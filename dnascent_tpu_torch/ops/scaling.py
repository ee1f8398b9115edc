"""Theil-Sen refinement as torch ops (port of
``dnascent_tpu/ops/scaling.py``'s ``theilsen_refine_pregathered``), over
the points that ``native.prep_decode_group`` subsamples on the host.  The
quantile scaling before it is ``native.prep_scale_batch``.

The TPU version picks the exact median with a sort-free bitwise search
(``masked_kth_smallest``); a sort gives the same order statistic.
"""

from __future__ import annotations

import torch


def masked_median_lower(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per row, sorted(values[mask])[count // 2] — the reference's
    ``slopes[slopes.size()/2]`` convention (event_handling.cpp:78).
    Masked entries are parked at +inf; since k < count, the picked value is
    the same wherever they land among real +inf entries."""
    k = mask.sum(dim=1) // 2
    parked = torch.where(mask, values, float("inf"))
    srt = torch.sort(parked, dim=1).values
    return srt.gather(1, k[:, None])[:, 0]


def theilsen_refine_pregathered(sig: torch.Tensor,         # (B, P) f32
                                y: torch.Tensor,           # (B, P) f32
                                num_points: torch.Tensor,  # (B,) i32
                                passthrough: torch.Tensor,  # (B,) bool
                                shift: torch.Tensor,       # (B,) f32
                                scale: torch.Tensor):      # (B,) f32
    """Batched Theil-Sen (event_handling.cpp:24-110) over host-subsampled
    points.  Returns (new_shift, new_scale); a zero median slope gives the
    (-1, -1) failure sentinel, passthrough rows keep their inputs."""
    B, P = sig.shape
    j = torch.arange(P, device=sig.device)
    pt_mask = j[None, :] < num_points.long()[:, None]
    x = (sig - shift[:, None]) / scale[:, None]
    dy = y[:, :, None] - y[:, None, :]
    dx = x[:, :, None] - x[:, None, :]
    pair_mask = (pt_mask[:, :, None] & pt_mask[:, None, :]
                 & (j[:, None] < j[None, :])[None])
    dx_zero = dx == 0
    slopes = torch.where(pair_mask & ~dx_zero,
                         dy / torch.where(dx_zero, 1.0, dx), 0.0)
    # dx == 0 pairs give +-inf in the reference and sort to the ends
    inf_val = torch.where(dy >= 0, float("inf"), float("-inf"))
    slopes = torch.where(pair_mask & dx_zero, inf_val, slopes)
    del dx, dy, inf_val, dx_zero
    m_slope = masked_median_lower(slopes.reshape(B, -1),
                                  pair_mask.reshape(B, -1))
    intercepts = y - m_slope[:, None] * x
    b_int = masked_median_lower(intercepts, pt_mask)
    new_shift = shift + (-b_int / m_slope) * scale
    new_scale = scale * (1.0 / m_slope)
    failed = m_slope == 0.0
    new_shift = torch.where(failed, -1.0, new_shift)
    new_scale = torch.where(failed, -1.0, new_scale)
    new_shift = torch.where(passthrough, shift, new_shift)
    new_scale = torch.where(passthrough, scale, new_scale)
    return new_shift, new_scale

