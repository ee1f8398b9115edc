"""Theil-Sen scaling refinement as torch ops (port of the upload-lean pair
in ``dnascent_tpu/ops/scaling.py``: ``theilsen_pregather`` on the host,
``theilsen_refine_pregathered`` on the device).

The TPU version picks the exact median with a sort-free bitwise search
(``masked_kth_smallest``); a sort gives the same order statistic.
"""

from __future__ import annotations

import numpy as np
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


def theilsen_pregather(cleaned_signals: np.ndarray, model_ranks: np.ndarray,
                       pore_model: np.ndarray, max_points: int, trim: int):
    """Host stride subsample (``idx = trim + skip*j``,
    event_handling.cpp:63-65) for one read.  Returns (sig_pts, y_pts,
    num_points, passthrough)."""
    n = cleaned_signals.shape[0]
    effective = n - 2 * trim
    skip = effective // max_points if effective > max_points else 1
    num_points = min(effective, max_points)
    sig = np.zeros(max_points, dtype=np.float32)
    y = np.zeros(max_points, dtype=np.float32)
    if n > 0 and num_points > 0:
        j = np.arange(max_points, dtype=np.int64)
        idx = np.clip(trim + skip * j, 0, n - 1)
        sig[:] = cleaned_signals[idx]
        safe = np.where(model_ranks[idx] < 0, 0, model_ranks[idx])
        y[:] = pore_model[safe, 0]
    return sig, y, max(num_points, 0), n < max_points
