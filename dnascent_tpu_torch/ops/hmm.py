"""Batched forward-HMM log-likelihood of the ``--HMM`` detect path (port of
``dnascent_tpu/ops/hmm.py``; reference ``sequenceProbability``,
detect.cpp:235-378).

Windows are rows of (W, N) tensors on the caller's device; the time
recursion is a Python loop over the T observation columns, and the
intra-column deletion chain, a sequential log-sum-exp recurrence in the
reference (detect.cpp:343-348), is ``torch.logcumsumexp`` shifted to an
exclusive prefix.  The JAX package runs this as an XLA scan, not a Pallas
kernel, so it is plain torch ops here too.  Op order and precisions follow
the JAX function: the six transition logs are taken in f64 on the host and
rounded to f32, everything else is f32 on the device.

Each window is scored twice (analogue-substituted and unmodified emission
tables); the caller differences the two for the log-likelihood ratio.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG = float("-inf")


def _f32(x: float) -> float:
    """``x`` rounded to f32, as a Python float (exact in f64)."""
    return float(np.float32(x))


def forward_batch(obs: torch.Tensor,        # (W, T) f32 scaled observations
                  n_obs: torch.Tensor,      # (W,) i32
                  mu: torch.Tensor,         # (W, N) f32 per-state means
                  sigma: torch.Tensor,      # (W, N) f32
                  n_states: torch.Tensor,   # (W,) i32 (2*window here)
                  events_per_base: torch.Tensor,  # (W,) f32
                  hmm_probs: tuple) -> torch.Tensor:
    """Forward log-probability per window, (W,) f32 on the inputs' device
    (detect.cpp:235-378).  Steps past a window's ``n_obs`` and states past
    its ``n_states`` hold their values."""
    W, T = obs.shape
    N = mu.shape[1]
    dev = obs.device
    f32 = dict(dtype=torch.float32, device=dev)
    eD2D_f, eD2M_f, eI2M_f, eM2D_f, iM2I_f, iI2I_f = hmm_probs
    eD2D, eD2M, eI2M, eM2D, iM2I, iI2I = (
        _f32(np.log(p)) for p in (eD2D_f, eD2M_f, eI2M_f, eM2D_f, iM2I_f,
                                  iI2I_f))
    epb = events_per_base
    iM2M = torch.log(1.0 - (1.0 / epb))[:, None]
    eM2M = torch.log((1.0 - eM2D_f - iM2I_f) - (1.0 - 1.0 / epb))[:, None]
    ln25, ln50 = _f32(np.log(0.25)), _f32(np.log(0.5))

    sidx = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    in_range = sidx < n_states[:, None]
    is0 = sidx == 0
    fj = sidx.to(torch.float32)
    lp_const = -0.5 * torch.log(2.0 * math.pi * sigma * sigma)
    inv_sigma = 1.0 / sigma
    # loop invariants of the deletion chain
    fj_d = fj * eD2D
    fj1_d = (fj - 1.0) * eD2D

    neg = torch.full((W, N), NEG, **f32)
    neg1 = neg[:, :1]
    D = torch.where(in_range, ln25 + fj_d, neg)
    I = neg.clone()
    M = neg.clone()
    firstI = neg1.clone()
    # start + ln25 and start + ln50: the start state is 0 at t == 0 only
    start25 = (torch.full((W, 1), ln25, **f32), neg1)
    start50 = (torch.full((W, 1), ln50, **f32), neg1)

    def shift(v):
        return torch.cat([neg1, v[:, :-1]], dim=1)

    lae = torch.logaddexp
    # every step past the longest window holds every state
    n_steps = min(T, int(n_obs.max())) if W else 0
    for t in range(n_steps):
        active = (t < n_obs)[:, None]
        upd = active & in_range
        first = 0 if t == 0 else 1
        a = (obs[:, t : t + 1] - mu) * inv_sigma
        em = lp_const - 0.5 * a * a

        firstI_c = lae(start25[first], firstI + ln25)
        I_c = lae(I + iI2I, M + iM2I)
        M_stay = M + iM2M
        M_base = lae(lae(shift(I) + eI2M, shift(M) + eM2M),
                     lae(M_stay, shift(D) + eD2M))
        M0_base = lae(lae(firstI + ln50, M_stay), start50[first])
        M_c = torch.where(is0, M0_base, M_base) + em
        # D[i] = lse(D[0] + i*eD2D,
        #            lse_{j<=i-1}(M[j] - j*eD2D) + eM2D + (i-1)*eD2D)
        D_first = firstI_c + ln25                       # detect.cpp:309
        cum_excl = shift(torch.logcumsumexp(M_c - fj_d, dim=1))
        D_chain = cum_excl + eM2D + fj1_d
        D_c = torch.where(is0, D_first, lae(D_first + fj_d, D_chain))

        # a state outside n_states is -inf from the start and never
        # updated, so holding it is keeping it
        I = torch.where(upd, I_c, I)
        M = torch.where(upd, M_c, M)
        D = torch.where(upd, D_c, D)
        firstI = torch.where(active, firstI_c, firstI)

    last = torch.clamp(n_states.long() - 1, 0, N - 1)[:, None]
    Dl = D.gather(1, last)[:, 0]
    Ml = M.gather(1, last)[:, 0]
    Il = I.gather(1, last)[:, 0]
    eM2MorD = lae(eM2M[:, 0], torch.full_like(eM2M[:, 0], eM2D))
    return lae(lae(Dl, Ml + eM2MorD), Il + eI2M)
