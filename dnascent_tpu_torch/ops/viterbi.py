"""Windowed Viterbi eventalign: plain PyTorch twins of kernels C and D,
termination, and the host path decode (port of
``dnascent_tpu/ops/viterbi.py``).

Layouts are the TPU kernels': observations (T, W), per-state coefficient
planes (N, W), codes (T, N, W) with windows fastest.  Each code byte packs
the I (bits 0-1), M (bits 2-4) and D (bit 5) predecessors; ties go to the
first candidate in the reference's lnArgMax order (alignment.cpp:377-381).
State kinds are 0=D, 1=M, 2=I; 3 marks PAD in emitted paths.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import put_scalar
from .banded import LOG_INV_SQRT_2PI

NEG = float("-inf")
KIND_D, KIND_M, KIND_I, KIND_PAD = 0, 1, 2, 3


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) + exp(b)) in the same operation order as jnp.logaddexp."""
    amax = torch.maximum(a, b)
    delta = a - b
    return amax + torch.log1p(torch.exp(-delta.abs()))


def transition_scores(events_per_base: torch.Tensor, hmm_probs):
    """Per-window transitions (alignment.cpp:207-210) in f32.  Returns
    (iM2M, eM2M, eOrIM2M, eM2MorD) each (W,), and the six fixed log-probs
    (eD2D, eD2M, eI2M, eM2D, iM2I, iI2I) as f32-representable floats."""
    eD2D_f, eD2M_f, eI2M_f, eM2D_f, iM2I_f, iI2I_f = hmm_probs
    dev = events_per_base.device
    epb = events_per_base.to(torch.float32)
    one_minus = 1.0 - (1.0 / epb)
    iM2M = torch.log(one_minus)
    eM2M = torch.log(put_scalar(1.0 - eM2D_f - iM2I_f, dev) - one_minus)
    f32 = lambda v: put_scalar(float(np.float32(np.log(v))), dev)
    eOrIM2M = _logaddexp(eM2M, iM2M)
    eM2MorD = _logaddexp(eM2M, f32(eM2D_f))
    logs = tuple(float(np.float32(np.log(v))) for v in hmm_probs)
    return iM2M, eM2M, eOrIM2M, eM2MorD, logs


def emission_planes(ranks: torch.Tensor, model_table: torch.Tensor):
    """(N, W) k-mer ranks (-1 = beyond the window's states) -> the (mu,
    inv_sigma, lp_const) planes; -1 ranks get lp_const = -inf."""
    safe = ranks.clamp(0, model_table.shape[0] - 1)
    mu = model_table[safe, 0]
    sigma = torch.clamp(model_table[safe, 1], min=1e-6)
    inv_sigma = 1.0 / sigma
    lp_const = put_scalar(LOG_INV_SQRT_2PI, ranks.device) - torch.log(sigma)
    lp_const = torch.where(ranks < 0, NEG, lp_const)
    return mu.contiguous(), inv_sigma.contiguous(), lp_const.contiguous()


def viterbi_fill_plain(obs_T, mu, inv_sigma, lp_const, n_obs, n_states,
                       iM2M, eM2M, eOrIM2M, hmm_logs):
    """Plain twin of kernel C, vectorised over (states, windows) with a
    Python loop over observation columns.  Returns (codes (T, N, W) u8,
    I_fin, M_fin, D_fin (N, W) f32)."""
    dev = obs_T.device
    T, W = obs_T.shape
    N = mu.shape[0]
    eD2D, eD2M, eI2M, eM2D, iM2I, iI2I = (
        torch.tensor(v, dtype=torch.float32, device=dev) for v in hmm_logs)
    sidx = torch.arange(N, device=dev)[:, None]
    in_range = sidx < n_states.long()[None, :]
    is0 = sidx == 0
    fj = sidx.to(torch.float32)
    neg_row = torch.full((1, W), NEG, dtype=torch.float32, device=dev)

    def shift(v):  # v[i-1] along states, NEG at i=0
        return torch.cat([neg_row, v[:-1]], dim=0)

    # initial column: start -> D0 -> D1 -> ... (alignment.cpp:239-251)
    D_prev = torch.where(in_range, eM2D + fj * eD2D, NEG)
    I_prev = torch.full((N, W), NEG, dtype=torch.float32, device=dev)
    M_prev = I_prev.clone()
    iM2M, eM2M, eOrIM2M = iM2M[None, :], eM2M[None, :], eOrIM2M[None, :]
    codes = torch.empty((T, N, W), dtype=torch.uint8, device=dev)
    for t in range(T):
        a = (obs_T[t][None, :] - mu) * inv_sigma
        em = lp_const - (0.5 * a) * a
        # insertions: [I+iI2I, M+iM2I, start+iM2I], first wins
        c0 = I_prev + iI2I
        c1 = M_prev + iM2I
        c2 = torch.where(is0 & (t == 0), iM2I, NEG)
        aI = (c1 > c0).long()
        Ic = torch.maximum(c0, c1)
        aI = torch.where(c2 > Ic, 2, aI)
        Ic = torch.maximum(Ic, c2)
        # matches, i >= 1: [sh(I)+eI2M, sh(M)+eM2M, M+iM2M, sh(D)+eD2M]
        m0 = shift(I_prev) + eI2M
        m1 = shift(M_prev) + eM2M
        m2 = M_prev + iM2M
        m3 = shift(D_prev) + eD2M
        aM = (m1 > m0).long()
        best = torch.maximum(m0, m1)
        aM = torch.where(m2 > best, 2, aM)
        best = torch.maximum(best, m2)
        aM = torch.where(m3 > best, 3, aM)
        best = torch.maximum(best, m3)
        # state 0: [M+iM2M, start+eOrIM2M] -> codes {2, 4}
        s1 = eOrIM2M if t == 0 else torch.full_like(eOrIM2M, NEG)
        aM0 = torch.where(s1 > m2, 4, 2)
        best0 = torch.maximum(m2, s1)
        Mc = torch.where(is0, best0, best) + em
        aM = torch.where(is0, aM0, aM)
        # deletions, closed-form chain (alignment.cpp:405-427)
        A = Mc - fj * eD2D
        cmax_excl = shift(torch.cummax(A, dim=0).values)
        Dc = torch.where(is0, NEG, (cmax_excl + eM2D) + (fj - 1.0) * eD2D)
        aD = (shift(Mc) + eM2D < shift(Dc) + eD2D).long()
        # keep the previous column beyond each window's observation count
        upd = (t < n_obs.long())[None, :] & in_range
        I_prev = torch.where(upd, Ic, torch.where(in_range, I_prev, NEG))
        M_prev = torch.where(upd, Mc, torch.where(in_range, M_prev, NEG))
        D_prev = torch.where(upd, Dc, torch.where(in_range, D_prev, NEG))
        codes[t] = (aI | (aM << 2) | (aD << 5)).to(torch.uint8)
    return codes, I_prev, M_prev, D_prev


def terminate(I_fin, M_fin, D_fin, n_states, eM2MorD, eI2M: float):
    """Termination (alignment.cpp:445-476): best end kind per window.
    Returns (score (W,) f32, kind0 (W,) i32 with 0=D, 1=M, 2=I)."""
    N = D_fin.shape[0]
    last = (n_states.long() - 1).clamp(0, N - 1)[None, :]
    Dl = D_fin.gather(0, last)[0]
    Ml = M_fin.gather(0, last)[0]
    Il = I_fin.gather(0, last)[0]
    cand = torch.stack([Dl, Ml + eM2MorD, Il + eI2M])
    score, kind0 = cand.max(dim=0)
    # torch.max picks the first maximal index on every backend we target;
    # make the first-wins rule explicit for ties
    kind0 = torch.where(cand[0] == score, 0,
                        torch.where(cand[1] == score, 1, 2))
    return score, kind0.to(torch.int32)


def viterbi_backtrace_plain(codes, kind0, n_obs, n_states, s_rows: int):
    """Plain twin of kernel D: the countdown over s = column + position,
    all windows in lockstep.  Returns (path_code (W, s_pad) u8 in forward
    order with PAD gaps, path_len (W,) i32), s_pad = s_rows rounded up to a
    multiple of 8."""
    dev = codes.device
    T, N, W = codes.shape
    s_pad = -(-s_rows // 8) * 8
    kind = kind0.long()
    pos = n_states.long() - 1
    col = n_obs.long()
    done = col < 0
    wi = torch.arange(W, device=dev)
    path = torch.empty((W, s_pad), dtype=torch.uint8, device=dev)
    flat = codes.reshape(T * N, W)
    for s in range(s_pad - 1, -1, -1):
        active = (~done) & (col + pos == s)
        posc = pos.clamp(0, N - 1)
        t = s - 1 - posc
        ok = (t >= 0) & (t < T)
        byte = flat[(t.clamp(0, T - 1) * N + posc), wi].long()
        byte = torch.where(ok, byte, 0)
        cI, cM, cD = byte & 3, (byte >> 2) & 7, (byte >> 5) & 1
        at_init = col == 0
        nk_D = torch.where(at_init | (cD == 1), KIND_D, KIND_M)
        fin_D = at_init & (pos == 0)
        nk_M = torch.where(cM == 0, KIND_I, torch.where(cM == 3, KIND_D, KIND_M))
        np_M = torch.where((cM == 2) | (cM >= 4), pos, pos - 1)
        fin_M = cM == 4
        nk_I = torch.where(cI == 0, KIND_I, KIND_M)
        fin_I = cI == 2
        is_D = kind == KIND_D
        is_M = kind == KIND_M
        nk = torch.where(is_D, nk_D, torch.where(is_M, nk_M, nk_I))
        npos = torch.where(is_D, pos - 1, torch.where(is_M, np_M, pos))
        ncol = torch.where(is_D, col, col - 1)
        fin = torch.where(is_D, fin_D, torch.where(is_M, fin_M, fin_I))
        delta = (pos - npos).clamp(0, 1)
        path[:, s] = torch.where(active, kind | (delta << 2),
                                 KIND_PAD).to(torch.uint8)
        done = done | (active & fin)
        kind = torch.where(active, nk, kind)
        pos = torch.where(active, npos, pos)
        col = torch.where(active, ncol, col)
    path_len = ((path & 3) != KIND_PAD).sum(dim=1).to(torch.int32)
    return path, path_len


def left_align_paths(path):
    """(W, s_pad) PAD-gapped path codes -> (the same rows with their codes
    moved to the front in order and PAD only as a tail, path_len (W,) i32)."""
    pad = (path & 3) == KIND_PAD
    order = torch.sort(pad.to(torch.uint8), dim=1, stable=True).indices
    return path.gather(1, order), (~pad).sum(dim=1).to(torch.int32)


def viterbi_terminate_backtrace_plain(codes, I_fin, M_fin, D_fin, n_obs,
                                      n_states, eM2MorD, eI2M: float,
                                      s_rows: int):
    """Plain twin of kernel D: termination, the countdown walk, and each
    row left-aligned.  Returns (path (W, s_pad) u8 in forward order with PAD
    only as a tail, path_len (W,) i32), s_pad = s_rows rounded up to a
    multiple of 8."""
    _score, kind0 = terminate(I_fin, M_fin, D_fin, n_states, eM2MorD, eI2M)
    path, _len = viterbi_backtrace_plain(codes, kind0, n_obs, n_states,
                                         s_rows)
    return left_align_paths(path)


def decode_path(codes: np.ndarray, n_states: int):
    """Host decode of one forward-order code array -> (kinds, positions);
    pos[last] anchors at n_states-1, pos[t] = n_states-1 - deltas after t."""
    kinds = (codes & 3).astype(np.uint8)
    deltas = ((codes >> 2) & 1).astype(np.int64)
    csum = np.cumsum(deltas)
    total = csum[-1] if csum.shape[0] else 0
    return kinds, (n_states - 1) - (total - csum)
