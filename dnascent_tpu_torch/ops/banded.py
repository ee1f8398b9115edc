"""Adaptive banded event alignment: plain PyTorch twins of kernels A, E
and B and the host helpers around them (port of ``dnascent_tpu/ops/
banded.py``).

Two fills share one band loop and differ only in the emission:

- the static-stdv fill (kernel A), which the shipping pipeline runs (the
  banded aligner scores against the ONT table with stdv forced to 0.14,
  data_IO.cpp:173): one mu plane, emission ``h_c * (x - mu)^2`` with
  ``h_c = -0.5 / sigma^2``, and the log-density constant folded into the
  per-read stay/step scores.  Its arithmetic follows the TPU lean kernel
  (``banded_pallas._kernel_lean``) operation for operation;
- the general fill (kernel E) for pore models whose stdv varies per k-mer
  (fit-stdv tables): three coefficient planes and emission ``cA + cB*x +
  cC*x^2``, following ``banded_pallas._kernel`` operation for operation.

So each CUDA kernel (``csrc/banded_fill.cu``) matches its twin bit for bit;
against the JAX package's XLA scan, which rounds the emission differently,
the contract is the one ``tests/test_banded_pallas.py`` states (rights and
best_event equal, rare trace tie flips, best_score within 0.05).

The chase emits the band-ordered, PAD-gapped 2-bit move stream of
``banded_pallas.backtrace_moves_pallas``; ``native.prep_decode_group``
turns each read's column of it into event/k-mer pairs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import put_scalar

NEG = float("-inf")
FROM_D, FROM_U, FROM_L = 0, 1, 2
MOVE_D, MOVE_U, MOVE_L, MOVE_PAD = 0, 1, 2, 3
LOG_INV_SQRT_2PI = float(np.log(0.3989422804014327))
CH_ROWS = 4  # chase output rows are a multiple of this (TPU kernel's block)


def transition_scalars(n_events: torch.Tensor, n_kmers: torch.Tensor, *,
                       epsilon_skip: float, p_trim: float):
    """Per-read stay/step log-probabilities and the per-call skip and trim
    log-probabilities, as ``banded_fill_pallas`` forms them.  Shared by the
    wrappers and the plain twins so both consume identical inputs.  Returns
    (lp_stay, lp_step, lp_skip, lp_trim)."""
    fE = n_events.to(torch.float32)
    fK = n_kmers.to(torch.float32)
    p_stay = 1.0 - (1.0 / (fE / fK + 1.0))
    eps = put_scalar(epsilon_skip, fE.device)
    lp_stay = torch.log(p_stay)
    lp_step = torch.log1p(-(eps + p_stay))
    lp_skip = float(np.float32(np.log(epsilon_skip)))
    lp_trim = float(np.float32(np.log(p_trim)))
    return lp_stay.contiguous(), lp_step.contiguous(), lp_skip, lp_trim


def lean_scalars(n_events: torch.Tensor, n_kmers: torch.Tensor, *,
                 inv_sigma: float, lp_const: float, epsilon_skip: float,
                 p_trim: float):
    """The static fill's scalars: :func:`transition_scalars` with the static
    emission's log-density constant folded into stay and step, plus
    ``h_c``.  Returns (lp_stay, lp_step, lp_skip, lp_trim, h_c)."""
    lp_stay, lp_step, lp_skip, lp_trim = transition_scalars(
        n_events, n_kmers, epsilon_skip=epsilon_skip, p_trim=p_trim)
    lpc = put_scalar(lp_const, lp_stay.device)
    h_c = float(np.float32(-0.5 * inv_sigma * inv_sigma))
    return ((lp_stay + lpc).contiguous(), (lp_step + lpc).contiguous(),
            lp_skip, lp_trim, h_c)


def emission_coefficients(mu: torch.Tensor, inv_sigma: torch.Tensor,
                          lp_const: torch.Tensor):
    """The general fill's (B, K) planes, in ``banded_fill_pallas``'s op
    order: cC = -0.5 inv^2, cB = mu inv^2, cA = lp_const - 0.5 (mu inv)^2.
    Returns (cA, cB, cC)."""
    inv2 = inv_sigma * inv_sigma
    a = mu * inv_sigma
    cA = lp_const - 0.5 * (a * a)
    return cA.contiguous(), (mu * inv2).contiguous(), (-0.5 * inv2).contiguous()


def n_fill_steps(E: int, K: int) -> int:
    """Packed 4-band steps of a fill over E events and K k-mers."""
    return (E + K + 3) // 4


def banded_fill_plain(events: torch.Tensor,   # (B, E) f32 scaled events
                      mu: torch.Tensor,       # (B, K) f32, +inf = undefined
                      n_events: torch.Tensor,  # (B,) i32
                      n_kmers: torch.Tensor,   # (B,) i32
                      *, inv_sigma: float, lp_const: float,
                      bandwidth: int = 100, epsilon_skip: float = 1e-30,
                      p_trim: float = 0.01):
    """Plain twin of kernel A (static stdv).  Returns (trace (S, B, W) u8,
    rights (S, B) u8, best_event (B,) i32, best_score (B,) f32), S =
    ceil((E + K) / 4)."""
    lp_stay, lp_step, lp_skip, lp_trim, h_c = lean_scalars(
        n_events, n_kmers, inv_sigma=inv_sigma, lp_const=lp_const,
        epsilon_skip=epsilon_skip, p_trim=p_trim)
    h_c_t = torch.tensor(h_c, dtype=torch.float32, device=events.device)
    lp_stay, lp_step = lp_stay[:, None], lp_step[:, None]

    def scores(diag, up, ev, k):
        t = ev - torch.gather(mu, 1, k)
        em = h_c_t * (t * t)
        return diag + (lp_step + em), up + (lp_stay + em)

    return _fill_plain(events, mu.shape[1], n_events, n_kmers, scores,
                       lp_skip, lp_trim, bandwidth)


def banded_fill_general_plain(events: torch.Tensor,     # (B, E) f32
                              mu: torch.Tensor,         # (B, K) f32
                              inv_sigma: torch.Tensor,  # (B, K) f32
                              lp_const: torch.Tensor,   # (B, K) f32
                              n_events: torch.Tensor,   # (B,) i32
                              n_kmers: torch.Tensor,    # (B,) i32
                              *, bandwidth: int = 100,
                              epsilon_skip: float = 1e-30,
                              p_trim: float = 0.01):
    """Plain twin of kernel E (stdv per k-mer; -inf lp_const marks an
    undefined k-mer).  Same outputs as :func:`banded_fill_plain`."""
    cA, cB, cC = emission_coefficients(mu, inv_sigma, lp_const)
    lp_stay, lp_step, lp_skip, lp_trim = transition_scalars(
        n_events, n_kmers, epsilon_skip=epsilon_skip, p_trim=p_trim)
    lp_stay, lp_step = lp_stay[:, None], lp_step[:, None]

    def scores(diag, up, ev, k):
        em = ((torch.gather(cA, 1, k) + torch.gather(cB, 1, k) * ev)
              + (torch.gather(cC, 1, k) * ev) * ev)
        return (diag + lp_step) + em, (up + lp_stay) + em

    return _fill_plain(events, mu.shape[1], n_events, n_kmers, scores,
                       lp_skip, lp_trim, bandwidth)


def _fill_plain(events, K, n_events, n_kmers, scores, lp_skip, lp_trim,
                bandwidth):
    """The band loop both twins share, vectorised over (reads, band cells)
    with a Python loop over bands.  ``scores(diag, up, ev, k)`` returns the
    step and stay scores of every cell from its event values and clamped
    k-mer indices."""
    dev = events.device
    B, E = events.shape
    W = bandwidth
    half = W // 2
    n_steps = n_fill_steps(E, K)
    f32 = dict(dtype=torch.float32, device=dev)
    neg_col = torch.full((B, 1), NEG, **f32)
    lp_skip_t = torch.tensor(lp_skip, **f32)
    lp_trim_t = torch.tensor(lp_trim, **f32)
    n_ev = n_events.long()[:, None]
    n_km = n_kmers.long()[:, None]
    offs = torch.arange(W, device=dev)[None, :]
    rows = torch.arange(B, device=dev)[:, None]

    def shift_up(p):      # out[o] = p[o+1]
        return torch.cat([p[:, 1:], neg_col], dim=1)

    def shift_down(p):    # out[o] = p[o-1]
        return torch.cat([neg_col, p[:, :-1]], dim=1)

    p2 = torch.full((B, W), NEG, **f32)
    p2[:, half] = 0.0
    p1 = torch.full((B, W), NEG, **f32)
    p1[:, half] = lp_trim
    e0 = torch.full((B, 1), half, dtype=torch.long, device=dev)
    k0 = torch.full((B, 1), -1 - half, dtype=torch.long, device=dev)
    rp = torch.zeros((B, 1), dtype=torch.long, device=dev)
    bs = torch.full((B, 1), NEG, **f32)
    be = torch.zeros((B, 1), dtype=torch.long, device=dev)
    trace = torch.empty((n_steps, B, W), dtype=torch.uint8, device=dev)
    rights = torch.empty((n_steps, B), dtype=torch.uint8, device=dev)
    for step in range(n_steps):
        acc = torch.zeros((B, W), dtype=torch.long, device=dev)
        racc = torch.zeros((B, 1), dtype=torch.long, device=dev)
        for j in range(4):
            band = step * 4 + j + 2
            ll = p1[:, :1]
            ur = p1[:, W - 1 : W]
            both_ob = (ll == NEG) & (ur == NEG)
            right = torch.where(both_ob, torch.full_like(rp, band % 2),
                                (ll < ur).long())
            rb = right == 1
            e0 = e0 + (1 - right)
            k0 = k0 + right
            e = e0 - offs
            k = k0 + offs
            ev = torch.gather(events, 1, e.clamp(0, E - 1))
            up = torch.where(rb, shift_up(p1), p1)
            left = torch.where(rb, p1, shift_down(p1))
            dd = right + rp
            diag = torch.where(dd == 0, shift_down(p2),
                               torch.where(dd == 1, p2, shift_up(p2)))
            rp = right
            sd, su = scores(diag, up, ev, k.clamp(0, K - 1))
            sl = left + lp_skip_t
            mdu = torch.maximum(sd, su)
            from_du = torch.where(mdu == su, FROM_U, FROM_D)
            mall = torch.maximum(mdu, sl)
            frm = torch.where(mall == sl, FROM_L, from_du)
            valid = (e >= 0) & (e < n_ev) & (k >= 0) & (k < n_km)
            bnd = torch.where(valid, mall, NEG)
            frm = torch.where(valid, frm, 0)
            # trim state (event_handling.cpp:255-265)
            ot = -1 - k0
            et = e0 - ot
            trim_ok = (ot >= 0) & (ot < W) & (et >= 0) & (et < n_ev)
            is_trim = (offs == ot) & trim_ok
            bnd = torch.where(is_trim, lp_trim_t * (et.float() + 1.0), bnd)
            frm = torch.where(is_trim, FROM_U, frm)
            p2, p1 = p1, bnd
            acc = acc | (frm << (2 * j))
            racc = racc | (right << j)
            # start-cell tracking (event_handling.cpp:324-340)
            o_fin = (n_km - 1) - k0
            e_fin = e0 - o_fin
            ok = (o_fin >= 0) & (o_fin < W) & (e_fin >= 0) & (e_fin < n_ev)
            fin_val = bnd[rows, o_fin.clamp(0, W - 1)]
            cand = fin_val + (n_ev - e_fin).float() * lp_trim_t
            better = ok & (cand > bs)
            bs = torch.where(better, cand, bs)
            be = torch.where(better, e_fin, be)
        trace[step] = acc.to(torch.uint8)
        rights[step] = racc[:, 0].to(torch.uint8)
    return trace, rights, be[:, 0].int(), bs[:, 0]


def chase_rows(S: int) -> int:
    """Rows of the chase's output for a trace of S packed rows."""
    return -(-S // CH_ROWS) * CH_ROWS


def backtrace_moves_plain(trace: torch.Tensor,       # (S, B, W) u8
                          rights: torch.Tensor,      # (S, B) u8
                          best_event: torch.Tensor,  # (B,) i32
                          n_kmers: torch.Tensor,     # (B,) i32
                          bandwidth: int = 100) -> torch.Tensor:
    """Plain twin of kernel B: the band countdown over all reads in lockstep.
    Returns the (Sp, B) u8 stream, bands strictly descending, 4 per byte."""
    dev = trace.device
    S, B, W = trace.shape
    half = bandwidth // 2
    Sp = chase_rows(S)
    rights_i = rights.long()
    bits = torch.stack([(rights_i >> j) & 1 for j in range(4)], dim=1)
    n_right = bits.sum(dim=(0, 1))                            # (B,)
    bll = half + 4 * Sp - n_right
    e = best_event.long()
    k = n_kmers.long() - 1
    done = (e < 0) | (k < 0)
    cols = torch.arange(B, device=dev)
    out = torch.empty((Sp, B), dtype=torch.uint8, device=dev)
    for r in range(Sp):
        sr = Sp - 1 - r
        acc = torch.zeros(B, dtype=torch.long, device=dev)
        for m in range(4):
            j = 3 - m
            band = sr * 4 + j + 2
            active = (~done) & (e + k + 2 == band)
            if sr < S:
                off = (bll - e).clamp(0, W - 1)
                code = (trace[sr, cols, off].long() >> (2 * j)) & 3
                rbit = bits[sr, j]
            else:
                code = torch.zeros_like(e)
                rbit = 0
            is_d = active & (code == MOVE_D)
            is_u = active & (code == MOVE_U)
            is_l = active & (code == MOVE_L)
            e = e - (is_d | is_u).long()
            k = k - (is_d | is_l).long()
            done = done | (e < 0) | (k < 0)
            acc = acc | (torch.where(active, code, MOVE_PAD) << (2 * m))
            bll = bll - (1 - rbit)
        out[r] = acc.to(torch.uint8)
    return out


def prepare_emission_coefficients(kmer_ranks: np.ndarray, model: np.ndarray):
    """Host helper: gather (mu, 1/sigma, lp_const) for a (B, K) rank array.
    Ranks < 0 (undefined k-mers) get -inf lp_const so they never win."""
    safe = np.where(kmer_ranks < 0, 0, kmer_ranks)
    mu = model[safe, 0].astype(np.float32)
    sigma = model[safe, 1].astype(np.float32)
    inv_sigma = (1.0 / sigma).astype(np.float32)
    lp_const = (LOG_INV_SQRT_2PI - np.log(sigma)).astype(np.float32)
    lp_const[kmer_ranks < 0] = -np.inf
    return mu, inv_sigma, lp_const


def unpack_trace(trace_packed: np.ndarray, rights_packed: np.ndarray,
                 n_bands: int) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: expand packed fill outputs to per-band arrays.  Returns
    (trace (n_bands-2, B, W) u8, rights (n_bands-2, B) bool); index 0 is
    band 2, the first adaptively placed band."""
    S, B, W = trace_packed.shape
    tr = np.zeros((S * 4, B, W), dtype=np.uint8)
    rg = np.zeros((S * 4, B), dtype=bool)
    for j in range(4):
        tr[j::4] = (trace_packed >> (2 * j)) & 0x3
        rg[j::4] = ((rights_packed >> j) & 1).astype(bool)
    return tr[: n_bands - 2], rg[: n_bands - 2]
