"""Fast-mode windowed eventalign (port of the fast path of
``dnascent_tpu/pipeline/eventalign.py::run_eventalign``).

Every 50 bp window of every read is built up front on the host (windows
advance by their full k-mer span, so they are independent), the batch's
observation stream is rebuilt on the device from prep's resident fill input,
and windows run through the Viterbi fill (kernel C), termination and the
Viterbi backtrace (kernel D) in chunks grouped by observation and state
bucket.  The native post-processing turns each read's paths into aligned
positions.  Strict mode (the reference's sequential window coupling) and the
eventalign text table are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import device as devmod, native
from ..config import DNA_R10, SubstrateConfig
from ..io.poremodel import PoreModelSet
from ..models.cnn import RAWDEPTH, SIG_QUANT_LO, SIG_QUANT_SCALE
from ..ops import seqcodes, viterbi as vit, viterbi_cuda
from ..utils.seqtools import (core_index_from_codes, encode_bases,
                              residual_index_from_codes)
from .prep import PreparedRead

HMM_KEY = ("external_D2D", "external_D2M", "external_I2M", "external_M2D",
           "internal_M2I", "internal_I2I")
# observation-count buckets (the windows' scan lengths) and the longest
# window kept; plain 50 bp windows carry <= 42 states (bucket 48), only
# breakpoint-extended windows need the full 72
T_BUCKETS = (128, 192, 256, 384, 512, 1024)
N_STATE_PAD = 72
N_STATE_SMALL = 48


@dataclass
class AlignedPositions:
    """Per-read aligned-position table in genome-walk order; the CNN input
    windows travel as a flat u8 sample stream plus per-position counts."""

    coord: np.ndarray         # (P,) reference coordinate
    kmer_start: np.ndarray    # (P,) index into reference_seq of the 9-mer
    query_idx: np.ndarray     # (P,)
    ref_idx: np.ndarray       # (P,)
    core_idx: np.ndarray      # (P,) CNN core-sequence index
    residual_idx: np.ndarray  # (P,) CNN residual-sequence index
    n_signals: np.ndarray     # (P,) signals seen (may exceed RAWDEPTH)
    center_is_T: np.ndarray   # (P,) bool
    indel_score: np.ndarray   # (P,)
    signal_u8_flat: np.ndarray  # flat u8, counts-ordered
    signal_counts: np.ndarray   # (P,) u8 = min(n_signals, RAWDEPTH)


@dataclass
class EventalignResult:
    positions: Optional[AlignedPositions]
    qc_passed: bool


@dataclass
class _ReadState:
    p: PreparedRead
    ref_codes: np.ndarray
    core_rank: np.ndarray
    res_rank: np.ndarray
    mean_ref: np.ndarray
    defined: np.ndarray
    flat_obs_base: int = 0   # offset of the read's observations in the batch
    rank_off: int = 0        # offset of the read's ranks in the batch


@dataclass
class _WindowSet:
    """A read's windows as arrays."""

    ri: np.ndarray          # (Wn,) window reference start
    ns: np.ndarray          # (Wn,) state count = wl - k + 1
    g0: np.ndarray          # (Wn,) start into the read's guarded event stream
    g1: np.ndarray          # (Wn,) end (exclusive, t_cap-clipped)
    ref_coord: np.ndarray   # (Wn,)
    indel: np.ndarray       # (Wn,)
    g_ev: np.ndarray        # the read's guarded event-id stream


def _build_state(p: PreparedRead, models: PoreModelSet,
                 cfg: SubstrateConfig) -> Optional[_ReadState]:
    k = cfg.kmer_len
    codes = encode_bases(p.record.reference_seq)
    if codes.shape[0] - k + 1 <= 0:
        return None
    safe = np.where(codes < 0, 0, codes).astype(np.int64)
    win = np.lib.stride_tricks.sliding_window_view(safe, k)
    ranks = np.where(p.kmer_ranks_ref < 0, 0, p.kmer_ranks_ref)
    return _ReadState(p, codes, core_index_from_codes(win),
                      residual_index_from_codes(win),
                      models.pore_model[ranks, 0].astype(np.float64),
                      codes >= 0)


def _build_window_set(st: _ReadState, cfg: SubstrateConfig,
                      t_cap: int) -> Optional[_WindowSet]:
    """Every window of the read, as arrays.  Successful windows advance by
    their full k-mer span ``wl - k + 1`` (the JAX package's fast-mode
    departure from the reference's ``lastM_ref + 1`` coupling), so all
    windows of all reads can run in one device batch."""
    k = cfg.kmer_len
    p = st.p
    ref_len = len(p.record.reference_seq)
    total_wl = cfg.window_length_align
    r2q = p.record.ref_to_query
    pairs = p.event_alignment
    ev_mean = p.event_mean
    dmin, dmax = cfg.detect.event_mean_min, cfg.detect.event_mean_max
    undef_cum = np.concatenate(([0], np.cumsum(~st.defined)))
    m = st.mean_ref
    gap = np.abs(np.diff(m))
    bp = np.zeros(m.shape[0], dtype=bool)
    if m.shape[0] >= 3:
        bp[1:-1] = (gap[1:] > 0.75) & (gap[:-1] > 0.75)
    bp_pos = np.flatnonzero(bp)
    guard_ok = (ev_mean[pairs[:, 0]] > dmin) & (ev_mean[pairs[:, 0]] < dmax)
    guard_cum = np.concatenate(([0], np.cumsum(guard_ok)))
    j_at = np.searchsorted(pairs[:, 1], r2q[: ref_len + 1], side="left")
    next_bp = np.searchsorted(bp_pos, np.arange(m.shape[0] + total_wl + 1))
    ri_a, wl_a, j0_a, j1_a = native.window_chain(
        undef_cum, bp_pos, next_bp, j_at, guard_cum, ref_len, k, total_wl)
    if ri_a.shape[0] == 0:
        return None
    g0 = guard_cum[j0_a]
    g1 = np.minimum(guard_cum[j1_a], g0 + t_cap)
    ns = wl_a - k + 1
    indel = (r2q[ri_a + ns] - r2q[ri_a]) - ns
    if p.record.is_reverse:
        ref_coord = p.record.ref_end - ri_a - k // 2
    else:
        ref_coord = p.record.ref_start + ri_a + k // 2
    return _WindowSet(ri_a, ns, g0, g1, ref_coord, indel,
                      pairs[guard_ok, 0])


def _resident_obs(sets, dev) -> torch.Tensor:
    """The batch's flat f16 observation stream, gathered on the device from
    prep's resident fill inputs: a read's observations are its guarded
    events under the Theil-Sen scaling, an affine map of the quantile-scaled
    fill input.  The f16 rounding is the JAX package's (its goldens carry
    it)."""
    parts = []
    base = 0
    for st, ws in sets:
        p = st.p
        st.flat_obs_base = base
        a = np.float32(p.scale_q / p.scale)
        b = np.float32((p.shift_q - p.shift) / p.scale)
        idx = devmod.put_rows(ws.g_ev.astype(np.int64), dev)
        vals = p.events_dev[p.events_row].index_select(0, idx)
        parts.append((vals * float(a) + float(b)).to(torch.float16))
        base += ws.g_ev.shape[0]
    return torch.cat(parts)


def _batch_flat_ranks(states: list[_ReadState], dev) -> torch.Tensor:
    """One flat rank stream for the batch, built on the device from the
    reference base codes; sets ``st.rank_off`` (window rank starts are
    ``rank_off + ri``)."""
    parts = []
    off = 0
    for st in states:
        st.rank_off = off
        parts.append(st.ref_codes.astype(np.uint8))  # -1 -> 255 (non-ACGT)
        off += st.ref_codes.shape[0]
    codes = devmod.put_rep(np.concatenate(parts), dev)
    return seqcodes.flat_ranks_from_codes(codes)


def viterbi_windows(obs_flat: torch.Tensor, ranks_flat: torch.Tensor,
                    model_table: torch.Tensor, lens: np.ndarray,
                    ostarts: np.ndarray, rstarts: np.ndarray, ns: np.ndarray,
                    epb: np.ndarray, hmm_probs, n_state_pad: int):
    """One chunk of windows through fill (kernel C), termination and
    backtrace (kernel D).  Returns the (W, s_pad) u8 path codes on the
    device (forward order, PAD gaps)."""
    dev = obs_flat.device
    T = next(b for b in T_BUCKETS if b >= int(lens.max()))
    N = n_state_pad
    n_obs = devmod.put_rows(lens.astype(np.int32), dev)
    n_states = devmod.put_rows(ns.astype(np.int32), dev)
    tt = torch.arange(T, device=dev)
    oidx = devmod.put_rows(ostarts.astype(np.int64), dev)[None, :] + tt[:, None]
    obs_T = obs_flat[oidx.clamp(0, obs_flat.shape[0] - 1)].float()  # (T, W)
    ss = torch.arange(N, device=dev)
    ridx = devmod.put_rows(rstarts.astype(np.int64), dev)[None, :] + ss[:, None]
    ranks = ranks_flat[ridx.clamp(0, ranks_flat.shape[0] - 1)]
    ranks = torch.where(ss[:, None] < n_states.long()[None, :], ranks, -1)
    mu, inv_sigma, lp_const = vit.emission_planes(ranks, model_table)
    iM2M, eM2M, eOrIM2M, eM2MorD, logs = vit.transition_scores(
        devmod.put_rows(epb.astype(np.float32), dev), hmm_probs)
    codes, I_fin, M_fin, D_fin = viterbi_cuda.viterbi_fill_codes(
        obs_T.contiguous(), mu, inv_sigma, lp_const, n_obs, n_states,
        iM2M, eM2M, eOrIM2M, logs)
    _score, kind0 = vit.terminate(I_fin, M_fin, D_fin, n_states, eM2MorD,
                                  logs[2])
    # backtrace length bound from the chunk's true maxima, bucketed to 64
    bt_len = -(-(int(lens.max()) + int(ns.max()) + 2) // 64) * 64
    path, _len = viterbi_cuda.viterbi_backtrace(
        codes, kind0, n_obs, n_states, min(bt_len, T + N))
    return path


def _positions(st: _ReadState, ws: _WindowSet, codes: np.ndarray,
               steps_per: np.ndarray, cfg: SubstrateConfig
               ) -> Optional[AlignedPositions]:
    """Native post-processing of all of a read's window paths."""
    p = st.p
    (coord, kmer_start, query_idx, ref_idx, core, res, nsig, centerT,
     indel, sig_flat, _store) = native.process_read_windows(
        codes, steps_per, ws.ns.astype(np.int64), ws.g_ev, ws.g0, ws.ri,
        ws.ref_coord, ws.indel, p.record.is_reverse, cfg.kmer_len,
        p.event_raw_start, p.event_raw_end, p.record.raw, p.shift, p.scale,
        p.record.ref_to_query, st.core_rank, st.res_rank, st.ref_codes,
        SIG_QUANT_LO, SIG_QUANT_SCALE, RAWDEPTH)
    if coord.shape[0] == 0:
        return None
    return AlignedPositions(
        coord=coord, kmer_start=kmer_start, query_idx=query_idx,
        ref_idx=ref_idx, core_idx=core, residual_idx=res, n_signals=nsig,
        center_is_T=centerT, indel_score=indel, signal_u8_flat=sig_flat,
        signal_counts=np.minimum(nsig, RAWDEPTH).astype(np.uint8))


def run_eventalign(prepped: list[PreparedRead], models: PoreModelSet,
                   cfg: SubstrateConfig = DNA_R10,
                   max_windows_per_batch: int = 8192,
                   model_table: Optional[torch.Tensor] = None,
                   ) -> dict[str, EventalignResult]:
    """Fast-mode eventalign for a batch of prepared reads, on the device that
    holds their resident fill inputs.  Returns {read_id: EventalignResult};
    reads that failed earlier stages come back with qc_passed=False."""
    hmm_probs = tuple(getattr(cfg.hmm, k) for k in HMM_KEY)
    out: dict[str, EventalignResult] = {}
    t_cap = T_BUCKETS[-1]
    sets: list[tuple[_ReadState, _WindowSet]] = []
    for p in prepped:
        st = None
        if p.passed and p.event_alignment.shape[0]:
            st = _build_state(p, models, cfg)
        ws = _build_window_set(st, cfg, t_cap) if st is not None else None
        if ws is None:
            out[p.record.read_id] = EventalignResult(None, False)
            continue
        sets.append((st, ws))
    if not sets:
        return out
    dev = sets[0][0].p.events_dev.device
    if model_table is None:
        model_table = devmod.put_rep(models.pore_model.astype(np.float32), dev)
    obs_flat = _resident_obs(sets, dev)
    ranks_flat = _batch_flat_ranks([st for st, _ in sets], dev)

    lens = np.concatenate([ws.g1 - ws.g0 for _, ws in sets])
    ostarts = np.concatenate([st.flat_obs_base + ws.g0 for st, ws in sets])
    rstarts = np.concatenate([st.rank_off + ws.ri for st, ws in sets])
    ns = np.concatenate([ws.ns for _, ws in sets])
    epb = np.concatenate([np.full(ws.ri.shape[0], st.p.events_per_base)
                          for st, ws in sets])
    n_win = lens.shape[0]

    # group windows by (observation bucket, state bucket), then chunk
    tb = np.searchsorted(np.asarray(T_BUCKETS), lens, side="left")
    ns_hi = ns > N_STATE_SMALL
    chunks = []
    for bi in range(len(T_BUCKETS)):
        for hi, n_pad in ((False, N_STATE_SMALL), (True, N_STATE_PAD)):
            order = np.flatnonzero((tb == bi) & (ns_hi == hi))
            for c0 in range(0, order.shape[0], max_windows_per_batch):
                cid = order[c0 : c0 + max_windows_per_batch]
                chunks.append((cid, viterbi_windows(
                    obs_flat, ranks_flat, model_table, lens[cid],
                    ostarts[cid], rstarts[cid], ns[cid], epb[cid], hmm_probs,
                    n_pad)))
    # PAD-filter every window's path, restoring per-read window order
    path_of = [None] * n_win
    for cid, path in chunks:
        path = path.cpu().numpy()
        keep = (path & 3) != vit.KIND_PAD
        for row, wid in enumerate(cid):
            path_of[wid] = path[row][keep[row]]
    w0 = 0
    for st, ws in sets:
        w1 = w0 + ws.ri.shape[0]
        paths = path_of[w0:w1]
        w0 = w1
        steps = np.fromiter((c.shape[0] for c in paths), np.int64, len(paths))
        pos = _positions(st, ws, np.concatenate(paths), steps, cfg)
        out[st.p.record.read_id] = EventalignResult(pos, pos is not None)
    return out
