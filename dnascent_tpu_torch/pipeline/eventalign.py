"""Windowed eventalign (port of ``dnascent_tpu/pipeline/eventalign.py``).

Fast mode (detect's default, ``align --fast-windows``): every 50 bp window
of every read is built up front on the host, in one native call a batch
(windows advance by their full k-mer span, so they are independent), the
batch's observation stream is rebuilt on the device from prep's resident
fill input, one gather a fill group, and windows run through the Viterbi
fill (kernel C) and the Viterbi termination and backtrace (kernel D) in
chunks grouped by observation and state bucket.

Strict mode (``align``'s default, ``detect --strict-windows``) keeps the
reference's coupling: window n+1 starts where window n's last match ended
(alignment.cpp:738-740).  A speculative wavefront over reads runs it in
rounds: each round every read sends a chain of windows built under the fast
advance, one fill and one backtrace launch take them all, and a read commits
its chain while the chain's predictions prove true.

Either way the native post-processing turns each read's window paths into
aligned positions, and with ``collect_text`` the eventalign table (one row
per raw sample, the native formatter) is written beside them; with
``calls_per_read`` (trainCNN's second pass) called coordinates carry the
CNN's two call columns instead of becoming positions.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import ClassVar, Optional

import numpy as np
import torch

from .. import device as devmod, native
from ..config import DNA_R10, SubstrateConfig
from ..io.poremodel import PoreModelSet
from ..models.cnn import RAWDEPTH, SIG_QUANT_LO, SIG_QUANT_SCALE
from ..ops import seqcodes, viterbi as vit, viterbi_cuda
from ..utils.progress import span
from .prep import PreparedRead

HMM_KEY = ("external_D2D", "external_D2M", "external_I2M", "external_M2D",
           "internal_M2I", "internal_I2I")
# observation-count buckets (the windows' scan lengths) and the longest
# window kept; plain 50 bp windows carry <= 42 states (bucket 48), only
# breakpoint-extended windows need the full 72
T_BUCKETS = (128, 192, 256, 384, 512, 1024)
N_STATE_PAD = 72
N_STATE_SMALL = 48
# strict mode: a read's first chain is this long; it doubles on a fully
# committed chain and halves, to STRICT_SPEC_FLOOR, on a misprediction
STRICT_SPEC_START = 8
STRICT_SPEC_FLOOR = 4


@dataclass
class AlignedPositions:
    """Per-read aligned-position table in genome-walk order.  The raw-sample
    windows exist in two forms: the flat u8 sample stream plus per-position
    counts that detect's CNN takes, and ``signal``, the (P, RAWDEPTH) f32
    zero-padded windows of scaled samples that training batches take, built
    on first use from the scaled-sample store (scaled stream, each
    position's first sample, its sample count)."""

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
    # the scaled-sample store (scaled, seg_start, seg_nsig), set by
    # eventalign, and the windows built from it: a cache, not fields, so
    # the fields stay the per-position arrays
    _sig_store: ClassVar[Optional[tuple]] = None
    _signal: ClassVar[Optional[np.ndarray]] = None

    @property
    def signal(self) -> np.ndarray:
        """(P, RAWDEPTH) f32 zero-padded windows of scaled samples."""
        if self._signal is None:
            scaled, seg_start, seg_nsig = self._sig_store
            j = np.arange(RAWDEPTH)
            gidx = seg_start[:, None] + j[None, :]
            valid = j[None, :] < np.minimum(seg_nsig, RAWDEPTH)[:, None]
            self._signal = np.where(
                valid, scaled[np.clip(gidx, 0, scaled.shape[0] - 1)],
                0.0).astype(np.float32)
            self._sig_store = None
        return self._signal


@dataclass
class EventalignResult:
    positions: Optional[AlignedPositions]
    text: Optional[str]      # the read's eventalign table (collect_text)
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
    # strict mode: the read's cursors, its speculation depth, its guarded
    # pair stream (every window is a contiguous slice of it) and its
    # breakpoint positions (built on first use)
    reference_index: int = 0
    read_head: int = 0
    spec: int = STRICT_SPEC_START
    strict_jg: Optional[np.ndarray] = None    # (n_pairs+1,) cum guard count
    strict_g_ev: Optional[np.ndarray] = None  # guarded event ids
    bp_mask: Optional[np.ndarray] = None


@dataclass
class _Window:
    """One strict-mode window (alignment.cpp:555-650)."""

    state: _ReadState
    ref_index: int
    window_length: int
    event_ids: np.ndarray       # (T,) global event index per observation
    first_inrange: int          # pair index of the first in-range event
    indel_score: int
    reference_coord: int
    flat_local: int             # offset into the read's guarded stream
    # the reference index the search that found it started from (below
    # ref_index when unusable windows were skipped on the way)
    search_start: int = -1


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


@dataclass
class _Batch:
    """The native batch entry's output: each read's state and, for each
    read with a window, its window set, all views into the batch's arrays
    (window sets in state order)."""

    states: list[_ReadState]
    sets: list[tuple[_ReadState, _WindowSet]]
    codes: np.ndarray    # every read's base codes, read after read
    ri: np.ndarray       # the window arrays of the sets, set after set
    ns: np.ndarray
    g0: np.ndarray
    g1: np.ndarray


def _build_batch(prepped: list[PreparedRead], models: PoreModelSet,
                 cfg: SubstrateConfig, windows: bool) -> _Batch:
    """Every read's state and, with ``windows``, its fast-mode window set,
    from one native call over the batch.  Successful windows advance by
    their full k-mer span ``wl - k + 1`` (the JAX package's fast-mode
    departure from the reference's ``lastM_ref + 1`` coupling), so all
    windows of all reads can run in one device batch.  A read shorter than
    a k-mer gets no state, and a read with no window no window set."""
    recs = [p.record for p in prepped]
    meta = np.array([(len(r.reference_seq), p.kmer_ranks_ref.shape[0],
                      p.event_alignment.shape[0], p.event_mean.shape[0],
                      r.ref_to_query.shape[0], r.ref_start, r.ref_end,
                      r.is_reverse) for p, r in zip(prepped, recs)],
                    np.int64)
    seq = "".join(r.reference_seq for r in recs).encode("ascii")
    inputs = [np.concatenate([getattr(x, name) for x in xs]) for xs, name in (
        (prepped, "kmer_ranks_ref"), (prepped, "event_alignment"),
        (prepped, "event_mean"), (recs, "ref_to_query"))]
    with span("eventalign.window_build"):
        b = native.eventalign_batch(
            seq, meta, *inputs, models.pore_model, cfg.kmer_len,
            cfg.window_length_align, cfg.detect.event_mean_min,
            cfg.detect.event_mean_max, T_BUCKETS[-1], windows)
    offs = b.offsets.tolist()
    states, sets = [], []
    for p, (r0, k0, m0, w0, e0), (r1, k1, m1, w1, e1) in zip(
            prepped, offs, offs[1:]):
        if k1 == k0:
            continue
        st = _ReadState(p, b.codes[r0:r1], b.core[k0:k1], b.res[k0:k1],
                        b.mean_ref[m0:m1], b.defined[r0:r1], rank_off=r0)
        states.append(st)
        if w1 > w0:
            sets.append((st, _WindowSet(
                b.ri[w0:w1], b.ns[w0:w1], b.g0[w0:w1], b.g1[w0:w1],
                b.ref_coord[w0:w1], b.indel[w0:w1], b.g_ev[e0:e1])))
    return _Batch(states, sets, b.codes, b.ri, b.ns, b.g0, b.g1)


def _window_at(st: _ReadState, ri: int, cfg: SubstrateConfig, t_cap: int,
               read_head: int) -> tuple[Optional[_Window], int]:
    """Try to build a strict window at ``ri`` with the read cursor at
    ``read_head`` (alignment.cpp:555-650).  Returns (window or None, the
    advance to retry from when it is unusable)."""
    p = st.p
    k = cfg.kmer_len
    total_wl = cfg.window_length_align
    r2q = p.record.ref_to_query
    pairs = p.event_alignment
    bases_to_end = len(p.record.reference_seq) - ri
    wl = min(bases_to_end, total_wl)

    if bases_to_end > 1.5 * total_wl:
        # break-point search (alignment.cpp:562-595); the snippet must be
        # fully defined, else the window is skipped
        snip_len = int(1.5 * wl)
        if not st.defined[ri : ri + snip_len].all():
            return None, wl
        limit = int(1.5 * wl - k - 1)
        if st.bp_mask is None:
            # positions whose model-mean gaps to both neighbours exceed
            # 0.75, once per read
            m = st.mean_ref
            d1 = np.abs(np.diff(m))           # d1[i] = |m[i] - m[i+1]|
            bp = np.zeros(m.shape[0], bool)
            if m.shape[0] > 2:
                bp[1:-1] = (d1[1:] > 0.75) & (d1[:-1] > 0.75)
            st.bp_mask = bp
        hit = np.nonzero(st.bp_mask[ri + wl : ri + limit])[0]
        if hit.shape[0]:
            wl = wl + int(hit[0]) + k

    if not st.defined[ri : ri + wl].all():
        return None, wl
    lo = r2q[ri]
    hi = r2q[ri + wl - k + 1]
    # pairs[:, 1] ascending: the in-range span, from the cursor on
    j0 = max(int(np.searchsorted(pairs[:, 1], lo, side="left")), read_head)
    j1 = int(np.searchsorted(pairs[:, 1], hi, side="left"))
    if j1 <= j0:
        return None, wl
    # the window is the slice [jg[j0], jg[j1]) of the guarded stream: the
    # event-mean guard depends only on the event, so it commutes with
    # slicing pairs
    J0 = int(st.strict_jg[j0])
    J1 = int(st.strict_jg[j1])
    if J1 - J0 < 2:
        return None, wl
    nT = min(J1 - J0, t_cap)   # safety clip for pathological windows
    if p.record.is_reverse:
        ref_coord = p.record.ref_end - ri - k // 2
    else:
        ref_coord = p.record.ref_start + ri + k // 2
    return _Window(st, ri, wl, st.strict_g_ev[J0 : J0 + nT], j0,
                   int(hi - lo) - (wl - k + 1), ref_coord, J0), 0


def _advance_cursor(w: _Window, path_code: np.ndarray,
                    cfg: SubstrateConfig) -> None:
    """Strict mode: advance the read's cursors past one window's path
    (alignment.cpp:738-740): the reference to the last match's position + 1,
    the read head past the last match's event."""
    st = w.state
    path_kind, path_pos = vit.decode_path(path_code,
                                          w.window_length - cfg.kmer_len + 1)
    if path_kind.shape[0] == 0:
        st.read_head = w.first_inrange + 1
        st.reference_index = w.ref_index + 1
        return
    m_steps = np.nonzero(path_kind == vit.KIND_M)[0]
    if m_steps.shape[0]:
        last = m_steps[-1]
        last_m_ev = int(np.cumsum(path_kind != vit.KIND_D)[last] - 1)
        last_m_ref = int(path_pos[last])
    else:
        last_m_ev = 0
        last_m_ref = 0
    st.read_head = w.first_inrange + last_m_ev + 1
    st.reference_index = w.ref_index + last_m_ref + 1


def _window_set_from_windows(windows: list[_Window],
                             cfg: SubstrateConfig) -> _WindowSet:
    """A _WindowSet over a read's committed strict windows, in order, so the
    fast mode's post-processing serves strict mode too.  Each window's
    guarded event ids are concatenated into the set's stream (windows may
    overlap in events; spans are self-contained)."""
    k = cfg.kmer_len
    n = len(windows)
    ri = np.fromiter((w.ref_index for w in windows), np.int64, n)
    ns = np.fromiter((w.window_length - k + 1 for w in windows), np.int64, n)
    lens = np.fromiter((w.event_ids.shape[0] for w in windows), np.int64, n)
    g1 = np.cumsum(lens)
    g0 = g1 - lens
    rc = np.fromiter((w.reference_coord for w in windows), np.int64, n)
    indel = np.fromiter((w.indel_score for w in windows), np.int64, n)
    g_ev = np.concatenate([w.event_ids for w in windows])
    return _WindowSet(ri, ns, g0, g1, rc, indel, g_ev)


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...] for counts ci."""
    total = int(counts.sum())
    out = np.arange(total)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return out - np.repeat(starts, counts)


def _resident_obs(sets, dev) -> torch.Tensor:
    """The batch's flat f16 observation stream, gathered on the device from
    prep's resident fill inputs: a read's observations are its guarded
    events under the Theil-Sen scaling, an affine map ``a x + b`` of the
    quantile-scaled fill input.  One upload and one gather a fill group:
    the group's reads' event ids, each read's observation count, row offset
    in the group's (B_g, E_g) input and (a, b) in f32, then on the device
    the flat ids, the gather, an f32 multiply, an f32 add and the f16 cast
    (the JAX package's rounding, which its goldens carry).  The groups come
    one after another, in order of their first read; sets each read's
    ``flat_obs_base``."""
    groups: dict[int, list] = {}
    for st, ws in sets:
        groups.setdefault(id(st.p.events_dev), []).append((st, ws))
    parts = []
    base = 0
    for members in groups.values():
        events = members[0][0].p.events_dev
        r = len(members)
        # per read: observation count and fill row; scale_q, scale,
        # shift_q, shift
        ints = np.array([(ws.g_ev.shape[0], st.p.events_row)
                         for st, ws in members], np.int64)
        sc = np.array([(st.p.scale_q, st.p.scale, st.p.shift_q, st.p.shift)
                       for st, _ in members], np.float64)
        ab = np.empty((r, 2), np.float32)
        ab[:, 0] = sc[:, 0] / sc[:, 1]
        ab[:, 1] = (sc[:, 2] - sc[:, 3]) / sc[:, 1]
        ends = np.cumsum(ints[:, 0])
        n = int(ends[-1])
        for (st, _), o in zip(members, (base + ends - ints[:, 0]).tolist()):
            st.flat_obs_base = o
        buf = devmod.put_rows(np.concatenate(
            [ws.g_ev for _, ws in members]
            + [ints[:, 0], ints[:, 1] * events.shape[1],
               ab.view(np.int64).ravel()]), dev)
        rid = torch.repeat_interleave(buf[n : n + r], output_size=n)
        idx = buf[:n] + buf[n + r : n + 2 * r].index_select(0, rid)
        ab_dev = buf[n + 2 * r :].view(torch.float32).view(r, 2)
        vals = events.reshape(-1).index_select(0, idx)
        parts.append((vals * ab_dev[:, 0].index_select(0, rid)
                      + ab_dev[:, 1].index_select(0, rid)).to(torch.float16))
        base += n
    return torch.cat(parts)


def _strict_obs(states: list[_ReadState], cfg: SubstrateConfig,
                dev) -> torch.Tensor:
    """Strict mode's flat observation stream: each read's guarded event
    means under its Theil-Sen scaling, in f64 arithmetic cast to f32 (not
    the fast path's f16: the JAX package's strict windows see f32, and f16
    would flip its paths at ties).  Sets each read's guarded pair stream and
    its offset in the batch."""
    dmin, dmax = cfg.detect.event_mean_min, cfg.detect.event_mean_max
    parts = []
    base = 0
    for st in states:
        p = st.p
        pairs = p.event_alignment
        means = p.event_mean[pairs[:, 0]]
        guard = (means > dmin) & (means < dmax)
        st.strict_jg = np.concatenate([[0], np.cumsum(guard)]).astype(np.int64)
        st.strict_g_ev = pairs[guard, 0]
        parts.append(((means[guard] - p.shift) / p.scale).astype(np.float32))
        st.flat_obs_base = base
        base += parts[-1].shape[0]
    return devmod.put_rows(np.concatenate(parts), dev)


def _batch_flat_ranks(codes: np.ndarray, dev) -> torch.Tensor:
    """One flat rank stream for the batch, built on the device from the
    batch's reference base codes (window rank starts are a state's
    ``rank_off + ri``)."""
    # the u8 view maps -1 (non-ACGT) to 255
    return seqcodes.flat_ranks_from_codes(
        devmod.put_rows(codes.view(np.uint8), dev))


def viterbi_windows(obs_flat: torch.Tensor, ranks_flat: torch.Tensor,
                    model_table: torch.Tensor, lens: np.ndarray,
                    ostarts: np.ndarray, rstarts: np.ndarray, ns: np.ndarray,
                    epb: np.ndarray, hmm_probs, n_state_pad: int):
    """One chunk of windows through fill (kernel C) and termination and
    backtrace (kernel D).  Returns (path (W, s_pad) u8, path_len (W,) i32)
    on the device, each row's codes in forward order, left-aligned."""
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
    # backtrace length bound from the chunk's true maxima, bucketed to 64
    bt_len = -(-(int(lens.max()) + int(ns.max()) + 2) // 64) * 64
    return viterbi_cuda.viterbi_terminate_backtrace(
        codes, I_fin, M_fin, D_fin, n_obs, n_states, eM2MorD, logs[2],
        min(bt_len, T + N))


def _read_paths(chunks, n_win: int, counts: np.ndarray):
    """The chunks' left-aligned paths, as each read's concatenated codes in
    window order and its windows' step counts (``counts`` windows a read,
    in window order).  Whole-batch array work: one download of each chunk's
    live columns, one scatter into the window-ordered stream."""
    steps = np.zeros(n_win, dtype=np.int64)
    rows = []
    for cid, path, path_len in chunks:
        plen = devmod.to_host(path_len).astype(np.int64)
        width = int(plen.max()) if plen.shape[0] else 0
        rows.append((cid, devmod.to_host(path[:, :width]), plen))
        steps[cid] = plen
    offs = np.concatenate(([0], np.cumsum(steps)))
    flat = np.empty(int(offs[-1]), dtype=np.uint8)
    for cid, codes, plen in rows:
        col = np.arange(codes.shape[1])
        keep = col[None, :] < plen[:, None]
        flat[(offs[cid][:, None] + col[None, :])[keep]] = codes[keep]
    ends = np.cumsum(counts)
    return [(flat[offs[w1 - c]:offs[w1]], steps[w1 - c:w1])
            for c, w1 in zip(counts, ends)]


def _fast_paths(batch: _Batch, cfg, dev, model_table, hmm_probs,
                max_windows_per_batch):
    """Fast mode: [(state, window set, codes, steps a window)] for every
    read that has windows."""
    sets = batch.sets
    with span("eventalign.windows"):
        obs_flat = _resident_obs(sets, dev)
        ranks_flat = _batch_flat_ranks(batch.codes, dev)
        # the batch's window arrays, with each window's read
        counts, obs_base, rank_off = np.array(
            [(ws.ri.shape[0], st.flat_obs_base, st.rank_off)
             for st, ws in sets], np.int64).T
        win_read = np.repeat(np.arange(len(sets)), counts)
        lens = batch.g1 - batch.g0
        ostarts = obs_base[win_read] + batch.g0
        rstarts = rank_off[win_read] + batch.ri
        ns = batch.ns
        epb = np.fromiter((st.p.events_per_base for st, _ in sets),
                          np.float64, len(sets))[win_read]

    with span("eventalign.viterbi"):
        # group windows by (observation bucket, state bucket), then chunk
        tb = np.searchsorted(np.asarray(T_BUCKETS), lens, side="left")
        ns_hi = ns > N_STATE_SMALL
        chunks = []
        for bi in range(len(T_BUCKETS)):
            for hi, n_pad in ((False, N_STATE_SMALL), (True, N_STATE_PAD)):
                order = np.flatnonzero((tb == bi) & (ns_hi == hi))
                for c0 in range(0, order.shape[0], max_windows_per_batch):
                    cid = order[c0 : c0 + max_windows_per_batch]
                    chunks.append((cid, *viterbi_windows(
                        obs_flat, ranks_flat, model_table, lens[cid],
                        ostarts[cid], rstarts[cid], ns[cid], epb[cid],
                        hmm_probs, n_pad)))
        paths = _read_paths(chunks, lens.shape[0], counts)
    return [(st, ws, codes, steps)
            for (st, ws), (codes, steps) in zip(sets, paths)]


def _strict_chain(st: _ReadState, cfg: SubstrateConfig, t_cap: int,
                  depth: int) -> list[_Window]:
    """Up to ``depth`` windows from the read's true cursors on, each next
    one built under the fast-mode advance (a full k-mer span; the last path
    step is almost always a match, so lastM_ref + 1 == span) with the
    previous window's first in-range pair as the read-head bound."""
    k = cfg.kmer_len
    n_starts = len(st.p.record.reference_seq) - k + 1
    ri, rh = st.reference_index, st.read_head
    chain: list[_Window] = []
    while len(chain) < depth:
        w = None
        start = ri
        while ri < n_starts:
            w, skip = _window_at(st, ri, cfg, t_cap, rh)
            if w is not None:
                break
            ri += skip
        if w is None:
            break
        w.search_start = start
        chain.append(w)
        ri = w.ref_index + w.window_length - k + 1
        rh = w.first_inrange
    return chain


def _strict_round(windows: list[_Window], obs_flat, ranks_flat, model_table,
                  cfg, hmm_probs, max_windows_per_batch) -> list[np.ndarray]:
    """One wavefront round: the windows through kernels C and D (one launch
    each for up to ``max_windows_per_batch`` windows, at the round's largest
    observation and state buckets), then one download.  Returns each
    window's path codes."""
    k = cfg.kmer_len
    out = []
    for c0 in range(0, len(windows), max_windows_per_batch):
        chunk = windows[c0 : c0 + max_windows_per_batch]
        n = len(chunk)
        ns = np.fromiter((w.window_length - k + 1 for w in chunk), np.int64, n)
        path, path_len = viterbi_windows(
            obs_flat, ranks_flat, model_table,
            np.fromiter((w.event_ids.shape[0] for w in chunk), np.int64, n),
            np.fromiter((w.state.flat_obs_base + w.flat_local
                         for w in chunk), np.int64, n),
            np.fromiter((w.state.rank_off + w.ref_index for w in chunk),
                        np.int64, n),
            ns, np.fromiter((w.state.p.events_per_base for w in chunk),
                            np.float64, n),
            hmm_probs,
            N_STATE_SMALL if int(ns.max()) <= N_STATE_SMALL else N_STATE_PAD)
        plen = devmod.to_host(path_len)
        rows = devmod.to_host(path[:, : int(plen.max())])
        out += [rows[i, : plen[i]] for i in range(n)]
    return out


def _strict_paths(batch: _Batch, cfg, dev, model_table, hmm_probs,
                  max_windows_per_batch, spec_depth):
    """Strict mode's speculative wavefront.  Each round every active read
    sends a chain of ``min(its depth, spec_depth)`` windows; a chain's
    window is committed only while the search that found it started at the
    read's true reference cursor and the true read head is at most its
    first in-range pair.  Then it is the window the sequential loop builds:
    j0 = max(searchsorted, read_head) gives the same span, and a window
    skipped under the lower read-head bound is skipped under the true one.
    A mispredicted tail is dropped and rebuilt from the true cursors next
    round, so the result is the sequential loop's at any depth.  (The JAX
    package compares the window's own start with the cursor instead: the
    same wherever no window was skipped, but a window reached past a
    skipped one, e.g. after an N run in the reference, never commits there,
    and its wavefront does not end.)  Returns [(state, window set,
    codes, steps a window)] for every read with a committed window."""
    t_cap = T_BUCKETS[-1]
    states = batch.states
    obs_flat = _strict_obs(states, cfg, dev)
    ranks_flat = _batch_flat_ranks(batch.codes, dev)
    committed = {id(st): [] for st in states}
    active = states
    while True:
        chains = [(st, _strict_chain(st, cfg, t_cap, min(st.spec,
                                                         spec_depth)))
                  for st in active]
        chains = [(st, c) for st, c in chains if c]
        windows = [w for _, c in chains for w in c]
        if not windows:
            break
        codes = iter(_strict_round(windows, obs_flat, ranks_flat,
                                   model_table, cfg, hmm_probs,
                                   max_windows_per_batch))
        for st, chain in chains:
            ok = True
            for w, pc in zip(chain, codes):
                if ok and (w.search_start != st.reference_index
                           or st.read_head > w.first_inrange):
                    ok = False
                if ok:
                    _advance_cursor(w, pc, cfg)
                    committed[id(st)].append((w, pc))
            st.spec = (min(st.spec * 2, spec_depth) if ok
                       else max(STRICT_SPEC_FLOOR, st.spec // 2))
        active = [st for st, _ in chains]
    out = []
    for st in states:
        done = committed[id(st)]
        if done:
            pcs = [pc for _, pc in done]
            out.append((st, _window_set_from_windows([w for w, _ in done],
                                                     cfg),
                        np.concatenate(pcs),
                        np.fromiter((pc.shape[0] for pc in pcs), np.int64,
                                    len(pcs))))
    return out


def _positions(st: _ReadState, ws: _WindowSet, codes: np.ndarray,
               steps_per: np.ndarray, cfg: SubstrateConfig
               ) -> Optional[AlignedPositions]:
    """Native post-processing of all of a read's window paths."""
    p = st.p
    ns = ws.ns.astype(np.int64)
    with span("eventalign.postprocess"):
        (coord, kmer_start, query_idx, ref_idx, core, res, nsig, centerT,
         indel, sig_flat, store) = native.process_read_windows(
            codes, steps_per, ns, ws.g_ev, ws.g0, ws.ri, ws.ref_coord,
            ws.indel, p.record.is_reverse, cfg.kmer_len, p.event_raw_start,
            p.event_raw_end, p.record.raw, p.shift, p.scale,
            p.record.ref_to_query, st.core_rank, st.res_rank, st.ref_codes,
            SIG_QUANT_LO, SIG_QUANT_SCALE, RAWDEPTH)
    if coord.shape[0] == 0:
        return None
    pos = AlignedPositions(
        coord=coord, kmer_start=kmer_start, query_idx=query_idx,
        ref_idx=ref_idx, core_idx=core, residual_idx=res, n_signals=nsig,
        center_is_T=centerT, indel_score=indel, signal_u8_flat=sig_flat,
        signal_counts=np.minimum(nsig, RAWDEPTH).astype(np.uint8))
    pos._sig_store = store
    return pos


def _drop_called(pos: AlignedPositions,
                 calls: dict) -> Optional[AlignedPositions]:
    """The positions whose coordinate has no call (trainCNN's second pass
    prints the calls there instead; JAX ``_process_window``), or None when
    none is left."""
    keep = ~np.isin(pos.coord, np.fromiter(calls, np.int64, len(calls)))
    if not keep.any():
        return None
    flat_keep = np.repeat(keep, pos.signal_counts.astype(np.int64))
    out = AlignedPositions(**{
        f.name: getattr(pos, f.name)[flat_keep if f.name == "signal_u8_flat"
                                     else keep]
        for f in dataclasses.fields(pos)})
    scaled, seg_start, seg_nsig = pos._sig_store
    out._sig_store = (scaled, seg_start[keep], seg_nsig[keep])
    return out


def _read_text(st: _ReadState, ws: _WindowSet, codes: np.ndarray,
               steps: np.ndarray, cfg: SubstrateConfig,
               calls: Optional[dict]) -> str:
    """The read's eventalign rows (alignment.cpp:701-733), all windows at
    once: per window, one row per raw sample of each match step's event
    (M rows print the f32-cast scaled sample and the model mean, with the
    two call columns where the coordinate has a call) and of each insertion
    step's event before the window's last match (unrounded f64 sample, N^k,
    mean 0); deletions print nothing.  Byte-equal to the JAX package's
    per-window ``_append_window_text`` and, with calls, ``_emit_text``."""
    p = st.p
    k = cfg.kmer_len
    n_win = steps.shape[0]
    if codes.shape[0] == 0:
        return ""
    kinds = codes & 3
    win = np.repeat(np.arange(n_win), steps)
    first = np.cumsum(steps) - steps          # each window's first step
    # positions: anchored at ns - 1 on each window's last step
    dsum = np.concatenate(([0], np.cumsum((codes >> 2) & 1, dtype=np.int64)))
    pos = (ws.ns[win] - 1) - (dsum[(first + steps)[win]]
                              - dsum[1 : codes.shape[0] + 1])
    # evIdx: a window's running count of non-deletion steps, minus one
    nd = np.concatenate(([0], np.cumsum(kinds != vit.KIND_D,
                                        dtype=np.int64)))
    ev = nd[1:] - 1 - nd[first[win]]
    is_m = kinds == vit.KIND_M
    m_idx = np.flatnonzero(is_m)
    last_m_ev = np.zeros(n_win, np.int64)
    if m_idx.shape[0]:
        mw = win[m_idx]
        last = m_idx[np.r_[mw[1:] != mw[:-1], True]]
        last_m_ev[win[last]] = ev[last]
    # insertions after the last match are suppressed (alignment.cpp:728)
    is_i = (kinds == vit.KIND_I) & (ev < last_m_ev[win])
    sel = np.flatnonzero(is_m | is_i)
    if sel.shape[0] == 0:
        return ""
    sw = win[sel]
    e_g = ws.g_ev[ws.g0[sw] + ev[sel]]
    rs, re_ = p.event_raw_start, p.event_raw_end
    counts = (re_[e_g] - rs[e_g] + 1).astype(np.int64)
    vals = (p.record.raw[np.repeat(rs[e_g], counts) + _ranges(counts)]
            - p.shift) / p.scale
    spos = pos[sel]
    if p.record.is_reverse:
        coords = ws.ref_coord[sw] - spos - 1
    else:
        coords = ws.ref_coord[sw] + spos
    kstarts = ws.ri[sw] + spos
    row_coord = np.repeat(coords, counts)
    row_ins = np.repeat(is_i[sel], counts)
    # M rows print the f32-cast scaled value, insertion rows the unrounded
    # one: the two dtypes of the JAX package's per-row branches
    row_val = np.where(row_ins, vals.astype(np.float64),
                       vals.astype(np.float32).astype(np.float64))
    row_calls = None
    if calls:
        keys = np.fromiter(calls, np.int64, len(calls))
        order = np.argsort(keys)
        keys = keys[order]
        ce = np.array([calls[c][0] for c in keys], np.float64)
        cb = np.array([calls[c][1] for c in keys], np.float64)
        at = np.clip(np.searchsorted(keys, row_coord), 0, keys.shape[0] - 1)
        has = ~row_ins & (keys[at] == row_coord)
        row_calls = (has.astype(np.uint8), ce[at], cb[at])
    return native.format_eventalign_rows(
        row_coord, np.repeat(kstarts, counts), row_ins.astype(np.uint8),
        row_val, np.repeat(st.mean_ref[kstarts], counts),
        p.record.reference_seq, k, p.record.is_reverse, calls=row_calls)


def run_eventalign(prepped: list[PreparedRead], models: PoreModelSet,
                   cfg: SubstrateConfig = DNA_R10, collect_text: bool = False,
                   calls_per_read: Optional[dict] = None,
                   strict: bool = False, spec_depth: int = 64,
                   max_windows_per_batch: int = 8192,
                   model_table: Optional[torch.Tensor] = None,
                   ) -> dict[str, EventalignResult]:
    """Eventalign for a batch of prepared reads, on the device that holds
    their resident fill inputs; fast mode, or with ``strict`` the
    reference's window coupling, speculating at most ``spec_depth`` windows
    a read a round (any depth gives the same result).  ``collect_text``
    writes each read's eventalign table into its result;
    ``calls_per_read`` ({read_id: {coord: (EdU, BrdU)}}) adds the call
    columns there and drops the called coordinates from the positions.
    Returns {read_id: EventalignResult}; reads that failed earlier stages,
    or kept no position, come back with qc_passed=False."""
    hmm_probs = tuple(getattr(cfg.hmm, k) for k in HMM_KEY)
    out: dict[str, EventalignResult] = {}
    with span("eventalign.windows"):
        live = []
        for p in prepped:
            if p.passed and p.event_alignment.shape[0]:
                live.append(p)
            else:
                out[p.record.read_id] = EventalignResult(None, None, False)
        if not live:
            return out
        batch = _build_batch(live, models, cfg, not strict)
    paths = []
    if batch.states:
        dev = live[0].events_dev.device
        if model_table is None:
            model_table = devmod.put_rows(
                models.pore_model.astype(np.float32), dev)
        if strict:
            paths = _strict_paths(batch, cfg, dev, model_table, hmm_probs,
                                  max_windows_per_batch, spec_depth)
        elif batch.sets:
            paths = _fast_paths(batch, cfg, dev, model_table, hmm_probs,
                                max_windows_per_batch)
    for st, ws, codes, steps in paths:
        rec = st.p.record
        calls = (None if calls_per_read is None
                 else calls_per_read.get(rec.read_id))
        pos = _positions(st, ws, codes, steps, cfg)
        if pos is not None and calls:
            pos = _drop_called(pos, calls)
        text = None
        if pos is not None and collect_text:
            text = (f">{rec.read_id} {rec.contig} {rec.ref_start} "
                    f"{rec.ref_end} {rec.strand}\n"
                    + _read_text(st, ws, codes, steps, cfg, calls))
        out[rec.read_id] = EventalignResult(pos, text, pos is not None)
    for p in live:
        out.setdefault(p.record.read_id, EventalignResult(None, None, False))
    return out
