"""ctypes loader for the port's host C++ library (``dnascent_native.cpp``
and ``baseline_cpu.cpp``, one shared object).

The port's copies of entries of ``dnascent_tpu/native``, and its own: event
detection, the chase's move decode, prep's batch entries (every read's
k-mer ranks and quantile scaling in one call a batch, a fill group's padded
rows, and a fill group's move decode, banded QC and Theil-Sen subsample in
one call), eventalign's batch entry (every read's state arrays and
fast-mode window chain in one call) and window post-processing, seeBreaks'
libstdc++-exact bootstrap streams, the eventalign table's row formatter
(which, unlike the original, refuses rather than cuts a row that overflows
its buffer, and also writes trainCNN's call columns) and the benchmark-only
scalar CPU baseline of the detect hot path.  The library is built with ``g++`` at first use into
``build/torch_native/`` at the repository root (never into the package), and
rebuilt when either source is newer than the library.  ``available()`` is False
when it cannot be built or loaded; prep and eventalign need the library, so
detect, align and trainCNN then fail at their first batch.
"""

from __future__ import annotations

import ctypes
import os
from collections import namedtuple
import subprocess
import threading
import time

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
# baseline_cpu.cpp calls event_detect_single of dnascent_native.cpp, so
# both build into one library
_SRCS = [os.path.join(_HERE, "dnascent_native.cpp"),
         os.path.join(_HERE, "baseline_cpu.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "torch_native")
_LIB = os.path.join(BUILD_DIR, "libdnascent_native.so")

_lock = threading.Lock()
_lib = None
_load_error: Exception | None = None


def _build() -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # a private temporary name, then an atomic rename: a concurrent process
    # never loads a half-written library
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
           *_SRCS, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)


def _load():
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            if (not os.path.exists(_LIB)
                    or any(os.path.getmtime(_LIB) < os.path.getmtime(src)
                           for src in _SRCS)):
                _build()
            lib = ctypes.CDLL(_LIB)
            i64 = ctypes.c_int64
            u32 = ctypes.c_uint32
            f32 = ctypes.c_float
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.event_detect_single.restype = i64
            lib.event_detect_single.argtypes = [
                f64p, i64, i64, i64, f32, f32, f32, f64p, i64p, i64p, i64,
                i64p,
            ]
            lib.process_read_windows.restype = i64
            lib.process_read_windows.argtypes = [
                u8p, i64p, i64p, i64p, i64p, i64p, i64p, i64p,
                i64, i64, i64,
                i64p, i64p, f64p, ctypes.c_double, ctypes.c_double,
                i64p, i64p, i64p, i8p,
                f32, f32, i64,
                i64p, i64p, i64p, i64p, i64p, i64p, i64p, u8p, i64p,
                u8p, i64p, f32p, i64, i64p, i64p,
            ]
            dbl = ctypes.c_double
            lib.eventalign_batch.restype = i64
            lib.eventalign_batch.argtypes = [
                u8p, i64p, i64, i64p, i64p, f64p, i64p, f64p, i64,
                i64, i64, dbl, dbl, i64, i64,
                i8p, u8p, i64p, i64p, f64p, i64p, i64p, i64p, i64p, i64p,
                i64p, i64p, i64p,
            ]
            lib.decode_moves.restype = i64
            lib.decode_moves.argtypes = [
                u8p, i64, i64, i64, i64, i64,
                f64p, f32p, f32p, f32p, f32p, i64p, i64p, i64,
                i64p, i64, f64p, i64p, f64p,
            ]
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            vp = ctypes.c_void_p
            lib.prep_scale_batch.restype = i64
            lib.prep_scale_batch.argtypes = [
                u8p, u8p, i64p, i64, f64p, f64p, i64, i64, i64,
                i64p, i64p, u8p, f64p, f64p,
            ]
            lib.prep_fill_rows.restype = i64
            lib.prep_fill_rows.argtypes = [
                f64p, i64p, i64p, i64, f64p, f64p, i64, i64, i64,
                vp, i64, f32, f32p, vp, vp, i32p, i32p,
            ]
            lib.prep_decode_group.restype = i64
            lib.prep_decode_group.argtypes = [
                u8p, i64, i64, i32p, i64, i64p, f64p, i64p, i64p,
                i64p, f32p, i64, f32p, f32p, f32p, i64,
                dbl, i64, i64, i64, i64,
                i64p, i64, i64p, u8p, f32p, f32p, i32p, u8p,
            ]
            lib.seebreaks_simulation.restype = None
            lib.seebreaks_simulation.argtypes = [
                i64p, i64p, i64, i64p, i64, i64, i64, u32, i64, i64, f64p,
            ]
            lib.seebreaks_observation.restype = None
            lib.seebreaks_observation.argtypes = [u8p, i64, u32, i64, f64p]
            lib.seebreaks_difference.restype = None
            lib.seebreaks_difference.argtypes = [
                ctypes.c_double, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, i64, u32, f64p,
            ]
            lib.format_eventalign_rows.restype = i64
            lib.format_eventalign_rows.argtypes = [
                i64p, i64p, u8p, f64p, f64p, u8p, f64p, f64p, i64,
                ctypes.c_char_p, i64, i64, i64, ctypes.c_char_p, i64,
            ]
            lib.baseline_detect_read.restype = dbl
            lib.baseline_detect_read.argtypes = [
                f64p, i64, i64p, i64, i64p, i64, i64p, f64p, i64,
                i64, i64, dbl, dbl, dbl,
                i64, i64, i64,
                i64, dbl, dbl, dbl, i64, i64,
                f64p, i64, i64,
            ]
            _lib = lib
        except Exception as e:  # pragma: no cover
            _load_error = e
    return _lib


def available() -> bool:
    return _load() is not None


def get_lib():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"dnascent_native unavailable: {_load_error}")
    return lib


# ---------------------------------------------------------------------------
# High-level wrappers
# ---------------------------------------------------------------------------

def event_detect(raw: np.ndarray, w1: int = 3, w2: int = 6,
                 thresh1: float = 1.4, thresh2: float = 9.0,
                 peak_height: float = 0.2):
    """Native event detection + merge.  Returns (mean, raw_start, raw_end,
    et_n) mirroring dnascent_tpu's ops.reference.merge_events(detect_events(
    raw))."""
    lib = get_lib()
    raw = np.ascontiguousarray(raw, dtype=np.float64)
    n = raw.shape[0]
    max_out = n + 1
    mean = np.empty(max_out, dtype=np.float64)
    start = np.empty(max_out, dtype=np.int64)
    end = np.empty(max_out, dtype=np.int64)
    et_n = np.zeros(1, dtype=np.int64)
    m = lib.event_detect_single(raw, n, w1, w2, np.float32(thresh1),
                                np.float32(thresh2), np.float32(peak_height),
                                mean, start, end, max_out, et_n)
    return mean[:m].copy(), start[:m].copy(), end[:m].copy(), int(et_n[0])


# one row a read of eventalign_batch's ``meta``
EVENTALIGN_META = ("ref_len", "n_kmer_ranks", "n_pairs", "n_events",
                   "n_ref_to_query", "ref_start", "ref_end", "is_reverse")
EventalignBatch = namedtuple(
    "EventalignBatch", "codes defined core res mean_ref ri ns g0 g1 "
    "ref_coord indel g_ev offsets")
_BATCH_ERRORS = {
    -1: "k must be at least 9",
    -2: "a k-mer rank lies outside the pore model table",
    -3: "a pair's event id lies outside its read's events",
    -4: "a reference index lies outside its read's ref_to_query",
}


def eventalign_batch(seq: bytes, meta: np.ndarray, kmer_ranks: np.ndarray,
                     pairs: np.ndarray, event_mean: np.ndarray,
                     ref_to_query: np.ndarray, pore_model: np.ndarray,
                     k: int, total_wl: int, event_mean_min: float,
                     event_mean_max: float, t_cap: int,
                     windows: bool = True) -> EventalignBatch:
    """Eventalign's state arrays and, with ``windows``, its fast-mode window
    sets for a batch of reads in one call (the native twin of the JAX
    package's eventalign._build_state and _build_window_set, read by read).
    The inputs are concatenated in read order; ``meta`` has one row a read,
    the columns of ``EVENTALIGN_META``.  Returns the outputs concatenated in
    read order, and ``offsets``, (reads + 1, 5) rows of each read's start in
    [codes and defined, core and res, mean_ref, the window arrays, g_ev]; a
    read with no window has none and no g_ev either."""
    lib = get_lib()
    meta = np.ascontiguousarray(meta, np.int64).reshape(
        -1, len(EVENTALIGN_META))
    n = meta.shape[0]
    n_ref, n_rank, n_pairs, n_ev, n_r2q = (int(x) for x in
                                            meta[:, :5].sum(axis=0))
    seq = np.frombuffer(seq, np.uint8)
    kmer_ranks = np.ascontiguousarray(kmer_ranks, np.int64)
    pairs = np.ascontiguousarray(pairs, np.int64)
    event_mean = np.ascontiguousarray(event_mean, np.float64)
    ref_to_query = np.ascontiguousarray(ref_to_query, np.int64)
    pore_mean = np.ascontiguousarray(pore_model[:, 0], np.float64)
    if (seq.shape[0], kmer_ranks.shape[0], pairs.shape, event_mean.shape[0],
            ref_to_query.shape[0]) != (n_ref, n_rank, (n_pairs, 2), n_ev,
                                       n_r2q):
        raise ValueError("eventalign_batch: inputs do not match meta")
    n_kmer = int(np.maximum(meta[:, 0] - k + 1, 0).sum())
    codes = np.empty(n_ref, np.int8)
    defined = np.empty(n_ref, np.uint8)
    core = np.empty(n_kmer, np.int64)
    res = np.empty(n_kmer, np.int64)
    mean_ref = np.empty(n_rank, np.float64)
    # at most one window a k-mer start, and one more, a read
    win = [np.empty(n_ref + n, np.int64) for _ in range(6)]
    g_ev = np.empty(n_pairs, np.int64)
    offsets = np.empty((n + 1, 5), np.int64)
    n_win = int(lib.eventalign_batch(
        seq, meta, n, kmer_ranks, pairs, event_mean, ref_to_query, pore_mean,
        pore_mean.shape[0], int(k), int(total_wl),
        float(event_mean_min), float(event_mean_max), int(t_cap),
        int(bool(windows)), codes, defined, core, res, mean_ref, *win, g_ev,
        offsets))
    if n_win < 0:
        raise ValueError(f"eventalign_batch: {_BATCH_ERRORS[n_win]}")
    return EventalignBatch(codes, defined.view(np.bool_), core, res,
                           mean_ref, *(w[:n_win] for w in win),
                           g_ev[: int(offsets[n, 4])], offsets)


def decode_moves(packed: np.ndarray, col: int, best_event: int, n_kmers: int,
                 event_means: np.ndarray, scaled_events: np.ndarray,
                 mu: np.ndarray, inv_sigma: np.ndarray, lp_const: np.ndarray,
                 query_to_ref: np.ndarray, kmer_ranks_ref: np.ndarray):
    """Native decode of one read's packed 2-bit move stream (GIL-released
    twin of ops.banded.decode_moves_host).  Returns (pairs (n,2),
    cleaned_signals, cleaned_ranks, avg_log_emission, spanned, max_gap)."""
    lib = get_lib()
    rows, B = packed.shape
    max_pairs = rows * 4 + 1
    pairs = np.empty(max_pairs * 2, dtype=np.int64)
    cs = np.empty(max_pairs, dtype=np.float64)
    cr = np.empty(max_pairs, dtype=np.int64)
    stats = np.zeros(5, dtype=np.float64)
    m = lib.decode_moves(
        np.ascontiguousarray(packed, dtype=np.uint8), rows, B, int(col),
        int(best_event), int(n_kmers),
        np.ascontiguousarray(event_means, dtype=np.float64),
        np.ascontiguousarray(scaled_events, dtype=np.float32),
        np.ascontiguousarray(mu, dtype=np.float32),
        np.ascontiguousarray(inv_sigma, dtype=np.float32),
        np.ascontiguousarray(lp_const, dtype=np.float32),
        np.ascontiguousarray(query_to_ref, dtype=np.int64),
        np.ascontiguousarray(kmer_ranks_ref, dtype=np.int64),
        int(kmer_ranks_ref.shape[0]),
        pairs, max_pairs, cs, cr, stats)
    m = int(m)
    n_cleaned = int(stats[4])
    return (pairs[: 2 * m].reshape(-1, 2).copy(), cs[:n_cleaned].copy(),
            cr[:n_cleaned].copy(), float(stats[0]), bool(stats[1]),
            int(stats[2]))


# one row a read of prep_scale_batch's ``meta``
PREP_META = ("basecall_len", "ref_len", "n_events")
PrepScale = namedtuple("PrepScale", "rq rr too_few shift scale")
_PREP_ERRORS = {
    "prep_scale_batch": {-1: "k must lie in 1..31 and n_quantiles be "
                             "positive"},
    "prep_decode_group": {-1: "the pairs overflow their buffer"},
}


def _prep_error(name: str, err: int) -> None:
    if err == -2:
        raise ValueError(f"{name}: a k-mer rank lies outside the table")
    if err:
        raise ValueError(f"{name}: {_PREP_ERRORS[name][err]}")


def prep_scale_batch(query: bytes, ref: bytes, meta: np.ndarray,
                     event_mean: np.ndarray, pore_mean: np.ndarray, k: int,
                     n_quantiles: int) -> PrepScale:
    """Every read's k-mer ranks and quantile scaling for a batch in one call:
    the native twin of ``utils.seqtools.kmer_ranks`` of the basecall and of
    the reference, then ``ops.scaling.estimate_scaling_quantiles`` of the
    events against the reference k-mers' model means (undefined k-mers read
    as rank 0), read by read, bit for bit.  The inputs are concatenated in
    read order; ``meta`` has one row a read, the columns of ``PREP_META``;
    ``pore_mean`` is the pore table's mean a k-mer rank, as f64.  Returns
    the query and reference ranks concatenated in read order (-1 for a k-mer
    with a base outside ACGT), ``too_few`` for a read with fewer than two
    events, query k-mers or reference k-mers (shift 0 and scale 1), and each
    read's shift and scale."""
    lib = get_lib()
    meta = np.ascontiguousarray(meta, np.int64).reshape(-1, len(PREP_META))
    n = meta.shape[0]
    query = np.frombuffer(query, np.uint8)
    ref = np.frombuffer(ref, np.uint8)
    event_mean = np.ascontiguousarray(event_mean, np.float64)
    if (meta < 0).any() or (query.shape[0], ref.shape[0],
                            event_mean.shape[0]) != tuple(
            int(x) for x in meta.sum(axis=0)):
        raise ValueError("prep_scale_batch: inputs do not match meta")
    pore_mean = np.ascontiguousarray(pore_mean, np.float64)
    if pore_mean.ndim != 1:
        raise ValueError("prep_scale_batch: pore_mean must be one mean a "
                         "k-mer rank")
    n_kmers = np.maximum(meta[:, :2] - int(k) + 1, 0).sum(axis=0)
    rq, rr = (np.empty(int(c), np.int64) for c in n_kmers)
    too_few = np.empty(n, np.uint8)
    shift, scale = np.empty(n), np.empty(n)
    _prep_error("prep_scale_batch", int(lib.prep_scale_batch(
        query, ref, meta, n, event_mean, pore_mean, pore_mean.shape[0],
        int(k), int(n_quantiles), rq, rr, too_few, shift, scale)))
    return PrepScale(rq, rr, too_few.view(np.bool_), shift, scale)


def _void(a):
    return None if a is None else a.ctypes.data_as(ctypes.c_void_p)


def _read_offsets(name: str, offsets: np.ndarray, *arrays):
    """``offsets`` as the prep calls take them, the (reads + 1, columns)
    starts of each read in ``arrays`` (one a column, concatenated in read
    order), checked against them, with each read's counts (reads,
    columns)."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    if (offsets.ndim != 2 or offsets.shape[1] != len(arrays)
            or offsets.shape[0] < 1 or offsets[0].any()
            or (np.diff(offsets, axis=0) < 0).any()
            or any(offsets[-1, c] > a.shape[0]
                   for c, a in enumerate(arrays))):
        raise ValueError(f"{name}: offsets do not lay out the arrays")
    return offsets, np.diff(offsets, axis=0)


def prep_fill_rows(event_mean: np.ndarray, rq: np.ndarray,
                   offsets: np.ndarray, shift: np.ndarray,
                   scale: np.ndarray, B: int, E: int, K: int,
                   table: np.ndarray | None = None, pad: float = np.inf):
    """The padded host rows of one fill launch over the reads whose events
    and query ranks are concatenated at ``offsets`` ((reads + 1, 2) starts
    of [events, query ranks]), with their ``shift`` and ``scale``.  Returns
    (scaled (B, E) f32, (mean - shift) / scale and 0 past each read's
    events; (B, K), with ``table`` its f32 values at the query ranks and
    ``pad`` past each read's k-mers, else the ranks, -1 past them; n_events
    and n_kmers (B,) i32).  Undefined k-mers read as rank 0
    (data_IO.cpp:131); rows from the number of reads on are padding."""
    lib = get_lib()
    event_mean = np.ascontiguousarray(event_mean, np.float64)
    rq = np.ascontiguousarray(rq, np.int64)
    offsets, counts = _read_offsets("prep_fill_rows", offsets, event_mean,
                                    rq)
    n = counts.shape[0]
    shift = np.ascontiguousarray(shift, np.float64)
    scale = np.ascontiguousarray(scale, np.float64)
    if n > min(B, shift.shape[0], scale.shape[0]) or (n and (
            counts[:, 0].max() > E or counts[:, 1].max() > K)):
        raise ValueError("prep_fill_rows: the reads do not fit (B, E, K)")
    scaled = np.empty((B, E), np.float32)
    if table is None:
        ranks = out = np.empty((B, K), np.int64)
        gathered = None
    else:
        table = np.ascontiguousarray(table, np.float32)
        gathered = out = np.empty((B, K), np.float32)
        ranks = None
    n_ev, n_km = np.empty(B, np.int32), np.empty(B, np.int32)
    _prep_error("prep_fill_rows", int(lib.prep_fill_rows(
        event_mean, rq, offsets, n, shift, scale, int(B), int(E), int(K),
        _void(table), 0 if table is None else table.shape[0],
        np.float32(pad), scaled, _void(ranks), _void(gathered), n_ev,
        n_km)))
    return scaled, out, n_ev, n_km


def prep_decode_group(packed: np.ndarray, best_event: np.ndarray,
                      offsets: np.ndarray, event_mean: np.ndarray,
                      rq: np.ndarray, rr: np.ndarray, q2r: np.ndarray,
                      scaled: np.ndarray, tables, min_avg_emission: float,
                      max_gap_threshold: int, min_cleaned_events: int,
                      max_points: int, trim: int, sig: np.ndarray,
                      mms: np.ndarray, npts: np.ndarray,
                      passth: np.ndarray):
    """A fill group's move decode, banded QC and Theil-Sen subsample in one
    call, after the chase's readback: for read b of the group (its events,
    query ranks, reference ranks and query_to_ref concatenated at
    ``offsets``, (reads + 1, 4) starts; column b of ``packed`` (rows, B) and
    row b of the fill's ``scaled``), ``decode_moves`` with the emission
    coefficients gathered from the per-k-mer ``tables`` (mu, inv_sigma,
    lp_const; lp_const -inf for an undefined k-mer), its QC verdict (average
    log emission, span, largest k-mer gap, cleaned events), and for a
    passing read its ``ops.scaling.theilsen_pregather`` subsample written
    into row b of ``sig``, ``mms``, ``npts`` and ``passth`` in place (``sig``
    and ``mms`` zero beforehand).  Returns (pairs (P, 2) of the group in
    read order, their (reads + 1) starts, passed (reads,))."""
    lib = get_lib()
    event_mean = np.ascontiguousarray(event_mean, np.float64)
    rq, rr, q2r = (np.ascontiguousarray(a, np.int64) for a in (rq, rr, q2r))
    offsets, counts = _read_offsets("prep_decode_group", offsets,
                                    event_mean, rq, rr, q2r)
    packed = np.ascontiguousarray(packed, np.uint8)
    best_event = np.ascontiguousarray(best_event, np.int32)
    scaled = np.ascontiguousarray(scaled, np.float32)
    n = counts.shape[0]
    rows_p, B = packed.shape
    if (n > min(B, scaled.shape[0], best_event.shape[0])
            or (n and (counts[:, 0].max() > scaled.shape[1]
                       or (best_event[:n] >= counts[:, 0]).any()))):
        raise ValueError("prep_decode_group: the moves, best events or "
                         "scaled rows do not match the group's reads")
    # a pair moves the event cursor, the k-mer cursor or both, and is one
    # non-PAD move of four a byte
    cap = int(np.minimum(4 * rows_p, np.maximum(
        best_event[:n].astype(np.int64) + 1, 0) + counts[:, 1]).sum())
    pairs = np.empty((max(cap, 1), 2), np.int64)
    pair_offs = np.empty(n + 1, np.int64)
    passed = np.empty(n, np.uint8)
    mu, inv_sigma, lp_const = (np.ascontiguousarray(t, np.float32)
                               for t in tables)
    for a, dt in ((sig, np.float32), (mms, np.float32), (npts, np.int32),
                  (passth, np.uint8)):
        if (a.dtype != dt or not a.flags.c_contiguous or a.shape[0] < n
                or a.shape[1:] != ((max_points,) if a.ndim == 2 else ())):
            raise ValueError("prep_decode_group: the Theil-Sen rows must be "
                             "C-contiguous f32, f32, i32, u8, a read's row "
                             "each, max_points wide")
    _prep_error("prep_decode_group", int(lib.prep_decode_group(
        packed, rows_p, B, best_event, n, offsets, event_mean, rq, rr, q2r,
        scaled, scaled.shape[1],
        mu, inv_sigma, lp_const, mu.shape[0], float(min_avg_emission),
        int(max_gap_threshold), int(min_cleaned_events), int(max_points),
        int(trim), pairs, cap, pair_offs, passed, sig, mms, npts, passth)))
    return pairs[: int(pair_offs[n])], pair_offs, passed.view(np.bool_)


def baseline_detect_read(raw: np.ndarray, rq: np.ndarray, rr: np.ndarray,
                         q2r: np.ndarray, model: np.ndarray, cfg) -> float:
    """Benchmark-only: the full detect hot path (events -> scaling -> banded
    -> Theil-Sen -> windowed Viterbi) as scalar C++ on one host core, for
    benchmarks' CPU denominator; no detect path calls it.  Returns the
    summed window Viterbi scores (NaN = QC fail)."""
    lib = get_lib()
    hmm = np.asarray([cfg.hmm.external_D2D, cfg.hmm.external_D2M,
                      cfg.hmm.external_I2M, cfg.hmm.external_M2D,
                      cfg.hmm.internal_M2I, cfg.hmm.internal_I2I], np.float64)
    return float(lib.baseline_detect_read(
        np.ascontiguousarray(raw, np.float64), int(raw.shape[0]),
        np.ascontiguousarray(rq, np.int64), int(rq.shape[0]),
        np.ascontiguousarray(rr, np.int64), int(rr.shape[0]),
        np.ascontiguousarray(q2r, np.int64),
        np.ascontiguousarray(model, np.float64), int(model.shape[0]),
        int(cfg.events.window_length1), int(cfg.events.window_length2),
        float(cfg.events.threshold1), float(cfg.events.threshold2),
        float(cfg.events.peak_height),
        int(cfg.scaling.n_quantiles), int(cfg.scaling.theilsen_max_points),
        int(cfg.scaling.theilsen_trim),
        int(cfg.banded.bandwidth), float(cfg.banded.epsilon_skip),
        float(cfg.banded.p_trim), float(cfg.banded.min_average_log_emission),
        int(cfg.banded.max_gap_threshold), int(cfg.banded.min_cleaned_events),
        hmm, int(cfg.window_length_align), int(cfg.kmer_len)))



def time_baseline_reads(records, model: np.ndarray, cfg):
    """Benchmark-only: ``baseline_detect_read`` on each read record, pinned
    to one host core (the lowest of the process's affinity; the affinity is
    restored after).  Returns (core, seconds a read, checksums); only the
    call is timed, not the k-mer ranks and the query-to-reference padding
    built for it."""
    from ..utils.seqtools import kmer_ranks
    old = os.sched_getaffinity(0)
    core = min(old)
    seconds, checksums = [], []
    os.sched_setaffinity(0, {core})
    try:
        for rec in records:
            rq = kmer_ranks(rec.basecall, cfg.kmer_len)
            rr = kmer_ranks(rec.reference_seq, cfg.kmer_len)
            q2r = np.full(rq.shape[0], -1, np.int64)
            m = min(rec.query_to_ref.shape[0], rq.shape[0])
            q2r[:m] = rec.query_to_ref[:m]
            t0 = time.perf_counter()
            checksums.append(baseline_detect_read(rec.raw, rq, rr, q2r,
                                                  model, cfg))
            seconds.append(time.perf_counter() - t0)
    finally:
        os.sched_setaffinity(0, old)
    return core, seconds, checksums

def process_read_windows(codes, steps_per, ns_per, g_ev, ev_start,
                         ri_arr, rc_arr, indel_arr, is_reverse, k,
                         ev_raw_start, ev_raw_end, raw, shift, scale,
                         ref_to_query, core_rank, res_rank, ref_codes,
                         quant_lo, quant_scale, rawdepth):
    """Native fast-mode window post-processing for one read (the C++ twin of
    dnascent_tpu's eventalign._process_read_windows_batched).  ``g_ev`` is
    the read's whole guarded event-id stream; windows view spans starting at
    ``ev_start``.
    Returns the acc-style tuple (coord, kmer_start, query_idx, ref_idx,
    core, res, nsig, centerT, indel, sig_flat,
    (scaled_stream, seg_start, nsig))."""
    lib = get_lib()
    total_steps = int(steps_per.sum())
    ev_all = np.ascontiguousarray(g_ev, dtype=np.int64)
    counts_all = (ev_raw_end[ev_all] - ev_raw_start[ev_all] + 1)
    max_samples = int(counts_all.sum()) if ev_all.size else 0
    P_max = max(total_steps, 1)
    coord = np.empty(P_max, np.int64)
    kmer_start = np.empty(P_max, np.int64)
    query_idx = np.empty(P_max, np.int64)
    ref_idx = np.empty(P_max, np.int64)
    core = np.empty(P_max, np.int64)
    res = np.empty(P_max, np.int64)
    nsig = np.empty(P_max, np.int64)
    centerT = np.empty(P_max, np.uint8)
    indel_out = np.empty(P_max, np.int64)
    sig_flat = np.empty(max(min(P_max * rawdepth, max_samples), 1), np.uint8)
    scaled_stream = np.empty(max(max_samples, 1), np.float32)
    seg_start = np.empty(P_max, np.int64)
    fl = np.zeros(1, np.int64)
    nsamp = np.zeros(1, np.int64)
    P = lib.process_read_windows(
        np.ascontiguousarray(codes, np.uint8),
        np.ascontiguousarray(steps_per, np.int64),
        np.ascontiguousarray(ns_per, np.int64),
        ev_all,
        np.ascontiguousarray(ev_start, np.int64),
        np.ascontiguousarray(ri_arr, np.int64),
        np.ascontiguousarray(rc_arr, np.int64),
        np.ascontiguousarray(indel_arr, np.int64),
        int(len(steps_per)), int(bool(is_reverse)), int(k),
        np.ascontiguousarray(ev_raw_start, np.int64),
        np.ascontiguousarray(ev_raw_end, np.int64),
        np.ascontiguousarray(raw, np.float64),
        float(shift), float(scale),
        np.ascontiguousarray(ref_to_query, np.int64),
        np.ascontiguousarray(core_rank, np.int64),
        np.ascontiguousarray(res_rank, np.int64),
        np.ascontiguousarray(ref_codes, np.int8),
        np.float32(quant_lo), np.float32(quant_scale), int(rawdepth),
        coord, kmer_start, query_idx, ref_idx, core, res, nsig, centerT,
        indel_out, sig_flat, fl, scaled_stream, int(scaled_stream.shape[0]),
        seg_start, nsamp)
    P = int(P)
    return (coord[:P], kmer_start[:P], query_idx[:P], ref_idx[:P],
            core[:P], res[:P], nsig[:P], centerT[:P].astype(bool),
            indel_out[:P], sig_flat[: int(fl[0])],
            (scaled_stream[: int(nsamp[0])], seg_start[:P].copy(),
             nsig[:P].copy()))


def format_eventalign_rows(coords, kstarts, is_ins, values, mmeans,
                           seq: str, k: int, is_reverse: bool,
                           calls=None) -> str:
    """C-side formatting of eventalign table rows, one per raw sample.
    Arrays hold one entry per output row; the k-mers are sliced (and
    reverse-complemented) in C from the reference bytes.  ``calls`` is None
    or (has_call u8, edu f64, brdu f64) per row: rows with has_call carry
    trainCNN's two call columns.  Raises ValueError when the rows do not fit
    the buffer, whose size is fixed from the row count (a value such as
    1e300 prints 300 digits), instead of returning cut text."""
    lib = get_lib()
    n = int(coords.shape[0])
    if n == 0:
        return ""
    if calls is None:
        calls = (np.zeros(n, np.uint8), np.zeros(n), np.zeros(n))
    has_call, edu, brdu = (np.ascontiguousarray(calls[0], np.uint8),
                           np.ascontiguousarray(calls[1], np.float64),
                           np.ascontiguousarray(calls[2], np.float64))
    seq_b = seq.encode()
    # a row's integer, two k-mers, two or four %.6f values and separators
    cap = n * (64 + 2 * k) + 32 * int(has_call.sum())
    out = ctypes.create_string_buffer(cap)
    w = int(lib.format_eventalign_rows(
        np.ascontiguousarray(coords, np.int64),
        np.ascontiguousarray(kstarts, np.int64),
        np.ascontiguousarray(is_ins, np.uint8),
        np.ascontiguousarray(values, np.float64),
        np.ascontiguousarray(mmeans, np.float64),
        has_call, edu, brdu, n, seq_b, len(seq_b), int(k), int(is_reverse),
        out, cap))
    if w < 0:
        raise ValueError(f"format_eventalign_rows failed ({w}): "
                         + ("a row overflows the output buffer" if w == -1
                            else "bad arguments"))
    return out.raw[:w].decode()
