"""ctypes loader for the port's host C++ library (``dnascent_native.cpp``
and ``baseline_cpu.cpp``, one shared object).

A copy of the entries of ``dnascent_tpu/native`` that the port calls: event
detection, the chase's move decode, the eventalign window chain and window
post-processing, seeBreaks' libstdc++-exact bootstrap streams, the
eventalign table's row formatter (which, unlike the original, refuses
rather than cuts a row that overflows its buffer, and also writes trainCNN's
call columns) and the benchmark-only scalar CPU baseline of the detect hot
path.  The library is built with ``g++`` at first use into
``build/torch_native/`` at the repository root (never into the package), and
rebuilt when either source is newer than the library.  ``available()`` is False
when it cannot be built or loaded; prep then decodes moves with the numpy
twin (``ops.banded.decode_moves_host``), while eventalign needs the library.
"""

from __future__ import annotations

import ctypes
import os
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
            lib.window_chain.restype = i64
            lib.window_chain.argtypes = [
                i64p, i64p, i64, i64p, i64p, i64p, i64, i64, i64,
                i64p, i64p, i64p, i64p,
            ]
            lib.decode_moves.restype = i64
            lib.decode_moves.argtypes = [
                u8p, i64, i64, i64, i64, i64,
                f64p, f32p, f32p, f32p, f32p, i64p, i64p, i64,
                i64p, i64, f64p, i64p, f64p,
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
            dbl = ctypes.c_double
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


def window_chain(undef_cum: np.ndarray, bp_pos: np.ndarray,
                 next_bp: np.ndarray, j_at: np.ndarray, guard_cum: np.ndarray,
                 ref_len: int, k: int, total_wl: int):
    """Native twin of the scalar window chain in dnascent_tpu's
    eventalign._build_window_set.  Returns (ri, wl, j0, j1) i64 arrays."""
    lib = get_lib()
    # worst case one window per kmer position (short tail windows)
    n_max = max(1, ref_len - k + 2)
    ri = np.empty(n_max, np.int64)
    wl = np.empty(n_max, np.int64)
    j0 = np.empty(n_max, np.int64)
    j1 = np.empty(n_max, np.int64)
    n = lib.window_chain(
        np.ascontiguousarray(undef_cum, np.int64),
        np.ascontiguousarray(bp_pos, np.int64), int(bp_pos.shape[0]),
        np.ascontiguousarray(next_bp, np.int64),
        np.ascontiguousarray(j_at, np.int64),
        np.ascontiguousarray(guard_cum, np.int64),
        int(ref_len), int(k), int(total_wl), ri, wl, j0, j1)
    n = int(n)
    return ri[:n], wl[:n], j0[:n], j1[:n]


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
