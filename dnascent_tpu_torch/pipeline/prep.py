"""Pipeline stages 1-3: signal -> events -> scaling -> banded alignment ->
Theil-Sen (port of ``dnascent_tpu/pipeline/prep.py``).

Per batch of reads: native event detection and quantile scaling on the
host, the banded fill and backtrace chase (kernel B) on the device, the
native move decode and QC on the host, then the batched Theil-Sen
refinement on the device.  The fill is kernel A for a static-stdv pore
model (the shipping case) and kernel E for one whose stdv varies per k-mer
(the fit-stdv tables trainGMM output feeds).

The host steps are whole-batch native calls that release the interpreter
lock: k-mer ranks and quantile scaling one call a batch, each fill group's
padded rows one call, and each fill group's move decode, QC and Theil-Sen
subsample one call after the chase's readback.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from operator import attrgetter
from typing import Optional

import numpy as np
import torch

from .. import device as devmod, native
from ..config import DNA_R10, SubstrateConfig
from ..io.poremodel import PoreModelSet, PoreTables
from ..ops import banded, banded_cuda, scaling
from ..utils.progress import span
from .source import ReadRecord

MAX_FILL_B = 32          # reads per fill launch
BUCKET_STEP = 4096       # reads of similar length share a fill launch


@dataclass
class PreparedRead:
    record: ReadRecord
    event_mean: np.ndarray       # (E,) f64 merged events
    event_raw_start: np.ndarray  # (E,) i64
    event_raw_end: np.ndarray    # (E,) i64
    et_n: int                    # raw event count (for eventsPerBase)
    kmer_ranks_query: np.ndarray
    kmer_ranks_ref: np.ndarray
    shift: float = 0.0
    scale: float = 1.0
    events_per_base: float = 0.0
    event_alignment: np.ndarray = field(
        default_factory=lambda: np.empty((0, 2), dtype=np.int64))
    qc_fail_reason: Optional[str] = None
    # quantile scaling (before Theil-Sen) and the fill's device-resident
    # scaled events: eventalign rebuilds its observations from them, since
    # both scalings are affine in the raw event mean
    shift_q: float = 0.0
    scale_q: float = 1.0
    events_dev: Optional[torch.Tensor] = None   # (B_g, E_g) f32
    events_row: int = -1

    @property
    def passed(self) -> bool:
        return self.qc_fail_reason is None

    @property
    def n_events(self) -> int:
        return int(self.event_mean.shape[0])

    @property
    def n_kmers(self) -> int:
        return int(self.kmer_ranks_query.shape[0])


def static_stdv_scalars(pore_model: np.ndarray):
    """(inv_sigma, lp_const) of a static-stdv table, for kernel A; None for
    a table whose stdv varies per k-mer, which takes kernel E."""
    sig = pore_model[:, 1]
    if not np.all(sig == sig[0]):
        return None
    s0 = float(sig[0])
    return 1.0 / s0, float(banded.LOG_INV_SQRT_2PI - np.log(s0))


def pore_tables(models: PoreModelSet) -> PoreTables:
    """The model set's cached ``pore_tables``; built anew for a model set
    without them (the JAX package's)."""
    tables = getattr(models, "pore_tables", None)
    return PoreTables.of(models.pore_model) if tables is None else tables


def detect_events(records: list[ReadRecord], cfg: SubstrateConfig):
    """Native event detection + merge per read: (mean, raw_start, raw_end,
    n_raw_events)."""
    ed = cfg.events
    with ThreadPoolExecutor(max_workers=2) as ex:
        return list(ex.map(lambda r: native.event_detect(
            r.raw, ed.window_length1, ed.window_length2, ed.threshold1,
            ed.threshold2, ed.peak_height), records))


def quantile_scaled_reads(records: list[ReadRecord], models: PoreModelSet,
                          cfg: SubstrateConfig) -> list[PreparedRead]:
    """Events, k-mer ranks and quantile scaling (event_handling.cpp:594-595)
    for a batch; reads too short to align carry ``too_few_events``."""
    with span("prep.event_detection"):
        events = detect_events(records, cfg)
    with span("prep.scaling"):
        if not records:
            return []
        k = cfg.kmer_len
        lens = np.array([(len(r.basecall), len(r.reference_seq),
                          ev[0].shape[0]) for r, ev in zip(records, events)],
                        np.int64)
        mean = np.concatenate([ev[0] for ev in events])
        with span("prep.scale_build"):
            s = native.prep_scale_batch(
                "".join(r.basecall for r in records).encode("ascii"),
                "".join(r.reference_seq for r in records).encode("ascii"),
                lens, mean, pore_tables(models).mean, k,
                cfg.scaling.n_quantiles)
        # each read's starts of its events, query and reference k-mers
        starts = np.zeros((len(records) + 1, 3), np.int64)
        np.cumsum(np.stack([lens[:, 2], np.maximum(lens[:, 0] - k + 1, 0),
                            np.maximum(lens[:, 1] - k + 1, 0)], 1),
                  axis=0, out=starts[1:])
        offs = starts.tolist()
        prepped = []
        for rec, (_, rs, re_, et_n), (e0, q0, r0), (e1, q1, r1), few, \
                shift, scale in zip(records, events, offs, offs[1:],
                                    s.too_few.tolist(), s.shift.tolist(),
                                    s.scale.tolist()):
            p = PreparedRead(rec, mean[e0:e1], rs, re_, et_n, s.rq[q0:q1],
                             s.rr[r0:r1])
            if few:
                p.qc_fail_reason = "too_few_events"
            else:
                p.shift, p.scale = shift, scale
            prepped.append(p)
    return prepped


def _group_arrays(group: list[PreparedRead], *fields: str):
    """The group's reads' ``fields`` (attribute paths of a read), each
    concatenated in read order, and their (reads + 1, fields) starts, as
    prep's native group calls take them."""
    cols = [list(map(attrgetter(f), group)) for f in fields]
    offsets = np.zeros((len(group) + 1, len(fields)), np.int64)
    offsets[1:] = np.cumsum([[a.shape[0] for a in c] for c in cols],
                            axis=1).T
    return [np.concatenate(c) for c in cols], offsets


def _fill_rows(group: list[PreparedRead], table=None):
    """``native.prep_fill_rows`` of the group, its E and K the group's
    longest read, with ``table`` its values at the ranks."""
    (mean, rq), offsets = _group_arrays(group, "event_mean",
                                        "kmer_ranks_query")
    n = len(group)
    E, K = (int(x) for x in np.diff(offsets, axis=0).max(axis=0))
    return native.prep_fill_rows(
        mean, rq, offsets,
        np.fromiter((p.shift for p in group), np.float64, n),
        np.fromiter((p.scale for p in group), np.float64, n),
        devmod.pad_rows(n), E, K, table)


def fill_inputs(group: list[PreparedRead], models: PoreModelSet):
    """Host arrays of one static-stdv fill launch (kernel A), one native
    call: (scaled events (B, E) f32, mu (B, K) f32 with +inf past each
    read's k-mers, n_events (B,) i32, n_kmers (B,) i32)."""
    return _fill_rows(group, pore_tables(models).mu)


def general_fill_inputs(group: list[PreparedRead], models: PoreModelSet):
    """Host arrays of one per-k-mer-stdv fill launch (kernel E): (scaled
    events, mu, inv_sigma, lp_const (B, K) f32 with -inf lp_const past each
    read's k-mers, n_events, n_kmers)."""
    scaled, ranks, n_ev, n_km = _fill_rows(group)
    mu, inv_sigma, lp_const = banded.prepare_emission_coefficients(
        ranks, models.pore_model)
    return scaled, mu, inv_sigma, lp_const, n_ev, n_km


def _fill_groups(live: list[PreparedRead]) -> list[list[PreparedRead]]:
    """Reads grouped by length bucket, at most MAX_FILL_B per launch."""
    buckets: dict[tuple[int, int], list[PreparedRead]] = {}
    for p in live:
        key = (-(-p.n_events // BUCKET_STEP), -(-p.n_kmers // BUCKET_STEP))
        buckets.setdefault(key, []).append(p)
    return [g[c : c + MAX_FILL_B] for g in buckets.values()
            for c in range(0, len(g), MAX_FILL_B)]


def prepare_reads(records: list[ReadRecord], models: PoreModelSet,
                  cfg: SubstrateConfig = DNA_R10,
                  device="cuda") -> list[PreparedRead]:
    """Events + quantile scaling + banded alignment + Theil-Sen for a batch
    of reads on ``device``.  Failed reads carry ``qc_fail_reason`` and are
    kept, so the caller can count them."""
    dev = devmod.resolve(device)
    prepped = quantile_scaled_reads(records, models, cfg)
    live = [p for p in prepped if p.passed]
    if not live:
        return prepped
    bw = cfg.banded.bandwidth
    fill_kw = dict(bandwidth=bw, epsilon_skip=cfg.banded.epsilon_skip,
                   p_trim=cfg.banded.p_trim)
    static = static_stdv_scalars(models.pore_model)
    if static is None:
        build, fill = general_fill_inputs, banded_cuda.banded_fill_general
    else:
        build, fill = fill_inputs, banded_cuda.banded_fill_lean
        fill_kw.update(inv_sigma=static[0], lp_const=static[1])
    mp = cfg.scaling.theilsen_max_points

    # dispatch every group's fill + chase, then collect
    dispatched = []
    for group in _fill_groups(live):
        with span("prep.fill_build"):
            arrays = build(group, models)
        scaled = arrays[0]
        args = [devmod.put_rows(a, dev) for a in arrays]
        scaled_dev, n_km_dev = args[0], args[-1]
        for b, p in enumerate(group):
            p.shift_q, p.scale_q = p.shift, p.scale
            p.events_dev, p.events_row = scaled_dev, b
        tp, rp, best_e, _ = fill(*args, **fill_kw)
        moves = banded_cuda.backtrace_moves(tp, rp, best_e, n_km_dev,
                                            bandwidth=bw)
        dispatched.append((group, scaled, moves, best_e))

    order = []
    with span("prep.banded_decode"):
        # Theil-Sen's subsample a read, written by the decode in fill-group
        # order
        n_live = len(live)
        ts = (np.zeros((n_live, mp), np.float32),
              np.zeros((n_live, mp), np.float32),
              np.zeros(n_live, np.int32), np.ones(n_live, np.uint8))
        tables = pore_tables(models)[1:]
        for group, scaled, moves, best_e in dispatched:
            moves = devmod.to_host(moves)
            best_e = devmod.to_host(best_e)
            rows = slice(len(order), len(order) + len(group))
            order += group
            with span("prep.decode_build"):
                (mean, rq, rr, q2r), offsets = _group_arrays(
                    group, "event_mean", "kmer_ranks_query",
                    "kmer_ranks_ref", "record.query_to_ref")
                pairs, offs, ok = native.prep_decode_group(
                    moves, best_e, offsets, mean, rq, rr, q2r, scaled,
                    tables, cfg.banded.min_average_log_emission,
                    cfg.banded.max_gap_threshold,
                    cfg.banded.min_cleaned_events, mp,
                    cfg.scaling.theilsen_trim, *(a[rows] for a in ts))
            offs = offs.tolist()
            for p, good, o0, o1 in zip(group, ok.tolist(), offs, offs[1:]):
                if good:
                    p.event_alignment = pairs[o0:o1]
                else:
                    p.qc_fail_reason = "banded_qc"

    # Theil-Sen refinement, batched on the device over host-subsampled points
    keep = [i for i, p in enumerate(order) if p.passed]
    live2 = [order[i] for i in keep]
    if live2:
        with span("prep.theilsen"):
            n2 = len(live2)
            B = devmod.pad_rows(n2)
            sig = np.zeros((B, mp), dtype=np.float32)
            mms = np.zeros((B, mp), dtype=np.float32)
            npts = np.zeros(B, dtype=np.int32)
            passth = np.ones(B, dtype=bool)
            sh = np.zeros(B, dtype=np.float32)
            sc = np.ones(B, dtype=np.float32)
            for out, rows in zip((sig, mms, npts, passth), ts):
                out[:n2] = rows[keep]
            sh[:n2] = np.fromiter((p.shift for p in live2), np.float64, n2)
            sc[:n2] = np.fromiter((p.scale for p in live2), np.float64, n2)
            new_sh, new_sc = scaling.theilsen_refine_pregathered(
                *(devmod.put_rows(a, dev)
                  for a in (sig, mms, npts, passth, sh, sc)))
            new_sh = devmod.to_host(new_sh)
            new_sc = devmod.to_host(new_sc)
            for b, p in enumerate(live2):
                p.shift, p.scale = float(new_sh[b]), float(new_sc[b])
                if p.shift == -1.0:  # Theil-Sen failure sentinel
                    p.qc_fail_reason = "theilsen"
                    p.event_alignment = np.empty((0, 2), dtype=np.int64)
                # eventsPerBase: raw event count over basecall length - k
                # (event_handling.cpp:606)
                p.events_per_base = p.et_n / max(
                    1, len(p.record.basecall) - cfg.kmer_len)
    return prepped
