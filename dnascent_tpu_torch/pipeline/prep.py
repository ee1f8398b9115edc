"""Pipeline stages 1-3: signal -> events -> scaling -> banded alignment ->
Theil-Sen (port of ``dnascent_tpu/pipeline/prep.py``).

Per batch of reads: native event detection and quantile scaling on the
host, the banded fill and backtrace chase (kernel B) on the device, the
native move decode and QC on the host, then the batched Theil-Sen
refinement on the device.  The fill is kernel A for a static-stdv pore
model (the shipping case) and kernel E for one whose stdv varies per k-mer
(the fit-stdv tables trainGMM output feeds).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import device as devmod, native
from ..config import DNA_R10, SubstrateConfig
from ..io.poremodel import PoreModelSet
from ..ops import banded, banded_cuda, scaling
from ..utils.progress import span
from ..utils.seqtools import kmer_ranks
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
    k = cfg.kmer_len
    prepped = []
    with span("prep.event_detection"):
        events = detect_events(records, cfg)
    with span("prep.scaling"):
        for rec, (mean, rs, re_, et_n) in zip(records, events):
            rq = kmer_ranks(rec.basecall, k)
            rr = kmer_ranks(rec.reference_seq, k)
            p = PreparedRead(rec, mean, rs, re_, et_n, rq, rr)
            if mean.shape[0] < 2 or rq.shape[0] < 2 or rr.shape[0] < 2:
                p.qc_fail_reason = "too_few_events"
            else:
                # undefined k-mers take the A-substituted rank
                # (data_IO.cpp:131)
                safe_rr = np.where(rr < 0, 0, rr)
                p.shift, p.scale = scaling.estimate_scaling_quantiles(
                    mean, models.pore_model[safe_rr, 0].astype(np.float64),
                    cfg.scaling)
            prepped.append(p)
    return prepped


def _ranked_group(group: list[PreparedRead]):
    """(scaled events (B, E) f32, k-mer ranks (B, K) i64 with -1 past each
    read's k-mers, n_events (B,) i32, n_kmers (B,) i32), E and K the
    group's longest read."""
    B = devmod.pad_rows(len(group))
    E = max(p.n_events for p in group)
    K = max(p.n_kmers for p in group)
    scaled = np.zeros((B, E), dtype=np.float32)
    # undefined (N-containing) k-mers take the A-substituted rank
    # (data_IO.cpp:131); -1 marks the padding past each read's k-mers
    ranks = np.full((B, K), -1, dtype=np.int64)
    n_ev = np.zeros(B, dtype=np.int32)
    n_km = np.zeros(B, dtype=np.int32)
    for b, p in enumerate(group):
        ne, nk = p.n_events, p.n_kmers
        scaled[b, :ne] = (p.event_mean - p.shift) / p.scale
        ranks[b, :nk] = np.where(p.kmer_ranks_query < 0, 0,
                                 p.kmer_ranks_query)
        n_ev[b], n_km[b] = ne, nk
    return scaled, ranks, n_ev, n_km


def fill_inputs(group: list[PreparedRead], models: PoreModelSet):
    """Host arrays of one static-stdv fill launch (kernel A): (scaled
    events (B, E) f32, mu (B, K) f32 with +inf past each read's k-mers,
    n_events (B,) i32, n_kmers (B,) i32)."""
    scaled, ranks, n_ev, n_km = _ranked_group(group)
    mu = np.where(ranks < 0, np.float32(np.inf),
                  models.pore_model[np.maximum(ranks, 0), 0]).astype(
                      np.float32)
    return scaled, mu, n_ev, n_km


def general_fill_inputs(group: list[PreparedRead], models: PoreModelSet):
    """Host arrays of one per-k-mer-stdv fill launch (kernel E): (scaled
    events, mu, inv_sigma, lp_const (B, K) f32 with -inf lp_const past each
    read's k-mers, n_events, n_kmers)."""
    scaled, ranks, n_ev, n_km = _ranked_group(group)
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
    cleaned: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    decode = (native.decode_moves if native.available()
              else banded.decode_moves_host)

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

    with span("prep.banded_decode"):
        for group, scaled, moves, best_e in dispatched:
            moves = devmod.to_host(moves)
            best_e = devmod.to_host(best_e)
            for b, p in enumerate(group):
                ne, nk = p.n_events, p.n_kmers
                q2r = np.full(nk, -1, dtype=np.int64)
                q2r_src = p.record.query_to_ref[:nk]
                q2r[: q2r_src.shape[0]] = q2r_src
                mu_b, inv_b, lpc_b = banded.prepare_emission_coefficients(
                    p.kmer_ranks_query[None, :], models.pore_model)
                pairs, cs, cr, avg_em, spanned, max_gap = decode(
                    moves, b, int(best_e[b]), nk, p.event_mean,
                    scaled[b, :ne], mu_b[0], inv_b[0], lpc_b[0], q2r,
                    p.kmer_ranks_ref)
                if (avg_em >= cfg.banded.min_average_log_emission
                        and spanned
                        and max_gap <= cfg.banded.max_gap_threshold
                        and cs.shape[0] >= cfg.banded.min_cleaned_events):
                    p.event_alignment = pairs
                else:
                    p.qc_fail_reason = "banded_qc"
                cleaned[id(p)] = (cs, cr)

    # Theil-Sen refinement, batched on the device over host-subsampled points
    live2 = [p for p in live if p.passed]
    if live2:
        with span("prep.theilsen"):
            mp = cfg.scaling.theilsen_max_points
            B = devmod.pad_rows(len(live2))
            sig = np.zeros((B, mp), dtype=np.float32)
            mms = np.zeros((B, mp), dtype=np.float32)
            npts = np.zeros(B, dtype=np.int32)
            passth = np.ones(B, dtype=bool)
            sh = np.zeros(B, dtype=np.float32)
            sc = np.ones(B, dtype=np.float32)
            for b, p in enumerate(live2):
                cs, cr = cleaned[id(p)]
                sig[b], mms[b], npts[b], passth[b] = \
                    scaling.theilsen_pregather(cs, cr, models.pore_model, mp,
                                               cfg.scaling.theilsen_trim)
                sh[b], sc[b] = p.shift, p.scale
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
