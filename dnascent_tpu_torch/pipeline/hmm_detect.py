"""The ``--HMM`` detect path: per-thymidine log-likelihood ratios (port of
``dnascent_tpu/pipeline/hmm_detect.py``; reference ``llAcrossRead``,
detect.cpp:381-574).

The points of interest are every reference T at least 2*window from the
read edges; each scores a +-window snippet under analogue-substituted and
unmodified emission tables with the forward algorithm (``ops/hmm.py``).
All windows of a read batch run as one device batch, two forward passes
over one upload of the observations.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from .. import device as devmod
from ..config import DNA_R10, SubstrateConfig
from ..io.poremodel import PoreModelSet
from ..ops.hmm import forward_batch
from ..parallel.compute import DeviceLike, as_devices
from ..utils.seqtools import encode_bases, reverse_complement
from .detect import DetectStats, run_batches
from .eventalign import HMM_KEY
from .prep import PreparedRead, prepare_reads
from .source import ReadRecord

# batches in flight, as the JAX package's HMM loop keeps them
PIPELINE_DEPTH = 10


def _poi_windows(p: PreparedRead, cfg: SubstrateConfig, window: int):
    """All scorable windows of one read (detect.cpp:381-547): a list of
    (reference position, the snippet's event means, query position)."""
    k = cfg.kmer_len
    rec = p.record
    codes = encode_bases(rec.reference_seq)
    n = codes.shape[0]
    pois = np.nonzero(codes[2 * window : n - 2 * window] == 1)[0] + 2 * window
    if rec.is_reverse:
        pois = pois[::-1]
    r2q = rec.ref_to_query
    pairs = p.event_alignment
    out = []
    for pos in pois:
        lo_q = r2q[pos - window]
        hi_q = r2q[pos + window]
        if (codes[pos - window : pos + window + k] < 0).any():
            continue
        j0 = np.searchsorted(pairs[:, 1], lo_q, side="left")
        j1 = np.searchsorted(pairs[:, 1], hi_q, side="left")
        if j1 <= j0:
            continue
        ev = p.event_mean[pairs[j0:j1, 0]]
        ev = ev[(ev > 0.0) & (ev < 250.0)]
        if ev.shape[0] < 2 * window - k:  # detect.cpp:510
            continue
        out.append((int(pos), ev, int(r2q[pos])))
    return out


def _bucket_up(n: int, step: int) -> int:
    return max(step, ((n + step - 1) // step) * step)


def hmm_detect_reads(records: Iterable[ReadRecord], models: PoreModelSet,
                     cfg: SubstrateConfig = DNA_R10,
                     device: DeviceLike = "cuda",
                     stats: Optional[DetectStats] = None,
                     batch_size: int = 32):
    """Generator of (read_id, the read's ``.detect`` text block, or None
    for a read that failed QC) over ``records``, in order, run on
    ``device`` (one device or a device set) in batches of ``batch_size``
    reads, PIPELINE_DEPTH batches a device in flight.  A passing read with
    no scorable window gives its header alone."""
    devices = as_devices(device)
    hmm_probs = tuple(getattr(cfg.hmm, kk) for kk in HMM_KEY)
    window = cfg.detect.hmm_window
    k = cfg.kmer_len
    n_states = 2 * window
    brdu_lo, brdu_hi = window - k // 2, window + k // 2   # detect.cpp:544

    def flush(batch, dev):
        prepped = prepare_reads(batch, models, cfg, device=dev)
        jobs = []          # (p, windows) of the scorable reads
        results = {}       # read id -> text or None
        for p in prepped:
            rec = p.record
            if not p.passed or p.event_alignment.shape[0] == 0:
                results[rec.read_id] = None
                continue
            results[rec.read_id] = (f">{rec.read_id} {rec.contig} "
                                    f"{rec.ref_start} {rec.ref_end} "
                                    f"{rec.strand}\n")
            wins = _poi_windows(p, cfg, window)
            if wins:
                jobs.append((p, wins))
        if jobs:
            n_win = sum(len(wins) for _, wins in jobs)
            W = _bucket_up(n_win, 512)
            T = _bucket_up(max(len(ev) for _, wins in jobs
                               for _, ev, _ in wins), 64)
            obs = np.zeros((W, T), dtype=np.float32)
            n_obs = np.zeros(W, dtype=np.int32)
            mu_un = np.zeros((W, n_states), dtype=np.float32)
            sd_un = np.ones((W, n_states), dtype=np.float32)
            mu_an = np.zeros((W, n_states), dtype=np.float32)
            sd_an = np.ones((W, n_states), dtype=np.float32)
            epb = np.ones(W, dtype=np.float32)
            i = np.arange(n_states)
            in_brdu = (i >= brdu_lo) & (i <= brdu_hi)
            w = 0
            for p, wins in jobs:
                ranks = np.where(p.kmer_ranks_ref < 0, 0, p.kmer_ranks_ref)
                isT = encode_bases(p.record.reference_seq) == 1
                hasT = np.zeros(ranks.shape[0], dtype=bool)
                for j in range(k):
                    hasT |= isT[j : j + ranks.shape[0]]
                for pos, ev, _pq in wins:
                    obs[w, : len(ev)] = (ev - p.shift) / p.scale
                    n_obs[w] = len(ev)
                    rr = ranks[pos - window : pos - window + n_states]
                    mu_un[w] = models.unlabelled_model[rr, 0]
                    sd_un[w] = models.unlabelled_model[rr, 1]
                    sel = in_brdu & hasT[pos - window
                                         : pos - window + n_states]
                    mu_an[w] = np.where(sel, models.analogue_model[rr, 0],
                                        mu_un[w])
                    sd_an[w] = np.where(sel, models.analogue_model[rr, 1],
                                        sd_un[w])
                    epb[w] = p.events_per_base
                    w += 1
            ns = np.full(W, n_states, dtype=np.int32)
            # one upload of each array, shared by both forward passes
            put = lambda a: devmod.put_rows(a, dev)
            obs_d, n_obs_d, ns_d, epb_d = (put(obs), put(n_obs), put(ns),
                                           put(epb))
            ll_an = forward_batch(obs_d, n_obs_d, put(mu_an), put(sd_an),
                                  ns_d, epb_d, hmm_probs)
            ll_un = forward_batch(obs_d, n_obs_d, put(mu_un), put(sd_un),
                                  ns_d, epb_d, hmm_probs)
            # the padded rows (no observation, iM2M = -inf) are dropped
            # before the difference
            llr = (ll_an[:n_win].cpu().numpy()
                   - ll_un[:n_win].cpu().numpy())
            w = 0
            for p, wins in jobs:
                rec = p.record
                lines = [results[rec.read_id]]
                for pos, _ev, pos_q in wins:
                    kmer_ref = rec.reference_seq[pos - k // 2
                                                 : pos - k // 2 + k]
                    kmer_query = rec.basecall[pos_q - k // 2
                                              : pos_q - k // 2 + k]
                    if rec.is_reverse:
                        coord = rec.ref_end - pos - 1
                        kmer_ref = reverse_complement(kmer_ref)
                        kmer_query = reverse_complement(kmer_query)
                    else:
                        coord = rec.ref_start + pos
                    lines.append(f"{coord}\t{llr[w]:.6f}\t{kmer_ref}"
                                 f"\t{kmer_query}\n")
                    w += 1
                results[rec.read_id] = "".join(lines)
        return [(p.record.read_id, results[p.record.read_id])
                for p in prepped]

    # stats are counted here, on the consumer side: the worker threads
    # must not race the counters
    for batch_out in run_batches(records, flush, batch_size,
                                 PIPELINE_DEPTH, devices):
        for rid, text in batch_out:
            if stats is not None:
                stats.processed += 1
                stats.failed += text is None
            yield rid, text
