"""detect: per-thymidine BrdU/EdU probabilities (port of
``dnascent_tpu/pipeline/detect.py``; reference detect.cpp:735-920).

    read source -> prep (events, scaling, banded fill + chase, Theil-Sen)
                -> eventalign, fast or strict (windowed Viterbi fill +
                   backtrace)
                -> CNN forward (reads batched by padded position count)
                -> per-read call tables -> writer

Batches run in a pipeline of worker threads with an ordered drain, so the
output keeps submission order (the reference's buffered OpenMP loop and
ordered writer, detect.cpp:852-906); over a device set, batch i runs whole
on device i mod N.  Reads failing QC are counted, not fatal
(detect.cpp:878-897).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Optional, Union

import numpy as np
import torch

from .. import device as devmod
from ..config import DNA_R10, SubstrateConfig
from ..io.poremodel import PoreModelSet
from ..models import cnn as cnn_mod
from ..models.reference_cnn import ReferenceDetectCNN
from ..parallel.compute import (DeviceLike, as_devices, per_device,
                                replicate_module)
from ..utils.progress import NULL, span
from ..utils.seqtools import _COMP_TABLE as _COMP_U8
from .eventalign import AlignedPositions, run_eventalign
from .prep import PreparedRead, prepare_reads
from .source import ReadRecord

# positions per CNN call before halo chunking starts
CNN_CHUNK_POSITIONS = 32768
# either detect CNN: same call, (B, L, 3) probabilities, receptive_field()
DetectModel = Union[cnn_mod.DetectCNN, ReferenceDetectCNN]


@dataclass
class DetectedRead:
    """Per-read detect output (the call side of DNAscent::read)."""

    record: ReadRecord
    # per output position (centre base T), in aligned-position order
    ref_coords: np.ndarray      # (C,) int64
    edu_prob: np.ndarray        # (C,) float32
    brdu_prob: np.ndarray       # (C,) float32
    kmer_starts: np.ndarray     # (C,) int64 into record.reference_seq
    # modbam side: per-position query indices in sequencing orientation,
    # filtered by the deletion mask (detect.cpp:704)
    query_indices: np.ndarray   # (Cq,) int64
    edu_prob_q: np.ndarray
    brdu_prob_q: np.ndarray
    _kmers: Optional[list] = None

    @property
    def kmers_ref(self) -> list:
        """Reference-oriented 9-mer strings, built on first use."""
        if self._kmers is None:
            k = 9
            seq = np.frombuffer(self.record.reference_seq.encode("ascii"),
                                np.uint8)
            if seq.shape[0] < k or self.kmer_starts.shape[0] == 0:
                self._kmers = [""] * self.kmer_starts.shape[0]
                return self._kmers
            wins = np.lib.stride_tricks.sliding_window_view(
                seq, k)[self.kmer_starts]
            if self.record.is_reverse:
                wins = _COMP_U8[wins][:, ::-1]
            flat = wins.tobytes()
            self._kmers = [flat[i : i + k].decode("ascii")
                           for i in range(0, len(flat), k)]
        return self._kmers


@dataclass
class DetectStats:
    processed: int = 0
    failed: int = 0


def _bucket_len(n: int) -> int:
    """Padded position count of a CNN batch: 256, then multiples of 2048."""
    if n <= 256:
        return 256
    return ((n + 2047) // 2048) * 2048


@dataclass
class _PosChunk:
    """Rows [lo, hi) of one read's positions for halo-chunked CNN inference
    over very long reads; only the core rows [core_lo, core_hi), farther
    than the receptive field from the chunk edges, emit outputs, so the
    result equals the unchunked run."""

    parent: AlignedPositions
    lo: int
    hi: int
    core_lo: int
    core_hi: int
    flat_lo: int
    flat_hi: int
    order: int

    @property
    def n(self) -> int:
        return self.hi - self.lo

    def arrays(self):
        par = self.parent
        t = par.center_is_T[self.lo : self.hi].copy()
        t[: self.core_lo - self.lo] = False
        t[self.core_hi - self.lo :] = False
        return (par.core_idx[self.lo : self.hi],
                par.residual_idx[self.lo : self.hi],
                par.signal_counts[self.lo : self.hi],
                par.signal_u8_flat[self.flat_lo : self.flat_hi], t)


def _chunk_positions(pos: AlignedPositions, chunk: int, halo: int):
    """Split one read's positions into halo-padded chunks (exact for any
    local receptive field <= halo)."""
    n = pos.coord.shape[0]
    flat_offs = np.concatenate(
        [[0], np.cumsum(pos.signal_counts.astype(np.int64))])
    out = []
    for order, core_lo in enumerate(range(0, n, chunk)):
        core_hi = min(n, core_lo + chunk)
        lo, hi = max(0, core_lo - halo), min(n, core_hi + halo)
        out.append(_PosChunk(pos, lo, hi, core_lo, core_hi,
                             int(flat_offs[lo]), int(flat_offs[hi]), order))
    return out


def _whole(pos: AlignedPositions) -> _PosChunk:
    n = pos.coord.shape[0]
    return _PosChunk(pos, 0, n, 0, n, 0, pos.signal_u8_flat.shape[0], 0)


def _signal_windows(flat_u8: torch.Tensor, counts: torch.Tensor, B: int,
                    L: int) -> torch.Tensor:
    """(B, L, RAWDEPTH) u8 windows from the flat sample stream and the
    per-position counts (0 = padding)."""
    counts = counts.reshape(B * L).long()
    offs = torch.cumsum(counts, 0) - counts
    j = torch.arange(cnn_mod.RAWDEPTH, device=flat_u8.device)
    idx = (offs[:, None] + j[None, :]).clamp(0, max(flat_u8.shape[0] - 1, 0))
    valid = j[None, :] < counts[:, None]
    if flat_u8.shape[0] == 0:
        return torch.zeros((B, L, cnn_mod.RAWDEPTH), dtype=torch.uint8,
                           device=flat_u8.device)
    sig = torch.where(valid, flat_u8[idx], 0)
    return sig.to(torch.uint8).reshape(B, L, cnn_mod.RAWDEPTH)


@torch.no_grad()
def run_cnn_batched(model: DetectModel, results: dict,
                    prepped: list[PreparedRead], device,
                    batch_positions: int = 1 << 19,
                    chunk_positions: int = CNN_CHUNK_POSITIONS) -> dict:
    """Run the CNN over every QC-passed read, batching reads by padded
    position count.  Returns {read_id: (Ct, 2) float32 [BrdU, EdU]
    probabilities at the read's centre-T positions}, in position order."""
    dev = devmod.resolve(device)
    halo = max(256, -(-model.receptive_field() // 256) * 256)
    with span("cnn.pack"):
        jobs = []
        for p in prepped:
            res = results.get(p.record.read_id)
            if res is None or not res.qc_passed or res.positions is None:
                continue
            pos = res.positions
            if pos.coord.shape[0] > chunk_positions:
                jobs += [(p, ch) for ch in _chunk_positions(
                    pos, chunk_positions, halo)]
            else:
                jobs.append((p, _whole(pos)))
        buckets: dict[int, list] = {}
        for p, ch in jobs:
            buckets.setdefault(_bucket_len(ch.n), []).append((p, ch))
    parts: dict[str, list] = {}
    for L, group in sorted(buckets.items()):
        bs = max(1, batch_positions // L)
        for i in range(0, len(group), bs):
            chunk = group[i : i + bs]
            B = len(chunk)
            with span("cnn.pack"):
                core = np.zeros((B, L), dtype=np.int64)
                resid = np.zeros((B, L), dtype=np.int64)
                counts = np.zeros((B, L), dtype=np.uint8)
                flats, t_index, t_spans = [], [], []
                for b, (p, ch) in enumerate(chunk):
                    c, r, n_sig, flat, is_t = ch.arrays()
                    core[b, : ch.n] = c
                    resid[b, : ch.n] = r
                    counts[b, : ch.n] = n_sig
                    flats.append(flat)
                    tpos = np.flatnonzero(is_t)
                    t_index.append(b * L + tpos)
                    t_spans.append(tpos.shape[0])
                flat = np.concatenate(flats)
            sig = _signal_windows(devmod.put_rows(flat, dev),
                                  devmod.put_rows(counts, dev), B, L)
            core_d, resid_d = (devmod.put_rows(core, dev),
                               devmod.put_rows(resid, dev))
            with span("cnn.forward"):
                probs = model(core_d, resid_d, sig)
            t_idx = devmod.put_rows(np.concatenate(t_index), dev)
            sel = devmod.to_host(probs.reshape(B * L, -1)[t_idx, 1:].float())
            o = 0
            for (p, ch), ct in zip(chunk, t_spans):
                parts.setdefault(p.record.read_id, []).append(
                    (ch.order, sel[o : o + ct]))
                o += ct
    out = {}
    for rid, lst in parts.items():
        lst.sort(key=lambda t: t[0])
        out[rid] = np.concatenate([a for _, a in lst])
    return out


def collect_calls(rec: ReadRecord, pos: AlignedPositions,
                  probs_t: np.ndarray) -> DetectedRead:
    """Per-read call table from the centre-T probabilities (columns [BrdU,
    EdU]; detect.cpp:686-714)."""
    sel = pos.center_is_T
    brdu = probs_t[:, 0].astype(np.float32)
    edu = probs_t[:, 1].astype(np.float32)
    # modbam side: skip positions whose reference index is in a deletion
    qsel_t = ~rec.ref_to_del[pos.ref_idx[sel]]
    return DetectedRead(
        record=rec, ref_coords=pos.coord[sel], edu_prob=edu, brdu_prob=brdu,
        kmer_starts=pos.kmer_start[sel],
        query_indices=pos.query_idx[sel][qsel_t],
        edu_prob_q=edu[qsel_t], brdu_prob_q=brdu[qsel_t])


def _bind_thread(dev: torch.device) -> None:
    """Make ``dev`` a worker thread's current CUDA device: a new thread
    starts on cuda:0, and what runs on the current device (the kernel
    wrappers guard their own launches) must run on the batch's."""
    if dev.type == "cuda":
        torch.cuda.set_device(dev)


def run_batches(records: Iterable[ReadRecord], process, batch_size: int,
                pipeline_depth: int, devices: list[torch.device],
                timer=None):
    """Generator of ``process(batch, device)`` over ``records`` cut into
    batches of ``batch_size``, batch *i* on ``devices[i mod N]``, each
    device with ``pipeline_depth`` batches in flight on its own worker
    threads (the reference's buffered OpenMP loop), all drained in
    submission order (its ordered writer, detect.cpp:852-906).  Every batch
    is what it would be on one device and runs there whole, so the output
    does not depend on N.  A thread prefetches the batches (signal IO)
    meanwhile.

    With ``timer`` (a ``utils.progress.StageTimer``) the three threads'
    steps are spans of batch *i*: the consumer's ``pipeline.submit_wait``
    and ``pipeline.drain_wait``, the producer's ``pipeline.source`` (each
    record) and ``pipeline.put_wait``, and a worker's ``batch`` around
    ``process``, inside which the pipeline's own span sites record."""
    n_dev = len(devices)
    in_flight = pipeline_depth * n_dev
    q: "queue.Queue" = queue.Queue(maxsize=in_flight)

    def traced(name, seq):
        return NULL if timer is None else timer.span(name, batch=seq)

    def producer():
        cur: list[ReadRecord] = []
        seq = 0
        try:
            with NULL if timer is None else timer.scope("producer"):
                it = iter(records)
                while True:
                    with traced("pipeline.source", seq):
                        rec = next(it, None)
                    if rec is None:
                        break
                    cur.append(rec)
                    if len(cur) >= batch_size:
                        with traced("pipeline.put_wait", seq):
                            q.put(cur)
                        cur = []
                        seq += 1
                if cur:
                    with traced("pipeline.put_wait", seq):
                        q.put(cur)
            q.put(None)
        except Exception as e:  # re-raised on the consumer side
            q.put(e)

    def traced_process(seq, batch, dev):
        with timer.scope("worker"), timer.span("batch", batch=seq):
            return process(batch, dev)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    with contextlib.ExitStack() as stack:
        pools = [stack.enter_context(ThreadPoolExecutor(
            max_workers=pipeline_depth, initializer=_bind_thread,
            initargs=(dev,))) for dev in devices]
        pending: deque = deque()
        i = 0

        def drain():
            seq, fut = pending.popleft()
            with traced("pipeline.drain_wait", seq):
                return fut.result()

        while True:
            with traced("pipeline.submit_wait", i):
                batch = q.get()
            if batch is None:
                break
            if isinstance(batch, Exception):
                t.join()
                raise batch
            k = i % n_dev
            job = ((process, batch, devices[k]) if timer is None
                   else (traced_process, i, batch, devices[k]))
            pending.append((i, pools[k].submit(*job)))
            i += 1
            while len(pending) >= in_flight:
                yield drain()
        while pending:
            yield drain()
    t.join()


def detect_reads(records: Iterable[ReadRecord], models: PoreModelSet,
                 model: DetectModel, cfg: SubstrateConfig = DNA_R10,
                 device: DeviceLike = "cuda", batch_size: int = 32,
                 stats: Optional[DetectStats] = None,
                 collect_failures: bool = False, pipeline_depth: int = 4,
                 strict_windows: bool = False, timer=None):
    """Generator of (read_id, DetectedRead or None) over ``records``, run on
    ``device`` (one device, or a device set: ``parallel/compute.py``) in
    batches of ``batch_size`` reads, ``pipeline_depth`` batches a device in
    flight; ``strict_windows`` aligns with the reference's window coupling
    (strict eventalign) instead of fast mode.  ``model`` lives on one of
    the devices and is copied to the others.

    ``timer`` (a ``utils.progress.StageTimer``) adds up the wall time of
    each batch's three stages under the JAX package's names.  Each stage
    ends by reading its results back to the host (prep the Theil-Sen
    shifts or the chase's moves, eventalign the Viterbi paths, the CNN its
    probabilities), so on a card a stage's wall includes its device work;
    no synchronise is added.  Batches in flight overlap, so the totals are
    approximate (telemetry, not accounting).  The timer also records the
    run's spans (``run_batches``; the steps inside the stages, ``collect``,
    and every ``h2d`` copy and ``readback`` as a device wait), which
    ``timer.spans()`` returns; the output does not depend on it."""
    devices = as_devices(device)
    model.eval()
    cnns = replicate_module(model, devices)
    tables = per_device(devices, lambda d: devmod.put_rows(
        models.pore_model.astype(np.float32), d))

    def stage(name):
        return NULL if timer is None else timer.time(name)

    def process(batch, dev):
        with stage("prep(events+scaling+banded)"):
            prepped = prepare_reads(batch, models, cfg, device=dev)
        with stage("eventalign(viterbi)"):
            results = run_eventalign(prepped, models, cfg,
                                     strict=strict_windows,
                                     model_table=tables[dev])
        with stage("cnn_forward"):
            probs = run_cnn_batched(cnns[dev], results, prepped, dev)
        out = []
        with span("collect"):
            for p in prepped:
                rid = p.record.read_id
                res = results.get(rid)
                if res is None or res.positions is None or rid not in probs:
                    out.append((rid, None))
                else:
                    out.append((rid, collect_calls(p.record, res.positions,
                                                   probs[rid])))
        return out

    for batch_out in run_batches(records, process, batch_size,
                                 pipeline_depth, devices, timer):
        for rid, d in batch_out:
            if stats is not None:
                stats.processed += 1
                stats.failed += d is None
            if d is not None or collect_failures:
                yield rid, d
