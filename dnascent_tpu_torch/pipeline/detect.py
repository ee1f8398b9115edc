"""detect: per-thymidine BrdU/EdU probabilities (port of
``dnascent_tpu/pipeline/detect.py``; reference detect.cpp:735-920).

    read source -> prep (events, scaling, banded fill + chase, Theil-Sen)
                -> fast eventalign (windowed Viterbi fill + backtrace)
                -> CNN forward (reads batched by padded position count)
                -> per-read call tables -> writer

Batches run in a pipeline of worker threads with an ordered drain, so the
output keeps submission order (the reference's buffered OpenMP loop and
ordered writer, detect.cpp:852-906).  Reads failing QC are counted, not
fatal (detect.cpp:878-897).
"""

from __future__ import annotations

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
    """Per-read detect output (the call side of DNAscent::read).  The
    query-side fields the JAX package's modbam writer reads are not kept:
    the modbam output is not ported yet."""

    record: ReadRecord
    # per output position (centre base T), in aligned-position order
    ref_coords: np.ndarray      # (C,) int64
    edu_prob: np.ndarray        # (C,) float32
    brdu_prob: np.ndarray       # (C,) float32
    kmer_starts: np.ndarray     # (C,) int64 into record.reference_seq
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
    jobs = []
    for p in prepped:
        res = results.get(p.record.read_id)
        if res is None or not res.qc_passed or res.positions is None:
            continue
        pos = res.positions
        if pos.coord.shape[0] > chunk_positions:
            jobs += [(p, ch) for ch in _chunk_positions(pos, chunk_positions,
                                                        halo)]
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
            B = devmod.pad_rows(len(chunk))
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
            probs = model(devmod.put_rows(core, dev),
                          devmod.put_rows(resid, dev), sig)
            t_idx = devmod.put_rows(np.concatenate(t_index), dev)
            sel = probs.reshape(B * L, -1)[t_idx, 1:].float().cpu().numpy()
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
    return DetectedRead(
        record=rec, ref_coords=pos.coord[sel],
        edu_prob=probs_t[:, 1].astype(np.float32),
        brdu_prob=probs_t[:, 0].astype(np.float32),
        kmer_starts=pos.kmer_start[sel])


def detect_reads(records: Iterable[ReadRecord], models: PoreModelSet,
                 model: DetectModel, cfg: SubstrateConfig = DNA_R10,
                 device="cuda", batch_size: int = 32,
                 stats: Optional[DetectStats] = None,
                 collect_failures: bool = False, pipeline_depth: int = 4):
    """Generator of (read_id, DetectedRead or None) over ``records``, run on
    ``device`` in batches of ``batch_size`` reads, ``pipeline_depth``
    batches in flight.  ``model`` must already live on ``device``."""
    dev = devmod.resolve(device)
    model.eval()
    model_table = devmod.put_rep(models.pore_model.astype(np.float32), dev)
    def process(batch):
        prepped = prepare_reads(batch, models, cfg, device=dev)
        results = run_eventalign(prepped, models, cfg, model_table=model_table)
        probs = run_cnn_batched(model, results, prepped, dev)
        out = []
        for p in prepped:
            rid = p.record.read_id
            res = results.get(rid)
            if res is None or res.positions is None or rid not in probs:
                out.append((rid, None))
            else:
                out.append((rid, collect_calls(p.record, res.positions,
                                               probs[rid])))
        return out

    # prefetch record batches (signal IO) on a thread while batches run
    q: "queue.Queue" = queue.Queue(maxsize=pipeline_depth)

    def producer():
        cur: list[ReadRecord] = []
        try:
            for rec in records:
                cur.append(rec)
                if len(cur) >= batch_size:
                    q.put(cur)
                    cur = []
            if cur:
                q.put(cur)
            q.put(None)
        except Exception as e:  # re-raised on the consumer side
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    def drain(fut):
        for rid, d in fut.result():
            if stats is not None:
                stats.processed += 1
                stats.failed += d is None
            if d is not None or collect_failures:
                yield rid, d

    with ThreadPoolExecutor(max_workers=pipeline_depth) as ex:
        pending: deque = deque()
        while True:
            batch = q.get()
            if batch is None:
                break
            if isinstance(batch, Exception):
                t.join()
                raise batch
            pending.append(ex.submit(process, batch))
            while len(pending) >= pipeline_depth:
                yield from drain(pending.popleft())
        while pending:
            yield from drain(pending.popleft())
    t.join()
