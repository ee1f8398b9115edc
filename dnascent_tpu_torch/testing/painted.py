"""Reads whose signal carries BrdU and EdU tracks, for fitting the detect
CNN and for running the fork workflow (detect -> forkSense -> seeBreaks) on
reads whose replication structure is known.

``painted_read`` is a copy of ``_painted_read`` in
``tests/test_workflow_e2e.py``: the same arguments give the same record bit
for bit.  ``painted_fork_dataset`` writes the files a user feeds the CLI
(FASTA, one pod5 file, BAM, index) for reads painted as right forks, left
forks and origins, with their truth in ``truth.json`` beside them."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

from ..config import DNA_R10
from ..io import bam as bam_io
from ..io import fasta as fasta_io
from ..io import pod5_io
from ..io.index_io import build_index
from ..io.poremodel import PoreModelSet
from ..pipeline.source import ReadRecord
from ..pipeline.traincnn import LABEL_IDS
from ..utils.seqtools import kmer_ranks
from .simulate import random_sequence, simulate_read

# track layouts, left to right on the forward strand, for --order EdU,BrdU
# (EdU in the first pulse): a right fork moves right, so its second-pulse
# BrdU lies downstream of its EdU; a left fork is the mirror; an origin
# fired in the first pulse has EdU flanked by two BrdU tracks
PATTERNS = {"right": ("EdU", "BrdU"), "left": ("BrdU", "EdU"),
            "origin": ("BrdU", "EdU", "BrdU")}


def edu_model(models: PoreModelSet) -> np.ndarray:
    """The EdU table of ``tests/test_workflow_e2e.py``: the analogue model
    with every mean 0.8 lower."""
    edu = models.analogue_model.copy()
    edu[:, 0] -= 0.8
    return edu


def painted_signal(models: PoreModelSet, edu: np.ndarray, sequence: str,
                   labels: np.ndarray, seed: int, shift: float = 90.0,
                   scale: float = 16.0) -> np.ndarray:
    """Raw pA signal of ``sequence``: each k-mer at the pore model's level,
    or the analogue model's where ``labels`` (per reference index) is BrdU
    and ``edu``'s where it is EdU; dwell and noise drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    ranks = kmer_ranks(sequence, DNA_R10.kmer_len)
    ranks = np.where(ranks < 0, 0, ranks)
    lab_k = labels[: ranks.shape[0]]
    means = models.pore_model[ranks, 0].astype(np.float64)
    means = np.where(lab_k == LABEL_IDS["BrdU"],
                     models.analogue_model[ranks, 0], means)
    means = np.where(lab_k == LABEL_IDS["EdU"], edu[ranks, 0], means)
    dwell = 4 + rng.poisson(8.0, size=ranks.shape[0])
    return (np.repeat(shift + scale * means, dwell)
            + rng.normal(0, 1.2, int(dwell.sum())))


def painted_read(models: PoreModelSet, edu: np.ndarray, length: int,
                 labels: np.ndarray, seed: int, read_id: str,
                 ref_start: int = 10000) -> ReadRecord:
    """A forward read of a random sequence (``simulate_read``'s, from
    ``seed``) painted by ``labels``, mapped all-M at ``ref_start`` of
    contig ``chrW``."""
    sim = simulate_read(models.pore_model, DNA_R10, length=length, seed=seed)
    raw = painted_signal(models, edu, sim.sequence, labels, seed, sim.shift,
                         sim.scale)
    idx = np.arange(length, dtype=np.int64)
    return ReadRecord(
        read_id=read_id, contig="chrW", ref_start=ref_start,
        ref_end=ref_start + length, is_reverse=False, basecall=sim.sequence,
        reference_seq=sim.sequence, ref_to_query=idx.copy(),
        query_to_ref=idx.copy(), ref_to_del=np.zeros(length, bool), raw=raw)


def labels_from_tracks(length: int, tracks) -> np.ndarray:
    """Label per index (``traincnn.LABEL_IDS``) of a read of ``length`` from
    (analogue, start, end) tracks in read coordinates."""
    labels = np.zeros(length, dtype=np.int32)
    for kind, s, e in tracks:
        labels[s:e] = LABEL_IDS[kind]
    return labels


def training_pairs(models: PoreModelSet, edu: np.ndarray, n_reads: int,
                   length: int, track_len: tuple, seed: int):
    """(ReadRecord, labels) pairs for fitting: each read holds one BrdU and
    one EdU track of a length drawn from ``track_len`` (low, high), in an
    order and at places drawn from ``seed``, so no position or order
    predicts a label."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n_reads):
        a, b = ("BrdU", "EdU") if rng.random() < 0.5 else ("EdU", "BrdU")
        la, lb = (int(x) for x in rng.integers(*track_len, size=2))
        gap = int(rng.integers(0, length - la - lb + 1))
        s = int(rng.integers(0, length - la - lb - gap + 1))
        tracks = [(a, s, s + la), (b, s + la + gap, s + la + gap + lb)]
        labels = labels_from_tracks(length, tracks)
        pairs.append((painted_read(models, edu, length, labels,
                                   int(rng.integers(1 << 31)), f"train-{i}"),
                      labels))
    return pairs


@dataclass
class PaintedFork:
    """One read's truth: its pattern (``PATTERNS``), span on the contig, and
    tracks as (analogue, start, end) in reference coordinates."""
    read_id: str
    pattern: str
    ref_start: int
    ref_end: int
    tracks: list
    at_end: bool = False

    @property
    def labels(self) -> np.ndarray:
        """Label per reference index of the read."""
        return labels_from_tracks(
            self.ref_end - self.ref_start,
            [(k, s - self.ref_start, e - self.ref_start)
             for k, s, e in self.tracks])

    def boundary(self) -> tuple:
        """(end of the first track, start of the second) of a fork."""
        return self.tracks[0][2], self.tracks[1][1]


@dataclass
class PaintedDataset:
    reference_fa: str
    bam: str
    signal_dir: str
    index: str
    truth: str
    reads: list


def _fork_tracks(rng, pattern: str, length: int, track_len: tuple,
                 margin: int, at_end: bool) -> list:
    """Contiguous tracks of ``pattern`` in read coordinates, each of a
    length drawn from ``track_len``.  With ``at_end`` the BrdU track of a
    fork runs to within 100 bp of the read end the fork moves towards;
    otherwise the tracks sit at least ``margin`` from both ends."""
    kinds = PATTERNS[pattern]
    lens = [int(x) for x in rng.integers(*track_len, size=len(kinds))]
    total = sum(lens)
    if at_end and pattern == "right":
        s = length - total - int(rng.integers(0, 100))
    elif at_end and pattern == "left":
        s = int(rng.integers(0, 100))
    else:
        s = int(rng.integers(margin, length - total - margin + 1))
    tracks = []
    for kind, n in zip(kinds, lens):
        tracks.append((kind, s, s + n))
        s += n
    return tracks


def painted_fork_dataset(outdir: str, models: PoreModelSet, n_right: int,
                         n_left: int, n_origin: int, read_length: int = 20000,
                         track_len: tuple = (2000, 4001), margin: int = 3000,
                         contig_length: int = 1_000_000, seed: int = 0,
                         end_fraction: float = 0.25) -> PaintedDataset:
    """Write ``n_right`` right-fork, ``n_left`` left-fork and ``n_origin``
    origin reads (``PATTERNS``) of ``read_length`` as a user's files:
    ``reference.fa`` (one seeded random contig ``chrP``), ``signal/
    batch0.pod5``, ``alignment.bam`` (each read its forward span of the
    contig, all-M), ``index.dnascent`` and ``truth.json`` (each read's
    ``PaintedFork``).  In about ``end_fraction`` of the fork reads the BrdU
    track runs to within 100 bp of the read end (seeBreaks' run-offs)."""
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    contig = random_sequence(rng, contig_length)
    fa = os.path.join(outdir, "reference.fa")
    fasta_io.write_fasta({"chrP": contig}, fa)
    signal_dir = os.path.join(outdir, "signal")
    os.makedirs(signal_dir, exist_ok=True)
    edu = edu_model(models)

    patterns = (["right"] * n_right + ["left"] * n_left
                + ["origin"] * n_origin)
    truth, signals, records = [], [], []
    for i, pattern in enumerate(patterns):
        start = int(rng.integers(0, contig_length - read_length))
        at_end = pattern != "origin" and bool(rng.random() < end_fraction)
        tracks = _fork_tracks(rng, pattern, read_length, track_len, margin,
                              at_end)
        refseq = contig[start: start + read_length]
        read_id = f"{i:08x}-0000-4000-8000-{seed & 0xFFFFFFFFFFFF:012x}"
        fork = PaintedFork(read_id, pattern, start, start + read_length,
                           [(k, start + s, start + e) for k, s, e in tracks],
                           at_end)
        raw = painted_signal(models, edu, refseq, fork.labels, seed + i)
        truth.append(fork)
        signals.append((read_id, raw))
        records.append(bam_io.build_record(
            read_id, 0, start, 60, [(bam_io.BAM_CMATCH, read_length)],
            refseq))

    pod5_io.write_pod5(os.path.join(signal_dir, "batch0.pod5"), signals)
    bam_path = os.path.join(outdir, "alignment.bam")
    header = f"@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:chrP\tLN:{contig_length}\n"
    w = bam_io.BamWriter(bam_path, header, ["chrP"], [contig_length])
    for r in records:
        w.write_record(r)
    w.close()
    index_path = os.path.join(outdir, "index.dnascent")
    build_index(signal_dir, index_path)
    truth_path = os.path.join(outdir, "truth.json")
    with open(truth_path, "w") as fh:
        json.dump([vars(f) for f in truth], fh)
    return PaintedDataset(fa, bam_path, signal_dir, index_path, truth_path,
                          truth)


def read_truth(path: str) -> list:
    """The ``PaintedFork`` list of a ``truth.json``."""
    with open(path) as fh:
        return [PaintedFork(**{**d, "tracks": [tuple(t) for t in d["tracks"]]})
                for d in json.load(fh)]
