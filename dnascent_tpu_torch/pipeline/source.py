"""Read sources: the host-side record feeding the pipeline.

``ReadRecord`` carries everything ``DNAscent::read`` derives from a BAM
record + raw signal (reference: src/reads.h:178-304): the basecall and the
mapped reference subsequence (both in 5'->3' *sequencing* direction, i.e.
reverse-complemented for reverse-strand reads), CIGAR-derived coordinate
maps, and the raw pA signal.

Concrete sources (copies of ``dnascent_tpu/pipeline/source.py``'s):
* ``BamSignalSource`` (io/bam.py + io/pod5_io.py or io/fast5_io.py) — the
  production path;
* ``SimulatedSource`` — deterministic synthetic reads for tests/benchmarks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np

from ..config import SubstrateConfig, DNA_R10
from ..testing.simulate import simulate_read
from ..utils.progress import span
from ..utils.seqtools import reverse_complement


@dataclass
class ReadRecord:
    read_id: str
    contig: str
    ref_start: int
    ref_end: int
    is_reverse: bool
    basecall: str                 # 5'->3' sequencing direction
    reference_seq: str            # mapped ref subsequence, same orientation
    ref_to_query: np.ndarray      # (refLen,) int64 (reads.h:192; htsInterface.cpp:59)
    query_to_ref: np.ndarray      # (queryLen,) int64, -1 where unmapped
    ref_to_del: np.ndarray        # (refLen,) bool
    raw: np.ndarray               # (S,) float64 pA
    mapping_quality: int = 60
    bam_record: object = None     # source BamRecord (modbam passthrough)

    @property
    def strand(self) -> str:
        return "rev" if self.is_reverse else "fwd"

    @property
    def ref_span(self) -> int:
        return self.ref_end - self.ref_start


class BamSignalSource:
    """Production source: BAM records + pod5/fast5 raw signal.

    Mirrors the DNAscent::read constructor (reads.h:210-287): Dorado tags
    ns/ts/pi/sp drive split-read signal slicing (pod5.cpp:74-93), reverse
    records revcomp both basecall and mapped reference, and the record
    filter matches detect_main (mapq, ref span, non-empty SEQ;
    detect.cpp:833-845).
    """

    def __init__(self, bam_path: str, reference: dict, index: dict,
                 min_mapq: int = 20, min_length: int = 1000,
                 max_reads: int | None = None, on_missing=None,
                 shard: tuple[int, int] | None = None):
        self.bam_path = bam_path
        self.reference = reference
        self.index = index
        self.min_mapq = min_mapq
        self.min_length = min_length
        self.max_reads = max_reads
        self.on_missing = on_missing
        # (process_index, process_count): multi-host data parallelism — each
        # host takes every process_count-th filter-passing record, skipping
        # non-owned records BEFORE the signal fetch (the expensive part).
        # New subsystem vs the reference (single process; SURVEY §5).
        self.shard = shard

    def _kept(self, reader):
        """The BAM records the filter keeps (mapq, ref span, non-empty SEQ,
        this shard's share), as (record, CIGAR, ref_start, ref_end)."""
        from ..io import bam as bam_io
        seen = 0
        for rec in reader:
            if rec.is_unmapped or rec.ref_id < 0 or rec.l_seq == 0:
                continue
            cigar = rec.cigar()
            ref_start, ref_end = bam_io.get_ref_span(cigar, rec.pos)
            if (rec.mapq < self.min_mapq
                    or ref_end - ref_start < self.min_length):
                continue
            if self.shard is not None:
                owner = seen % self.shard[1] == self.shard[0]
                seen += 1
                if not owner:
                    continue
            yield rec, cigar, ref_start, ref_end

    def count_records(self) -> int:
        """Pre-pass counting the records this source will yield (modulo
        missing-index skips) — the reference's ``countRecords`` progress-bar
        total (htsInterface.cpp:15-30, detect.cpp:829).  Signal files are
        not touched; only the BAM is scanned."""
        from ..io import bam as bam_io
        reader = bam_io.BamReader(self.bam_path)
        n = 0
        for _ in self._kept(reader):
            if self.max_reads is not None and n >= self.max_reads:
                break
            n += 1
        reader.close()
        return n

    def __iter__(self) -> Iterator[ReadRecord]:
        """The records with their signal.  On a thread that records spans
        (``utils.progress``), reading and filtering BAM records and the
        CIGAR maps are ``source.bam`` spans and the signal fetch a
        ``source.pod5`` span."""
        from ..io import bam as bam_io
        from ..io import fast5_io, pod5_io

        reader = bam_io.BamReader(self.bam_path)
        kept = self._kept(reader)
        count = 0
        while self.max_reads is None or count < self.max_reads:
            with span("source.bam"):
                nxt = next(kept, None)
            if nxt is None:
                break
            rec, cigar, ref_start, ref_end = nxt
            read_id = rec.qname
            fetch_id = read_id
            parent = rec.get_tag("pi")
            sp = rec.get_tag("sp") or 0
            ts = rec.get_tag("ts") or 0
            ns = rec.get_tag("ns")
            if parent:
                fetch_id = parent
            entry = self.index.get(fetch_id)
            if entry is None:
                if self.on_missing:
                    self.on_missing(read_id)
                continue
            if entry.path.endswith(".pod5"):
                with span("source.pod5"):
                    stored = pod5_io.read_id_to_stored(fetch_id)
                    raw = pod5_io.pod5_get_signal(entry.path, stored,
                                                  entry.batch, entry.row)
            else:
                raw = fast5_io.fast5_get_signal(entry.path, fetch_id)
            if raw.shape[0] == 0:
                continue
            # Dorado signal slicing (pod5.cpp:74-93)
            if ns is not None and ns > 0:
                if fetch_id != read_id:
                    raw = raw[sp + ts : sp + ns]
                else:
                    raw = raw[ts:ns]

            with span("source.bam"):
                contig = reader.ref_names[rec.ref_id]
                refseq = self.reference[contig][ref_start:ref_end]
                r2q, q2r, r2d, _, _ = bam_io.parse_cigar(cigar, rec.pos,
                                                         rec.is_reverse)
                basecall = rec.seq()
                if rec.is_reverse:
                    basecall = reverse_complement(basecall)
                    refseq = reverse_complement(refseq)
                q2r_arr = np.full(len(basecall), -1, dtype=np.int64)
                q2r_arr[: q2r.shape[0]] = q2r
            count += 1
            yield ReadRecord(
                read_id=read_id,
                contig=contig,
                ref_start=ref_start,
                ref_end=ref_end,
                is_reverse=rec.is_reverse,
                basecall=basecall,
                reference_seq=refseq,
                ref_to_query=r2q,
                query_to_ref=q2r_arr,
                ref_to_del=r2d,
                raw=raw,
                mapping_quality=rec.mapq,
                bam_record=rec,
            )
        reader.close()


class SimulatedSource:
    """Yields error-free simulated reads (query == reference, identity maps).

    ``analogue_spans`` optionally paints BrdU/EdU tracks onto subranges to
    exercise detect/forkSense end-to-end.
    """

    def __init__(self, models, cfg: SubstrateConfig = DNA_R10, n_reads: int = 8,
                 length: int = 5000, seed: int = 0, contig: str = "chrSim",
                 analogue_painter=None, reverse: bool = False):
        self.models = models
        self.cfg = cfg
        self.n_reads = n_reads
        self.length = length
        self.seed = seed
        self.contig = contig
        self.analogue_painter = analogue_painter
        # reverse-strand records: basecall/reference stay in sequencing
        # orientation (as the BAM source delivers them, reads.h:280-286);
        # only the genome-coordinate mapping flips
        self.reverse = reverse

    def __iter__(self) -> Iterator[ReadRecord]:
        for i in range(self.n_reads):
            seed = self.seed + i
            mask = None
            if self.analogue_painter is not None:
                mask = self.analogue_painter(seed, self.length)
            sim = simulate_read(self.models.pore_model, self.cfg,
                                length=self.length, seed=seed,
                                analogue_model=self.models.analogue_model,
                                analogue_mask=mask)
            L = len(sim.sequence)
            idx = np.arange(L, dtype=np.int64)
            yield ReadRecord(
                read_id=sim.read_id,
                contig=self.contig,
                ref_start=1000 + 10 * i,
                ref_end=1000 + 10 * i + L,
                is_reverse=self.reverse,
                basecall=sim.sequence,
                reference_seq=sim.sequence,
                ref_to_query=idx.copy(),
                query_to_ref=idx.copy(),
                ref_to_del=np.zeros(L, dtype=bool),
                raw=sim.raw,
            )
