"""The benchmark's inputs: pore tables, simulated and painted reads, and the
files a user feeds ``detect`` (FASTA, pod5, BAM, index).

Frozen copies of the port's generators and writers
(``dnascent_tpu_torch/testing/simulate.py``, ``testing/painted.py``,
``testing/dataset.py``, ``io/poremodel.py``'s synthetic tables and the
writer halves of ``io/pod5_io.py``, ``io/bam.py``, ``io/index_io.py`` and
``io/fasta.py``), so that a later change to the program cannot change a
cell's inputs.  Nothing here imports the program.

A traffic mix (``perfbench/traffic/<name>.json``) is read by ``make_pool``:
a fixed set of read lengths (the same for every seed; the seed draws their
order, sequences, strands, dwell times, noise and analogue tracks).
"""

from __future__ import annotations

import os
import struct
import uuid
import zlib
from dataclasses import dataclass, field

import numpy as np

KMER = 9
# the R10.4.1 preset's static stdv (DNAscent data_IO.cpp:173)
STATIC_STDV = 0.14
# A=0, T=1, G=2, C=3 (DNAscent data_IO.cpp:131)
_CODE = np.full(256, -1, dtype=np.int8)
for _b, _v in (("A", 0), ("T", 1), ("G", 2), ("C", 3)):
    _CODE[ord(_b)] = _v
_COMP = np.arange(256, dtype=np.uint8)
for _a, _c in (("A", "T"), ("T", "A"), ("G", "C"), ("C", "G"), ("N", "N")):
    _COMP[ord(_a)] = ord(_c)


def encode_bases(seq: str) -> np.ndarray:
    return _CODE[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def reverse_complement(seq: str) -> str:
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _COMP[raw][::-1].tobytes().decode("ascii")


def kmer_ranks(seq: str, k: int = KMER) -> np.ndarray:
    """Base-4 rank of every k-mer (leftmost base most significant), -1
    where a k-mer holds a base other than ACGT."""
    codes = encode_bases(seq).astype(np.int64)
    n = codes.size - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    bad = codes < 0
    safe = np.where(bad, 0, codes)
    ranks = np.zeros(n, dtype=np.int64)
    anybad = np.zeros(n, dtype=bool)
    for i in range(k):
        ranks += safe[i : i + n] << (2 * (k - 1 - i))
        anybad |= bad[i : i + n]
    ranks[anybad] = -1
    return ranks


# ---------------------------------------------------------------------------
# Pore tables (the synthetic R10.4.1 9-mer stand-in; ONT's table is not in
# the repository)
# ---------------------------------------------------------------------------

def synthetic_table(seed: int = 1, analogue_shift: float = 0.0,
                    k: int = KMER) -> np.ndarray:
    """(4^k, 2) f32 (mean, stdv) in normalised units: means smooth in base
    composition plus k-mer noise; ``analogue_shift`` moves every k-mer that
    holds a T (a BrdU-substituted table)."""
    n = 4 ** k
    rng = np.random.default_rng(seed)
    idx = np.arange(n, dtype=np.int64)
    codes = np.empty((n, k), dtype=np.int64)
    tmp = idx.copy()
    for i in range(k - 1, -1, -1):
        codes[:, i] = tmp % 4
        tmp //= 4
    base_level = np.array([0.35, -0.75, 1.15, -1.05])
    w = np.exp(-0.5 * ((np.arange(k) - (k - 1) / 2) / 1.6) ** 2)
    w = w * k / w.sum()
    means = (base_level[codes] * w).mean(axis=1) * 1.6
    means = means + rng.normal(0.0, 0.35, size=n)
    if analogue_shift != 0.0:
        means = means + (codes == 1).any(axis=1) * analogue_shift
    stdvs = 0.10 + 0.08 * rng.random(n)
    return np.stack([means, stdvs], axis=1).astype(np.float32)


@dataclass
class Tables:
    pore: np.ndarray       # static-stdv table the pipeline aligns with
    analogue: np.ndarray   # BrdU levels (painting)
    edu: np.ndarray        # EdU levels (painting)


def pore_tables(seed: int = 1) -> Tables:
    pore = synthetic_table(seed)
    pore[:, 1] = STATIC_STDV
    analogue = synthetic_table(seed, analogue_shift=0.40)
    edu = analogue.copy()
    edu[:, 0] -= 0.8
    return Tables(pore, analogue, edu)


# ---------------------------------------------------------------------------
# Reads
# ---------------------------------------------------------------------------

def random_sequence(rng: np.random.Generator, length: int) -> str:
    return np.frombuffer(b"ATGC", dtype=np.uint8)[
        rng.integers(0, 4, size=length)].tobytes().decode("ascii")


def signal(tables: Tables, seq: str, labels, rng: np.random.Generator,
           shift: float = 90.0, scale: float = 16.0,
           noise: float = 1.2) -> np.ndarray:
    """Raw pA of ``seq`` (5'->3' as sequenced): each k-mer at its table's
    level (``labels`` per k-mer: 0 unlabelled, 1 BrdU, 2 EdU), a dwell of 4
    + Poisson(8) samples, Gaussian noise."""
    ranks = kmer_ranks(seq)
    ranks = np.where(ranks < 0, 0, ranks)
    means = tables.pore[ranks, 0].astype(np.float64)
    if labels is not None:
        lab = labels[: ranks.shape[0]]
        means = np.where(lab == 1, tables.analogue[ranks, 0], means)
        means = np.where(lab == 2, tables.edu[ranks, 0], means)
    dwell = 4 + rng.poisson(8.0, size=ranks.shape[0])
    return (np.repeat(shift + scale * means, dwell)
            + rng.normal(0.0, noise, size=int(dwell.sum())))


# fork track layouts left to right on the forward strand (EdU first pulse)
PATTERNS = {"right": (2, 1), "left": (1, 2), "origin": (1, 2, 1)}


def fork_labels(rng: np.random.Generator, length: int, pattern: str,
                track_len=(2000, 4001), margin: int = 1000) -> np.ndarray:
    """Per-base labels of one read painted with ``pattern``'s contiguous
    tracks, each of a length drawn from ``track_len`` (shrunk to fit)."""
    kinds = PATTERNS[pattern]
    lens = rng.integers(*track_len, size=len(kinds))
    room = max(len(kinds), length - 2 * margin)
    lens = np.maximum(1, (lens * min(1.0, room / lens.sum())).astype(int))
    s = int(rng.integers(margin, max(margin + 1, length - lens.sum() - margin)))
    labels = np.zeros(length, dtype=np.int8)
    for kind, n in zip(kinds, lens):
        labels[s : s + n] = kind
        s += n
    return labels


@dataclass
class PoolRead:
    """One read of a cell's pool, as the benchmark made it."""

    read_id: str
    refseq: str          # the mapped reference span, forward strand
    ref_start: int
    is_reverse: bool
    raw: np.ndarray      # pA, as the program will see it
    noise: bool = False  # signal replaced by noise: the read fails QC
    labels: np.ndarray = field(default=None, repr=False)

    @property
    def length(self) -> int:
        return len(self.refseq)

    @property
    def seq(self) -> str:
        """The read in sequencing orientation (error-free: basecall ==
        mapped reference)."""
        return reverse_complement(self.refseq) if self.is_reverse \
            else self.refseq


def traffic_lengths(traffic: dict) -> np.ndarray:
    """The mix's read lengths: one fixed set drawn from the traffic file's
    own ``length_seed``, whatever the run's seed."""
    n = int(traffic["pool"])
    dist = traffic["lengths"]
    if dist["kind"] == "fixed":
        lengths = np.full(n, int(dist["bp"]))
    elif dist["kind"] == "lognormal":
        rng = np.random.default_rng(int(dist["length_seed"]))
        lengths = np.exp(rng.normal(np.log(dist["median_bp"]), dist["sigma"],
                                    size=n))
        lengths = np.clip(lengths, dist["min_bp"], dist["max_bp"]).astype(int)
    else:
        raise ValueError(f"unknown length distribution {dist['kind']!r}")
    return lengths[lengths >= int(traffic.get("min_read_length", 0))]


def _quantise_pa(raw: np.ndarray, scale: float) -> np.ndarray:
    """pA as stored in pod5 and read back: int16 counts of ``scale`` pA."""
    return np.round(raw / scale).astype(np.int16).astype(np.float64) * scale


def make_pool(traffic: dict, tables: Tables,
              seed: int) -> tuple[list[PoolRead], str]:
    """(pool, contig or None) of the cell from ``seed``: the mix's fixed lengths in a
    seeded order, each read a seeded random span of one seeded contig
    (memory mixes: its own random sequence), a fixed share on the reverse
    strand, the reads with ``i % noise_every == noise_at`` turned to noise,
    and fork tracks painted on reads of ``paint_min_bp`` or more."""
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(traffic_lengths(traffic))
    n = lengths.shape[0]
    n_rev = int(round(float(traffic.get("reverse_share", 0.0)) * n))
    reverse = np.zeros(n, dtype=bool)
    reverse[rng.permutation(n)[:n_rev]] = True
    noise_every = traffic.get("noise_every")
    paint = traffic.get("paint")
    contig = None
    if traffic["source"] == "pod5":
        contig = random_sequence(rng, int(traffic["contig_bp"]))
    pod5_scale = float(traffic.get("pod5_scale_pa", 0.1875))
    pool = []
    for i, length in enumerate(lengths.tolist()):
        r = np.random.default_rng(rng.integers(1 << 63))
        if contig is None:
            start = 1000 + 10 * i
            refseq = random_sequence(r, length)
        else:
            start = int(r.integers(0, len(contig) - length))
            refseq = contig[start : start + length]
        read = PoolRead(f"{i:08x}-0000-4000-8000-{seed & 0xFFFFFFFFFFFF:012x}",
                        refseq, start, bool(reverse[i]), None)
        if paint and length >= int(paint["min_bp"]):
            names = list(paint["patterns"])
            weights = np.asarray([paint["patterns"][k] for k in names], float)
            pattern = names[int(r.choice(len(names), p=weights / weights.sum()))]
            fwd = fork_labels(r, length, pattern)
            read.labels = fwd[::-1].copy() if read.is_reverse else fwd
        if noise_every and i % int(noise_every) == int(traffic["noise_at"]):
            read.noise = True
            n_samples = 12 * length
            read.raw = r.normal(90.0, 30.0, size=n_samples)
        else:
            read.raw = signal(tables, read.seq, read.labels, r)
        if traffic["source"] == "pod5":
            read.raw = _quantise_pa(read.raw, pod5_scale)
        pool.append(read)
    return pool, contig


# ---------------------------------------------------------------------------
# Files: FASTA, pod5 (VBZ), BAM, index
# ---------------------------------------------------------------------------

def write_fasta(path: str, name: str, seq: str, width: int = 80) -> None:
    with open(path, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), width):
            fh.write(seq[i : i + width] + "\n")


POD5_SIGNATURE = b"\x8bPOD\r\n\x1a\n"


def _svb16_encode(v: np.ndarray) -> bytes:
    v = np.asarray(v, dtype=np.uint16)
    two = v > 0xFF
    bits = two.astype(np.uint8)
    keys = np.packbits(bits, bitorder="little")
    lengths = bits.astype(np.int64) + 1
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    payload = np.zeros(int(lengths.sum()), dtype=np.uint8)
    payload[offsets] = (v & 0xFF).astype(np.uint8)
    payload[offsets[two] + 1] = (v[two] >> 8).astype(np.uint8)
    return keys.tobytes() + payload.tobytes()


def _vbz_compress(samples: np.ndarray, codec) -> bytes:
    """VBZ: zig-zag deltas of int16, svb16, zstd."""
    s = np.asarray(samples, dtype=np.int16).astype(np.int32)
    d = np.diff(s, prepend=0)
    zz = ((d << 1) ^ (d >> 31)).astype(np.uint16)
    return codec.compress(_svb16_encode(zz), asbytes=True)


def write_pod5(path: str, reads: list[tuple[str, np.ndarray]],
               scale: float = 0.1875, chunk: int = 102400) -> None:
    """A pod5 container: signature, the read table and the signal table as
    embedded Arrow IPC files (rows VBZ-compressed), signature."""
    import pyarrow as pa
    import pyarrow.ipc  # noqa: F401

    codec = pa.Codec("zstd", compression_level=1)
    sig_ids, sig_bytes, sig_counts, read_ids, read_rows = [], [], [], [], []
    for read_id, pa_signal in reads:
        raw = np.round(pa_signal / scale).astype(np.int16)
        rid = uuid.UUID(read_id).bytes
        rows = []
        for s in range(0, raw.shape[0], chunk):
            part = raw[s : s + chunk]
            sig_ids.append(rid)
            sig_bytes.append(_vbz_compress(part, codec))
            sig_counts.append(part.shape[0])
            rows.append(len(sig_ids) - 1)
        read_ids.append(rid)
        read_rows.append(rows)
    signal_table = pa.table({
        "read_id": pa.array(sig_ids, type=pa.binary(16)),
        "signal": pa.array(sig_bytes, type=pa.large_binary()),
        "samples": pa.array(sig_counts, type=pa.uint32()),
    })
    read_table = pa.table({
        "read_id": pa.array(read_ids, type=pa.binary(16)),
        "signal": pa.array(read_rows, type=pa.list_(pa.uint64())),
        "read_number": pa.array(range(len(reads)), type=pa.uint32()),
        "calibration_offset": pa.array([0.0] * len(reads), type=pa.float32()),
        "calibration_scale": pa.array([scale] * len(reads),
                                      type=pa.float32()),
    })

    def arrow_bytes(table):
        sink = pa.BufferOutputStream()
        with pa.ipc.new_file(sink, table.schema) as w:
            w.write_table(table)
        return sink.getvalue().to_pybytes()

    with open(path, "wb") as fh:
        fh.write(POD5_SIGNATURE)
        fh.write(arrow_bytes(read_table))
        fh.write(arrow_bytes(signal_table))
        fh.write(POD5_SIGNATURE)


_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_SEQ_ENCODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
BAM_CMATCH = 0
FLAG_REVERSE = 0x10


def _bgzf_block(chunk: bytes) -> bytes:
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 4 + b"\x00\xff"
              + struct.pack("<H", 6) + b"BC"
              + struct.pack("<HH", 2, len(cdata) + 25))
    return header + cdata + struct.pack("<II", zlib.crc32(chunk),
                                        len(chunk) & 0xFFFFFFFF)


def bam_record(qname: str, pos: int, length_seq: str, flag: int) -> bytes:
    """One all-M BAM record body, SEQ forward as SAM stores it, no
    qualities (0xff)."""
    qname_b = qname.encode("ascii") + b"\x00"
    n = len(length_seq)
    codes = np.array([_SEQ_ENCODE[c] for c in length_seq], dtype=np.uint8)
    packed = np.zeros((n + 1) // 2, dtype=np.uint8)
    packed[: (n + 1) // 2] |= codes[0::2] << 4
    packed[: n // 2] |= codes[1::2]
    body = struct.pack("<iiBBHHHiiii", 0, pos, len(qname_b), 60, 0, 1, flag,
                       n, -1, -1, 0)
    body += qname_b + struct.pack("<I", (n << 4) | BAM_CMATCH)
    return body + packed.tobytes() + b"\xff" * n


def write_bam(path: str, contig: str, contig_len: int,
              records: list[bytes]) -> None:
    text = (f"@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:{contig}\tLN:{contig_len}\n"
            ).encode("ascii")
    name = contig.encode("ascii") + b"\x00"
    body = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text
                     + struct.pack("<i", 1) + struct.pack("<i", len(name))
                     + name + struct.pack("<i", contig_len))
    for rec in records:
        body += struct.pack("<i", len(rec)) + rec
    with open(path, "wb") as fh:
        for s in range(0, len(body), 65280):
            fh.write(_bgzf_block(bytes(body[s : s + 65280])))
        fh.write(_BGZF_EOF)


@dataclass
class Files:
    fasta: str
    bam: str
    index: str
    pod5: str
    contig: str


def write_files(outdir: str, traffic: dict, pool: list[PoolRead],
                contig_seq: str) -> Files:
    """The user's four inputs for ``pool``: one contig, one pod5 file (all
    reads, batch 0), an all-M BAM in pool order, and the index."""
    contig = traffic.get("contig_name", "chrB")
    fa = os.path.join(outdir, "reference.fa")
    write_fasta(fa, contig, contig_seq)
    sig_dir = os.path.join(outdir, "signal")
    os.makedirs(sig_dir, exist_ok=True)
    pod5 = os.path.join(sig_dir, "batch0.pod5")
    write_pod5(pod5, [(r.read_id, r.raw) for r in pool],
               float(traffic.get("pod5_scale_pa", 0.1875)))
    bam = os.path.join(outdir, "alignment.bam")
    write_bam(bam, contig, len(contig_seq),
              [bam_record(r.read_id, r.ref_start, r.refseq,
                          FLAG_REVERSE if r.is_reverse else 0)
               for r in pool])
    index = os.path.join(outdir, "index.dnascent")
    with open(index, "w") as fh:
        for row, r in enumerate(pool):
            fh.write(f"{r.read_id}\t0\t{row}\t{pod5}\n")
    return Files(fa, bam, index, pod5, contig)
