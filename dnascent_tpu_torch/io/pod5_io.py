"""pod5 signal I/O without the pod5 C library.

A pod5 "combined" file embeds complete Arrow IPC files (read table, signal
table, run-info table) between a leading and trailing file signature, with a
flatbuffer footer locating them (reference access: src/pod5.cpp via the
pod5_format C API).  Rather than carrying a flatbuffer dependency, this
reader locates the embedded Arrow files by scanning for the ``ARROW1``
file magic pairs and identifies tables by their schemas — robust for
spec-conforming files.

Signal rows are VBZ-compressed: zig-zag delta int16 -> svb16 streamvbyte ->
zstd (nanoporetech/vbz).  The svb16 decode (1 control bit per value -> 1 or 2
data bytes) is vectorised with numpy.

The reading half of ``dnascent_tpu/io/pod5_io.py``, copied; pyarrow and
zstandard are imported guarded, so a host without them can still import the
port.

Calibration to pA follows pod5.cpp:57-61: pA = (raw + offset) * scale.
Dorado split-read slicing (sp/ts/ns tags) happens in the read source, as in
pod5.cpp:74-93.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass

import numpy as np

try:
    import pyarrow as pa
    import pyarrow.ipc
    HAVE_ARROW = True
except Exception:  # pragma: no cover
    HAVE_ARROW = False

try:
    import zstandard
    HAVE_ZSTD = True
except Exception:  # pragma: no cover
    HAVE_ZSTD = False

ARROW_MAGIC = b"ARROW1"


# ---------------------------------------------------------------------------
# VBZ codec (svb16 + zigzag delta + zstd)
# ---------------------------------------------------------------------------

def svb16_decode(data: bytes, count: int) -> np.ndarray:
    """StreamVByte 16-bit decode: ceil(n/8) key bytes, bit=1 -> 2 data
    bytes, bit=0 -> 1 data byte (little endian)."""
    n_keys = (count + 7) // 8
    keys = np.frombuffer(data, dtype=np.uint8, count=n_keys)
    bits = np.unpackbits(keys, bitorder="little")[:count].astype(np.int64)
    lengths = bits + 1
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    payload = np.frombuffer(data, dtype=np.uint8, offset=n_keys)
    lo = payload[offsets].astype(np.uint16)
    hi = np.zeros(count, dtype=np.uint16)
    two = lengths == 2
    hi[two] = payload[offsets[two] + 1].astype(np.uint16)
    return (lo | (hi << 8)).astype(np.uint16)


def _zigzag_decode(u: np.ndarray) -> np.ndarray:
    s = u.astype(np.int32)
    return (s >> 1) ^ -(s & 1)


def vbz_decompress(data: bytes, sample_count: int) -> np.ndarray:
    """VBZ -> int16 samples."""
    if not HAVE_ZSTD:
        raise RuntimeError("zstandard unavailable; pod5 support disabled")
    raw = zstandard.ZstdDecompressor().decompress(
        data, max_output_size=max(4 * sample_count + 64, 1 << 16))
    u = svb16_decode(raw, sample_count)
    deltas = _zigzag_decode(u)
    return np.cumsum(deltas, dtype=np.int64).astype(np.int16)


# ---------------------------------------------------------------------------
# Container scan + tables
# ---------------------------------------------------------------------------

def _embedded_arrow_spans(buf: bytes):
    """(start, end) byte ranges of embedded Arrow files.  Arrow files open
    AND close with the magic, so magics pair up in order."""
    spans = []
    pos = 0
    idxs = []
    while True:
        i = buf.find(ARROW_MAGIC, pos)
        if i < 0:
            break
        idxs.append(i)
        pos = i + len(ARROW_MAGIC)
    # pair consecutive magics (start, end) — an Arrow file begins with
    # "ARROW1\0\0" and ends with footer + "ARROW1"
    i = 0
    while i + 1 < len(idxs):
        start = idxs[i]
        # find the closing magic: the first subsequent magic NOT followed by
        # the \0\0 padding of a new file start
        j = i + 1
        while j < len(idxs):
            after = buf[idxs[j] + 6 : idxs[j] + 8]
            if after != b"\x00\x00":
                break
            # magic followed by \0\0 could also be a (rare) coincidence in
            # data; trust file structure: Arrow start magics only appear at
            # span starts, so the first candidate is the end
            break
        spans.append((start, idxs[j] + len(ARROW_MAGIC)))
        i = j + 1
    return spans


@dataclass
class Pod5Tables:
    reads: "pa.Table"
    signal: "pa.Table"


_TABLE_CACHE: dict[str, "Pod5Tables"] = {}
_TABLE_CACHE_MAX = 4


def _open_tables_cached(path: str) -> Pod5Tables:
    """Parsed-table cache: reads stream file-by-file (the read source sorts
    by filename like sortReadsByFilename, reads.cpp:16-38), so a tiny LRU
    avoids re-parsing the container per read."""
    t = _TABLE_CACHE.get(path)
    if t is None:
        t = _open_tables(path)
        if len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
            _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
        _TABLE_CACHE[path] = t
    return t


def _open_tables(path: str) -> Pod5Tables:
    if not HAVE_ARROW:
        raise RuntimeError("pyarrow unavailable; pod5 support disabled")
    with open(path, "rb") as fh:
        buf = fh.read()
    reads_t = signal_t = None
    for s, e in _embedded_arrow_spans(buf):
        try:
            reader = pa.ipc.open_file(pa.BufferReader(buf[s:e]))
        except Exception:
            continue
        t = reader.read_all()
        names = set(t.column_names)
        if {"read_id", "signal"} <= names and "samples" in names:
            signal_t = t
        elif "read_id" in names and ("signal" in names or "signal_" in names
                                     or "read_number" in names):
            reads_t = t
    if signal_t is None or reads_t is None:
        raise ValueError(f"{path}: could not locate pod5 read/signal tables")
    return Pod5Tables(reads=reads_t, signal=signal_t)


def _uuid_strs(col) -> list[str]:
    vals = col.to_pylist()
    out = []
    for v in vals:
        if isinstance(v, bytes):
            out.append(str(uuid.UUID(bytes=v)))
        else:
            out.append(str(v))
    return out


def pod5_get_signal(path: str, read_id: str, batch: int | None = None,
                    row: int | None = None) -> np.ndarray:
    """Full raw signal in pA for a read (pod5_getSignal, pod5.cpp:24-106)."""
    t = _open_tables_cached(path)
    ids = _uuid_strs(t.reads.column("read_id"))
    try:
        idx = ids.index(read_id)
    except ValueError:
        raise KeyError(f"{read_id} not present in {path}")
    srows = t.reads.column("signal")[idx].as_py()
    cal_offset = t.reads.column("calibration_offset")[idx].as_py()
    cal_scale = t.reads.column("calibration_scale")[idx].as_py()
    sig_ids = _uuid_strs(t.signal.column("read_id"))
    chunks = []
    for srow in srows:
        data = t.signal.column("signal")[srow].as_py()
        count = t.signal.column("samples")[srow].as_py()
        if isinstance(data, list):
            chunks.append(np.asarray(data, dtype=np.int16))
        else:
            chunks.append(vbz_decompress(data, count))
    raw = np.concatenate(chunks) if chunks else np.empty(0, np.int16)
    return (raw.astype(np.float64) + cal_offset) * cal_scale


def _is_uuid(s: str) -> bool:
    try:
        uuid.UUID(s)
        return True
    except ValueError:
        return False


def read_id_to_stored(read_id: str) -> str:
    """The UUID form a non-UUID read id is stored under (writer behaviour)."""
    if _is_uuid(read_id):
        return read_id
    return str(uuid.uuid5(uuid.NAMESPACE_DNS, read_id))
