"""Reader for TensorFlow tensor-bundle checkpoints (SavedModel
``variables/``) without TensorFlow.

The reference ships its trained detect CNN as a TF SavedModel
(``dnn_models/detect_model_BrdUEdU_DNAr10_4_1``; loaded through the TF C API
in src/tensor.cpp:24-105).  The port needs no TensorFlow, so this module (a
copy of ``dnascent_tpu/io/tf_bundle.py``) parses the bundle format directly:

* ``variables.index`` is a leveldb-format SSTable whose values are serialized
  ``BundleEntryProto`` messages (dtype, shape, shard, offset, size);
* ``variables.data-NNNNN-of-MMMMM`` shards hold the raw little-endian tensor
  bytes at the recorded offsets.

``read_index`` needs only the index file (enough to validate architecture
shapes); ``read_tensors`` additionally loads values when the data shards are
present, which is what :mod:`..models.cnn_import` builds on to load
reference-trained weights.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

# TF DataType enum -> numpy dtype (the subset that appears in checkpoints)
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 7: np.bytes_, 9: np.int64, 10: np.bool_, 14: np.uint16,
    17: np.uint16,  # bfloat16 stored as raw u16
    19: np.float16, 22: np.uint32, 23: np.uint64,
}


@dataclass(frozen=True)
class BundleEntry:
    name: str
    dtype: int
    shape: tuple[int, ...]
    shard_id: int
    offset: int
    size: int

    @property
    def np_dtype(self):
        return _DTYPES.get(self.dtype)


def _varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _block(data: bytes, offset: int, size: int) -> bytes:
    """Extract one table block; trailer is 1 compression byte + crc32."""
    raw = data[offset : offset + size]
    ctype = data[offset + size]
    if ctype == 0:
        return raw
    if ctype == 1:  # snappy — never used by TF's bundle writer, but be safe
        try:
            import snappy  # pragma: no cover

            return snappy.uncompress(raw)  # pragma: no cover
        except ImportError as e:  # pragma: no cover
            raise NotImplementedError("snappy-compressed bundle index") from e
    raise NotImplementedError(f"block compression {ctype}")


def _block_entries(block: bytes):
    """Yield (key, value) from a prefix-compressed leveldb block."""
    n_restarts = struct.unpack("<I", block[-4:])[0]
    end = len(block) - 4 * (n_restarts + 1)
    pos = 0
    key = b""
    while pos < end:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        vlen, pos = _varint(block, pos)
        key = key[:shared] + block[pos : pos + non_shared]
        pos += non_shared
        value = block[pos : pos + vlen]
        pos += vlen
        yield key, value


def _parse_shape(buf: bytes) -> tuple[int, ...]:
    """TensorShapeProto: repeated field 2 = Dim{ field 1 = size }."""
    dims = []
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 2 and wire == 2:
            ln, pos = _varint(buf, pos)
            sub = buf[pos : pos + ln]
            pos += ln
            spos = 0
            size = 0
            while spos < len(sub):
                stag, spos = _varint(sub, spos)
                if stag >> 3 == 1 and stag & 7 == 0:
                    size, spos = _varint(sub, spos)
                else:  # pragma: no cover — name field etc.
                    spos = _skip(sub, spos, stag & 7)
            dims.append(size)
        else:
            pos = _skip(buf, pos, wire)
    return tuple(dims)


def _skip(buf: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        _, pos = _varint(buf, pos)
    elif wire == 1:
        pos += 8
    elif wire == 2:
        ln, pos = _varint(buf, pos)
        pos += ln
    elif wire == 5:
        pos += 4
    else:  # pragma: no cover
        raise ValueError(f"wire type {wire}")
    return pos


def _parse_entry(name: str, buf: bytes) -> BundleEntry:
    """BundleEntryProto: 1 dtype, 2 shape, 3 shard_id, 4 offset, 5 size."""
    dtype = shard = offset = size = 0
    shape: tuple[int, ...] = ()
    pos = 0
    while pos < len(buf):
        tag, pos = _varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 0:
            dtype, pos = _varint(buf, pos)
        elif field == 2 and wire == 2:
            ln, pos = _varint(buf, pos)
            shape = _parse_shape(buf[pos : pos + ln])
            pos += ln
        elif field == 3 and wire == 0:
            shard, pos = _varint(buf, pos)
        elif field == 4 and wire == 0:
            offset, pos = _varint(buf, pos)
        elif field == 5 and wire == 0:
            size, pos = _varint(buf, pos)
        else:
            pos = _skip(buf, pos, wire)
    return BundleEntry(name, dtype, shape, shard, offset, size)


def read_index(index_path: str) -> dict[str, BundleEntry]:
    """Parse ``variables.index`` → {tensor name: BundleEntry}."""
    data = open(index_path, "rb").read()
    magic = struct.unpack("<Q", data[-8:])[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{index_path}: not a tensor-bundle index")
    footer = data[-48:]
    pos = 0
    _, pos = _varint(footer, pos)          # metaindex offset
    _, pos = _varint(footer, pos)          # metaindex size
    idx_off, pos = _varint(footer, pos)    # index block offset
    idx_size, pos = _varint(footer, pos)   # index block size
    index_block = _block(data, idx_off, idx_size)

    entries: dict[str, BundleEntry] = {}
    for _, handle in _block_entries(index_block):
        hoff, hpos = _varint(handle, 0)
        hsize, _ = _varint(handle, hpos)
        for key, value in _block_entries(_block(data, hoff, hsize)):
            name = key.decode("utf-8", "replace")
            if not name:  # BundleHeaderProto under the empty key
                continue
            entries[name] = _parse_entry(name, value)
    return entries


def read_tensors(prefix: str,
                 names: list[str] | None = None) -> dict[str, np.ndarray]:
    """Load tensors from a bundle given its prefix (``.../variables``).

    Requires the ``.data-NNNNN-of-MMMMM`` shard files next to the index.
    """
    entries = read_index(prefix + ".index")
    n_shards = 1
    for e in entries.values():
        n_shards = max(n_shards, e.shard_id + 1)
    shards = {}
    out: dict[str, np.ndarray] = {}
    for name, e in entries.items():
        if names is not None and name not in names:
            continue
        npdt = e.np_dtype
        if npdt is None or npdt is np.bytes_:
            continue
        if e.shard_id not in shards:
            shard_path = f"{prefix}.data-{e.shard_id:05d}-of-{n_shards:05d}"
            if not os.path.exists(shard_path):
                raise FileNotFoundError(
                    f"bundle data shard missing: {shard_path} (the index "
                    "alone carries only dtypes/shapes)")
            shards[e.shard_id] = np.memmap(shard_path, dtype=np.uint8,
                                           mode="r")
        raw = shards[e.shard_id][e.offset : e.offset + e.size]
        arr = np.frombuffer(raw.tobytes(), dtype=npdt)
        out[name] = arr.reshape(e.shape)
    return out


def read_savedmodel_shapes(model_dir: str) -> dict[str, BundleEntry]:
    """Index a SavedModel directory's variables (shapes/dtypes only)."""
    return read_index(os.path.join(model_dir, "variables", "variables.index"))
