"""Minimal TF tensor-bundle (SavedModel ``variables/``) WRITER.

A copy of ``dnascent_tpu/testing/tf_bundle_writer.py``, the counterpart of
:mod:`..io.tf_bundle`: it emits the leveldb-format
SSTable index + raw data shard that TensorFlow's BundleWriter produces, so
tests can fabricate a reference-shaped SavedModel directory end to end and
the from-scratch reader is guarded against self-consistent drift (the two
sides are developed independently against the format spec: TF
tensor_bundle.cc + leveldb table_format.md).

Layout written (the subset the format requires):
* one data block holding all (key, BundleEntryProto) pairs sorted by key,
  prefix-compressed with a single restart point;
* an empty metaindex block;
* an index block mapping a separator key -> the data block's handle;
* the 48-byte footer: metaindex handle, index handle, padding, magic;
* every block carries its 1-byte compression type + masked crc32c trailer;
* ``variables.data-00000-of-00001`` holds the tensors' little-endian bytes
  back to back at the offsets recorded in the index.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

_NP2TF = {np.dtype(np.float32): 1, np.dtype(np.float64): 2,
          np.dtype(np.int32): 3, np.dtype(np.uint8): 4,
          np.dtype(np.int64): 9, np.dtype(np.bool_): 10,
          np.dtype(np.float16): 19}

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        tab = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tab.append(c)
        _CRC_TABLE = tab
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _block(entries: list[tuple[bytes, bytes]]) -> bytes:
    """A leveldb block: no prefix sharing (shared=0 per entry), one restart
    point at 0."""
    body = bytearray()
    for key, value in entries:
        body += _varint(0) + _varint(len(key)) + _varint(len(value))
        body += key + value
    body += struct.pack("<I", 0)        # restart[0]
    body += struct.pack("<I", 1)        # n_restarts
    return bytes(body)


def _entry_proto(dtype: int, shape, shard: int, offset: int,
                 size: int) -> bytes:
    """BundleEntryProto: 1 dtype, 2 TensorShapeProto, 3 shard, 4 offset,
    5 size."""
    shape_proto = bytearray()
    for d in shape:
        dim = _varint(1 << 3 | 0) + _varint(int(d))   # Dim.size = field 1
        shape_proto += _varint(2 << 3 | 2) + _varint(len(dim)) + dim
    out = bytearray()
    out += _varint(1 << 3 | 0) + _varint(dtype)
    out += _varint(2 << 3 | 2) + _varint(len(shape_proto)) + bytes(shape_proto)
    if shard:
        out += _varint(3 << 3 | 0) + _varint(shard)
    if offset:
        out += _varint(4 << 3 | 0) + _varint(offset)
    out += _varint(5 << 3 | 0) + _varint(size)
    return bytes(out)


def write_bundle(prefix: str, tensors: dict[str, np.ndarray]) -> None:
    """Write ``<prefix>.index`` + ``<prefix>.data-00000-of-00001``."""
    names = sorted(tensors)
    data = bytearray()
    index_entries: list[tuple[bytes, bytes]] = []
    # empty key -> BundleHeaderProto {num_shards=1, endianness=0(LE)}
    header = _varint(1 << 3 | 0) + _varint(1)
    index_entries.append((b"", header))
    for name in names:
        arr = np.ascontiguousarray(tensors[name])
        tf_dtype = _NP2TF[arr.dtype]
        raw = arr.tobytes()
        index_entries.append((name.encode(), _entry_proto(
            tf_dtype, arr.shape, 0, len(data), len(raw))))
        data += raw
    with open(f"{prefix}.data-00000-of-00001", "wb") as fh:
        fh.write(bytes(data))

    out = bytearray()

    def emit_block(entries) -> tuple[int, int]:
        blk = _block(entries)
        off = len(out)
        out.extend(blk)
        out.append(0)                                  # compression: none
        out.extend(struct.pack("<I", _masked_crc(blk + b"\x00")))
        return off, len(blk)

    data_off, data_size = emit_block(index_entries)
    meta_off, meta_size = emit_block([])
    handle = _varint(data_off) + _varint(data_size)
    idx_off, idx_size = emit_block([(b"\xff", handle)])
    footer = bytearray()
    footer += _varint(meta_off) + _varint(meta_size)
    footer += _varint(idx_off) + _varint(idx_size)
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", _TABLE_MAGIC)
    out += footer
    with open(f"{prefix}.index", "wb") as fh:
        fh.write(bytes(out))


def write_savedmodel_dir(model_dir: str,
                         tensors: dict[str, np.ndarray]) -> None:
    """Fabricate ``<model_dir>/variables/variables.{index,data-*}`` with the
    bundle keys the reference checkpoint uses (``layer<N>/<part>`` ->
    ``layer_with_weights-N/<part>/.ATTRIBUTES/VARIABLE_VALUE``,
    ``trainable<N>`` -> ``trainable_variables/N/...``)."""
    raw = {}
    for k, v in tensors.items():
        if k.startswith("trainable"):
            n = int(k[len("trainable"):])
            raw[f"trainable_variables/{n}/.ATTRIBUTES/VARIABLE_VALUE"] = v
        else:
            layer, part = k.split("/", 1)
            n = int(layer[len("layer"):])
            raw[f"layer_with_weights-{n}/{part}/.ATTRIBUTES/"
                "VARIABLE_VALUE"] = v
    vdir = os.path.join(model_dir, "variables")
    os.makedirs(vdir, exist_ok=True)
    write_bundle(os.path.join(vdir, "variables"), raw)
