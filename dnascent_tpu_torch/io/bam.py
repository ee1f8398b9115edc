"""BAM I/O: BGZF container + record codec + CIGAR coordinate maps (a copy
of ``dnascent_tpu/io/bam.py``).

Self-contained (no htslib/pysam): BGZF blocks are gzip members with a BSIZE
extra field, inflated and deflated through zlib; records are parsed and
built with struct/numpy.  Replaces the reference's htslib usage (reference:
src/htsInterface.cpp) and the modbam tag writer (reference:
src/reads.h:453-512).

``parse_cigar`` mirrors htsInterface::parseCigar exactly, including its
quirks: reverse-strand reads walk the CIGAR backwards so both coordinate
frames are in the 5'->3' *sequencing* direction, soft clips advance the
query, and insertion ops temporarily write ref-keyed entries that later ops
overwrite (map overwrite semantics preserved via in-order slice writes).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

BAM_CMATCH, BAM_CINS, BAM_CDEL, BAM_CREF_SKIP = 0, 1, 2, 3
BAM_CSOFT_CLIP, BAM_CHARD_CLIP, BAM_CPAD, BAM_CEQUAL, BAM_CDIFF = 4, 5, 6, 7, 8
_SEQ_DECODE = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
FLAG_REVERSE = 0x10
FLAG_UNMAPPED = 0x4
FLAG_SECONDARY = 0x100
FLAG_SUPPLEMENTARY = 0x800

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


# ---------------------------------------------------------------------------
# BGZF
# ---------------------------------------------------------------------------

class BGZFReader:
    """Streaming BGZF inflater."""

    def __init__(self, path: str):
        self._fh = open(path, "rb")
        self._buf = bytearray()
        self._pos = 0
        self._eof = False

    def _fill(self, need: int) -> None:
        while len(self._buf) - self._pos < need and not self._eof:
            header = self._fh.read(12)
            if len(header) < 12:
                self._eof = True
                break
            magic, _mtime, _xfl, _os, xlen = struct.unpack("<IIBBH", header)
            if magic & 0xFFFF != 0x8B1F:
                raise ValueError("not a BGZF/gzip stream")
            extra = self._fh.read(xlen)
            bsize = None
            off = 0
            while off + 4 <= len(extra):
                si1, si2, slen = extra[off], extra[off + 1], struct.unpack(
                    "<H", extra[off + 2 : off + 4])[0]
                if si1 == 66 and si2 == 67 and slen == 2:
                    bsize = struct.unpack("<H", extra[off + 4 : off + 6])[0]
                off += 4 + slen
            if bsize is None:
                raise ValueError("missing BGZF BSIZE extra field")
            cdata_len = bsize - xlen - 19
            cdata = self._fh.read(cdata_len)
            self._fh.read(8)  # CRC32 + ISIZE
            if cdata_len > 0:
                self._buf += zlib.decompress(cdata, wbits=-15)
        if self._pos > 1 << 20:
            del self._buf[: self._pos]
            self._pos = 0

    def read(self, n: int) -> bytes:
        self._fill(n)
        out = bytes(self._buf[self._pos : self._pos + n])
        self._pos += len(out)
        return out

    def close(self):
        self._fh.close()


class BGZFWriter:
    def __init__(self, path: str, level: int = 6):
        self._fh = open(path, "wb")
        self._level = level
        self._pending = bytearray()

    def write(self, data: bytes) -> None:
        self._pending += data
        while len(self._pending) >= 65280:
            self._flush_block(self._pending[:65280])
            del self._pending[:65280]

    def _flush_block(self, chunk: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(chunk)) + co.flush()
        bsize = len(cdata) + 25 + 1
        # gzip magic + flags, XLEN=6, the BC extra field holding BSIZE-1
        header = (b"\x1f\x8b\x08\x04" + b"\x00" * 4 + b"\x00\xff"
                  + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize - 1))
        self._fh.write(header + cdata
                       + struct.pack("<II", zlib.crc32(bytes(chunk)),
                                     len(chunk) & 0xFFFFFFFF))

    def close(self) -> None:
        if self._pending:
            self._flush_block(bytes(self._pending))
            self._pending.clear()
        self._fh.write(_BGZF_EOF)
        self._fh.close()


# ---------------------------------------------------------------------------
# Records
# ---------------------------------------------------------------------------

@dataclass
class BamRecord:
    raw: bytes  # record body (after the 4-byte block_size)

    def _fixed(self):
        return struct.unpack_from("<iiBBHHHiiii", self.raw, 0)

    @property
    def ref_id(self) -> int:
        return self._fixed()[0]

    @property
    def pos(self) -> int:
        return self._fixed()[1]

    @property
    def mapq(self) -> int:
        return self._fixed()[3]

    @property
    def flag(self) -> int:
        return self._fixed()[6]

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def n_cigar(self) -> int:
        return self._fixed()[5]

    @property
    def l_seq(self) -> int:
        return self._fixed()[7]

    @property
    def qname(self) -> str:
        l_qname = self._fixed()[2]
        return self.raw[32 : 32 + l_qname - 1].decode("ascii")

    def cigar(self) -> np.ndarray:
        """(n, 2) array of (op, length)."""
        l_qname = self._fixed()[2]
        off = 32 + l_qname
        n = self.n_cigar
        u = np.frombuffer(self.raw, dtype="<u4", count=n, offset=off)
        return np.stack([u & 0xF, u >> 4], axis=1).astype(np.int64)

    def seq(self) -> str:
        l_qname = self._fixed()[2]
        off = 32 + l_qname + 4 * self.n_cigar
        n = self.l_seq
        packed = np.frombuffer(self.raw, dtype=np.uint8,
                               count=(n + 1) // 2, offset=off)
        codes = np.empty(2 * packed.shape[0], dtype=np.uint8)
        codes[0::2] = packed >> 4
        codes[1::2] = packed & 0xF
        return _SEQ_DECODE[codes[:n]].tobytes().decode("ascii")

    def _aux_offset(self) -> int:
        f = self._fixed()
        l_qname, n_cigar, l_seq = f[2], f[5], f[7]
        return 32 + l_qname + 4 * n_cigar + (l_seq + 1) // 2 + l_seq

    def aux_bytes(self) -> bytes:
        return self.raw[self._aux_offset():]

    def iter_tags(self):
        """Yields (tag, type_char, value, span) over the aux region."""
        data = self.raw
        off = self._aux_offset()
        end = len(data)
        while off + 3 <= end:
            start = off
            tag = data[off : off + 2].decode("ascii")
            typ = chr(data[off + 2])
            off += 3
            if typ in "cC":
                val = struct.unpack_from("<b" if typ == "c" else "<B", data, off)[0]
                off += 1
            elif typ in "sS":
                val = struct.unpack_from("<h" if typ == "s" else "<H", data, off)[0]
                off += 2
            elif typ in "iI":
                val = struct.unpack_from("<i" if typ == "i" else "<I", data, off)[0]
                off += 4
            elif typ == "f":
                val = struct.unpack_from("<f", data, off)[0]
                off += 4
            elif typ in "ZH":
                zend = data.index(b"\x00", off)
                val = data[off:zend].decode("ascii")
                off = zend + 1
            elif typ == "B":
                sub = chr(data[off])
                cnt = struct.unpack_from("<I", data, off + 1)[0]
                size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4,
                        "f": 4}[sub]
                arr = np.frombuffer(
                    data, dtype={"c": "<i1", "C": "<u1", "s": "<i2",
                                 "S": "<u2", "i": "<i4", "I": "<u4",
                                 "f": "<f4"}[sub],
                    count=cnt, offset=off + 5)
                val = arr
                off += 5 + cnt * size
            else:
                raise ValueError(f"unknown aux type {typ!r}")
            yield tag, typ, val, (start, off)

    def get_tag(self, name: str):
        for tag, typ, val, _ in self.iter_tags():
            if tag == name:
                return val
        return None

    def with_tags_replaced(self, remove: list[str],
                           append: bytes) -> "BamRecord":
        """New record with listed tags removed and raw aux bytes appended."""
        spans = [sp for tag, _, _, sp in self.iter_tags() if tag in remove]
        raw = bytearray(self.raw[: self._aux_offset()])
        data = self.raw
        keep = bytearray()
        last = self._aux_offset()
        for s, e in spans:
            keep += data[last:s]
            last = e
        keep += data[last:]
        raw += keep + append
        return BamRecord(bytes(raw))


def encode_tag_Z(tag: str, value: str) -> bytes:
    return tag.encode() + b"Z" + value.encode() + b"\x00"


def encode_tag_array_u8(tag: str, values) -> bytes:
    arr = np.asarray(values, dtype=np.uint8)
    return (tag.encode() + b"B" + b"C" + struct.pack("<I", arr.shape[0])
            + arr.tobytes())


class BamReader:
    def __init__(self, path: str):
        self._r = BGZFReader(path)
        magic = self._r.read(4)
        if magic != b"BAM\x01":
            raise ValueError(f"{path}: not a BAM file")
        l_text = struct.unpack("<i", self._r.read(4))[0]
        self.header_text = self._r.read(l_text).decode("ascii", "replace")
        n_ref = struct.unpack("<i", self._r.read(4))[0]
        self.ref_names: list[str] = []
        self.ref_lengths: list[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._r.read(4))[0]
            self.ref_names.append(self._r.read(l_name)[:-1].decode("ascii"))
            self.ref_lengths.append(struct.unpack("<i", self._r.read(4))[0])

    def __iter__(self) -> Iterator[BamRecord]:
        while True:
            bs = self._r.read(4)
            if len(bs) < 4:
                return
            block_size = struct.unpack("<i", bs)[0]
            raw = self._r.read(block_size)
            if len(raw) < block_size:
                return
            yield BamRecord(raw)

    def close(self):
        self._r.close()


class BamWriter:
    def __init__(self, path: str, header_text: str, ref_names: list[str],
                 ref_lengths: list[int]):
        self._w = BGZFWriter(path)
        body = bytearray(b"BAM\x01")
        text = header_text.encode("ascii")
        body += struct.pack("<i", len(text)) + text
        body += struct.pack("<i", len(ref_names))
        for name, ln in zip(ref_names, ref_lengths):
            nb = name.encode("ascii") + b"\x00"
            body += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)
        self._w.write(bytes(body))

    def write_record(self, rec: BamRecord) -> None:
        self._w.write(struct.pack("<i", len(rec.raw)) + rec.raw)

    def close(self) -> None:
        self._w.close()


_SEQ_ENCODE = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def build_record(qname: str, ref_id: int, pos: int, mapq: int,
                 cigar: list[tuple[int, int]], seq: str, flag: int = 0,
                 qual: Optional[bytes] = None, aux: bytes = b"") -> BamRecord:
    """Construct a BAM record from scratch (for writers/tests).

    ``cigar`` is a list of (op, length); ``seq`` in reference-forward
    orientation as SAM stores it.
    """
    qname_b = qname.encode("ascii") + b"\x00"
    n = len(seq)
    packed = np.zeros((n + 1) // 2, dtype=np.uint8)
    codes = np.array([_SEQ_ENCODE.get(c, 15) for c in seq], dtype=np.uint8)
    hi = codes[0::2]
    lo = codes[1::2]
    packed[: hi.shape[0]] |= hi << 4
    packed[: lo.shape[0]] |= lo
    if qual is None:
        qual = b"\xff" * n  # 0xff = missing quality
    body = bytearray()
    body += struct.pack("<iiBBHHHiiii", ref_id, pos, len(qname_b),
                        mapq, 0, len(cigar), flag, n, -1, -1, 0)
    body += qname_b
    for op, ol in cigar:
        body += struct.pack("<I", (ol << 4) | op)
    body += packed.tobytes()
    body += qual
    body += aux
    return BamRecord(bytes(body))


# ---------------------------------------------------------------------------
# CIGAR coordinate maps (htsInterface.cpp:59-232)
# ---------------------------------------------------------------------------

def parse_cigar(cigar: np.ndarray, pos: int, is_reverse: bool):
    """Build (ref_to_query, query_to_ref, ref_to_del, ref_start, ref_end)
    with the reference's exact semantics.

    Arrays are dense: ref_to_query over ref offsets [0, refSpan), query_to_ref
    over query positions (soft clips included).  The reference uses std::map
    with overwrite-on-insert; in-order numpy slice writes reproduce that.
    """
    ops = cigar[::-1] if is_reverse else cigar
    ref_span = int(cigar[np.isin(cigar[:, 0],
                                 (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF,
                                  BAM_CDEL, BAM_CREF_SKIP)), 1].sum())
    q_span = int(cigar[np.isin(cigar[:, 0],
                               (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF,
                                BAM_CINS, BAM_CSOFT_CLIP)), 1].sum())
    # insertion ops write up to ol entries past the current ref position
    pad = int(cigar[np.isin(cigar[:, 0], (BAM_CINS, BAM_CSOFT_CLIP)), 1].max(
        initial=0))
    r2q = np.zeros(ref_span + pad + 1, dtype=np.int64)
    r2d = np.zeros(ref_span + pad + 1, dtype=bool)
    q2r = np.zeros(q_span, dtype=np.int64)
    rp = 0
    qp = 0
    for op, ol in ops:
        if op in (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF):
            j = np.arange(rp, rp + ol)
            r2q[j] = qp + np.arange(ol)
            q2r[qp : qp + ol] = j
            r2d[j] = False
            qp += ol
            rp += ol
        elif op in (BAM_CDEL, BAM_CREF_SKIP):
            j = np.arange(rp, rp + ol)
            r2q[j] = qp
            # query2ref[qp] gets overwritten to each j in turn; the final
            # value is the last (htsInterface.cpp:88-96 loop semantics)
            if qp < q_span:
                q2r[qp] = rp + ol - 1
            r2d[j] = True
            rp += ol
        elif op in (BAM_CSOFT_CLIP, BAM_CINS):
            j = np.arange(rp, rp + ol)
            r2q[j] = qp + np.arange(ol)
            q2r[qp : qp + ol] = j
            r2d[j] = False
            qp += ol
        # hard clip / pad: advance neither
    return (r2q[: ref_span + pad + 1], q2r, r2d[: ref_span + pad + 1],
            int(pos), int(pos) + rp)


def get_ref_span(cigar: np.ndarray, pos: int):
    """(ref_start, ref_end) as getRefEnd (htsInterface.cpp:181-232)."""
    span = int(cigar[np.isin(cigar[:, 0],
                             (BAM_CMATCH, BAM_CEQUAL, BAM_CDIFF, BAM_CDEL,
                              BAM_CREF_SKIP)), 1].sum())
    return int(pos), int(pos) + span
