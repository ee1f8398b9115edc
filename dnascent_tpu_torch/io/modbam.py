"""Modified-base BAM output/input for detect results.

Writer mirrors DNAscent::read::writeModBamTag (reference: src/reads.h:453-512):
MM fields ``N+b?`` then ``N+e?`` sharing the same query-index deltas, ML as
uint8 (p*255 truncated) with the BrdU block concatenated before the EdU
block; existing MM/ML content is preserved by prepending/concatenating.

Reader mirrors the detectedRead modbam constructor (reads.h:534-637),
including its coordinate convention (coordOnRef = refEnd - indexOnRef for
reverse reads) and the final reversal to ascending coordinates.

A copy of ``dnascent_tpu/io/modbam.py``.
"""

from __future__ import annotations

import numpy as np

from . import bam as bam_io
from ..pipeline.detect import DetectedRead
from ..pipeline.forksense import DetectedReadData


def build_modbam_tags(query_indices: np.ndarray, edu: np.ndarray,
                      brdu: np.ndarray, existing_mm: str = "",
                      existing_ml=None) -> bytes:
    """Aux bytes for the MM + ML tags (reads.h:462-511)."""
    deltas = []
    prev = 0
    for q in query_indices:
        deltas.append(int(q) - prev)
        prev = int(q) + 1
    delta_str = "".join(f",{d}" for d in deltas)
    mm_value = (existing_mm + "N+b?" + delta_str + ";" + "N+e?" + delta_str
                + ";")
    brdu_u8 = (brdu * 255.0).astype(np.uint8)   # C-style truncation
    edu_u8 = (edu * 255.0).astype(np.uint8)
    ml = list(existing_ml) if existing_ml is not None else []
    ml.extend(brdu_u8.tolist())
    ml.extend(edu_u8.tolist())
    return (bam_io.encode_tag_Z("MM", mm_value)
            + bam_io.encode_tag_array_u8("ML", ml))


class ModBamWriter:
    """Sam/modbam output strategy (detect.h:66-114 SamWriter)."""

    def __init__(self, path: str, header_text: str, ref_names, ref_lengths):
        self._w = bam_io.BamWriter(path, header_text, ref_names, ref_lengths)

    def write(self, d: DetectedRead) -> None:
        rec = d.record.bam_record
        if rec is None:
            raise ValueError("modbam output requires source BAM records")
        existing_mm = rec.get_tag("MM") or ""
        existing_ml = rec.get_tag("ML")
        aux = build_modbam_tags(d.query_indices, d.edu_prob_q, d.brdu_prob_q,
                                existing_mm,
                                existing_ml if existing_ml is not None else None)
        self._w.write_record(rec.with_tags_replaced(["MM", "ML"], aux))

    def close(self):
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def detected_read_from_bam(rec: bam_io.BamRecord,
                           ref_names: list[str]) -> DetectedReadData | None:
    """Parse a modbam record back into detect-space calls
    (detectedRead ctor, reads.h:534-637)."""
    mm = rec.get_tag("MM")
    ml = rec.get_tag("ML")
    if mm is None or ml is None:
        return None
    cigar = rec.cigar()
    r2q, q2r, r2d, ref_start, ref_end = bam_io.parse_cigar(
        cigar, rec.pos, rec.is_reverse)
    probs = np.asarray(ml, dtype=np.float64) / 255.0

    field_bounds: dict[str, tuple[int, int]] = {}
    ref_coords = []
    offset = 0
    prev_q = 0
    for fieldspec in mm.split(";"):
        if not fieldspec:
            continue
        parts = fieldspec.split(",")
        name = parts[0]
        key = {"N+b?": "BrdU", "N+e?": "EdU"}.get(name, name)
        start_off = offset
        for skip in parts[1:]:
            if key == "BrdU":
                q = prev_q + int(skip)
                if q < q2r.shape[0]:
                    ridx = int(q2r[q])
                    if rec.is_reverse:
                        coord = ref_end - ridx
                    else:
                        coord = ref_start + ridx
                    ref_coords.append(coord)
                prev_q = q + 1
            offset += 1
        field_bounds[key] = (start_off, offset)

    if "BrdU" not in field_bounds or "EdU" not in field_bounds:
        return None
    b0, b1 = field_bounds["BrdU"]
    e0, e1 = field_bounds["EdU"]
    brdu = probs[b0:b1]
    edu = probs[e0:e1]
    coords = np.asarray(ref_coords, dtype=np.int64)
    if rec.is_reverse:
        brdu = brdu[::-1]
        edu = edu[::-1]
        coords = coords[::-1]
    return DetectedReadData(
        read_id=rec.qname,
        contig=ref_names[rec.ref_id] if rec.ref_id >= 0 else "*",
        ref_start=ref_start,
        ref_end=ref_end,
        strand="rev" if rec.is_reverse else "fwd",
        coords=coords,
        edu=edu,
        brdu=brdu,
        # the dense ref->query map, for forkSense's querySpan
        ref_to_query=r2q,
    )


def iter_modbam_detected_reads(path: str):
    reader = bam_io.BamReader(path)
    for rec in reader:
        d = detected_read_from_bam(rec, reader.ref_names)
        if d is not None:
            yield d
    reader.close()
