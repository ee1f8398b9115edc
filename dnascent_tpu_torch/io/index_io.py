"""DNAscent index reader: readID -> signal file (+pod5 batch/row), one TSV
row per read, ``readID \t batch \t row \t path`` with batch=row=-1 for fast5
(reference: src/index.cpp:294-317).  The reading half of
``dnascent_tpu/io/index_io.py``, copied; the port builds no index.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class IndexEntry:
    batch: int
    row: int
    path: str


def parse_index(path: str) -> dict[str, IndexEntry]:
    """Load index.dnascent (parseIndex, data_IO.cpp:244-267)."""
    out = {}
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                continue
            cols = line.rstrip("\n").split("\t")
            read_id, batch, row, p = cols[0], int(cols[1]), int(cols[2]), cols[3]
            out[read_id] = IndexEntry(batch, row, p)
    return out
