"""DNAscent index: readID -> signal file (+pod5 batch/row).

Mirrors the reference's ``index`` subcommand (reference: src/index.cpp):
recursive directory walk over fast5/pod5 files, one TSV row per read:
``readID \t batch \t row \t path`` with batch=row=-1 for fast5
(index.cpp:294-317), plus the Guppy sequencing-summary fast path
(index.cpp:96-143).  A copy of ``dnascent_tpu/io/index_io.py``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

from . import fast5_io, pod5_io


@dataclass
class IndexEntry:
    batch: int
    row: int
    path: str


def find_signal_files(root: str) -> list[str]:
    """Recursive fast5/pod5 discovery (readDirectory, index.cpp:185-229)."""
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".fast5") or f.endswith(".pod5"):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def build_index(signal_dir: str, output_path: str,
                sequencing_summary: Optional[str] = None,
                progress=None) -> int:
    """Write index.dnascent; returns the number of rows."""
    files = find_signal_files(signal_dir)
    n = 0
    with open(output_path, "w") as out:
        if sequencing_summary:
            mapping = parse_sequencing_summary(sequencing_summary)
            by_name = {os.path.basename(p): p for p in files}
            for read_id, fname in mapping.items():
                path = by_name.get(os.path.basename(fname))
                if path is None:
                    raise FileNotFoundError(
                        f"signal file for {read_id} not found: {fname}")
                out.write(f"{read_id}\t-1\t-1\t{path}\n")
                n += 1
        else:
            for p in files:
                if p.endswith(".fast5"):
                    for rid in fast5_io.fast5_extract_read_ids(p):
                        out.write(f"{rid}\t-1\t-1\t{p}\n")
                        n += 1
                else:
                    for rid, batch, row in pod5_io.pod5_extract_read_ids(p):
                        out.write(f"{rid}\t{batch}\t{row}\t{p}\n")
                        n += 1
                if progress:
                    progress(p)
    return n


def parse_sequencing_summary(path: str) -> dict[str, str]:
    """readID -> fast5 filename (parseSequencingSummary, index.cpp:96-143)."""
    out = {}
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        try:
            col_file = next(i for i, c in enumerate(header)
                            if c in ("filename", "filename_fast5"))
            col_read = header.index("read_id")
        except (StopIteration, ValueError):
            raise ValueError("failed to parse sequencing summary header")
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) > max(col_file, col_read):
                out[cols[col_read]] = cols[col_file]
    return out


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
