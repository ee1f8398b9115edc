"""dnascent2bedgraph: convert detect / forkSense outputs to bedgraphs.

Python re-implementation of the reference utility
(reference: utils/dnascent2bedgraph.py, 440 LoC): splits detect and/or
forkSense per-read tables into one bedgraph file per read (per column for
forkSense), organised into numbered subdirectories, for genome-browser
visualisation.  A copy of ``dnascent_tpu/tools/bedgraph.py``; run as
``python -m dnascent_tpu_torch.tools.bedgraph``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional


def _iter_reads(path: str):
    """Yield (header_fields, rows) per read from a detect/forkSense file."""
    header = None
    rows: list[str] = []
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line[0] == "#":
                continue
            if line[0] == ">":
                if header is not None:
                    yield header, rows
                header = line[1:].split()
                rows = []
            else:
                rows.append(line.rstrip("\n"))
    if header is not None:
        yield header, rows


def _write_bedgraph(path: str, contig: str, entries):
    with open(path, "w") as fh:
        for start, end, value in entries:
            fh.write(f"{contig}\t{start}\t{end}\t{value}\n")


def convert_detect(detect_path: str, outdir: str, max_reads: Optional[int],
                   reads_per_dir: int = 300) -> int:
    """One bedgraph per read: column 2 = EdU prob, column 3 = BrdU prob
    (two files per read, suffixed .EdU / .BrdU)."""
    n = 0
    for header, rows in _iter_reads(detect_path):
        if max_reads is not None and n >= max_reads:
            break
        read_id, contig = header[0], header[1]
        strand = header[4] if len(header) > 4 else "fwd"
        sub = os.path.join(outdir, str(n // reads_per_dir))
        os.makedirs(sub, exist_ok=True)
        edu_entries, brdu_entries = [], []
        for row in rows:
            cols = row.split("\t")
            pos = int(cols[0])
            edu_entries.append((pos, pos + 1, cols[1]))
            brdu_entries.append((pos, pos + 1, cols[2]))
        base = os.path.join(sub, f"{read_id}.{contig}.{strand}")
        _write_bedgraph(base + ".EdU.bedgraph", contig, edu_entries)
        _write_bedgraph(base + ".BrdU.bedgraph", contig, brdu_entries)
        n += 1
    return n


def convert_forksense(fs_path: str, outdir: str, max_reads: Optional[int],
                      reads_per_dir: int = 300) -> int:
    """One bedgraph per read per forkSense column (EdU segment, BrdU
    segment)."""
    n = 0
    for header, rows in _iter_reads(fs_path):
        if max_reads is not None and n >= max_reads:
            break
        read_id, contig = header[0], header[1]
        strand = header[4] if len(header) > 4 else "fwd"
        sub = os.path.join(outdir, str(n // reads_per_dir))
        os.makedirs(sub, exist_ok=True)
        cols_by_name = {1: [], 2: []}
        for row in rows:
            cols = row.split("\t")
            pos = int(cols[0])
            for ci in (1, 2):
                if ci < len(cols):
                    cols_by_name[ci].append((pos, pos + 1, cols[ci]))
        base = os.path.join(sub, f"{read_id}.{contig}.{strand}.forkSense")
        _write_bedgraph(base + ".EdUsegment.bedgraph", contig, cols_by_name[1])
        _write_bedgraph(base + ".BrdUsegment.bedgraph", contig, cols_by_name[2])
        n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dnascent2bedgraph",
        description="convert detect/forkSense output to per-read bedgraphs")
    p.add_argument("-d", "--detect", default=None)
    p.add_argument("-f", "--forkSense", dest="forksense", default=None)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-n", "--maxReads", type=int, default=None)
    p.add_argument("--filesPerDir", type=int, default=300)
    a = p.parse_args(argv)
    if not (a.detect or a.forksense):
        p.error("at least one of --detect / --forkSense is required")
    os.makedirs(a.output, exist_ok=True)
    total = 0
    if a.detect:
        total += convert_detect(a.detect, a.output, a.maxReads, a.filesPerDir)
    if a.forksense:
        total += convert_forksense(a.forksense, a.output, a.maxReads,
                                   a.filesPerDir)
    print(f"wrote bedgraphs for {total} reads -> {a.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
