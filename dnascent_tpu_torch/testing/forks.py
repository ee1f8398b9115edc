"""Synthetic forkSense inputs: detect-style call tables with painted
analogue tracks, so a fork's structure is known (a copy of
``_synthetic_read`` in ``tests/test_forksense.py``)."""

from __future__ import annotations

import numpy as np

from ..pipeline.forksense import DetectedReadData

# track layouts over a read's 8000 call positions (start, end, analogue): a
# right fork is EdU then BrdU downstream, a left fork BrdU then EdU (order
# "EdU,BrdU")
RIGHT_FORK = [(1000, 2200, "E"), (2300, 3500, "B")]
LEFT_FORK = [(4000, 5200, "B"), (5300, 6500, "E")]


def synthetic_read(seed, n=8000, spacing=2, tracks=None, read_id="r0",
                   start=10000):
    """Detect-style read: coords every `spacing` bp from `start`; tracks
    paint analogue probability regions: list of (start_idx, end_idx, kind)
    kind in {'E','B'}."""
    rng = np.random.default_rng(seed)
    coords = start + spacing * np.arange(n)
    edu = rng.uniform(0.0, 0.25, n)
    brdu = rng.uniform(0.0, 0.25, n)
    for s, e, kind in tracks or []:
        m = rng.random(e - s) < 0.6  # 60% positive call density in track
        if kind == "E":
            edu[s:e] = np.where(m, rng.uniform(0.6, 1.0, e - s), edu[s:e])
        else:
            brdu[s:e] = np.where(m, rng.uniform(0.6, 1.0, e - s), brdu[s:e])
    return DetectedReadData(read_id, "chr1", int(coords[0]),
                            int(coords[-1]) + 1, "fwd", coords, edu, brdu)


def fork_reads(n_right: int, n_left: int) -> list[DetectedReadData]:
    """``n_right`` right-fork reads (seeds 0..) then ``n_left`` left-fork
    reads (seeds from 100, or from ``n_right`` when that is larger), named
    ``rf-i`` and ``lf-i``: the golden forkSense set is ``fork_reads(12,
    12)``."""
    left0 = max(100, n_right)
    return ([synthetic_read(i, tracks=RIGHT_FORK, read_id=f"rf-{i}")
             for i in range(n_right)]
            + [synthetic_read(left0 + i, tracks=LEFT_FORK, read_id=f"lf-{i}")
               for i in range(n_left)])


def varied_fork_reads(n_right: int, n_left: int, seed: int,
                      end_fraction: float = 0.25) -> list[DetectedReadData]:
    """Fork reads of varied span: each read starts anywhere in the first
    5 Mb of chr1 and holds 6000-10000 calls (12-20 kb).  In about
    ``end_fraction`` of them the BrdU track runs to within 100 bp of the
    end the fork moves towards (the 3' end for a right fork, the 5' end for
    a left one), so seeBreaks observes run-offs; the others sit at least
    3 kb from both ends.  Named ``rf-i`` and ``lf-i`` as ``fork_reads``."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n_right + n_left):
        right = i < n_right
        n = int(rng.integers(6000, 10001))
        at_end = rng.random() < end_fraction
        if right:   # EdU then BrdU; the BrdU track ends near the 3' end
            o = (n - 2500 - int(rng.integers(0, 50)) if at_end
                 else int(rng.integers(500, n - 4000)))
            tracks = [(o, o + 1200, "E"), (o + 1300, o + 2500, "B")]
            name = f"rf-{i}"
        else:       # BrdU then EdU; the BrdU track starts near the 5' end
            o = (int(rng.integers(0, 50)) if at_end
                 else int(rng.integers(1500, n - 4000)))
            tracks = [(o, o + 1200, "B"), (o + 1300, o + 2500, "E")]
            name = f"lf-{i - n_right}"
        reads.append(synthetic_read(int(rng.integers(1 << 31)), n=n,
                                    tracks=tracks, read_id=name,
                                    start=int(rng.integers(0, 5_000_000))))
    return reads


def write_detect_file(reads, path: str) -> None:
    """The reads as a ``.detect`` file with 6-decimal probabilities (the
    columns forkSense and seeBreaks read; no k-mer column)."""
    with open(path, "w") as fh:
        fh.write("#Mode CNN\n")
        for r in reads:
            fh.write(f">{r.read_id} {r.contig} {r.ref_start} {r.ref_end} "
                     f"{r.strand}\n")
            fh.write("".join(f"{c}\t{e:.6f}\t{b:.6f}\n"
                             for c, e, b in zip(r.coords, r.edu, r.brdu)))
