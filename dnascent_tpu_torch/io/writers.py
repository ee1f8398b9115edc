"""Human-readable ``.detect`` and ``.align`` writers (port of
``dnascent_tpu/io/writers.py``).

``#``-prefixed header (detect.cpp:196-232), per-read ``>readID contig
refStart refEnd strand`` records and tab-separated ``coord  EdU  BrdU
kmer`` rows (EdU before BrdU, a documented reference quirk, detect.cpp:698);
reverse reads' rows are emitted in ascending-coordinate order by the same
line reversal as runCNN (detect.cpp:722).  Floats use 6 decimal places like
std::to_string.
"""

from __future__ import annotations

import datetime
from typing import Optional, TextIO

from .. import __version__
from ..pipeline.detect import DetectedRead


def detect_header(bam: str, reference: str, index: str, threads: int,
                  quality: int, length: int, compute: str = "CPU",
                  mode: str = "CNN") -> str:
    now = datetime.datetime.now().strftime("%d/%m/%Y %H:%M:%S")
    out = [f"#Alignment {bam}", f"#Genome {reference}", f"#Index {index}",
           f"#Threads {threads}", f"#Compute {compute}", f"#Mode {mode}",
           f"#MappingQuality {quality}", f"#MappingLength {length}",
           f"#SystemStartTime {now}", "#Software dnascent_tpu_torch",
           f"#Version {__version__}", "#Commit none"]
    return "\n".join(out) + "\n"


class DetectHRWriter:
    """Human-readable .detect writer (OutputWriter HR strategy,
    detect.h:21-64)."""

    def __init__(self, path: str, mode: str = "w"):
        self._fh: Optional[TextIO] = open(path, mode)

    def write_header(self, header: str) -> None:
        self._fh.write(header)

    def write(self, d: DetectedRead) -> None:
        rec = d.record
        lines = [f"{d.ref_coords[i]}\t{d.edu_prob[i]:.6f}"
                 f"\t{d.brdu_prob[i]:.6f}\t{km}"
                 for i, km in enumerate(d.kmers_ref)]
        if rec.is_reverse:
            lines.reverse()
        self._fh.write(f">{rec.read_id} {rec.contig} {rec.ref_start} "
                       f"{rec.ref_end} {rec.strand}\n")
        if lines:
            self._fh.write("\n".join(lines) + "\n")

    def write_text(self, text: str) -> None:
        """A read's block as ``hmm_detect_reads`` formats it (``--HMM``)."""
        self._fh.write(text)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class AlignHRWriter:
    """Human-readable .align writer: passthrough of per-read eventalign text
    (alignment.cpp:701-736)."""

    def __init__(self, path: str):
        self._fh = open(path, "w")

    def write_text(self, text: str) -> None:
        self._fh.write(text)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
