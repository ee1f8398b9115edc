"""FASTA import (reference: src/data_IO.cpp:79-112 via pfasta).

Names are truncated at the first whitespace; sequences are uppercased.  A
copy of ``dnascent_tpu/io/fasta.py``'s reader."""

from __future__ import annotations


def import_reference(path: str) -> dict[str, str]:
    ref: dict[str, str] = {}
    name = None
    parts: list[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.rstrip("\r\n")
            if not line:
                continue
            if line[0] == ">":
                if name is not None:
                    ref[name] = "".join(parts).upper()
                name = line[1:].split()[0]
                parts = []
            else:
                parts.append(line)
    if name is not None:
        ref[name] = "".join(parts).upper()
    if not ref:
        raise ValueError(f"no fasta header found in {path}")
    return ref
