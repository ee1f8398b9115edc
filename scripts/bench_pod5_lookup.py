#!/usr/bin/env python3
"""Time the port's pod5 read fetch (``pod5_get_signal``) at 128 and at 4096
reads a file, from one or more source trees in turns on one host.

    python3 scripts/bench_pod5_lookup.py [TREE ...] [--fetches N]

Two pod5 files of seeded 2000-sample reads, one of 128 reads and one of
4096 (about what MinKNOW writes to a file), are written once with this
tree's writer into a temporary directory.  Each TREE (default: this one)
then runs in a fresh interpreter that imports that tree's
``dnascent_tpu_torch.io.pod5_io`` and, for each file, times on the host
clock the first fetch (the file's parse and whatever the tree builds once
per file), then N seeded fetches (default 128) with the parsed file
cached.  Trees run in the order given: pass parent, change, change, parent
to compare two commits.  A tree whose codec imports ``zstandard`` runs on a
host without it through a stand-in module over pyarrow's zstd codec,
installed in that tree's interpreter only (``zstd_stand_in`` in its rows),
so its decode costs what pyarrow's does and two trees differ by their
lookup.  Every tree must fetch the same samples (``checksum``).  Prints the
card's name and power limit where ``nvidia-smi`` is present, one JSON line
a tree and file, then one JSON line with every row.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = 2000
FILE_READS = (128, 4096)


# read i of an n-read file
ID_FORMAT = "{i:08x}-0000-4000-8000-{n:012x}"


WORKER = r"""
import importlib, json, sys, time, types
tree, fetches, id_format = sys.argv[1], int(sys.argv[2]), sys.argv[3]
files = json.loads(sys.argv[4])
sys.path.insert(0, tree)
try:
    importlib.import_module("zstandard")
    stand_in = False
except ImportError:
    stand_in = True
if stand_in:
    import pyarrow as pa
    class ZstdCompressor:
        def __init__(self, level=3, **_):
            self._codec = pa.Codec("zstd", compression_level=level)
        def compress(self, data):
            return self._codec.compress(data, asbytes=True)
    class ZstdDecompressor:
        def decompress(self, data, max_output_size=0):
            return pa.CompressedInputStream(pa.BufferReader(data),
                                            "zstd").read()
    mod = types.ModuleType("zstandard")
    mod.ZstdCompressor, mod.ZstdDecompressor = ZstdCompressor, ZstdDecompressor
    sys.modules["zstandard"] = mod
import numpy as np
from dnascent_tpu_torch.io import pod5_io
for path, n_reads in files:
    ids = [id_format.format(i=i, n=n_reads) for i in range(n_reads)]
    rng = np.random.default_rng(n_reads)
    picks = [ids[i] for i in rng.choice(n_reads, fetches, replace=False)]
    t0 = time.perf_counter()
    first = pod5_io.pod5_get_signal(path, ids[0])
    first_s = time.perf_counter() - t0
    times, checksum = [], float(first.sum())
    for rid in picks:
        t0 = time.perf_counter()
        sig = pod5_io.pod5_get_signal(path, rid)
        times.append(time.perf_counter() - t0)
        checksum += float(sig.sum())
    print(json.dumps(dict(tree=tree, reads_a_file=n_reads,
                          first_fetch_s=first_s, fetches=fetches,
                          fetch_s_mean=float(np.mean(times)),
                          fetch_s_median=float(np.median(times)),
                          checksum=checksum, zstd_stand_in=stand_in)))
"""


def write_files(tmp: str):
    """The two files, written with this tree's writer: [(path, reads)]."""
    import numpy as np
    from dnascent_tpu_torch.io import pod5_io
    out = []
    for n_reads in FILE_READS:
        rng = np.random.default_rng(n_reads)
        ids = [ID_FORMAT.format(i=i, n=n_reads) for i in range(n_reads)]
        path = os.path.join(tmp, f"reads{n_reads}.pod5")
        pod5_io.write_pod5(path, [(rid, rng.normal(90, 15, SAMPLES))
                                  for rid in ids])
        out.append((path, n_reads))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", default=[ROOT])
    ap.add_argument("--fetches", type=int, default=128)
    a = ap.parse_args()
    sys.path.insert(0, ROOT)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    except FileNotFoundError:
        smi = "no nvidia-smi"
    print(smi, flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        files = write_files(tmp)
        sizes = {n: os.path.getsize(p) for p, n in files}
        for tree in a.trees:
            res = subprocess.run(
                [sys.executable, "-c", WORKER, os.path.abspath(tree),
                 str(a.fetches), ID_FORMAT, json.dumps(files)],
                capture_output=True,
                text=True, timeout=1200)
            if res.returncode != 0:
                raise SystemExit(f"bench_pod5_lookup: {tree} exited "
                                 f"{res.returncode}:\n{res.stderr[-3000:]}")
            for line in res.stdout.splitlines():
                row = json.loads(line)
                row["file_bytes"] = sizes[row["reads_a_file"]]
                rows.append(row)
                print(json.dumps(row), flush=True)
    for n in FILE_READS:
        sums = {r["checksum"] for r in rows if r["reads_a_file"] == n}
        if len(sums) != 1:
            raise SystemExit(f"bench_pod5_lookup: trees fetched different "
                             f"samples from the {n}-read file: {sums}")
    print(json.dumps(dict(card=smi, samples_a_read=SAMPLES, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
