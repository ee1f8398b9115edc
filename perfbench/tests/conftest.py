"""Shared set-up of the benchmark's own tests: the repository root on the
path, and a copy of the benchmark's registry with the cells cut to a size
the CPU runs in seconds (same configurations, short reads, tiny pools)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "memory": dict(pool=3, lengths=dict(kind="fixed", bp=2000), batch=2,
                   pipeline_depth=1, warm_batches=1, check_reads=2,
                   noise_every=3, noise_at=1),
    "pod5": dict(pool=4, lengths=dict(kind="lognormal", median_bp=2200,
                                      sigma=0.3, min_bp=1500, max_bp=3000,
                                      length_seed=7),
                 batch=2, pipeline_depth=1, warm_batches=1, check_reads=2,
                 contig_bp=40000, paint=dict(min_bp=2000,
                                             patterns={"right": 1})),
}


def make_tiny_root(dest: str) -> str:
    """A registry under ``dest``: BENCHMARK.json and perfbench's configs,
    traffic and metrics, each traffic mix cut to TINY's size."""
    os.makedirs(os.path.join(dest, "perfbench"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(ROOT, "perfbench", d),
                        os.path.join(dest, "perfbench", d))
    tdir = os.path.join(dest, "perfbench", "traffic")
    for name in os.listdir(tdir):
        path = os.path.join(tdir, name)
        with open(path) as fh:
            t = json.load(fh)
        t.update(TINY[t["source"]])
        with open(path, "w") as fh:
            json.dump(t, fh)
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda:0"
