"""PyTorch port: it imports and runs without jax and without the JAX
package ``dnascent_tpu``, and its CLI refuses what is not ported rather
than ignoring it."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dnascent_tpu_torch")

BLOCKED = ("jax", "jaxlib", "flax", "optax", "dnascent_tpu")

# Run in a fresh interpreter: this test process already imported jax and
# dnascent_tpu (tests/conftest.py).  A meta-path hook refuses jax, flax,
# optax and the JAX package with every submodule, so any import of them
# fails; the port's CPU path runs (host layer, native library, kernels'
# plain twins, both CNNs, a detect run); afterwards none may sit in
# sys.modules.
_NO_JAX = r"""
import sys
BLOCKED = %r
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
import numpy as np, torch
import dnascent_tpu_torch
import dnascent_tpu_torch.cli, dnascent_tpu_torch.__main__
from dnascent_tpu_torch.pipeline import detect, eventalign, prep
from dnascent_tpu_torch.io import writers
from dnascent_tpu_torch.models import cnn, reference_cnn
from dnascent_tpu_torch.ops import banded_cuda, gru_cuda, viterbi_cuda
rng = np.random.default_rng(0)
ev = torch.from_numpy(rng.normal(0, 1, (2, 60)).astype(np.float32))
mu = torch.from_numpy(rng.normal(0, 1, (2, 40)).astype(np.float32))
n = lambda *v: torch.tensor(v, dtype=torch.int32)
tp, rp, be, bs = banded_cuda.banded_fill_lean(ev, mu, n(60, 50), n(40, 35),
                                              inv_sigma=7.0, lp_const=0.5)
mv = banded_cuda.backtrace_moves(tp, rp, be, n(40, 35))
assert mv.shape[1] == 2 and torch.isfinite(bs).all()
inv = torch.full_like(mu, 7.0)
out = banded_cuda.banded_fill_general(ev, mu, inv, torch.log(inv) - 0.92,
                                      n(60, 50), n(40, 35))
assert torch.isfinite(out[3]).all()
model = reference_cnn.params_from_tensors(
    reference_cnn.ReferenceDetectCNN(), reference_cnn.synthetic_tensors(0))
sig = torch.from_numpy(rng.integers(0, 256, (1, 32, 20)).astype(np.uint8))
idx = torch.ones((1, 32), dtype=torch.int64)
with torch.no_grad():
    probs = model(idx, idx, sig)
assert probs.shape == (1, 32, 3) and torch.isfinite(probs).all()
assert dnascent_tpu_torch.cli.main(["--version"]) == 0
from dnascent_tpu_torch import native
from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.poremodel import synthetic_model_set
from dnascent_tpu_torch.pipeline.source import SimulatedSource
assert native.available()
pms = synthetic_model_set(DNA_R10)
small = cnn.init_untrained(cnn.DetectCNN(d_model=16, dilations=(1,)))
out = dict(detect.detect_reads(SimulatedSource(pms, DNA_R10, n_reads=1,
                                               length=1200, seed=3),
                               pms, small, DNA_R10, device="cpu"))
assert len(out) == 1 and all(d.ref_coords.size for d in out.values())
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("NO_JAX_OK")
""" % (BLOCKED,)


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout


def _port_sources():
    """Every .py of the port, and chip_smoke.py."""
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def test_no_source_file_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    for path in _port_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_no_source_file_imports_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+dnascent_tpu(\.|\s|$)", re.M)
    for path in _port_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_cli_refuses_unported_features(tmp_path, capsys):
    from dnascent_tpu_torch import cli
    base = ["detect", "-b", "x.bam", "-r", "x.fa", "-i", "x.idx"]
    for extra in (["-o", str(tmp_path / "o.bam")],
                  ["-o", str(tmp_path / "o.detect"), "--HMM"],
                  ["-o", str(tmp_path / "o.detect"), "--strict-windows"],
                  ["-o", str(tmp_path / "o.detect"), "--nprocs", "2"]):
        assert cli.main(base + extra) == 1
        assert "Not ported" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())
    assert cli.main(["align"]) == 1
    assert cli.main(["detect", *base[1:], "-o", "o.txt"]) == 1
    # --model is ported: a missing SavedModel directory is an input error,
    # raised before any input is read
    with pytest.raises(SystemExit, match="not found"):
        cli.main(base + ["-o", str(tmp_path / "o.detect"), "--device", "cpu",
                         "--model", str(tmp_path / "no_such_model")])


def test_cli_detect_runs_with_untrained_weights(tmp_path, models):
    """The port's own untrained weights (seeded torch generator) on a tiny
    dataset: one record per passing read, probabilities in [0, 1]; a
    ``--resume`` rerun skips every completed read and leaves the file as
    it was."""
    from dnascent_tpu.testing.dataset import build_dataset
    ds = build_dataset(str(tmp_path / "ds"), models, n_reads=2,
                       read_length=1200, signal_format="fast5", seed=3)
    out = str(tmp_path / "u.detect")
    cmd = [sys.executable, "-m", "dnascent_tpu_torch", "detect", "-b", ds.bam,
           "-r", ds.reference_fa, "-i", ds.index, "-o", out, "-l", "1000",
           "--device", "cpu", "--allow-untrained-cnn"]
    env = dict(os.environ, DNASCENT_TPU_MODELS="/nonexistent",
               OMP_NUM_THREADS="2")
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    with open(out) as fh:
        text = fh.read()
    lines = [l for l in text.splitlines() if not l.startswith("#")]
    assert sum(l.startswith(">") for l in lines) == 2
    probs = np.array([[float(x) for x in l.split("\t")[1:3]]
                      for l in lines if not l.startswith(">")])
    assert probs.size and ((probs >= 0) & (probs <= 1)).all()

    res = subprocess.run(cmd + ["--resume"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "skipping 2 completed reads" in res.stderr
    with open(out) as fh:
        assert fh.read() == text
