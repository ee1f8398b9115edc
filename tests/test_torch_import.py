"""PyTorch port: it imports and runs without jax and without the JAX
package ``dnascent_tpu`` (its writers, dataset builder, signal QC, error
taxonomy, CPU baseline, benchmark, graft entry points and painted reads
included), and its CLI takes every flag of the JAX CLI (the multi-device
and multi-process ones included), while it ignores ``--HMM`` on align and
trainCNN, as the JAX CLI does."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

# the CLI's progress bar binds sys.stderr when its module is first
# imported: import it here, not under a test's capsys
import dnascent_tpu_torch.utils.progress  # noqa: F401

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
from dnascent_tpu_torch.pipeline import (align, detect, eventalign,
                                         forksense, hmm_detect, prep,
                                         seebreaks, traincnn, traingmm)
from dnascent_tpu_torch.io import index_io, modbam, writers
from dnascent_tpu_torch.testing import forks
from dnascent_tpu_torch.tools import bedgraph
from dnascent_tpu_torch.models import cnn, reference_cnn
from dnascent_tpu_torch.ops import banded_cuda, gru_cuda, hmm, viterbi_cuda
from dnascent_tpu_torch.parallel import collectives, compute, merge, mesh
from dnascent_tpu_torch.io import fast5_io, fasta, pod5_io, poremodel
from dnascent_tpu_torch.testing import dataset, painted
from dnascent_tpu_torch.ops import signal_qc
from dnascent_tpu_torch.utils import errors, progress, seqtools
from dnascent_tpu_torch.models import cnn_import
from dnascent_tpu_torch import config
assert config.get_config("DNA_R10.4.1") is config.DNA_R10
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
text = dict(hmm_detect.hmm_detect_reads(
    SimulatedSource(pms, DNA_R10, n_reads=1, length=1200, seed=3), pms,
    DNA_R10, device="cpu"))
assert len(text) == 1 and all(t.count("\n") > 1 for t in text.values())
rec = next(iter(SimulatedSource(pms, DNA_R10, n_reads=1, length=1200,
                                seed=4)))
rq = seqtools.kmer_ranks(rec.basecall, DNA_R10.kmer_len)
rr = seqtools.kmer_ranks(rec.reference_seq, DNA_R10.kmer_len)
assert np.isfinite(native.baseline_detect_read(
    rec.raw, rq, rr, rec.query_to_ref[: rq.shape[0]],
    pms.pore_model.astype(np.float64), DNA_R10))
assert signal_qc.trim_and_segment_raw(rec.raw)[0] >= 200
lab = painted.labels_from_tracks(1200, [("BrdU", 200, 500)])
pr = painted.painted_read(pms, painted.edu_model(pms), 1200, lab, 5, "p")
assert pr.raw.shape[0] > 1200 and pr.basecall == pr.reference_seq
import bench_torch
from dnascent_tpu_torch import graft_entry
fn, args = graft_entry.entry(device="cpu")
assert fn(*args).shape == (4, 512, 3)
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
    """Every .py of the port (graft_entry.py included), chip_smoke.py,
    bench_torch.py and the port's bench scripts."""
    out = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "bench_torch.py")]
    out += [os.path.join(ROOT, "scripts", f)
            for f in ("bench_banded_cuda.py", "bench_viterbi_gru_cuda.py",
                      "profile_backtrace_cuda.py", "bench_pod5_lookup.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def test_no_source_file_imports_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax)\b", re.M)
    for path in _port_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_no_source_file_imports_zstandard():
    """pod5's zstd stage is pyarrow's codec: the card's host has no
    ``zstandard``."""
    pat = re.compile(r"^\s*(import|from)\s+zstandard\b", re.M)
    for path in _port_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_no_source_file_imports_the_jax_package():
    pat = re.compile(r"^\s*(from|import)\s+dnascent_tpu(\.|\s|$)", re.M)
    for path in _port_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


_BASE = ["-b", "x.bam", "-r", "x.fa", "-i", "x.idx"]
_SEE_BREAKS = ["seeBreaks", "-r", "r.bed", "-a", "a.bed", "-d", "x.detect",
               "-o", "o.seeBreaks"]


# each argv the port refused as "Not ported" before the multi-device and
# multi-process flags were ported, with the input error it now reaches
# after argument handling (an exception, or exit code 1 and a message; the
# --coordinator case refuses before it contacts the coordinator), then the
# two refusals that stay: an unknown output extension and a missing
# SavedModel directory (--model is ported; its check comes before any
# input is read)
@pytest.mark.parametrize("argv, error", [
    (["detect", *_BASE, "-o", "o.bam", "--nprocs", "2"],
     "human-readable .detect output only"),
    (["trainCNN", *_BASE, "-o", "o.trainCNN", "--fit", "fit.npz",
      "--fit-label", "BrdU", "--procid", "1", "--device", "cpu"],
     "No trained CNN weights"),
    (["forkSense", "-d", "x.detect", "-o", "o.fs", "--order", "EdU,BrdU",
      "--nprocs", "2"], FileNotFoundError),
    ([*_SEE_BREAKS, "--nprocs", "2"], FileNotFoundError),
    ([*_SEE_BREAKS, "--fast", "--coordinator", "localhost:1"],
     "--coordinator needs --procid"),
    (["align", *_BASE, "-o", "o.align", "--nprocs", "2", "--device", "cpu"],
     FileNotFoundError),
    (["align", *_BASE, "-o", "o.align", "--devices", "2", "--device", "cpu"],
     FileNotFoundError),
    (["detect", *_BASE, "-o", "o.txt"], "Invalid output extension"),
    (["detect", *_BASE, "-o", "o.detect", "--device", "cpu", "--model",
      "no_such_model"], "not found"),
], ids=["detect_bam_nprocs", "traincnn_procid", "forksense_nprocs",
        "seebreaks_nprocs", "seebreaks_coordinator", "align_nprocs",
        "align_devices", "bad_extension", "missing_model"])
def test_cli_refuses_unported_features(argv, error, tmp_path, capsys,
                                       monkeypatch):
    """Nothing is left unported: the multi-device and multi-process flags
    pass argument handling on every subcommand that has them, so each argv
    that was refused as "Not ported" ends in its input error instead; the
    input refusals that remain still refuse.  Nothing is written."""
    from dnascent_tpu_torch import cli
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("RANK", raising=False)
    if isinstance(error, str):
        try:
            rc = cli.main(argv)
        except SystemExit as e:
            msg = str(e)
        else:
            assert rc == 1
            msg = capsys.readouterr().err
        assert error in msg
    else:
        with pytest.raises(error):
            cli.main(argv)
    assert "Not ported" not in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


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


def test_cli_ignores_hmm_on_align_and_traincnn(tmp_path, models,
                                               monkeypatch):
    """``align --HMM`` and ``trainCNN --HMM`` write what they write without
    the flag, byte for byte, as the JAX CLI's shared parser accepts the
    flag there and only detect reads it."""
    from dnascent_tpu.testing.dataset import build_dataset
    from dnascent_tpu_torch import cli

    ds = build_dataset(str(tmp_path / "ds"), models, n_reads=2,
                       read_length=1200, signal_format="fast5", seed=3)
    monkeypatch.setenv("DNASCENT_TPU_MODELS", "/nonexistent")
    io = ["-b", ds.bam, "-r", ds.reference_fa, "-i", ds.index, "-l", "100",
          "--device", "cpu"]
    for sub, extra in (("align", ["--fast-windows"]),
                       ("trainCNN", ["--allow-untrained-cnn"])):
        texts = []
        for flag in ([], ["--HMM"]):
            out = str(tmp_path / f"{sub}{len(flag)}.out")
            assert cli.main([sub, *io, "-o", out, *extra, *flag]) == 0
            with open(out) as fh:
                texts.append(fh.read())
        assert texts[0] and texts[0] == texts[1], sub
