"""PyTorch port, the align slice on the CPU: strict eventalign and the
eventalign text table against the JAX package, and the port's ``align`` and
``detect --strict-windows`` CLIs against ``tests/goldens/fixture.align`` and
the JAX CLI, on the golden dataset (``build_dataset(..., n_reads=4,
read_length=1500, signal_format="fast5", seed=11)``) and on simulated
reverse-strand reads."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from dnascent_tpu.config import DNA_R10
from dnascent_tpu.testing.dataset import build_dataset
from tests.test_golden_outputs import _normalize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "goldens")
# the DetectCNN's probabilities against the JAX CLI's (the spread of
# tests/test_torch_pipeline.py)
PROB_ATOL_MAX, PROB_ATOL_MEAN = 0.25, 0.03
POSITION_FIELDS = ("coord", "kmer_start", "n_signals", "core_idx",
                   "residual_idx", "center_is_T", "signal_u8_flat")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, models):
    d = tmp_path_factory.mktemp("torch_align_golden")
    return build_dataset(str(d), models, n_reads=4, read_length=1500,
                         signal_format="fast5", seed=11)


def _golden_records(dataset):
    from dnascent_tpu.io.fasta import import_reference
    from dnascent_tpu.io.index_io import parse_index
    from dnascent_tpu.pipeline.source import BamSignalSource
    recs = list(BamSignalSource(dataset.bam,
                                import_reference(dataset.reference_fa),
                                parse_index(dataset.index), min_length=100))
    assert len(recs) == 4
    return recs


def _reverse_records(models):
    from dnascent_tpu.pipeline.source import SimulatedSource
    return list(SimulatedSource(models, DNA_R10, n_reads=3, length=1800,
                                seed=41, reverse=True))


def _n_run_records(models):
    """Simulated reads whose reference carries an N run: the windows over
    it are skipped, so a later window is reached past a skipped one."""
    from dnascent_tpu.pipeline.source import SimulatedSource
    out = []
    for r in SimulatedSource(models, DNA_R10, n_reads=2, length=2400,
                             seed=5):
        s = list(r.reference_seq)
        s[1200:1210] = "N" * 10
        out.append(dataclasses.replace(r, reference_seq="".join(s)))
    return out


@pytest.fixture(scope="module")
def prepped(dataset, models):
    """{input: (JAX prepared reads, port prepared reads on the CPU)}."""
    import torch
    from dnascent_tpu.pipeline import prep as jprep
    from dnascent_tpu_torch.pipeline import prep as tprep

    torch.set_num_threads(2)
    out = {}
    for name, recs in (("golden", _golden_records(dataset)),
                       ("reverse", _reverse_records(models))):
        out[name] = (jprep.prepare_reads(recs, models, DNA_R10),
                     tprep.prepare_reads(recs, models, DNA_R10,
                                         device="cpu"))
    return out


def _assert_positions_equal(rj, rt):
    assert rj.keys() == rt.keys() and rj
    n_passed = 0
    for rid in rj:
        assert rj[rid].qc_passed == rt[rid].qc_passed, rid
        if not rj[rid].qc_passed:
            continue
        n_passed += 1
        for name in POSITION_FIELDS:
            np.testing.assert_array_equal(getattr(rj[rid].positions, name),
                                          getattr(rt[rid].positions, name),
                                          err_msg=f"{rid} {name}")
    assert n_passed


@pytest.mark.parametrize("data", ["golden", "reverse"])
def test_strict_positions_match_jax(prepped, models, data):
    """Strict run_eventalign positions equal the JAX strict positions in
    every field."""
    from dnascent_tpu.pipeline import eventalign as jea
    from dnascent_tpu_torch.pipeline import eventalign as tea
    jp, tp = prepped[data]
    _assert_positions_equal(
        jea.run_eventalign(jp, models, DNA_R10, strict=True),
        tea.run_eventalign(tp, models, DNA_R10, strict=True))


@pytest.mark.parametrize("mode", ["fast", "strict"])
@pytest.mark.parametrize("data", ["golden", "reverse"])
def test_text_matches_jax(prepped, models, data, mode):
    """The eventalign table equals the JAX package's byte for byte, and so
    do the positions beside it."""
    from dnascent_tpu.pipeline import eventalign as jea
    from dnascent_tpu_torch.pipeline import eventalign as tea
    jp, tp = prepped[data]
    strict = mode == "strict"
    rj = jea.run_eventalign(jp, models, DNA_R10, collect_text=True,
                            strict=strict)
    rt = tea.run_eventalign(tp, models, DNA_R10, collect_text=True,
                            strict=strict)
    _assert_positions_equal(rj, rt)
    for rid in rj:
        assert rj[rid].text == rt[rid].text, rid
    assert sum(r.text is not None for r in rt.values()) >= 3


@pytest.mark.parametrize("data", ["golden", "n_run"])
def test_strict_speculation_depth_is_exact(prepped, models, data):
    """The speculative wavefront commits only windows the sequential loop
    would build, so speculation depth 1 (the sequential loop) and 64 give
    identical results.  On reads whose reference carries an N run the
    wavefront must also end (the JAX package's commit rule never commits a
    window reached past a skipped one, and its wavefront does not end
    there)."""
    import torch
    from dnascent_tpu_torch.pipeline import eventalign as tea, prep as tprep
    if data == "golden":
        tp = prepped["golden"][1]
    else:
        torch.set_num_threads(2)
        tp = tprep.prepare_reads(_n_run_records(models), models, DNA_R10,
                                 device="cpu")
        assert all(p.passed for p in tp)
    seq = tea.run_eventalign(tp, models, DNA_R10, collect_text=True,
                             strict=True, spec_depth=1)
    spec = tea.run_eventalign(tp, models, DNA_R10, collect_text=True,
                              strict=True, spec_depth=64)
    _assert_positions_equal(seq, spec)
    for rid in seq:
        assert seq[rid].text == spec[rid].text
    if data == "n_run":
        for r in spec.values():
            # the N run's k-mers take no position, the rest of the read do
            assert r.qc_passed and r.positions.coord.shape[0] > 2000


def _run_port(args, timeout=300):
    env = dict(os.environ, DNASCENT_TPU_MODELS="/nonexistent",
               OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", "dnascent_tpu_torch", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-2000:]
    return res


def _ds_args(dataset, out, length):
    return ["-b", dataset.bam, "-r", dataset.reference_fa, "-i",
            dataset.index, "-o", out, "-l", str(length)]


def test_align_cli_matches_golden(dataset, tmp_path):
    """``align --device cpu`` (strict windows, align's default) equals
    fixture.align under _normalize, and writes its .align.log."""
    out = str(tmp_path / "port.align")
    _run_port(["align", *_ds_args(dataset, out, 100), "--device", "cpu"])
    with open(out) as fh, open(os.path.join(GOLDEN_DIR,
                                            "fixture.align")) as gh:
        assert _normalize(fh.read()) == gh.read()
    assert os.path.exists(str(tmp_path / "port.align.log"))


def test_align_fast_cli_matches_jax_cli(dataset, tmp_path, monkeypatch):
    """``align --fast-windows``: the port's file equals the JAX CLI's byte
    for byte (neither writes a header)."""
    from dnascent_tpu import cli as jcli
    monkeypatch.setenv("DNASCENT_TPU_MODELS", "/nonexistent")
    want = str(tmp_path / "jax.align")
    assert jcli.main(["align", *_ds_args(dataset, want, 100),
                      "--fast-windows"]) == 0
    got = str(tmp_path / "port.align")
    _run_port(["align", *_ds_args(dataset, got, 100), "--fast-windows",
               "--device", "cpu"])
    with open(got) as fa, open(want) as fb:
        text = fa.read()
        assert text == fb.read() and text.count(">") == 4


def _detect_records(path):
    heads, rows = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            if line.startswith(">"):
                heads.append(line.rstrip("\n"))
            else:
                rows.append(line.rstrip("\n").split("\t"))
    return heads, rows


def test_detect_strict_windows_cli_matches_jax_cli(dataset, tmp_path,
                                                   monkeypatch):
    """``detect --strict-windows --device cpu`` with the JAX package's
    default CNN weights against the JAX CLI's ``--strict-windows`` run with
    the same weights: headers, coordinates and k-mers exact, probabilities
    within the DetectCNN spread."""
    from dnascent_tpu import cli as jcli
    from dnascent_tpu.models import cnn as jcnn
    monkeypatch.setenv("DNASCENT_TPU_MODELS", "/nonexistent")
    weights = str(tmp_path / "jax_default.npz")
    jcnn.save_params(jcnn.default_params(), weights)
    want = str(tmp_path / "jax.detect")
    assert jcli.main(["detect", *_ds_args(dataset, want, 1000),
                      "--strict-windows", "--cnn-weights", weights]) == 0
    got = str(tmp_path / "port.detect")
    _run_port(["detect", *_ds_args(dataset, got, 1000), "--strict-windows",
               "--device", "cpu", "--cnn-weights", weights])
    (jh, jr), (ph, pr) = _detect_records(want), _detect_records(got)
    assert ph == jh and len(jh) == 4
    assert [(r[0], r[3]) for r in pr] == [(r[0], r[3]) for r in jr]
    d = np.abs(np.array([[float(x) for x in r[1:3]] for r in pr])
               - np.array([[float(x) for x in r[1:3]] for r in jr]))
    assert d.max() < PROB_ATOL_MAX and d.mean() < PROB_ATOL_MEAN, \
        (d.max(), d.mean())
