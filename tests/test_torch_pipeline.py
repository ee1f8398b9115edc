"""PyTorch port, the detect slice on the CPU: prepare_reads and fast
eventalign against the JAX modules, and the port's ``detect`` CLI against
tests/goldens/fixture.detect, on the golden dataset
(``build_dataset(..., n_reads=4, read_length=1500, signal_format="fast5",
seed=11)``, as tests/test_golden_outputs.py builds it)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dnascent_tpu.config import DNA_R10
from dnascent_tpu.testing.dataset import build_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "fixture.detect")
# EdU/BrdU probabilities against the golden: the golden was written by the
# JAX pipeline, whose jitted bf16 CNN differs from the flax model applied
# op by op (which the port matches to < 1e-2, tests/test_torch_cnn.py) and
# rounds its output to f16.  Measured on this dataset: max 0.204, mean
# 0.024 over 1465 calls x 2 columns.
PROB_ATOL_MAX, PROB_ATOL_MEAN = 0.25, 0.03


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, models):
    d = tmp_path_factory.mktemp("torch_golden")
    return build_dataset(str(d), models, n_reads=4, read_length=1500,
                         signal_format="fast5", seed=11)


@pytest.fixture(scope="module")
def records(dataset):
    from dnascent_tpu.io.fasta import import_reference
    from dnascent_tpu.io.index_io import parse_index
    from dnascent_tpu.pipeline.source import BamSignalSource

    recs = list(BamSignalSource(dataset.bam,
                                import_reference(dataset.reference_fa),
                                parse_index(dataset.index), min_length=1000))
    assert len(recs) == 4
    return recs


@pytest.fixture(scope="module")
def prepped(records, models):
    """The same records through the JAX prep and the port's prep (CPU)."""
    import torch
    from dnascent_tpu.pipeline import prep as jprep
    from dnascent_tpu_torch.pipeline import prep as tprep

    torch.set_num_threads(2)
    return (jprep.prepare_reads(records, models, DNA_R10),
            tprep.prepare_reads(records, models, DNA_R10, device="cpu"))


def _assert_prep_equal(jax_p, port_p):
    for a, b in zip(jax_p, port_p):
        assert a.record.read_id == b.record.read_id
        assert a.qc_fail_reason == b.qc_fail_reason
        np.testing.assert_array_equal(a.event_alignment, b.event_alignment)
        np.testing.assert_allclose([b.shift, b.scale, b.events_per_base],
                                   [a.shift, a.scale, a.events_per_base],
                                   rtol=1e-6)


def test_prepare_reads_matches_jax(prepped):
    """event_alignment and QC exact; shift/scale/events-per-base within
    rtol 1e-6 (equal on this dataset: the Theil-Sen median is the same
    order statistic over the same f32 arithmetic)."""
    _assert_prep_equal(*prepped)


def test_prepare_reads_fit_stdv_matches_jax(records, models, monkeypatch):
    """A pore model whose stdv varies per k-mer (the static model's means,
    stdvs 0.10 to 0.18) takes the general fill, kernel E's twin, and never
    the static one.  The JAX prep runs its XLA scan fill on the CPU; the
    same fields are held exact (measured: no rounding-tie flip moved an
    alignment on this dataset)."""
    import dataclasses
    import torch
    from dnascent_tpu.io.poremodel import synthetic_model_table
    from dnascent_tpu.pipeline import prep as jprep
    from dnascent_tpu_torch.pipeline import prep as tprep

    fit = dataclasses.replace(models, pore_model=synthetic_model_table(9, 1))
    assert tprep.static_stdv_scalars(fit.pore_model) is None

    def static_fill(*args, **kw):
        raise AssertionError("static-stdv fill used for a fit-stdv model")

    monkeypatch.setattr(tprep.banded_cuda, "banded_fill_lean", static_fill)
    torch.set_num_threads(2)
    port_p = tprep.prepare_reads(records, fit, DNA_R10, device="cpu")
    assert all(p.passed for p in port_p)
    _assert_prep_equal(jprep.prepare_reads(records, fit, DNA_R10), port_p)


def test_fast_eventalign_matches_jax(prepped, models):
    from dnascent_tpu.pipeline import eventalign as jea
    from dnascent_tpu_torch.pipeline import eventalign as tea

    jax_p, port_p = prepped
    rj = jea.run_eventalign(jax_p, models, DNA_R10)
    rt = tea.run_eventalign(port_p, models, DNA_R10)
    assert rj.keys() == rt.keys()
    for rid in rj:
        assert rj[rid].qc_passed == rt[rid].qc_passed
        a, b = rj[rid].positions, rt[rid].positions
        for name in ("coord", "kmer_start", "signal_counts", "core_idx",
                     "residual_idx", "center_is_T", "signal_u8_flat"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=f"{rid} {name}")


def _records(path):
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


def test_detect_cli_matches_golden(dataset, tmp_path):
    """``python -m dnascent_tpu_torch detect --device cpu`` with the JAX
    package's default CNN weights (exported with save_params): read
    headers, coordinates, k-mers and the set of called sites exact,
    probabilities within the tolerance measured above."""
    from dnascent_tpu.models import cnn as jcnn

    weights = str(tmp_path / "jax_default.npz")
    jcnn.save_params(jcnn.default_params(), weights)
    out = str(tmp_path / "port.detect")
    env = dict(os.environ, DNASCENT_TPU_MODELS="/nonexistent",
               OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "dnascent_tpu_torch", "detect",
         "-b", dataset.bam, "-r", dataset.reference_fa, "-i", dataset.index,
         "-o", out, "-l", "1000", "--device", "cpu", "--cnn-weights",
         weights], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    g_heads, g_rows = _records(GOLDEN)
    p_heads, p_rows = _records(out)
    assert p_heads == g_heads
    assert [(r[0], r[3]) for r in p_rows] == [(r[0], r[3]) for r in g_rows]
    d = np.abs(np.array([[float(x) for x in r[1:3]] for r in p_rows])
               - np.array([[float(x) for x in r[1:3]] for r in g_rows]))
    assert d.max() < PROB_ATOL_MAX and d.mean() < PROB_ATOL_MEAN, \
        (d.max(), d.mean())
    with open(out) as fh:
        header = [line for line in fh if line.startswith("#")]
    assert "#Mode CNN\n" in header and "#Compute CPU\n" in header
