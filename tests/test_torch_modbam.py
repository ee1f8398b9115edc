"""PyTorch port, modbam output on the CPU: ``detect -o out.bam`` against
tests/goldens/fixture.detect.bam on the golden dataset
(``build_dataset(..., n_reads=4, read_length=1500, signal_format="fast5",
seed=11)``, as tests/test_golden_outputs.py builds it), with the JAX
package's default CNN weights exported as tests/test_torch_pipeline.py
does."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dnascent_tpu.io.bam import BamReader
from dnascent_tpu.testing.dataset import build_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "fixture.detect.bam")
# ML bytes are p x 255 truncated, so the probability tolerances of
# tests/test_torch_pipeline.py against fixture.detect (0.25 max, 0.03 mean,
# the jitted bf16 CNN's spread) carry into them as ceil(255 x 0.25) + 1 and
# 255 x 0.03 + 1.  Measured on this dataset: max 52, mean 4.98 over 2930
# bytes.
ML_ATOL_MAX, ML_ATOL_MEAN = 65, 255 * 0.03 + 1


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, models):
    d = tmp_path_factory.mktemp("torch_modbam")
    return build_dataset(str(d), models, n_reads=4, read_length=1500,
                         signal_format="fast5", seed=11)


def _tags(rec):
    return {tag: (typ, val) for tag, typ, val, _ in rec.iter_tags()}


def test_detect_modbam_matches_golden(dataset, tmp_path):
    """The port's ``.bam`` and the golden, decompressed and compared record
    by record: header, core fields, MM and every other tag exact; ML of
    equal length within the tolerances above.  A byte compare of the files
    cannot pass: the ML bytes carry the CNN's spread, and the BGZF blocks
    theirs."""
    from dnascent_tpu.models import cnn as jcnn

    weights = str(tmp_path / "jax_default.npz")
    jcnn.save_params(jcnn.default_params(), weights)
    out = str(tmp_path / "port.bam")
    env = dict(os.environ, DNASCENT_TPU_MODELS="/nonexistent",
               OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "dnascent_tpu_torch", "detect",
         "-b", dataset.bam, "-r", dataset.reference_fa, "-i", dataset.index,
         "-o", out, "-l", "1000", "--device", "cpu", "--cnn-weights",
         weights], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got, want = BamReader(out), BamReader(GOLDEN)
    assert (got.header_text, got.ref_names, got.ref_lengths) == \
        (want.header_text, want.ref_names, want.ref_lengths)
    g_recs, w_recs = list(got), list(want)
    got.close()
    want.close()
    assert len(g_recs) == len(w_recs) == 4
    diffs = []
    for g, w in zip(g_recs, w_recs):
        core = lambda r: r.raw[: r._aux_offset()]
        assert core(g) == core(w), w.qname
        gt, wt = _tags(g), _tags(w)
        assert gt.keys() == wt.keys() and "ML" in wt and "MM" in wt
        for tag in wt:
            if tag != "ML":
                assert gt[tag] == wt[tag], (w.qname, tag)
        g_ml, w_ml = gt["ML"][1], wt["ML"][1]
        assert g_ml.shape == w_ml.shape and w_ml.size, w.qname
        diffs.append(np.abs(g_ml.astype(int) - w_ml.astype(int)))
    d = np.concatenate(diffs)
    assert d.max() <= ML_ATOL_MAX and d.mean() <= ML_ATOL_MEAN, \
        (d.max(), d.mean(), d.size)
