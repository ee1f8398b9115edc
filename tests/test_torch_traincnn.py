"""PyTorch port, trainCNN's training tables on the CPU: the port's
``trainCNN`` CLI against ``tests/goldens/fixture.trainCNN``, and the calls
path of eventalign against the JAX package's on the same calls.

The golden was written with the JAX package's untrained ``PRNGKey(0)``
weights, which torch cannot regenerate: the test exports them with
``cnn.save_params`` and passes ``--cnn-weights``, as
tests/test_torch_pipeline.py does, so the two call columns carry the
DetectCNN spread (measured on this dataset: max 0.2042, mean 0.0196 over
17,593 rows x 2 columns); every other column is exact."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dnascent_tpu.config import DNA_R10
from dnascent_tpu.testing.dataset import build_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "fixture.trainCNN")
PROB_ATOL_MAX, PROB_ATOL_MEAN = 0.25, 0.03


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, models):
    d = tmp_path_factory.mktemp("torch_traincnn_golden")
    return build_dataset(str(d), models, n_reads=4, read_length=1500,
                         signal_format="fast5", seed=11)


def _table(path):
    heads, rows = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith(">"):
                heads.append(line.rstrip("\n"))
            else:
                rows.append(line.rstrip("\n").split("\t"))
    return heads, rows


def test_traincnn_cli_matches_golden(dataset, tmp_path):
    """``trainCNN --device cpu --cnn-weights <JAX default weights>``:
    headers and columns 1-5 exact, the same rows carry the two call
    columns, and the calls are within the DetectCNN spread."""
    from dnascent_tpu.models import cnn as jcnn
    weights = str(tmp_path / "jax_default.npz")
    jcnn.save_params(jcnn.default_params(), weights)
    out = str(tmp_path / "port.trainCNN")
    env = dict(os.environ, DNASCENT_TPU_MODELS="/nonexistent",
               OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "dnascent_tpu_torch", "trainCNN",
         "-b", dataset.bam, "-r", dataset.reference_fa, "-i", dataset.index,
         "-o", out, "-l", "100", "--device", "cpu", "--cnn-weights",
         weights], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    (gh, gr), (ph, pr) = _table(GOLDEN), _table(out)
    assert ph == gh and len(gh) == 4
    assert len(pr) == len(gr)
    assert [r[:5] for r in pr] == [r[:5] for r in gr]
    called = [i for i, r in enumerate(gr) if len(r) == 7]
    assert [i for i, r in enumerate(pr) if len(r) == 7] == called
    assert called and all(len(gr[i]) == 5 for i in range(len(gr))
                          if i not in set(called))
    d = np.abs(np.array([[float(x) for x in pr[i][5:]] for i in called])
               - np.array([[float(x) for x in gr[i][5:]] for i in called]))
    assert d.max() < PROB_ATOL_MAX and d.mean() < PROB_ATOL_MEAN, \
        (d.max(), d.mean())


@pytest.mark.parametrize("strict", [False, True], ids=["fast", "strict"])
def test_calls_path_matches_jax(dataset, models, strict):
    """run_eventalign with ``calls_per_read`` (seeded calls at the
    centre-T coordinates of three of the four reads, none for the fourth)
    against the JAX package's calls path: equal tables byte for byte, and
    the positions the called coordinates leave."""
    import torch
    from dnascent_tpu.io.fasta import import_reference
    from dnascent_tpu.io.index_io import parse_index
    from dnascent_tpu.pipeline import eventalign as jea, prep as jprep
    from dnascent_tpu.pipeline.source import BamSignalSource
    from dnascent_tpu_torch.pipeline import eventalign as tea, prep as tprep

    torch.set_num_threads(2)
    recs = list(BamSignalSource(dataset.bam,
                                import_reference(dataset.reference_fa),
                                parse_index(dataset.index), min_length=100))
    jp = jprep.prepare_reads(recs, models, DNA_R10)
    tp = tprep.prepare_reads(recs, models, DNA_R10, device="cpu")
    first = tea.run_eventalign(tp, models, DNA_R10, strict=strict)
    rng = np.random.default_rng(3)
    calls = {}
    for rid in list(first)[:3]:
        pos = first[rid].positions
        coords = pos.coord[pos.center_is_T]
        probs = rng.random((coords.shape[0], 2)).astype(np.float32)
        calls[rid] = {int(c): (float(e), float(b))
                      for c, (e, b) in zip(coords, probs)}
    rj = jea.run_eventalign(jp, models, DNA_R10, collect_text=True,
                            calls_per_read=calls, strict=strict)
    rt = tea.run_eventalign(tp, models, DNA_R10, collect_text=True,
                            calls_per_read=calls, strict=strict)
    assert rj.keys() == rt.keys()
    for rid in rj:
        assert rj[rid].qc_passed == rt[rid].qc_passed
        assert rj[rid].text == rt[rid].text
        a, b = rj[rid].positions, rt[rid].positions
        for name in ("coord", "kmer_start", "n_signals", "core_idx",
                     "center_is_T"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        if rid in calls:
            assert not np.isin(b.coord, list(calls[rid])).any()
            assert rt[rid].text.count("\n") > b.coord.shape[0]
