"""PyTorch port, trainGMM on the CPU: ``train_gmm`` against the JAX
package's on seeded pools, the ``trainGMM`` CLI against the JAX CLI on a
synthetic ``.align`` file, and the align then trainGMM chain against
``tests/goldens/fixture.trainGMM.model``.

The port's EM runs in f64 (the reference's precision), the JAX package's in
f32.  A k-mer freezes once its log-likelihood gain drops to the tolerance
(0.01); where that gain sits within f32 rounding of the tolerance the two
stop one iteration apart, so such a fit is held to the JAX's fit one
iteration later or earlier on the port's own EM trajectory (measured: 1 of
the 4 pools below, 23 of 300 seeded mixtures)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dnascent_tpu.config import DNA_R10
from tests.test_golden_outputs import _normalize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIT_TOL = 1e-5
FIT_FIELDS = ("pi1", "pi2", "mu2", "sigma2")


def _test_pools(models):
    """The pools of tests/test_seebreaks_traingmm.py (seeds 5 and 6): three
    50/50 two-component mixtures and one single Gaussian."""
    rng = np.random.default_rng(5)
    pools = {}
    for idx in [7, 123, 99999]:
        mu1 = models.pore_model[idx, 0]
        s1 = models.pore_model[idx, 1]
        n = 2000
        z = rng.random(n) < 0.5
        pools[idx] = np.where(z, rng.normal(mu1 + 0.45, 0.12, n),
                              rng.normal(mu1, s1, n))
    rng = np.random.default_rng(6)
    pools[11] = rng.normal(models.pore_model[11, 0] + 0.3, 0.15, 1000)
    return pools


def _fit_array(fits):
    return np.array([[getattr(f, k) for k in FIT_FIELDS] for f in fits])


def _em_runner(pools, fits, models, rows):
    """run(tolerance, max_iter) -> the port's EM fits (len(rows), 4) of the
    k-mers ``rows`` of ``fits``, on their DBSCAN-filtered pools."""
    import torch
    from dnascent_tpu_torch.pipeline import traingmm as tg
    p = DNA_R10.traingmm
    filt = []
    for i in rows:
        ev = pools[fits[i].kmer_index]
        keep = tg.dbscan_filter_1d(
            ev, p.dbscan_epsilon, int(p.dbscan_min_points_fraction
                                      * ev.shape[0]))
        filt.append(ev[keep])
    M = max(f.shape[0] for f in filt)
    data = np.zeros((len(rows), M), np.float32)
    mask = np.zeros((len(rows), M), bool)
    for j, f in enumerate(filt):
        data[j, : f.shape[0]] = f
        mask[j, : f.shape[0]] = True
    kmers = np.array([fits[i].kmer_index for i in rows])
    mu1 = models.pore_model[kmers, 0]
    s1 = models.pore_model[kmers, 1]
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in
            (data, mask, mu1, s1, mu1, (p.prior_stdv_multiplier * s1)
             .astype(np.float32))]

    def run(tolerance, max_iter):
        fit = tg.em_prior_batch(*args, p.default_pi, tolerance, max_iter)
        return np.stack([t.numpy() for t in fit], 1)
    return run


def _assert_fits_match(pools, models):
    from dnascent_tpu.pipeline import traingmm as jg
    from dnascent_tpu_torch.pipeline import traingmm as tg
    want = jg.train_gmm(pools, models, DNA_R10)
    got = tg.train_gmm(pools, models, DNA_R10, device="cpu")
    assert len(got) == len(want) == len(pools)
    assert [(f.kmer_index, f.n_imported, f.n_filtered) for f in got] == \
        [(f.kmer_index, f.n_imported, f.n_filtered) for f in want]
    for f in got:
        assert f.mu1 == f.ont_mean and f.sigma1 == f.ont_stdv
    a, b = _fit_array(want), _fit_array(got)
    edge = np.flatnonzero(np.abs(a - b).max(axis=1) > FIT_TOL)
    if edge.shape[0]:
        run = _em_runner(pools, got, models, edge)
        tol, n_iter = DNA_R10.traingmm.em_tolerance, \
            DNA_R10.traingmm.em_max_iterations
        assert np.abs(run(tol, n_iter) - b[edge]).max() <= 1e-6
        # the iteration each edge k-mer stopped at: the fewest iterations
        # whose fit is its final one (fits at max_iter m move until then)
        lo, hi = np.zeros(edge.shape[0], int), np.full(edge.shape[0], n_iter)
        while (lo < hi).any():
            mid = (lo + hi) // 2
            for m in np.unique(mid[lo < hi]):
                sel = (lo < hi) & (mid == m)
                done = np.abs(run(tol, int(m)) - b[edge]).max(axis=1) <= 1e-6
                hi[sel & done] = m
                lo[sel & ~done] = m + 1
        # the JAX's fit is the never-frozen trajectory one iteration either
        # side of that stop
        explained = np.zeros(edge.shape[0], bool)
        for m in np.unique(np.concatenate([lo - 1, lo + 1])):
            near = np.abs(run(-np.inf, int(m)) - a[edge]).max(axis=1)
            explained |= (np.abs(lo - m) == 1) & (near <= FIT_TOL)
        assert explained.all(), [got[i].kmer_index
                                 for i in edge[~explained]]
    return edge.shape[0]


def test_train_gmm_matches_jax(models):
    """The pools of tests/test_seebreaks_traingmm.py: k-mers and event
    counts exact; pi, mu and sigma within 1e-5, or the JAX's stop one EM
    iteration from the port's (pool 11, whose gain at iteration 31 is 0.0098
    on the JAX's trajectory and 0.0100 on the port's)."""
    assert _assert_fits_match(_test_pools(models), models) <= 1


def test_train_gmm_matches_jax_on_mixtures(models):
    """40 seeded mixtures of varied weight, offset, spread and pool size
    (200 to 3000 events): the same contract."""
    rng = np.random.default_rng(8)
    pools = {}
    for idx in rng.choice(4 ** 9, 40, replace=False):
        n = int(rng.integers(200, 3000))
        mu1 = models.pore_model[idx, 0]
        z = rng.random(n) < rng.uniform(0.1, 0.9)
        pools[int(idx)] = np.where(
            z, rng.normal(mu1 + rng.uniform(-0.6, 0.6),
                          rng.uniform(0.08, 0.3), n),
            rng.normal(mu1, 0.14, n))
    assert _assert_fits_match(pools, models) <= 6


def test_gmm_table_roundtrip(models, tmp_path):
    """write_gmm_table then the port's import_traingmm_model: the second
    component's mean and stdv per k-mer, as the JAX package's round trip."""
    from dnascent_tpu_torch.io.poremodel import import_traingmm_model
    from dnascent_tpu_torch.pipeline import traingmm as tg
    fits = tg.train_gmm(_test_pools(models), models, DNA_R10, device="cpu")
    path = str(tmp_path / "fit.model")
    tg.write_gmm_table(fits, path)
    table = import_traingmm_model(path, 9)
    for f in fits:
        assert abs(table[f.kmer_index, 0] - f.mu2) < 1e-5
        assert abs(table[f.kmer_index, 1] - f.sigma2) < 1e-5


def _synthetic_align(path, models, n_rows=2000):
    """A ``.align`` file of three k-mers x ``n_rows`` rows, each k-mer's
    scaled samples a seeded two-component mixture around its model mean,
    over two reads, with an insertion row (N^k, skipped by the parser)."""
    from dnascent_tpu.utils.seqtools import index2kmer
    rng = np.random.default_rng(12)
    with open(path, "w") as fh:
        for read in range(2):
            fh.write(f">read{read} chrS 0 100 fwd\n")
            for idx in (5, 4000, 123456):
                km = index2kmer(idx, 9)
                mu1 = models.pore_model[idx, 0]
                n = n_rows // 2
                z = rng.random(n) < 0.4
                vals = np.where(z, rng.normal(mu1 + 0.4, 0.15, n),
                                rng.normal(mu1, 0.14, n))
                for v in vals:
                    fh.write(f"10\t{km}\t{v:.6f}\t{km}\t{mu1:.6f}\n")
            fh.write(f"11\t{index2kmer(5, 9)}\t0.1\t{'N' * 9}\t0\n")


@pytest.mark.parametrize("max_events", [10000, 700])
def test_traingmm_cli_matches_jax_cli(models, tmp_path, monkeypatch,
                                      max_events):
    """``trainGMM -d <.align>`` on three k-mers x 2000 rows (and capped at
    700 events a k-mer): the port's table equals the JAX CLI's, k-mers and
    counts exact, fits within 1e-5 (none of these sits at the freeze
    edge)."""
    from dnascent_tpu import cli as jcli
    monkeypatch.setenv("DNASCENT_TPU_MODELS", "/nonexistent")
    align = str(tmp_path / "synthetic.align")
    _synthetic_align(align, models)
    outs = []
    for name in ("jax", "port"):
        out = str(tmp_path / f"{name}.model")
        args = ["trainGMM", "-d", align, "-o", out, "-e", str(max_events)]
        if name == "jax":
            assert jcli.main(args) == 0
        else:
            env = dict(os.environ, DNASCENT_TPU_MODELS="/nonexistent",
                       OMP_NUM_THREADS="2")
            res = subprocess.run(
                [sys.executable, "-m", "dnascent_tpu_torch", *args,
                 "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=300)
            assert res.returncode == 0, res.stderr[-2000:]
        with open(out) as fh:
            outs.append([line.rstrip("\n").split("\t") for line in fh])
    jax_rows, port_rows = outs
    assert len(port_rows) == len(jax_rows) == 4
    assert port_rows[0] == jax_rows[0]
    for a, b in zip(jax_rows[1:], port_rows[1:]):
        assert a[:3] == b[:3] and a[9:] == b[9:]
        assert int(b[9]) == min(2000, max_events)
        np.testing.assert_allclose([float(x) for x in b[3:9]],
                                   [float(x) for x in a[3:9]], atol=1.5e-6)


def test_align_then_traingmm_matches_golden(tmp_path):
    """The port's ``align`` then ``trainGMM`` on the golden dataset equals
    fixture.trainGMM.model.  That golden holds only its header: no k-mer of
    the four 1.5 kb reads reaches 200 events, so the chain tests the align
    table's parser and the writer, not the EM (the tests above do)."""
    from dnascent_tpu.io.poremodel import synthetic_model_set
    from dnascent_tpu.testing.dataset import build_dataset
    ds = build_dataset(str(tmp_path / "ds"), synthetic_model_set(DNA_R10),
                       n_reads=4, read_length=1500, signal_format="fast5",
                       seed=11)
    env = dict(os.environ, DNASCENT_TPU_MODELS="/nonexistent",
               OMP_NUM_THREADS="2")
    align = str(tmp_path / "gmm.align")
    model = str(tmp_path / "fit.model")
    for args in (["align", "-b", ds.bam, "-r", ds.reference_fa, "-i",
                  ds.index, "-o", align, "-l", "100"],
                 ["trainGMM", "-d", align, "-o", model, "-e", "10000"]):
        res = subprocess.run(
            [sys.executable, "-m", "dnascent_tpu_torch", *args, "--device",
             "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
    with open(model) as fh, open(os.path.join(
            ROOT, "tests", "goldens", "fixture.trainGMM.model")) as gh:
        assert _normalize(fh.read()) == gh.read()
