"""PyTorch port, the ``--HMM`` detect path on the CPU: the forward
algorithm (``ops/hmm.py``) against the JAX package's ``forward_batch_jit``,
``hmm_detect_reads`` against the JAX package's, and the port's ``detect
--HMM`` CLI against tests/goldens/fixture.hmm.detect.

Tolerances (measured on the CPU): the forward against the JAX scan within
1.5e-5 absolute on log-likelihoods of -97 to -8 (the JAX's deletion chain
is a tree of f32 log-add-exps, the port's ``torch.logcumsumexp`` a
sequential one); the printed LLR against the golden within 1.5e-5, and
against the JAX ``hmm_detect_reads`` on the same prepared reads within
1.6e-5.  Every other column is exact."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dnascent_tpu.config import DNA_R10
from dnascent_tpu.testing.dataset import build_dataset
# the CLI's progress bar binds sys.stderr when its module is first
# imported: import it here, not under a test's capsys
import dnascent_tpu_torch.utils.progress  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "fixture.hmm.detect")
FWD_ATOL = 5e-5
LLR_ATOL = 1e-4
HMM_PROBS = tuple(getattr(DNA_R10.hmm, k) for k in (
    "external_D2D", "external_D2M", "external_I2M", "external_M2D",
    "internal_M2I", "internal_I2I"))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, models):
    d = tmp_path_factory.mktemp("torch_hmm_golden")
    return build_dataset(str(d), models, n_reads=4, read_length=1500,
                         signal_format="fast5", seed=11)


def _windows(seed, W=2048, T=64, N=24):
    """Seeded windows: observations near a walk over the states' means;
    n_obs 20..T, the first eight windows with n_states < N."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(0, 1, (W, N)).astype(np.float32)
    sd = rng.uniform(0.1, 0.3, (W, N)).astype(np.float32)
    n_obs = rng.integers(20, T + 1, W).astype(np.int32)
    ns = np.full(W, N, np.int32)
    ns[:8] = rng.integers(2, N, 8)
    walk = np.minimum(np.arange(T) // 2, N - 1)
    obs = (mu[:, walk] + rng.normal(0, 0.2, (W, T))).astype(np.float32)
    obs[np.arange(T)[None, :] >= n_obs[:, None]] = 0.0
    epb = rng.uniform(1.5, 2.5, W).astype(np.float32)
    return obs, n_obs, mu, sd, ns, epb


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_batch_matches_jax(seed):
    import jax.numpy as jnp
    from dnascent_tpu.ops.hmm import forward_batch_jit
    from dnascent_tpu_torch.ops.hmm import forward_batch

    arrays = _windows(seed)
    ref = np.asarray(forward_batch_jit(*(jnp.asarray(a) for a in arrays),
                                       HMM_PROBS))
    got = forward_batch(*(torch.from_numpy(a) for a in arrays),
                        HMM_PROBS).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert (arrays[4] < 24).sum() == 8 and (arrays[1] < 64).any()
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_ATOL)


def test_forward_batch_holds_padded_steps():
    """Columns past every window's n_obs change nothing: T 64 and T 128
    (the extra columns zero) give the same values bit for bit."""
    from dnascent_tpu_torch.ops.hmm import forward_batch

    obs, *rest = _windows(2, W=512)
    wide = np.zeros((obs.shape[0], 128), np.float32)
    wide[:, :64] = obs
    a = forward_batch(torch.from_numpy(obs),
                      *(torch.from_numpy(x) for x in rest), HMM_PROBS)
    b = forward_batch(torch.from_numpy(wide),
                      *(torch.from_numpy(x) for x in rest), HMM_PROBS)
    assert torch.equal(a, b)


def _simulated(models, n_reads=4, seed=17):
    """The JAX package's packing-test reads, every second one reverse."""
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    return [dataclasses.replace(r, is_reverse=i % 2 == 1)
            for i, r in enumerate(SimulatedSource(models, DNA_R10,
                                                  n_reads=n_reads,
                                                  length=1500, seed=seed))]


def _compare_texts(jax_out, port_out, llr_atol):
    """Headers, coordinates and both k-mer columns exact; the largest LLR
    gap, asserted within ``llr_atol``."""
    assert [r for r, _ in jax_out] == [r for r, _ in port_out]
    gap, rows = 0.0, 0
    for (rid, a), (_, b) in zip(jax_out, port_out):
        la, lb = a.splitlines(), b.splitlines()
        assert len(la) == len(lb) and la[0] == lb[0], rid
        for x, y in zip(la[1:], lb[1:]):
            x, y = x.split("\t"), y.split("\t")
            assert x[0] == y[0] and x[2:] == y[2:], (rid, x, y)
            gap = max(gap, abs(float(x[1]) - float(y[1])))
            rows += 1
    assert rows and gap <= llr_atol, (rows, gap)
    return gap


def test_hmm_detect_reads_match_jax(models, monkeypatch):
    """The port's ``hmm_detect_reads`` against the JAX package's on four
    simulated reads (two reverse).  (1) On the same prepared reads (the JAX
    generator fed the port's prep): every column exact but the LLR, within
    LLR_ATOL.  (2) Each on its own prep: the port's fill follows the Pallas
    kernel's op order, the JAX package's CPU path its XLA scan, and the two
    break one tie differently in the fourth read (ROADMAP section 3), moving
    an event pair and the Theil-Sen shift by 2.8e-4; the reads whose preps
    agree are held to LLR_ATOL, the fourth's LLRs moved by 0.0167."""
    import dnascent_tpu.pipeline.hmm_detect as jhd
    from dnascent_tpu.pipeline.prep import prepare_reads as jax_prep
    from dnascent_tpu_torch.pipeline import prep as tprep
    from dnascent_tpu_torch.pipeline.hmm_detect import hmm_detect_reads

    records = _simulated(models)
    port = list(hmm_detect_reads(records, models, DNA_R10, device="cpu"))
    assert len(port) == 4 and all(t and t.count("\n") > 100
                                  for _, t in port)

    with monkeypatch.context() as m:
        m.setattr(jhd, "prepare_reads", lambda batch, models, cfg:
                  tprep.prepare_reads(batch, models, cfg, device="cpu"))
        shared = list(jhd.hmm_detect_reads(records, models, DNA_R10))
    _compare_texts(shared, port, LLR_ATOL)

    own = list(jhd.hmm_detect_reads(records, models, DNA_R10))
    jp = jax_prep(records, models, DNA_R10)
    tp = tprep.prepare_reads(records, models, DNA_R10, device="cpu")
    same = [np.array_equal(a.event_alignment, b.event_alignment)
            and a.shift == b.shift and a.scale == b.scale
            for a, b in zip(jp, tp)]
    assert same == [True, True, True, False]
    _compare_texts([o for o, s in zip(own, same) if s],
                   [o for o, s in zip(port, same) if s], LLR_ATOL)
    assert _compare_texts(own[3:], port[3:], 0.05) > LLR_ATOL


def test_poi_windows_match_jax(dataset, models):
    """The windows of each golden read (positions, event means, query
    positions) equal the JAX package's exactly; both preps agree there."""
    from dnascent_tpu.io.fasta import import_reference
    from dnascent_tpu.io.index_io import parse_index
    from dnascent_tpu.pipeline.hmm_detect import _poi_windows as jax_poi
    from dnascent_tpu.pipeline.prep import prepare_reads as jax_prep
    from dnascent_tpu.pipeline.source import BamSignalSource
    from dnascent_tpu_torch.pipeline.hmm_detect import _poi_windows
    from dnascent_tpu_torch.pipeline.prep import prepare_reads

    recs = list(BamSignalSource(dataset.bam,
                                import_reference(dataset.reference_fa),
                                parse_index(dataset.index), min_length=1000))
    n = 0
    for a, b in zip(jax_prep(recs, models, DNA_R10),
                    prepare_reads(recs, models, DNA_R10, device="cpu")):
        wa = jax_poi(a, models, DNA_R10, DNA_R10.detect.hmm_window)
        wb = _poi_windows(b, DNA_R10, DNA_R10.detect.hmm_window)
        assert len(wa) == len(wb) and wa
        for (pa, ea, qa), (pb, eb, qb) in zip(wa, wb):
            assert pa == pb and qa == qb and np.array_equal(ea, eb)
        n += len(wa)
    assert n == 1429   # the golden's rows


def test_hmm_detect_batch_packing_invariant(models, monkeypatch):
    """All windows of a read batch run as one device batch: a read's text
    does not depend on which reads share its batch (the JAX package's
    ``test_hmm_detect_batched_packing_invariant``).  One batch in flight:
    on the CPU, batches in flight only contend for the interpreter."""
    from dnascent_tpu_torch.pipeline import hmm_detect

    monkeypatch.setattr(hmm_detect, "PIPELINE_DEPTH", 1)
    records = _simulated(models)
    one = dict(hmm_detect.hmm_detect_reads(records, models, DNA_R10,
                                           device="cpu", batch_size=1))
    four = dict(hmm_detect.hmm_detect_reads(records, models, DNA_R10,
                                            device="cpu", batch_size=4))
    assert set(one) == set(four) and len(one) == 4
    for rid in one:
        assert one[rid] == four[rid]


def _hmm_cli(dataset, out, *extra):
    from dnascent_tpu_torch import cli
    return cli.main(["detect", "-b", dataset.bam, "-r", dataset.reference_fa,
                     "-i", dataset.index, "-o", out, "-l", "1000", "--HMM",
                     "--device", "cpu", *extra])


def test_cli_hmm_matches_golden(dataset, tmp_path, monkeypatch):
    """``detect --HMM --device cpu`` with no CNN weights (it loads none):
    equal to fixture.hmm.detect under ``_normalize`` in every line but the
    LLR column, which is within LLR_ATOL (its 6th decimal may flip); the
    ``.detect.log`` is written; a ``.bam`` output is refused."""
    from test_golden_outputs import _normalize

    monkeypatch.setenv("DNASCENT_TPU_MODELS", "/nonexistent")
    out = str(tmp_path / "hmm.detect")
    assert _hmm_cli(dataset, out) == 0
    with open(out) as fh:
        text = fh.read()
    assert "#Mode HMM\n" in text and "#Compute CPU\n" in text
    got = _normalize(text).splitlines()
    with open(GOLDEN) as fh:
        want = fh.read().splitlines()
    assert len(got) == len(want) == 1436
    gap = 0.0
    for x, y in zip(got, want):
        if x[:1] in "#>":
            assert x == y
            continue
        x, y = x.split("\t"), y.split("\t")
        assert x[0] == y[0] and x[2:] == y[2:], (x, y)
        gap = max(gap, abs(float(x[1]) - float(y[1])))
    assert gap <= LLR_ATOL, gap
    assert os.path.exists(str(tmp_path / "hmm.detect.log"))
    assert _hmm_cli(dataset, str(tmp_path / "hmm.bam")) == 1
    assert not os.path.exists(str(tmp_path / "hmm.bam"))


def test_cli_hmm_resume_loses_completed_reads(dataset, tmp_path,
                                              monkeypatch, capsys):
    """A reference quirk mirrored, not fixed: ``--resume --HMM`` skips the
    reads already in the output, then reopens the file for writing, as the
    JAX CLI does (``dnascent_tpu/cli.py:225``), so the completed reads are
    lost and the file holds the header alone."""
    monkeypatch.setenv("DNASCENT_TPU_MODELS", "/nonexistent")
    out = str(tmp_path / "hmm.detect")
    assert _hmm_cli(dataset, out) == 0
    with open(out) as fh:
        assert sum(line.startswith(">") for line in fh) == 4
    capsys.readouterr()
    assert _hmm_cli(dataset, out, "--resume") == 0
    assert "resume: skipping 4 completed reads" in capsys.readouterr().err
    with open(out) as fh:
        lines = fh.read().splitlines()
    assert lines and all(line.startswith("#") for line in lines)
    assert "#Mode HMM" in lines
