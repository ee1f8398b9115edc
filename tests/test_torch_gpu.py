"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
twin on the same CUDA tensors, and small detect runs (default CNN, and the
reference topology) on CUDA against the same runs on the CPU.  Marked
``gpu``; they skip without CUDA.

This file imports neither jax nor the shared conftest's fixtures, so on a
machine without jax it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.poremodel import synthetic_model_set, synthetic_model_table
from dnascent_tpu_torch.pipeline.source import SimulatedSource
from dnascent_tpu_torch.models import reference_cnn
from dnascent_tpu_torch.ops import (banded_cuda, gru_cuda, viterbi as tvit,
                                    viterbi_cuda)
from dnascent_tpu_torch.pipeline.eventalign import HMM_KEY

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def models():
    return synthetic_model_set(DNA_R10)


def _groups(models, lengths, seed=21):
    """One fill group of simulated reads of the given lengths, all passing
    quantile scaling."""
    from dnascent_tpu_torch.pipeline import prep
    recs = [next(iter(SimulatedSource(models, DNA_R10, n_reads=1, length=n,
                                      seed=seed + i)))
            for i, n in enumerate(lengths)]
    group = [p for p in prep.quantile_scaled_reads(recs, models, DNA_R10)
             if p.passed]
    assert len(group) == len(lengths)
    return group


def _fill_inputs(models, build="fill_inputs", n_reads=4, length=800):
    from dnascent_tpu_torch.pipeline import prep
    group = _groups(models, [length] * n_reads)
    return getattr(prep, build)(group, models), prep.static_stdv_scalars(
        models.pore_model)


def _fill_and_chase_match(cuda, models, lengths, general):
    """Kernel A (or E on a fit-stdv model) and kernel B on one group, each
    bitwise against its plain twin on the same CUDA tensors."""
    from dnascent_tpu_torch.pipeline import prep
    if general:
        models = dataclasses.replace(models,
                                     pore_model=synthetic_model_table(9, 1))
    group = _groups(models, lengths)
    if general:
        args = [torch.from_numpy(a).to(cuda)
                for a in prep.general_fill_inputs(group, models)]
        kernel, plain, kw = (banded_cuda.banded_fill_general,
                             banded_cuda.banded_fill_general_plain, {})
    else:
        inv_sigma, lp_const = prep.static_stdv_scalars(models.pore_model)
        args = [torch.from_numpy(a).to(cuda)
                for a in prep.fill_inputs(group, models)]
        kernel, plain = (banded_cuda.banded_fill_lean,
                         banded_cuda.banded_fill_plain)
        kw = dict(inv_sigma=inv_sigma, lp_const=lp_const)
    got = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):     # -fmad=false: bitwise equal
        assert torch.equal(g, w)
    chase = (got[0], got[1], got[2], args[-1])
    moves = banded_cuda.backtrace_moves(*chase)
    ref = banded_cuda.backtrace_moves_plain(*chase)
    torch.cuda.synchronize()
    assert torch.equal(moves, ref)


# the cases the fill's event/k-mer rings and the chase's staged chunks can
# get wrong: reads of one launch differing in length by 4x (a short read
# runs through most bands past its end, and its chase emits mostly PAD
# rows), a read with fewer k-mers than half the band (n_kmers < W/2), and
# the main path's 10 kb reads (twins take about 40 s each at that length)
_BANDED_CASES = {"lengths_4x": [600, 2400, 1200, 2400, 900, 600],
               "short_read": [40, 1500, 70],
               "main_path_10kb": [10000] * 8}


@pytest.mark.parametrize("general", [False, True], ids=["A", "E"])
@pytest.mark.parametrize("case", sorted(_BANDED_CASES))
def test_banded_cases_match_plain(cuda, models, case, general):
    _fill_and_chase_match(cuda, models, _BANDED_CASES[case], general)


def _reference_tensors(seed):
    """Seeded reference-topology weights with non-zero biases and BatchNorm
    statistics, as trained weights have."""
    return reference_cnn.seed_affine(reference_cnn.synthetic_tensors(seed),
                                     seed + 1)


def test_banded_kernels_match_plain(cuda, models):
    (scaled, mu, n_ev, n_km), (inv_sigma, lp_const) = _fill_inputs(models)
    args = [torch.from_numpy(a).to(cuda) for a in (scaled, mu, n_ev, n_km)]
    kw = dict(inv_sigma=inv_sigma, lp_const=lp_const)
    got = banded_cuda.banded_fill_lean(*args, **kw)
    want = banded_cuda.banded_fill_plain(*args, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):     # -fmad=false: bitwise equal
        assert torch.equal(g, w)
    moves = banded_cuda.backtrace_moves(got[0], got[1], got[2], args[3])
    ref = banded_cuda.backtrace_moves_plain(got[0], got[1], got[2], args[3])
    assert torch.equal(moves, ref)


def test_general_fill_matches_plain(cuda, models):
    """Kernel E on a fit-stdv pore model (stdvs 0.10 to 0.18 per k-mer):
    bitwise equal to its twin, and the chase agrees on its trace."""
    fit = dataclasses.replace(models, pore_model=synthetic_model_table(9, 1))
    arrays, static = _fill_inputs(fit, "general_fill_inputs")
    assert static is None
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    got = banded_cuda.banded_fill_general(*args)
    want = banded_cuda.banded_fill_general_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):     # -fmad=false: bitwise equal
        assert torch.equal(g, w)
    moves = banded_cuda.backtrace_moves(got[0], got[1], got[2], args[5])
    ref = banded_cuda.backtrace_moves_plain(got[0], got[1], got[2], args[5])
    assert torch.equal(moves, ref)


def test_gru_encoder_matches_plain(cuda):
    """Kernel F within the JAX contract's 2e-5 of its twin, padded tails
    included; rows made only of the code q=128 (dequantised to 0.0 by IEEE
    division) are masked at every step by both, so they stay exactly 0."""
    rng = np.random.default_rng(11)
    n, t = 8192, 20
    xq = np.clip(rng.normal(128, 30, (n, t)), 1, 255).astype(np.uint8)
    xq[np.arange(t)[None, :] >= rng.integers(0, t + 1, n)[:, None]] = 0
    xq[rng.random((n, t)) < 0.02] = 128
    xq[:64] = 128
    model = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(), _reference_tensors(7))
    w = model.gru.packed().detach().to(cuda)
    xq = torch.from_numpy(xq).to(cuda)
    got = gru_cuda.gru_encoder(xq, w)
    want = gru_cuda.gru_encoder_plain(xq, w)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-5
    assert torch.equal(got[:64], torch.zeros_like(got[:64]))
    assert torch.equal(want[:64], got[:64])


def test_viterbi_kernels_match_plain(cuda):
    rng = np.random.default_rng(9)
    W, T, N = 300, 128, 48
    n_states = rng.integers(5, 42, W).astype(np.int32)
    ranks = rng.integers(0, 4 ** 9, (N, W))
    ranks[np.arange(N)[:, None] >= n_states[None, :]] = -1
    table = np.stack([rng.normal(0, 1, 4 ** 9),
                      np.full(4 ** 9, 0.14)], 1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    mu, inv, lpc = tvit.emission_planes(t(ranks), t(table))
    obs = t(rng.normal(0, 1, (T, W)).astype(np.float32))
    n_obs = t(rng.integers(10, T, W).astype(np.int32))
    n_st = t(n_states)
    hmm = tuple(getattr(DNA_R10.hmm, k) for k in HMM_KEY)
    iM2M, eM2M, eOrIM2M, eM2MorD, logs = tvit.transition_scores(
        t(rng.uniform(1.5, 3.0, W).astype(np.float32)), hmm)
    fill_args = (obs, mu, inv, lpc, n_obs, n_st, iM2M, eM2M, eOrIM2M, logs)
    got = viterbi_cuda.viterbi_fill_codes(*fill_args)
    want = viterbi_cuda.viterbi_fill_plain(*fill_args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _, kind0 = tvit.terminate(*got[1:], n_st, eM2MorD, logs[2])
    path = viterbi_cuda.viterbi_backtrace(got[0], kind0, n_obs, n_st, T + N)
    ref = viterbi_cuda.viterbi_backtrace_plain(got[0], kind0, n_obs, n_st,
                                               T + N)
    for g, w in zip(path, ref):
        assert torch.equal(g, w)


def test_detect_cuda_matches_cpu(cuda, models):
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.pipeline.detect import detect_reads

    model = cnn.init_untrained(cnn.DetectCNN(d_model=32, dilations=(1, 2)))
    runs = []
    for dev in ("cpu", cuda):
        src = SimulatedSource(models, DNA_R10, n_reads=3, length=1200, seed=4)
        runs.append(dict(detect_reads(src, models, model.to(dev), device=dev)))
    cpu, gpu = runs
    assert cpu.keys() == gpu.keys() and cpu
    for rid in cpu:
        np.testing.assert_array_equal(cpu[rid].ref_coords, gpu[rid].ref_coords)
        # bf16 convolutions round differently in oneDNN and cuDNN
        np.testing.assert_allclose(cpu[rid].brdu_prob, gpu[rid].brdu_prob,
                                   atol=0.05)


def test_reference_detect_cuda_matches_cpu(cuda, models):
    """The reference topology (seeded weights and biases) through detect on
    CUDA (kernels A-D and F) and on the CPU: positions equal, probabilities
    within the bf16 spread of cuDNN against oneDNN."""
    from dnascent_tpu_torch.pipeline.detect import detect_reads

    model = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(), _reference_tensors(0))
    runs = []
    for dev in ("cpu", cuda):
        src = SimulatedSource(models, DNA_R10, n_reads=3, length=1200, seed=4)
        runs.append(dict(detect_reads(src, models, model.to(dev), device=dev)))
    cpu, gpu = runs
    assert cpu.keys() == gpu.keys() and cpu
    for rid in cpu:
        np.testing.assert_array_equal(cpu[rid].ref_coords, gpu[rid].ref_coords)
        np.testing.assert_allclose(cpu[rid].brdu_prob, gpu[rid].brdu_prob,
                                   atol=0.05)
