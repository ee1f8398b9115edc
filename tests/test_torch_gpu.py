"""PyTorch port on the card: each CUDA kernel against its plain PyTorch
twin on the same CUDA tensors, and small detect runs (default CNN, and the
reference topology) on CUDA against the same runs on the CPU.  Marked
``gpu``; they skip without CUDA.

This file imports neither jax nor the shared conftest's fixtures, so on a
machine without jax it runs as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import collections
import dataclasses
import threading

import numpy as np
import pytest
import torch

from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.poremodel import synthetic_model_set, synthetic_model_table
from dnascent_tpu_torch.pipeline.source import SimulatedSource
from dnascent_tpu_torch.models import reference_cnn
from dnascent_tpu_torch.ops import (banded_cuda, gru_cuda, trunk_epilogue_cuda,
                                    viterbi as tvit, viterbi_cuda)
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


@pytest.mark.parametrize("n", [1, 129, 8192])
def test_gru_encoder_matches_plain(cuda, n):
    """Kernel F within the JAX contract's 2e-5 of its twin, padded tails
    included; rows made only of the code q=128 (dequantised to 0.0 by IEEE
    division) are masked at every step by both, so they stay exactly 0;
    all-live rows; a single row, and a block's ragged tail (129 rows).  F
    ranks a block's rows by live count, so permuting the rows must permute
    the output, bit for bit."""
    rng = np.random.default_rng(11 + n)
    t = 20
    xq = np.clip(rng.normal(128, 30, (n, t)), 1, 255).astype(np.uint8)
    xq[np.arange(t)[None, :] >= rng.integers(0, t + 1, n)[:, None]] = 0
    xq[rng.random((n, t)) < 0.02] = 128
    n128, n_live = n // 8, max(1, n // 8)
    xq[:n128] = 128
    xq[n128 : n128 + n_live] = rng.choice(
        np.r_[1:128, 129:256], (n_live, t)).astype(np.uint8)
    model = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(), _reference_tensors(7))
    w = model.gru.packed().detach().to(cuda)
    xq = torch.from_numpy(xq).to(cuda)
    got = gru_cuda.gru_encoder(xq, w)
    want = gru_cuda.gru_encoder_plain(xq, w)
    perm = torch.from_numpy(rng.permutation(n)).to(cuda)
    permuted = gru_cuda.gru_encoder(xq[perm].contiguous(), w)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-5
    assert torch.equal(got[:n128], torch.zeros_like(got[:n128]))
    assert torch.equal(want[:n128], got[:n128])
    assert bool((got[n128 : n128 + n_live] != 0).any(dim=1).all())
    assert torch.equal(permuted, got[perm])


def _tie_finals(I_f, M_f, D_f, n_states, eM2MorD, eI2M):
    """Copies of the finals with ties at each window's last state: D = M +
    eM2MorD (window % 4 == 0), M + eM2MorD = I + eI2M (1), all three (2),
    as filled (3)."""
    W = I_f.shape[1]
    wi = torch.arange(W, device=I_f.device)
    last = (n_states.long() - 1).clamp(0, I_f.shape[0] - 1)
    I_f, M_f, D_f = I_f.clone(), M_f.clone(), D_f.clone()
    m = M_f[last, wi]
    m = torch.where(torch.isfinite(m), m, torch.full_like(m, -50.0))
    m_cand = m + eM2MorD
    i_eq = m_cand - eI2M
    i_eq = torch.where(i_eq + eI2M == m_cand, i_eq,
                       torch.nextafter(i_eq, torch.full_like(i_eq, 1e30)))
    case = wi % 4
    M_f[last, wi] = torch.where(case < 3, m, M_f[last, wi])
    D_f[last, wi] = torch.where(case == 1, m_cand - 1.0,
                                torch.where(case < 3, m_cand, D_f[last, wi]))
    I_f[last, wi] = torch.where(case == 0, m_cand - 1.0,
                                torch.where(case < 3, i_eq, I_f[last, wi]))
    return I_f, M_f, D_f


@pytest.mark.parametrize("W", [1, 33, 1247, 2048])
@pytest.mark.parametrize("T", [128, 1024])
@pytest.mark.parametrize("N", [48, 72])
def test_viterbi_kernels_match_plain(cuda, N, T, W):
    """Kernels C and D bitwise against their twins (every code cell and the
    finals, then path and path_len) at both state buckets, the smallest and
    the largest observation bucket, one window, ragged blocks of windows
    (33 and 1247, not multiples of 16) and the main path's 2048; the first
    windows take the edge counts (n_obs 1 and T, n_states 1 and N).  D runs
    at s_rows = T + N, at the path's 64-bucket of the true maxima, and on
    finals crafted to tie at termination."""
    rng = np.random.default_rng(9 + N + T + W)
    n_states = rng.integers(1, N + 1, W).astype(np.int32)
    n_obs = rng.integers(1, T + 1, W).astype(np.int32)
    edges = [(T, N), (1, 1), (1, N), (T, 1)][:W]
    n_obs[:len(edges)], n_states[:len(edges)] = zip(*edges)
    bucket = min(-(-(int(n_obs.max()) + int(n_states.max()) + 2) // 64) * 64,
                 T + N)
    ranks = rng.integers(0, 4 ** 9, (N, W))
    ranks[np.arange(N)[:, None] >= n_states[None, :]] = -1
    table = np.stack([rng.normal(0, 1, 4 ** 9),
                      np.full(4 ** 9, 0.14)], 1).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    mu, inv, lpc = tvit.emission_planes(t(ranks), t(table))
    obs = t(rng.normal(0, 1, (T, W)).astype(np.float32))
    n_obs = t(n_obs)
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
    ties = _tie_finals(*got[1:], n_st, eM2MorD, logs[2])
    for finals, s_rows in ((got[1:], T + N), (got[1:], bucket),
                           (ties, T + N)):
        args = (got[0], *finals, n_obs, n_st, eM2MorD, logs[2], s_rows)
        path = viterbi_cuda.viterbi_terminate_backtrace(*args)
        ref = viterbi_cuda.viterbi_terminate_backtrace_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(path, ref):
            assert torch.equal(g, w)
        assert int(path[1].min()) > 0


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


def test_seebreaks_device_bootstrap_matches_numpy(cuda):
    """seeBreaks' device bootstrap (``--fast`` on the card) against the
    numpy bootstrap in distribution: means within 5 standard errors + 1e-3,
    spreads within 15 % (its stream differs from numpy's)."""
    from dnascent_tpu_torch.pipeline import seebreaks as sb
    rng = np.random.default_rng(7)
    n_reads, n_forks, iters = 200, 150, 4000
    v5 = rng.integers(0, 100000, n_reads).astype(np.int64)
    v3 = v5 + rng.integers(40000, 90000, n_reads)
    lens = rng.integers(2000, 9000, 300).astype(np.int64)
    runoffs = rng.random(n_forks) < 0.3
    sim_np = sb.simulation_fast(v5, v3, lens, n_forks, iters, 5, 2000, 300)
    obs_np = sb.observation_fast(runoffs, iters, 5)
    sim_dv, obs_dv = sb.bootstrap_fast_device(v5, v3, lens, runoffs, iters,
                                              5, 2000, 300, cuda)
    assert sim_dv.shape == obs_dv.shape == (iters,)
    for got, want in ((sim_dv, sim_np), (obs_dv, obs_np)):
        se = want.std(ddof=1) / np.sqrt(iters)
        assert abs(got.mean() - want.mean()) < 5 * se + 1e-3
        assert abs(got.std() - want.std()) < 0.15 * max(want.std(), 1e-3)


def test_seebreaks_fast_cuda_cli(cuda, tmp_path):
    """``forkSense`` on the synthetic fork set, then ``seeBreaks --fast``
    with its default device, the card: a well-formed ``.seeBreaks`` file
    (every iteration of the six end tolerances, finite fractions)."""
    import contextlib
    import io
    import os
    import subprocess
    import sys
    from dnascent_tpu_torch import cli
    from dnascent_tpu_torch.testing.forks import fork_reads, write_detect_file

    detect = str(tmp_path / "forks.detect")
    write_detect_file(fork_reads(12, 12), detect)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "dnascent_tpu_torch", "forkSense", "-d",
         detect, "-o", str(tmp_path / "out.forkSense"), "--order",
         "EdU,BrdU", "--markForks", "--markAnalogues"], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = str(tmp_path / "out.seeBreaks")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["seeBreaks", "-r",
                         str(tmp_path / "rightForks_DNAscent_forkSense.bed"),
                         "-a", str(tmp_path / "BrdU_DNAscent_forkSense.bed"),
                         "-d", detect, "-o", out, "--fast"]) == 0
    with open(out) as fh:
        text = fh.read()
    assert "#nForks 12\n" in text
    sections = text.split(">")[1:]
    assert [s.split("\n", 1)[0] for s in sections] == [
        "ExpectedReadEndFractions:", "ObservedReadEndFractions:"]
    for s in sections:
        vals = np.array([float(v) for v in s.split("\n")[1:] if v])
        assert vals.shape == (6 * DNA_R10.seebreaks.bootstrap_iterations,)
        assert np.isfinite(vals).all() and (vals >= 0).all() \
            and (vals <= 1).all()


def _align_runs(cuda, models, n_reads, length, seed, strict):
    """The same simulated reads (the first forward, the rest reverse)
    through prep and eventalign with its text on the CPU and on CUDA."""
    from dnascent_tpu_torch.pipeline import eventalign, prep
    recs = (list(SimulatedSource(models, DNA_R10, n_reads=1, length=length,
                                 seed=seed))
            + list(SimulatedSource(models, DNA_R10, n_reads=n_reads - 1,
                                   length=length, seed=seed + 1,
                                   reverse=True)))
    runs = []
    for dev in ("cpu", cuda):
        pp = prep.prepare_reads(recs, models, DNA_R10, device=dev)
        runs.append(eventalign.run_eventalign(pp, models, DNA_R10,
                                              collect_text=True,
                                              strict=strict))
    return runs


def test_strict_eventalign_cuda_matches_cpu(cuda, models):
    """Strict eventalign on CUDA (kernels A-D, C and D once a wavefront
    round) against the CPU on two simulated reads, one reverse: every
    position field and the text equal, and C and D launched alike."""
    fill0 = viterbi_cuda.FILL_LAUNCHES.count
    bt0 = viterbi_cuda.BACKTRACE_LAUNCHES.count
    cpu, gpu = _align_runs(cuda, models, 2, 3000, 31, strict=True)
    n_fill = viterbi_cuda.FILL_LAUNCHES.count - fill0
    assert n_fill > 1 and viterbi_cuda.BACKTRACE_LAUNCHES.count - bt0 == n_fill
    assert cpu.keys() == gpu.keys() and len(cpu) == 2
    for rid in cpu:
        a, b = cpu[rid], gpu[rid]
        assert a.qc_passed and b.qc_passed
        for f in dataclasses.fields(a.positions):
            np.testing.assert_array_equal(getattr(a.positions, f.name),
                                          getattr(b.positions, f.name))
        assert a.text == b.text


def test_align_text_cuda_matches_cpu(cuda, models):
    """``align_reads`` on CUDA and on the CPU, strict and fast: the native
    formatter's tables from the card's paths equal the CPU's byte for
    byte."""
    from dnascent_tpu_torch.pipeline.align import align_reads
    recs = list(SimulatedSource(models, DNA_R10, n_reads=3, length=1500,
                                seed=33, reverse=True))
    for strict in (True, False):
        texts = [list(align_reads(iter(recs), models, DNA_R10, device=d,
                                  strict=strict)) for d in ("cpu", cuda)]
        assert texts[0] == texts[1]
        assert all(t is not None and t.count("\n") > 1000
                   for _, t in texts[1])


def test_em_prior_batch_cuda_matches_cpu(cuda):
    """trainGMM's EM on CUDA against the CPU on 256 seeded two-component
    pools of 200 to 4000 events: pi, mu and sigma within 1e-5 (f64 on both,
    so the freeze iteration does not depend on the sum order)."""
    from dnascent_tpu_torch.pipeline.traingmm import em_prior_batch
    rng = np.random.default_rng(35)
    K, M = 256, 4000
    n = rng.integers(200, M + 1, K)
    mu1 = rng.normal(0, 1, K).astype(np.float32)
    s1 = np.full(K, 0.14, np.float32)
    z = rng.random((K, M)) < rng.uniform(0.1, 0.9, K)[:, None]
    data = np.where(z, rng.normal(mu1[:, None] + rng.uniform(-0.6, 0.6, K)
                                  [:, None], 0.2, (K, M)),
                    rng.normal(mu1[:, None], 0.14, (K, M))).astype(np.float32)
    mask = np.arange(M)[None, :] < n[:, None]
    data[~mask] = 0.0
    args = [torch.from_numpy(a) for a in (data, mask, mu1, s1, mu1, 2 * s1)]
    cpu = em_prior_batch(*args, 0.5, 0.01, 100)
    gpu = em_prior_batch(*(a.to(cuda) for a in args), 0.5, 0.01, 100)
    for a, b in zip(cpu, gpu):
        assert float((a - b.cpu()).abs().max()) <= 1e-5


def test_hmm_forward_cuda_matches_cpu(cuda):
    """The ``--HMM`` forward algorithm on CUDA against the CPU on 2048
    seeded windows (n_obs 20..64, eight with n_states < 24): within 5e-5,
    the CPU tolerance against the JAX package (the CPU's logcumsumexp
    accumulates in f64, CUDA's in f32)."""
    from dnascent_tpu_torch.ops.hmm import forward_batch
    rng = np.random.default_rng(41)
    W, T, N = 2048, 64, 24
    mu = rng.normal(0, 1, (W, N)).astype(np.float32)
    sd = rng.uniform(0.1, 0.3, (W, N)).astype(np.float32)
    n_obs = rng.integers(20, T + 1, W).astype(np.int32)
    ns = np.full(W, N, np.int32)
    ns[:8] = rng.integers(2, N, 8)
    obs = (mu[:, np.minimum(np.arange(T) // 2, N - 1)]
           + rng.normal(0, 0.2, (W, T))).astype(np.float32)
    epb = rng.uniform(1.5, 2.5, W).astype(np.float32)
    args = [torch.from_numpy(a) for a in (obs, n_obs, mu, sd, ns, epb)]
    hmm = tuple(getattr(DNA_R10.hmm, k) for k in HMM_KEY)
    cpu = forward_batch(*args, hmm)
    gpu = forward_batch(*(a.to(cuda) for a in args), hmm).cpu()
    assert torch.isfinite(gpu).all()
    assert float((cpu - gpu).abs().max()) <= 5e-5


def test_hmm_detect_cuda_matches_cpu(cuda, models):
    """``hmm_detect_reads`` on CUDA and on the CPU, two simulated reads (one
    reverse): every column equal but the LLR, within 1e-4."""
    from dnascent_tpu_torch.pipeline.hmm_detect import hmm_detect_reads
    recs = [dataclasses.replace(r, is_reverse=i % 2 == 1) for i, r in
            enumerate(SimulatedSource(models, DNA_R10, n_reads=2,
                                      length=1500, seed=43))]
    cpu, gpu = (list(hmm_detect_reads(iter(recs), models, DNA_R10, device=d))
                for d in ("cpu", cuda))
    assert [r for r, _ in cpu] == [r for r, _ in gpu] and len(cpu) == 2
    for (_, a), (_, b) in zip(cpu, gpu):
        la, lb = a.splitlines(), b.splitlines()
        assert len(la) == len(lb) > 100 and la[0] == lb[0]
        for x, y in zip(la[1:], lb[1:]):
            x, y = x.split("\t"), y.split("\t")
            assert x[0] == y[0] and x[2:] == y[2:]
            assert abs(float(x[1]) - float(y[1])) <= 1e-4


@pytest.mark.parametrize("arch", ["tpu", "reference"])
def test_train_step_cuda_matches_cpu(cuda, arch):
    """One training step of each architecture from equal weights on one
    seeded batch (2 x 1024 positions, f32 windows): the loss on CUDA within
    1e-2 of the CPU's (bf16 layers: cuDNN against oneDNN), the BatchNorm
    moving statistics of the reference topology unchanged, and the GRU
    encoder left to the plain scan (float windows: kernel F not launched)."""
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.pipeline import traincnn as tc
    rng = np.random.default_rng(47)
    B, L = 2, 1024
    sig = rng.normal(0, 1, (B, L, 20)).astype(np.float32)
    sig[np.arange(20)[None, None, :] >= rng.integers(1, 21, (B, L))[
        ..., None]] = 0.0
    lab = np.where(rng.random((B, L)) < 0.3, 1, -1).astype(np.int32)
    batch = tc.TrainBatch(rng.integers(1, 1025, (B, L)).astype(np.int32),
                          rng.integers(1, 257, (B, L)).astype(np.int32),
                          sig, lab, lab >= 0)
    losses, frozen = [], []
    for dev in ("cpu", cuda):
        if arch == "tpu":
            model, opt = cnn.init_untrained(cnn.DetectCNN(), seed=5), None
        else:
            model, opt = tc.reference_arch_trainer(seed=5, device=dev)
            frozen.append([p.detach().cpu().clone() for p in
                           reference_cnn.frozen_parameters(model)])
        f0 = gru_cuda.LAUNCHES.count
        _, loss = tc.train_detect_cnn([batch], model=model, optimizer=opt,
                                      device=dev)
        assert gru_cuda.LAUNCHES.count == f0
        losses.append(loss[0])
        if arch == "reference":
            assert all(torch.equal(a, b.cpu()) for a, b in zip(
                frozen[-1], reference_cnn.frozen_parameters(model)))
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) <= 1e-2, losses


def _bits(t):
    """A tensor's bit patterns (NaN payloads and -0.0 included)."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _epilogue_operand(cuda, gen, shape, dtype):
    """A seeded conv result of ``shape`` in ``dtype`` with NaN, +-Inf and
    -0.0 at seeded places, and its (5, C) table; the table's channel 3 has
    gamma -1, beta -0.0, bias 0.25 = mean, and the result is 0.0 at its
    first positions, so -0.0 reaches the ReLU there (which on the card, as
    torch.relu there, gives +0.0)."""
    B, C, L = shape
    y = torch.randn(shape, generator=gen, device=cuda) * 2
    flat = y.view(-1)
    idx = torch.randint(0, flat.numel(), (4000,), generator=gen, device=cuda)
    for j, v in enumerate((float("nan"), float("inf"), float("-inf"), -0.0)):
        flat[idx[j::4]] = v
    y[0, 3, :8] = 0.0
    rand = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
        C, generator=gen, device=cuda)
    bias, mean, beta = rand(-0.5, 0.5), rand(-0.1, 0.1), rand(-0.1, 0.1)
    gamma, var = rand(0.5, 1.5), rand(0.5, 2.0)
    bias[3], mean[3], gamma[3], beta[3] = 0.25, 0.25, -1.0, -0.0
    inv = torch.rsqrt(var + reference_cnn._BN_EPS)
    return y.to(dtype), torch.stack([bias, mean, inv, gamma, beta])


@pytest.mark.parametrize("C", [64, 128, 256])
def test_trunk_epilogue_matches_plain(cuda, C):
    """The trunk epilogue kernel bit for bit against its twin at the main
    path's (32, C, 10,240), in each form (conv + BN + ReLU; a block's join;
    conv + bias + ReLU to f32) and conv dtype (bf16, f32), and at L =
    10,243 (the one-element loop); NaN, +-Inf and -0.0 in the conv
    results."""
    ep = trunk_epilogue_cuda
    gen = torch.Generator(device=cuda).manual_seed(C)
    for L in (10240, 10243):
        for dtype in (torch.bfloat16, torch.float32):
            (y0, t0), (y1, t1) = (
                _epilogue_operand(cuda, gen, (32, C, L), dtype)
                for _ in range(2))
            cases = {"bn": (y0, t0, None, None, None),
                     "join": (y0, t0, y1, t1, None),
                     "bias": (y0, t0[:1].contiguous(), None, None,
                              torch.float32)}
            for form, args in cases.items():
                n0 = ep.EPILOGUE_LAUNCHES.count
                got = ep.trunk_epilogue(*args)
                want = ep.trunk_epilogue_plain(*args)
                torch.cuda.synchronize()
                what = (form, dtype, L)
                assert ep.EPILOGUE_LAUNCHES.count == n0 + 1, what
                assert got.dtype == want.dtype and got.is_contiguous()
                assert torch.equal(_bits(got), _bits(want)), what
                if form != "bias":   # -0.0 reached the ReLU there
                    pre = ep._affine(y0[:1, 3:4, :8], t0[:, 3:4])
                    assert bool((_bits(pre) == -2 ** 31).all()), what
                assert bool(torch.isnan(got).any()), what
            del y0, y1, cases, got, want


class _AtenCount(collections.Counter):
    """Non-view aten ops a model's forward dispatches, those inside the
    GRU encoder left out."""

    def __init__(self, model):
        super().__init__()
        from torch.utils._python_dispatch import TorchDispatchMode
        self.skip = False
        count = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if not count.skip and not func.is_view:
                    count[func.overloadpacket.__name__] += 1
                return func(*args, **(kwargs or {}))

        self.mode = Mode()
        self.hooks = [
            model.gru.register_forward_pre_hook(
                lambda *a: setattr(self, "skip", True)),
            model.gru.register_forward_hook(
                lambda *a: setattr(self, "skip", False))]

    def run(self, fn):
        try:
            with self.mode:
                return fn()
        finally:
            for h in self.hooks:
                h.remove()


def _model_inputs(cuda, B, L, seed):
    rng = np.random.default_rng(seed)
    core = torch.from_numpy(rng.integers(1, 1025, (B, L))).to(cuda)
    res = torch.from_numpy(rng.integers(1, 257, (B, L))).to(cuda)
    sig = np.clip(rng.normal(128, 30, (B, L, 20)), 1, 255).astype(np.uint8)
    sig[np.arange(20)[None, None, :] >= rng.integers(0, 21, (B, L))[
        ..., None]] = 0
    return core, res, torch.from_numpy(sig).to(cuda)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_fused_forward_matches_module_chain_cuda(cuda, precision):
    """The reference topology's no-grad forward (cached weights, the
    epilogue kernel after each of the 69 convolutions' 34 groups) equals
    its grad-mode forward (the module chain) bit for bit at (4, 10,240),
    launches the epilogue exactly 34 times, and dispatches at most 130
    non-view aten ops outside the GRU encoder (the chain: about 530)."""
    dt = torch.float32 if precision == "f32" else torch.bfloat16
    model = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(dt), _reference_tensors(3)).to(cuda)
    inputs = _model_inputs(cuda, 4, 10240, 5)
    chain = model(*inputs).detach()
    with torch.no_grad():
        model(*inputs)                       # builds the cache
        n0 = trunk_epilogue_cuda.EPILOGUE_LAUNCHES.count
        count = _AtenCount(model)
        fused = count.run(lambda: model(*inputs))
        n1 = trunk_epilogue_cuda.EPILOGUE_LAUNCHES.count
    torch.cuda.synchronize()
    assert torch.equal(_bits(chain), _bits(fused))
    assert n1 - n0 == 34
    assert sum(count.values()) <= 130, count.most_common(12)
    assert count["convolution"] == 69, count.most_common(12)


def test_fused_forward_threads_share_one_model_cuda(cuda):
    """Four threads calling one fresh model at once on the card (the first
    calls race to build the cache) give the single-thread results bit for
    bit."""
    import sys
    tensors = _reference_tensors(4)
    inputs = [_model_inputs(cuda, 2, 4096, 20 + k) for k in range(4)]
    ref = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(), tensors).to(cuda)
    with torch.no_grad():
        want = [ref(*x) for x in inputs]
    model = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(), tensors).to(cuda)
    got, errors = [None] * 4, []
    barrier = threading.Barrier(4)

    def work(k):
        try:
            barrier.wait(timeout=60)
            with torch.no_grad():
                for _ in range(3):
                    got[k] = model(*inputs[k])
            torch.cuda.synchronize()
        except Exception as exc:   # reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads), errors
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))
