"""PyTorch port, kernels C (Viterbi fill) and D (Viterbi backtrace): the
plain twins, which the wrappers run for CPU tensors, held to the JAX
contract (tests/test_viterbi_pallas.py): scores within rtol 1e-6, path
lengths equal, PAD-filtered paths equal — against the XLA scan and the
Pallas kernels in interpret mode, on the same seeded inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dnascent_tpu.config import DNA_R10
from dnascent_tpu_torch.ops import viterbi as tvit, viterbi_cuda
from dnascent_tpu_torch.pipeline.eventalign import HMM_KEY

HMM = tuple(getattr(DNA_R10.hmm, k) for k in HMM_KEY)


@pytest.fixture(scope="module")
def windows():
    """Seeded windows: (W, T) observations, (W, N) coefficient planes with
    -inf lp_const past each window's states, per-window epb."""
    torch.set_num_threads(2)
    rng = np.random.default_rng(3)
    W, T, N = 96, 64, 48
    obs = rng.normal(90, 12, (W, T)).astype(np.float32)
    n_obs = rng.integers(10, T, W).astype(np.int32)
    n_states = rng.integers(5, 42, W).astype(np.int32)
    table = np.stack([rng.normal(90, 10, 4 ** 9),
                      rng.uniform(1, 3, 4 ** 9)], 1).astype(np.float32)
    ranks = rng.integers(0, 4 ** 9, (W, N))
    ranks[np.arange(N)[None, :] >= n_states[:, None]] = -1
    mu = table[np.maximum(ranks, 0), 0]
    sigma = np.maximum(table[np.maximum(ranks, 0), 1], 1e-6)
    inv = (1.0 / sigma).astype(np.float32)
    lpc = (np.float32(np.log(0.3989422804014327)) - np.log(sigma)).astype(
        np.float32)
    lpc[ranks < 0] = -np.inf
    epb = rng.uniform(1.5, 3.0, W).astype(np.float32)
    return obs, n_obs, mu, inv, lpc, n_states, epb


def _port(obs, n_obs, mu, inv, lpc, n_states, epb):
    T = obs.shape[1]
    N = mu.shape[1]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    iM2M, eM2M, eOrIM2M, eM2MorD, logs = tvit.transition_scores(t(epb), HMM)
    codes, I_f, M_f, D_f = viterbi_cuda.viterbi_fill_codes(
        t(obs.T), t(mu.T), t(inv.T), t(lpc.T), t(n_obs), t(n_states), iM2M,
        eM2M, eOrIM2M, logs)
    score, kind0 = tvit.terminate(I_f, M_f, D_f, t(n_states), eM2MorD,
                                  logs[2])
    path, plen = viterbi_cuda.viterbi_backtrace(codes, kind0, t(n_obs),
                                                t(n_states), T + N)
    return codes.numpy(), score.numpy(), path.numpy(), plen.numpy()


def _check(port, pc, pl, sc):
    _, score, path, plen = port
    pc = np.asarray(pc)
    np.testing.assert_allclose(score, np.asarray(sc), rtol=1e-6)
    np.testing.assert_array_equal(plen, np.asarray(pl))
    for w in range(pc.shape[0]):
        np.testing.assert_array_equal(path[w][(path[w] & 3) != 3],
                                      pc[w][(pc[w] & 3) != 3])


def test_fill_and_backtrace_match_xla_scan(windows):
    from dnascent_tpu.ops import viterbi as jvit
    obs, n_obs, mu, inv, lpc, n_states, epb = windows
    pc, pl, sc = jvit.viterbi_fill_backtrace(
        *(jnp.asarray(x) for x in (obs, n_obs, mu, inv, lpc, n_states, epb)),
        HMM, use_pallas=False)
    _check(_port(*windows), pc, pl, sc)


def test_fill_and_backtrace_match_pallas_interpret(windows, monkeypatch):
    """The Pallas path (fill + countdown backtrace) in interpret mode; the
    fill codes are also compared cell for cell."""
    from jax.experimental.pallas import tpu as pltpu
    import dnascent_tpu.ops.viterbi_pallas as vp
    from dnascent_tpu.ops import viterbi as jvit

    monkeypatch.setattr(vp, "WBLK", 128)
    obs, n_obs, mu, inv, lpc, n_states, epb = windows
    args = [jnp.asarray(x) for x in (obs, n_obs, mu, inv, lpc, n_states, epb)]
    port = _port(*windows)
    with pltpu.force_tpu_interpret_mode():
        pc, pl, sc = jvit.viterbi_fill_backtrace(*args, HMM, use_pallas=True)
        iM2M = jnp.log(1.0 - 1.0 / args[6])
        eM2M = jnp.log(1.0 - HMM[3] - HMM[4] - (1.0 - 1.0 / args[6]))
        codes = vp.viterbi_fill_codes_pallas(
            args[0].T, args[2].T, args[3].T, args[4].T, args[1], args[5],
            iM2M, eM2M, jnp.logaddexp(eM2M, iM2M),
            tuple(float(np.log(v)) for v in HMM))[0]
    _check(port, pc, pl, sc)
    np.testing.assert_array_equal(port[0], np.asarray(codes))


def test_decode_path_matches_jax():
    from dnascent_tpu.ops import viterbi as jvit
    codes = np.random.default_rng(5).integers(0, 8, 300).astype(np.uint8)
    codes = codes[(codes & 3) != 3]
    for got, want in zip(tvit.decode_path(codes, 40),
                         jvit.decode_path(codes, 40)):
        np.testing.assert_array_equal(got, want)
    kinds, pos = tvit.decode_path(np.array([1 | 4, 1, 2, 1 | 4, 0 | 4],
                                           np.uint8), 6)
    np.testing.assert_array_equal(kinds, [1, 1, 2, 1, 0])
    np.testing.assert_array_equal(pos, [3, 3, 3, 4, 5])
