"""PyTorch port, kernels C (Viterbi fill) and D (Viterbi termination and
backtrace): the plain twins, which the wrappers run for CPU tensors, held
to the JAX contract (tests/test_viterbi_pallas.py): scores within rtol
1e-6, path lengths equal, PAD-filtered paths equal — against the XLA scan
and the Pallas kernels in interpret mode, on the same seeded inputs.  D's
rows are left-aligned with PAD only as a tail, and its termination picks
the first of D, M, I on ties, as ``terminate`` and the JAX argmax do."""

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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fill(obs, n_obs, mu, inv, lpc, n_states, epb):
    """Kernel C's twin through its wrapper -> (codes, I, M, D finals,
    eM2MorD, eI2M)."""
    iM2M, eM2M, eOrIM2M, eM2MorD, logs = tvit.transition_scores(_t(epb), HMM)
    codes, I_f, M_f, D_f = viterbi_cuda.viterbi_fill_codes(
        _t(obs.T), _t(mu.T), _t(inv.T), _t(lpc.T), _t(n_obs), _t(n_states),
        iM2M, eM2M, eOrIM2M, logs)
    return codes, I_f, M_f, D_f, eM2MorD, logs[2]


def _port(obs, n_obs, mu, inv, lpc, n_states, epb, s_rows=None):
    T = obs.shape[1]
    N = mu.shape[1]
    codes, I_f, M_f, D_f, eM2MorD, eI2M = _fill(obs, n_obs, mu, inv, lpc,
                                                n_states, epb)
    score, _kind0 = tvit.terminate(I_f, M_f, D_f, _t(n_states), eM2MorD,
                                   eI2M)
    path, plen = viterbi_cuda.viterbi_terminate_backtrace(
        codes, I_f, M_f, D_f, _t(n_obs), _t(n_states), eM2MorD, eI2M,
        T + N if s_rows is None else s_rows)
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


def test_paths_are_left_aligned(windows):
    """Every row holds its path_len codes first, none of them PAD, and PAD
    in every slot after them."""
    _, _, path, plen = _port(*windows)
    live = np.arange(path.shape[1])[None, :] < plen[:, None]
    assert plen.min() > 0
    assert ((path & 3) != 3)[live].all()
    assert (path[~live] == 3).all()


def test_termination_ties_pick_d_then_m(windows):
    """Finals crafted so that D = M + eM2MorD in some windows and M +
    eM2MorD = I + eI2M in others (and all three tie in some): each path's
    last forward code is the kind that ``terminate`` and the JAX argmax
    (first maximum: D, M, I) pick."""
    obs, n_obs, mu, inv, lpc, n_states, epb = windows
    T, N = obs.shape[1], mu.shape[1]
    codes, I_f, M_f, D_f, eM2MorD, eI2M = _fill(*windows)
    W = codes.shape[2]
    last = torch.from_numpy(n_states.astype(np.int64) - 1)
    wi = torch.arange(W)
    M_f, D_f, I_f = M_f.clone(), D_f.clone(), I_f.clone()
    base = M_f[last, wi].clone()
    base = torch.where(torch.isfinite(base), base, torch.tensor(-50.0))
    m_cand = base + eM2MorD
    case = wi % 4  # 0: D = M, 1: M = I, 2: all three, 3: as filled
    M_f[last, wi] = torch.where(case < 3, base, M_f[last, wi])
    D_f[last, wi] = torch.where((case == 0) | (case == 2), m_cand,
                                torch.where(case == 1, m_cand - 1.0,
                                            D_f[last, wi]))
    # I + eI2M == M + eM2MorD: pick I's final as f32 so the sum rounds back
    i_eq = m_cand - eI2M
    i_eq = torch.where(i_eq + eI2M == m_cand, i_eq, torch.nextafter(
        i_eq, torch.tensor(float("inf"))))
    I_f[last, wi] = torch.where(case == 1, i_eq,
                                torch.where(case == 0, m_cand - 1.0,
                                            torch.where(case == 2, i_eq,
                                                        I_f[last, wi])))
    cand = torch.stack([D_f[last, wi], M_f[last, wi] + eM2MorD,
                        I_f[last, wi] + eI2M])
    tied = (cand == cand.max(dim=0).values).sum(dim=0)
    assert bool((tied[case < 3] >= 2).all())
    _, kind0 = tvit.terminate(I_f, M_f, D_f, _t(n_states), eM2MorD, eI2M)
    want = np.asarray(jnp.argmax(jnp.asarray(cand.numpy()), axis=0))
    np.testing.assert_array_equal(kind0.numpy(), want)
    np.testing.assert_array_equal(want[case.numpy() == 0], 0)
    np.testing.assert_array_equal(want[case.numpy() == 1], 1)
    path, plen = viterbi_cuda.viterbi_terminate_backtrace(
        codes, I_f, M_f, D_f, _t(n_obs), _t(n_states), eM2MorD, eI2M, T + N)
    assert int(plen.min()) > 0
    last_code = path[wi, plen.long() - 1] & 3
    np.testing.assert_array_equal(last_code.numpy(), kind0.numpy())


def test_short_s_rows_matches_plain_countdown(windows):
    """``s_rows`` below T + N (the path's 64-bucket, here 64): a window
    whose walk would start at s >= s_pad gets no path, the rest the full
    one, exactly as the PAD-gapped countdown at that s_pad."""
    obs, n_obs, mu, inv, lpc, n_states, epb = windows
    s_rows = 64
    codes, I_f, M_f, D_f, eM2MorD, eI2M = _fill(*windows)
    _, kind0 = tvit.terminate(I_f, M_f, D_f, _t(n_states), eM2MorD, eI2M)
    gapped, glen = tvit.viterbi_backtrace_plain(codes, kind0, _t(n_obs),
                                                _t(n_states), s_rows)
    _, _, path, plen = _port(*windows, s_rows=s_rows)
    full = _port(*windows)[3]
    assert path.shape == (obs.shape[0], s_rows)
    np.testing.assert_array_equal(plen, glen.numpy())
    s0 = n_obs + n_states - 1
    assert (plen[s0 >= s_rows] == 0).all() and (s0 >= s_rows).any()
    np.testing.assert_array_equal(plen[s0 < s_rows], full[s0 < s_rows])
    gapped = gapped.numpy()
    for w in range(path.shape[0]):
        np.testing.assert_array_equal(path[w, :plen[w]],
                                      gapped[w][(gapped[w] & 3) != 3])


def test_read_paths_match_per_window_filter(windows):
    """eventalign's consumer of D's left-aligned rows, fed two chunks whose
    windows interleave, gives each read the codes and step counts of the
    per-window PAD filter over the countdown's gapped rows."""
    from dnascent_tpu_torch.pipeline.eventalign import _read_paths
    obs, n_obs, mu, inv, lpc, n_states, epb = windows
    T, N = obs.shape[1], mu.shape[1]
    codes, I_f, M_f, D_f, eM2MorD, eI2M = _fill(*windows)
    path, plen = viterbi_cuda.viterbi_terminate_backtrace(
        codes, I_f, M_f, D_f, _t(n_obs), _t(n_states), eM2MorD, eI2M, T + N)
    _, kind0 = tvit.terminate(I_f, M_f, D_f, _t(n_states), eM2MorD, eI2M)
    gapped = tvit.viterbi_backtrace_plain(codes, kind0, _t(n_obs),
                                          _t(n_states), T + N)[0].numpy()
    W = path.shape[0]
    wid = np.arange(W)
    chunks = [(cid, path[cid], plen[cid]) for cid in (wid[wid % 3 != 1],
                                                       wid[wid % 3 == 1])]
    counts = np.array([5, 1, 40, W - 46])
    got = _read_paths(chunks, W, counts)
    rows = [gapped[w][(gapped[w] & 3) != 3] for w in range(W)]
    w0 = 0
    for (flat, steps), c in zip(got, counts):
        np.testing.assert_array_equal(flat, np.concatenate(rows[w0:w0 + c]))
        np.testing.assert_array_equal(
            steps, [r.shape[0] for r in rows[w0:w0 + c]])
        w0 += c


def test_codes_window_stride():
    """Kernel D's wrapper takes codes whose window stride is a multiple of
    16, as kernel C lays them out, and refuses any other layout."""
    padded = torch.zeros((4, 3, 48), dtype=torch.uint8)
    assert viterbi_cuda.codes_window_stride(padded[:, :, :33]) == 48
    assert viterbi_cuda.codes_window_stride(padded) == 48
    for bad in (torch.zeros((4, 3, 33), dtype=torch.uint8),
                padded[:, :, 1:34], padded.transpose(0, 1)):
        with pytest.raises(ValueError, match="multiples of 16"):
            viterbi_cuda.codes_window_stride(bad)


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
