"""PyTorch port, kernels A (static-stdv banded fill), E (per-k-mer-stdv
banded fill) and B (backtrace chase): the plain twins, which the wrappers
run for CPU tensors, held to the JAX kernels' contracts
(tests/test_banded_pallas.py) on the same seeded inputs.  The Pallas
kernels run in interpret mode, as their own tests run them."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dnascent_tpu.config import DNA_R10
from dnascent_tpu.ops import banded as jbanded
from dnascent_tpu_torch.ops import banded as tbanded, banded_cuda

LENS = (300, 450, 380)


def _inputs(pore_model):
    """Seeded simulated reads -> scaled events, per-k-mer coefficients and
    the static-stdv scalars, as the JAX kernel tests build them."""
    from dnascent_tpu.ops import reference as ref
    from dnascent_tpu.testing.simulate import simulate_read
    from dnascent_tpu.utils import seqtools

    torch.set_num_threads(2)
    reads = []
    for i, ln in enumerate(LENS):
        sim = simulate_read(pore_model, DNA_R10, length=ln, seed=70 + i)
        me = ref.merge_events(ref.detect_events(sim.raw), sim.raw.shape[0])
        ranks = np.maximum(seqtools.kmer_ranks(sim.sequence, 9), 0)
        shift, scale = ref.estimate_scaling_quantiles(
            me.mean, pore_model[ranks, 0])
        reads.append((me, ranks, shift, scale))
    B = len(reads)
    E = max(r[0].mean.shape[0] for r in reads)
    K = max(r[1].shape[0] for r in reads)
    scaled = np.zeros((B, E), np.float32)
    mu = np.zeros((B, K), np.float32)
    ivs = np.ones((B, K), np.float32)
    lpc = np.full((B, K), -np.inf, np.float32)
    n_ev = np.zeros(B, np.int32)
    n_km = np.zeros(B, np.int32)
    for b, (me, ranks, shift, scale) in enumerate(reads):
        ne, nk = me.mean.shape[0], ranks.shape[0]
        scaled[b, :ne] = (me.mean - shift) / scale
        m, i_, l_ = jbanded.prepare_emission_coefficients(ranks[None],
                                                          pore_model)
        mu[b, :nk], ivs[b, :nk], lpc[b, :nk] = m[0], i_[0], l_[0]
        n_ev[b], n_km[b] = ne, nk
    s0 = float(pore_model[0, 1])
    lean = dict(inv_sigma=1.0 / s0,
                lp_const=float(np.log(0.3989422804014327) - np.log(s0)))
    mu_lean = np.where(np.isfinite(lpc), mu, np.inf).astype(np.float32)
    return scaled, mu, ivs, lpc, n_ev, n_km, mu_lean, lean


@pytest.fixture(scope="module")
def fill_inputs(models):
    return _inputs(models.pore_model)


@pytest.fixture(scope="module")
def fit_model():
    """A fit-stdv pore model: the static model's means with stdvs 0.10 to
    0.18 varying per k-mer."""
    from dnascent_tpu.io.poremodel import synthetic_model_table
    table = synthetic_model_table(9, seed=1)
    assert np.unique(table[:, 1]).shape[0] > 1000
    return table


@pytest.fixture(scope="module")
def general_inputs(fit_model):
    return _inputs(fit_model)[:6]


@pytest.fixture(scope="module")
def general_fill(general_inputs):
    out = banded_cuda.banded_fill_general(
        *(torch.from_numpy(a) for a in general_inputs))
    return [t.numpy() for t in out]


@pytest.fixture(scope="module")
def port_fill(fill_inputs):
    scaled, _, _, _, n_ev, n_km, mu_lean, lean = fill_inputs
    out = banded_cuda.banded_fill_lean(
        torch.from_numpy(scaled), torch.from_numpy(mu_lean),
        torch.from_numpy(n_ev), torch.from_numpy(n_km), **lean)
    return [t.numpy() for t in out]


def _check_fill_contract(port, ref, n_ev, n_km):
    """The lean-kernel contract: rights and best_event bitwise equal, trace
    codes differ in < 2e-3 of a read's cells (rounding-tie flips), best
    score within 0.05."""
    tp, rp, be, bs = port
    tr, rr, ber, bsr = (np.asarray(x) for x in ref)
    assert tp.shape == tr.shape and tp.dtype == np.uint8
    np.testing.assert_array_equal(rp, rr)
    for b in range(tp.shape[1]):
        s = (int(n_ev[b]) + int(n_km[b]) + 3) // 4
        mismatch = (tp[:s, b] != tr[:s, b]).mean()
        assert mismatch < 2e-3, f"row {b}: {mismatch}"
    np.testing.assert_array_equal(be, ber)
    np.testing.assert_allclose(bs, bsr, rtol=0, atol=0.05)


def test_fill_matches_xla_scan(fill_inputs, port_fill):
    scaled, mu, ivs, lpc, n_ev, n_km, _, _ = fill_inputs
    ref = jbanded.banded_fill_jit(*(jnp.asarray(x) for x in
                                    (scaled, mu, ivs, lpc, n_ev, n_km)))
    _check_fill_contract(port_fill, ref, n_ev, n_km)


def test_fill_matches_pallas_lean_interpret(fill_inputs, port_fill):
    """Same arithmetic as the TPU lean kernel, op for op: beyond the
    contract, trace, rights and best events are bitwise equal (the scan
    comparison above carries the rounding-tie flips)."""
    from jax.experimental.pallas import tpu as pltpu
    from dnascent_tpu.ops import banded_pallas

    scaled, _, _, _, n_ev, n_km, mu_lean, lean = fill_inputs
    with pltpu.force_tpu_interpret_mode():
        ref = banded_pallas.banded_fill_pallas_lean(
            jnp.asarray(scaled), jnp.asarray(mu_lean), jnp.asarray(n_ev),
            jnp.asarray(n_km), **lean)
    _check_fill_contract(port_fill, ref, n_ev, n_km)
    for ours, theirs in zip(port_fill[:3], ref[:3]):
        np.testing.assert_array_equal(ours, np.asarray(theirs))
    # the per-read stay/step log-probs come from torch's and XLA's own log,
    # which may differ in the last bit
    np.testing.assert_allclose(port_fill[3], np.asarray(ref[3]), rtol=1e-6)


def test_general_fill_matches_xla_scan(general_inputs, general_fill):
    """Kernel E's twin on a per-k-mer-stdv model against the XLA scan: the
    same contract as the static fill (rights and best_event bitwise, trace
    mismatch < 2e-3 per read, best_score within 0.05)."""
    scaled, mu, ivs, lpc, n_ev, n_km = general_inputs
    ref = jbanded.banded_fill_jit(*(jnp.asarray(x) for x in general_inputs))
    _check_fill_contract(general_fill, ref, n_ev, n_km)


def test_general_fill_matches_pallas_interpret(general_inputs, general_fill):
    """Kernel E's twin follows ``banded_pallas._kernel`` op for op: trace,
    rights and best events bitwise equal to it in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu
    from dnascent_tpu.ops import banded_pallas

    scaled, mu, ivs, lpc, n_ev, n_km = general_inputs
    with pltpu.force_tpu_interpret_mode():
        ref = banded_pallas.banded_fill_pallas(
            *(jnp.asarray(x) for x in general_inputs))
    _check_fill_contract(general_fill, ref, n_ev, n_km)
    for ours, theirs in zip(general_fill[:3], ref[:3]):
        np.testing.assert_array_equal(ours, np.asarray(theirs))
    np.testing.assert_allclose(general_fill[3], np.asarray(ref[3]),
                               rtol=1e-6)


def test_general_fill_reduces_to_lean_on_static_model(fill_inputs):
    """On a static-stdv model both fills run the same recursion; only the
    emission's rounding differs, so they meet the scan contract against
    each other."""
    scaled, mu, ivs, lpc, n_ev, n_km, mu_lean, lean = fill_inputs
    t = [torch.from_numpy(a) for a in (scaled, mu, ivs, lpc, n_ev, n_km)]
    general = [x.numpy() for x in banded_cuda.banded_fill_general(*t)]
    static = banded_cuda.banded_fill_lean(t[0], torch.from_numpy(mu_lean),
                                          t[4], t[5], **lean)
    _check_fill_contract(general, static, n_ev, n_km)


def _moves(packed, col):
    by = packed[:, col].astype(np.int64)
    mv = np.stack([(by >> (2 * j)) & 3 for j in range(4)], axis=1).reshape(-1)
    return mv[mv != 3]


def test_chase_matches_pallas_interpret(fill_inputs, port_fill, models):
    """PAD-filtered move streams equal to the Pallas chase on the same
    trace, in the same (Sp, B) band-ordered layout."""
    from jax.experimental.pallas import tpu as pltpu
    from dnascent_tpu.ops import banded_pallas

    scaled, _, _, _, _, n_km, _, _ = fill_inputs
    tp, rp, be, _ = port_fill
    port = banded_cuda.backtrace_moves(
        torch.from_numpy(tp), torch.from_numpy(rp), torch.from_numpy(be),
        torch.from_numpy(n_km)).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(banded_pallas.backtrace_moves_pallas(
            jnp.asarray(tp), jnp.asarray(rp), jnp.asarray(be),
            jnp.asarray(n_km)))
    assert port.shape == ref.shape
    for b in range(scaled.shape[0]):
        np.testing.assert_array_equal(_moves(port, b), _moves(ref, b))


def test_host_helpers_match_jax(port_fill, models):
    """The numpy copies of the JAX module's host helpers give its output."""
    tp, rp, _, _ = port_fill
    n_bands = 4 * tp.shape[0] - 3
    for ours, theirs in zip(tbanded.unpack_trace(tp, rp, n_bands),
                            jbanded.unpack_trace(tp, rp, n_bands)):
        np.testing.assert_array_equal(ours, theirs)
    ranks = np.random.default_rng(6).integers(-1, 4 ** 9, (2, 50))
    for ours, theirs in zip(
            tbanded.prepare_emission_coefficients(ranks, models.pore_model),
            jbanded.prepare_emission_coefficients(ranks, models.pore_model)):
        np.testing.assert_array_equal(ours, theirs)


def test_wrappers_reject_bad_inputs(fill_inputs):
    scaled, _, _, _, n_ev, n_km, mu_lean, lean = fill_inputs
    ev = torch.from_numpy(scaled)
    with pytest.raises(TypeError):
        banded_cuda.banded_fill_lean(ev.double(), torch.from_numpy(mu_lean),
                                     torch.from_numpy(n_ev),
                                     torch.from_numpy(n_km), **lean)
    with pytest.raises(ValueError):
        banded_cuda.banded_fill_lean(ev.t().contiguous().t(),
                                     torch.from_numpy(mu_lean),
                                     torch.from_numpy(n_ev),
                                     torch.from_numpy(n_km)[:2], **lean)
    with pytest.raises(ValueError):
        banded_cuda.banded_fill_lean(ev.to("meta"), torch.from_numpy(mu_lean),
                                     torch.from_numpy(n_ev),
                                     torch.from_numpy(n_km), **lean)


def test_general_wrapper_rejects_bad_inputs(general_inputs):
    t = [torch.from_numpy(a) for a in general_inputs]
    with pytest.raises(TypeError):      # f64 inverse sigmas
        banded_cuda.banded_fill_general(t[0], t[1], t[2].double(), *t[3:])
    with pytest.raises(ValueError):     # lp_const plane of the wrong width
        banded_cuda.banded_fill_general(*t[:3], t[3][:, :-1].contiguous(),
                                        *t[4:])
    with pytest.raises(ValueError):     # a device that is neither cpu nor cuda
        banded_cuda.banded_fill_general(*(x.to("meta") for x in t))
