"""PyTorch port, torch-op modules without a kernel: k-mer rank arithmetic
(ops/seqcodes.py), Theil-Sen (ops/scaling.py) and one-device placement
(device.py), each against its JAX counterpart on the same seeded inputs."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from dnascent_tpu.ops import scaling as jscaling, seqcodes as jseq
from dnascent_tpu_torch import device as devmod
from dnascent_tpu_torch.ops import scaling as tscaling, seqcodes as tseq


def test_rank_arithmetic_matches_jax():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, (3, 257)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 255      # non-ACGT bases
    ours = tseq.ranks_from_codes(torch.from_numpy(codes)).numpy()
    theirs = np.asarray(jseq.ranks_from_codes(jnp.asarray(codes)))
    np.testing.assert_array_equal(ours, theirs)
    flat = codes.reshape(-1)
    np.testing.assert_array_equal(
        tseq.flat_ranks_from_codes(torch.from_numpy(flat)).numpy(),
        np.asarray(jseq.flat_ranks_from_codes_jit(jnp.asarray(flat))))
    r32 = jnp.asarray(theirs.astype(np.int32))
    rt = torch.from_numpy(theirs.copy())
    for tf, jf in ((tseq.core_index_from_ranks, jseq.core_index_from_ranks),
                   (tseq.residual_index_from_ranks,
                    jseq.residual_index_from_ranks),
                   (tseq.center_is_t_from_ranks, jseq.center_is_t_from_ranks)):
        np.testing.assert_array_equal(tf(rt).numpy(), np.asarray(jf(r32)))


def _theilsen_inputs(P=300, B=4, seed=2):
    rng = np.random.default_rng(seed)
    y = rng.normal(0, 1, (B, P)).astype(np.float32)
    sig = (y * 16 + 90 + rng.normal(0, 2, (B, P))).astype(np.float32)
    npts = np.array([P, P - 40, P, 7], np.int32)
    passth = np.array([False, False, True, False])
    # row 3: a flat model -> zero median slope -> the (-1, -1) sentinel
    y[3] = 0.5
    sh = np.array([89.0, 91.0, 90.0, 90.0], np.float32)
    sc = np.array([15.0, 17.0, 16.0, 16.0], np.float32)
    return sig, y, npts, passth, sh, sc


def test_theilsen_matches_jax():
    """Same order statistic (sort vs the TPU's bitwise search) and the same
    f32 arithmetic around it: equal to 1 ulp, sentinel and passthrough
    rows exact."""
    args = _theilsen_inputs()
    P = args[0].shape[1]
    ours = tscaling.theilsen_refine_pregathered(
        *(torch.from_numpy(a) for a in args))
    theirs = jscaling.theilsen_refine_pregathered(
        *(jnp.asarray(a) for a in args), max_points=P)
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(o.numpy(), np.asarray(t), rtol=2e-7)
    assert ours[0][3] == -1.0 and ours[1][3] == -1.0
    assert ours[0][2] == args[4][2] and ours[1][2] == args[5][2]


def test_theilsen_pregather_matches_jax(models):
    rng = np.random.default_rng(4)
    for n in (0, 150, 1000, 2600):
        cs = rng.normal(90, 10, n)
        cr = rng.integers(-1, 4 ** 9, n)
        ours = tscaling.theilsen_pregather(cs, cr, models.pore_model, 1000, 50)
        theirs = jscaling.theilsen_pregather(cs, cr, models.pore_model, 1000,
                                             50)
        for o, t in zip(ours, theirs):
            np.testing.assert_array_equal(o, t)


def test_device_placement_is_explicit():
    x = np.arange(6, dtype=np.int32).reshape(2, 3)
    t = devmod.put_rows(x, "cpu")
    assert t.device.type == "cpu" and t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), x)
    assert devmod.pad_rows(5) == 5 and devmod.pad_rows(0) == 1
    with pytest.raises(ValueError):
        devmod.resolve("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            devmod.resolve("cuda")
