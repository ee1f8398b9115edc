"""PyTorch port, DetectCNN: weight transfer from the flax model's npz
layout and agreement with the flax model on the same seeded inputs."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import dnascent_tpu_torch  # noqa: F401  (sets DNASCENT_TPU_NO_CACHE)
from dnascent_tpu.models import cnn as jcnn
from dnascent_tpu_torch.models import cnn as tcnn

SMALL = dict(d_model=32, dilations=(1, 2))
# Both sides run the dense and conv layers in bf16, which the frameworks
# round at different places.  Against the flax model applied op by op the
# port agrees to < 1e-2 (measured up to 7.3e-3 on these inputs); XLA's
# jit fuses the bf16 chain differently and moves the flax model itself by
# up to ~0.11 from its op-by-op value (measured), so the jitted comparison,
# which is what the JAX pipeline runs, carries that spread.
ATOL_OP_BY_OP = 0.02
ATOL_JIT_MAX, ATOL_JIT_MEAN = 0.15, 0.02


def _inputs(B=2, L=512, seed=0):
    rng = np.random.default_rng(seed)
    core = rng.integers(1, tcnn.CORE_VOCAB - 1, (B, L))
    res = rng.integers(1, tcnn.RESIDUAL_VOCAB - 1, (B, L))
    cnt = rng.integers(0, 21, (B, L))
    sig = np.clip(rng.normal(128, 30, (B, L, 20)), 1, 255).astype(np.uint8)
    sig[np.arange(20)[None, None, :] >= cnt[..., None]] = 0
    return core, res, sig


def _pair(tmp_path, kw, seed):
    """A flax model with params from a seed, saved with save_params, and the
    port's model loaded from that npz."""
    jm = jcnn.create_model(**kw)
    params = jcnn.init_params(jm, jax.random.PRNGKey(seed))
    path = str(tmp_path / "w.npz")
    jcnn.save_params(params, path)
    tm = tcnn.load_npz(tcnn.DetectCNN(**kw), path)
    return jm, params, tm


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "default"])
def test_cnn_matches_flax(tmp_path, kw):
    torch.set_num_threads(2)
    jm, params, tm = _pair(tmp_path, kw, seed=3)
    core, res, sig = _inputs()
    args = (jnp.asarray(core), jnp.asarray(res), jnp.asarray(sig))
    eager = np.asarray(jm.apply(params, *args))
    jit = np.asarray(jcnn.apply_model(jm, params, *args))
    with torch.no_grad():
        ours = tm(torch.from_numpy(core), torch.from_numpy(res),
                  torch.from_numpy(sig)).numpy()
    assert ours.shape == eager.shape and np.isfinite(ours).all()
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)
    assert np.abs(ours - eager).max() < ATOL_OP_BY_OP
    d = np.abs(ours - jit)
    assert d.max() < ATOL_JIT_MAX and d.mean() < ATOL_JIT_MEAN


def test_params_from_flax_layout(tmp_path):
    jm, params, tm = _pair(tmp_path, SMALL, seed=5)
    with np.load(tmp_path / "w.npz") as data:
        flat = {k: data[k] for k in data.files}
    np.testing.assert_array_equal(tm.in_dense.weight.detach().numpy(),
                                  flat["params/Dense_1/kernel"].T)
    np.testing.assert_array_equal(
        tm.blocks[1].conv0.weight.detach().numpy(),
        flat["params/ConvBlock_1/Conv_0/kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(tm.core_embed.detach().numpy(),
                                  flat["params/Embed_0/embedding"])
    n_loaded = sum(int(np.prod(v.shape)) for v in flat.values())
    assert n_loaded == sum(p.numel() for p in tm.parameters())
    bad = dict(flat)
    bad.pop("params/Dense_2/bias")
    with pytest.raises(KeyError):
        tcnn.params_from_flax(tcnn.DetectCNN(**SMALL), bad)


def test_receptive_field_and_quantiser_match_jax():
    assert (tcnn.DetectCNN().receptive_field()
            == jcnn.create_model().receptive_field())
    x = np.random.default_rng(1).normal(0, 3, 1000).astype(np.float32)
    x[::7] = 0.0
    np.testing.assert_array_equal(tcnn.quantise_signal_u8(x),
                                  jcnn.quantise_signal_u8(x))


def test_untrained_weights_are_seeded():
    a = tcnn.init_untrained(tcnn.DetectCNN(**SMALL), seed=1)
    b = tcnn.init_untrained(tcnn.DetectCNN(**SMALL), seed=1)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
