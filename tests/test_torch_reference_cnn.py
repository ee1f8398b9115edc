"""PyTorch port, the reference CNN topology (``detect --model``) and kernel
F's plain twin, against the JAX package's ``models/reference_cnn.py`` on
the same seeded inputs (CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from dnascent_tpu.models import reference_cnn as rc
from dnascent_tpu.models.cnn import SIG_QUANT_LO, SIG_QUANT_SCALE
from dnascent_tpu_torch.models import reference_cnn as trc
from dnascent_tpu_torch.ops import gru as tgru, gru_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every model below carries seeded non-zero biases and BatchNorm statistics
# (trc.seed_affine), as trained weights do
# GRU: the JAX contract (test_gru_pallas_matches_scan), f32 rounding of the
# 16-term products; measured 3.6e-7 against the scan, 5.4e-7 against the
# Pallas kernel
GRU_ATOL = 2e-5
# whole model, f32 convolutions, against the flax-free JAX module applied
# op by op: measured max 1.2e-6
F32_ATOL = 1e-4
# bf16 convolutions round at other places in oneDNN and XLA: measured max
# 5.2e-3, mean 2.1e-4 on these inputs
BF16_ATOL_MAX, BF16_ATOL_MEAN = 0.02, 1e-3
# the CLI against the JAX CLI, whose bf16 model is jitted (XLA fuses the
# bf16 chain differently): measured max 0.0171, mean 0.0017 over 612 calls
# x 2 columns
CLI_ATOL_MAX, CLI_ATOL_MEAN = 0.05, 0.01


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _port_model(tensors, dtype=torch.bfloat16):
    return trc.params_from_tensors(trc.ReferenceDetectCNN(dtype), tensors)


def test_tables_and_synthetic_tensors_match_jax():
    """The port's wiring tables and its copy of the numpy weight generator
    equal the JAX module's."""
    assert trc._PROLOGUE == rc._PROLOGUE and trc._BLOCKS == rc._BLOCKS
    assert trc._EPILOGUE == rc._EPILOGUE
    assert trc._CONV_SHAPES == rc._CONV_SHAPES
    assert trc._SEP_SHAPES == rc._SEP_SHAPES and trc._BN_CH == rc._BN_CH
    for seed in (0, 5):
        ours, theirs = trc.synthetic_tensors(seed), rc.synthetic_tensors(seed)
        assert ours.keys() == theirs.keys() and len(ours) == 268
        for k in ours:
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_receptive_field():
    assert trc.ReferenceDetectCNN().receptive_field() == 249


@pytest.mark.parametrize("loader", ["tensors", "tree"])
def test_params_consume_every_tensor(loader):
    """Both loaders fill all 268 parameters (each starts as NaN), with the
    TF layouts transposed."""
    tensors = trc.synthetic_tensors(2)
    model = trc.ReferenceDetectCNN()
    assert sum(1 for _ in model.parameters()) == 268
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(float("nan"))
    if loader == "tensors":
        trc.params_from_tensors(model, tensors)
    else:
        # the npz key layout cnn.save_params writes for the JAX tree
        import flax
        flat = flax.traverse_util.flatten_dict(
            rc.params_from_tensors(tensors), sep="/")
        trc.params_from_tree(model, {k: np.asarray(v)
                                     for k, v in flat.items()})
    for name, p in model.named_parameters():
        assert not torch.isnan(p).any(), name
    got = lambda p: p.detach().numpy()   # noqa: E731
    np.testing.assert_array_equal(got(model.layer(43).weight),
                                  tensors["layer43/kernel"].transpose(2, 1, 0))
    np.testing.assert_array_equal(
        got(model.layer(4).depthwise)[:, 0],
        tensors["layer4/depthwise_kernel"][:, :, 0].T)
    np.testing.assert_array_equal(got(model.gru.recurrent1),
                                  tensors["trainable4"])


def test_params_shape_errors_match_jax():
    tensors = trc.synthetic_tensors(4)
    bad = dict(tensors, **{"layer2/kernel": tensors["layer2/kernel"][:, :32]})
    with pytest.raises(ValueError, match=r"layer2 kernel shape"):
        rc.params_from_tensors(bad)
    with pytest.raises(ValueError, match=r"layer2 kernel shape"):
        trc.params_from_tensors(trc.ReferenceDetectCNN(), bad)
    bad = dict(tensors, **{"layer3/gamma": np.ones(32, np.float32)})
    with pytest.raises(ValueError, match=r"layer3 BN channels"):
        trc.params_from_tensors(trc.ReferenceDetectCNN(), bad)
    missing = {k: v for k, v in tensors.items() if k != "trainable190"}
    with pytest.raises(KeyError, match="trainable190"):
        trc.params_from_tensors(trc.ReferenceDetectCNN(), missing)


@pytest.fixture(scope="module")
def gru_case():
    """512 seeded rows of u8 codes: padded tails, and rows made only of the
    code q=128, whose dequantised value is 0.0 under IEEE division."""
    torch.set_num_threads(2)
    params = rc.params_from_tensors(trc.seed_affine(rc.synthetic_tensors(0),
                                                    10))
    assert all(np.abs(params[c]["bias"]).min() > 0 for c in ("gru0", "gru1"))
    rng = np.random.default_rng(5)
    xq = rng.integers(0, 256, (512, rc.RAWDEPTH)).astype(np.uint8)
    xq[:32, 7:] = 0
    xq[40:48] = 128
    q = xq.astype(np.float32)
    x = np.where(q == 0, 0.0, (q - 1.0) / SIG_QUANT_SCALE + SIG_QUANT_LO
                 ).astype(np.float32)
    ambiguous = ((x == 0) & (q != 0)).any(axis=1)
    w = tgru.pack_weights({k: _t(v) for k, v in params["gru0"].items()},
                          {k: _t(v) for k, v in params["gru1"].items()})
    ours = gru_cuda.gru_encoder(torch.from_numpy(xq), w).numpy()
    return params, xq, x, ambiguous, ours


def test_gru_twin_matches_scan(gru_case):
    """Against the XLA scan fed host-dequantised samples: every row within
    GRU_ATOL, the q=128 rows included (both sides divide in IEEE f32, so
    that code lands on 0.0 and masks on both)."""
    params, xq, x, ambiguous, ours = gru_case
    ref = np.asarray(rc._gru_scan(jnp.asarray(x), jnp.asarray(x != 0),
                                  params["gru0"], params["gru1"]))
    assert ambiguous[40:48].all()
    np.testing.assert_allclose(ours, ref, atol=GRU_ATOL)
    x_t, live = tgru.dequantise(torch.from_numpy(xq))
    np.testing.assert_array_equal(x_t.numpy()[xq != 0], x[xq != 0])
    np.testing.assert_array_equal(live.numpy(), (xq != 0) & (x != 0))


def test_gru_twin_matches_pallas_interpret(gru_case):
    """Against ``_gru_scan_pallas`` in interpret mode: within GRU_ATOL on
    the rows without the q=128 code.  Interpret mode mimics the TPU's
    reciprocal division, under which q=128 is not 0.0 and stays live, so
    those rows are reported apart (as test_gru_pallas_matches_scan
    does)."""
    from jax.experimental.pallas import tpu as pltpu

    params, xq, x, ambiguous, ours = gru_case
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(rc._gru_scan_pallas(jnp.asarray(xq), params["gru0"],
                                             params["gru1"]))
    keep = ~ambiguous
    assert keep.sum() > 400
    np.testing.assert_allclose(ours[keep], ref[keep], atol=GRU_ATOL)
    # all-128 rows: every step masked here, so the state stays 0
    np.testing.assert_array_equal(ours[40:48], 0.0)


def _model_inputs(B=2, L=256, seed=0):
    rng = np.random.default_rng(seed)
    core = rng.integers(1, 1025, (B, L))
    res = rng.integers(1, 257, (B, L))
    cnt = rng.integers(0, 21, (B, L))
    sig = np.clip(rng.normal(128, 30, (B, L, rc.RAWDEPTH)), 1, 255
                  ).astype(np.uint8)
    sig[np.arange(rc.RAWDEPTH)[None, None, :] >= cnt[..., None]] = 0
    return core, res, sig


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_model_matches_jax(precision, monkeypatch):
    """The whole model against ``rc.create_model().apply`` (op by op) on
    u8 windows, B=2, L=256: f32 convolutions within F32_ATOL, bf16 within
    the measured bf16 spread."""
    torch.set_num_threads(2)
    tensors = trc.seed_affine(rc.synthetic_tensors(1), 11)
    core, res, sig = _model_inputs()
    if precision == "f32":
        monkeypatch.setattr(rc, "_CONV_DTYPE", jnp.float32)
    ref = np.asarray(rc.create_model().apply(
        rc.params_from_tensors(tensors), jnp.asarray(core), jnp.asarray(res),
        jnp.asarray(sig)))
    model = _port_model(tensors, torch.float32 if precision == "f32"
                        else torch.bfloat16)
    with torch.no_grad():
        ours = model(_t(core), _t(res), _t(sig)).numpy()
    assert ours.shape == ref.shape == (2, 256, 3)
    np.testing.assert_allclose(ours.sum(-1), 1.0, atol=1e-5)
    d = np.abs(ours - ref)
    if precision == "f32":
        assert d.max() < F32_ATOL, d.max()
    else:
        assert d.max() < BF16_ATOL_MAX and d.mean() < BF16_ATOL_MEAN, \
            (d.max(), d.mean())


def test_float_window_matches_jax(monkeypatch):
    """A float sample window takes the plain scan on the CPU (0.0 =
    padding), as the JAX module's float path does; f32 convolutions."""
    rng = np.random.default_rng(3)
    sig = rng.normal(0, 1, (1, 64, rc.RAWDEPTH)).astype(np.float32)
    sig[:, :, 10:] = 0.0
    core = rng.integers(1, 1025, (1, 64))
    tensors = trc.seed_affine(rc.synthetic_tensors(6), 16)
    monkeypatch.setattr(rc, "_CONV_DTYPE", jnp.float32)
    ref = np.asarray(rc.create_model().apply(
        rc.params_from_tensors(tensors), jnp.asarray(core), jnp.asarray(core),
        jnp.asarray(sig)))
    model = _port_model(tensors, torch.float32)
    with torch.no_grad():
        ours = model(_t(core), _t(core), _t(sig)).numpy()
    np.testing.assert_allclose(ours, ref, atol=F32_ATOL)
    # off the CPU a float window raises: only u8 windows reach kernel F
    with pytest.raises(ValueError, match="u8 windows"):
        model.gru(torch.zeros((4, rc.RAWDEPTH), device="meta"))


def test_seed_affine_draws_every_bias_and_bn_stat():
    """seed_affine replaces exactly the biases and BatchNorm tensors, with
    non-zero values (positive variances), and keeps the matrices."""
    base = trc.synthetic_tensors(0)
    live = trc.seed_affine(base, 1)
    assert live.keys() == base.keys()
    changed = {k for k in base if not np.array_equal(base[k], live[k])}
    want = {"trainable2", "trainable5", "trainable191"}
    want |= {k for k in base if k.startswith("layer")
             and k.split("/")[1] in ("bias", "gamma", "beta", "moving_mean",
                                     "moving_variance")}
    assert changed == want and len(want) > 100
    for k in want:
        assert np.all(live[k] != 0) and live[k].dtype == np.float32, k
        assert live[k].shape == base[k].shape, k
    assert all(np.all(live[k] > 0) for k in want if "variance" in k)


def test_savedmodel_roundtrip(tmp_path):
    """A SavedModel directory written by the test bundle writer loads
    through the port's loader into the same model as the tensor dict; a
    directory with a wrong shape is refused by the architecture check."""
    from dnascent_tpu.testing.tf_bundle_writer import write_savedmodel_dir

    tensors = trc.seed_affine(trc.synthetic_tensors(3), 13)
    model_dir = str(tmp_path / "detect_model")
    write_savedmodel_dir(model_dir, tensors)
    loaded = trc.load_savedmodel(model_dir)
    want = _port_model(tensors)
    for (na, a), (nb, b) in zip(loaded.named_parameters(),
                                want.named_parameters()):
        assert na == nb and torch.equal(a, b), na
    bad = dict(tensors, **{"layer2/kernel": tensors["layer2/kernel"][:, :32]})
    write_savedmodel_dir(str(tmp_path / "bad"), bad)
    with pytest.raises(ValueError, match="layer_with_weights-2/kernel"):
        trc.load_savedmodel(str(tmp_path / "bad"))


def _calls(path):
    heads, rows = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            if line.startswith(">"):
                heads.append(line.rstrip("\n"))
            else:
                rows.append(line.rstrip("\n").split("\t"))
    return heads, rows


def test_cli_model_matches_jax_cli(tmp_path, models):
    """``python -m dnascent_tpu_torch detect --model <dir> --device cpu``
    against the JAX CLI with the same SavedModel on the same dataset:
    headers, coordinates and k-mers exact, probabilities within the
    measured bf16 spread.  The same weights as a reference-topology npz
    (``--cnn-weights``, the layout ``trainCNN --fit-arch reference``
    writes) give the same calls."""
    import flax
    from dnascent_tpu import cli as jcli
    from dnascent_tpu.models import cnn as jcnn
    from dnascent_tpu.testing.dataset import build_dataset
    from dnascent_tpu.testing.tf_bundle_writer import write_savedmodel_dir
    from dnascent_tpu_torch import cli as tcli

    ds = build_dataset(str(tmp_path / "ds"), models, n_reads=2,
                       read_length=1200, signal_format="fast5", seed=21)
    tensors = trc.seed_affine(trc.synthetic_tensors(5), 15)
    model_dir = str(tmp_path / "detect_model")
    write_savedmodel_dir(model_dir, tensors)
    io = ["-b", ds.bam, "-r", ds.reference_fa, "-i", ds.index, "-l", "1000"]
    jax_out = str(tmp_path / "jax.detect")
    assert jcli.main(["detect", *io, "-o", jax_out, "--model", model_dir]) == 0
    port_out = str(tmp_path / "port.detect")
    env = dict(os.environ, DNASCENT_TPU_MODELS="/nonexistent",
               OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "dnascent_tpu_torch", "detect", *io, "-o",
         port_out, "--device", "cpu", "--model", model_dir], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    j_heads, j_rows = _calls(jax_out)
    p_heads, p_rows = _calls(port_out)
    assert p_heads == j_heads and len(p_rows) > 200
    assert [(r[0], r[3]) for r in p_rows] == [(r[0], r[3]) for r in j_rows]
    d = np.abs(np.array([[float(x) for x in r[1:3]] for r in p_rows])
               - np.array([[float(x) for x in r[1:3]] for r in j_rows]))
    assert d.max() < CLI_ATOL_MAX and d.mean() < CLI_ATOL_MEAN, \
        (d.max(), d.mean())

    npz = str(tmp_path / "ref.npz")
    jcnn.save_params(flax.core.freeze(rc.params_from_tensors(tensors)), npz)
    npz_out = str(tmp_path / "port_npz.detect")
    torch.set_num_threads(2)
    assert tcli.main(["detect", *io, "-o", npz_out, "--device", "cpu",
                      "--cnn-weights", npz]) == 0
    assert _calls(npz_out) == (p_heads, p_rows)
