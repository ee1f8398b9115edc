"""PyTorch port, CNN fitting (``trainCNN --fit``) on the CPU: the training
batches, the optimizer, the train step of both architectures and the npz
weights against the JAX package's ``pipeline/traincnn.py`` and
``save_params``, and the CLI end to end.

Tolerances (measured on the CPU): the batches' signal windows equal the
JAX's exactly; AdamW against ``optax.adamw`` over 3 steps within 1e-6
relative (max 1.4e-6 absolute at |p| ~ 4: 3 f32 ulps of the parameter); the
reference topology with f32 convolutions, 3 steps from the same weights and
batches, losses within 2.3e-6 relative; the DetectCNN's first loss (bf16
layers, oneDNN against XLA) within 2.1e-5 on these batches, held to
2e-3."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from dnascent_tpu.config import DNA_R10
from dnascent_tpu.testing.dataset import build_dataset
# both CLIs' progress bars bind sys.stderr when their module is first
# imported: import them here, not under a test's capsys
import dnascent_tpu.utils.progress  # noqa: F401
import dnascent_tpu_torch.utils.progress  # noqa: F401

ADAMW_RTOL = 1e-6
REF_LOSS_RTOL = 1e-4
DETECT_LOSS_ATOL = 2e-3


def _random_batches(n, B=2, L=256, seed=0):
    """Seeded batches: indices, f32 windows with 0..20 live samples, labels
    in {0, 1, 2} with half the positions masked (-1)."""
    from dnascent_tpu_torch.pipeline.traincnn import TrainBatch
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        core = rng.integers(1, 1025, (B, L)).astype(np.int32)
        res = rng.integers(1, 257, (B, L)).astype(np.int32)
        sig = rng.normal(0, 1, (B, L, 20)).astype(np.float32)
        live = rng.integers(0, 21, (B, L))
        sig[np.arange(20)[None, None, :] >= live[..., None]] = 0.0
        lab = rng.integers(0, 3, (B, L)).astype(np.int32)
        lab[rng.random((B, L)) < 0.5] = -1
        out.append(TrainBatch(core, res, sig, lab, lab >= 0))
    return out


def _simulated(models, n_reads=3, seed=5):
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    return [dataclasses.replace(r, is_reverse=i % 2 == 1)
            for i, r in enumerate(SimulatedSource(models, DNA_R10,
                                                  n_reads=n_reads,
                                                  length=1500, seed=seed))]


def test_batches_match_jax(models):
    """``batches_from_labelled_reads`` (three simulated reads, one
    reverse, label BrdU, seq_len 256, batch 4) against the JAX's: core,
    residual, labels and mask exact, and the f32 signal windows (built from
    the scaled-sample store, not the u8 stream) exact too.  Both preps
    agree on these reads."""
    from dnascent_tpu.pipeline import traincnn as jt
    from dnascent_tpu.pipeline.prep import prepare_reads as jax_prep
    from dnascent_tpu_torch.pipeline import traincnn as tt
    from dnascent_tpu_torch.pipeline.prep import prepare_reads

    recs = _simulated(models)
    for a, b in zip(jax_prep(recs, models, DNA_R10),
                    prepare_reads(recs, models, DNA_R10, device="cpu")):
        assert np.array_equal(a.event_alignment, b.event_alignment)
    pairs = [(r, np.full(len(r.reference_seq), 1, np.int32)) for r in recs]
    want = list(jt.batches_from_labelled_reads(pairs, models, DNA_R10,
                                               seq_len=256, batch_size=4))
    got = list(tt.batches_from_labelled_reads(pairs, models, DNA_R10,
                                              seq_len=256, batch_size=4,
                                              device="cpu"))
    assert len(got) == len(want) > 1
    assert not got[-1].mask[-1].any()          # the tail batch is padded
    for a, b in zip(want, got):
        for f in ("core_idx", "residual_idx", "labels", "mask"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert b.signal.dtype == np.float32
        np.testing.assert_array_equal(b.signal, a.signal)
    assert sum(int(b.mask.sum()) for b in got) > 500


def test_signal_store_follows_dropped_positions(models):
    """``AlignedPositions.signal`` is built from the scaled samples; after
    trainCNN's second pass drops the called coordinates, the kept rows keep
    their windows, which dequantise to the u8 stream's within its step."""
    from dnascent_tpu_torch.models.cnn import SIG_QUANT_SCALE
    from dnascent_tpu_torch.pipeline import eventalign as ea
    from dnascent_tpu_torch.pipeline.prep import prepare_reads

    rec = _simulated(models, n_reads=1)
    prepped = prepare_reads(rec, models, DNA_R10, device="cpu")
    pos = ea.run_eventalign(prepped, models, DNA_R10)[
        rec[0].read_id].positions
    drop = {int(c): (0.5, 0.5) for c in pos.coord[::3]}
    kept = ea._drop_called(pos, drop)
    keep = ~np.isin(pos.coord, list(drop))
    sig = pos.signal
    np.testing.assert_array_equal(kept.signal, sig[keep])
    counts = pos.signal_counts.astype(np.int64)
    live = np.arange(20)[None, :] < counts[:, None]
    assert np.array_equal(sig != 0.0, live)
    q = np.zeros_like(sig)
    q[live] = (pos.signal_u8_flat.astype(np.float32) - 1.0) \
        / SIG_QUANT_SCALE - 6.0
    assert np.abs(np.where(live, q - sig, 0.0)).max() <= 0.5 / SIG_QUANT_SCALE


def test_adamw_matches_optax():
    """``make_optimizer`` (torch AdamW, optax's defaults) against
    ``optax.adamw`` on the same seeded parameters and gradients, 3 steps."""
    import jax.numpy as jnp
    import optax
    from dnascent_tpu_torch.pipeline.traincnn import make_optimizer

    rng = np.random.default_rng(4)
    shapes = {"a": (64, 3), "b": (3,), "c": (5, 16, 48)}
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(0, 0.1, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    opt = optax.adamw(3e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = make_optimizer(list(tp.values()), 3e-4)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k in shapes:
        a, b = tp[k].detach().numpy(), np.asarray(jp[k])
        np.testing.assert_allclose(a, b, rtol=ADAMW_RTOL, atol=1e-7)
        assert not np.array_equal(np.asarray(jp[k]), params[k])


def test_reference_arch_steps_match_jax(monkeypatch):
    """The reference topology from ``reference_arch_trainer`` (seeded
    synthetic weights) with f32 convolutions, the JAX ``_CONV_DTYPE``
    monkeypatched alike: 3 steps on the same batches, losses within
    REF_LOSS_RTOL; the BatchNorm moving statistics are bitwise unchanged
    and out of the optimizer, every other weight moved."""
    import jax.numpy as jnp
    from dnascent_tpu.models import reference_cnn as rc
    from dnascent_tpu.pipeline import traincnn as jt
    from dnascent_tpu_torch.models import reference_cnn as trc
    from dnascent_tpu_torch.pipeline import traincnn as tt

    batches = _random_batches(3)
    monkeypatch.setattr(rc, "_CONV_DTYPE", jnp.float32)
    jm, jparams, jopt = jt.reference_arch_trainer(seed=0)
    _, want = jt.train_detect_cnn(batches, model=jm, params=jparams,
                                  optimizer=jopt)
    model, opt = tt.reference_arch_trainer(seed=0, device="cpu")
    for mod in model.modules():
        if isinstance(mod, (trc.Conv, trc.SepConv)):
            mod.dtype = torch.float32
    frozen = {id(p) for p in trc.frozen_parameters(model)}
    assert len(frozen) == 2 * len(trc._BN_CH)
    assert not frozen & {id(p) for g in opt.param_groups
                         for p in g["params"]}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, got = tt.train_detect_cnn(batches, model=model, optimizer=opt,
                                 device="cpu")
    assert len(got) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=REF_LOSS_RTOL)
    for n, p in model.named_parameters():
        if id(p) in frozen:
            assert torch.equal(p, before[n]), n
        else:
            assert not torch.equal(p, before[n]), n


def test_detect_cnn_first_loss_matches_jax():
    """The DetectCNN from the JAX ``default_params`` (via
    ``params_from_flax``): the first step's loss, taken before any update,
    within the bf16 spread of the two models, and a finite second loss."""
    import flax
    from dnascent_tpu.models import cnn as jcnn
    from dnascent_tpu.pipeline import traincnn as jt
    from dnascent_tpu_torch.models import cnn as tcnn
    from dnascent_tpu_torch.pipeline import traincnn as tt

    batches = _random_batches(2, seed=1)
    jparams = jcnn.default_params()
    _, want = jt.train_detect_cnn(batches[:1], model=jcnn.create_model(),
                                  params=jparams)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(jparams),
                                           sep="/")
    model = tcnn.params_from_flax(tcnn.DetectCNN(),
                                  {k: np.asarray(v) for k, v in flat.items()})
    _, got = tt.train_detect_cnn(batches, model=model, device="cpu")
    assert abs(got[0] - want[0]) <= DETECT_LOSS_ATOL, (got[0], want[0])
    assert np.isfinite(got[1]) and got[1] != got[0]


@pytest.mark.parametrize("arch", ["tpu", "reference"])
def test_save_params_round_trip(arch, tmp_path):
    """Port -> npz -> the JAX ``load_params`` -> the JAX ``save_params`` ->
    the port: equal keys, equal arrays, equal weights, and the JAX model
    applies them.  The JAX's own npz (default or seeded weights) reads into
    the port and writes back key for key, array for array."""
    import jax.numpy as jnp
    from dnascent_tpu.models import cnn as jcnn
    from dnascent_tpu.models import reference_cnn as rc
    from dnascent_tpu_torch.models import cnn as tcnn
    from dnascent_tpu_torch.models import reference_cnn as trc
    from dnascent_tpu_torch.pipeline.traincnn import save_model

    if arch == "tpu":
        model = tcnn.init_untrained(tcnn.DetectCNN(), seed=3)
        load = lambda flat: tcnn.params_from_flax(tcnn.DetectCNN(), flat)
        jax_model, jax_params = jcnn.create_model(), jcnn.default_params()
    else:
        tensors = trc.seed_affine(trc.synthetic_tensors(2), 12)
        model = trc.params_from_tensors(trc.ReferenceDetectCNN(), tensors)
        load = lambda flat: trc.params_from_tree(trc.ReferenceDetectCNN(),
                                                 flat)
        jax_model = rc.create_model()
        jax_params = rc.params_from_tensors(rc.synthetic_tensors(2))

    def read(path):
        with np.load(path) as d:
            return {k: d[k] for k in d.files}

    ours = str(tmp_path / "port.npz")
    save_model(model, ours)
    loaded = jcnn.load_params(ours)
    theirs = str(tmp_path / "jax.npz")
    jcnn.save_params(loaded, theirs)
    a, b = read(ours), read(theirs)
    assert a.keys() == b.keys() and len(a) == (58 if arch == "tpu" else 268)
    for k in a:
        assert a[k].dtype == np.float32 and np.array_equal(a[k], b[k]), k
    back = load(b)
    for (na, pa), (nb, pb) in zip(model.named_parameters(),
                                  back.named_parameters()):
        assert na == nb and torch.equal(pa, pb), na
    core = jnp.ones((1, 64), jnp.int32)
    probs = jax_model.apply(loaded, core, core,
                            jnp.zeros((1, 64, 20), jnp.float32))
    assert probs.shape == (1, 64, 3)

    jax_npz = str(tmp_path / "jax_own.npz")
    jcnn.save_params(jax_params, jax_npz)
    again = str(tmp_path / "port_again.npz")
    save_model(load(read(jax_npz)), again)
    c, d = read(jax_npz), read(again)
    assert c.keys() == d.keys()
    for k in c:
        assert np.array_equal(c[k], d[k]), k


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory, models):
    d = tmp_path_factory.mktemp("torch_fit")
    return build_dataset(str(d), models, n_reads=2, read_length=1200,
                         signal_format="fast5", seed=3)


@pytest.mark.parametrize("arch", ["tpu", "reference"])
def test_cli_fit_then_detect(arch, small_dataset, tmp_path, monkeypatch,
                             capsys):
    """``trainCNN --fit out.npz --fit-label BrdU --fit-arch <arch> --device
    cpu`` writes its tables and an npz in the JAX layout; the port's and the
    JAX package's ``detect --cnn-weights out.npz`` both run on it.  Without
    ``--fit-label`` it refuses."""
    from dnascent_tpu import cli as jcli
    from dnascent_tpu.models import cnn as jcnn
    from dnascent_tpu_torch import cli

    ds = small_dataset
    monkeypatch.setenv("DNASCENT_TPU_MODELS", "/nonexistent")
    io = ["-b", ds.bam, "-r", ds.reference_fa, "-i", ds.index]
    weights = str(tmp_path / "jax_default.npz")
    jcnn.save_params(jcnn.default_params(), weights)
    fit = str(tmp_path / f"fit_{arch}.npz")
    train = ["trainCNN", *io, "-o", str(tmp_path / "t.trainCNN"), "-l",
             "100", "--device", "cpu", "--cnn-weights", weights, "--fit",
             fit]
    assert cli.main(train) == 1
    assert "--fit requires --fit-label" in capsys.readouterr().err
    assert cli.main(train + ["--fit-label", "BrdU", "--fit-arch", arch]) == 0
    out = capsys.readouterr().out
    assert "trainCNN: 2 reads written" in out
    assert f"trainCNN fit [{arch}]: 1 steps, loss " in out
    with np.load(fit) as d:
        assert ("gru0/kernel" in d.files) == (arch == "reference")
        assert all(np.isfinite(d[k]).all() for k in d.files)
    with open(str(tmp_path / "t.trainCNN")) as fh:
        assert sum(line.startswith(">") for line in fh) == 2
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        det = str(tmp_path / f"{name}.detect")
        assert main(["detect", *io, "-o", det, "-l", "1000",
                     "--cnn-weights", fit, *extra]) == 0, name
        with open(det) as fh:
            rows = [line.split("\t") for line in fh
                    if line[:1] not in "#>"]
        probs = np.array([[float(r[1]), float(r[2])] for r in rows])
        assert probs.size and ((probs >= 0) & (probs <= 1)).all(), name
