"""PyTorch port, multi-device and multi-process runs on the CPU
(``dnascent_tpu_torch/parallel``, the ``--devices``/``--nprocs``/
``--procid``/``--coordinator`` flags): each function against itself on one
device or process, and against the JAX package's where it has the same one.

Two CPU "devices" are two replicas on the CPU (``--devices 2 --device
cpu``); a batch runs whole on one of them, so N devices must equal one
byte for byte.  The process tests run gloo groups on localhost, at a port
found free by binding port 0.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from dnascent_tpu.parallel import collectives as jcoll
from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.poremodel import synthetic_model_set
from dnascent_tpu_torch.parallel import collectives as tcoll, mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWO = ["cpu", "cpu"]
FS_FLAGS = ["--order", "EdU,BrdU", "--markForks", "--markAnalogues"]
# the DetectCNN config of __graft_entry__.py:68-70 (the JAX multi-chip
# train step's), and of tests/test_parallel.py:13-14 (its sharded apply)
TRAIN_CNN = dict(d_model=64, d_core=16, d_residual=8, d_signal=16,
                 dilations=(1, 2))
APPLY_CNN = dict(d_model=32, d_core=8, d_residual=8, d_signal=8,
                 dilations=(1, 2))
# one AdamW step (lr 1e-3) with f32 convolutions, 2 replicas against 1 and
# against the JAX step on its 4 x 2 CPU mesh: the loss within f32 rounding
# of the sum order (equal to 7 digits); a parameter moves by about
# lr * sign(gradient), so where f32 rounding moves a small gradient the
# update moves too: measured max 1.7e-7 against one replica (the replicas'
# summed gradients) and 1.08e-5 against the JAX step (one replica alone
# differs from it as much: the two models' f32 gradients)
LOSS_ATOL, PARAM_ATOL_REPLICAS, PARAM_ATOL_JAX = 1e-6, 1e-6, 5e-5
# the sharded apply against the JAX sharded apply, bf16 convolutions: the
# JAX test's own tolerance (tests/test_parallel.py:29); measured max 3.8e-3
# absolute, within it
APPLY_RTOL, APPLY_ATOL = 2e-2, 2e-3
# the sharded apply against the unsharded one in f32 (the halo makes it
# exact up to the convolutions' rounding at another length): measured 0,
# as in bf16
APPLY_F32_ATOL = 1e-6


@pytest.fixture(scope="module")
def port_models():
    return synthetic_model_set(DNA_R10)


@pytest.fixture(scope="module")
def records(port_models):
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    torch.set_num_threads(2)
    return list(SimulatedSource(port_models, DNA_R10, n_reads=6,
                                length=1500, seed=7))


def _detect(records, pms, device):
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.pipeline.detect import detect_reads
    model = cnn.init_untrained(cnn.DetectCNN(**APPLY_CNN))
    out = {}
    for rid, d in detect_reads(records, pms, model, DNA_R10, device=device,
                               batch_size=3, collect_failures=True):
        out[rid] = None if d is None else [
            getattr(d, f) for f in ("ref_coords", "brdu_prob", "edu_prob",
                                    "kmer_starts", "query_indices")]
    return out


def _hmm(records, pms, device):
    from dnascent_tpu_torch.pipeline.hmm_detect import hmm_detect_reads
    return dict(hmm_detect_reads(records, pms, DNA_R10, device=device,
                                 batch_size=3))


def _align(records, pms, device):
    from dnascent_tpu_torch.pipeline.align import align_reads
    return dict(align_reads(records, pms, DNA_R10, device=device,
                            batch_size=3))


@pytest.mark.parametrize("run", [_detect, _hmm, _align],
                         ids=["detect", "hmm", "align"])
def test_two_devices_bitwise_equal_one(run, records, port_models,
                                       monkeypatch):
    """detect, ``--HMM`` and strict align on two CPU devices (batch i on
    device i mod 2) give one device's output: the same reads in the same
    order, every array and text equal."""
    from dnascent_tpu_torch.pipeline import hmm_detect
    # many small --HMM batches in flight only contend for the interpreter
    monkeypatch.setattr(hmm_detect, "PIPELINE_DEPTH", 1)
    one = run(records, port_models, "cpu")
    two = run(records, port_models, TWO)
    assert list(one) == list(two) and len(one) == 6
    assert sum(v is not None for v in one.values()) >= 5
    for rid, a in one.items():
        b = two[rid]
        if isinstance(a, list):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y, err_msg=rid)
        else:
            assert a == b, rid


def test_device_set_rules():
    """``--devices``: N CPU replicas; ``all`` one on the CPU; N above the
    visible CUDA devices an error, as is a non-positive or non-numeric
    count."""
    from dnascent_tpu_torch.parallel.compute import (as_devices, device_set,
                                                     per_device)
    cpu = torch.device("cpu")
    assert device_set(None, "cpu") == [cpu]
    assert device_set("3", "cpu") == [cpu] * 3
    assert device_set("all", "cpu") == [cpu]
    assert as_devices(TWO) == as_devices(tuple(TWO)) == [cpu] * 2
    assert as_devices("cpu") == [cpu]
    assert per_device(as_devices(TWO), str) == {cpu: "cpu"}
    with pytest.raises(ValueError, match="at least one"):
        as_devices([])
    for bad in ("0", "-1", "two"):
        with pytest.raises(ValueError, match="positive count"):
            device_set(bad, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            device_set("2", "cuda")
    else:
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match="CUDA device"):
            device_set(str(n + 1), "cuda")


def test_gather_ordered_and_window_keys_equal_jax():
    """With one process: the stable reorder by permuted keys, 1-D and 2-D
    rows, and the composite window keys, equal to the JAX functions."""
    rng = np.random.default_rng(3)
    keys = rng.permutation(50).astype(np.int64) * 7
    for values in (rng.normal(size=50), rng.integers(0, 99, (50, 2))):
        got = tcoll.gather_ordered(values, keys)
        np.testing.assert_array_equal(got, jcoll.gather_ordered(values, keys))
        np.testing.assert_array_equal(got, values[np.argsort(keys)])
    ordinals = rng.permutation(9)
    counts = rng.integers(0, 5, 9)
    np.testing.assert_array_equal(tcoll.window_keys(ordinals, counts),
                                  jcoll.window_keys(ordinals, counts))
    assert tcoll.window_keys([], []).dtype == np.int64


def _fork_reads(pkg):
    if pkg == "jax":
        from tests.test_forksense import _synthetic_read
        make = lambda seed, tracks, rid: _synthetic_read(  # noqa: E731
            seed=seed, tracks=tracks, read_id=rid)
    else:
        from dnascent_tpu_torch.testing.forks import synthetic_read
        make = lambda seed, tracks, rid: synthetic_read(  # noqa: E731
            seed, tracks=tracks, read_id=rid)
    return [make(i, [(1000, 2200, "E"), (2300, 3500, "B")], f"r{i}")
            for i in range(8)]


def test_forksense_permuted_ordinals_equal_single_and_jax():
    """forksense_run over a permuted shard with its global ordinals
    reassembles pass 1's fraction vectors in global order: the same
    2-means as the unsharded run, and the JAX package's with the same
    ordinals (tests/test_collectives.py:33-47); pass 2's blocks equal the
    JAX's read for read."""
    import dataclasses
    from dnascent_tpu.config import DNA_R10 as JAX_R10
    from dnascent_tpu.pipeline.forksense import forksense_run as jrun
    from dnascent_tpu_torch.pipeline.forksense import forksense_run as trun

    perm = [3, 0, 6, 1, 7, 4, 2, 5]
    reads, jreads = _fork_reads("port"), _fork_reads("jax")
    inc_single, _ = trun(reads, "EdU,BrdU", DNA_R10)
    inc_perm, out_perm = trun([reads[i] for i in perm], "EdU,BrdU", DNA_R10,
                              read_ordinals=perm)
    jinc, jout = jrun([jreads[i] for i in perm], "EdU,BrdU", JAX_R10,
                      read_ordinals=perm)
    assert inc_perm == inc_single
    assert dataclasses.asdict(inc_perm) == dataclasses.asdict(jinc)
    assert [o.main for o in out_perm] == [o.main for o in jout]
    assert any(o.main for o in out_perm)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# one process of a two-process group; imports only the port
_WORKER = r"""
import os, sys
pid, port_fs, port_sb, detect, outdir = sys.argv[1:6]
os.chdir(outdir)
from dnascent_tpu_torch import cli
group = lambda port: ["--coordinator", f"localhost:{port}", "--nprocs", "2",
                      "--procid", pid]
rc = cli.main(["forkSense", "-d", detect, "-o", "sharded.forkSense",
               "--order", "EdU,BrdU", "--markForks", "--markAnalogues",
               *group(port_fs)])
if rc == 0:
    rc = cli.main(["seeBreaks", "-r", sys.argv[6], "-a", sys.argv[7],
                   "-d", detect, "-o", "sharded.seeBreaks", *group(port_sb)])
sys.exit(rc)
"""


def test_forksense_and_seebreaks_two_process_gloo(tmp_path, monkeypatch):
    """forkSense then seeBreaks in two cooperating processes (a gloo group
    on localhost): the merged forkSense output carries the single run's
    ``#EstimatedRegion`` lines, blocks and beds, and seeBreaks (spans
    gathered in read order) the single run's output, as
    tests/test_collectives.py:69-139 holds the JAX CLI."""
    from dnascent_tpu_torch import cli
    from dnascent_tpu_torch.testing.forks import fork_reads, write_detect_file

    detect = str(tmp_path / "synthetic.detect")
    write_detect_file(fork_reads(12, 12), detect)
    single, shard = tmp_path / "single", tmp_path / "sharded"
    single.mkdir()
    shard.mkdir()
    monkeypatch.chdir(single)
    assert cli.main(["forkSense", "-d", detect, "-o", "single.forkSense",
                     *FS_FLAGS]) == 0
    beds = [str(single / n) for n in ("rightForks_DNAscent_forkSense.bed",
                                      "BrdU_DNAscent_forkSense.bed")]
    assert cli.main(["seeBreaks", "-r", beds[0], "-a", beds[1], "-d", detect,
                     "-o", "single.seeBreaks"]) == 0

    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    env.pop("RANK", None)
    ports = [str(_free_port()), str(_free_port())]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(k), *ports, detect, str(shard),
         *beds], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for k in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]

    def lines(path, keep):
        with open(path) as fh:
            return [l for l in fh if keep(l)]

    est = lambda l: l.startswith("#EstimatedRegion")  # noqa: E731
    body = lambda l: not l.startswith("#")  # noqa: E731
    merged, one = shard / "sharded.forkSense", single / "single.forkSense"
    assert lines(merged, est) == lines(one, est) and len(lines(one, est)) == 2
    assert sorted(lines(merged, body)) == sorted(lines(one, body))
    assert len(lines(one, body)) > 1000
    for bed in ("rightForks", "leftForks", "BrdU", "EdU"):
        name = f"{bed}_DNAscent_forkSense.bed"
        # the merge sorts the rows by (contig, start, end, read)
        assert (sorted(lines(shard / name, body))
                == sorted(lines(single / name, body))), name
    assert lines(shard / "rightForks_DNAscent_forkSense.bed", body)
    stat = lambda l: not l.startswith("#SystemStartTime")  # noqa: E731
    assert (lines(shard / "sharded.seeBreaks", stat)
            == lines(single / "single.seeBreaks", stat))
    assert not (shard / "sharded.seeBreaks.host1").exists()


@pytest.fixture(scope="module")
def cli_dataset(tmp_path_factory):
    """A 4-read fast5 dataset (the JAX package's writer) and the JAX
    package's default DetectCNN weights, exported as
    tests/test_torch_pipeline.py does."""
    from dnascent_tpu.io.poremodel import synthetic_model_set as jax_models
    from dnascent_tpu.models import cnn as jcnn
    from dnascent_tpu.testing.dataset import build_dataset
    from dnascent_tpu.config import DNA_R10 as JAX_R10
    d = tmp_path_factory.mktemp("torch_parallel_cli")
    ds = build_dataset(str(d / "ds"), jax_models(JAX_R10), n_reads=4,
                       read_length=1200, signal_format="fast5", seed=3)
    weights = str(d / "jax_default.npz")
    jcnn.save_params(jcnn.default_params(), weights)
    return ds, weights


def _body(path):
    with open(path) as fh:
        return [l for l in fh.read().splitlines() if l and l[0] != "#"]


@pytest.mark.parametrize("sub", ["detect", "align"])
def test_cli_sharded_runs_merge_to_single(sub, cli_dataset, tmp_path,
                                          monkeypatch):
    """``--nprocs 2 --procid k`` without a coordinator: two shard runs,
    the second merging the set, equal the single run put through the same
    merge (tests/test_cli.py:271-320); shard 0 runs last."""
    from dnascent_tpu_torch import cli
    from dnascent_tpu_torch.parallel.merge import merge_host_outputs
    ds, weights = cli_dataset
    monkeypatch.setenv("DNASCENT_TPU_MODELS", "/nonexistent")
    torch.set_num_threads(2)
    ext = {"detect": ("detect", ["-l", "1000", "--cnn-weights", weights]),
           "align": ("align", ["-l", "100", "--fast-windows"])}[sub]
    base = [sub, "-b", ds.bam, "-r", ds.reference_fa, "-i", ds.index,
            "--device", "cpu", *ext[1]]
    single = str(tmp_path / f"single.{ext[0]}")
    assert cli.main(base + ["-o", single]) == 0
    merged = str(tmp_path / f"merged.{ext[0]}")
    for k in ("1", "0"):
        assert cli.main(base + ["-o", merged, "--nprocs", "2",
                                "--procid", k]) == 0
        assert os.path.exists(f"{merged}.host{k}")
        assert os.path.exists(merged) == (k == "0")
    canon = str(tmp_path / f"canon.{ext[0]}")
    merge_host_outputs([single], canon)
    assert _body(merged) == _body(canon)
    assert len(_body(merged)) > 500
    assert _body(f"{merged}.host0") and _body(f"{merged}.host1")


def test_cli_detect_two_devices_byte_equal(cli_dataset, tmp_path,
                                           monkeypatch):
    """``detect --devices 2 --device cpu`` writes the file that ``detect
    --device cpu`` writes, byte for byte but the start time."""
    from dnascent_tpu_torch import cli
    ds, weights = cli_dataset
    monkeypatch.setenv("DNASCENT_TPU_MODELS", "/nonexistent")
    torch.set_num_threads(2)
    base = ["detect", "-b", ds.bam, "-r", ds.reference_fa, "-i", ds.index,
            "-l", "1000", "--device", "cpu", "--cnn-weights", weights]
    texts = []
    for extra in ([], ["--devices", "2"]):
        out = str(tmp_path / f"d{len(extra)}.detect")
        assert cli.main(base + ["-o", out, *extra]) == 0
        with open(out) as fh:
            texts.append([l for l in fh
                          if not l.startswith("#SystemStartTime")])
    assert texts[0] == texts[1]
    assert sum(l.startswith(">") for l in texts[0]) == 4


def _jax_f32(monkeypatch, jcnn):
    """The JAX DetectCNN with its bf16 layers in f32: its module reads
    ``jnp.bfloat16`` when it traces."""
    import jax.numpy as jnp

    class F32Jnp:
        def __getattr__(self, name):
            return jnp.float32 if name == "bfloat16" else getattr(jnp, name)

    monkeypatch.setattr(jcnn, "jnp", F32Jnp())


def _port_f32(monkeypatch, model):
    """The port's DetectCNN with its bf16 layers in f32."""
    from dnascent_tpu_torch.models import cnn as tcnn
    monkeypatch.setattr(tcnn, "_BF16", torch.float32)
    for m in model.modules():
        if isinstance(m, tcnn.Dense):
            m.dtype = torch.float32
    return model


def _port_from_jax(params, **kw):
    import flax
    from dnascent_tpu_torch.models import cnn as tcnn
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(params),
                                           sep="/")
    return tcnn.params_from_flax(tcnn.DetectCNN(**kw),
                                 {k: np.asarray(v) for k, v in flat.items()})


def test_data_parallel_train_step_matches_one_replica_and_jax(monkeypatch):
    """One AdamW step of the DetectCNN (f32 convolutions) with the batch's
    rows split over two CPU replicas, against one replica and against the
    JAX ``data_parallel_train_step`` on its 4 x 2 CPU mesh, from the same
    weights and batch (__graft_entry__.py:63-90): losses within LOSS_ATOL,
    every parameter within PARAM_ATOL."""
    import jax
    import optax
    from dnascent_tpu.models import cnn as jcnn
    from dnascent_tpu.parallel import mesh as jmesh
    from dnascent_tpu_torch.models import cnn as tcnn
    from dnascent_tpu_torch.pipeline.traincnn import make_optimizer

    torch.set_num_threads(2)
    _jax_f32(monkeypatch, jcnn)
    jmodel = jcnn.create_model(**TRAIN_CNN)
    jparams = jcnn.default_params(jmodel, seed=0)
    B, L = 8, 128
    rng = np.random.default_rng(0)
    batch = {
        "core": rng.integers(1, 1025, size=(B, L)).astype(np.int32),
        "residual": rng.integers(1, 257, size=(B, L)).astype(np.int32),
        "signal": rng.normal(0, 1, size=(B, L, jcnn.RAWDEPTH)
                             ).astype(np.float32),
        "labels": rng.integers(0, 3, size=(B, L)).astype(np.int32),
        "mask": rng.random((B, L)) < 0.9,
    }
    mesh = jmesh.make_mesh(n_data=4, n_seq=2, devices=jax.devices()[:8])
    opt = optax.adamw(1e-3)
    step = jmesh.data_parallel_train_step(jmodel, opt, mesh)
    jnew, _, jloss = step(jmesh.replicate(mesh, jparams),
                          jmesh.replicate(mesh, opt.init(jparams)), batch)
    want = _port_from_jax(jnew, **TRAIN_CNN)

    start = dict(_port_from_jax(jparams, **TRAIN_CNN).named_parameters())
    want = dict(want.named_parameters())
    got = {}
    for devices in (["cpu"], TWO):
        model = _port_f32(monkeypatch, _port_from_jax(jparams, **TRAIN_CNN))
        step = tmesh.data_parallel_train_step(
            model, make_optimizer(model.parameters(), 1e-3), devices)
        got[len(devices)] = (float(step(batch)),
                             dict(model.named_parameters()))
    assert abs(got[2][0] - got[1][0]) <= LOSS_ATOL
    assert abs(got[2][0] - float(jloss)) <= LOSS_ATOL
    for name, p in got[2][1].items():
        p = p.detach()
        np.testing.assert_allclose(p, got[1][1][name].detach(), rtol=0,
                                   atol=PARAM_ATOL_REPLICAS, err_msg=name)
        np.testing.assert_allclose(p, want[name].detach(), rtol=0,
                                   atol=PARAM_ATOL_JAX, err_msg=name)
        assert not torch.equal(p, start[name]), name


def _apply_inputs():
    from dnascent_tpu.models import cnn as jcnn
    rng = np.random.default_rng(0)
    B, L = 8, 128
    return (rng.integers(1, 1025, size=(B, L)).astype(np.int32),
            rng.integers(1, 257, size=(B, L)).astype(np.int32),
            rng.normal(0, 1, size=(B, L, jcnn.RAWDEPTH)).astype(np.float32))


def test_sequence_sharded_apply_matches_unsharded_and_jax(monkeypatch):
    """The DetectCNN over positions split in two (halo = half the receptive
    field), against the JAX ``sequence_sharded_apply`` on its 4 x 2 mesh in
    bf16 (tests/test_parallel.py:9-29, its tolerance), and against the
    port's unsharded forward in f32 within APPLY_F32_ATOL."""
    import jax
    import jax.numpy as jnp
    from dnascent_tpu.models import cnn as jcnn
    from dnascent_tpu.parallel import mesh as jmesh

    torch.set_num_threads(2)
    core, resid, sig = _apply_inputs()
    jmodel = jcnn.create_model(**APPLY_CNN)
    jparams = jcnn.default_params(jmodel)
    mesh = jmesh.make_mesh(n_data=4, n_seq=2, devices=jax.devices()[:8])
    want = np.asarray(jmesh.sequence_sharded_apply(jmodel, mesh)(
        jparams, jnp.asarray(core), jnp.asarray(resid), jnp.asarray(sig)))
    t = [torch.from_numpy(a) for a in (core, resid, sig)]
    model = _port_from_jax(jparams, **APPLY_CNN).eval()
    assert model.receptive_field() // 2 == 6
    with torch.no_grad():
        got = tmesh.sequence_sharded_apply(model, TWO)(*t).numpy()
        np.testing.assert_allclose(got, want, rtol=APPLY_RTOL,
                                   atol=APPLY_ATOL)
        model = _port_f32(monkeypatch, model)
        whole = model(*t).numpy()
        for halo in (None, 20):
            got = tmesh.sequence_sharded_apply(model, TWO, halo)(*t).numpy()
            assert got.shape == (8, 128, 3)
            np.testing.assert_allclose(got, whole, rtol=0,
                                       atol=APPLY_F32_ATOL)
        # a halo short of the receptive field is not exact at the cut
        got = tmesh.sequence_sharded_apply(model, TWO, 1)(*t).numpy()
        assert np.abs(got - whole).max() > 1e-3


def test_shard_files_for_host_equal_jax():
    from dnascent_tpu.parallel.mesh import shard_files_for_host as jshard
    files = [f"f{i}" for i in range(10)]
    parts = [tmesh.shard_files_for_host(files, k, 3) for k in range(3)]
    assert parts == [jshard(files, k, 3) for k in range(3)]
    assert sorted(sum(parts, [])) == sorted(files)
    assert tmesh.shard_files_for_host(files) == sorted(files)


def test_coordinator_without_procid_or_rank_is_an_error(monkeypatch):
    """``--coordinator`` takes the process index from ``--procid`` or, as
    torch's launchers set it, ``RANK``; without either the run refuses
    before it contacts anything."""
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="--procid"):
        tmesh.init_distributed("localhost:1", 2, None)
    with pytest.raises(ValueError, match="outside"):
        tmesh.init_distributed("localhost:1", 2, 2)
    assert tmesh.init_distributed(None, 1, None) == 0
    assert tcoll.process_count() == 1
