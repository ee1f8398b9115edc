"""The port's root scripts on the CPU: ``bench_torch.py`` (the counterpart
of ``bench.py``) end to end at a tiny size with jax and the JAX package
blocked from import, its host-step wrapping, its CPU baseline, and
``dnascent_tpu_torch/graft_entry.py`` (the counterpart of
``__graft_entry__.py``) against the JAX entry's shapes."""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.poremodel import synthetic_model_set
from dnascent_tpu_torch.ops import cuda_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
import bench_torch  # noqa: E402

BLOCKED = ("jax", "jaxlib", "flax", "optax", "dnascent_tpu")
# installed as sitecustomize in every process of the run, the spawned
# baseline worker included: any import of jax or the JAX package fails
_SITECUSTOMIZE = r"""
import sys
BLOCKED = %r
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
""" % (BLOCKED,)
# the keys of BENCH_r05.json's record, and the port's own
KEYS = ("metric", "value", "unit", "eventalign_mode", "vs_baseline",
        "baseline_reads_per_s", "baseline_kind", "baseline_parts",
        "qc_fail_rate", "stage_breakdown_unpipelined", "secondary", "mixed",
        "bench_wall_s", "min", "max", "best", "device", "power_limit_w",
        "torch", "cuda", "pipeline_depth", "depth_sweep", "peak_device_mb",
        "device_profile", "transfer_mb", "transfer_note", "launches", "gate")


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    """``bench_torch.py --device cpu`` run once at a tiny size, jax and the
    JAX package blocked in it and in its baseline worker, ``HOME`` (so the
    baseline cache) in a temporary directory: (process result, ``HOME``)."""
    home = tmp_path_factory.mktemp("bench_home")
    site = home / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    path = [str(site), ROOT] + [p for p in os.environ.get(
        "PYTHONPATH", "").split(os.pathsep) if p]
    env = dict(os.environ, HOME=str(home), OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(path),
               BENCH_READS="4", BENCH_READ_LEN="2000", BENCH_REPS="1",
               BENCH_LONG_READS="0", BENCH_MIXED_READS="4")
    for var in ("BENCH_BASELINE", "BENCH_DEPTH", "BENCH_DEPTHS",
                "BENCH_BATCH", "BENCH_BUDGET_S"):
        env.pop(var, None)
    res = subprocess.run([sys.executable, "bench_torch.py", "--device",
                          "cpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    return res, home


def test_bench_runs_end_to_end_without_jax(bench_run):
    """The tiny run: two JSON lines (the headline, then the record), the
    record with every key, the gate passed, a positive value, the host
    steps timed and the sweep over depths 1, 4 and 10."""
    res, home = bench_run
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [l for l in res.stdout.splitlines() if l.startswith("{")]
    assert len(lines) == 2, res.stdout[-3000:]
    head, out = (json.loads(line) for line in lines)
    assert head["value"] == out["value"]
    missing = [k for k in KEYS if k not in out]
    assert not missing, missing
    assert out["metric"] == "detect_reads_per_s" and out["value"] > 0
    assert out["min"] <= out["value"] <= out["max"] == out["best"]
    assert out["gate"]["passed"] and out["gate"]["reads"] == 4
    assert out["gate"]["max_prob_diff"] <= out["gate"]["tol"]
    assert sorted(out["depth_sweep"], key=int) == ["1", "4", "10"]
    assert out["depth_sweep"]["10"]["median"] == out["value"]
    assert out["transfer_mb"] is None and out["transfer_note"]
    # a CPU run reports no device reading
    assert out["device"] == "cpu" and out["peak_device_mb"] is None
    assert out["device_profile"] is None and out["power_limit_w"] is None
    assert set(out["launches"]) == set(cuda_lib.launch_counters())
    assert out["secondary"] is None and out["secondary_skipped"]
    stages = out["stage_breakdown_unpipelined"]
    assert {"prep_s", "eventalign_s", "cnn_s"} <= set(stages)
    steps = stages["host_steps"]
    assert steps and set(steps) == {s for s, *_ in bench_torch.HOST_STEPS}
    assert all(v["calls"] > 0 and v["s"] >= 0 for v in steps.values())
    mixed = out["mixed"]
    assert mixed["n_reads"] == 4 and mixed["reads_per_s"] > 0
    assert mixed["kbp_per_s"] > 0
    parts = out["baseline_parts"]
    assert "oracle_hotpath_per_read_s" not in parts
    assert parts["gru_encoder_twin_s"] > 0
    assert parts["gru_encoder_library_s"] > 0
    cache = home / ".cache" / "dnascent_tpu_torch_bench.json"
    assert cache.exists()
    with open(bench_torch.PARTIAL) as fh:
        assert json.loads(fh.read()) == out


def _bench_model():
    from dnascent_tpu_torch.models import reference_cnn
    return reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(),
        reference_cnn.synthetic_tensors(0)).eval()


def test_host_step_timers_leave_results_alone():
    """A serial pass with the host steps wrapped gives the unwrapped pass's
    calls exactly, every step is timed, and every wrapped attribute is the
    original object again afterwards."""
    from dnascent_tpu_torch import native
    from dnascent_tpu_torch.ops import scaling
    from dnascent_tpu_torch.pipeline import detect, eventalign, prep
    from dnascent_tpu_torch.pipeline.source import SimulatedSource

    torch.set_num_threads(2)
    mods = dict(prep=prep, scaling=scaling, native=native,
                eventalign=eventalign, detect=detect)
    orig = {(m, a): getattr(mods[m], a) for _, m, a in bench_torch.HOST_STEPS}
    pms = synthetic_model_set(DNA_R10)
    records = list(SimulatedSource(pms, DNA_R10, n_reads=2, length=1200,
                                   seed=11))
    model = _bench_model()
    cpu = torch.device("cpu")
    _, plain = bench_torch.serial_pass(records, pms, model, DNA_R10, cpu, 2)
    with bench_torch.host_step_timers() as totals:
        assert all(getattr(mods[m], a) is not f
                   for (m, a), f in orig.items())
        stages, timed = bench_torch.serial_pass(records, pms, model, DNA_R10,
                                                cpu, 2)
    assert all(getattr(mods[m], a) is f for (m, a), f in orig.items())
    assert set(totals) == {s for s, *_ in bench_torch.HOST_STEPS}
    assert all(n > 0 for _, n in totals.values())
    assert all(v > 0 for v in stages.values())
    assert list(plain) == list(timed) and len(plain) == 2
    for rid, a in plain.items():
        b = timed[rid]
        for f in ("ref_coords", "kmer_starts", "brdu_prob", "edu_prob",
                  "query_indices"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f"{rid} {f}")


def test_baseline_at_tiny_size(bench_run, monkeypatch):
    """The tiny run's CPU baseline (8 reads of 2 kb, measured in its spawned
    worker): finite per-read seconds, both GRU encoder timings, the faster
    one charged, x48, the record's baseline parts taken from it, and the
    cached result returned by the next call in this process, keyed by this
    host, its cores, the length and the sources' hash (no new worker)."""
    res, home = bench_run
    assert res.returncode == 0, res.stderr[-3000:]
    with open(home / ".cache" / "dnascent_tpu_torch_bench.json") as fh:
        cache = json.load(fh)
    assert len(cache) == 1
    (key, b), = cache.items()
    for k in ("cpp_hotpath_per_read_s", "cnn_f32_1core_per_read_s",
              "gru_encoder_twin_s", "gru_encoder_library_s",
              "per_core_s_per_read", "baseline_reads_per_s"):
        assert np.isfinite(b[k]) and b[k] > 0, k
    charged = min(b["gru_encoder_twin_s"], b["gru_encoder_library_s"])
    assert b["cnn_f32_1core_per_read_s"] == pytest.approx(
        b["cnn_forward_with_gru_twin_s"] - b["gru_encoder_twin_s"] + charged)
    assert b["baseline_reads_per_s"] == pytest.approx(
        bench_torch.BASELINE_THREADS / b["per_core_s_per_read"])
    assert b["host_cores"] == os.cpu_count() and b["read_len"] == 2000
    assert b["reads"] == 8 and b["key"] == key
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["baseline_reads_per_s"] == b["baseline_reads_per_s"]
    assert all(out["baseline_parts"][k] == b[k] for k in out["baseline_parts"])

    def no_worker(*args, **kwargs):
        raise AssertionError("the cached baseline was measured again")

    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setattr(bench_torch.mp, "get_context", no_worker)
    assert bench_torch.measure_baseline(2000) == b


def test_graft_entry_matches_jax_entry():
    """``entry(device="cpu")`` gives the JAX ``entry()``'s inputs and a
    finite output of its shape; ``dryrun_multichip(2, device="cpu")``
    passes both of its checks; by default it runs on the card, and asking
    for more cards than are visible raises."""
    from dnascent_tpu_torch import graft_entry

    spec = importlib.util.spec_from_file_location(
        "jax_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    jge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jge)
    jfn, jargs = jge.entry()
    jshape = jax.eval_shape(jfn, *jargs).shape

    torch.set_num_threads(2)
    fn, args = graft_entry.entry(device="cpu")
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    out = fn(*args)
    assert tuple(out.shape) == jshape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, rtol=1e-5)

    assert graft_entry.dryrun_multichip(2, device="cpu") is None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises((RuntimeError, ValueError)):
        graft_entry.dryrun_multichip(n + 1)  # the card by default
