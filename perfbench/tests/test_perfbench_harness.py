"""The harness end to end on the CPU at a tiny size (the look for a card
skipped): the result line's schema, a cell added from new files only, the
control and the planted faults each coming out not correct, and the
refusal to run without a card."""

import json
import os
import re
import subprocess
import sys
import time

import pytest

from conftest import ROOT
from perfbench import run as R

SECONDS = 20.0
SEED = 2**31 + 17
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _run(root, cell, trace=False, **kw):
    return R.run_cell(R.load_cell(cell, root), SEED, SECONDS, trace, "cpu",
                      t0=time.perf_counter(), **kw)


def test_benchmark_json_keeps_the_contract():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs
        assert os.path.exists(os.path.join(ROOT, "perfbench", "traffic",
                                           w["traffic"] + ".json"))
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cells.add(w["name"])
    names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert os.path.exists(os.path.join(ROOT, "perfbench", "metrics",
                                           m["name"] + ".py"))
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] == "detect_kbp_per_s"
        assert "workloads" in m
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_result_line_schema(tiny_root):
    out = _run(tiny_root, "v4.10kb")
    assert out["correct"] is True
    assert out["attempted"] > 0
    assert set(out["metrics"]) == {"detect_kbp_per_s", "setup_s"}
    assert out["metrics"]["detect_kbp_per_s"]["unit"] == "kbp/s"
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    keys = [k for k in out if k != "_extra"]
    assert keys[-1] == "checks"
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps({k: out[k] for k in keys})


@pytest.fixture(scope="module")
def w128_root(tiny_root, tmp_path_factory):
    """A copy of the tiny registry with the DetectCNN configuration's two
    cells, kept for later: ``cnn128.10kb`` (the memory mix) and
    ``cnn128.pod5`` (pod5 and BAM in, modbam out, with the source and
    writer spans among its per-layer metrics)."""
    import shutil
    root = str(tmp_path_factory.mktemp("w128") / "root")
    shutil.copytree(tiny_root, root)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    b["configs"].append({"name": "detectcnn_w128", "source": "test",
                         "file": "perfbench/configs/detectcnn_w128.json",
                         "reduced": [], "why": "test"})
    for name, traffic in (("cnn128.10kb", "memory_10kb"),
                          ("cnn128.pod5", "pod5_10kb")):
        b["workloads"].append({"name": name, "config": "detectcnn_w128",
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for m in b["per_layer"]:
        if m["name"] != "roofline.gru_encoder":
            m["workloads"] += ["cnn128.10kb", "cnn128.pod5"]
    for name in ("source_ms_per_read", "writer_ms_per_read"):
        b["per_layer"].append({"name": name, "unit": "ms/read",
                               "better": "lower", "source": "program_span",
                               "layer": "test", "moves": "detect_kbp_per_s",
                               "workloads": ["cnn128.pod5"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(b, fh)
    return root


def test_traced_run_reads_spans_and_no_device_metric_on_the_cpu(w128_root):
    out = _run(w128_root, "cnn128.pod5", trace=True)
    m = out["metrics"]
    for name in ("source_ms_per_read", "writer_ms_per_read",
                 "prep_ms_per_kbp", "event_detection_ms_per_kbp",
                 "eventalign_ms_per_kbp", "postprocess_ms_per_kbp",
                 "cnn_ms_per_kbp"):
        assert m[name]["value"] > 0, name
    # no device trace on the CPU: no roofline, utilisation or device memory
    for name in m:
        assert "roofline" not in name and "mfu" not in name
        assert name not in ("device_idle_share", "peak_device_mib")
    assert out["correct"] is True


def test_a_cell_from_new_files_only(tiny_root, tmp_path):
    """A later change adds a configuration, a traffic mix and a metric as
    files and entries; the harness finds them by name."""
    import shutil
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    pb = os.path.join(root, "perfbench")
    shutil.copy(os.path.join(pb, "configs", "detectcnn_w128.json"),
                os.path.join(pb, "configs", "detectcnn_w64.json"))
    with open(os.path.join(pb, "configs", "detectcnn_w64.json")) as fh:
        conf = json.load(fh)
    conf["architecture"]["d_model"] = 64
    with open(os.path.join(pb, "configs", "detectcnn_w64.json"), "w") as fh:
        json.dump(conf, fh)
    with open(os.path.join(pb, "traffic", "memory_10kb.json")) as fh:
        traffic = json.load(fh)
    traffic["lengths"] = {"kind": "fixed", "bp": 1600}
    with open(os.path.join(pb, "traffic", "memory_1600bp.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(pb, "metrics", "reads_attempted.py"), "w") as fh:
        fh.write("def read(run):\n    return float(run.attempted)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    b["configs"].append({"name": "detectcnn_w64", "source": "test",
                         "file": "perfbench/configs/detectcnn_w64.json",
                         "reduced": ["d_model"], "why": "test"})
    b["workloads"].append({"name": "w64.short", "config": "detectcnn_w64",
                           "traffic": "memory_1600bp", "chips": 1,
                           "why": "test"})
    b["end_to_end"].append({"name": "reads_attempted", "unit": "reads",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["w64.short"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(b, fh)
    cell = R.load_cell("w64.short", root)
    assert cell.config["architecture"]["d_model"] == 64
    out = _run(root, "w64.short")
    assert out["metrics"]["reads_attempted"]["value"] == out["attempted"] > 0
    assert out["correct"] is True


def test_cold_build_flag_and_the_rate_closed_at_the_last_drain(tmp_path):
    """A checkout without the built libraries is a cold build; the rate is
    the drained kbp over the time to the last drain, never a 0."""
    root = str(tmp_path)
    assert R.cold_build(root)
    for d, lib in ((R.CACHE_DIRS[0], "libdnascent_kernels_0123.so"),
                   (R.CACHE_DIRS[1], "libdnascent_native.so")):
        os.makedirs(os.path.join(root, d))
        open(os.path.join(root, d, lib), "w").close()
    assert not R.cold_build(root)
    run = R.Run(cell=None, seconds=51.0, kbp=900.0, rate_s=45.0)
    assert R.reader(ROOT, "detect_kbp_per_s")(run) == 20.0
    assert R.reader(ROOT, "detect_kbp_per_s")(R.Run(cell=None)) is None
    load = R._host_load(R._host_sample(), R._host_sample())
    assert load["own_cores"] >= 0 and 0 <= load["steal_share"] <= 1


@pytest.mark.parametrize("cell", ["v4.10kb", "cnn128.10kb"])
def test_control_is_not_correct(w128_root, cell):
    out = _run(w128_root, cell, control=True)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def _drop_half(orig):
    """Half of each batch's reads lose their CNN output (they come back
    as failed), the rest as computed."""
    def broken(model, results, prepped, device, *a, **k):
        probs = orig(model, results, prepped, device, *a, **k)
        for rid in sorted(probs)[::2]:
            del probs[rid]
        return probs
    return broken


def _swap_calls(orig):
    """Each read's calls altered where they are made: BrdU and EdU
    swapped."""
    def broken(rec, pos, probs_t):
        return orig(rec, pos, probs_t[:, ::-1].copy())
    return broken


@pytest.mark.parametrize("fault", [
    {"dnascent_tpu_torch.pipeline.detect.run_cnn_batched": _drop_half},
    {"dnascent_tpu_torch.pipeline.detect.collect_calls": _swap_calls},
], ids=["half_the_batch_left_out", "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, fault):
    import dnascent_tpu_torch.pipeline.detect  # noqa: F401  (patch target)
    out = _run(tiny_root, "v4.10kb", faults=fault)
    assert out["correct"] is False


def test_no_card_no_result():
    """Without a CUDA device the harness exits non-zero and prints no
    result (this CPU host has none; on a card the test skips)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "v4.10kb", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


@pytest.mark.gpu
def test_tiny_cell_on_the_card(tiny_root, cuda_device):
    out = R.run_cell(R.load_cell("v4.10kb", tiny_root), SEED, SECONDS,
                     False, cuda_device, t0=time.perf_counter())
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"


def test_printed_numbers_are_shown_not_compared():
    from perfbench import check
    numbers = {"call_gap_mean": 0.01, "call_gap_p99": 0.5, "sites": 9}
    ok, shown = check.verdict(numbers, {"call_gap_mean": 0.02},
                              printed=["call_gap_p99"])
    assert ok and set(shown) == {"call_gap_mean"}
    with pytest.raises(KeyError):
        check.verdict(numbers, {"call_gap_mean": 0.02})
