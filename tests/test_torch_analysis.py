"""PyTorch port, the flow after detect on the CPU: forkSense, seeBreaks and
dnascent2bedgraph against the JAX package's modules, CLIs and goldens.

The inputs are the synthetic fork reads of tests/test_forksense.py (12 right
and 12 left forks), which tests/test_golden_outputs.py also feeds the JAX CLI to
write the forkSense and seeBreaks goldens; no CNN runs, so every output must
be exact.  The CLIs run in subprocesses with their working directory set,
because forkSense writes its bed files there.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from dnascent_tpu.config import DNA_R10
from dnascent_tpu.pipeline import forksense as jfs
from tests.test_forksense import _synthetic_read
from tests.test_golden_outputs import GOLDEN_DIR, _normalize

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS_FLAGS = ["--order", "EdU,BrdU", "--markForks", "--markAnalogues",
            "--markOrigins", "--markTerminations"]
FS_BEDS = ["rightForks_DNAscent_forkSense.bed",
           "leftForks_DNAscent_forkSense.bed", "BrdU_DNAscent_forkSense.bed",
           "EdU_DNAscent_forkSense.bed", "origins_DNAscent_forkSense.bed",
           "terminations_DNAscent_forkSense.bed"]


def _run(pkg, args, cwd):
    """``python -m <pkg> <args>`` in ``cwd``; returns its stdout."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-m", pkg, *args], cwd=cwd,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return res.stdout


def _jax_reads():
    return ([_synthetic_read(seed=i, tracks=[(1000, 2200, "E"),
                                             (2300, 3500, "B")],
                             read_id=f"rf-{i}") for i in range(12)]
            + [_synthetic_read(seed=100 + i, tracks=[(4000, 5200, "B"),
                                                     (5300, 6500, "E")],
                               read_id=f"lf-{i}") for i in range(12)])


def _port_reads():
    from dnascent_tpu_torch.testing.forks import fork_reads
    return fork_reads(12, 12)


def _stages(fsm, reads):
    """Every intermediate of forkSense on ``reads`` through one package's
    module, as plain Python values."""
    fs = DNA_R10.forksense
    out = {"call_fractions": [], "dbscan": [], "segments": [], "forks": [],
           "origins_terminations": [], "stalls": []}
    bs, es = [], []
    for r in reads:
        b, e = fsm.call_fractions_read(r.coords, r.edu, r.brdu, fs)
        bs.append(b)
        es.append(e)
        out["call_fractions"].append((b.tolist(), e.tolist()))
    inc = fsm.estimate_analogue_incorporation(np.concatenate(bs),
                                              np.concatenate(es), fs)
    out["two_means"] = [dataclasses.asdict(inc), dataclasses.asdict(
        fsm.two_means(np.concatenate(bs), fs))]
    segs = lambda lst: [dataclasses.astuple(s) for s in lst]
    for r in reads:
        labs = fsm.run_dbscan(r, inc, fs)
        out["dbscan"].append([lab.tolist() for lab in labs])
        fsm.call_segmentation(r, *labs, fs)
        out["segments"].append((segs(r.edu_segments), segs(r.brdu_segments)))
        fsm.call_forks(r, "EdU,BrdU", fs)
        out["forks"].append((segs(r.left_forks), segs(r.right_forks)))
        fsm.call_origins(r)
        fsm.call_terminations(r)
        out["origins_terminations"].append((segs(r.origins),
                                            segs(r.terminations)))
        fsm.call_stalls(r, "EdU,BrdU", fs)
        out["stalls"].append([f.score for f in r.left_forks + r.right_forks])
    return out


@pytest.fixture(scope="module")
def stages():
    from dnascent_tpu_torch.pipeline import forksense as tfs
    return _stages(jfs, _jax_reads()), _stages(tfs, _port_reads())


@pytest.mark.parametrize("stage", ["call_fractions", "two_means", "dbscan",
                                   "segments", "forks",
                                   "origins_terminations", "stalls"])
def test_forksense_stages_equal(stages, stage):
    """Call fractions, the 2-means, DBSCAN labels, segments, forks with
    their stress signatures, origins and terminations, and stall scores:
    exact."""
    want, got = (s[stage] for s in stages)
    assert got == want
    if stage == "forks":
        assert sum(len(l) + len(r) for l, r in got) >= 20


@pytest.fixture(scope="module")
def fork_run(tmp_path_factory):
    """The port's ``forkSense`` then ``seeBreaks`` (parity mode) on the
    synthetic fork set, as tests/test_golden_outputs.py runs the JAX CLI."""
    from dnascent_tpu_torch.testing.forks import write_detect_file
    d = str(tmp_path_factory.mktemp("torch_forks"))
    detect = os.path.join(d, "synthetic.detect")
    write_detect_file(_port_reads(), detect)
    _run("dnascent_tpu_torch", ["forkSense", "-d", detect, "-o",
                                os.path.join(d, "out.forkSense"), *FS_FLAGS],
         d)
    _run("dnascent_tpu_torch",
         ["seeBreaks", "-r", os.path.join(d, FS_BEDS[0]), "-a",
          os.path.join(d, FS_BEDS[2]), "-d", detect, "-o",
          os.path.join(d, "out.seeBreaks")], d)
    return d


@pytest.mark.parametrize("name", ["out.forkSense", *FS_BEDS, "out.seeBreaks"])
def test_forksense_seebreaks_cli_match_goldens(fork_run, name):
    with open(os.path.join(fork_run, name)) as fh:
        got = _normalize(fh.read())
    with open(os.path.join(GOLDEN_DIR, f"fixture.{name}")) as fh:
        assert got == fh.read()


def test_forksense_headers(fork_run):
    """forkSense runs on the host in both packages: the port says so."""
    with open(os.path.join(fork_run, "out.forkSense")) as fh:
        head = [line for line in fh if line.startswith("#")]
    assert "#Compute CPU\n" in head
    assert "#Software dnascent_tpu_torch\n" in head


def test_seebreaks_fast_cpu_equals_jax(fork_run, tmp_path):
    """``seeBreaks --fast --device cpu`` runs the numpy bootstrap, as the
    JAX package's ``--fast`` does on the CPU: equal output."""
    args = ["seeBreaks", "-r", os.path.join(fork_run, FS_BEDS[0]), "-l",
            os.path.join(fork_run, FS_BEDS[1]), "-a",
            os.path.join(fork_run, FS_BEDS[2]), "-d",
            os.path.join(fork_run, "synthetic.detect"), "--fast"]
    outs = []
    for pkg, extra in (("dnascent_tpu", []),
                       ("dnascent_tpu_torch", ["--device", "cpu"])):
        out = str(tmp_path / f"{pkg}.seeBreaks")
        _run(pkg, [*args, "-o", out, *extra], str(tmp_path))
        with open(out) as fh:
            outs.append(_normalize(fh.read()))
    assert outs[0] == outs[1] and "#nForks 24\n" in outs[0]


def _write_modbam(reads, path):
    """The fork reads as a modbam file: all-M records starting one base
    before the first call, every third read reverse (its calls stored in
    sequencing order, as detect writes them)."""
    from dnascent_tpu_torch.io import bam
    from dnascent_tpu_torch.io.modbam import build_modbam_tags
    rng = np.random.default_rng(3)
    length = 16002
    w = bam.BamWriter(path, "@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:chr1\t"
                      "LN:40000\n", ["chr1"], [40000])
    for i, r in enumerate(reads):
        rev = i % 3 == 1
        start = int(r.coords[0]) - 1
        rec = bam.build_record(
            r.read_id, 0, start, 60, [(bam.BAM_CMATCH, length)],
            "".join(rng.choice(list("ACGT"), length)),
            flag=bam.FLAG_REVERSE if rev else 0)
        if rev:   # the reader maps query q to coord = refEnd - q
            q, edu, brdu = start + length - r.coords[::-1], r.edu[::-1], \
                r.brdu[::-1]
        else:
            q, edu, brdu = r.coords - start, r.edu, r.brdu
        w.write_record(rec.with_tags_replaced(
            ["MM", "ML"], build_modbam_tags(q, edu, brdu)))
    w.close()


def test_forksense_on_modbam_equals_jax(tmp_path):
    """forkSense on a ``.bam`` (the query-span branch): the JAX CLI and the
    port's give equal outputs, stress signatures included."""
    bam_path = str(tmp_path / "forks.bam")
    _write_modbam(_port_reads(), bam_path)
    outs = []
    for pkg in ("dnascent_tpu", "dnascent_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        _run(pkg, ["forkSense", "-d", bam_path, "-o", str(d / "out.fs"),
                   *FS_FLAGS, "--makeSignatures"], str(d))
        outs.append({f: _normalize((d / f).read_text())
                     for f in sorted(os.listdir(d))})
    assert outs[0] == outs[1] and len(outs[0]) == 9
    spans = {line.split()[7] for line in
             outs[0]["rightForks_DNAscent_forkSense.bed"].splitlines()}
    assert spans - {"-1"}, "no query spans on the modbam branch"
    assert any(" rev " in line for line in
               outs[0]["leftForks_DNAscent_forkSense.bed"].splitlines())


def test_seebreaks_bootstrap_matches_numpy_in_distribution():
    """The torch bootstrap of ``--fast`` on the card, run here with a CPU
    generator, against the JAX package's numpy bootstrap: the asserts of
    its device-bootstrap test."""
    from dnascent_tpu.pipeline import seebreaks as jsb
    from dnascent_tpu_torch.pipeline import seebreaks as sb
    rng = np.random.default_rng(7)
    n_reads, n_forks, iters = 200, 150, 4000
    v5 = rng.integers(0, 100000, n_reads).astype(np.int64)
    v3 = v5 + rng.integers(40000, 90000, n_reads)
    track_lengths = rng.integers(2000, 9000, 300).astype(np.int64)
    runoffs = rng.random(n_forks) < 0.3
    fsb, tol = 2000, 300

    sim_np = jsb.simulation_fast(v5, v3, track_lengths, n_forks, iters, 5,
                                 fsb, tol)
    obs_np = jsb.observation_fast(runoffs, iters, 5)
    sim_dv, obs_dv = sb.bootstrap_fast_device(
        v5, v3, track_lengths, runoffs, iters, 5, fsb, tol, "cpu")

    assert sim_dv.shape == (iters,) and obs_dv.shape == (iters,)
    assert sim_dv.dtype == obs_dv.dtype == np.float32
    se_sim = sim_np.std(ddof=1) / np.sqrt(iters)
    assert abs(sim_dv.mean() - sim_np.mean()) < 5 * se_sim + 1e-3
    se_obs = obs_np.std(ddof=1) / np.sqrt(iters)
    assert abs(obs_dv.mean() - obs_np.mean()) < 5 * se_obs + 1e-3
    assert abs(sim_dv.std() - sim_np.std()) < 0.15 * max(sim_np.std(), 1e-3)
    assert abs(obs_dv.std() - obs_np.std()) < 0.15 * max(obs_np.std(), 1e-3)


def test_seebreaks_fast_needs_its_device(fork_run, tmp_path, monkeypatch):
    """``--fast`` on ``cuda`` without CUDA raises (no CPU fallback); parity
    mode never touches the device."""
    import torch
    from dnascent_tpu_torch import cli
    from dnascent_tpu_torch.pipeline import seebreaks as sb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sb, "bootstrap_fast_device", None)
    args = ["seeBreaks", "-r", os.path.join(fork_run, FS_BEDS[0]), "-a",
            os.path.join(fork_run, FS_BEDS[2]), "-d",
            os.path.join(fork_run, "synthetic.detect")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args + ["-o", str(tmp_path / "x.seeBreaks"), "--fast"])
    assert not list(tmp_path.iterdir())
    out = str(tmp_path / "parity.seeBreaks")
    assert cli.main(args + ["-o", out, "--device", "cuda"]) == 0
    with open(out) as fh, open(os.path.join(fork_run, "out.seeBreaks")) as g:
        assert _normalize(fh.read()) == _normalize(g.read())


def test_seebreaks_parity_needs_native(fork_run, tmp_path, monkeypatch):
    """Parity mode without the native library raises with its build error
    and writes nothing; only ``--fast`` keeps a numpy path on the CPU."""
    from dnascent_tpu_torch import cli, native
    monkeypatch.setattr(native, "_load", lambda: None)
    monkeypatch.setattr(native, "_load_error", OSError("g++ failed"))
    args = ["seeBreaks", "-r", os.path.join(fork_run, FS_BEDS[0]), "-a",
            os.path.join(fork_run, FS_BEDS[2]), "-d",
            os.path.join(fork_run, "synthetic.detect")]
    with pytest.raises(RuntimeError, match="dnascent_native unavailable: "
                                           "g\\+\\+ failed"):
        cli.main(args + ["-o", str(tmp_path / "parity.seeBreaks")])
    assert not list(tmp_path.iterdir())
    out = tmp_path / "fast.seeBreaks"
    assert cli.main(args + ["-o", str(out), "--fast", "--device", "cpu"]) == 0
    assert "#nForks 12\n" in out.read_text()


def test_varied_fork_reads_equal_jax(tmp_path):
    """forkSense then seeBreaks (parity mode) on fork reads of varied span,
    a quarter with a BrdU track at the read end its fork moves towards (the
    input chip_smoke.py's phase 6 feeds the card): the JAX CLI and the
    port's give equal outputs, with non-zero expected and observed read-end
    fractions."""
    from dnascent_tpu_torch.testing.forks import (varied_fork_reads,
                                                  write_detect_file)
    detect = str(tmp_path / "varied.detect")
    write_detect_file(varied_fork_reads(24, 24, seed=0), detect)
    outs = []
    for pkg in ("dnascent_tpu", "dnascent_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        _run(pkg, ["forkSense", "-d", detect, "-o", str(d / "out.forkSense"),
                   *FS_FLAGS], str(d))
        _run(pkg, ["seeBreaks", "-r", str(d / FS_BEDS[0]), "-l",
                   str(d / FS_BEDS[1]), "-a", str(d / FS_BEDS[2]), "-d",
                   detect, "-o", str(d / "out.seeBreaks")], str(d))
        outs.append({f: _normalize((d / f).read_text())
                     for f in sorted(os.listdir(d))})
    assert outs[0] == outs[1] and len(outs[0]) == 8
    head = dict(line[1:].split(" ", 1) for line in
                outs[0]["out.seeBreaks"].splitlines() if line.startswith("#"))
    assert head["nForks"] == "48"
    assert float(head["ExpectedReadEndFraction"]) > 0
    assert float(head["ObservedReadEndFraction"]) > 0


@pytest.mark.parametrize("kind", ["detect", "forkSense"])
def test_bedgraph_equals_jax(tmp_path, kind):
    """dnascent2bedgraph on a ``.detect`` file and on a forkSense output
    (the goldens): every file the JAX tool writes, equal."""
    from dnascent_tpu.tools import bedgraph as jbg
    src = os.path.join(GOLDEN_DIR, "fixture.detect" if kind == "detect"
                       else "fixture.out.forkSense")
    flag = "-d" if kind == "detect" else "-f"
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert jbg.main([flag, src, "-o", str(jax_dir), "--filesPerDir", "2"]) == 0
    _run("dnascent_tpu_torch.tools.bedgraph",
         [flag, src, "-o", str(port_dir), "--filesPerDir", "2"],
         str(tmp_path))

    def files(root):
        return {os.path.relpath(os.path.join(dp, f), root):
                open(os.path.join(dp, f)).read()
                for dp, _, fs in os.walk(root) for f in fs}
    want = files(jax_dir)
    assert files(port_dir) == want and len(want) >= 4
