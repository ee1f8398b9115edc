"""The port's CLI against ``tests/test_cli.py``: each of its 18 tests has a
counterpart that runs the port's CLI on the same inputs, with the same exit
codes and message substrings.  The dataset is the golden one
(``build_dataset(..., n_reads=4, read_length=1500, signal_format="fast5",
seed=11)``), here written by the port's own ``build_dataset``; the CNN is
the port's seeded untrained one (``--allow-untrained-cnn``: the JAX
package's ``PRNGKey(0)`` weights cannot be drawn in torch).

Counterparts in other files (same inputs unless said):
- ``test_cli_index``: ``test_torch_host.py::test_index_cli_equal``
  (index files equal the JAX CLI's);
- ``test_cli_detect_hr``: ``test_torch_pipeline.py::
  test_detect_cli_matches_golden`` (against ``fixture.detect``) and
  ``test_stage_times_and_resume`` here;
- ``test_cli_detect_modbam_roundtrip``: ``test_torch_modbam.py::
  test_detect_modbam_matches_golden``;
- ``test_cli_detect_hmm``: ``test_torch_hmm.py::test_cli_hmm_matches_golden``;
- ``test_cli_align_then_traingmm``: ``test_torch_traingmm.py::
  test_align_then_traingmm_matches_golden``;
- ``test_cli_traincnn``: ``test_torch_traincnn.py::
  test_traincnn_cli_matches_golden`` (with the JAX default weights);
- ``test_cli_forksense_and_seebreaks``: ``test_torch_analysis.py::
  test_forksense_seebreaks_cli_match_goldens`` (``forks.fork_reads(12,
  12)``, the reads that test builds);
- ``test_cli_detect_strict_windows``: ``test_torch_align.py::
  test_detect_strict_windows_cli_matches_jax_cli``.

The other ten are here.  The port's stated differences (ROADMAP section 3):
its ``--device`` flag, its help wording and program name, and its refusal
of a ``--model`` or ``--cnn-weights`` path that does not exist.
"""

import io
import os
import re
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

# the CLI's progress bar binds sys.stderr when its module is first
# imported: import it here, not under a test's capsys
import dnascent_tpu_torch.utils.progress  # noqa: F401
from dnascent_tpu import cli as jcli
from dnascent_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "flax", "optax", "dnascent_tpu")
ENV = dict(os.environ, DNASCENT_TPU_MODELS="/nonexistent",
           OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
# the subcommands whose port adds --device (its one flag the JAX CLI lacks)
DEVICE_FLAG = {"detect", "align", "trainCNN", "trainGMM", "seeBreaks"}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.poremodel import synthetic_model_set
    from dnascent_tpu_torch.testing.dataset import build_dataset
    d = tmp_path_factory.mktemp("torch_clids")
    return build_dataset(str(d), synthetic_model_set(DNA_R10), n_reads=4,
                         read_length=1500, signal_format="fast5", seed=11)


def _io(ds):
    return ["-b", ds.bam, "-r", ds.reference_fa, "-i", ds.index]


def _body(path):
    with open(path) as fh:
        return [line for line in fh.read().splitlines()
                if line and line[0] != "#"]


def _n_reads(text):
    return text.count("\n>") + text.startswith(">")


def test_cli_help(capsys):
    assert cli.main([]) == 0
    assert "The subprograms are:" in capsys.readouterr().out
    assert cli.main(["--version"]) == 0
    assert cli.main(["-v"]) == 0
    version = capsys.readouterr().out
    assert jcli.main(["--version"]) == 0
    assert capsys.readouterr().out == version.splitlines(True)[0]
    assert cli.main(["bogus"]) == 1
    assert "Unknown subprogram: bogus" in capsys.readouterr().err


def _flags(main, sub, capsys):
    """The option strings a subcommand's ``--help`` lists."""
    with pytest.raises(SystemExit) as e:
        main([sub, "--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    flags = set()
    for line in text.split("options:", 1)[1].splitlines():
        m = re.match(r"\s{2}(-\S.*?)(?:\s{2,}|$)", line)
        if m:
            flags |= {f.split()[0] for f in m.group(1).split(", ")}
    return flags


@pytest.mark.parametrize("sub", sorted(jcli.SUBCOMMANDS))
def test_cli_help_lists_the_jax_flags(sub, capsys):
    """Each subprogram's help lists every JAX flag; the port adds only
    ``--device``, and only where it has a device to place work on."""
    assert set(cli.SUBCOMMANDS) == set(jcli.SUBCOMMANDS)
    want = _flags(jcli.main, sub, capsys)
    got = _flags(cli.main, sub, capsys)
    assert "-h" in want and len(want) > 3
    assert want <= got
    assert got - want == ({"--device"} if sub in DEVICE_FLAG else set())


def test_cli_traincnn_fit_requires_label(dataset, tmp_path, capsys):
    msgs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        rc = main(["trainCNN", *_io(dataset),
                   "-o", str(tmp_path / "x"), "-l", "100",
                   "--allow-untrained-cnn",
                   "--fit", str(tmp_path / "w.npz"), *extra])
        assert rc == 1
        msgs.append(capsys.readouterr().err)
    assert msgs[0] == msgs[1] == (
        "Exiting with error.  --fit requires --fit-label.\n")
    assert not list(tmp_path.iterdir())


def test_cli_detect_refuses_untrained(dataset, tmp_path):
    """Without trained weights (and without the override flag) detect
    refuses with the JAX CLI's message, like the reference refuses without
    its SavedModel, and writes nothing."""
    msgs = []
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        out = str(tmp_path / f"{name}.detect")
        with pytest.raises(SystemExit) as e:
            main(["detect", *_io(dataset), "-o", out, "-l", "1000", *extra])
        msgs.append(str(e.value))
        assert not os.path.exists(out)
    assert msgs[0] == msgs[1]
    assert msgs[0].startswith("Exiting with error.  No trained CNN weights")


def test_count_records_matches_iteration(dataset):
    """count_records (the countRecords progress-bar pre-pass,
    htsInterface.cpp:15-30) equals the number of records the source
    yields, whole and sharded."""
    from dnascent_tpu_torch.io.fasta import import_reference
    from dnascent_tpu_torch.io.index_io import parse_index
    from dnascent_tpu_torch.pipeline.source import BamSignalSource
    ref = import_reference(dataset.reference_fa)
    idx = parse_index(dataset.index)
    src = BamSignalSource(dataset.bam, ref, idx, min_mapq=0, min_length=100)
    assert src.count_records() == len(list(src)) > 0
    half = BamSignalSource(dataset.bam, ref, idx, min_mapq=0, min_length=100,
                           shard=(0, 2))
    assert half.count_records() == len(list(half))


def test_progress_bar_renders():
    from dnascent_tpu.utils.progress import ProgressBar as JaxBar
    from dnascent_tpu_torch.utils.progress import ProgressBar
    texts = []
    for bar_cls in (ProgressBar, JaxBar):
        buf = io.StringIO()
        bar = bar_cls(10, width=10, stream=buf)
        bar.display(5, failed=2)
        bar.finish()
        texts.append(buf.getvalue())
    err = texts[0]
    assert "50.0%" in err and "5/10" in err and "failed: 2" in err
    assert "ETA" in err
    assert texts[0] == texts[1]


def test_load_cnn_selects_reference_topology_npz(tmp_path):
    """--cnn-weights npz written from reference-topology params (by the
    JAX package's ``save_params``) loads the reference model, not the
    default DetectCNN."""
    from dnascent_tpu.models import cnn as jcnn
    from dnascent_tpu.models import reference_cnn as jref
    from dnascent_tpu_torch.models import cnn as tcnn
    from dnascent_tpu_torch.models import reference_cnn as tref
    npz = str(tmp_path / "ref.npz")
    jcnn.save_params(jref.params_from_tensors(jref.synthetic_tensors(1)), npz)
    a = SimpleNamespace(model=None, cnn_weights=npz, allow_untrained_cnn=False)
    model = cli._load_cnn(a, "cpu")
    assert isinstance(model, tref.ReferenceDetectCNN)
    assert tuple(model.gru.kernel0.shape) == (1, 48)
    jcnn.save_params(jcnn.default_params(), npz)
    assert isinstance(cli._load_cnn(a, "cpu"), tcnn.DetectCNN)


def _run(args, **env):
    res = subprocess.run([sys.executable, "-m", "dnascent_tpu_torch", *args],
                         cwd=ROOT, env=dict(ENV, **env), capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


def test_stage_times_and_resume(dataset, tmp_path):
    """``detect`` as ``test_cli_detect_hr`` checks it; a ``--resume`` rerun
    skips every read and leaves the file as it was
    (``test_cli_detect_resume``); and ``DNASCENT_STAGE_TIMES=1`` prints the
    JAX package's three stage names under "stage wall-clock totals:" on
    stderr after the progress bar, then every span of the run as a tree
    by thread role, while the ``.detect`` body stays byte for byte what the
    run without it writes."""
    base = ["detect", *_io(dataset), "-l", "1000", "--device", "cpu",
            "--allow-untrained-cnn"]
    out = str(tmp_path / "out.detect")
    res = _run([*base, "-o", out])
    assert "stage wall-clock totals" not in res.stderr
    with open(out) as fh:
        text = fh.read()
    assert text.startswith("#Alignment")
    assert _n_reads(text) >= 3
    assert len([l for l in _body(out) if l[0] != ">"]) > 500
    assert os.path.exists(str(tmp_path / "out.detect.log"))

    res = _run([*base, "-o", out, "--resume"])
    assert f"skipping {_n_reads(text)} completed reads" in res.stderr
    with open(out) as fh:
        assert fh.read() == text

    timed = str(tmp_path / "timed.detect")
    res = _run([*base, "-o", timed], DNASCENT_STAGE_TIMES="1")
    assert _body(timed) == _body(out)
    head, report = res.stderr.split("stage wall-clock totals:\n")
    assert "100.0%" in head and "failed: 0" in head
    report, tree = report.split("spans (wall ms, thread-CPU ms, calls):\n")
    names = [line.split()[0] for line in report.splitlines()]
    assert sorted(names) == ["cnn_forward", "eventalign(viterbi)",
                             "prep(events+scaling+banded)"]
    for line in report.splitlines():
        assert re.fullmatch(r"  \S+ +[0-9.]+ ms \(1 calls\)", line), line
    tree = tree.split("\ndetect:")[0].splitlines()
    assert [ln for ln in tree if not ln.startswith(" ")] == [
        "main", "producer", "worker"]
    steps = {ln.split()[0]: ln for ln in tree if ln.startswith(" ")}
    for name in ("pipeline.drain_wait", "pipeline.source", "source.bam",
                 "batch", "prep.event_detection", "eventalign.postprocess",
                 "cnn.forward", "h2d", "readback", *names):
        assert name in steps, name
    for ln in tree:
        if ln.startswith(" "):
            assert re.fullmatch(r" +\S+ +[0-9.]+ +[0-9.]+ +[0-9]+", ln), ln


def test_cli_traincnn_fit_then_detect(dataset, tmp_path):
    """trainCNN --fit writes weights the detect CLI can consume."""
    out = str(tmp_path / "out.trainCNN")
    npz = str(tmp_path / "fitted.npz")
    assert cli.main(["trainCNN", *_io(dataset), "-o", out, "-l", "100",
                     "--device", "cpu", "--allow-untrained-cnn", "--fit",
                     npz, "--fit-label", "BrdU", "--fit-epochs", "2"]) == 0
    assert os.path.exists(npz)
    det = str(tmp_path / "fitted.detect")
    assert cli.main(["detect", *_io(dataset), "-o", det, "-l", "1000",
                     "--device", "cpu", "--cnn-weights", npz]) == 0
    rows = [l for l in open(det) if l and l[0] not in "#>"]
    assert len(rows) > 500


@pytest.mark.parametrize("sub, min_l, min_rows", [("align", "100", 5000),
                                                  ("detect", "1000", 500)])
def test_cli_sharded_matches_single(dataset, tmp_path, sub, min_l, min_rows):
    """``--nprocs 2``: two shard runs and the deterministic merge reproduce
    the single-process output byte for byte (but the timestamped header),
    for align and detect (``test_cli_align_sharded_matches_single``,
    ``test_cli_detect_sharded_matches_single``)."""
    from dnascent_tpu_torch.parallel.merge import merge_host_outputs
    args = [sub, *_io(dataset), "-l", min_l, "--device", "cpu"]
    if sub == "detect":
        args.append("--allow-untrained-cnn")
    single = str(tmp_path / f"single.{sub}")
    assert cli.main([*args, "-o", single]) == 0
    merged = str(tmp_path / f"merged.{sub}")
    for k in ("1", "0"):   # shard 0 last: it completes the set and merges
        assert cli.main([*args, "-o", merged, "--nprocs", "2",
                         "--procid", k]) == 0
        assert os.path.exists(merged + f".host{k}")
    assert os.path.exists(merged)
    canon = str(tmp_path / f"canon.{sub}")
    merge_host_outputs([single], canon)
    assert _body(merged) == _body(canon)
    assert len(_body(merged)) > min_rows


# the port alone: a meta-path hook refuses jax, flax, optax and the JAX
# package with every submodule (as tests/test_torch_import.py does); the
# port's build_dataset writes two 12 kb reads as pod5 (enough call windows
# for forkSense's 2-means), then detect and forkSense run through the CLI
_PORT_ONLY = r"""
import os, sys
BLOCKED = %r
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
from dnascent_tpu_torch import cli
from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.poremodel import synthetic_model_set
from dnascent_tpu_torch.testing.dataset import build_dataset
ds = build_dataset("ds", synthetic_model_set(DNA_R10), n_reads=2,
                   read_length=12000, signal_format="pod5", seed=11)
assert cli.main(["detect", "-b", ds.bam, "-r", ds.reference_fa, "-i",
                 ds.index, "-o", "port.detect", "--device", "cpu",
                 "--allow-untrained-cnn"]) == 0
assert cli.main(["forkSense", "-d", "port.detect", "-o", "port.forkSense",
                 "--order", "EdU,BrdU", "--markAnalogues"]) == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("PORT_ONLY_OK")
""" % (BLOCKED,)


def test_port_only_dataset_detect_forksense(tmp_path):
    res = subprocess.run([sys.executable, "-c", _PORT_ONLY], cwd=tmp_path,
                         env=ENV, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "PORT_ONLY_OK" in res.stdout
    with open(tmp_path / "port.detect") as fh:
        text = fh.read()
    assert _n_reads(text) == 2
    probs = np.array([[float(x) for x in l.split("\t")[1:3]]
                      for l in text.splitlines() if l[0] not in "#>"])
    assert probs.shape[0] > 4000 and ((probs >= 0) & (probs <= 1)).all()
    with open(tmp_path / "port.forkSense") as fh:
        fs = fh.read()
    assert "#EstimatedRegionBrdU" in fs and "#Software dnascent_tpu_torch" in fs
    assert (tmp_path / "BrdU_DNAscent_forkSense.bed").exists()
