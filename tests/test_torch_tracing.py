"""The port's span recorder (``dnascent_tpu_torch/utils/progress.py``):
the spans a small ``detect_reads`` run records on the CPU (names, parents,
batches, thread roles, stage totals), output equal with and without it,
and nothing recorded or read off a clock without it; the signal source's
spans; the benchmark's readings of spans (``perfbench/spans.py``) on
hand-built spans; and the span clock mapped onto the CPU profiler's."""

import time

import numpy as np
import pytest
import torch

from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.poremodel import synthetic_model_set
from dnascent_tpu_torch.utils import progress
from dnascent_tpu_torch.utils.progress import Span, StageTimer
from perfbench import spans as pspans

STAGES = ("prep(events+scaling+banded)", "eventalign(viterbi)",
          "cnn_forward")
PREP, ALIGN, CNN = STAGES
# each worker span detect records, with its parent's name
WORKER_PARENT = {
    "batch": None, PREP: "batch", ALIGN: "batch", CNN: "batch",
    "collect": "batch",
    "prep.event_detection": PREP, "prep.scaling": PREP,
    "prep.fill_build": PREP, "prep.banded_decode": PREP,
    "prep.theilsen": PREP,
    "eventalign.windows": ALIGN, "eventalign.viterbi": ALIGN,
    "eventalign.postprocess": ALIGN,
    "eventalign.window_build": "eventalign.windows",
    "prep.scale_build": "prep.scaling",
    "prep.decode_build": "prep.banded_decode",
    "cnn.pack": CNN, "cnn.forward": CNN,
}
# the device waits, and the steps they sit in
WAIT_PARENTS = {
    "h2d": {PREP, "prep.theilsen", "eventalign.windows",
            "eventalign.viterbi", CNN},
    "readback": {"prep.banded_decode", "prep.theilsen",
                 "eventalign.viterbi", CNN},
}
MAIN = {"pipeline.submit_wait", "pipeline.drain_wait"}
PRODUCER = {"pipeline.source", "pipeline.put_wait"}
N_READS, BATCH = 4, 2
FIELDS = ("ref_coords", "brdu_prob", "edu_prob", "kmer_starts",
          "query_indices", "edu_prob_q", "brdu_prob_q")


class _NoClock:
    """Stands in for the recorder's ``time`` module: reading a clock
    fails the test."""

    def __getattr__(self, name):
        raise AssertionError(f"the recorder read time.{name}")


def _no_span(*a, **k):
    raise AssertionError("a span was made with no recorder")


def _detect(timer):
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.pipeline.detect import detect_reads
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    pms = synthetic_model_set(DNA_R10)
    records = list(SimulatedSource(pms, DNA_R10, n_reads=N_READS,
                                   length=1500, seed=7))
    model = cnn.init_untrained(cnn.DetectCNN(
        d_model=32, d_core=8, d_residual=8, d_signal=8, dilations=(1, 2)))
    out = {}
    for rid, d in detect_reads(records, pms, model, DNA_R10, device="cpu",
                               batch_size=BATCH, collect_failures=True,
                               pipeline_depth=2, timer=timer):
        out[rid] = None if d is None else [getattr(d, f) for f in FIELDS]
    return out


@pytest.fixture(scope="module")
def runs():
    """(output with a recorder, the recorder, output without one, run with
    every clock read and span allocation of the recorder failing)."""
    torch.set_num_threads(2)
    timer = StageTimer()
    traced = _detect(timer)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(progress, "time", _NoClock())
        mp.setattr(progress, "_Open", _no_span)
        plain = _detect(None)
    return traced, timer, plain


def test_detect_records_every_step_under_its_parent(runs):
    _, timer, _ = runs
    spans = timer.spans()
    by_id = {s.sid: s for s in spans}
    names = {s.name for s in spans}
    assert set(WORKER_PARENT) | set(WAIT_PARENTS) | MAIN | PRODUCER <= names
    for s in spans:
        parent = by_id.get(s.parent)
        pname = None if parent is None else parent.name
        if s.name in WORKER_PARENT:
            assert s.role == "worker" and pname == WORKER_PARENT[s.name], s
        elif s.name in WAIT_PARENTS:
            assert s.wait and s.role == "worker", s
            assert pname in WAIT_PARENTS[s.name], (s, pname)
        elif s.name in MAIN:
            assert s.role == "main" and pname is None, s
        else:
            assert s.name in PRODUCER, s
            assert s.role == "producer" and pname is None, s
        assert s.wait == (s.name in WAIT_PARENTS)
        if parent is not None:
            # a child runs on its parent's thread, inside it, for its batch
            assert parent.tid == s.tid and parent.batch == s.batch
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
        assert s.t0 <= s.t1 and s.cpu0 <= s.cpu1
    # one batch number a batch, shared by its worker spans, each drained
    n_batches = N_READS // BATCH
    batches = [s for s in spans if s.name == "batch"]
    assert sorted(s.batch for s in batches) == list(range(n_batches))
    assert {s.batch for s in spans if s.role == "worker"} == set(
        range(n_batches))
    assert sorted(s.batch for s in spans
                  if s.name == "pipeline.drain_wait") == list(
        range(n_batches))
    assert sorted(s.batch for s in spans
                  if s.name == "pipeline.put_wait") == list(range(n_batches))
    # the three threads' roles, on three kinds of thread
    tids = {r: {s.tid for s in spans if s.role == r}
            for r in progress.ROLES}
    assert len(tids["main"]) == len(tids["producer"]) == 1
    assert 1 <= len(tids["worker"]) <= 2
    assert not tids["main"] & tids["producer"]
    assert not (tids["main"] | tids["producer"]) & tids["worker"]
    # a sid each
    assert len(by_id) == len(spans)


def test_stage_totals_are_the_sums_of_their_spans(runs):
    _, timer, _ = runs
    spans = timer.spans()
    assert set(timer.totals) == set(STAGES)
    for name in STAGES:
        mine = [s for s in spans if s.name == name]
        assert timer.counts[name] == len(mine) == N_READS // BATCH
        assert timer.totals[name] == sum(s.t1 - s.t0 for s in mine) / 1e9


def test_output_equal_with_and_without_a_recorder(runs):
    traced, _, plain = runs
    assert list(traced) == list(plain)
    assert all(v is not None for v in plain.values())
    for rid in plain:
        for a, b in zip(traced[rid], plain[rid]):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), rid


def test_window_sets_built_once_and_copied_once_a_fill_group():
    """Under a recorder, eventalign on a batch of 2 reads and on one of 8
    reads of one fill group: the native batch entry runs once a batch, in
    its own ``eventalign.window_build`` span under ``eventalign.windows``,
    and the ``h2d`` copies under ``eventalign.windows`` are 1 (the rank
    stream) plus 1 a fill group, whatever the number of reads."""
    from dnascent_tpu_torch.pipeline.eventalign import run_eventalign
    from dnascent_tpu_torch.pipeline.prep import prepare_reads
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    torch.set_num_threads(2)
    pms = synthetic_model_set(DNA_R10)
    records = list(SimulatedSource(pms, DNA_R10, n_reads=8, length=1500,
                                   seed=7))
    timer = StageTimer()
    for b, recs in enumerate((records[:2], records)):
        with timer.scope("worker"), timer.span("batch", batch=b):
            prepped = prepare_reads(recs, pms, DNA_R10, device="cpu")
            assert len({id(p.events_dev) for p in prepped}) == 1
            out = run_eventalign(prepped, pms, DNA_R10)
            assert len(out) == len(recs) and all(
                r.qc_passed for r in out.values())
    spans = timer.spans()
    by_id = {s.sid: s for s in spans}

    def under(name, parent):
        return [sum(s.name == name and by_id[s.parent].name == parent
                    and s.batch == b for s in spans) for b in (0, 1)]
    assert under("eventalign.window_build", "eventalign.windows") == [1, 1]
    assert under("h2d", "eventalign.windows") == [2, 2]


def test_prep_builds_once_a_batch_and_once_a_fill_group():
    """Under a recorder, prep on a batch of 2 reads and on one of 8 reads
    of one fill group, then on 2 reads of two fill groups (3 and 5 kb
    events apart): the native scaling call runs once a batch, in its own
    ``prep.scale_build`` span under ``prep.scaling``, and the decode call
    once a fill group, in ``prep.decode_build`` under
    ``prep.banded_decode``, whatever the number of reads."""
    from dnascent_tpu_torch.pipeline.prep import _fill_groups, prepare_reads
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    torch.set_num_threads(2)
    pms = synthetic_model_set(DNA_R10)
    records = list(SimulatedSource(pms, DNA_R10, n_reads=8, length=1500,
                                   seed=7))
    longer = list(SimulatedSource(pms, DNA_R10, n_reads=1, length=3000,
                                  seed=9))
    batches = (records[:2], records, records[:1] + longer)
    timer = StageTimer()
    groups = []
    for b, recs in enumerate(batches):
        with timer.scope("worker"), timer.span("batch", batch=b):
            prepped = prepare_reads(recs, pms, DNA_R10, device="cpu")
        assert len(prepped) == len(recs) and all(p.passed for p in prepped)
        groups.append(len(_fill_groups(prepped)))
    assert groups == [1, 1, 2]
    spans = timer.spans()
    by_id = {s.sid: s for s in spans}

    def under(name, parent):
        return [sum(s.name == name and by_id[s.parent].name == parent
                    and s.batch == b for s in spans)
                for b in range(len(batches))]
    assert under("prep.scale_build", "prep.scaling") == [1, 1, 1]
    assert under("prep.decode_build", "prep.banded_decode") == groups
    assert under("prep.fill_build", "batch") == groups


def test_no_recorder_records_nothing_and_reads_no_clock():
    """Off, a span site is the shared null context (the detect run without
    a recorder in the fixture ran with clock reads and span allocation
    failing); a recorder records only under its own scope."""
    assert progress.span("h2d", wait=True) is progress.NULL
    timer = StageTimer()
    with timer.scope("worker"):
        with progress.span("inner"):
            pass
    assert progress.span("after") is progress.NULL
    (s,) = timer.spans()
    assert (s.name, s.role, s.parent, s.batch) == ("inner", "worker", -1, -1)
    assert not timer.totals


def test_two_recorders_interleaved_keep_their_own_batches():
    """Two detect runs in one process, consumed in turns: each recorder
    holds its own run's batches only (no state is shared)."""
    from dnascent_tpu_torch.pipeline.detect import run_batches
    seen = []

    def process(batch, dev):
        with progress.span("work"):
            seen.append(batch[0])
        return batch
    timers = [StageTimer(), StageTimer()]
    gens = [run_batches(range(k * 100, k * 100 + 6), process, 2, 2,
                        [torch.device("cpu")], timer=t)
            for k, t in enumerate(timers)]
    for a, b in zip(*gens):
        assert a[0] // 100 == 0 and b[0] // 100 == 1
    for k, t in enumerate(timers):
        spans = t.spans()
        work = [s for s in spans if s.name == "work"]
        assert sorted(s.batch for s in work) == [0, 1, 2]
        assert {s.batch for s in spans if s.name == "batch"} == {0, 1, 2}
        # the fetch that finds the end counts toward the next batch
        assert sorted(s.batch for s in spans
                      if s.name == "pipeline.source") == [0, 0, 1, 1, 2, 2,
                                                          3]
    assert len(seen) == 6


def test_source_spans_under_the_producer(tmp_path):
    """``BamSignalSource`` over pod5 records its BAM and signal steps on a
    thread under a recorder, and yields the same records either way."""
    from dnascent_tpu_torch.io.fasta import import_reference
    from dnascent_tpu_torch.io.index_io import parse_index
    from dnascent_tpu_torch.io.pod5_io import HAVE_ZSTD
    from dnascent_tpu_torch.pipeline.source import BamSignalSource
    from dnascent_tpu_torch.testing.dataset import build_dataset
    if not HAVE_ZSTD:
        pytest.skip("pod5 needs pyarrow with its zstd codec")
    ds = build_dataset(str(tmp_path), synthetic_model_set(DNA_R10),
                       n_reads=2, read_length=1500, signal_format="pod5",
                       seed=3)
    src = BamSignalSource(ds.bam, import_reference(ds.reference_fa),
                          parse_index(ds.index), min_length=1000)
    plain = list(src)
    timer = StageTimer()
    with timer.scope("producer"):
        traced = []
        it = iter(src)
        while True:
            with timer.span("pipeline.source", batch=0):
                rec = next(it, None)
            if rec is None:
                break
            traced.append(rec)
    assert len(plain) == len(traced) == src.count_records() == 2
    for a, b in zip(plain, traced):
        assert a.read_id == b.read_id and np.array_equal(a.raw, b.raw)
        assert a.basecall == b.basecall
        assert np.array_equal(a.ref_to_query, b.ref_to_query)
    spans = timer.spans()
    by_id = {s.sid: s for s in spans}
    kids = [s for s in spans if s.name.startswith("source.")]
    assert sorted({s.name for s in kids}) == ["source.bam", "source.pod5"]
    assert sum(s.name == "source.pod5" for s in kids) == 2
    for s in kids:
        assert by_id[s.parent].name == "pipeline.source"
        assert s.role == "producer" and s.batch == 0


def test_tree_lists_every_span_under_its_parent(runs):
    import io
    _, timer, _ = runs
    buf = io.StringIO()
    timer.tree(buf)
    lines = buf.getvalue().splitlines()
    assert [ln for ln in lines if not ln.startswith(" ")] == list(
        progress.ROLES)
    rows = {}
    for ln in lines:
        if ln.startswith(" "):
            head, wall, cpu, calls = ln.rsplit(None, 3)
            rows.setdefault(head.strip(), []).append(
                (len(head) - len(head.lstrip()), float(wall), float(cpu),
                 int(calls)))
    ((depth, wall, _cpu, calls),) = rows["batch"]
    assert (depth, calls) == (2, N_READS // BATCH)
    assert wall == pytest.approx(sum((s.t1 - s.t0) / 1e6 for s in
                                     timer.spans() if s.name == "batch"),
                                 abs=0.051)
    assert [d for d, *_ in rows["prep.theilsen"]] == [6]
    assert {d for d, *_ in rows["h2d"]} >= {6, 8}


def _hand_spans():
    """Two workers (tid 1, 2) and the main thread (tid 9); times in ns on
    the host clock, window [0, 1000)."""
    S = Span
    return [
        S(0, -1, "batch", 1, "worker", 0, 100, 600, 0, 300, False),
        S(1, 0, "h2d", 1, "worker", 0, 200, 300, 0, 50, True),
        S(2, 0, "cnn.forward", 1, "worker", 0, 350, 550, 100, 200, False),
        S(3, 2, "readback", 1, "worker", 0, 400, 450, 150, 160, True),
        S(4, -1, "batch", 2, "worker", 1, -200, 300, 0, 400, False),
        S(5, 4, "readback", 2, "worker", 1, 0, 100, 0, 30, True),
        S(6, -1, "pipeline.drain_wait", 9, "main", 0, 0, 700, 0, 1, False),
    ]


def test_readers_on_hand_built_spans():
    sp = _hand_spans()
    # busy: 500 of worker 1, 300 of worker 2 (clipped at the window)
    assert pspans.worker_idle_share(sp, 0, 1000, 2) == pytest.approx(
        100 * (1 - 800 / 2000))
    # worker 1's batch alone starts inside; its waits (100 + 50 wall,
    # 50 + 10 CPU) left out: wall 350, CPU 240
    assert pspans.worker_offcpu_share(sp, 0, 1000) == pytest.approx(
        100 * (350 - 240) / 350)
    # waits 100 + 50 + 100 ns over 2 kbp
    assert pspans.device_wait_ms_per_kbp(sp, 2.0) == pytest.approx(
        250e-6 / 2)
    # cnn.forward 200 ns, its readback 50: self 150 ns over 2 kbp
    assert pspans.cnn_launch_ms_per_kbp(sp, 2.0) == pytest.approx(
        150e-6 / 2)
    st = pspans.steps(sp)
    assert st[("worker", "batch")]["self_s"] == pytest.approx(
        (500 - 100 - 200 + 500 - 100) / 1e9)
    assert st[("worker", "cnn.forward")]["self_cpu_s"] == pytest.approx(
        90 / 1e9)
    assert pspans.worker_idle_share(sp, 0, 0, 2) is None
    assert pspans.device_wait_ms_per_kbp(sp, 0.0) is None


def test_clock_gaps_and_device_time_on_hand_built_spans():
    sp = _hand_spans()
    shift = 10_000       # the profiler keeps the epoch; host = t - shift
    ops = [pspans.Op("k1", 10_120, 10_180, 1),
           pspans.Op("k2", 10_460, 10_480, 2),
           pspans.Op("k3", 10_500, 10_520, 99)]
    launches = [pspans.Launch(1, 10_110, 1), pspans.Launch(1, 10_420, 2),
                pspans.Launch(2, 10_050, 3)]
    c = pspans.clock(sp, ops, launches, 0, 1000, shift)
    assert (c["base"], c["shift_ns"]) == ("epoch", shift)
    assert c["check"]["share"] == 1.0 and c["check"]["holds"]
    c0 = pspans.clock(sp, ops, [], 0, 1000, shift)
    assert c0["check"]["kind"].startswith("device operations")
    assert c0["check"]["holds"]
    gaps = pspans.idle_gaps(ops)
    assert gaps == [(280, 10_180, 10_460), (20, 10_480, 10_500)]
    # at host 320 worker 1 is in its batch between steps, worker 2 has
    # ended its batch, the main thread waits on the drain
    assert pspans.gap_labels(sp, gaps, shift) == [
        ["batch+pipeline.drain_wait", 280e-9],
        ["cnn.forward+pipeline.drain_wait", 20e-9]]
    assert pspans.device_s_by_step(sp, ops, launches, shift) == {
        "batch": 60e-9, "readback": 20e-9, "unlinked": 20e-9}


def test_clock_maps_a_cpu_op_into_its_span():
    """On the CPU profiler: a matrix product run inside a program span
    lands inside that span under the mapping."""
    from torch.profiler import ProfilerActivity, profile
    timer = StageTimer()
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t_open = time.perf_counter_ns()
        epoch_minus_perf = time.time_ns() - time.perf_counter_ns()
        with timer.scope("worker"), timer.span("batch", batch=0):
            time.sleep(0.002)
            with progress.span("cnn.forward"):
                (x @ x).sum()
            time.sleep(0.002)
        t_stop = time.perf_counter_ns()
    ops, _ = pspans.profile_events(prof, "CPU")
    mm = [o for o in ops if o.name == "aten::mm"]
    assert len(mm) == 1
    c = pspans.clock(timer.spans(), ops, [], t_open, t_stop,
                     epoch_minus_perf)
    assert c["check"]["holds"], c
    (fwd,) = [s for s in timer.spans() if s.name == "cnn.forward"]
    t0, t1 = mm[0].t0 - c["shift_ns"], mm[0].t1 - c["shift_ns"]
    assert fwd.t0 <= t0 <= t1 <= fwd.t1, (fwd, t0, t1, c)


@pytest.mark.gpu
def test_card_syncs_only_inside_wait_spans():
    """One batch shaped as the benchmark's v4.10kb cell's (32 reads of
    10 kb, half reverse, the reference topology) at pipeline depth 1 under
    ``torch.cuda.set_sync_debug_mode("warn")``: every call of a worker that
    synchronises with the device lies inside one of its ``h2d`` or
    ``readback`` spans.  On a card only; the kernels are built and the
    shapes warmed on two reads first."""
    import collections
    import os
    import threading
    import warnings

    from dnascent_tpu_torch.models import reference_cnn as rc
    from dnascent_tpu_torch.pipeline.detect import detect_reads
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda:0")
    pms = synthetic_model_set(DNA_R10)
    recs = [*SimulatedSource(pms, DNA_R10, n_reads=16, length=10000,
                             seed=31),
            *SimulatedSource(pms, DNA_R10, n_reads=16, length=10000,
                             seed=47, reverse=True)]
    model = rc.params_from_tensors(
        rc.ReferenceDetectCNN(), rc.seed_affine(rc.synthetic_tensors(5),
                                                15)).to(dev)
    kw = dict(device=dev, batch_size=32, pipeline_depth=1)
    list(detect_reads(recs[:2], pms, model, DNA_R10, **kw))
    torch.cuda.synchronize()
    timer = StageTimer()
    hits = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            hits.append((threading.get_native_id(), time.perf_counter_ns(),
                         f"{os.path.relpath(filename)}:{lineno}"))
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            out = dict(detect_reads(recs, pms, model, DNA_R10, timer=timer,
                                    **kw))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(out) == 32 and all(d is not None for d in out.values())
    spans = timer.spans()
    th = pspans.Threads(spans)
    workers = set(th.roles("worker"))
    mine = [h for h in hits if h[0] in workers]
    outside = collections.Counter(
        site for tid, t, site in mine
        if not any(s.wait for s in _open_at(th, tid, t)))
    assert mine and not outside, (len(mine), sorted(outside.items()))


def _open_at(th, tid, t):
    """The spans open on thread ``tid`` at ``t``, innermost first."""
    s = th.innermost(tid, t)
    while s is not None:
        yield s
        s = th.by_id.get(s.parent)
