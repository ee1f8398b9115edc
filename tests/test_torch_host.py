"""The port's own host layer against the JAX package's originals, on the CPU.

The port carries copies of the host modules it needs (config, sequence
tools, pore models, read sources and their signal readers, the index
reader and writer, the FASTA reader, the BAM and modbam writers and
readers, the native library, quantile scaling, the SavedModel reader and
writer, the window ordering of forkSense, the synthetic fork reads, the
merge of shard outputs), so that it imports nothing of ``dnascent_tpu``.
Each copy must give what the original gives on the same inputs: the golden
dataset (``build_dataset(..., n_reads=4, read_length=1500,
signal_format="fast5", seed=11)``) and seeded numpy data.  Equality is
exact throughout.
"""

import dataclasses

import numpy as np
import pytest

from dnascent_tpu.config import DNA_R10 as JAX_R10
from dnascent_tpu.testing.dataset import build_dataset
from dnascent_tpu_torch.config import DNA_R10


@pytest.fixture(scope="module")
def dataset(tmp_path_factory, models):
    d = tmp_path_factory.mktemp("host_golden")
    return build_dataset(str(d), models, n_reads=4, read_length=1500,
                         signal_format="fast5", seed=11)


@pytest.fixture(scope="module")
def port_models():
    from dnascent_tpu_torch.io.poremodel import synthetic_model_set
    return synthetic_model_set(DNA_R10)


def _assert_records_equal(a, b):
    assert len(a) == len(b) and a
    for ra, rb in zip(a, b):
        for f in dataclasses.fields(ra):
            if f.name == "bam_record":
                assert (ra.bam_record is None) == (rb.bam_record is None)
                if ra.bam_record is not None:
                    assert ra.bam_record.raw == rb.bam_record.raw
                continue
            va, vb = getattr(ra, f.name), getattr(rb, f.name)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype, f.name
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, f.name


def test_config_equal():
    from dnascent_tpu import config as j
    from dnascent_tpu_torch import config as t
    assert dataclasses.asdict(DNA_R10) == dataclasses.asdict(JAX_R10)
    assert t.PRESETS.keys() == j.PRESETS.keys()
    for name in (None, *t.PRESETS):
        assert t.get_config(name) is DNA_R10
        assert (dataclasses.asdict(t.get_config(name))
                == dataclasses.asdict(j.get_config(name)))
    msgs = []
    for mod in (t, j):
        with pytest.raises(KeyError) as e:
            mod.get_config("RNA_R9")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "unknown substrate preset" in msgs[0]


def test_seqtools_equal():
    from dnascent_tpu.utils import seqtools as j
    from dnascent_tpu_torch.utils import seqtools as t
    rng = np.random.default_rng(3)
    seq = "".join(rng.choice(list("ACGTNacgtRY"), 400))
    np.testing.assert_array_equal(t._COMP_TABLE, j._COMP_TABLE)
    np.testing.assert_array_equal(t.encode_bases(seq), j.encode_bases(seq))
    assert t.reverse_complement(seq) == j.reverse_complement(seq)
    for k in (5, 9):
        np.testing.assert_array_equal(t.kmer_ranks(seq, k),
                                      j.kmer_ranks(seq, k))
    for i in rng.integers(0, 4 ** 9, 20):
        kmer = j.index2kmer(int(i), 9)
        assert t.index2kmer(int(i), 9) == kmer
        assert t.kmer2index(kmer) == j.kmer2index(kmer) == i
    codes = rng.integers(0, 4, (50, 9))
    np.testing.assert_array_equal(t.core_index_from_codes(codes),
                                  j.core_index_from_codes(codes))
    np.testing.assert_array_equal(t.residual_index_from_codes(codes),
                                  j.residual_index_from_codes(codes))
    for k in (1, 5, 9):
        np.testing.assert_array_equal(t.contains_T(seq, k),
                                      j.contains_T(seq, k))
    for s in (seq, "ACGT" * 20, "ACGTN", "acgt", "", "T"):
        assert t.all_defined(s) == j.all_defined(s)
    assert t.all_defined("GATTACA") and not t.all_defined("GATNACA")


def test_pore_models_equal(tmp_path, models, port_models):
    from dnascent_tpu.io import poremodel as j
    from dnascent_tpu_torch.io import poremodel as t
    for name in ("pore_model", "unlabelled_model", "analogue_model"):
        np.testing.assert_array_equal(getattr(port_models, name),
                                      getattr(models, name))
    assert port_models.kmer_len == models.kmer_len
    np.testing.assert_array_equal(t.synthetic_model_table(9, seed=4),
                                  j.synthetic_model_table(9, seed=4))
    # the TSV loaders: the JAX package writes the three tables, both load
    for fn, table in ((JAX_R10.fn_unlabelled_model, models.pore_model),
                      (JAX_R10.fn_fit_unlabelled_model,
                       models.unlabelled_model),
                      (JAX_R10.fn_fit_analogue_model, models.analogue_model)):
        j.write_model_tsv(table, str(tmp_path / fn), 9)
    a = j.load_model_set(JAX_R10, str(tmp_path), allow_synthetic=False)
    b = t.load_model_set(DNA_R10, str(tmp_path), allow_synthetic=False)
    for name in ("pore_model", "unlabelled_model", "analogue_model"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))


def test_simulated_source_equal(models, port_models):
    from dnascent_tpu.pipeline.source import SimulatedSource as JSource
    from dnascent_tpu_torch.pipeline.source import SimulatedSource as TSource
    a = list(JSource(models, JAX_R10, n_reads=3, length=900, seed=17))
    b = list(TSource(port_models, DNA_R10, n_reads=3, length=900, seed=17))
    _assert_records_equal(a, b)


def test_reference_and_index_equal(dataset):
    from dnascent_tpu.io import fasta as jf, index_io as ji
    from dnascent_tpu_torch.io import fasta as tf, index_io as ti
    assert tf.import_reference(dataset.reference_fa) == \
        jf.import_reference(dataset.reference_fa)
    a, b = ji.parse_index(dataset.index), ti.parse_index(dataset.index)
    assert a.keys() == b.keys() and a
    for rid in a:
        assert dataclasses.asdict(a[rid]) == dataclasses.asdict(b[rid])


def test_bam_signal_source_equal(dataset):
    from dnascent_tpu.io.fasta import import_reference
    from dnascent_tpu.io.index_io import parse_index
    from dnascent_tpu.pipeline.source import BamSignalSource as JSource
    from dnascent_tpu_torch.pipeline.source import BamSignalSource as TSource
    ref = import_reference(dataset.reference_fa)
    idx = parse_index(dataset.index)
    a = list(JSource(dataset.bam, ref, idx, min_length=1000))
    b = list(TSource(dataset.bam, ref, idx, min_length=1000))
    assert len(a) == 4
    _assert_records_equal(a, b)
    assert (TSource(dataset.bam, ref, idx, min_length=1000).count_records()
            == JSource(dataset.bam, ref, idx, min_length=1000).count_records())


def test_estimate_scaling_quantiles_equal():
    from dnascent_tpu.ops.reference import estimate_scaling_quantiles as j
    from dnascent_tpu_torch.ops.scaling import estimate_scaling_quantiles as t
    rng = np.random.default_rng(5)
    for n in (50, 997, 4000):
        ev = rng.normal(90, 16, n)
        mm = rng.normal(0, 1, n + 13)
        assert t(ev, mm, DNA_R10.scaling) == j(ev, mm, JAX_R10.scaling)


def test_native_event_detect_equal(dataset):
    from dnascent_tpu import native as jn
    from dnascent_tpu_torch import native as tn
    from dnascent_tpu_torch.io.fasta import import_reference
    from dnascent_tpu_torch.io.index_io import parse_index
    from dnascent_tpu_torch.pipeline.source import BamSignalSource
    assert tn.available() and jn.available()
    ed = DNA_R10.events
    raws = [r.raw for r in BamSignalSource(
        dataset.bam, import_reference(dataset.reference_fa),
        parse_index(dataset.index), min_length=1000)]
    raws.append(np.random.default_rng(1).normal(80, 10, 3000))
    for raw in raws:
        a = jn.event_detect(raw, ed.window_length1, ed.window_length2,
                            ed.threshold1, ed.threshold2, ed.peak_height)
        b = tn.event_detect(raw, ed.window_length1, ed.window_length2,
                            ed.threshold1, ed.threshold2, ed.peak_height)
        assert a[0].shape[0] > 10
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]


def test_native_decode_moves_equal():
    from dnascent_tpu import native as jn
    from dnascent_tpu_torch import native as tn
    rng = np.random.default_rng(7)
    rows, B, nk, ne = 300, 3, 700, 900
    # mostly moves, with PAD gaps, as the chase emits them
    codes = rng.choice(4, (rows, B, 4), p=[0.4, 0.25, 0.15, 0.2])
    packed = (codes << (2 * np.arange(4))).sum(-1).astype(np.uint8)
    means = rng.normal(90, 10, ne)
    scaled = rng.normal(0, 1, ne).astype(np.float32)
    mu = rng.normal(0, 1, nk).astype(np.float32)
    inv = np.full(nk, 7.0, np.float32)
    lpc = np.full(nk, 0.9, np.float32)
    q2r = np.where(rng.random(nk) < 0.1, -1, np.arange(nk)).astype(np.int64)
    rr = rng.integers(0, 4 ** 9, nk - 8).astype(np.int64)
    for col in range(B):
        args = (packed, col, ne - 1 - col, nk, means, scaled, mu, inv, lpc,
                q2r, rr)
        a, b = jn.decode_moves(*args), tn.decode_moves(*args)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@pytest.fixture(scope="module")
def port_prepped(dataset, port_models):
    """The golden reads through the port's prep (CPU)."""
    import torch
    from dnascent_tpu.io.fasta import import_reference
    from dnascent_tpu.io.index_io import parse_index
    from dnascent_tpu_torch.pipeline import prep as tprep
    from dnascent_tpu_torch.pipeline.source import BamSignalSource

    torch.set_num_threads(2)
    recs = list(BamSignalSource(dataset.bam,
                                import_reference(dataset.reference_fa),
                                parse_index(dataset.index),
                                min_length=1000))
    return tprep.prepare_reads(recs, port_models, DNA_R10, device="cpu")


@pytest.fixture(scope="module")
def native_eventalign_calls(port_prepped, models, port_models):
    """The arguments the port's eventalign hands its native batch entry
    and window post-processing on the golden reads, and those the JAX
    package's window-set function hands its native window chain on the same
    prepared reads (CPU)."""
    from dnascent_tpu import native as jn
    from dnascent_tpu.pipeline import eventalign as jea
    from dnascent_tpu_torch import native as tn
    from dnascent_tpu_torch.pipeline import eventalign as tea

    calls = {"eventalign_batch": [], "process_read_windows": [],
             "jax_window_chain": []}
    mp = pytest.MonkeyPatch()
    for mod, name, key in ((tn, "eventalign_batch", "eventalign_batch"),
                           (tn, "process_read_windows",
                            "process_read_windows"),
                           (jn, "window_chain", "jax_window_chain")):
        fn = getattr(mod, name)

        def rec(*a, _fn=fn, _key=key, **kw):
            calls[_key].append((a, kw))
            return _fn(*a, **kw)
        mp.setattr(mod, name, rec)
    try:
        tea.run_eventalign(port_prepped, port_models, DNA_R10)
        for p in port_prepped:
            if p.passed and p.event_alignment.shape[0]:
                jea._build_window_set(jea._build_state(p, models, JAX_R10),
                                      JAX_R10, tea.T_BUCKETS[-1])
    finally:
        mp.undo()
    assert all(calls.values()), {k: len(v) for k, v in calls.items()}
    return calls


def _assert_windows_match_jax_chain(calls):
    """The port's native batch entry, rerun on its recorded arguments, gives
    for each read the windows of the JAX package's native window chain
    rerun on that package's recorded arguments: the same starts,
    ns = wl - k + 1, g0 = guard_cum[j0] and
    g1 = min(guard_cum[j1], g0 + t_cap)."""
    import inspect
    from dnascent_tpu import native as jn
    from dnascent_tpu_torch import native as tn

    ((args, kw),) = calls["eventalign_batch"]
    arg = inspect.signature(tn.eventalign_batch).bind(*args, **kw).arguments
    k, t_cap = arg["k"], arg["t_cap"]
    b = tn.eventalign_batch(*args, **kw)
    jcalls = calls["jax_window_chain"]
    assert len(jcalls) == b.offsets.shape[0] - 1
    n_win = 0
    for i, (ja, jkw) in enumerate(jcalls):
        guard_cum = inspect.signature(jn.window_chain).bind(
            *ja, **jkw).arguments["guard_cum"]
        ri, wl, j0, j1 = jn.window_chain(*ja, **jkw)
        w0, w1 = b.offsets[i, 3], b.offsets[i + 1, 3]
        g0 = guard_cum[j0]
        for got, want in ((b.ri, ri), (b.ns, wl - k + 1), (b.g0, g0),
                          (b.g1, np.minimum(guard_cum[j1], g0 + t_cap))):
            np.testing.assert_array_equal(got[w0:w1], want)
        n_win += ri.shape[0]
    assert n_win == b.ri.shape[0] > 0


@pytest.mark.parametrize("name", ["window_chain", "process_read_windows"])
def test_native_eventalign_equal(native_eventalign_calls, name):
    from dnascent_tpu import native as jn
    from dnascent_tpu_torch import native as tn

    if name == "window_chain":
        _assert_windows_match_jax_chain(native_eventalign_calls)
        return

    def flat(out):
        for x in out:
            if isinstance(x, tuple):
                yield from flat(x)
            else:
                yield x

    for args, kw in native_eventalign_calls[name]:
        a = getattr(jn, name)(*args, **kw)
        b = getattr(tn, name)(*args, **kw)
        for x, y in zip(flat(a), flat(b), strict=True):
            np.testing.assert_array_equal(x, y)


def _simulated_prepped(port_models):
    """Seeded reads as eventalign takes them, without prep: forward and
    reverse, one with N runs (undefined k-mers), one whose events all fail
    the event-mean guard (no window), one shorter than a k-mer.  The
    reference comes from the synthetic pore model's range, so breakpoints
    (model-mean gaps above 0.75 on both sides) are frequent."""
    from dnascent_tpu_torch.pipeline.prep import PreparedRead
    from dnascent_tpu_torch.pipeline.source import ReadRecord
    from dnascent_tpu_torch.utils.seqtools import kmer_ranks

    rng = np.random.default_rng(23)
    k = DNA_R10.kmer_len
    out = []
    for i, (length, reverse, n_runs, guard_fail) in enumerate((
            (1800, False, 0, 0.05), (2300, True, 0, 0.3),
            (2000, False, 4, 0.05), (1200, True, 2, 1.0),
            (900, False, 0, 0.0), (6, False, 0, 0.0))):
        seq = rng.choice(list("ACGT"), length)
        for s0 in rng.integers(0, length, n_runs):
            seq[s0 : s0 + rng.integers(1, 30)] = "N"
        seq = "".join(seq)
        # a few insertions in the query
        r2q = (np.arange(length)
               + np.cumsum(rng.random(length) < 0.02)).astype(np.int64)
        n_qk = max(1, int(r2q[-1]) + 1 - k + 1)
        q = np.repeat(np.arange(n_qk), rng.integers(1, 4, n_qk))
        pairs = np.stack([np.arange(q.shape[0]), q], 1).astype(np.int64)
        mean = rng.normal(90.0, 15.0, q.shape[0])
        mean[rng.random(q.shape[0]) < guard_fail] = -5.0
        rec = ReadRecord(
            read_id=f"sim{i}", contig="chrSim", ref_start=500 + 7 * i,
            ref_end=500 + 7 * i + length, is_reverse=reverse, basecall=seq,
            reference_seq=seq, ref_to_query=r2q,
            query_to_ref=np.arange(length, dtype=np.int64),
            ref_to_del=np.zeros(length, bool), raw=np.zeros(1))
        out.append(PreparedRead(
            rec, mean, np.zeros(q.shape[0], np.int64),
            np.zeros(q.shape[0], np.int64), q.shape[0],
            kmer_ranks(seq, k), kmer_ranks(seq, k), event_alignment=pairs))
    return out


@pytest.mark.parametrize("reads", ["golden", "simulated"])
def test_eventalign_batch_matches_jax(request, models, port_models, reads):
    """The port's native batch entry against the JAX package's per-read
    ``_build_state`` and ``_build_window_set`` on the same prepared reads,
    with and without window sets: every state and window array equal in
    dtype and bits; a read shorter than a k-mer has no state, and a read
    the JAX package builds no window set for has none."""
    from dnascent_tpu.pipeline import eventalign as jea
    from dnascent_tpu_torch.pipeline import eventalign as tea

    if reads == "golden":
        prepped = [p for p in request.getfixturevalue("port_prepped")
                   if p.passed and p.event_alignment.shape[0]]
    else:
        prepped = _simulated_prepped(port_models)
    t_cap = tea.T_BUCKETS[-1]
    full_ns = JAX_R10.window_length_align - JAX_R10.kmer_len + 1
    seen = dict(states=0, sets=0, no_state=0, no_set=0, extended=0,
                undefined=0, reverse=0)
    for windows in (True, False):
        batch = tea._build_batch(prepped, port_models, DNA_R10, windows)
        states = {st.p.record.read_id: st for st in batch.states}
        sets = {st.p.record.read_id: ws for st, ws in batch.sets}
        assert windows or not sets
        for p in prepped:
            rid = p.record.read_id
            jst = jea._build_state(p, models, JAX_R10)
            jws = jea._build_window_set(jst, JAX_R10, t_cap)
            if len(p.record.reference_seq) < JAX_R10.kmer_len:
                assert rid not in states and rid not in sets and jws is None
                seen["no_state"] += 1
                continue
            st = states[rid]
            for f in ("ref_codes", "core_rank", "res_rank", "mean_ref",
                      "defined"):
                a, b = getattr(jst, f), getattr(st, f)
                assert a.dtype == b.dtype, (rid, f)
                np.testing.assert_array_equal(b, a, err_msg=f"{rid} {f}")
            seen["states"] += 1
            seen["undefined"] += int(not st.defined.all())
            if not windows:
                continue
            if jws is None:
                assert rid not in sets
                seen["no_set"] += 1
                continue
            ws = sets[rid]
            for f in ("ri", "ns", "g0", "g1", "ref_coord", "indel", "g_ev"):
                a, b = getattr(jws, f), getattr(ws, f)
                assert a.dtype == b.dtype, (rid, f)
                np.testing.assert_array_equal(b, a, err_msg=f"{rid} {f}")
            seen["sets"] += 1
            seen["extended"] += int((ws.ns > full_ns).sum())
            seen["reverse"] += int(p.record.is_reverse)
    assert seen["states"] == 2 * len(prepped) - seen["no_state"] > 0
    assert seen["sets"] > 0
    if reads == "simulated":
        # every case the entry has to cover was met
        assert seen["no_state"] == 2 and seen["no_set"] >= 1
        assert seen["extended"] and seen["undefined"] and seen["reverse"]
        assert seen["sets"] > seen["reverse"]


def test_resident_obs_matches_the_per_read_formula():
    """The fast path's observation stream, one upload and one gather a fill
    group, against the per-read formula it replaced (the read's row of
    the fill input gathered at its guarded events, times a, plus b, both
    f32, then f16), bit for bit: reads of two fill groups as wide as those
    of 3 kb and 9 kb reads, interleaved in read order."""
    import torch
    from dnascent_tpu_torch.pipeline import eventalign as tea

    rng = np.random.default_rng(9)
    widths = (6730, 20307)
    groups = [torch.from_numpy(rng.normal(0.0, 1.2, (3, e)).astype(
        np.float32)) for e in widths]

    class P:
        pass
    sets = []
    for i in range(5):
        g = i % 2
        p = P()
        p.events_dev, p.events_row = groups[g], i // 2
        p.scale_q, p.scale = rng.uniform(0.5, 2.0, 2)
        p.shift_q, p.shift = rng.normal(0.0, 3.0, 2)
        n = int(rng.integers(widths[g] // 2, widths[g]))
        g_ev = np.sort(rng.choice(widths[g], n, replace=False)).astype(
            np.int64)
        ws = tea._WindowSet(*[np.zeros(1, np.int64)] * 6, g_ev)
        sets.append((tea._ReadState(p, *[None] * 5), ws))
    obs = tea._resident_obs(sets, torch.device("cpu"))
    assert obs.dtype == torch.float16
    assert obs.shape[0] == sum(ws.g_ev.shape[0] for _, ws in sets)
    spans = []
    for st, ws in sets:
        p, n = st.p, ws.g_ev.shape[0]
        a = np.float32(p.scale_q / p.scale)
        b = np.float32((p.shift_q - p.shift) / p.scale)
        want = (p.events_dev[p.events_row].index_select(
            0, torch.from_numpy(ws.g_ev)) * float(a) + float(b)).to(
            torch.float16)
        got = obs[st.flat_obs_base : st.flat_obs_base + n]
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
        spans.append((st.flat_obs_base, n))
    # the reads' slices tile the stream, group after group
    spans.sort()
    assert [s for s, _ in spans] == list(np.cumsum([0] + [n for _, n in
                                                          spans])[:-1])
    assert [st.p.events_dev is groups[0] for st, _ in sorted(
        sets, key=lambda x: x[0].flat_obs_base)] == [True] * 3 + [False] * 2


def test_native_library_builds_outside_the_package():
    import os
    from dnascent_tpu_torch import native as tn
    assert tn.available()
    pkg = os.path.dirname(os.path.abspath(tn.__file__))
    assert os.path.commonpath([tn.BUILD_DIR, pkg]) != pkg
    assert os.path.basename(tn.BUILD_DIR) == "torch_native"
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]


def test_savedmodel_reader_and_writer_equal(tmp_path):
    from dnascent_tpu.models import cnn_import as jci
    from dnascent_tpu.testing.tf_bundle_writer import \
        write_savedmodel_dir as jwrite
    from dnascent_tpu_torch.models import cnn_import as tci, reference_cnn
    from dnascent_tpu_torch.testing.tf_bundle_writer import \
        write_savedmodel_dir as twrite
    tensors = reference_cnn.seed_affine(reference_cnn.synthetic_tensors(3), 4)
    twrite(str(tmp_path / "port"), tensors)
    jwrite(str(tmp_path / "jax"), tensors)
    for part in ("variables.index", "variables.data-00000-of-00001"):
        with open(tmp_path / "port" / "variables" / part, "rb") as fa, \
                open(tmp_path / "jax" / "variables" / part, "rb") as fb:
            assert fa.read() == fb.read(), part
    d = str(tmp_path / "port")
    assert tci.check_savedmodel_architecture(d) == \
        jci.check_savedmodel_architecture(d) == []
    a, b = jci.load_savedmodel_tensors(d), tci.load_savedmodel_tensors(d)
    assert a.keys() == b.keys() == tensors.keys()
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
        np.testing.assert_array_equal(b[k], tensors[k])


def _bam_records(rng, n=6, length=400):
    """Forward and reverse records whose CIGARs carry deletions, insertions
    and soft clips, some with MM/ML tags already present."""
    from dnascent_tpu.io import bam as jb
    recs = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACGT"), length))
        cigar = [(jb.BAM_CSOFT_CLIP, 5), (jb.BAM_CMATCH, 150),
                 (jb.BAM_CDEL, 3 + i), (jb.BAM_CMATCH, 100),
                 (jb.BAM_CINS, 4), (jb.BAM_CMATCH, length - 259)]
        aux = jb.encode_tag_Z("XX", f"tag{i}")
        if i % 3 == 2:
            aux += (jb.encode_tag_Z("MM", "C+m?,0,2;")
                    + jb.encode_tag_array_u8("ML", [7, 250]))
        recs.append(jb.build_record(
            f"read-{i}", 0, 1000 + 37 * i, 60, cigar, seq,
            flag=jb.FLAG_REVERSE if i % 2 else 0, aux=aux))
    return recs


def _modbam_calls(rng, rec):
    """Seeded query indices (ascending, inside the query) and probabilities
    for one record."""
    idx = np.sort(rng.choice(rec.l_seq, 60, replace=False)).astype(np.int64)
    return idx, rng.random(60).astype(np.float32), \
        rng.random(60).astype(np.float32)


def test_bam_writer_equal(tmp_path):
    """Records built, re-tagged with MM/ML and written through the JAX
    package's BAM writer and the port's give equal file bytes (more than one
    BGZF block)."""
    from dnascent_tpu.io import bam as jb, modbam as jm
    from dnascent_tpu_torch.io import bam as tb, modbam as tm
    rng = np.random.default_rng(11)
    recs = _bam_records(rng, n=200)
    header = "@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:chrS\tLN:60000\n"
    paths = []
    for bam, modbam, name in ((jb, jm, "jax.bam"), (tb, tm, "port.bam")):
        w = bam.BamWriter(str(tmp_path / name), header, ["chrS"], [60000])
        calls = np.random.default_rng(12)
        for r in recs:
            rec = bam.build_record(r.qname, r.ref_id, r.pos, r.mapq,
                                   [tuple(c) for c in r.cigar()], r.seq(),
                                   flag=r.flag, aux=r.aux_bytes())
            assert rec.raw == r.raw
            idx, edu, brdu = _modbam_calls(calls, rec)
            aux = modbam.build_modbam_tags(idx, edu, brdu,
                                           rec.get_tag("MM") or "",
                                           rec.get_tag("ML"))
            w.write_record(rec.with_tags_replaced(["MM", "ML"], aux))
        w.close()
        paths.append(tmp_path / name)
    a, b = (p.read_bytes() for p in paths)
    assert a == b and len(a) > 65280


@pytest.mark.parametrize("strand", ["fwd", "rev"])
def test_modbam_tags_and_reader_equal(strand):
    """build_modbam_tags and detected_read_from_bam of both packages on
    records with deletions, insertions and soft clips."""
    from dnascent_tpu.io import modbam as jm
    from dnascent_tpu_torch.io import modbam as tm
    rng = np.random.default_rng(13)
    recs = [r for r in _bam_records(rng) if r.is_reverse == (strand == "rev")]
    for rec in recs:
        idx, edu, brdu = _modbam_calls(rng, rec)
        args = (idx, edu, brdu, rec.get_tag("MM") or "", rec.get_tag("ML"))
        aux = jm.build_modbam_tags(*args)
        assert tm.build_modbam_tags(*args) == aux
        tagged = rec.with_tags_replaced(["MM", "ML"], aux)
        a = jm.detected_read_from_bam(tagged, ["chrS"])
        b = tm.detected_read_from_bam(tagged, ["chrS"])
        assert a.strand == b.strand == strand and a.coords.size
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=f.name)
            else:
                assert va == vb, f.name


@pytest.mark.parametrize("deletions", [False, True])
def test_collect_calls_query_fields_equal(dataset, port_models, deletions):
    """collect_calls of both packages on the golden dataset's reads (the
    port's positions and seeded probabilities): the query-side modbam
    fields equal; with ``deletions`` a seeded tenth of each read's reference
    positions is marked deleted, so the mask drops calls."""
    import torch
    from dnascent_tpu.pipeline.detect import collect_calls as jcc
    from dnascent_tpu_torch.io.fasta import import_reference
    from dnascent_tpu_torch.io.index_io import parse_index
    from dnascent_tpu_torch.pipeline import eventalign as tea, prep as tprep
    from dnascent_tpu_torch.pipeline.detect import collect_calls as tcc
    from dnascent_tpu_torch.pipeline.source import BamSignalSource

    torch.set_num_threads(2)
    recs = list(BamSignalSource(dataset.bam,
                                import_reference(dataset.reference_fa),
                                parse_index(dataset.index), min_length=1000))
    pp = tprep.prepare_reads(recs, port_models, DNA_R10, device="cpu")
    results = tea.run_eventalign(pp, port_models, DNA_R10)
    rng = np.random.default_rng(14)
    n_dropped = 0
    for rec in recs:
        pos = results[rec.read_id].positions
        if deletions:
            rec = dataclasses.replace(
                rec, ref_to_del=rng.random(rec.ref_to_del.shape[0]) < 0.1)
        probs = rng.random((int(pos.center_is_T.sum()), 2)).astype(np.float32)
        a, b = jcc(rec, pos, probs), tcc(rec, pos, probs)
        for name in ("ref_coords", "edu_prob", "brdu_prob", "kmer_starts",
                     "query_indices", "edu_prob_q", "brdu_prob_q"):
            va, vb = getattr(a, name), getattr(b, name)
            assert va.dtype == vb.dtype, name
            np.testing.assert_array_equal(va, vb, err_msg=name)
        n_dropped += a.ref_coords.shape[0] - a.query_indices.shape[0]
    assert (n_dropped > 0) == deletions


@pytest.mark.parametrize("source", ["fast5", "pod5", "summary"])
def test_index_cli_equal(tmp_path, models, dataset, source):
    """``index`` of both CLIs on the golden fast5 dataset, on a pod5 dataset
    and with a sequencing summary: equal index files."""
    from dnascent_tpu import cli as jcli
    from dnascent_tpu_torch import cli as tcli
    signal_dir = dataset.signal_dir
    extra = []
    if source == "pod5":
        signal_dir = build_dataset(str(tmp_path / "pod5"), models, n_reads=3,
                                   read_length=600, signal_format="pod5",
                                   seed=4).signal_dir
    elif source == "summary":
        summary = tmp_path / "sequencing_summary.txt"
        from dnascent_tpu.io.index_io import parse_index
        ids = sorted(parse_index(dataset.index))
        summary.write_text("filename\tread_id\n" + "".join(
            f"batch0.fast5\t{rid}\n" for rid in ids))
        extra = ["-s", str(summary)]
    outs = []
    for cli, name in ((jcli, "jax.idx"), (tcli, "port.idx")):
        out = str(tmp_path / name)
        assert cli.main(["index", "-f", signal_dir, "-o", out, *extra]) == 0
        outs.append(open(out).read())
    assert outs[0] == outs[1] and outs[0].count("\n") >= 3


def test_native_seebreaks_equal():
    """The three libstdc++-RNG entries of seeBreaks' parity mode, bitwise
    against the JAX package's native library on the same inputs."""
    from dnascent_tpu import native as jn
    from dnascent_tpu_torch import native as tn
    rng = np.random.default_rng(16)
    v5 = rng.integers(0, 100000, 300).astype(np.int64)
    v3 = v5 + rng.integers(40000, 90000, 300)
    lens = rng.integers(2000, 9000, 120).astype(np.int64)
    runoffs = (rng.random(90) < 0.3).astype(np.uint8)
    out = []
    for lib in (jn.get_lib(), tn.get_lib()):
        sim = np.empty(700)
        lib.seebreaks_simulation(v5, v3, v5.shape[0], lens, lens.shape[0],
                                 runoffs.shape[0], sim.shape[0], 221005, 2000,
                                 300, sim)
        obs = np.empty(700)
        lib.seebreaks_observation(runoffs, runoffs.shape[0], 221005,
                                  obs.shape[0], obs)
        diff = np.empty(900)
        lib.seebreaks_difference(0.3, 0.04, 0.1, 0.02, diff.shape[0], 221005,
                                 diff)
        out.append((sim, obs, diff))
    for x, y in zip(*out):
        assert np.isfinite(x).all() and np.unique(x).size > 1
        np.testing.assert_array_equal(x, y)


def test_fork_reads_equal():
    """The port's synthetic fork reads (testing/forks.py) are the forkSense
    tests' ``_synthetic_read``."""
    from tests.test_forksense import _synthetic_read
    from dnascent_tpu_torch.testing import forks
    got = forks.fork_reads(3, 2)
    want = ([_synthetic_read(seed=i, tracks=forks.RIGHT_FORK,
                             read_id=f"rf-{i}") for i in range(3)]
            + [_synthetic_read(seed=100 + i, tracks=forks.LEFT_FORK,
                               read_id=f"lf-{i}") for i in range(2)])
    for a, b in zip(got, want, strict=True):
        for name in ("read_id", "contig", "ref_start", "ref_end", "strand"):
            assert getattr(a, name) == getattr(b, name)
        for name in ("coords", "edu", "brdu"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def _eventalign_rows(rng, n=3000, seq_len=600):
    """Seeded formatter inputs: a fifth of the rows insertions, coordinates
    and values of every sign, f32-cast and unrounded values."""
    seq = "".join(rng.choice(list("ACGT"), seq_len))
    vals = rng.normal(0, 2, n)
    vals[::3] = vals[::3].astype(np.float32)
    return seq, (rng.integers(-5, 10 ** 9, n), rng.integers(0, seq_len - 9, n),
                 (rng.random(n) < 0.2).astype(np.uint8), vals,
                 rng.normal(0, 1.5, n))


@pytest.mark.parametrize("is_reverse", [False, True])
def test_native_format_eventalign_rows_equal(is_reverse):
    """The port's copy of the eventalign row formatter writes the bytes of
    the JAX package's native original on normal rows (forward k-mers, and
    reverse-complemented ones)."""
    from dnascent_tpu import native as jn
    from dnascent_tpu_torch import native as tn
    seq, rows = _eventalign_rows(np.random.default_rng(17 + is_reverse))
    want = jn.format_eventalign_rows(*rows, seq, 9, is_reverse)
    assert want.count("\n") == rows[0].shape[0]
    assert tn.format_eventalign_rows(*rows, seq, 9, is_reverse) == want


@pytest.mark.parametrize("n_rows", [1, 3])
def test_native_format_eventalign_rows_refuses_overflow(n_rows):
    """A value such as 1e300 prints 300 digits, more than the buffer sized
    from the row count holds: the port's formatter raises where the
    original returns the text cut short."""
    from dnascent_tpu import native as jn
    from dnascent_tpu_torch import native as tn
    seq, rows = _eventalign_rows(np.random.default_rng(19), n=n_rows)
    rows[3][-1] = 1e300
    cut = jn.format_eventalign_rows(*rows, seq, 9, False)
    assert not cut.endswith("\n")       # the original's silent truncation
    with pytest.raises(ValueError, match="overflow"):
        tn.format_eventalign_rows(*rows, seq, 9, False)


def test_import_traingmm_model_equal(tmp_path):
    """trainGMM's table reader: the JAX package's writer's table (with a
    header row and a k-mer carrying N, both skipped) read by both."""
    from dnascent_tpu.io.poremodel import import_traingmm_model as j
    from dnascent_tpu.pipeline.traingmm import GMMFit, write_gmm_table
    from dnascent_tpu_torch.io.poremodel import import_traingmm_model as t
    rng = np.random.default_rng(21)
    fits = [GMMFit(int(i), *rng.normal(0, 1, 8), 900, 850)
            for i in rng.choice(4 ** 9, 50, replace=False)]
    path = str(tmp_path / "fit.model")
    write_gmm_table(fits, path)
    with open(path, "a") as fh:
        fh.write("ACGTNACGT\t1\t1\t1\t1\t1\t1\t1\t1\t1\t1\n")
    a, b = j(path, 9), t(path, 9)
    assert np.count_nonzero(a[:, 1]) == 50
    np.testing.assert_array_equal(b, a)


def test_parse_align_events_and_dbscan_equal(tmp_path):
    """The trainGMM host steps: pooling an align table's scaled samples by
    k-mer (insertion rows skipped, ``-e`` and ``-m`` caps) and the 1-D
    DBSCAN filter, against the JAX package's."""
    from dnascent_tpu.pipeline import traingmm as j
    from dnascent_tpu_torch.pipeline import traingmm as t
    from dnascent_tpu_torch.utils.seqtools import index2kmer
    rng = np.random.default_rng(23)
    kmers = [index2kmer(int(i), 9) for i in rng.choice(4 ** 9, 6)]
    path = str(tmp_path / "t.align")
    with open(path, "w") as fh:
        for read in range(4):
            fh.write(f">r{read} chrS 0 10 fwd\n")
            for _ in range(400):
                km = kmers[rng.integers(0, 6)]
                ins = rng.random() < 0.1
                fh.write(f"7\t{km}\t{rng.normal(0, 1):.6f}\t"
                         f"{'N' * 9 if ins else km}\t0.5\n")
    for max_events, max_reads in ((10000, None), (50, 2)):
        a = j.parse_align_events(path, 9, max_events, max_reads)
        b = t.parse_align_events(path, 9, max_events, max_reads)
        assert a.keys() == b.keys() and len(a) == 6
        for k in a:
            np.testing.assert_array_equal(b[k], a[k])
    for seed in range(3):
        r = np.random.default_rng(seed)
        ev = np.concatenate([r.normal(0, 0.2, 500), r.normal(3, 0.5, 30),
                             r.uniform(-9, 9, 12)])
        for eps, min_points in ((0.5, 12), (0.1, 3), (0.05, 40)):
            keep = j.dbscan_filter_1d(ev, eps, min_points)
            assert 0 < keep.sum() < ev.shape[0] or min_points == 40
            np.testing.assert_array_equal(
                t.dbscan_filter_1d(ev, eps, min_points), keep)


def _write_shards(tmp_path, rng):
    """Three detect-style shard files and three bed shards of seeded reads
    on two contigs (ties in start and end broken by the read id), each
    with a header; the third bed shard is empty but for its header."""
    texts, beds = ["", "", ""], ["#h0\n", "#h1\n", "#h2\n"]
    for i in range(30):
        contig = f"chr{rng.integers(1, 3)}"
        start = int(rng.integers(0, 4)) * 100
        end = start + int(rng.integers(1, 3)) * 50
        k = int(rng.integers(0, 3))
        texts[k] += f">r{i:02d} {contig} {start} {end} fwd\n"
        texts[k] += "".join(f"{start + j}\t0.{j}\t0.5\n"
                            for j in range(int(rng.integers(0, 4))))
        if k < 2:
            beds[k] += f"{contig} {start} {end} r{i:02d} {start} {end} fwd\n"
    paths = []
    for k in range(3):
        paths.append(tmp_path / f"out.detect.host{k}")
        paths[-1].write_text(f"#Header {k}\n#Mode CNN\n" + texts[k])
        (tmp_path / f"x.bed.host{k}").write_text(beds[k])
    return ([str(p) for p in paths],
            [str(tmp_path / f"x.bed.host{k}") for k in range(3)])


def test_merge_host_outputs_equal(tmp_path):
    """``parallel/merge.py``: the port's merge of shard outputs and of bed
    shards writes the JAX package's bytes, and the shard-path helpers
    agree."""
    from dnascent_tpu.parallel import merge as jm
    from dnascent_tpu_torch.parallel import merge as tm

    detect, beds = _write_shards(tmp_path, np.random.default_rng(9))
    for fn, shards in (("merge_host_outputs", detect),
                       ("merge_bed_outputs", beds)):
        got, want = tmp_path / f"{fn}.port", tmp_path / f"{fn}.jax"
        n = getattr(tm, fn)(shards, str(got))
        assert n == getattr(jm, fn)(shards, str(want)) and n > 10
        assert got.read_bytes() == want.read_bytes(), fn
    out = str(tmp_path / "out.detect")
    assert tm.host_shard_path(out, 2) == jm.host_shard_path(out, 2)
    for n in (3, 4):
        assert (tm.all_shards_present(out, n)
                == jm.all_shards_present(out, n) == (n == 3))


def _error_classes():
    from dnascent_tpu.utils import errors
    return sorted(name for name, obj in vars(errors).items()
                  if isinstance(obj, type) and issubclass(obj, Exception)
                  and obj.__module__ == errors.__name__)


@pytest.mark.parametrize("name", _error_classes())
def test_errors_equal(name):
    """Every class of the JAX package's error taxonomy has its copy in the
    port, a subclass of the port's base class, with the same message for
    the same arguments."""
    from dnascent_tpu.utils import errors as j
    from dnascent_tpu_torch.utils import errors as t
    jcls, tcls = getattr(j, name), getattr(t, name)
    assert issubclass(tcls, t.DNAscentError)
    assert [c.__name__ for c in tcls.__mro__] == \
        [c.__name__ for c in jcls.__mro__]
    made = 0
    for args in ((), ("reads/batch0.fast5",)):
        try:
            want = str(jcls(*args))
        except TypeError:
            with pytest.raises(TypeError):
                tcls(*args)
            continue
        assert str(tcls(*args)) == want
        made += 1
    assert made


def test_signal_qc_equal():
    """scrappie's raw-signal QC helpers, the port's host copy against the
    JAX package's on seeded signals: exactly equal."""
    from dnascent_tpu.ops import signal_qc as j
    from dnascent_tpu_torch.ops import signal_qc as t
    rng = np.random.default_rng(21)
    assert t.MAD_SCALING_FACTOR == j.MAD_SCALING_FACTOR
    flank = rng.normal(80, 0.5, 700)
    for raw in (rng.normal(90, 12, 5000),
                np.concatenate([flank, rng.normal(95, 15, 6000), flank]),
                rng.normal(90, 12, 99), rng.normal(90, 12, 1),
                np.full(400, 7.0)):
        for p in (0.0, 0.2, 0.5, 1.0, np.array([0.1, 0.9])):
            np.testing.assert_array_equal(t.quantilef(raw, p),
                                          j.quantilef(raw, p))
        assert t.madf(raw) == j.madf(raw)
        assert t.madf(raw, 90.0) == j.madf(raw, 90.0)
        for chunk, perc in ((100, 0.2), (2, 0.0), (37, 0.5), (500, 1.0)):
            assert (t.trim_raw_by_mad(raw, chunk, perc)
                    == j.trim_raw_by_mad(raw, chunk, perc))
        assert t.trim_and_segment_raw(raw) == j.trim_and_segment_raw(raw)
        assert (t.trim_and_segment_raw(raw, 10, 5, 50, 0.3)
                == j.trim_and_segment_raw(raw, 10, 5, 50, 0.3))
    assert np.isnan(t.quantilef(np.empty(0), 0.5))


def test_savedmodel_to_npz_equal(tmp_path):
    """``savedmodel_to_npz`` of both packages on one SavedModel bundle:
    the same keys and equal arrays."""
    from dnascent_tpu.models import cnn_import as jci
    from dnascent_tpu_torch.models import cnn_import as tci, reference_cnn
    from dnascent_tpu_torch.testing.tf_bundle_writer import \
        write_savedmodel_dir
    d = str(tmp_path / "model")
    write_savedmodel_dir(
        d, reference_cnn.seed_affine(reference_cnn.synthetic_tensors(6), 7))
    n_t = tci.savedmodel_to_npz(d, str(tmp_path / "port.npz"))
    n_j = jci.savedmodel_to_npz(d, str(tmp_path / "jax.npz"))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert n_t == n_j == len(a.files) > 100
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_stage_timer_counts_every_call_under_threads():
    """Detect's worker threads share one ``StageTimer``: under a short
    switch interval and more threads than cores, no update is lost."""
    import sys
    import threading

    from dnascent_tpu_torch.utils.progress import StageTimer
    timer = StageTimer()
    n_threads, n_calls = 32, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_calls):
                with timer.time("stage"):
                    pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert timer.counts["stage"] == n_threads * n_calls
    assert timer.totals["stage"] > 0.0
