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


# ---------------------------------------------------------------------------
# Prep's native batch entries against the JAX package's per-read steps
# ---------------------------------------------------------------------------

def _sim_records(port_models, n, length, seed, reverse=False):
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    return list(SimulatedSource(port_models, DNA_R10, n_reads=n,
                                length=length, seed=seed, reverse=reverse))


def _golden_records(dataset):
    from dnascent_tpu_torch.io.fasta import import_reference
    from dnascent_tpu_torch.io.index_io import parse_index
    from dnascent_tpu_torch.pipeline.source import BamSignalSource
    return list(BamSignalSource(dataset.bam,
                                import_reference(dataset.reference_fa),
                                parse_index(dataset.index), min_length=1000))


def _odd_base_records(port_models):
    """Simulated reads with N runs and lowercase stretches in the basecall,
    the reference or both, and a read shorter than a k-mer."""
    rng = np.random.default_rng(41)
    out = []
    for i, rec in enumerate(_sim_records(port_models, 4, 1200, 60,
                                         reverse=True)):
        q, r = (np.array(list(s)) for s in (rec.basecall, rec.reference_seq))
        for arr, on in ((q, i != 1), (r, i != 0)):
            if not on:
                continue
            for s0 in rng.integers(0, arr.shape[0] - 40, 3):
                arr[s0 : s0 + rng.integers(1, 12)] = "N"
            s0 = int(rng.integers(0, arr.shape[0] - 200))
            arr[s0 : s0 + 150] = np.char.lower(arr[s0 : s0 + 150])
        out.append(dataclasses.replace(rec, basecall="".join(q),
                                       reference_seq="".join(r)))
    out.append(dataclasses.replace(out[0], basecall="ACGTACGT",
                                   reference_seq="ACGTACGTA"))
    return out


def _jax_scaling(models, basecall, reference, mean):
    """(query ranks, reference ranks, too few, shift, scale) of one read by
    the JAX package's ``kmer_ranks`` and ``estimate_scaling_quantiles``."""
    from dnascent_tpu.ops.reference import estimate_scaling_quantiles
    from dnascent_tpu.utils.seqtools import kmer_ranks
    k = JAX_R10.kmer_len
    rq, rr = kmer_ranks(basecall, k), kmer_ranks(reference, k)
    if min(mean.shape[0], rq.shape[0], rr.shape[0]) < 2:
        return rq, rr, True, 0.0, 1.0
    safe = np.where(rr < 0, 0, rr)
    shift, scale = estimate_scaling_quantiles(
        mean, models.pore_model[safe, 0].astype(np.float64), JAX_R10.scaling)
    return rq, rr, False, shift, scale


def _scale_batch(port_models, basecalls, references, means):
    from dnascent_tpu_torch import native as tn
    lens = np.array([(len(q), len(r), m.shape[0])
                     for q, r, m in zip(basecalls, references, means)],
                    np.int64)
    return tn.prep_scale_batch(
        "".join(basecalls).encode("ascii"),
        "".join(references).encode("ascii"), lens, np.concatenate(means),
        port_models.pore_model[:, 0].astype(np.float64), DNA_R10.kmer_len,
        DNA_R10.scaling.n_quantiles)


def _bits(x) -> bytes:
    return np.float64(x).tobytes()


@pytest.mark.parametrize("reads", ["golden", "simulated", "odd_bases",
                                   "event_counts"])
def test_prep_scale_batch_matches_jax(dataset, models, port_models, reads):
    """The scaling call over a batch against the JAX package's
    ``kmer_ranks`` of the basecall and the reference and
    ``estimate_scaling_quantiles``, read by read: ranks, the too-few verdict
    and the bits of shift and scale.  The golden reads; simulated reads of
    both strands; reads with N and lowercase bases, one shorter than a
    k-mer and one with 6 events (fewer than the ten quantiles); and 50, 997
    and 4000 random event means, each read with 13 more reference k-mers
    (bins of the ten quantiles that do not divide the counts)."""
    from dnascent_tpu_torch import native as tn
    ed = DNA_R10.events
    counts = (50, 997, 4000)
    if reads == "golden":
        records = _golden_records(dataset)
    elif reads == "simulated":
        records = (_sim_records(port_models, 3, 2500, 70)
                   + _sim_records(port_models, 3, 2500, 80, reverse=True))
    elif reads == "event_counts":
        records = [_sim_records(port_models, 1, n + 13 + DNA_R10.kmer_len - 1,
                                90 + i)[0] for i, n in enumerate(counts)]
    else:
        records = _odd_base_records(port_models)
    if reads == "event_counts":
        rng = np.random.default_rng(5)
        means = [rng.normal(90, 16, n) for n in counts]
    else:
        means = [tn.event_detect(r.raw, ed.window_length1, ed.window_length2,
                                 ed.threshold1, ed.threshold2,
                                 ed.peak_height)[0] for r in records]
    if reads == "odd_bases":
        means[2] = means[2][:6]
    qs = [r.basecall for r in records]
    rs = [r.reference_seq for r in records]
    s = _scale_batch(port_models, qs, rs, means)
    q0 = r0 = 0
    seen = set()
    for i, (q, r, mean) in enumerate(zip(qs, rs, means)):
        rq, rr, few, shift, scale = _jax_scaling(models, q, r, mean)
        np.testing.assert_array_equal(s.rq[q0 : q0 + rq.shape[0]], rq)
        np.testing.assert_array_equal(s.rr[r0 : r0 + rr.shape[0]], rr)
        q0, r0 = q0 + rq.shape[0], r0 + rr.shape[0]
        assert bool(s.too_few[i]) == few, i
        assert _bits(s.shift[i]) == _bits(shift), (i, s.shift[i], shift)
        assert _bits(s.scale[i]) == _bits(scale), (i, s.scale[i], scale)
        seen |= {("few", few), ("undefined", bool((rq < 0).any())),
                 ("short", mean.shape[0] < 10)}
    assert (q0, r0) == (s.rq.shape[0], s.rr.shape[0])
    assert s.rq.dtype == s.rr.dtype == np.int64
    if reads == "odd_bases":
        assert {("few", True), ("undefined", True), ("short", True)} <= seen
        assert any(c.islower() for c in "".join(qs + rs))
    if reads == "event_counts":
        assert [len(r) - DNA_R10.kmer_len + 1 for r in rs] == [
            n + 13 for n in counts]


def test_prep_scale_batch_summation_order(models, port_models):
    """10,000 reads of random event means (their magnitudes spread over
    six decades) and random references: shift and scale bit-equal to the
    JAX package's, whose regression sums ten values in numpy's pairwise
    order; a left-to-right sum would differ in many of them.  Then event
    means the selection's buckets cannot hold: a NaN, infinities, one
    value repeated, a range past the largest double, and a huge outlier."""
    rng = np.random.default_rng(97)
    n = 10_000
    k = DNA_R10.kmer_len
    refs = ["".join(rng.choice(list("ACGT"), int(m)))
            for m in rng.integers(k + 12, k + 60, n)]
    means = [rng.normal(90.0, 16.0, int(m)) * 10.0 ** rng.uniform(-3, 3)
             for m in rng.integers(10, 90, n)]
    odd = [rng.normal(90.0, 16.0, 40) for _ in range(6)]
    odd[0][[3, 17]] = np.nan
    odd[1][5], odd[1][9] = np.inf, -np.inf
    odd[2][:] = 87.5
    odd[3][[2, 30]] = -1.5e308, 1.5e308
    odd[4][11] = 1e300
    odd[5][[0, 1, 2, 3]] = np.inf
    for i, mean in enumerate(odd):
        ref = refs[i]
        s = _scale_batch(port_models, [ref], [ref], [mean])
        _, _, few, shift, scale = _jax_scaling(models, ref, ref, mean)
        assert not few
        assert _bits(s.shift[0]) == _bits(shift), (i, s.shift[0], shift)
        assert _bits(s.scale[0]) == _bits(scale), (i, s.scale[0], scale)
    s = _scale_batch(port_models, refs, refs, means)
    naive = 0
    for i, (ref, mean) in enumerate(zip(refs, means)):
        _, rr, few, shift, scale = _jax_scaling(models, ref, ref, mean)
        assert not few and not s.too_few[i]
        assert _bits(s.shift[i]) == _bits(shift), i
        assert _bits(s.scale[i]) == _bits(scale), i
        # the same regression with every sum taken left to right
        from dnascent_tpu.ops.reference import quantile_medians
        x = quantile_medians(models.pore_model[rr, 0].astype(np.float64), 10)
        y = quantile_medians(mean, 10)
        sx, sy = sum(x.tolist()), sum(y.tolist())
        sxy, sxx = sum((x * y).tolist()), sum((x * x).tolist())
        naive += ((10 * sxy - sx * sy) / (10 * sxx - sx * sx)) != scale
    assert naive > n // 10


@pytest.fixture(scope="module", params=["golden", "painted", "passthrough",
                                        "theilsen_sizes", "fit_stdv"])
def prep_case(request, dataset, port_models):
    """(case, records, port models, JAX models, cfg, the JAX package's
    cfg) of a prep run: the golden reads; painted reads whose signal is
    drawn from a scrambled table over 10-100 % of the read (the longer ones
    fail banded QC) and a 3 kb read in a second fill group, ordered so that
    the reads that pass come in fill-group order otherwise than in the
    batch; simulated reads of 900 and 1500 bp under a minimum of 100
    cleaned events, so the short ones pass with fewer
    cleaned events than Theil-Sen's 1000 points (passthrough); simulated
    reads of 60, 158, 1008 and 2608 bp under no minimum, whose cleaned
    events number about their k-mers (52, 150, 1000, 2600), so that the
    stride subsample takes no points, all but the trimmed ends, a stride
    of 1 and a stride of 2; and simulated reads against a per-k-mer-stdv
    table (kernel E)."""
    from dnascent_tpu.io.poremodel import synthetic_model_set as jax_set
    from dnascent_tpu_torch.testing.painted import (
        edu_model, labels_from_tracks, painted_read)
    jmodels, pms, cfg, jcfg = jax_set(JAX_R10), port_models, DNA_R10, JAX_R10
    case = request.param
    if case == "golden":
        records = _golden_records(dataset)
    elif case == "painted":
        scrambled = pms.pore_model[np.random.default_rng(0).permutation(
            pms.pore_model.shape[0])]
        short = [painted_read(pms, scrambled, 1500, labels_from_tracks(
            1500, [("EdU", 300, 300 + int(1200 * f))]), 40 + i, f"p{i}")
            for i, f in enumerate((0.1, 0.8, 1.0))]
        long = painted_read(pms, edu_model(pms), 3000, labels_from_tracks(
            3000, [("BrdU", 500, 1500), ("EdU", 1500, 2500)]), 50, "p3")
        # the two reads that pass banded QC come in the other order in
        # the fill groups
        records = [short[1], long, short[0], short[2]]
    elif case == "passthrough":
        records = (_sim_records(pms, 2, 900, 90)
                   + _sim_records(pms, 1, 1500, 95, reverse=True))
        cfg, jcfg = (dataclasses.replace(c, banded=dataclasses.replace(
            c.banded, min_cleaned_events=100)) for c in (cfg, jcfg))
    elif case == "theilsen_sizes":
        records = [_sim_records(pms, 1, n, 120 + i, reverse=bool(i % 2))[0]
                   for i, n in enumerate((60, 158, 1008, 2608))]
        cfg, jcfg = (dataclasses.replace(c, banded=dataclasses.replace(
            c.banded, min_cleaned_events=0)) for c in (cfg, jcfg))
    else:
        records = _sim_records(pms, 2, 1200, 99)
        pms = dataclasses.replace(pms, pore_model=pms.unlabelled_model)
        jmodels = dataclasses.replace(jmodels,
                                      pore_model=jmodels.unlabelled_model)
    return case, records, pms, jmodels, cfg, jcfg


def _prep(records, pms, cfg):
    """``prepare_reads`` on the CPU, with each decode call recorded with its
    result, and the fill groups, the decode calls' reads, in order."""
    import torch
    from dnascent_tpu_torch import native as tn
    from dnascent_tpu_torch.pipeline import prep as tprep

    torch.set_num_threads(2)
    calls, groups = [], []
    decode, fill_groups = tn.prep_decode_group, tprep._fill_groups

    def rec(*a, **kw):
        out = decode(*a, **kw)
        calls.append((a, kw, out))
        return out

    def rec_groups(live):
        out = fill_groups(live)
        groups.extend(out)
        return out
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tn, "prep_decode_group", rec)
        mp.setattr(tprep, "_fill_groups", rec_groups)
        out = tprep.prepare_reads(records, pms, cfg, device="cpu")
    return out, calls, groups


def test_prep_decode_group_matches_jax(prep_case):
    """Each fill group's decode call against the JAX package's per-read
    ``prepare_emission_coefficients``, ``decode_moves`` and
    ``theilsen_pregather`` and prep's four banded QC tests on the same
    inputs: pairs, verdict, and each passing read's Theil-Sen row (points,
    model means, count, passthrough) bit for bit."""
    import inspect
    from dnascent_tpu import native as jn
    from dnascent_tpu.ops import banded as jbanded
    from dnascent_tpu.ops import scaling as jscaling
    from dnascent_tpu_torch import native as tn

    case, records, pms, jmodels, cfg, _ = prep_case
    _, calls, _ = _prep(records, pms, cfg)
    assert len(calls) == (2 if case in ("painted", "theilsen_sizes") else 1)
    seen = dict(passed=0, failed=0, passth=0, strides=set())
    mp, trim = cfg.scaling.theilsen_max_points, cfg.scaling.theilsen_trim
    for a, kw, (pairs, offs, ok) in calls:
        arg = inspect.signature(tn.prep_decode_group).bind(*a, **kw).arguments
        o = arg["offsets"]
        best_e = arg["best_event"]
        for b in range(o.shape[0] - 1):
            (e0, q0, r0, t0), (e1, q1, r1, t1) = o[b], o[b + 1]
            nk = q1 - q0
            mu, inv, lpc = jbanded.prepare_emission_coefficients(
                arg["rq"][None, q0:q1], jmodels.pore_model)
            q2r = np.full(nk, -1, np.int64)
            src = arg["q2r"][t0:t1][:nk]
            q2r[: src.shape[0]] = src
            jp, cs, cr, avg, spanned, gap = jn.decode_moves(
                arg["packed"], b, int(best_e[b]), nk,
                arg["event_mean"][e0:e1], arg["scaled"][b, : e1 - e0],
                mu[0], inv[0], lpc[0], q2r, arg["rr"][r0:r1])
            want = bool(avg >= cfg.banded.min_average_log_emission
                        and spanned and gap <= cfg.banded.max_gap_threshold
                        and cs.shape[0] >= cfg.banded.min_cleaned_events)
            assert bool(ok[b]) == want, (case, b)
            np.testing.assert_array_equal(pairs[offs[b] : offs[b + 1]], jp)
            if not want:
                assert not arg["sig"][b].any()
                seen["failed"] += 1
                continue
            sig, y, npts, passth = jscaling.theilsen_pregather(
                cs, cr, jmodels.pore_model, mp, trim)
            assert arg["sig"][b].tobytes() == sig.tobytes()
            assert arg["mms"][b].tobytes() == y.tobytes()
            assert (arg["npts"][b], bool(arg["passth"][b])) == (
                npts, passth)
            seen["passed"] += 1
            seen["passth"] += int(passth)
            # the subsample's stride (0: no points), idx = trim + skip*j
            stride = max(1, (cs.shape[0] - 2 * trim) // mp) if npts else 0
            seen["strides"].add((stride, passth))
    assert seen["passed"]
    if case == "painted":
        assert seen["failed"] >= 2
    if case == "passthrough":
        assert seen["passth"] >= 2
    if case == "theilsen_sizes":
        assert seen["strides"] == {(0, True), (1, True), (1, False),
                                   (2, False)}


@pytest.mark.parametrize("nk", [700, 500])
def test_prep_decode_group_synthetic_moves_match_jax(nk):
    """Random packed moves with PAD gaps, as the chase emits them, through
    the decode call, each column against the JAX package's per-read
    ``decode_moves``: pairs, verdict and the Theil-Sen row of its cleaned
    signals, bit for bit.  About one query k-mer in ten has no reference
    position and the reference ranks are random; under loose QC limits the
    walks over 700 k-mers stop short of the first (not spanned, failed)
    and those over 500 reach it (passed)."""
    from dnascent_tpu import native as jn
    from dnascent_tpu.ops import scaling as jscaling
    from dnascent_tpu_torch import native as tn
    rng = np.random.default_rng(7)
    rows, B, ne = 300, 3, 900
    codes = rng.choice(4, (rows, B, 4), p=[0.4, 0.25, 0.15, 0.2])
    packed = (codes << (2 * np.arange(4))).sum(-1).astype(np.uint8)
    means = rng.normal(90, 10, ne)
    scaled = rng.normal(0, 1, ne).astype(np.float32)
    n_model = 4 ** 9
    mu = rng.normal(0, 1, n_model).astype(np.float32)
    inv = np.full(n_model, 7.0, np.float32)
    lpc = np.full(n_model, 0.9, np.float32)
    q2r = np.where(rng.random(nk) < 0.1, -1, np.arange(nk)).astype(np.int64)
    rr = rng.integers(0, n_model, nk - 8).astype(np.int64)
    best_e = np.array([ne - 1 - col for col in range(B)], np.int32)
    # read b's events, query ranks (rank j at k-mer j, so the tables give
    # mu[j]), reference ranks and query_to_ref, concatenated
    offsets = np.array([[b * ne, b * nk, b * (nk - 8), b * nk]
                        for b in range(B + 1)], np.int64)
    mp, trim = 100, 10
    sig = np.zeros((B, mp), np.float32)
    mms = np.zeros((B, mp), np.float32)
    npts = np.zeros(B, np.int32)
    passth = np.zeros(B, np.uint8)
    pairs, offs, ok = tn.prep_decode_group(
        packed, best_e, offsets, np.tile(means, B),
        np.tile(np.arange(nk), B), np.tile(rr, B), np.tile(q2r, B),
        np.tile(scaled, (B, 1)), (mu, inv, lpc), -1e9, 10 ** 6, 0, mp, trim,
        sig, mms, npts, passth)
    pore_model = mu[:, None].astype(np.float64)  # the mean column
    for col in range(B):
        jp, cs, cr, _, spanned, _ = jn.decode_moves(
            packed, col, int(best_e[col]), nk, means, scaled, mu[:nk],
            inv[:nk], lpc[:nk], q2r, rr)
        np.testing.assert_array_equal(pairs[offs[col] : offs[col + 1]], jp)
        assert bool(ok[col]) == spanned == (nk == 500), col
        if not spanned:
            assert not sig[col].any() and not mms[col].any()
            continue
        assert (cs.shape[0] - 2 * trim) // mp >= 2
        want = jscaling.theilsen_pregather(cs, cr, pore_model, mp, trim)
        assert sig[col].tobytes() == want[0].tobytes()
        assert mms[col].tobytes() == want[1].tobytes()
        assert (npts[col], bool(passth[col])) == want[2:]


def test_prepare_reads_matches_jax_host_steps(prep_case):
    """``prepare_reads`` gives every field of every prepared read with the
    bits of the JAX package's host steps run read by read on the port's own
    chase (its fill and chase, held to the JAX package's elsewhere, are
    shared; the JAX package's own fill may break a tie otherwise): event
    detection, k-mer ranks and quantile scaling; ``decode_moves`` of each
    read's column of its fill group's moves with
    ``prepare_emission_coefficients``, and prep's QC; then
    ``theilsen_pregather``, batched in read order for the port's device
    Theil-Sen (the JAX package's differs in its f32 rounding).  Each read's
    device fill row is its events scaled by the quantile shift and scale,
    in f32, then zeros."""
    import inspect
    import torch
    from dnascent_tpu import native as jn
    from dnascent_tpu.ops import banded as jbanded
    from dnascent_tpu.ops import scaling as jscaling
    from dnascent_tpu.pipeline.prep import _detect_and_merge
    from dnascent_tpu_torch import native as tn
    from dnascent_tpu_torch.ops import scaling as tscaling
    from dnascent_tpu_torch.pipeline.prep import devmod

    case, records, pms, jmodels, cfg, jcfg = prep_case
    got, calls, groups = _prep(records, pms, cfg)
    assert len(calls) == len(groups)
    where = {id(p): (g, b) for g, group in enumerate(groups)
             for b, p in enumerate(group)}
    args = [inspect.signature(tn.prep_decode_group).bind(*a, **kw).arguments
            for a, kw, _ in calls]
    want, ts = [], []
    for rec, p in zip(records, got):
        mean, rs, re_, et_n = _detect_and_merge(rec.raw, jcfg)
        rq, rr, few, shift, scale = _jax_scaling(
            jmodels, rec.basecall, rec.reference_seq, mean)
        w = dict(event_mean=mean, event_raw_start=rs, event_raw_end=re_,
                 et_n=et_n, kmer_ranks_query=rq, kmer_ranks_ref=rr,
                 shift=shift, scale=scale, events_per_base=0.0,
                 event_alignment=np.empty((0, 2), np.int64),
                 qc_fail_reason="too_few_events" if few else None,
                 shift_q=0.0 if few else shift,
                 scale_q=1.0 if few else scale)
        want.append(w)
        epb = et_n / max(1, len(rec.basecall) - jcfg.kmer_len)
        if few:
            assert id(p) not in where and p.events_dev is None
            continue
        g, b = where[id(p)]
        arg = args[g]
        assert p.events_row == b
        nk = rq.shape[0]
        mu, inv, lpc = jbanded.prepare_emission_coefficients(
            rq[None, :], jmodels.pore_model)
        q2r = np.full(nk, -1, np.int64)
        src = rec.query_to_ref[:nk]
        q2r[: src.shape[0]] = src
        scaled = ((mean - shift) / scale).astype(np.float32)
        row = p.events_dev[b].numpy()
        assert row[: mean.shape[0]].tobytes() == scaled.tobytes()
        assert not row[mean.shape[0]:].any()
        pairs, cs, cr, avg, spanned, gap = jn.decode_moves(
            arg["packed"], b, int(arg["best_event"][b]), nk, mean, scaled,
            mu[0], inv[0], lpc[0], q2r, rr)
        if not (avg >= jcfg.banded.min_average_log_emission and spanned
                and gap <= jcfg.banded.max_gap_threshold
                and cs.shape[0] >= jcfg.banded.min_cleaned_events):
            w["qc_fail_reason"] = "banded_qc"
            continue
        w["event_alignment"] = pairs
        ts.append((w, epb, jscaling.theilsen_pregather(
            cs, cr, jmodels.pore_model, jcfg.scaling.theilsen_max_points,
            jcfg.scaling.theilsen_trim)))
    assert ts
    B = len(ts)
    mp = jcfg.scaling.theilsen_max_points
    sig = np.zeros((B, mp), np.float32)
    mms = np.zeros((B, mp), np.float32)
    npts = np.zeros(B, np.int32)
    passth = np.ones(B, bool)
    sh = np.zeros(B, np.float32)
    sc = np.ones(B, np.float32)
    for b, (w, _, row) in enumerate(ts):
        sig[b], mms[b], npts[b], passth[b] = row
        sh[b], sc[b] = w["shift"], w["scale"]
    new_sh, new_sc = tscaling.theilsen_refine_pregathered(
        *(torch.from_numpy(a) for a in (sig, mms, npts, passth, sh, sc)))
    for b, (w, epb, _) in enumerate(ts):
        w["shift"], w["scale"] = float(new_sh[b]), float(new_sc[b])
        if w["shift"] == -1.0:
            w["qc_fail_reason"] = "theilsen"
            w["event_alignment"] = np.empty((0, 2), np.int64)
        # eventsPerBase (event_handling.cpp:606)
        w["events_per_base"] = epb
    for p, w in zip(got, want):
        for f, y in w.items():
            x = getattr(p, f)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape, f
                assert x.tobytes() == y.tobytes(), (case, f)
            elif isinstance(x, float):
                assert type(y) is float and _bits(x) == _bits(y), (
                    case, f, x, y)
            else:
                assert x == y, (case, f, x, y)
    reasons = [p.qc_fail_reason for p in got]
    assert None in reasons
    if case == "painted":
        assert "banded_qc" in reasons
    if case == "passthrough":
        assert passth[: len(ts)].sum() >= 2


def test_fill_rows_match_jax_emission_coefficients(models, port_models):
    """A fill group's native rows (kernel A's and kernel E's) against the
    JAX package's ``prepare_emission_coefficients`` of the group's query
    ranks, undefined k-mers read as rank 0 (data_IO.cpp:131), on the static
    table and on a per-k-mer-stdv table: mu (+inf past each read's k-mers
    for kernel A), inv_sigma and lp_const (-inf past them for kernel E),
    the scaled events and the counts, bit for bit; and the model set's
    ``pore_tables`` gathered at the raw ranks, -inf lp_const for an
    undefined k-mer, give the JAX package's coefficients of them (built
    alike for a model set of the JAX package's, which has no cache)."""
    from dnascent_tpu.ops import banded as jbanded
    from dnascent_tpu_torch.pipeline import prep as tprep
    records = _odd_base_records(port_models)[:4] + _sim_records(
        port_models, 2, 2000, 5)
    prepped = [p for p in tprep.quantile_scaled_reads(records, port_models,
                                                      DNA_R10) if p.passed]
    assert len(prepped) == 6
    raw = np.concatenate([p.kmer_ranks_query for p in prepped])
    assert (raw < 0).any()
    B = len(prepped)
    E = max(p.n_events for p in prepped)
    K = max(p.n_kmers for p in prepped)
    ranks = np.full((B, K), -1, np.int64)
    scaled = np.zeros((B, E), np.float32)
    counts = np.zeros((2, B), np.int32)
    for b, p in enumerate(prepped):
        ranks[b, : p.n_kmers] = np.maximum(p.kmer_ranks_query, 0)
        scaled[b, : p.n_events] = (p.event_mean - p.shift) / p.scale
        counts[:, b] = p.n_events, p.n_kmers
    for table in (models.pore_model, models.unlabelled_model):
        pms = dataclasses.replace(port_models, pore_model=table)
        mu, inv, lpc = jbanded.prepare_emission_coefficients(ranks, table)
        lean = tprep.fill_inputs(prepped, pms)
        gen = tprep.general_fill_inputs(prepped, pms)
        for got, want in ((lean[1], np.where(ranks < 0, np.inf, mu)),
                          (gen[1], mu), (gen[2], inv), (gen[3], lpc)):
            assert got.dtype == np.float32
            assert got.tobytes() == want.astype(np.float32).tobytes()
        for arrays in (lean, gen):
            assert arrays[0].tobytes() == scaled.tobytes()
            assert [a.tolist() for a in arrays[-2:]] == counts.tolist()
        t = pms.pore_tables
        assert tprep.pore_tables(pms) is t
        # a model set without the cache (the JAX package's) has them built
        built = tprep.pore_tables(dataclasses.replace(models,
                                                      pore_model=table))
        assert [a.tobytes() for a in built] == [a.tobytes() for a in t]
        assert t.mean.dtype == np.float64
        np.testing.assert_array_equal(t.mean, table[:, 0])
        want = jbanded.prepare_emission_coefficients(raw, table)
        safe = np.maximum(raw, 0)
        got = (t.mu[safe], t.inv_sigma[safe],
               np.where(raw < 0, np.float32(-np.inf), t.lp_const[safe]))
        for g, w in zip(got, want):
            assert g.tobytes() == w.tobytes()


def test_prep_calls_refuse_bad_inputs(port_models):
    """The prep wrappers raise before any pointer reaches the library on
    inputs that do not fit: meta that does not match the inputs or is
    negative, a pore table of two columns, offsets that do not lay out the
    arrays, reads wider than the rows asked for, more reads than shifts, a
    best event outside its read, and Theil-Sen rows too narrow."""
    from dnascent_tpu_torch import native as tn
    from dnascent_tpu_torch.pipeline import prep as tprep
    recs = _sim_records(port_models, 2, 1200, 3)
    p = tprep.quantile_scaled_reads(recs, port_models, DNA_R10)[0]
    mean = port_models.pore_model[:, 0].astype(np.float64)
    seq = "ACGT" * 10
    for meta, pm in (([[40, 40, 5]], mean), ([[40, 41, 6]], mean),
                     ([[-1, 41, 6]], mean),
                     ([[40, 40, 6]], port_models.pore_model)):
        with pytest.raises(ValueError, match="prep_scale_batch"):
            tn.prep_scale_batch(seq.encode(), seq.encode(), meta,
                                np.zeros(6), pm, 9, 10)
    E, K = p.n_events, p.n_kmers
    o = np.array([[0, 0], [E, K]])
    one = np.ones(1)
    ev, rq = p.event_mean, p.kmer_ranks_query
    for offs, e, k, sh in ((o + 1, E, K, one), (o[:, :1], E, K, one),
                           (o, E - 1, K, one), (o, E, K - 1, one),
                           (o, E, K, one[:0])):
        with pytest.raises(ValueError, match="prep_fill_rows"):
            tn.prep_fill_rows(ev, rq, offs, sh, one, 1, e, k)
    scaled, _, n_ev, _ = tn.prep_fill_rows(ev, rq, o, one, one, 1, E, K)
    mp = DNA_R10.scaling.theilsen_max_points
    ts = (np.zeros((1, mp), np.float32), np.zeros((1, mp), np.float32),
          np.zeros(1, np.int32), np.ones(1, np.uint8))
    q2r = p.record.query_to_ref
    o4 = np.array([[0, 0, 0, 0], [E, K, p.kmer_ranks_ref.shape[0],
                                  q2r.shape[0]]])
    rest = (ev, rq, p.kmer_ranks_ref, q2r, scaled,
            port_models.pore_tables[1:], -2.0, 5, 1000, mp, 50)
    packed = np.full((8, 1), 0xFF, np.uint8)
    for offs, best in ((o4, [int(n_ev[0])]), (o4 * 2, [0]),
                       (np.concatenate([o4, o4[1:]]), [0])):
        with pytest.raises(ValueError, match="prep_decode_group"):
            tn.prep_decode_group(packed, np.array(best, np.int32), offs,
                                 *rest, *ts)
    with pytest.raises(ValueError, match="Theil-Sen rows"):
        tn.prep_decode_group(packed, np.zeros(1, np.int32), o4, *rest,
                             ts[0][:, 1:].copy(), *ts[1:])
    pairs, offs, ok = tn.prep_decode_group(packed, np.zeros(1, np.int32),
                                           o4, *rest, *ts)
    assert pairs.shape == (0, 2) and offs.tolist() == [0, 0]
    assert not ok[0]


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
