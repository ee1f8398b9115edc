"""PyTorch port, the BrdU/EdU fork workflow of tests/test_workflow_e2e.py on
the CPU: reads painted with analogue tracks, the training batches fitted on
them, detect on painted fork reads and forkSense on its calls, each against
the JAX package on the same seeded inputs; and the painted fork dataset
(FASTA, pod5, BAM, index) read back through the port's read source.

``test_full_workflow_fork_recovery`` (slow, not in tier-1) is the port's
copy of the JAX test of that name at its sizes: fit a small DetectCNN on
painted reads, detect on fork reads, and require the calls to separate the
painted tracks and forkSense to call the fork."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from dnascent_tpu.config import DNA_R10
from tests.test_torch_pipeline import PROB_ATOL_MAX, PROB_ATOL_MEAN
from tests.test_workflow_e2e import _painted_read

# the fork reads of (c) and (d): EdU at 20-45 %, BrdU at 47-72 % of 3 kb
FORK_LEN = 3000
FORK_TRACKS = [("EdU", 600, 1350), ("BrdU", 1410, 2160)]


@pytest.fixture(scope="module")
def port_models():
    from dnascent_tpu_torch.config import DNA_R10 as TCFG
    from dnascent_tpu_torch.io.poremodel import synthetic_model_set
    return synthetic_model_set(TCFG)


def _jax_edu(models):
    edu = models.analogue_model.copy()
    edu[:, 0] -= 0.8
    return edu


def _labels(length, tracks):
    from dnascent_tpu_torch.testing.painted import labels_from_tracks
    return labels_from_tracks(length, tracks)


def _read_fields(r):
    return (r.read_id, r.contig, r.ref_start, r.ref_end, r.is_reverse,
            r.basecall, r.reference_seq)


@pytest.mark.parametrize("length", [1500, 4000])
@pytest.mark.parametrize("seed", [3, 900, 2001])
def test_painted_read_matches_jax(models, port_models, seed, length):
    """(a) ``painted.painted_read`` (with ``painted.edu_model``) is
    ``_painted_read`` (with the JAX test's EdU table) bit for bit: raw
    signal, basecall, the maps and the span."""
    from dnascent_tpu_torch.testing.painted import edu_model, painted_read
    labels = _labels(length, [("BrdU", 200, 700), ("EdU", 900, 1400)])
    want = _painted_read(models, _jax_edu(models), length, labels, seed,
                         f"r{seed}")
    got = painted_read(port_models, edu_model(port_models), length, labels,
                       seed, f"r{seed}")
    assert _read_fields(got) == _read_fields(want)
    for f in ("raw", "ref_to_query", "query_to_ref", "ref_to_del"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
    assert got.raw.dtype == want.raw.dtype


def _painted_pairs(models, port_models, seeds):
    """(JAX pairs, port pairs) of painted 2 kb reads (BrdU 300-900, EdU
    1100-1700) with their labels."""
    from dnascent_tpu_torch.testing.painted import edu_model, painted_read

    labels = _labels(2000, [("BrdU", 300, 900), ("EdU", 1100, 1700)])
    return ([(_painted_read(models, _jax_edu(models), 2000, labels, s,
                            f"t{s}"), labels) for s in seeds],
            [(painted_read(port_models, edu_model(port_models), 2000, labels,
                           s, f"t{s}"), labels) for s in seeds])


def test_painted_batches_match_jax(models, port_models):
    """(b) ``batches_from_labelled_reads`` on 4 painted 2 kb reads (the
    JAX test's training seeds, 900-903; seq_len 512): core, residual,
    signal, labels and mask bitwise equal between the packages."""
    from dnascent_tpu.pipeline import traincnn as jt
    from dnascent_tpu_torch.pipeline import traincnn as tt

    jpairs, tpairs = _painted_pairs(models, port_models, range(900, 904))
    want = list(jt.batches_from_labelled_reads(jpairs, models, DNA_R10,
                                               seq_len=512, batch_size=4))
    got = list(tt.batches_from_labelled_reads(tpairs, port_models,
                                              seq_len=512, batch_size=4,
                                              device="cpu"))
    assert len(got) == len(want) > 1
    for a, b in zip(want, got):
        for f in ("core_idx", "residual_idx", "signal", "labels", "mask"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), f)
    labelled = np.concatenate([b.labels[b.mask] for b in got])
    assert set(np.unique(labelled)) == {0, 1, 2}


def test_painted_prep_tie_flips_against_jax_scan(models, port_models):
    """A divergence painted reads show: on read 40 the JAX CPU prep's XLA
    scan fill flips rounding ties against the Pallas kernel it runs on the
    TPU (the JAX contract allows 2e-3 of the trace codes), which moves
    three events of the event alignment at the EdU track's left edge
    (k-mer 1101).  The port's fill (kernel A's twin) follows the Pallas
    kernel bitwise (next test), so the port's alignment is the Pallas
    kernel's, not the XLA scan's."""
    from dnascent_tpu.pipeline.prep import prepare_reads as jprep
    from dnascent_tpu_torch.pipeline.prep import prepare_reads as tprep

    jpairs, tpairs = _painted_pairs(models, port_models, [40])
    want = jprep([jpairs[0][0]], models, DNA_R10)[0].event_alignment
    got = tprep([tpairs[0][0]], port_models, device="cpu")[0].event_alignment
    assert got.shape == want.shape
    diff = np.nonzero((got != want).any(axis=1))[0]
    assert diff.tolist() == [2416, 2417, 2418]
    assert want[diff, 1].tolist() == [1101, 1101, 1102]
    assert got[diff, 1].tolist() == [1102, 1103, 1103]


def test_painted_fill_matches_jax_pallas(models, port_models):
    """Kernel A's twin on painted read 40's events against the JAX Pallas
    kernel in interpret mode: trace codes, rights and best cell bitwise."""
    from jax.experimental.pallas import tpu as pltpu
    from dnascent_tpu.ops import banded_pallas
    from dnascent_tpu_torch.ops import banded_cuda
    from dnascent_tpu_torch.pipeline import prep as tprep
    import torch

    _, tpairs = _painted_pairs(models, port_models, [40])
    p = tprep.quantile_scaled_reads([tpairs[0][0]], port_models,
                                    tprep.DNA_R10)
    arrays = tprep.fill_inputs(p, port_models)
    inv, lpc = tprep.static_stdv_scalars(port_models.pore_model)
    got = banded_cuda.banded_fill_lean(
        *(torch.from_numpy(a) for a in arrays), inv_sigma=inv, lp_const=lpc)
    with pltpu.force_tpu_interpret_mode():
        want = banded_pallas.banded_fill_pallas_lean(
            *(jnp.asarray(a) for a in arrays), inv_sigma=inv, lp_const=lpc)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def fork_detect(models, port_models, tmp_path_factory):
    """(JAX DetectedReads, port DetectedReads) of 4 painted 3 kb fork reads
    through each package's ``detect_reads``, the port on the CPU with the
    JAX default weights carried across as the npz ``save_params`` writes."""
    import torch
    from dnascent_tpu.models import cnn as jcnn
    from dnascent_tpu.pipeline.detect import detect_reads as jdetect
    from dnascent_tpu_torch.models import cnn as tcnn
    from dnascent_tpu_torch.pipeline.detect import detect_reads as tdetect
    from dnascent_tpu_torch.testing.painted import edu_model, painted_read

    torch.set_num_threads(2)
    labels = _labels(FORK_LEN, FORK_TRACKS)
    jreads = [_painted_read(models, _jax_edu(models), FORK_LEN, labels,
                            2000 + i, f"fork-{i}") for i in range(4)]
    treads = [painted_read(port_models, edu_model(port_models), FORK_LEN,
                           labels, 2000 + i, f"fork-{i}") for i in range(4)]
    params = jcnn.default_params()
    path = str(tmp_path_factory.mktemp("weights") / "jax_default.npz")
    jcnn.save_params(params, path)
    model = tcnn.load_npz(tcnn.DetectCNN(), path)
    want = [d for _, d in jdetect(jreads, models, jcnn.create_model(),
                                  params, DNA_R10, batch_size=4)]
    got = [d for _, d in tdetect(treads, port_models, model, device="cpu",
                                 batch_size=4)]
    return want, got


def test_painted_detect_matches_jax(fork_detect):
    """(c) ``detect_reads`` on the painted fork reads: the same reads pass,
    positions and k-mers exact, probabilities within the DetectCNN spread
    against the JAX jit (``test_torch_pipeline.PROB_ATOL_MAX``/``_MEAN``)."""
    want, got = fork_detect
    assert [d.record.read_id for d in got] == \
        [d.record.read_id for d in want]
    assert len(got) >= 3
    diffs = []
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.ref_coords, a.ref_coords)
        np.testing.assert_array_equal(b.kmer_starts, a.kmer_starts)
        diffs += [np.abs(b.brdu_prob - a.brdu_prob),
                  np.abs(b.edu_prob - a.edu_prob)]
    d = np.concatenate(diffs)
    assert d.max() < PROB_ATOL_MAX and d.mean() < PROB_ATOL_MEAN, \
        (d.max(), d.mean())


# forkSense's marks: the CLI's four (a segment without a fork partner is
# dropped), and the analogue beds alone (every segment is a bed line)
MARKS = {"forks": {}, "analogues": dict(mark_origins=False, mark_terms=False,
                                        mark_forks=False)}


@pytest.mark.parametrize("marks", sorted(MARKS))
def test_forksense_on_painted_calls_matches_jax(fork_detect, marks):
    """(d) ``forksense_run`` in both packages on the JAX detect's calls of
    (c): the same 2-means centroids and every output list (the beds, the
    main table) equal line for line.  Four 3 kb reads hold ~750 calls and
    one call-fraction window each, under forkSense's floors for its two
    passes (2000 calls a read, 10 windows), so both packages run with the
    floors at 500 and 4.  The JAX default weights are untrained: their
    calls make EdU segments (beds of the analogue run) and no fork."""
    from dnascent_tpu.pipeline import forksense as jfs
    from dnascent_tpu_torch.config import DNA_R10 as TCFG
    from dnascent_tpu_torch.pipeline import forksense as tfs

    want, _ = fork_detect

    def run(fsm, cfg):
        cfg = dataclasses.replace(cfg, forksense=dataclasses.replace(
            cfg.forksense, min_read_positions=500,
            min_call_fraction_windows=4))
        reads = [fsm.DetectedReadData(
            read_id=d.record.read_id, contig=d.record.contig,
            ref_start=d.record.ref_start, ref_end=d.record.ref_end,
            strand=d.record.strand, coords=d.ref_coords, edu=d.edu_prob,
            brdu=d.brdu_prob) for d in want]
        inc, outputs = fsm.forksense_run(reads, "EdU,BrdU", cfg,
                                         **MARKS[marks])
        return inc, [dataclasses.asdict(o) for o in outputs]

    (jinc, jout), (tinc, tout) = run(jfs, DNA_R10), run(tfs, TCFG)
    assert dataclasses.asdict(tinc) == dataclasses.asdict(jinc)
    assert len(tout) == len(jout) == len(want)
    assert tout == jout
    if marks == "analogues":
        assert sum(len(o["edu_beds"]) for o in tout) >= 2


def test_painted_fork_dataset_round_trip(port_models, tmp_path):
    """(e) ``painted_fork_dataset``'s pod5 and BAM read back through
    ``BamSignalSource``: the same reads in order, spans and sequences the
    contig's, signals within one ADC step of the painted pA signal; the
    truth file gives each pattern's tracks."""
    from dnascent_tpu_torch.io.fasta import import_reference
    from dnascent_tpu_torch.io.index_io import parse_index
    from dnascent_tpu_torch.pipeline.source import BamSignalSource
    from dnascent_tpu_torch.testing.painted import (
        PATTERNS, edu_model, painted_fork_dataset, painted_signal,
        read_truth)

    ds = painted_fork_dataset(str(tmp_path), port_models, 3, 3, 2,
                              read_length=3000, track_len=(300, 600),
                              margin=300, contig_length=40_000, seed=8,
                              end_fraction=0.5)
    truth = read_truth(ds.truth)
    assert truth == ds.reads
    ref = import_reference(ds.reference_fa)
    records = list(BamSignalSource(ds.bam, ref, parse_index(ds.index),
                                   min_length=1000))
    assert [r.read_id for r in records] == [f.read_id for f in truth]
    assert sum(f.at_end for f in truth) >= 1
    edu = edu_model(port_models)
    for i, (r, f) in enumerate(zip(records, truth)):
        assert (r.contig, r.ref_start, r.ref_end, r.is_reverse) == \
            ("chrP", f.ref_start, f.ref_end, False)
        assert r.reference_seq == r.basecall == \
            ref["chrP"][f.ref_start:f.ref_end]
        assert tuple(k for k, _, _ in f.tracks) == PATTERNS[f.pattern]
        assert all(f.ref_start <= s < e <= f.ref_end
                   for _, s, e in f.tracks)
        want = painted_signal(port_models, edu, r.reference_seq, f.labels,
                              8 + i)
        assert r.raw.shape == want.shape
        assert np.abs(r.raw - want).max() <= 0.1875 / 2 + 1e-9


@pytest.mark.slow
def test_full_workflow_fork_recovery(port_models):
    """The JAX test of this name through the port, at its sizes and gates:
    a DetectCNN of width 96 fitted on 10 painted 3 kb reads for 25 epochs
    (AdamW, 1e-3), detect on 6 painted 10 kb right-fork reads, the calls
    separating the tracks, forkSense calling a right fork over them."""
    import torch
    from dnascent_tpu_torch.config import DNA_R10 as TCFG
    from dnascent_tpu_torch.models import cnn
    from dnascent_tpu_torch.pipeline import forksense as fsm
    from dnascent_tpu_torch.pipeline.detect import detect_reads
    from dnascent_tpu_torch.pipeline.traincnn import (
        batches_from_labelled_reads, train_detect_cnn)
    from dnascent_tpu_torch.testing.painted import edu_model, painted_read

    torch.set_num_threads(4)
    edu = edu_model(port_models)
    labels = _labels(3000, [("BrdU", 400, 1300), ("EdU", 1700, 2600)])
    pairs = [(painted_read(port_models, edu, 3000, labels, 900 + i,
                           f"train-{i}"), labels) for i in range(10)]
    batches = list(batches_from_labelled_reads(pairs, port_models, TCFG,
                                               seq_len=512, batch_size=4,
                                               device="cpu"))
    model = cnn.init_untrained(cnn.DetectCNN(
        d_model=96, d_core=48, d_residual=16, d_signal=48,
        dilations=(1, 2, 4, 8)))
    model, losses = train_detect_cnn(iter(batches), model=model,
                                     learning_rate=1e-3, epochs=25,
                                     device="cpu")
    assert losses[-1] < losses[0] * 0.6

    flabels = _labels(10000, [("EdU", 2000, 4500), ("BrdU", 4700, 7200)])
    fork_reads = [painted_read(port_models, edu, 10000, flabels, 2000 + i,
                               f"fork-{i}") for i in range(6)]
    detected = [d for _, d in detect_reads(fork_reads, port_models, model,
                                           TCFG, device="cpu", batch_size=6)]
    assert len(detected) >= 5

    d0 = detected[0]
    rel = d0.ref_coords - d0.record.ref_start
    in_brdu = (rel >= 4700) & (rel < 7200)
    in_edu = (rel >= 2000) & (rel < 4500)
    outside = ~(in_brdu | in_edu)
    assert d0.brdu_prob[in_brdu].mean() > 2 * d0.brdu_prob[outside].mean()
    assert d0.edu_prob[in_edu].mean() > 2 * d0.edu_prob[outside].mean()

    fs_reads = [fsm.DetectedReadData(
        read_id=d.record.read_id, contig=d.record.contig,
        ref_start=d.record.ref_start, ref_end=d.record.ref_end,
        strand=d.record.strand, coords=d.ref_coords, edu=d.edu_prob,
        brdu=d.brdu_prob) for d in detected]
    _, outputs = fsm.forksense_run(fs_reads, "EdU,BrdU", TCFG)
    right = [line for o in outputs for line in o.right_forks]
    assert len(right) >= 1, "no right forks called"
    lb, ub = (int(c) for c in right[0].split()[1:3])
    assert lb < 10000 + 4500 and ub > 10000 + 4700
