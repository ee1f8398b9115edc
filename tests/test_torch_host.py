"""The port's own host layer against the JAX package's originals, on the CPU.

The port carries copies of the host modules it needs (config, sequence
tools, pore models, read sources and their signal readers, index and FASTA
readers, the native library, quantile scaling, the SavedModel reader and
writer), so that it imports nothing of ``dnascent_tpu``.  Each copy must
give what the original gives on the same inputs: the golden dataset
(``build_dataset(..., n_reads=4, read_length=1500, signal_format="fast5",
seed=11)``) and seeded numpy data.  Equality is exact throughout.
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
    assert dataclasses.asdict(DNA_R10) == dataclasses.asdict(JAX_R10)


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
def native_eventalign_calls(dataset, models, port_models):
    """The arguments the port's eventalign hands the native window chain and
    window post-processing, recorded on two golden reads (CPU)."""
    import torch
    from dnascent_tpu.io.fasta import import_reference
    from dnascent_tpu.io.index_io import parse_index
    from dnascent_tpu_torch import native as tn
    from dnascent_tpu_torch.pipeline import eventalign as tea, prep as tprep
    from dnascent_tpu_torch.pipeline.source import BamSignalSource

    torch.set_num_threads(2)
    recs = list(BamSignalSource(dataset.bam,
                                import_reference(dataset.reference_fa),
                                parse_index(dataset.index),
                                min_length=1000))[:2]
    calls = {"window_chain": [], "process_read_windows": []}
    mp = pytest.MonkeyPatch()
    for name in calls:
        fn = getattr(tn, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            calls[_name].append((a, kw))
            return _fn(*a, **kw)
        mp.setattr(tn, name, rec)
    try:
        pp = tprep.prepare_reads(recs, port_models, DNA_R10, device="cpu")
        tea.run_eventalign(pp, port_models, DNA_R10)
    finally:
        mp.undo()
    assert all(calls.values()), {k: len(v) for k, v in calls.items()}
    return calls


@pytest.mark.parametrize("name", ["window_chain", "process_read_windows"])
def test_native_eventalign_equal(native_eventalign_calls, name):
    from dnascent_tpu import native as jn
    from dnascent_tpu_torch import native as tn

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
