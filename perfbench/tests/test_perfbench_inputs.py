"""The traffic generator and the file writers: deterministic by seed,
the same set of lengths for every seed, and files the port reads back as
the reads the benchmark made."""

import numpy as np

from perfbench import inputs

MIXED = dict(source="pod5", pool=12,
             lengths=dict(kind="lognormal", median_bp=1800, sigma=0.5,
                          min_bp=400, max_bp=4000, length_seed=7),
             min_read_length=1000, reverse_share=0.3, contig_bp=30000,
             paint=dict(min_bp=2000, patterns={"right": 3, "left": 3,
                                               "origin": 2}))
MEMORY = dict(source="memory", pool=5, lengths=dict(kind="fixed", bp=1500),
              min_read_length=1000, noise_every=3, noise_at=1)


def _pool(traffic, seed):
    return inputs.make_pool(traffic, inputs.pore_tables(1), seed)


def test_same_seed_same_reads():
    a, ca = _pool(MIXED, 2**31 + 5)
    b, cb = _pool(MIXED, 2**31 + 5)
    assert ca == cb
    for x, y in zip(a, b):
        assert (x.read_id, x.refseq, x.is_reverse) == \
            (y.read_id, y.refseq, y.is_reverse)
        np.testing.assert_array_equal(x.raw, y.raw)


def test_seeds_share_the_lengths_not_the_reads():
    a, _ = _pool(MIXED, 11)
    b, _ = _pool(MIXED, 12)
    assert sorted(r.length for r in a) == sorted(r.length for r in b)
    assert [r.refseq for r in a] != [r.refseq for r in b]
    assert all(r.length >= 1000 for r in a)
    assert sum(r.is_reverse for r in a) == sum(r.is_reverse for r in b)


def test_memory_mix_noise_reads():
    pool, contig = _pool(MEMORY, 3)
    assert contig is None
    assert [r.noise for r in pool] == [i % 3 == 1 for i in range(5)]
    clean = pool[0]
    # error-free: the signal follows the pore table's levels
    assert abs(np.median(clean.raw) - 90.0) < 20.0


def test_port_reads_the_files_back(tmp_path):
    from dnascent_tpu_torch.io.fasta import import_reference
    from dnascent_tpu_torch.io.index_io import parse_index
    from dnascent_tpu_torch.pipeline.source import BamSignalSource

    pool, contig = _pool(MIXED, 21)
    files = inputs.write_files(str(tmp_path), MIXED, pool, contig)
    src = BamSignalSource(files.bam, import_reference(files.fasta),
                          parse_index(files.index), min_length=1000)
    got = {r.read_id: r for r in src}
    assert set(got) == {r.read_id for r in pool}
    for r in pool:
        g = got[r.read_id]
        assert g.is_reverse == r.is_reverse
        assert g.reference_seq == r.seq and g.basecall == r.seq
        assert g.ref_start == r.ref_start
        # pA stored as int16 counts of the calibration scale, read back
        np.testing.assert_allclose(g.raw, r.raw, atol=1e-9)
