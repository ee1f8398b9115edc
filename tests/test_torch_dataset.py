"""The port's dataset writer and its signal, FASTA and pore-model writers
against the JAX package's, on the CPU.

``dnascent_tpu_torch.testing.dataset.build_dataset`` builds the file set a
user gives the reference binary (FASTA, pod5 or fast5, BAM, index) on the
port's own simulator and writers.  At the same arguments and seed it must
write what ``dnascent_tpu.testing.dataset.build_dataset`` writes: FASTA, BAM
and index byte for byte (the index with each run's directory prefix
normalised, since it stores absolute signal paths), pod5 byte for byte
(pyarrow writes an Arrow IPC file deterministically for the same tables),
and fast5 by the signals read back through both packages' readers, since
HDF5 object headers may carry creation times.  The VBZ codec's encoders
and the two text writers are held byte-equal on seeded inputs.
"""

import os

import numpy as np
import pytest

from dnascent_tpu.config import DNA_R10 as JAX_R10
from dnascent_tpu.io.poremodel import synthetic_model_set as jax_models
from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.poremodel import synthetic_model_set


def _read(path, mode="rb"):
    with open(path, mode) as fh:
        return fh.read()


@pytest.mark.parametrize("fmt", ["pod5", "fast5"])
def test_build_dataset_equals_jax(tmp_path, fmt):
    from dnascent_tpu.io import fast5_io as jf5, pod5_io as jp5
    from dnascent_tpu.io.index_io import parse_index as jparse
    from dnascent_tpu.testing.dataset import build_dataset as jbuild
    from dnascent_tpu_torch.io import fast5_io as tf5, pod5_io as tp5
    from dnascent_tpu_torch.io.index_io import parse_index as tparse
    from dnascent_tpu_torch.testing.dataset import build_dataset as tbuild

    kw = dict(n_reads=5, read_length=1200, contig_length=20000,
              signal_format=fmt, seed=13, reverse_fraction=0.5)
    a = jbuild(str(tmp_path / "jax"), jax_models(JAX_R10), **kw)
    b = tbuild(str(tmp_path / "port"), synthetic_model_set(DNA_R10), **kw)
    assert b.read_ids == a.read_ids and len(a.read_ids) == 5
    for name in ("reference_fa", "bam"):
        assert _read(getattr(b, name)) == _read(getattr(a, name)), name
    assert (_read(b.index, "r").replace(str(tmp_path / "port"), "OUT")
            == _read(a.index, "r").replace(str(tmp_path / "jax"), "OUT"))
    sig = f"batch0.{fmt}"
    sa, sb = (os.path.join(d.signal_dir, sig) for d in (a, b))
    if fmt == "pod5":
        assert _read(sb) == _read(sa)
    ja, ta = jparse(a.index), tparse(b.index)
    assert sorted(ja) == sorted(ta) == sorted(a.read_ids)
    for rid in a.read_ids:
        if fmt == "pod5":
            got = [tp5.pod5_get_signal(sb, rid), jp5.pod5_get_signal(sb, rid)]
            want = jp5.pod5_get_signal(sa, rid)
        else:
            got = [tf5.fast5_get_signal(sb, rid), jf5.fast5_get_signal(sb, rid)]
            want = jf5.fast5_get_signal(sa, rid)
        assert want.shape[0] > 1000
        for g in got:
            np.testing.assert_array_equal(g, want)


def test_vbz_encoders_equal_jax():
    from dnascent_tpu.io import pod5_io as j
    from dnascent_tpu_torch.io import pod5_io as t
    rng = np.random.default_rng(8)
    assert t.POD5_SIGNATURE == j.POD5_SIGNATURE
    # one- and two-byte zig-zag deltas; a delta must fit in 16 bits
    for n, spread in ((1, 1), (7, 100), (4001, 30), (20000, 3000)):
        x = rng.normal(0, spread, n).round().astype(np.int16)
        zz = t._zigzag_encode(np.diff(x.astype(np.int32), prepend=0))
        np.testing.assert_array_equal(
            zz, j._zigzag_encode(np.diff(x.astype(np.int32), prepend=0)))
        assert t.svb16_encode(zz) == j.svb16_encode(zz)
        blob = t.vbz_compress(x)
        assert blob == j.vbz_compress(x)
        np.testing.assert_array_equal(t.vbz_decompress(blob, n), x)


def test_text_writers_equal_jax(tmp_path):
    from dnascent_tpu.io import fasta as jfa, poremodel as jpm
    from dnascent_tpu_torch.io import fasta as tfa, poremodel as tpm
    rng = np.random.default_rng(9)
    ref = {f"c{i}": "".join(rng.choice(list("ACGTN"), n))
           for i, n in enumerate((0, 79, 80, 81, 1000))}
    for width in (80, 7):
        tfa.write_fasta(ref, str(tmp_path / "t.fa"), width=width)
        jfa.write_fasta(ref, str(tmp_path / "j.fa"), width=width)
        assert _read(tmp_path / "t.fa") == _read(tmp_path / "j.fa")
    assert tfa.import_reference(str(tmp_path / "t.fa")) == ref
    table = np.stack([rng.normal(90, 10, 4 ** 4),
                      rng.uniform(1, 3, 4 ** 4)], axis=1)
    for with_stdv in (True, False):
        tpm.write_model_tsv(table, str(tmp_path / "t.model"), 4, with_stdv)
        jpm.write_model_tsv(table, str(tmp_path / "j.model"), 4, with_stdv)
        assert (_read(tmp_path / "t.model")
                == _read(tmp_path / "j.model"))


def test_writers_without_their_library_raise(tmp_path, monkeypatch):
    """A writer whose library is absent raises the JAX writer's
    RuntimeError and writes no file in another format."""
    from dnascent_tpu_torch.io import fast5_io, pod5_io
    reads = [("00000000-0000-4000-8000-000000000000", np.ones(10))]
    monkeypatch.setattr(pod5_io, "HAVE_ZSTD", False)
    with pytest.raises(RuntimeError, match="pyarrow\\+zstandard required"):
        pod5_io.write_pod5(str(tmp_path / "x.pod5"), reads)
    with pytest.raises(RuntimeError, match="zstandard unavailable"):
        pod5_io.vbz_compress(np.zeros(4, np.int16))
    monkeypatch.setattr(fast5_io, "HAVE_H5PY", False)
    with pytest.raises(RuntimeError, match="h5py unavailable"):
        fast5_io.write_fast5(str(tmp_path / "x.fast5"), reads)
    assert not list(tmp_path.iterdir())


def test_fast5_vbz_round_trip(tmp_path):
    """``write_fast5(vbz=True)`` stores filter 32020 chunks that both
    packages' readers decode to the signal the plain writer stores."""
    from dnascent_tpu.io import fast5_io as j
    from dnascent_tpu_torch.io import fast5_io as t
    rng = np.random.default_rng(10)
    reads = [(f"r{i}", rng.normal(90, 15, n)) for i, n in enumerate((5, 3000))]
    t.write_fast5(str(tmp_path / "vbz.fast5"), reads, vbz=True)
    t.write_fast5(str(tmp_path / "raw.fast5"), reads)
    assert t.VBZ_FILTER_OPTS == j.VBZ_FILTER_OPTS
    for rid, _ in reads:
        want = j.fast5_get_signal(str(tmp_path / "raw.fast5"), rid)
        for reader in (t, j):
            np.testing.assert_array_equal(
                reader.fast5_get_signal(str(tmp_path / "vbz.fast5"), rid),
                want)
