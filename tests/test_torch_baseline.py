"""The port's copy of the benchmark-only scalar C++ CPU baseline
(``dnascent_tpu_torch/native/baseline_cpu.cpp``, built into the port's
native library) against the JAX package's: the same checksum to the last
bit on ``tests/test_native_baseline.py``'s read (seed 100, 3 kb), NaN on its
noise read (a QC failure), and a rebuild when either source is newer than
the library; and its timed loop over read records, pinned to one core."""

import os

import numpy as np

from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.poremodel import synthetic_model_set


def _read_inputs(rec, cfg):
    """(raw, query ranks, reference ranks, query_to_ref padded with -1) of
    one read record."""
    from dnascent_tpu_torch.utils.seqtools import kmer_ranks
    rq = kmer_ranks(rec.basecall, cfg.kmer_len)
    rr = kmer_ranks(rec.reference_seq, cfg.kmer_len)
    q2r = np.full(rq.shape[0], -1, np.int64)
    m = min(rec.query_to_ref.shape[0], rq.shape[0])
    q2r[:m] = rec.query_to_ref[:m]
    return rec.raw, rq, rr, q2r


def _baseline_inputs(models, cfg):
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    rec = next(iter(SimulatedSource(models, cfg, n_reads=1, length=3000,
                                    seed=100)))
    return (*_read_inputs(rec, cfg), models.pore_model.astype(np.float64))


def test_baseline_checksum_equals_jax_native(cfg, models):
    from dnascent_tpu import native as jn
    from dnascent_tpu_torch import native as tn
    want = jn.baseline_detect_read(*_baseline_inputs(models, cfg), cfg)
    got = tn.baseline_detect_read(
        *_baseline_inputs(synthetic_model_set(DNA_R10), DNA_R10), DNA_R10)
    assert np.isfinite(want) and want != 0.0
    assert got == want


def test_baseline_flags_qc_failure():
    from dnascent_tpu_torch import native as tn
    cfg = DNA_R10
    rng = np.random.default_rng(0)
    raw = rng.uniform(0.0, 1.0, 4000)  # flat noise, no event structure
    n = 500
    rq = rng.integers(0, 4 ** cfg.kmer_len, n).astype(np.int64)
    rr = rng.integers(0, 4 ** cfg.kmer_len, n).astype(np.int64)
    q2r = np.arange(n, dtype=np.int64)
    got = tn.baseline_detect_read(
        raw, rq, rr, q2r,
        synthetic_model_set(cfg).pore_model.astype(np.float64), cfg)
    assert np.isnan(got)


def test_library_rebuilds_when_either_source_is_newer(monkeypatch):
    """The rebuild check covers both sources: a library older than
    ``baseline_cpu.cpp`` alone is rebuilt."""
    from dnascent_tpu_torch import native as tn
    assert tn.available()
    assert [os.path.basename(s) for s in tn._SRCS] == [
        "dnascent_native.cpp", "baseline_cpu.cpp"]
    built = []
    monkeypatch.setattr(tn, "_build", lambda: built.append(True))
    monkeypatch.setattr(tn, "_lib", None)
    lib_mtime = os.path.getmtime(tn._LIB)
    real = os.path.getmtime

    def mtime(path):
        if path == tn._SRCS[1]:
            return lib_mtime + 1.0
        return min(real(path), lib_mtime) if path in tn._SRCS else real(path)

    monkeypatch.setattr(tn.os.path, "getmtime", mtime)
    assert tn.available() and built == [True]


def test_time_baseline_reads_at_tiny_size():
    """``time_baseline_reads`` on two simulated 2 kb reads: each read's
    checksum is ``baseline_detect_read``'s on the same inputs, to the bit;
    it ran on the lowest core of the process's affinity, and the affinity
    is what it was before."""
    from dnascent_tpu_torch import native as tn
    from dnascent_tpu_torch.pipeline.source import SimulatedSource
    cfg = DNA_R10
    pms = synthetic_model_set(cfg)
    model = pms.pore_model.astype(np.float64)
    records = list(SimulatedSource(pms, cfg, n_reads=2, length=2000,
                                   seed=101))
    before = os.sched_getaffinity(0)
    core, seconds, checksums = tn.time_baseline_reads(records, model, cfg)
    assert os.sched_getaffinity(0) == before
    assert core == min(before)
    assert len(seconds) == len(checksums) == 2
    assert all(s >= 0.0 for s in seconds)
    for rec, got in zip(records, checksums):
        want = tn.baseline_detect_read(*_read_inputs(rec, cfg), model, cfg)
        assert np.isfinite(want)
        assert np.float64(got).tobytes() == np.float64(want).tobytes()
