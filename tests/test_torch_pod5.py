"""The port's pod5 reader and VBZ codec against the JAX package's (CPU).

The port's zstd stage is pyarrow's codec, the JAX package's is
``zstandard``: frames must be byte-equal in both directions, reads must
come back as the JAX reader returns them (also reads spanning two signal
rows, and reads of a 4096-read file, found through the port's read id ->
row map), and the port's whole pod5 path (dataset writer, ``index``,
``detect --model``) must run in an interpreter where ``zstandard`` and
``h5py`` cannot be imported, calling what the JAX CLI calls on the same
files.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import zstandard

from dnascent_tpu.io import pod5_io as jp5
from dnascent_tpu_torch.io import pod5_io as tp5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# detect --model, the port's CLI against the JAX CLI: the bound
# tests/test_torch_reference_cnn.py holds the --model path to (bf16
# convolutions round at other places in oneDNN and XLA)
CLI_ATOL_MAX, CLI_ATOL_MEAN = 0.05, 0.01


def _signal(case: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(n)
    if case == "extremes":
        # the largest deltas the codec carries (int16 range), alternating:
        # every zig-zag value above 255, so two svb16 bytes each
        return np.tile(np.array([16383, -16384], np.int16), n // 2)
    return rng.normal(0, 300, n).round().astype(np.int16)


def _body(x: np.ndarray) -> bytes:
    return tp5.svb16_encode(
        tp5._zigzag_encode(np.diff(x.astype(np.int32), prepend=0)))


@pytest.mark.parametrize("case, n", [
    ("normal", 1), ("normal", 7), ("normal", 8), ("normal", 9),
    ("normal", 1000), ("normal", 102400), ("extremes", 1000),
    ("no_content_size", 1000)])
def test_vbz_codec_equals_jax(case, n):
    """Encoders byte-equal; each package decodes the other's frames to the
    samples; a frame without a content-size field (as streaming encoders
    write) decodes in both; a sample count the stream does not hold is
    refused."""
    x = _signal(case, n)
    if case == "extremes":
        assert len(_body(x)) == (n + 7) // 8 + 2 * n
    if case == "no_content_size":
        blob = zstandard.ZstdCompressor(
            level=1, write_content_size=False).compress(_body(x))
        assert (zstandard.get_frame_parameters(blob).content_size
                == zstandard.CONTENTSIZE_UNKNOWN)
    else:
        blob = tp5.vbz_compress(x)
        assert blob == jp5.vbz_compress(x)
    np.testing.assert_array_equal(tp5.vbz_decompress(blob, n), x)
    np.testing.assert_array_equal(jp5.vbz_decompress(blob, n), x)
    if n > 1:
        with pytest.raises(ValueError, match="svb16 size"):
            tp5.vbz_decompress(blob, n - 1)


def test_read_spanning_two_signal_rows(tmp_path):
    """A read of more than 102,400 samples is stored as two signal rows;
    the port's file equals the JAX writer's byte for byte, and both readers
    return the stored samples from either file."""
    rng = np.random.default_rng(3)
    reads = [(f"{i:08x}-0000-4000-8000-000000000003",
              rng.normal(90, 15, n)) for i, n in enumerate((150_000, 500))]
    tp5.write_pod5(str(tmp_path / "t.pod5"), reads)
    jp5.write_pod5(str(tmp_path / "j.pod5"), reads)
    with open(tmp_path / "t.pod5", "rb") as a, open(tmp_path / "j.pod5",
                                                    "rb") as b:
        assert a.read() == b.read()
    tables = tp5._open_tables(str(tmp_path / "t.pod5"))
    assert tables.reads.column("signal")[0].as_py() == [0, 1]
    assert tables.signal.column("samples").to_pylist() == [102400, 47600, 500]
    for rid, sig in reads:
        want = np.round(sig / 0.1875).astype(np.int16) * 0.1875
        for path in (tmp_path / "t.pod5", tmp_path / "j.pod5"):
            np.testing.assert_array_equal(
                tp5.pod5_get_signal(str(path), rid), want)
            np.testing.assert_array_equal(
                jp5.pod5_get_signal(str(path), rid), want)


def test_lookup_in_a_4096_read_file(tmp_path):
    """The read id -> row map on a MinKNOW-sized file (4096 reads of 2000
    samples): 64 seeded reads come back as the JAX reader (a scan of every
    read id) returns them; an absent id raises KeyError."""
    rng = np.random.default_rng(4096)
    ids = [f"{i:08x}-0000-4000-8000-000000001000" for i in range(4096)]
    path = str(tmp_path / "big.pod5")
    tp5.write_pod5(path, [(rid, rng.normal(90, 15, 2000)) for rid in ids])
    assert len(tp5._open_tables(path).rows) == 4096
    for i in rng.choice(4096, 64, replace=False):
        got = tp5.pod5_get_signal(path, ids[i])
        assert got.shape == (2000,)
        np.testing.assert_array_equal(got, jp5.pod5_get_signal(path, ids[i]))
    with pytest.raises(KeyError):
        tp5.pod5_get_signal(path, "ffffffff-0000-4000-8000-000000001000")


# The port's pod5 path in a fresh interpreter: a meta-path hook refuses
# zstandard and h5py (the card's host has neither) and the JAX package; the
# port's own writer builds the dataset, its CLI indexes it and runs detect
# on the CPU with a SavedModel of seeded weights.
_NO_ZSTD = r"""
import sys
BLOCKED = ("zstandard", "h5py", "jax", "jaxlib", "flax", "optax",
           "dnascent_tpu")
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None
sys.meta_path.insert(0, _Block())
import os
out = sys.argv[1]
from dnascent_tpu_torch import cli
from dnascent_tpu_torch.config import DNA_R10
from dnascent_tpu_torch.io.index_io import parse_index
from dnascent_tpu_torch.io.poremodel import synthetic_model_set
from dnascent_tpu_torch.models.reference_cnn import seed_affine, synthetic_tensors
from dnascent_tpu_torch.testing.dataset import build_dataset
from dnascent_tpu_torch.testing.tf_bundle_writer import write_savedmodel_dir
ds = build_dataset(os.path.join(out, "ds"), synthetic_model_set(DNA_R10),
                   n_reads=4, read_length=2000, signal_format="pod5",
                   seed=31)
write_savedmodel_dir(os.path.join(out, "model"),
                     seed_affine(synthetic_tensors(5), 15))
idx = os.path.join(out, "idx.dnascent")
assert cli.main(["index", "-f", ds.signal_dir, "-o", idx]) == 0
assert parse_index(idx) == parse_index(ds.index)
assert cli.main(["detect", "-b", ds.bam, "-r", ds.reference_fa, "-i", idx,
                 "-o", os.path.join(out, "port.detect"), "--device", "cpu",
                 "--model", os.path.join(out, "model")]) == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("NO_ZSTD_OK")
"""


def _calls(path):
    heads, rows = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            if line.startswith(">"):
                heads.append(line.rstrip("\n"))
            else:
                rows.append(line.rstrip("\n").split("\t"))
    return heads, rows


def test_pod5_cli_without_zstandard_or_h5py(tmp_path):
    """build_dataset(pod5) -> index -> detect --device cpu --model, with
    zstandard and h5py blocked, against the JAX CLI on the same files and
    SavedModel: read headers, coordinates and k-mers exact, probabilities
    within the --model bound."""
    from dnascent_tpu import cli as jcli

    env = dict(os.environ, DNASCENT_TPU_MODELS="/nonexistent",
               OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", _NO_ZSTD, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_ZSTD_OK" in res.stdout
    ds = tmp_path / "ds"
    jax_out = str(tmp_path / "jax.detect")
    assert jcli.main(["detect", "-b", str(ds / "alignment.bam"), "-r",
                      str(ds / "reference.fa"), "-i",
                      str(tmp_path / "idx.dnascent"), "-o", jax_out,
                      "--model", str(tmp_path / "model")]) == 0
    j_heads, j_rows = _calls(jax_out)
    p_heads, p_rows = _calls(str(tmp_path / "port.detect"))
    assert p_heads == j_heads and len(p_heads) == 4 and len(p_rows) > 400
    assert [(r[0], r[3]) for r in p_rows] == [(r[0], r[3]) for r in j_rows]
    d = np.abs(np.array([[float(x) for x in r[1:3]] for r in p_rows])
               - np.array([[float(x) for x in r[1:3]] for r in j_rows]))
    assert d.max() < CLI_ATOL_MAX and d.mean() < CLI_ATOL_MEAN, \
        (d.max(), d.mean())
