"""The plain reference agrees with the port on a few tiny reads: the same
call sites, probabilities within the bf16 CNN's spread; and its batched
forms equal their one-at-a-time forms."""

import numpy as np
import pytest
import torch

from perfbench import check, inputs, models
from perfbench.reference import pipeline as ref_pipe

import json
import os
from conftest import ROOT


def _config(name):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as fh:
        return json.load(fh)


def _reads(seed, n=2, bp=1800):
    pool, _ = inputs.make_pool(
        dict(source="memory", pool=n, lengths=dict(kind="fixed", bp=bp),
             min_read_length=1000), inputs.pore_tables(1), seed)
    return pool


@pytest.mark.parametrize("config", ["dnascent_v4_detect", "detectcnn_w128"])
def test_reference_agrees_with_the_port(config):
    from dnascent_tpu_torch.config import DNA_R10
    from dnascent_tpu_torch.io.poremodel import PoreModelSet
    from dnascent_tpu_torch.pipeline.detect import detect_reads
    from perfbench.run import _record

    conf = _config(config)
    tables = inputs.pore_tables(1)
    pool = _reads(77)
    tensors = models.make_tensors(conf, 77, "cpu")
    model = models.program_model(conf, tensors, "cpu")
    ms = PoreModelSet(tables.pore, tables.pore, tables.analogue, 9)
    got = dict(detect_reads([_record(r) for r in pool], ms,
                            model, DNA_R10, device="cpu", batch_size=2,
                            pipeline_depth=1))
    ref = check.reference_calls(pool, conf, tables.pore, tensors, "cpu")
    for r, c in zip(pool, ref):
        d = got[r.read_id]
        assert c is not None and d is not None
        np.testing.assert_array_equal(d.ref_coords, c[0])
        np.testing.assert_array_equal(d.kmer_starts, c[1])
        gap = np.maximum(np.abs(d.brdu_prob - c[3][:, 0]),
                         np.abs(d.edu_prob - c[3][:, 1]))
        # bf16 layers against the f32 reference
        assert gap.mean() < 0.01 and gap.max() < 0.2


def test_batched_reference_equals_one_at_a_time():
    pool = _reads(5, n=3, bp=1500)
    pore = inputs.pore_tables(1).pore
    reads = [check.reference_inputs(r) for r in pool]
    together = ref_pipe.prepare(reads, pore)
    for r, t in zip(reads, together):
        alone = ref_pipe.prepare([r], pore)[0]
        np.testing.assert_array_equal(alone.coord, t.coord)
        np.testing.assert_array_equal(alone.sig_u8, t.sig_u8)


def test_noise_fails_qc_in_the_reference():
    pool, _ = inputs.make_pool(
        dict(source="memory", pool=2, lengths=dict(kind="fixed", bp=1500),
             min_read_length=1000, noise_every=2, noise_at=1),
        inputs.pore_tables(1), 9)
    out = ref_pipe.prepare([check.reference_inputs(r) for r in pool],
                           inputs.pore_tables(1).pore)
    assert out[0] is not None and out[1] is None


def test_weights_are_seeded_and_on_the_device():
    conf = _config("dnascent_v4_detect")
    a = models.make_tensors(conf, 2**31 + 3, "cpu")
    b = models.make_tensors(conf, 2**31 + 3, "cpu")
    c = models.make_tensors(conf, 2**31 + 4, "cpu")
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer2/kernel"], c["layer2/kernel"])
