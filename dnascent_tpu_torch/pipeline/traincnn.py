"""trainCNN's training tables (port of
``dnascent_tpu/pipeline/traincnn.py::generate_training_tables``; reference
trainCNN.cpp:194-360): the detect pipeline's calls, then eventalign again
with the calls attached, so the table's rows carry each called position's
EdU and BrdU probabilities.  Fitting a CNN (``trainCNN --fit``) is not
ported.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np

from .. import device as devmod
from ..config import DNA_R10, SubstrateConfig
from ..io.poremodel import PoreModelSet
from .detect import DetectModel, collect_calls, run_cnn_batched
from .eventalign import run_eventalign
from .prep import prepare_reads


def generate_training_tables(records, models: PoreModelSet,
                             model: DetectModel,
                             cfg: SubstrateConfig = DNA_R10,
                             device="cuda") -> Iterator[str]:
    """detect's calls on ``records`` (fast eventalign, then ``model``, which
    must live on ``device``), then fast eventalign again with the calls
    attached (trainCNN.cpp:327-335).  Yields one annotated table a read
    that passes both passes, in order."""
    dev = devmod.resolve(device)
    model.eval()
    model_table = devmod.put_rep(models.pore_model.astype(np.float32), dev)
    prepped = prepare_reads(list(records), models, cfg, device=dev)
    results = run_eventalign(prepped, models, cfg, model_table=model_table)
    probs = run_cnn_batched(model, results, prepped, dev)
    calls_per_read = {}
    for p in prepped:
        rid = p.record.read_id
        if rid not in probs or not results[rid].qc_passed:
            continue
        d = collect_calls(p.record, results[rid].positions, probs[rid])
        calls_per_read[rid] = {
            int(c): (float(e), float(b))
            for c, e, b in zip(d.ref_coords, d.edu_prob, d.brdu_prob)}
    results2 = run_eventalign(prepped, models, cfg, collect_text=True,
                              calls_per_read=calls_per_read,
                              model_table=model_table)
    for p in prepped:
        res = results2.get(p.record.read_id)
        if res is not None and res.qc_passed and res.text:
            yield res.text
