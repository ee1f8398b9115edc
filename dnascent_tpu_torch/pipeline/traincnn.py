"""trainCNN: the training tables and the fitting of a detect CNN (port of
``dnascent_tpu/pipeline/traincnn.py``; reference trainCNN.cpp:194-360).

* ``generate_training_tables``: the detect pipeline's calls, then
  eventalign again with the calls attached, so the table's rows carry each
  called position's EdU and BrdU probabilities (the reference's trainCNN);
* ``train_detect_cnn``: fitting a detect CNN (the DetectCNN or the
  reference topology) from labelled per-position examples with AdamW,
  ``trainCNN --fit``, which the JAX package adds over the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from .. import device as devmod
from ..config import DNA_R10, SubstrateConfig
from ..io.poremodel import PoreModelSet
from ..models import cnn as cnn_mod, reference_cnn
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
    model_table = devmod.put_rows(models.pore_model.astype(np.float32), dev)
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


# ---------------------------------------------------------------------------
# Fitting (``trainCNN --fit``)
# ---------------------------------------------------------------------------

@dataclass
class TrainBatch:
    core_idx: np.ndarray   # (B, L) int32
    residual_idx: np.ndarray
    signal: np.ndarray     # (B, L, RAWDEPTH) f32
    labels: np.ndarray     # (B, L) int32 in {0, 1, 2}; -1 = ignore
    mask: np.ndarray       # (B, L) bool


# the output columns of the reference's detect CNN (detect.cpp:686-714)
LABEL_IDS = {"Thym": 0, "BrdU": 1, "EdU": 2}


def batches_from_labelled_reads(records_and_labels, models: PoreModelSet,
                                cfg: SubstrateConfig = DNA_R10,
                                seq_len: int = 1024, batch_size: int = 8,
                                device="cuda") -> Iterator[TrainBatch]:
    """Fixed-shape training batches from (ReadRecord, label per reference
    index) pairs: prep and fast eventalign on ``device``, each read's
    aligned positions cut into ``seq_len`` chunks (only centre-T positions
    keep their label), the chunks shuffled by ``default_rng(0)`` and packed
    ``batch_size`` to a batch; the tail batch is padded with label -1."""
    dev = devmod.resolve(device)
    chunks = []
    recs = [r for r, _ in records_and_labels]
    labels_by_id = {r.read_id: lab for r, lab in records_and_labels}
    prepped = prepare_reads(recs, models, cfg, device=dev)
    results = run_eventalign(prepped, models, cfg)
    for p in prepped:
        res = results.get(p.record.read_id)
        if res is None or not res.qc_passed:
            continue
        pos = res.positions
        lab_ref = labels_by_id[p.record.read_id]
        lab = lab_ref[np.clip(pos.ref_idx, 0, lab_ref.shape[0] - 1)]
        lab = np.where(pos.center_is_T, lab, -1)  # only T positions scored
        n = pos.coord.shape[0]
        for s in range(0, n, seq_len):
            e = min(s + seq_len, n)
            chunks.append((pos.core_idx[s:e], pos.residual_idx[s:e],
                           pos.signal[s:e], lab[s:e]))
    rng = np.random.default_rng(0)
    rng.shuffle(chunks)
    for i in range(0, len(chunks), batch_size):
        B = batch_size
        core = np.zeros((B, seq_len), dtype=np.int32)
        resid = np.zeros((B, seq_len), dtype=np.int32)
        sig = np.zeros((B, seq_len, cnn_mod.RAWDEPTH), dtype=np.float32)
        lab = np.full((B, seq_len), -1, dtype=np.int32)
        for b, (c, r, sg, lb) in enumerate(chunks[i : i + batch_size]):
            n = c.shape[0]
            core[b, :n] = c
            resid[b, :n] = r
            sig[b, :n] = sg
            lab[b, :n] = lb
        yield TrainBatch(core, resid, sig, lab, lab >= 0)


def make_optimizer(params, learning_rate: float = 3e-4):
    """``optax.adamw(learning_rate)`` with its defaults, which differ from
    torch's in the weight decay (1e-4, not 1e-2)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def reference_arch_trainer(seed: int = 0, learning_rate: float = 3e-4,
                           device="cuda"):
    """(model, optimizer) for fitting the reference topology from its seeded
    synthetic weights.  The BatchNorm moving statistics are frozen: out of
    the optimizer and without gradients."""
    model = reference_cnn.params_from_tensors(
        reference_cnn.ReferenceDetectCNN(),
        reference_cnn.synthetic_tensors(seed)).to(devmod.resolve(device))
    for p in reference_cnn.frozen_parameters(model):
        p.requires_grad_(False)
    return model, make_optimizer(
        [p for p in model.parameters() if p.requires_grad], learning_rate)


def save_model(model: DetectModel, path: str) -> None:
    """The model's weights as the JAX package's npz (``save_params``)."""
    if isinstance(model, reference_cnn.ReferenceDetectCNN):
        reference_cnn.save_params(model, path)
    else:
        cnn_mod.save_params(model, path)


def masked_nll(model: DetectModel, batch: dict):
    """(the sum of the negative log-probabilities of the labels over the
    masked positions, probabilities clipped to [1e-9, 1]; the mask count)
    of a batch (a dict of ``TrainBatch``'s arrays on the model's device:
    core, residual, signal, labels, mask)."""
    probs = model(batch["core"], batch["residual"], batch["signal"])
    logp = torch.log(torch.clamp(probs, 1e-9, 1.0))
    labels = torch.clamp(batch["labels"], 0, 2).long()
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch["mask"].float()
    return (nll * mask).sum(), mask.sum()


def make_train_step(model: DetectModel, optimizer):
    """One step on a batch (as :func:`masked_nll` takes it): the mean
    negative log-probability of the label over the masked positions, its
    gradient, the optimizer's update.  Returns the loss (a 0-dim tensor on
    the model's device)."""
    def step(batch):
        optimizer.zero_grad(set_to_none=True)
        total, count = masked_nll(model, batch)
        loss = total / torch.clamp(count, min=1.0)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_detect_cnn(batches, model: Optional[DetectModel] = None,
                     learning_rate: float = 3e-4, epochs: int = 1,
                     log_every: int = 50, callback=None,
                     checkpoint_path: Optional[str] = None,
                     checkpoint_every: int = 500, optimizer=None,
                     device="cuda"):
    """Fit ``model`` (the DetectCNN, seeded untrained weights, when None)
    on ``batches`` for ``epochs`` on ``device``; the model runs the
    inference form of its BatchNorm throughout.  ``callback(i, loss)`` is
    called every ``log_every``-th batch of an epoch; with
    ``checkpoint_path`` the weights are written (the JAX package's npz)
    every ``checkpoint_every`` steps and at the end.  Returns (model,
    losses)."""
    dev = devmod.resolve(device)
    if model is None:
        model = cnn_mod.init_untrained(cnn_mod.DetectCNN())
    model = model.to(dev)
    if optimizer is None:
        optimizer = make_optimizer(
            [p for p in model.parameters() if p.requires_grad],
            learning_rate)
    step = make_train_step(model, optimizer)
    losses = []
    global_step = 0
    batch_list = list(batches)
    put = lambda a: devmod.put_rows(a, dev)
    for _ in range(epochs):
        for i, b in enumerate(batch_list):
            loss = float(step({
                "core": put(b.core_idx), "residual": put(b.residual_idx),
                "signal": put(b.signal), "labels": put(b.labels),
                "mask": put(b.mask)}))
            losses.append(loss)
            global_step += 1
            if callback and i % log_every == 0:
                callback(i, loss)
            if (checkpoint_path is not None
                    and global_step % checkpoint_every == 0):
                save_model(model, checkpoint_path)
    if checkpoint_path is not None:
        save_model(model, checkpoint_path)
    return model, losses
