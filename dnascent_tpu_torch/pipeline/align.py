"""align: the eventalign table of every read (port of the JAX package's
``align`` loop, ``dnascent_tpu/cli.py:328-375``; reference
alignment.cpp:806-906).

    read source -> prep (events, scaling, banded fill + chase, Theil-Sen)
                -> eventalign, strict (the reference's window coupling) or
                   fast, with its text table
                -> writer

Batches run in the pipeline ``detect_reads`` uses (worker threads, ordered
drain): strict mode's per-round host syncs of one batch overlap the host
work of its neighbours.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from .. import device as devmod
from ..config import DNA_R10, SubstrateConfig
from ..io.poremodel import PoreModelSet
from ..parallel.compute import DeviceLike, as_devices, per_device
from .detect import DetectStats, run_batches
from .eventalign import run_eventalign
from .prep import prepare_reads
from .source import ReadRecord


def align_reads(records: Iterable[ReadRecord], models: PoreModelSet,
                cfg: SubstrateConfig = DNA_R10, device: DeviceLike = "cuda",
                strict: bool = True, batch_size: int = 32,
                stats: Optional[DetectStats] = None,
                pipeline_depth: int = 4):
    """Generator of (read_id, eventalign text or None for a read that failed
    QC) over ``records``, in order, run on ``device`` (one device or a
    device set) in batches of ``batch_size`` reads, ``pipeline_depth``
    batches a device in flight.  ``strict`` (align's default) keeps the
    reference's window coupling; without it windows advance by their full
    span (``--fast-windows``)."""
    devices = as_devices(device)
    tables = per_device(devices, lambda d: devmod.put_rows(
        models.pore_model.astype(np.float32), d))

    def process(batch, dev):
        prepped = prepare_reads(batch, models, cfg, device=dev)
        results = run_eventalign(prepped, models, cfg, collect_text=True,
                                 strict=strict, model_table=tables[dev])
        out = []
        for p in prepped:
            res = results.get(p.record.read_id)
            ok = res is not None and res.qc_passed and res.text
            out.append((p.record.read_id, res.text if ok else None))
        return out

    for batch_out in run_batches(records, process, batch_size,
                                 pipeline_depth, devices):
        for rid, text in batch_out:
            if stats is not None:
                stats.processed += 1
                stats.failed += text is None
            yield rid, text
