"""Synthetic nanopore signal simulator (a copy of
``dnascent_tpu/testing/simulate.py``).

Generates raw pA signals from a DNA sequence and a pore-model table so that
the full pipeline (event detection -> scaling -> banded alignment -> Viterbi
-> CNN) can be exercised and benchmarked without real pod5/fast5 data (which
the reference mount does not include).  The simulator follows the R10.4.1
generative story: per-kmer dwell (geometric in events, ~12.5 samples/base at
5 kHz / 400 bp/s) and Gaussian level noise around the model mean.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..config import SubstrateConfig, DNA_R10
from ..utils.seqtools import kmer_ranks, reverse_complement


@dataclass
class SimulatedRead:
    read_id: str
    sequence: str          # basecall == reference subsequence (error-free sim)
    raw: np.ndarray        # (S,) float64 raw signal in pA
    shift: float           # true shift used for generation
    scale: float           # true scale
    # per-kmer ground truth:
    dwell_samples: np.ndarray  # (n_kmers,) int


def random_sequence(rng: np.random.Generator, length: int) -> str:
    return "".join(np.array(list("ATGC"))[rng.integers(0, 4, size=length)])


def simulate_read(model: np.ndarray, cfg: SubstrateConfig = DNA_R10,
                  length: int = 5000, seed: int = 0,
                  shift: float = 90.0, scale: float = 16.0,
                  noise: float = 1.2, read_id: str | None = None,
                  sequence: str | None = None,
                  analogue_model: np.ndarray | None = None,
                  analogue_mask: np.ndarray | None = None) -> SimulatedRead:
    """Simulate one read.

    ``analogue_mask`` (n_kmers bool) optionally switches k-mers to
    ``analogue_model`` levels, emulating BrdU/EdU-substituted regions.
    """
    rng = np.random.default_rng(seed)
    if sequence is None:
        sequence = random_sequence(rng, length)
    k = cfg.kmer_len
    ranks = kmer_ranks(sequence, k)
    ranks = np.where(ranks < 0, 0, ranks)
    means = model[ranks, 0].astype(np.float64)
    if analogue_mask is not None and analogue_model is not None:
        means = np.where(analogue_mask[: ranks.shape[0]],
                         analogue_model[ranks, 0].astype(np.float64), means)
    # dwell: mean ~12 samples/base at 5kHz; min 4 so events are detectable
    dwell = 4 + rng.poisson(8.0, size=ranks.shape[0])
    level = shift + scale * means
    raw = np.repeat(level, dwell) + rng.normal(0.0, noise, size=int(dwell.sum()))
    return SimulatedRead(
        read_id=read_id or f"simread-{seed:08d}",
        sequence=sequence,
        raw=raw,
        shift=shift,
        scale=scale,
        dwell_samples=dwell,
    )
