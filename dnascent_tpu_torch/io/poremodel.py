"""Pore-model tables: 4^k entries of (mean, stdv) per k-mer (a copy of
``dnascent_tpu/io/poremodel.py``: the loaders, trainGMM's table reader, the
synthetic tables and the TSV writer).

Three tables are used at runtime, mirroring the reference's startup loads
(reference: src/config.h:52-54):

* ``pore_model``       — ONT nucleotide model, static stdv 0.14
                         (import_poreModel_staticStdv, data_IO.cpp:144-190)
* ``unlabelled_model`` — fitted Gaussian unlabelled model
                         (import_poreModel_fitStdv, data_IO.cpp:193-242)
* ``analogue_model``   — fitted Gaussian BrdU model

Tables are dense float32 arrays of shape (4^k, 2) indexed by the base-4 k-mer
rank, designed for device-side gathers.  Because the reference repository does
not ship the model data files, a deterministic synthetic generator is provided
for tests and benchmarks; real ONT/fitted TSVs load through the same paths.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import SubstrateConfig, default_models_dir
from ..utils.seqtools import kmer2index


@dataclass
class PoreModelSet:
    """The three model tables, ready for device upload."""

    pore_model: np.ndarray        # (4^k, 2) float32: ONT nucleotide model, static stdv
    unlabelled_model: np.ndarray  # (4^k, 2) float32: fitted unlabelled Gaussian
    analogue_model: np.ndarray    # (4^k, 2) float32: fitted BrdU Gaussian
    kmer_len: int

    def table(self, use_fit: bool) -> np.ndarray:
        """Select between ONT and fitted-unlabelled tables the way the
        ``useFitPoreModel`` flag does (event_handling.cpp:117-124)."""
        return self.unlabelled_model if use_fit else self.pore_model


def _parse_model_tsv(path: str, kmer_len: int, static_stdv: float | None) -> np.ndarray:
    """Parse a pore-model TSV into a dense (4^k, 2) table.

    Static-stdv variant keeps only column 2 (mean) and forces stdv
    (data_IO.cpp:173); fit-stdv variant reads mean and stdv columns
    (data_IO.cpp:219-225).  Header lines start with '#'; a first line whose
    first column is not a valid k-mer (e.g. trainGMM's column header) is
    skipped.
    """
    table = np.zeros((4 ** kmer_len, 2), dtype=np.float32)
    with open(path, "r") as fh:
        for line in fh:
            if not line.strip() or line[0] == "#":
                continue
            cols = line.rstrip("\n").split("\t")
            kmer = cols[0]
            if len(kmer) != kmer_len or any(c not in "ATGC" for c in kmer):
                continue  # tolerate header rows
            idx = kmer2index(kmer, kmer_len)
            mean = float(cols[1])
            stdv = static_stdv if static_stdv is not None else float(cols[2])
            table[idx, 0] = mean
            table[idx, 1] = stdv
    return table


def import_pore_model_static_stdv(path: str, kmer_len: int, static_stdv: float = 0.14) -> np.ndarray:
    return _parse_model_tsv(path, kmer_len, static_stdv)


def import_pore_model_fit_stdv(path: str, kmer_len: int) -> np.ndarray:
    return _parse_model_tsv(path, kmer_len, None)


def import_traingmm_model(path: str, kmer_len: int) -> np.ndarray:
    """Parse the TSV emitted by trainGMM (columns: kmer, ONT_mean, ONT_stdv,
    pi_1, mean_1, stdv_1, pi_2, mean_2, stdv_2, ...; trainGMM.cpp:468,521) into
    a fit-stdv table using the second mixture component."""
    table = np.zeros((4 ** kmer_len, 2), dtype=np.float32)
    with open(path, "r") as fh:
        for line in fh:
            if not line.strip() or line[0] == "#":
                continue
            cols = line.rstrip("\n").split("\t")
            kmer = cols[0]
            if len(kmer) != kmer_len or any(c not in "ATGC" for c in kmer):
                continue
            idx = kmer2index(kmer, kmer_len)
            table[idx, 0] = float(cols[7])  # mean_2
            table[idx, 1] = float(cols[8])  # stdv_2
    return table


# ---------------------------------------------------------------------------
# Synthetic models (the reference's pore_models/ data files are not shipped in
# this mount; tests and benchmarks use this deterministic stand-in).
# ---------------------------------------------------------------------------

def synthetic_model_table(kmer_len: int, seed: int = 0, analogue_shift: float = 0.0,
                          stdv: float | None = None) -> np.ndarray:
    """Deterministic synthetic (mean, stdv) table covering all 4^k k-mers.

    Real ONT R10.4.1 9-mer tables are expressed in *normalised* signal units
    (means roughly in [-2.5, 2.5], which is why the reference's forced static
    stdv of 0.14 is sensible; data_IO.cpp:173).  The per-read shift/scale maps
    raw pA onto these units.  Means depend smoothly on base composition with
    pseudo-random k-mer-specific structure; ``analogue_shift`` perturbs k-mers
    containing T, emulating a BrdU-substituted table.
    """
    n = 4 ** kmer_len
    rng = np.random.default_rng(seed)
    idx = np.arange(n, dtype=np.int64)
    # per-position base codes
    codes = np.empty((n, kmer_len), dtype=np.int64)
    tmp = idx.copy()
    for i in range(kmer_len - 1, -1, -1):
        codes[:, i] = tmp % 4
        tmp //= 4
    base_level = np.array([0.35, -0.75, 1.15, -1.05])  # A,T,G,C (normalised)
    # central bases dominate the pore current
    w = np.exp(-0.5 * ((np.arange(kmer_len) - (kmer_len - 1) / 2) / 1.6) ** 2)
    w = w * kmer_len / w.sum()
    means = (base_level[codes] * w).mean(axis=1) * 1.6
    means = means + rng.normal(0.0, 0.35, size=n)  # kmer-specific structure
    if analogue_shift != 0.0:
        hasT = (codes == 1).any(axis=1)
        means = means + hasT * analogue_shift
    if stdv is None:
        stdvs = 0.10 + 0.08 * rng.random(n)
    else:
        stdvs = np.full(n, stdv)
    return np.stack([means, stdvs], axis=1).astype(np.float32)


def synthetic_model_set(cfg: SubstrateConfig) -> PoreModelSet:
    k = cfg.kmer_len
    pore = synthetic_model_table(k, seed=1)
    pore[:, 1] = cfg.static_stdv
    unlab = synthetic_model_table(k, seed=1)
    analogue = synthetic_model_table(k, seed=1, analogue_shift=0.40)
    return PoreModelSet(pore_model=pore, unlabelled_model=unlab,
                        analogue_model=analogue, kmer_len=k)


def load_model_set(cfg: SubstrateConfig, models_dir: str | None = None,
                   allow_synthetic: bool = True) -> PoreModelSet:
    """Load the three tables from ``models_dir`` (falling back to the package's
    ``pore_models/`` directory, mirroring the exe-relative lookup at
    data_IO.cpp:146-147).  When the files are absent and ``allow_synthetic``
    is set, fall back to the deterministic synthetic tables."""
    d = models_dir or default_models_dir()
    paths = {
        "pore": os.path.join(d, cfg.fn_unlabelled_model),
        "unlab": os.path.join(d, cfg.fn_fit_unlabelled_model),
        "analogue": os.path.join(d, cfg.fn_fit_analogue_model),
    }
    if all(os.path.exists(p) for p in paths.values()):
        return PoreModelSet(
            pore_model=import_pore_model_static_stdv(paths["pore"], cfg.kmer_len, cfg.static_stdv),
            unlabelled_model=import_pore_model_fit_stdv(paths["unlab"], cfg.kmer_len),
            analogue_model=import_pore_model_fit_stdv(paths["analogue"], cfg.kmer_len),
            kmer_len=cfg.kmer_len,
        )
    if not allow_synthetic:
        missing = [p for p in paths.values() if not os.path.exists(p)]
        raise FileNotFoundError(f"missing pore model files: {missing}")
    return synthetic_model_set(cfg)


def write_model_tsv(table: np.ndarray, path: str, kmer_len: int, with_stdv: bool = True) -> None:
    """Write a table back to the reference TSV layout."""
    from ..utils.seqtools import index2kmer

    with open(path, "w") as fh:
        fh.write("#kmer\tlevel_mean\tlevel_stdv\n" if with_stdv else "#kmer\tlevel_mean\n")
        for i in range(table.shape[0]):
            kmer = index2kmer(i, kmer_len)
            if with_stdv:
                fh.write(f"{kmer}\t{table[i,0]:.6f}\t{table[i,1]:.6f}\n")
            else:
                fh.write(f"{kmer}\t{table[i,0]:.6f}\n")
