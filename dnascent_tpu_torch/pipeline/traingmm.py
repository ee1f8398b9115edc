"""trainGMM: per-9-mer Gaussian mixture fits from align output (port of
``dnascent_tpu/pipeline/traingmm.py``; reference trainGMM.cpp:376-530).

Event pools per k-mer (capped at ``-e`` events), 1-D DBSCAN outlier removal
(eps 0.5 pA, minPoints 2.5 % of the pool) on the host, then a 2-component
EM whose component 1 is pinned to the ONT model (gaussianMixtureEM_PRIOR,
trainGMM.cpp:185-265).  The k-mers' EM problems are independent, so they
run as one batched, masked, log-space EM in torch on the device, in chunks
of k-mers, for a fixed number of iterations with per-k-mer freezing (the
JAX package's ``lax.scan``; not a hand-written kernel there either).  The
EM runs in f64, as the reference's does, where the JAX package's runs in
f32: a k-mer freezes once its log-likelihood gain drops to the tolerance,
and in f32 that gain moves by ~1e-3 with the order of the sums, so the
iteration a k-mer stops at, and its fit, would depend on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import device as devmod
from ..config import DNA_R10, SubstrateConfig
from ..io.poremodel import PoreModelSet
from ..utils.seqtools import index2kmer, kmer2index


def parse_align_events(path: str, kmer_len: int, max_events: int,
                       max_reads: int | None = None) -> dict[int, np.ndarray]:
    """Stream align output, pooling scaled event means per k-mer
    (trainGMM.cpp:424-463).  Column 2 is the scaled event, column 3 the
    k-mer; N-containing insertion rows are skipped."""
    pools: dict[int, list] = {}
    reads = 0
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line[0] == "#":
                continue
            if line[0] == ">":
                reads += 1
                if max_reads is not None and reads > max_reads:
                    break
                continue
            cols = line.rstrip("\n").split("\t")
            kmer = cols[3]
            if "N" in kmer:
                continue
            idx = kmer2index(kmer, kmer_len)
            pool = pools.setdefault(idx, [])
            if len(pool) < max_events:
                pool.append(float(cols[2]))
    return {k: np.asarray(v) for k, v in pools.items()}


def dbscan_filter_1d(events: np.ndarray, eps: float,
                     min_points: int) -> np.ndarray:
    """Non-noise mask for 1-D DBSCAN (DBSCAN, trainGMM.cpp:143-182).

    A point survives iff it lies within eps of a *core* point (core points
    are within eps of themselves).  Equivalent to the reference's cluster
    expansion, order-independently."""
    order = np.argsort(events, kind="stable")
    s = events[order]
    lo = np.searchsorted(s, s - eps, side="left")
    hi = np.searchsorted(s, s + eps, side="right")
    n_nb = hi - lo
    core = n_nb >= min_points
    # survivors: within eps of any core point
    core_vals = s[core]
    if core_vals.size == 0:
        keep_sorted = np.zeros_like(core)
    else:
        j = np.searchsorted(core_vals, s)
        left = np.where(j > 0, np.abs(s - core_vals[np.maximum(j - 1, 0)]),
                        np.inf)
        right = np.where(j < core_vals.size,
                         np.abs(core_vals[np.minimum(j, core_vals.size - 1)] - s),
                         np.inf)
        keep_sorted = np.minimum(left, right) <= eps
    keep = np.zeros(events.shape[0], dtype=bool)
    keep[order] = keep_sorted
    return keep


def _log_norm(x: torch.Tensor, mu: torch.Tensor,
              sigma: torch.Tensor) -> torch.Tensor:
    z = (x - mu[:, None]) / sigma[:, None]
    return (-0.5 * torch.log(2.0 * math.pi * sigma[:, None] ** 2)
            - 0.5 * z * z)


@torch.no_grad()
def em_prior_batch(data: torch.Tensor, mask: torch.Tensor,
                   mu1: torch.Tensor, sigma1: torch.Tensor,
                   mu2_0: torch.Tensor, sigma2_0: torch.Tensor,
                   pi_init: float, tolerance: float, max_iter: int = 100):
    """Batched, masked, log-space EM with component 1 frozen
    (gaussianMixtureEM_PRIOR, trainGMM.cpp:185-265), in f64 on the device
    of ``data``.  ``data`` (K, M) f32 events, ``mask`` (K, M) bool the live
    ones; ``mu1``, ``sigma1`` (K,) the pinned component, ``mu2_0``,
    ``sigma2_0`` (K,) component 2's start.  Runs ``max_iter`` iterations; a
    k-mer whose log-likelihood stops improving by more than ``tolerance``
    takes that iteration's update and then freezes.  Returns (pi1, pi2,
    mu2, sigma2), each (K,) in the dtype of ``data``."""
    K = data.shape[0]
    out_dtype = data.dtype
    data, mu1, sigma1, mu2_0, sigma2_0 = (
        t.to(torch.float64) for t in (data, mu1, sigma1, mu2_0, sigma2_0))
    f64 = dict(dtype=torch.float64, device=data.device)
    n = mask.sum(dim=1).to(torch.float64).clamp(min=1.0)
    ln1 = _log_norm(data, mu1, sigma1)   # the pinned component's term

    def loglik(pi1, pi2, mu2, sigma2):
        l1 = torch.log(pi1)[:, None] + ln1
        l2 = torch.log(pi2)[:, None] + _log_norm(data, mu2, sigma2)
        lse = torch.logaddexp(l1, l2)
        return torch.where(mask, lse, 0.0).sum(dim=1), l2, lse

    pi1 = torch.full((K,), 1.0 - pi_init, **f64)
    pi2 = torch.full((K,), pi_init, **f64)
    mu2, sigma2 = mu2_0, sigma2_0
    ll_old, l2, lse = loglik(pi1, pi2, mu2, sigma2)
    frozen = torch.zeros(K, dtype=torch.bool, device=data.device)
    for _ in range(max_iter):
        # E step at the current parameters (those of the last M step, whose
        # log-likelihood terms are at hand; a frozen k-mer's are not, but
        # its update is discarded below)
        r2 = torch.where(mask, torch.exp(l2 - lse), 0.0)
        r1 = torch.where(mask, 1.0 - r2, 0.0)
        nk1 = r1.sum(dim=1)
        nk2 = r2.sum(dim=1).clamp(min=1e-12)
        pi1n = nk1 / n
        pi2n = nk2 / n
        mu2n = (r2 * data).sum(dim=1) / nk2
        var2 = (r2 * (data - mu2n[:, None]) ** 2).sum(dim=1) / nk2
        sigma2n = torch.sqrt(var2.clamp(min=1e-12))
        ll_new, l2, lse = loglik(pi1n, pi2n, mu2n, sigma2n)
        improved = (ll_new - ll_old) > tolerance
        pi1 = torch.where(frozen, pi1, pi1n)
        pi2 = torch.where(frozen, pi2, pi2n)
        mu2 = torch.where(frozen, mu2, mu2n)
        sigma2 = torch.where(frozen, sigma2, sigma2n)
        ll_old = torch.where(frozen, ll_old, ll_new)
        frozen = frozen | ~improved
    return tuple(t.to(out_dtype) for t in (pi1, pi2, mu2, sigma2))


@dataclass
class GMMFit:
    kmer_index: int
    ont_mean: float
    ont_stdv: float
    pi1: float
    mu1: float
    sigma1: float
    pi2: float
    mu2: float
    sigma2: float
    n_imported: int
    n_filtered: int


def train_gmm(pools: dict[int, np.ndarray], models: PoreModelSet,
              cfg: SubstrateConfig = DNA_R10, chunk: int = 2048,
              device="cuda") -> list[GMMFit]:
    """Full trainGMM (train_main, trainGMM.cpp:376-530): DBSCAN filter on
    the host, then the batched EM on ``device`` in chunks of ``chunk``
    k-mers.  Pools below ``min_raw_events``, or below
    ``min_filtered_events`` after the filter, are not fitted."""
    dev = devmod.resolve(device)
    p = cfg.traingmm
    jobs = []
    for idx, ev in pools.items():
        if ev.shape[0] < p.min_raw_events:
            continue
        min_points = int(p.dbscan_min_points_fraction * ev.shape[0])
        filt = ev[dbscan_filter_1d(ev, p.dbscan_epsilon, min_points)]
        if filt.shape[0] < p.min_filtered_events:
            continue
        jobs.append((idx, ev.shape[0], filt))

    fits: list[GMMFit] = []
    for c0 in range(0, len(jobs), chunk):
        group = jobs[c0 : c0 + chunk]
        K = len(group)
        M = max(f.shape[0] for _, _, f in group)
        data = np.zeros((K, M), dtype=np.float32)
        mask = np.zeros((K, M), dtype=bool)
        for i, (_, _, filt) in enumerate(group):
            data[i, : filt.shape[0]] = filt
            mask[i, : filt.shape[0]] = True
        kmers = np.array([idx for idx, _, _ in group], dtype=np.int64)
        mu1 = models.pore_model[kmers, 0].astype(np.float32)
        s1 = models.pore_model[kmers, 1].astype(np.float32)
        s2_0 = (p.prior_stdv_multiplier * s1).astype(np.float32)
        out = em_prior_batch(
            *(devmod.put_rows(a, dev) for a in (data, mask, mu1, s1, mu1,
                                                s2_0)),
            p.default_pi, p.em_tolerance, p.em_max_iterations)
        pi1, pi2, mu2, sigma2 = (t.cpu().numpy() for t in out)
        for i, (idx, n_raw, filt) in enumerate(group):
            fits.append(GMMFit(idx, float(mu1[i]), float(s1[i]),
                               float(pi1[i]), float(mu1[i]), float(s1[i]),
                               float(pi2[i]), float(mu2[i]), float(sigma2[i]),
                               n_raw, filt.shape[0]))
    return fits


def write_gmm_table(fits: list[GMMFit], path: str, kmer_len: int = 9) -> None:
    """Fitted-model TSV in the reference layout (trainGMM.cpp:468,519-523),
    the file ``io.poremodel.import_traingmm_model`` reads."""
    with open(path, "w") as fh:
        fh.write("6mer\tONT_mean\tONT_stdv\tpi_1\tmean_1\tstdv_1\tpi_2\t"
                 "mean_2\tstdv_2\timported_events\tfiltered_events\n")
        for f in fits:
            kmer = index2kmer(f.kmer_index, kmer_len)
            fh.write(f"{kmer}\t{f.ont_mean:.6f}\t{f.ont_stdv:.6f}"
                     f"\t{f.pi1:.6f}\t{f.mu1:.6f}\t{f.sigma1:.6f}"
                     f"\t{f.pi2:.6f}\t{f.mu2:.6f}\t{f.sigma2:.6f}"
                     f"\t{f.n_imported}\t{f.n_filtered}\n")
