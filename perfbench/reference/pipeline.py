"""Plain NumPy reference of ``detect``'s path up to the CNN's inputs: event
detection, quantile scaling, adaptive banded alignment, Theil-Sen,
fast-mode eventalign windows, the 3-state Viterbi, and the per-position
tables the CNN reads.

A frozen copy of the JAX package's NumPy oracles (``ops/reference.py``:
events, scaling, the banded DP and Viterbi, each citing DNAscent v4.1.1),
with the config constants they need, plus the fast-mode window rules and
the position post-processing as the port documents them
(``pipeline/eventalign.py``, alignment.cpp:555-740 with the full-span
window advance).  Two changes of form, none of arithmetic: the banded DP
runs several reads side by side and the Viterbi several windows side by
side (each read's and window's cells are computed exactly as alone), so a
sample of reads fits in a run.  Everything is f64 unless the algorithm
states f32 (the banded DP's scores, as the reference's ``float`` bands);
Viterbi observations are rounded to f16, the port's documented input
precision for fast-mode windows.  It imports nothing of the program or of
JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# Constants (DNAscent v4.1.1 R10.4.1 preset; config.h, event_detection.h,
# event_handling.cpp, alignment.cpp, reads.h)
# ---------------------------------------------------------------------------
K = 9
WINDOW_LENGTH = 50               # config.h windowLength_align
EV_W1, EV_W2 = 3, 6              # event_detection.h
EV_T1, EV_T2, EV_PEAK = 1.4, 9.0, 0.2
N_QUANTILES = 10
TS_MAX_POINTS, TS_TRIM = 1000, 50
BANDWIDTH = 100
EPS_SKIP, P_TRIM = 1e-30, 0.01
MIN_AVG_LOG_EMISSION, MAX_GAP, MIN_CLEANED = -2.0, 5, 1000
EVENT_MEAN_MIN, EVENT_MEAN_MAX = 0.0, 250.0      # alignment.cpp:624
HMM = dict(eD2D=0.3, eD2M=0.7, eI2M=0.999, eM2D=0.0025, iM2I=0.001,
           iI2I=0.001)
T_CAP = 1024                     # longest window kept (observations)
RAWDEPTH = 20                    # reads.h:12
SIG_QUANT_LO = np.float32(-6.0)  # u8 codes: [-6, 6] onto [1, 255]
SIG_QUANT_SCALE = np.float32(254.0 / 12.0)
LOG_INV_SQRT_2PI = float(np.log(0.3989422804014327))
FROM_D, FROM_U, FROM_L = 0, 1, 2
KIND_D, KIND_M, KIND_I = 0, 1, 2


# ---------------------------------------------------------------------------
# Events (scrappie event_detection.c) and the merge (event_handling.cpp)
# ---------------------------------------------------------------------------

def _tstat(sums, sumsqs, n, w_length):
    tstat = np.zeros(n, dtype=np.float32)
    if n < 2 * w_length or w_length < 2:
        return tstat
    eta = np.float32(np.finfo(np.float32).tiny)
    w = float(w_length)
    i = np.arange(w_length, n - w_length + 1)
    sum1 = sums[i].copy()
    sumsq1 = sumsqs[i].copy()
    inner = i > w_length
    sum1[inner] -= sums[i[inner] - w_length]
    sumsq1[inner] -= sumsqs[i[inner] - w_length]
    sum2 = (sums[i + w_length] - sums[i]).astype(np.float32)
    sumsq2 = (sumsqs[i + w_length] - sumsqs[i]).astype(np.float32)
    mean1 = (sum1 / w).astype(np.float32)
    mean2 = sum2 / np.float32(w)
    var = ((sumsq1 / w).astype(np.float32) - mean1 * mean1
           + sumsq2 / np.float32(w) - mean2 * mean2)
    var = np.maximum(var, eta)
    tstat[i] = np.abs(mean2 - mean1) / np.sqrt(var / np.float32(w))
    return tstat


def _peaks(t1: np.ndarray, t2: np.ndarray) -> list:
    """The two-detector peak FSM (event_detection.c:122-198)."""
    FMAX = float(np.finfo(np.float32).max)
    sig = (t1.tolist(), t2.tolist())
    thresh = (EV_T1, EV_T2)
    wlen = (EV_W1, EV_W2)
    masked_to = [0, 0]
    peak_pos = [-1, -1]
    peak_val = [FMAX, FMAX]
    valid = [False, False]
    peaks = []
    for i in range(len(sig[0])):
        for k in (0, 1):
            if masked_to[k] >= i:
                continue
            cur = sig[k][i]
            if peak_pos[k] == -1:
                if cur < peak_val[k]:
                    peak_val[k] = cur
                elif cur - peak_val[k] > EV_PEAK:
                    peak_val[k] = cur
                    peak_pos[k] = i
            else:
                if cur > peak_val[k]:
                    peak_val[k] = cur
                    peak_pos[k] = i
                if k == 0 and peak_val[0] > thresh[0]:
                    masked_to[1] = peak_pos[0] + wlen[0]
                    peak_pos[1] = -1
                    peak_val[1] = FMAX
                    valid[1] = False
                if peak_val[k] - cur > EV_PEAK and peak_val[k] > thresh[k]:
                    valid[k] = True
                if valid[k] and (i - peak_pos[k]) > wlen[k] // 2:
                    peaks.append(peak_pos[k])
                    peak_pos[k] = -1
                    peak_val[k] = cur
                    valid[k] = False
    return peaks


@dataclass
class Events:
    mean: np.ndarray       # (m,) f64 merged event means (the first is 0.0)
    raw_start: np.ndarray  # (m,) inclusive
    raw_end: np.ndarray    # (m,) inclusive
    n_raw: int


def events(raw: np.ndarray) -> Events:
    """t-stat segmentation (event_detection.c:268-319), then normaliseEvents'
    merge with its one-event lag (event_handling.cpp:549-575)."""
    raw = np.asarray(raw, dtype=np.float64)
    n = raw.shape[0]
    sums = np.zeros(n + 1)
    sumsqs = np.zeros(n + 1)
    np.cumsum(raw, out=sums[1:])
    np.cumsum(raw * raw, out=sumsqs[1:])
    peaks = np.asarray(_peaks(_tstat(sums, sumsqs, n, EV_W1),
                              _tstat(sums, sumsqs, n, EV_W2)), np.int64)
    peaks = peaks[(peaks > 0) & (peaks < n)]
    bounds = np.concatenate([[0], peaks, [n]])
    starts, ends = bounds[:-1], bounds[1:]
    lengths = (ends - starts).astype(np.float32)
    means = ((sums[ends] - sums[starts]) / lengths).astype(np.float32)
    out_m, out_s, out_e = [], [], []
    raw_start, mean = 0, 0.0
    for i in range(means.shape[0]):
        if means[i] > 0.0 and i > 0:
            out_m.append(mean)
            out_s.append(raw_start)
            out_e.append(min(int(starts[i]) - 1, n - 1))
            mean = float(means[i])
            raw_start = int(starts[i])
    return Events(np.asarray(out_m, np.float64), np.asarray(out_s, np.int64),
                  np.asarray(out_e, np.int64), int(means.shape[0]))


# ---------------------------------------------------------------------------
# Scaling (event_handling.cpp:451-541, :24-110)
# ---------------------------------------------------------------------------

def _quantile_medians(data):
    s = np.sort(np.asarray(data, dtype=np.float64))
    n = s.shape[0] // N_QUANTILES
    i = np.arange(N_QUANTILES)
    return s[(i * n + (i + 1) * n) // 2]


def quantile_scaling(event_means, model_means) -> tuple[float, float]:
    x = _quantile_medians(model_means)
    y = _quantile_medians(event_means)
    n = x.shape[0]
    sx, sx2, sy, sxy = x.sum(), (x * x).sum(), y.sum(), (x * y).sum()
    slope = (n * sxy - sx * sy) / (n * sx2 - sx * sx)
    return float((sy - slope * sx) / n), float(slope)   # shift, scale


def theilsen(signals, model_means, shift, scale) -> tuple[float, float]:
    """(shift, scale) refined; (-1, -1) when the median slope is 0."""
    signals = np.asarray(signals, np.float64)
    model_means = np.asarray(model_means, np.float64)
    if model_means.shape[0] < TS_MAX_POINTS:
        return shift, scale
    eff = signals.shape[0] - 2 * TS_TRIM
    skip = eff // TS_MAX_POINTS if eff > TS_MAX_POINTS else 1
    npts = TS_MAX_POINTS if eff > TS_MAX_POINTS else eff
    idx = TS_TRIM + skip * np.arange(npts)
    x = (signals[idx] - shift) / scale
    y = model_means[idx]
    iu = np.triu_indices(npts, k=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        slopes = np.sort((y[:, None] - y[None, :])[iu]
                         / (x[:, None] - x[None, :])[iu])
    m = slopes[slopes.shape[0] // 2]
    b = np.sort(y - m * x)[npts // 2]
    if m == 0.0:
        return -1.0, -1.0
    return shift + (-b / m) * scale, scale * (1.0 / m)


# ---------------------------------------------------------------------------
# Adaptive banded alignment (event_handling.cpp:148-448), several reads side
# by side
# ---------------------------------------------------------------------------

@dataclass
class Banded:
    pairs: np.ndarray        # (n, 2) (event, k-mer) ascending
    cleaned_signals: np.ndarray
    cleaned_ranks: np.ndarray
    qc_pass: bool


def banded_align(reads: list[dict], pore: np.ndarray,
                 bf16: bool = False) -> list[Banded]:
    """Each read dict holds ``means`` (f64 events), ``ranks_q`` (query
    k-mer ranks, A-substituted), ``ranks_r`` (reference ranks), ``q2r``
    (query -> reference index, -1 unmapped), ``shift`` and ``scale``.
    ``bf16`` computes the DP in bfloat16 (every input, emission and score
    rounded to it): the control."""
    bf = _bf16 if bf16 else (lambda v: v)
    R = len(reads)
    W = BANDWIDTH
    half = W // 2
    NEG = np.float32(-np.inf)
    E = np.array([r["means"].shape[0] for r in reads])
    Kn = np.array([r["ranks_q"].shape[0] for r in reads])
    NB = E + Kn + 2
    nb_max = int(NB.max())
    Emax, Kmax = int(E.max()), int(Kn.max())
    ev = np.zeros((R, Emax), np.float32)
    mu = np.zeros((R, Kmax), np.float32)
    inv = np.ones((R, Kmax), np.float32)
    lpc = np.zeros((R, Kmax), np.float32)
    lp_stay = np.zeros((R, 1), np.float32)
    lp_step = np.zeros((R, 1), np.float32)
    lp_skip = np.float32(np.log(EPS_SKIP))
    lp_trim = np.float32(np.log(P_TRIM))
    for j, r in enumerate(reads):
        e, k = E[j], Kn[j]
        ev[j, :e] = ((r["means"] - r["shift"]) / r["scale"]).astype(np.float32)
        sig = pore[r["ranks_q"], 1].astype(np.float32)
        mu[j, :k] = pore[r["ranks_q"], 0].astype(np.float32)
        lpc[j, :k] = (LOG_INV_SQRT_2PI - np.log(sig)).astype(np.float32)
        inv[j, :k] = (1.0 / sig).astype(np.float32)
        p_stay = 1.0 - (1.0 / (e / k + 1.0))
        lp_stay[j] = np.float32(np.log(p_stay))
        lp_step[j] = np.float32(np.log(1.0 - np.exp(float(lp_skip))
                                       - np.exp(float(lp_stay[j, 0]))))
    ev, mu = bf(ev), bf(mu)
    bands = np.full((R, nb_max, W), NEG, np.float32)
    trace = np.zeros((R, nb_max, W), np.uint8)
    bll = np.zeros((R, nb_max, 2), np.int64)
    bll[:, 0] = (half - 1, -1 - half)
    bll[:, 1] = (half, -1 - half)
    rows = np.arange(R)
    rc = rows[:, None]
    bands[:, 0, -1 - bll[0, 0, 1]] = 0.0
    bands[:, 1, bll[0, 1, 0]] = lp_trim
    trace[:, 1, bll[0, 1, 0]] = FROM_U
    o = np.arange(W)[None, :]
    # flat gathers: the inputs padded by W each side, so a cell's event and
    # k-mer indices (within W of the matrix) need no clipping, and the
    # previous two bands padded by 2 of -inf each side, so a predecessor
    # out of band reads -inf
    pad = lambda a, v: np.pad(a, ((0, 0), (W, W)), constant_values=v).ravel()
    evP, muP, invP, lpcP = pad(ev, 0), pad(mu, 0), pad(inv, 1), pad(lpc, 0)
    base_in = (rows * (Emax + 2 * W) + W)[:, None]
    base_km = (rows * (Kmax + 2 * W) + W)[:, None]
    ko = base_km + o
    eo = base_in - o
    bo = (rows * (W + 4))[:, None] + o
    negc = np.full((R, 2), NEG, np.float32)
    P1 = np.concatenate([negc, bands[:, 1], negc], axis=1).ravel()
    P2 = np.concatenate([negc, bands[:, 0], negc], axis=1).ravel()
    all_live = np.ones((R, W), bool)
    Em1 = E - 1

    for bi in range(2, nb_max):
        act = bi < NB
        ll, ur = P1[2 :: W + 4], P1[W + 1 :: W + 4]
        right = np.where((ll == NEG) & (ur == NEG), bi % 2 == 1, ll < ur)
        e_p1, k_p1 = bll[:, bi - 1, 0], bll[:, bi - 1, 1]
        e0 = e_p1 + ~right
        k0 = k_p1 + right
        bll[:, bi, 0], bll[:, bi, 1] = e0, k0
        if k0.min() < 0:      # the trim cells of the first bands
            t_off = -1 - k0
            t_ev = e0 - t_off
            t_ok = act & (t_off >= 0) & (t_off < W) & (t_ev >= 0) & (t_ev < E)
            if t_ok.any():
                r_ok = rows[t_ok]
                bands[r_ok, bi, t_off[t_ok]] = bf(
                    lp_trim * (t_ev[t_ok] + 1).astype(np.float32))
                trace[r_ok, bi, t_off[t_ok]] = FROM_U
        lo = np.maximum(np.maximum(-k0, e0 - Em1), 0)
        hi = np.minimum(np.minimum(Kn - k0, e0 + 1), W)
        if act.all() and lo.max() == 0 and hi.min() == W:
            live = all_live
        else:
            live = act[:, None] & (o >= lo[:, None]) & (o < hi[:, None])
            if not live.any():
                P2 = P1
                P1 = np.concatenate([negc, bands[:, bi], negc], axis=1).ravel()
                continue
        # predecessors are the previous bands shifted by -1, 0 or 1
        # (event_handling.cpp:139-146)
        up = P1[bo + (e_p1 - e0 + 3)[:, None]]
        left = P1[bo + (k0 - k_p1 + 1)[:, None]]
        diag = P2[bo + (k0 - bll[:, bi - 2, 1] + 1)[:, None]]
        # reads past their last band keep moving: clip their gathers
        ki = ko + np.clip(k0, -W, Kmax)[:, None]
        a = (evP[eo + np.clip(e0, -1, Emax + W - 1)[:, None]] - muP[ki]) \
            * invP[ki]
        lp_em = bf(lpcP[ki] - np.float32(0.5) * a * a)
        sd = bf(bf(diag + lp_step) + lp_em)
        su = bf(bf(up + lp_stay) + lp_em)
        sl = bf(left + lp_skip)
        mdu = np.maximum(sd, su)
        mall = np.maximum(mdu, sl)
        frm = np.where(mall == sl, FROM_L,
                       np.where(mdu == su, FROM_U, FROM_D)).astype(np.uint8)
        if live is all_live:
            bands[:, bi] = mall
            trace[:, bi] = frm
        else:
            bands[:, bi] = np.where(live, mall, bands[:, bi])
            trace[:, bi] = np.where(live, frm, trace[:, bi])
        P2 = P1
        P1 = np.concatenate([negc, bands[:, bi], negc], axis=1).ravel()
    return [_banded_backtrace(reads[j], ev[j, :E[j]], mu[j, :Kn[j]],
                              inv[j, :Kn[j]], lpc[j, :Kn[j]], bands[j],
                              trace[j], bll[j], lp_trim)
            for j in range(R)]


def _banded_backtrace(r, scaled, mu, inv, lpc, bands, trace, bll,
                      lp_trim) -> Banded:
    """event_handling.cpp:318-443."""
    n_ev, n_km = scaled.shape[0], mu.shape[0]
    W = BANDWIDTH
    best = np.float32(-np.inf)
    ce, ck = 0, n_km - 1
    for e in range(n_ev):
        bi = (e + 1) + (ck + 1)
        off = int(bll[bi, 0]) - e
        if 0 <= off < W:
            s = bands[bi, off] + np.float32(n_ev - e) * lp_trim
            if s > best:
                best, ce = s, e
    means = r["means"]
    q2r = r["q2r"]
    ranks_r = r["ranks_r"]
    pairs, cs, cr, buf = [], [], [], []
    sum_em, n_al, gap, max_gap = 0.0, 0, 0, 0
    while ck >= 0 and ce >= 0:
        pairs.append((ce, ck))
        a = (scaled[ce] - mu[ck]) * inv[ck]
        sum_em += float(lpc[ck] - np.float32(0.5) * a * a)
        n_al += 1
        bi = (ce + 1) + (ck + 1)
        frm = trace[bi, int(bll[bi, 0]) - ce]
        if frm == FROM_D:
            buf.append(float(means[ce]))
            ref = int(q2r[ck]) if ck < q2r.shape[0] else -1
            if 0 <= ref < ranks_r.shape[0]:
                cr.append(int(ranks_r[ref]))
                cs.append(float(np.mean(buf)))
            buf.clear()
            ck -= 1
            ce -= 1
            gap = 0
        elif frm == FROM_U:
            buf.append(float(means[ce]))
            ce -= 1
            gap = 0
        else:
            ck -= 1
            gap += 1
            max_gap = max(max_gap, gap)
    pairs.reverse()
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    avg = sum_em / n_al if n_al else float("-inf")
    spanned = bool(pairs.size) and pairs[0, 1] == 0 \
        and pairs[-1, 1] == n_km - 1
    ok = (avg >= MIN_AVG_LOG_EMISSION and spanned and max_gap <= MAX_GAP
          and len(cs) >= MIN_CLEANED)
    return Banded(pairs, np.asarray(cs, np.float64),
                  np.asarray(cr, np.int64), ok)


def _bf16(x: np.ndarray) -> np.ndarray:
    """Round f32 values to the nearest bfloat16 (ties to even)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


# ---------------------------------------------------------------------------
# Fast-mode windows (alignment.cpp:555-650, advance by the full k-mer span)
# ---------------------------------------------------------------------------

@dataclass
class Windows:
    ri: np.ndarray       # reference start of each window
    ns: np.ndarray       # states (k-mers)
    ev: list             # each window's guarded event ids
    ref_coord: np.ndarray


def windows(refseq: str, ranks_r: np.ndarray, pore: np.ndarray,
            pairs: np.ndarray, means: np.ndarray, r2q: np.ndarray,
            ref_start: int, ref_end: int, is_reverse: bool) -> Windows:
    codes = _codes(refseq)
    defined = codes >= 0
    ref_len = len(refseq)
    m = pore[np.where(ranks_r < 0, 0, ranks_r), 0].astype(np.float64)
    gap = np.abs(np.diff(m))
    bp = np.zeros(m.shape[0], bool)
    if m.shape[0] >= 3:
        bp[1:-1] = (gap[1:] > 0.75) & (gap[:-1] > 0.75)
    pq = pairs[:, 1]
    ri, out_ri, out_ns, out_ev = 0, [], [], []
    while ri < ref_len - K + 1:
        to_end = ref_len - ri
        wl = min(to_end, WINDOW_LENGTH)
        if to_end > 1.5 * WINDOW_LENGTH:
            snip = int(1.5 * wl)
            if not defined[ri : ri + snip].all():
                ri += wl
                continue
            limit = int(1.5 * wl - K - 1)
            hit = np.flatnonzero(bp[ri + wl : ri + limit])
            if hit.shape[0]:
                wl = wl + int(hit[0]) + K
        if not defined[ri : ri + wl].all():
            ri += wl
            continue
        j0 = int(np.searchsorted(pq, r2q[ri], side="left"))
        j1 = int(np.searchsorted(pq, r2q[ri + wl - K + 1], side="left"))
        ev = pairs[j0:j1, 0]
        mm = means[ev]
        ev = ev[(mm > EVENT_MEAN_MIN) & (mm < EVENT_MEAN_MAX)]
        if j1 <= j0 or ev.shape[0] < 2:
            ri += wl
            continue
        out_ri.append(ri)
        out_ns.append(wl - K + 1)
        out_ev.append(ev[:T_CAP])
        ri += wl - K + 1
    ri_a = np.asarray(out_ri, np.int64)
    rc = (ref_end - ri_a - K // 2) if is_reverse else (ref_start + ri_a
                                                       + K // 2)
    return Windows(ri_a, np.asarray(out_ns, np.int64), out_ev, rc)


def _codes(seq: str) -> np.ndarray:
    table = np.full(256, -1, np.int8)
    for b, v in (("A", 0), ("T", 1), ("G", 2), ("C", 3)):
        table[ord(b)] = v
    return table[np.frombuffer(seq.encode("ascii"), np.uint8)]


# ---------------------------------------------------------------------------
# Windowed 3-state Viterbi (alignment.cpp:193-516), windows side by side
# ---------------------------------------------------------------------------

def viterbi(obs: list, ranks: list, pore: np.ndarray, epb: float,
            bf16: bool = False) -> list:
    """Each window's path as (kind, position) pairs in forward order;
    ``obs[w]`` its scaled observations, ``ranks[w]`` its k-mer ranks.  Max
    product with the reference's first-wins tie order; -inf for log 0.
    ``bf16`` rounds the inputs, emissions and every state score to
    bfloat16 (the control)."""
    bf = ((lambda v: _bf16(np.asarray(v, np.float32)).astype(np.float64))
          if bf16 else (lambda v: v))
    h = {k: np.log(v) for k, v in HMM.items()}
    iM2M = np.log(1.0 - 1.0 / epb)
    eM2M = np.log(1.0 - HMM["eM2D"] - HMM["iM2I"] - (1.0 - 1.0 / epb))
    eM2MorD = np.logaddexp(eM2M, h["eM2D"])
    eOrIM2M = np.logaddexp(eM2M, iM2M)
    Wn = len(obs)
    Tn = np.array([o.shape[0] for o in obs])
    Nn = np.array([r.shape[0] for r in ranks])
    T, N = int(Tn.max()), int(Nn.max())
    x = np.zeros((Wn, T))
    mu = np.zeros((Wn, N))
    sg = np.ones((Wn, N))
    for w in range(Wn):
        x[w, : Tn[w]] = obs[w]
        mu[w, : Nn[w]] = pore[ranks[w], 0]
        sg[w, : Nn[w]] = pore[ranks[w], 1]
    x, mu = bf(x), bf(mu)
    lconst = -0.5 * np.log(2.0 * np.pi * sg ** 2)
    NEG = -np.inf
    # back-pointers as choice codes: I {0: I(i,t-1), 1: M(i,t-1), 2: start}
    # M {0: I(i-1), 1: M(i-1), 2: M(i), 3: D(i-1), 4: start} at t-1;
    # D {0: M(i-1,t), 1: D(i-1,t)}
    bI = np.zeros((T, Wn, N), np.int8)
    bM = np.zeros((T, Wn, N), np.int8)
    bD = np.zeros((T, Wn, N), np.int8)
    D = np.full((Wn, N), NEG)
    D[:, 0] = h["eM2D"]
    for i in range(1, N):
        D[:, i] = D[:, i - 1] + h["eD2D"]
    I = np.full((Wn, N), NEG)
    M = np.full((Wn, N), NEG)
    start = 0.0
    fins = [None] * Wn
    for t in range(T):
        z = (x[:, t : t + 1] - mu) / sg
        em = bf(lconst - 0.5 * z * z)
        cI = np.stack([I + h["iI2I"], M + h["iM2I"],
                       np.full((Wn, N), NEG)])
        cI[2, :, 0] = start + h["iM2I"]
        aI = _first_argmax(cI)
        Ic = bf(np.take_along_axis(cI, aI[None], 0)[0])
        sh = lambda v: np.concatenate([np.full((Wn, 1), NEG), v[:, :-1]], 1)
        cM = np.stack([sh(I) + h["eI2M"] + em, sh(M) + eM2M + em,
                       M + iM2M + em, sh(D) + h["eD2M"] + em,
                       np.full((Wn, N), NEG)])
        cM[0, :, 0] = cM[1, :, 0] = cM[3, :, 0] = NEG
        cM[4, :, 0] = start + eOrIM2M + em[:, 0]
        aM = _first_argmax(cM)
        Mc = bf(np.take_along_axis(cM, aM[None], 0)[0])
        Dc = np.full((Wn, N), NEG)
        aD = np.zeros((Wn, N), np.int8)
        for i in range(1, N):
            c0 = Mc[:, i - 1] + h["eM2D"]
            c1 = Dc[:, i - 1] + h["eD2D"]
            take_m = c0 >= c1
            Dc[:, i] = bf(np.where(take_m, c0, c1))
            aD[:, i] = np.where(take_m, 0, 1)
        bI[t], bM[t], bD[t] = aI, aM, aD
        I, M, D = Ic, Mc, Dc
        start = NEG
        for w in np.flatnonzero(Tn == t + 1):
            n = Nn[w]
            fins[w] = (D[w, n - 1], M[w, n - 1] + eM2MorD,
                       I[w, n - 1] + h["eI2M"])
    paths = []
    for w in range(Wn):
        cand = fins[w]
        kind = (KIND_D, KIND_M, KIND_I)[int(np.argmax(cand))]
        i, t = Nn[w] - 1, Tn[w]   # t: columns consumed by the state
        rev = []
        while True:
            rev.append((kind, i))
            if kind == KIND_I:
                c = bI[t - 1, w, i]
                if c == 2:
                    break
                kind, t = (KIND_I, KIND_M)[c], t - 1
            elif kind == KIND_M:
                c = bM[t - 1, w, i]
                if c == 4:
                    break
                kind = (KIND_I, KIND_M, KIND_M, KIND_D)[c]
                i, t = (i - 1, i - 1, i, i - 1)[c], t - 1
            else:
                if i == 0:
                    break   # D0 at column 0 starts the chain
                c = bD[t - 1, w, i] if t > 0 else 1
                kind, i = (KIND_M, KIND_D)[c], i - 1
        rev.reverse()
        paths.append(np.asarray(rev, np.int64).reshape(-1, 2))
    return paths


def _first_argmax(c: np.ndarray) -> np.ndarray:
    """Index of the first maximum along axis 0 (lnArgMax's tie order)."""
    return np.argmax(c, axis=0).astype(np.int8)


# ---------------------------------------------------------------------------
# A read end to end, up to the CNN's inputs
# ---------------------------------------------------------------------------

@dataclass
class Positions:
    coord: np.ndarray
    kmer_start: np.ndarray
    query_idx: np.ndarray
    ref_idx: np.ndarray
    core: np.ndarray
    res: np.ndarray
    counts: np.ndarray       # min(samples, RAWDEPTH)
    sig_u8: np.ndarray       # (P, RAWDEPTH) u8 codes, 0 = padding
    center_t: np.ndarray


def _index_tables(refseq: str):
    codes = _codes(refseq)
    safe = np.where(codes < 0, 0, codes).astype(np.int64)
    win = np.lib.stride_tricks.sliding_window_view(safe, K)
    core = np.zeros(win.shape[0], np.int64)
    for i in range(2, 7):
        core = core * 4 + win[:, i]
    res = np.zeros(win.shape[0], np.int64)
    for i in (0, 1, 7, 8):
        res = res * 4 + win[:, i]
    return codes, core + 1, res + 1


def positions(read: dict, ev: Events, win: Windows, paths: list,
              shift: float, scale: float) -> Optional[Positions]:
    """alignment.cpp:654-740: each window's match steps become positions
    (a run of matches at one k-mer is one position); each position keeps
    its events' raw samples, scaled, the first RAWDEPTH as u8 codes."""
    codes, core_t, res_t = _index_tables(read["refseq_seq"])
    wi, pi, ei = [], [], []
    for w, path in enumerate(paths):
        kinds = path[:, 0]
        m = kinds == KIND_M
        ev_idx = np.cumsum(kinds != KIND_D) - 1
        wi.append(np.full(int(m.sum()), w, np.int64))
        pi.append(path[m, 1])
        ei.append(win.ev[w][ev_idx[m]])
    if not wi:
        return None
    wi, pi, ei = np.concatenate(wi), np.concatenate(pi), np.concatenate(ei)
    if wi.shape[0] == 0:
        return None
    # a new position wherever the (window, k-mer) of a match step changes
    new = np.ones(wi.shape[0], bool)
    new[1:] = (wi[1:] != wi[:-1]) | (pi[1:] != pi[:-1])
    pos_of = np.cumsum(new) - 1
    first = np.flatnonzero(new)
    w_p, p_p = wi[first], pi[first]
    ks = win.ri[w_p] + p_p
    coord = (win.ref_coord[w_p] - p_p - 1 if read["is_reverse"]
             else win.ref_coord[w_p] + p_p)
    cnt = ev.raw_end[ei] - ev.raw_start[ei] + 1
    n = np.bincount(pos_of, weights=cnt, minlength=first.shape[0]).astype(
        np.int64)
    # each step's samples after those of the earlier steps of its position
    csum = np.cumsum(cnt) - cnt
    before = csum - csum[first][pos_of]
    take = np.clip(RAWDEPTH - before, 0, cnt)
    j = _ranges(take)
    src = np.repeat(ev.raw_start[ei], take) + j
    v = ((read["raw"][src] - shift) / scale).astype(np.float32)
    q = np.rint((v - SIG_QUANT_LO) * SIG_QUANT_SCALE) + np.float32(1.0)
    u8 = np.zeros((first.shape[0], RAWDEPTH), np.uint8)
    u8[np.repeat(pos_of, take), np.repeat(before, take) + j] = np.clip(
        q, 1.0, 255.0).astype(np.uint8)
    return Positions(coord, ks, read["r2q"][ks + K // 2], ks + K // 2,
                     core_t[ks], res_t[ks], np.minimum(n, RAWDEPTH), u8,
                     codes[ks + K // 2] == 1)


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[0..c0-1, 0..c1-1, ...]."""
    starts = np.cumsum(counts) - counts
    return np.arange(int(counts.sum())) - np.repeat(starts, counts)


def prepare(reads: list[dict], pore: np.ndarray,
            bf16: bool = False) -> list[Optional[Positions]]:
    """Reads (dicts: ``raw``, ``seq`` (basecall), ``refseq_seq`` (mapped
    reference, both in sequencing orientation), ``r2q``, ``q2r``,
    ``ref_start``, ``ref_end``, ``is_reverse``) -> each read's positions,
    or None where it fails QC or keeps no position.  ``bf16`` runs the
    banded DP and the Viterbi in bfloat16 (the control)."""
    out: list = [None] * len(reads)
    live = []
    evs = {}
    for j, r in enumerate(reads):
        ev = events(r["raw"])
        rq = _ranks(r["seq"])
        rr = _ranks(r["refseq_seq"])
        if ev.mean.shape[0] < 2 or rq.shape[0] < 2 or rr.shape[0] < 2:
            continue
        shift, scale = quantile_scaling(ev.mean,
                                        pore[np.where(rr < 0, 0, rr), 0])
        evs[j] = ev
        live.append(dict(j=j, means=ev.mean, ranks_q=np.where(rq < 0, 0, rq),
                         ranks_r=rr, q2r=r["q2r"], shift=shift, scale=scale))
    if not live:
        return out
    for item, b in zip(live, banded_align(live, pore, bf16)):
        if not b.qc_pass:
            continue
        j = item["j"]
        r = reads[j]
        ev = evs[j]
        safe = np.where(b.cleaned_ranks < 0, 0, b.cleaned_ranks)
        shift, scale = theilsen(b.cleaned_signals, pore[safe, 0],
                                item["shift"], item["scale"])
        if shift == -1.0:
            continue
        epb = ev.n_raw / max(1, len(r["seq"]) - K)
        win = windows(r["refseq_seq"], item["ranks_r"], pore, b.pairs,
                      ev.mean, r["r2q"], r["ref_start"], r["ref_end"],
                      r["is_reverse"])
        if win.ri.shape[0] == 0:
            continue
        rr = item["ranks_r"]
        obs = [((ev.mean[e] - shift) / scale).astype(np.float16).astype(
            np.float64) for e in win.ev]
        ranks = [np.where(rr[ri : ri + ns] < 0, 0, rr[ri : ri + ns])
                 for ri, ns in zip(win.ri, win.ns)]
        paths = [None] * len(obs)
        # windows side by side, grouped by observation count so padding
        # stays small
        order = np.argsort([o.shape[0] for o in obs], kind="stable")
        for c in range(0, order.shape[0], 256):
            sel = order[c : c + 256]
            for w, p in zip(sel, viterbi([obs[w] for w in sel],
                                         [ranks[w] for w in sel], pore, epb,
                                         bf16)):
                paths[w] = p
        out[j] = positions(r, ev, win, paths, shift, scale)
    return out


def _ranks(seq: str) -> np.ndarray:
    codes = _codes(seq).astype(np.int64)
    n = codes.size - K + 1
    if n <= 0:
        return np.empty(0, np.int64)
    bad = codes < 0
    safe = np.where(bad, 0, codes)
    r = np.zeros(n, np.int64)
    anybad = np.zeros(n, bool)
    for i in range(K):
        r += safe[i : i + n] << (2 * (K - 1 - i))
        anybad |= bad[i : i + n]
    r[anybad] = -1
    return r
