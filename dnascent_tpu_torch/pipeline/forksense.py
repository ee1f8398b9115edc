"""forkSense: replication fork / origin / termination / stall calling.

Re-implementation of the reference's two-pass analysis (reference:
src/forkSense.cpp) with the windowed density tests vectorised via prefix
sums + binary search instead of per-position neighbour scans:

  pass 1: 2 kb call-fraction windows over the whole detect output
          (forkSense.cpp:1459-1615) -> per-analogue 1-D 2-means
          (twoMeans_fs :1348-1408) -> incorporation estimate (:1411-1456)
  pass 2 per read (> 2000 call positions, :1648):
          modified-DBSCAN position labels (:903-1003)
          -> segmentation with density-based edge trimming (:284-423,
             segmentationTrim :1006-1063)
          -> stitching (< 3 kb, no intervening other-analogue segment, :215-281)
          -> mutual-nearest fork pairing (< 5 kb, :597-900) with stress
             signatures and query spans
          -> origins (:426-491), terminations (:494-561)
          -> stall scores with softplus scaling (:1066-1215); sentinels
             -1 (paired tip), -2 (negative gradient), -3 (no call)

Because detect coordinates are strictly increasing per read, the reference's
joint index-window/coordinate-gap conditions reduce to pure coordinate
windows, which ``np.searchsorted`` resolves exactly.

A copy of ``dnascent_tpu/pipeline/forksense.py``: host numpy in both
packages, no device code.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional, TextIO

import numpy as np

from ..config import ForkSenseParams, SubstrateConfig, DNA_R10
from ..parallel.collectives import gather_ordered, window_keys


@dataclass
class KMeansResult:
    centroid_1: float
    centroid_1_lower: float
    centroid_1_stdv: float
    centroid_2: float
    centroid_2_lower: float
    centroid_2_stdv: float


@dataclass
class Segment:
    left_coord: int
    left_idx: int
    right_coord: int
    right_idx: int
    partners: int = 0
    score: float = 0.0
    stress_signature: Optional[list] = None
    query_span: int = -1


@dataclass
class DetectedReadData:
    """Parsed detect output for one read (detectedRead, reads.h:516-649)."""

    read_id: str
    contig: str
    ref_start: int
    ref_end: int
    strand: str
    coords: np.ndarray      # ascending reference coordinates
    edu: np.ndarray         # EdU probabilities
    brdu: np.ndarray        # BrdU probabilities
    # populated by pass 2:
    edu_segments: list = field(default_factory=list)
    brdu_segments: list = field(default_factory=list)
    left_forks: list = field(default_factory=list)
    right_forks: list = field(default_factory=list)
    origins: list = field(default_factory=list)
    terminations: list = field(default_factory=list)
    # optional query-span support (modbam inputs):
    ref_to_query: Optional[np.ndarray] = None


def parse_detect_file(path: str) -> Iterator[DetectedReadData]:
    """Stream reads from a human-readable .detect file
    (iterateOnHumanReadable parsing, forkSense.cpp:1618-1719)."""
    read_id = contig = strand = None
    lo = hi = 0
    coords: list = []
    edu: list = []
    brdu: list = []
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line[0] == "#":
                continue
            if line[0] == ">":
                if read_id is not None and coords:
                    yield DetectedReadData(read_id, contig, lo, hi, strand,
                                           np.asarray(coords, dtype=np.int64),
                                           np.asarray(edu), np.asarray(brdu))
                parts = line[1:].split()
                read_id, contig, lo, hi, strand = (
                    parts[0], parts[1], int(parts[2]), int(parts[3]), parts[4])
                coords, edu, brdu = [], [], []
            else:
                cols = line.split("\t")
                coords.append(int(cols[0]))
                edu.append(float(cols[1]))
                brdu.append(float(cols[2]))
    if read_id is not None and coords:
        yield DetectedReadData(read_id, contig, lo, hi, strand,
                               np.asarray(coords, dtype=np.int64),
                               np.asarray(edu), np.asarray(brdu))


# ---------------------------------------------------------------------------
# Pass 1: call fractions + 2-means
# ---------------------------------------------------------------------------

def call_fractions_read(coords: np.ndarray, edu: np.ndarray, brdu: np.ndarray,
                        fs: ForkSenseParams = ForkSenseParams()):
    """2 kb windows: greedy cut where gap > resolution and attempts >=
    resolution/10 (getCallFractions, reads.h:650-687).  BrdU takes precedence
    when both probabilities exceed 0.5 (elif chain, reads.h:659-669)."""
    res = fs.call_fraction_resolution
    min_attempts = res // fs.call_fraction_min_attempts_divisor
    isB = brdu > 0.5
    isE = (~isB) & (edu > 0.5)
    cumB = np.concatenate([[0], np.cumsum(isB)])
    cumE = np.concatenate([[0], np.cumsum(isE)])
    n = coords.shape[0]
    bfr, efr = [], []
    i0 = 0
    while i0 < n:
        j = np.searchsorted(coords, coords[i0] + res, side="right")
        # first j with gap > res is index of first coord > coords[i0]+res
        j = max(j, i0 + min_attempts - 1)
        if j >= n:
            break
        attempts = j - i0 + 1
        bcalls = int(cumB[j + 1] - cumB[i0])
        ecalls = int(cumE[j + 1] - cumE[i0])
        bfr.append(bcalls / attempts)
        efr.append(ecalls / attempts)
        i0 = j + 1
    return np.asarray(bfr), np.asarray(efr)


def two_means(observations: np.ndarray,
              fs: ForkSenseParams = ForkSenseParams()) -> KMeansResult:
    """1-D 2-means with the reference's init/tolerance (twoMeans_fs,
    forkSense.cpp:1348-1408)."""
    obs = np.asarray(observations, dtype=np.float64)
    c1, c2 = fs.kmeans_init_c1, fs.kmeans_init_c2
    assign = np.abs(obs - c1) < np.abs(obs - c2)
    for _ in range(fs.kmeans_max_iter):
        new_assign = np.abs(obs - c1) < np.abs(obs - c2)
        p1 = obs[new_assign]
        p2 = obs[~new_assign]
        n1 = p1.mean() if p1.size else float("nan")
        n2 = p2.mean() if p2.size else float("nan")
        done = abs(c1 - n1) <= fs.kmeans_tol and abs(c2 - n2) <= fs.kmeans_tol
        c1, c2, assign = n1, n2, new_assign
        if done:
            break
    p1 = obs[assign]
    p2 = obs[~assign]
    return KMeansResult(
        centroid_1=c1,
        centroid_1_lower=float(p1.min()) if p1.size else 0.0,
        centroid_1_stdv=float(p1.std(ddof=1)) if p1.size > 1 else 0.0,
        centroid_2=c2,
        centroid_2_lower=float(p2.min()) if p2.size else 0.0,
        centroid_2_stdv=float(p2.std(ddof=1)) if p2.size > 1 else 0.0,
    )


def estimate_analogue_incorporation(bfr: np.ndarray, efr: np.ndarray,
                                    fs: ForkSenseParams = ForkSenseParams()
                                    ) -> KMeansResult:
    """Pick the higher centroid per analogue (forkSense.cpp:1411-1456).
    Result packs (BrdU_p, BrdU_lower, BrdU_stdv, EdU_p, EdU_lower,
    EdU_stdv)."""
    def pick(km: KMeansResult):
        if km.centroid_1 > km.centroid_2:
            return km.centroid_1, km.centroid_1_lower, km.centroid_1_stdv
        return km.centroid_2, km.centroid_2_lower, km.centroid_2_stdv

    bp, bl, bs = pick(two_means(bfr, fs))
    ep, el, es = pick(two_means(efr, fs))
    return KMeansResult(bp, bl, bs, ep, el, es)


# ---------------------------------------------------------------------------
# Pass 2 building blocks
# ---------------------------------------------------------------------------

def _windowed_net_calls(coords: np.ndarray, calls: np.ndarray,
                        alt: np.ndarray, eps: int):
    """For each position: neighbour count and net positive calls within
    |gap| <= eps (findNeighbours_mod, forkSense.cpp:903-938)."""
    pos = np.concatenate([[0], np.cumsum(calls > 0.5)])
    neg = np.concatenate([[0], np.cumsum(alt > 0.5)])
    lo = np.searchsorted(coords, coords - eps, side="left")
    hi = np.searchsorted(coords, coords + eps, side="right")
    n_nb = hi - lo
    net = (pos[hi] - pos[lo]) - (neg[hi] - neg[lo])
    return n_nb, np.maximum(0, net)


def dbscan_labels(coords: np.ndarray, calls: np.ndarray, alt: np.ndarray,
                  eps: int, min_density: float) -> np.ndarray:
    """DBSCAN_mod labels: 1 (in region) or -1 (noise)
    (forkSense.cpp:940-962)."""
    n_nb, net = _windowed_net_calls(coords, calls, alt, eps)
    min_points = (n_nb * min_density).astype(np.int64)  # int truncation
    return np.where(net < min_points, -1, 1)


def run_dbscan(r: DetectedReadData, inc: KMeansResult,
               fs: ForkSenseParams = ForkSenseParams()):
    """Per-position 3-way labels (runDBSCAN, forkSense.cpp:965-1003).
    Returns (edu_label, brdu_label, thym_label) 0/1 arrays."""
    eps = fs.dbscan_epsilon
    min_b = max(fs.min_density_floor, inc.centroid_1_lower)
    min_e = max(fs.min_density_floor, inc.centroid_2_lower)
    el = dbscan_labels(r.coords, r.edu, r.brdu, eps, min_e)
    bl = dbscan_labels(r.coords, r.brdu, r.edu, eps, min_b)
    edu_lab = ((el >= 0) & (bl < 0)).astype(np.int8)
    brdu_lab = ((bl >= 0) & (el < 0)).astype(np.int8)
    thym_lab = ((bl < 0) & (el < 0)).astype(np.int8)
    return edu_lab, brdu_lab, thym_lab


def segmentation_trim(coords: np.ndarray, calls: np.ndarray, alt: np.ndarray,
                      start: int, end: int,
                      fs: ForkSenseParams = ForkSenseParams()):
    """Edge trim for long segments (segmentationTrim, forkSense.cpp:1006-1063)."""
    eps = fs.dbscan_epsilon
    if coords[end] - coords[start] < 10 * eps:
        return 0, 0
    seg_c = coords[start : end + 1]
    seg_calls = calls[start : end + 1]
    seg_alt = alt[start : end + 1]
    n = seg_c.shape[0]
    # density sample over the middle third with strict |gap| < eps
    pos = np.concatenate([[0], np.cumsum(seg_calls > 0.5)])
    neg = np.concatenate([[0], np.cumsum(seg_alt > 0.5)])
    ii = np.arange(int(0.33 * n), int(0.66 * n))
    if ii.size == 0:
        return 0, 0
    lo = np.searchsorted(seg_c, seg_c[ii] - eps, side="right")
    hi = np.searchsorted(seg_c, seg_c[ii] + eps, side="left")
    lo = np.maximum(lo, ii - eps)          # index window (forkSense.cpp:1026)
    hi = np.minimum(hi, np.minimum(ii + eps, n))
    attempts = hi - lo
    net = (pos[hi] - pos[lo]) - (neg[hi] - neg[lo])
    dens = net / np.maximum(attempts, 1)
    min_density = float(dens.mean())
    labels = dbscan_labels(seg_c, seg_calls, seg_alt, eps, min_density)
    trim_left = int(np.argmax(labels >= 0)) if (labels >= 0).any() else n
    right_ok = labels[::-1] >= 0
    # reference scans i from n-1 down to 1 (forkSense.cpp:1056)
    trim_right = int(np.argmax(right_ok)) if right_ok.any() else n - 1
    return trim_left, trim_right


def _extract_segments(r: DetectedReadData, open_lab: np.ndarray,
                      close_lab1: np.ndarray, close_lab2: np.ndarray,
                      calls: np.ndarray, alt: np.ndarray,
                      fs: ForkSenseParams) -> list:
    """One analogue's segment automaton (callSegmentation halves,
    forkSense.cpp:295-353): open at open_lab==1, close at
    close_lab1|close_lab2, min length, density trim."""
    segs = []
    coords = r.coords
    n = coords.shape[0]
    in_seg = False
    s_idx = -1
    closing = (close_lab1 == 1) | (close_lab2 == 1)
    opening = open_lab == 1
    i = 0
    while i < n:
        if not in_seg:
            nxt = np.argmax(opening[i:]) if opening[i:].any() else -1
            if nxt < 0:
                break
            i = i + int(nxt)
            s_idx = i
            in_seg = True
            i += 1
        else:
            nxt = np.argmax(closing[i:]) if closing[i:].any() else -1
            if nxt < 0:
                i = n
                break
            e_idx = i + int(nxt)
            if abs(coords[e_idx] - coords[s_idx]) >= fs.segment_min_length:
                tl, tr = segmentation_trim(coords, calls, alt, s_idx, e_idx, fs)
                si, ei = s_idx + tl, e_idx - tr
                segs.append(Segment(int(coords[si]), si, int(coords[ei]), ei))
            in_seg = False
            i = e_idx + 1
    if in_seg and s_idx >= 0:
        e_idx = n - 1
        if abs(coords[e_idx] - coords[s_idx]) >= fs.segment_min_length:
            tl, tr = segmentation_trim(coords, calls, alt, s_idx, e_idx, fs)
            si, ei = s_idx + tl, e_idx - tr
            segs.append(Segment(int(coords[si]), si, int(coords[ei]), ei))
    return segs


def stitch_segments(primary: list, secondary: list,
                    fs: ForkSenseParams = ForkSenseParams()) -> list:
    """Merge primary segments closer than segment_stitch with no intervening
    secondary segment (stitchSegmentation, forkSense.cpp:215-281)."""
    connectivity = {}
    for i in range(len(primary)):
        for j in range(i + 1, len(primary)):
            if primary[j].left_coord - primary[i].right_coord < fs.segment_stitch:
                intervening = any(
                    primary[i].right_coord <= s.left_coord
                    and s.right_coord <= primary[j].left_coord
                    for s in secondary)
                if not intervening:
                    connectivity[i] = j
                    break
    out = []
    ignore = set()
    for i in range(len(primary)):
        if i in ignore:
            continue
        tgt = i
        s = primary[i]
        lc, li, rc, ri = s.left_coord, s.left_idx, s.right_coord, s.right_idx
        while tgt in connectivity:
            m = connectivity[tgt]
            rc, ri = primary[m].right_coord, primary[m].right_idx
            ignore.add(m)
            tgt = m
        out.append(Segment(lc, li, rc, ri))
    return out


def call_segmentation(r: DetectedReadData, edu_lab, brdu_lab, thym_lab,
                      fs: ForkSenseParams = ForkSenseParams()) -> None:
    """callSegmentation (forkSense.cpp:284-423)."""
    edu_segs = _extract_segments(r, edu_lab, thym_lab, brdu_lab,
                                 r.edu, r.brdu, fs)
    brdu_segs = _extract_segments(r, brdu_lab, thym_lab, edu_lab,
                                  r.brdu, r.edu, fs)
    r.brdu_segments = stitch_segments(brdu_segs, edu_segs, fs)
    r.edu_segments = stitch_segments(edu_segs, brdu_segs, fs)


def _closest_following(seg_list, anchor_right: int):
    """Closest segment whose left edge is >= anchor_right; returns
    (index, dist) or (-1, inf)."""
    best, best_d = -1, float("inf")
    for ri, s in enumerate(seg_list):
        if s.left_coord < anchor_right:
            continue
        d = s.left_coord - anchor_right
        if d < best_d:
            best_d, best = d, ri
    return best, best_d


def call_forks(r: DetectedReadData, analogue_order: str,
               fs: ForkSenseParams = ForkSenseParams(),
               human_readable: bool = True) -> None:
    """Mutual-nearest pairing of first-pulse -> second-pulse segments
    (callForks, forkSense.cpp:597-900) including stress signatures."""
    if analogue_order == "EdU,BrdU":
        a1, a2 = r.edu_segments, r.brdu_segments
    else:
        a1, a2 = r.brdu_segments, r.edu_segments

    proto_right, proto_left = [], []
    # right forks: analogue1 then analogue2 to its right
    for li, s1 in enumerate(a1):
        best, best_d = _closest_following(a2, s1.right_coord)
        if best < 0:
            continue
        failed = False
        for l2, o1 in enumerate(a1):
            if l2 == li or a2[best].left_coord < o1.right_coord:
                continue
            if a2[best].left_coord - o1.right_coord < best_d:
                failed = True
                break
        if not failed and best_d < fs.fork_max_gap:
            s1.partners += 1
            a2[best].partners += 1
            proto_right.append((li, best))
    # left forks: analogue2 then analogue1 to its right == analogue1 with
    # analogue2 to its left
    for li, s1 in enumerate(a1):
        best, best_d = -1, float("inf")
        for ri, s2 in enumerate(a2):
            if s1.left_coord < s2.right_coord:
                continue
            d = s1.left_coord - s2.right_coord
            if d < best_d:
                best_d, best = d, ri
        if best < 0:
            continue
        failed = False
        for l2, o1 in enumerate(a1):
            if l2 == li or o1.left_coord < a2[best].right_coord:
                continue
            if o1.left_coord - a2[best].right_coord < best_d:
                failed = True
                break
        if not failed and best_d < fs.fork_max_gap:
            a2[best].partners += 1
            s1.partners += 1
            proto_left.append((best, li))

    isB = r.brdu > 0.5
    isE = r.edu > 0.5
    cumB = np.concatenate([[0], np.cumsum(isB)])
    cumE = np.concatenate([[0], np.cumsum(isE)])

    def count(lo, hi):
        return int(cumB[hi] - cumB[lo]), int(cumE[hi] - cumE[lo]), hi - lo

    def query_span(lc, rc):
        if human_readable or r.ref_to_query is None:
            return -1
        if r.strand == "rev":
            i_l = r.ref_end - lc
            i_r = r.ref_end - rc
        else:
            i_l = lc - r.ref_start
            i_r = rc - r.ref_start
        q = r.ref_to_query
        i_l = int(np.clip(i_l, 0, q.shape[0] - 1))
        i_r = int(np.clip(i_r, 0, q.shape[0] - 1))
        return abs(int(q[i_r]) - int(q[i_l]))

    for li, ri_ in proto_right:
        s1, s2 = a1[li], a2[ri_]
        tip_partners = 0
        lc, lidx = s1.left_coord, s1.left_idx
        if s1.partners == 2:
            lc = (s1.left_coord + s1.right_coord) // 2
            lidx = (s1.left_idx + s1.right_idx) // 2
        rc, ridx = s2.right_coord, s2.right_idx
        if s2.partners == 2:
            rc = (s2.right_coord + s2.left_coord) // 2
            ridx = (s2.right_idx + s2.left_idx) // 2
            tip_partners += 1
        an1_len = float(s1.right_coord - lc)
        an2_len = float(rc - s2.left_coord)
        b1, e1, att1 = count(lidx, s1.right_idx)
        b2, e2, att2 = count(s2.left_idx, ridx)
        f = Segment(lc, lidx, rc, ridx)
        f.partners = tip_partners
        f.query_span = query_span(lc, rc)
        f.stress_signature = [float(rc - lc), an1_len, an2_len,
                              b1 / max(att1, 1), e1 / max(att1, 1),
                              e2 / max(att2, 1), b2 / max(att2, 1)]
        r.right_forks.append(f)

    for ri_, li in proto_left:
        s2, s1 = a2[ri_], a1[li]
        tip_partners = 0
        lc, lidx = s2.left_coord, s2.left_idx
        if s2.partners == 2:
            lc = (s2.left_coord + s2.right_coord) // 2
            lidx = (s2.left_idx + s2.right_idx) // 2
            tip_partners += 1
        rc, ridx = s1.right_coord, s1.right_idx
        if s1.partners == 2:
            rc = (s1.right_coord + s1.left_coord) // 2
            ridx = (s1.right_idx + s1.left_idx) // 2
        an2_len = float(s2.right_coord - lc)
        an1_len = float(rc - s1.left_coord)
        b1, e1, att1 = count(s1.left_idx, ridx)
        b2, e2, att2 = count(lidx, s2.right_idx)
        f = Segment(lc, lidx, rc, ridx)
        f.partners = tip_partners
        f.query_span = query_span(lc, rc)
        f.stress_signature = [float(rc - lc), an1_len, an2_len,
                              b1 / max(att1, 1), e1 / max(att1, 1),
                              e2 / max(att2, 1), b2 / max(att2, 1)]
        r.left_forks.append(f)


def _match_forks(lefts: list, rights: list, origins: bool):
    """Shared mutual-nearest matcher for origins/terminations
    (callOrigins :426-491 / callTerminations :494-561)."""
    out = []
    for li, lf in enumerate(lefts):
        best, best_d = -1, float("inf")
        for ri, rf in enumerate(rights):
            if origins:
                if rf.right_coord < lf.right_coord:
                    continue
                d = rf.right_coord - lf.left_coord
            else:
                if lf.right_coord < rf.right_coord:
                    continue
                d = lf.right_coord - rf.left_coord
            if d < best_d:
                best_d, best = d, ri
        if best < 0:
            continue
        failed = False
        for l2, o in enumerate(lefts):
            if l2 == li:
                continue
            if origins:
                if rights[best].right_coord < o.right_coord:
                    continue
                d = rights[best].right_coord - o.left_coord
            else:
                if o.right_coord < rights[best].right_coord:
                    continue
                d = o.right_coord - rights[best].left_coord
            if d < best_d:
                failed = True
                break
        if failed:
            continue
        lf_, rf_ = lf, rights[best]
        if origins:
            lb = min(lf_.right_coord, rf_.left_coord)
            ub = max(lf_.right_coord, rf_.left_coord)
            lb_i = min(lf_.right_idx, rf_.left_idx)
            ub_i = max(lf_.right_idx, rf_.left_idx)
        else:
            lb = min(lf_.left_coord, rf_.right_coord)
            ub = max(lf_.left_coord, rf_.right_coord)
            lb_i = min(lf_.left_idx, rf_.right_idx)
            ub_i = max(lf_.left_idx, rf_.right_idx)
        out.append(Segment(lb, lb_i, ub, ub_i))
    return out


def call_origins(r: DetectedReadData) -> None:
    r.origins = _match_forks(r.left_forks, r.right_forks, origins=True)


def call_terminations(r: DetectedReadData) -> None:
    r.terminations = _match_forks(r.left_forks, r.right_forks, origins=False)


def call_stalls(r: DetectedReadData, analogue_order: str,
                fs: ForkSenseParams = ForkSenseParams()) -> None:
    """Stall scores at unpaired fork tips (callStalls, forkSense.cpp:1066-1215)."""
    second = r.brdu if analogue_order == "EdU,BrdU" else r.edu
    filt = fs.stall_filter_size
    beta = fs.stall_beta
    alpha = 1.0 / np.log(2.0 / (1.0 + np.exp(-beta)))
    coords = r.coords
    n = coords.shape[0]
    cum = np.concatenate([[0], np.cumsum(second > 0.5)])

    def side_counts(tip):
        c = coords[tip]
        lo = int(np.searchsorted(coords, c - filt, side="right"))
        lo = max(lo, tip - filt)
        hi = int(np.searchsorted(coords, c + filt, side="left"))
        hi = min(hi, tip + filt)
        lhs_att = tip - lo
        rhs_att = hi - tip
        lhs_pos = int(cum[tip] - cum[lo])
        rhs_pos = int(cum[hi] - cum[tip])
        return lhs_pos, lhs_att, rhs_pos, rhs_att

    def softplus_score(num, den):
        score = num / den
        return (alpha * np.log(1 + np.exp(beta * (score - 1)))
                - alpha * np.log(1 + np.exp(-beta)))

    for s in r.right_forks:
        if s.partners > 0:
            s.score = -1
            continue
        tip = s.right_idx
        s.score = -3.0
        if not (filt < tip < n - filt):
            continue
        lp, la, rp, ra = side_counts(tip)
        if la < fs.stall_min_attempts:
            continue
        lhs = lp / la
        if lhs < fs.stall_min_lhs:
            continue
        if ra < fs.stall_min_attempts:
            continue
        rhs = rp / ra
        if lhs - rhs > 0:
            s.score = float(softplus_score(lhs - rhs, lhs))
        else:
            s.score = -2.0

    for s in r.left_forks:
        if s.partners > 0:
            s.score = -1
            continue
        tip = s.left_idx
        s.score = -3.0
        if not (filt < tip < n - filt):
            continue
        lp, la, rp, ra = side_counts(tip)
        if la < fs.stall_min_attempts:
            continue
        lhs = lp / la
        if ra < fs.stall_min_attempts:
            continue
        rhs = rp / ra
        if rhs < fs.stall_min_lhs:
            continue
        if rhs - lhs > 0:
            s.score = float(softplus_score(rhs - lhs, rhs))
        else:
            s.score = -2.0


# ---------------------------------------------------------------------------
# Orchestration + outputs
# ---------------------------------------------------------------------------

def _bed_line(r: DetectedReadData, s: Segment, extra: str = "") -> str:
    return (f"{r.contig} {s.left_coord} {s.right_coord} {r.read_id} "
            f"{r.ref_start} {r.ref_end} {r.strand}{extra}\n")


@dataclass
class ForkSenseOutputs:
    main: list = field(default_factory=list)
    origins: list = field(default_factory=list)
    terminations: list = field(default_factory=list)
    left_forks: list = field(default_factory=list)
    right_forks: list = field(default_factory=list)
    left_signatures: list = field(default_factory=list)
    right_signatures: list = field(default_factory=list)
    brdu_beds: list = field(default_factory=list)
    edu_beds: list = field(default_factory=list)


def process_read(r: DetectedReadData, inc: KMeansResult, analogue_order: str,
                 cfg: SubstrateConfig = DNA_R10,
                 mark_origins: bool = True, mark_terms: bool = True,
                 mark_forks: bool = True, mark_analogues: bool = True,
                 make_signatures: bool = False,
                 human_readable: bool = True) -> ForkSenseOutputs:
    """Full pass-2 treatment of one read (emptyBuffer body,
    forkSense.cpp:1218-1345)."""
    fs = cfg.forksense
    out = ForkSenseOutputs()
    labs = run_dbscan(r, inc, fs)
    call_segmentation(r, *labs, fs)
    segment_to_forks = False
    if mark_origins or mark_terms or mark_forks:
        call_forks(r, analogue_order, fs, human_readable)
        call_stalls(r, analogue_order, fs)
        for f in r.left_forks:
            out.left_forks.append(_bed_line(r, f, f" {f.query_span} {f.score:.6f}"))
        for f in r.right_forks:
            out.right_forks.append(_bed_line(r, f, f" {f.query_span} {f.score:.6f}"))
        if make_signatures:
            for f in r.left_forks:
                sig = " ".join(f"{v:.6f}" for v in f.stress_signature)
                out.left_signatures.append(_bed_line(r, f, f" {sig} {f.score:.6f}"))
            for f in r.right_forks:
                sig = " ".join(f"{v:.6f}" for v in f.stress_signature)
                out.right_signatures.append(_bed_line(r, f, f" {sig} {f.score:.6f}"))
        if mark_origins:
            call_origins(r)
            for o in r.origins:
                out.origins.append(_bed_line(r, o))
        if mark_terms:
            call_terminations(r)
            for t in r.terminations:
                out.terminations.append(_bed_line(r, t))
        segment_to_forks = True
    if mark_analogues:
        for s in r.brdu_segments:
            if segment_to_forks and s.partners == 0:
                continue
            out.brdu_beds.append(_bed_line(r, s))
        for s in r.edu_segments:
            if segment_to_forks and s.partners == 0:
                continue
            out.edu_beds.append(_bed_line(r, s))

    # main per-position segmentation output: only reads with a partnered
    # segment (forkSense.cpp:1307-1337)
    edu_out = np.zeros(r.coords.shape[0], dtype=np.int8)
    brdu_out = np.zeros(r.coords.shape[0], dtype=np.int8)
    write = False
    for s in r.edu_segments:
        if s.partners == 0:
            continue
        edu_out[s.left_idx : s.right_idx + 1] = 1
        write = True
    for s in r.brdu_segments:
        if s.partners == 0:
            continue
        brdu_out[s.left_idx : s.right_idx + 1] = 1
        write = True
    if write:
        lines = [f">{r.read_id} {r.contig} {r.ref_start} {r.ref_end} "
                 f"{r.strand}\n"]
        for i in range(r.coords.shape[0]):
            lines.append(f"{r.coords[i]}\t{edu_out[i]}\t{brdu_out[i]}\n")
        out.main.append("".join(lines))
    return out


def forksense_run(reads: Iterator[DetectedReadData], analogue_order: str,
                  cfg: SubstrateConfig = DNA_R10, read_ordinals=None,
                  progress_cb=None, **kwargs):
    """Two-pass run (sense_main, forkSense.cpp:1765-1787).  ``reads`` must
    be re-iterable (pass a list or a factory upstream for streams).  Pass 1
    pools every read's call-fraction windows in global read order into one
    whole-dataset 2-means (forkSense.cpp:1459-1615); pass 2 calls each
    read.

    Multi-process: callers shard the read list and pass each read's global
    ordinal in ``read_ordinals``; pass 1's call-fraction vectors are then
    gathered over the processes in global window order
    (``parallel/collectives.gather_ordered``), so every process runs the
    single-process 2-means, and pass 2 runs on the local shard only."""
    fs = cfg.forksense
    reads = list(reads)
    if read_ordinals is None:
        read_ordinals = range(len(reads))
    bfr_all, efr_all, counts = [], [], []
    for r in reads:
        bfr, efr = call_fractions_read(r.coords, r.edu, r.brdu, fs)
        bfr_all.append(bfr)
        efr_all.append(efr)
        counts.append(bfr.shape[0])
    keys = window_keys(read_ordinals, counts)
    bfr = gather_ordered(
        np.concatenate(bfr_all) if bfr_all else np.empty(0), keys)
    efr = gather_ordered(
        np.concatenate(efr_all) if efr_all else np.empty(0), keys)
    if bfr.shape[0] < fs.min_call_fraction_windows:
        raise ValueError(
            "insufficient call-fraction windows for forkSense "
            f"({bfr.shape[0]} < {fs.min_call_fraction_windows})")
    inc = estimate_analogue_incorporation(bfr, efr, fs)
    outputs = []
    for i, r in enumerate(reads):
        if r.coords.shape[0] > fs.min_read_positions:
            outputs.append(process_read(r, inc, analogue_order, cfg,
                                        **kwargs))
        if progress_cb is not None:
            # pass-2 progress hook (the reference's bar over the streamed
            # reads, forkSense.cpp:1633-1640)
            progress_cb(i + 1)
    return inc, outputs
