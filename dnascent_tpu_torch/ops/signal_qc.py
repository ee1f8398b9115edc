"""Raw-signal QC helpers mirroring scrappie's utility functions.

The reference vendors these in src/scrappie/scrappie_common.c (quantilef
:32-70, madf :96-121, trim_and_segment_raw :74-94, trim_raw_by_mad :123-160).
They sit outside the reference's main detect path but are part of its public
surface, so they are provided here with the same numeric semantics,
vectorised with numpy (chunked MAD computes as one reshape + median, not a
per-chunk loop).  A copy of ``dnascent_tpu/ops/signal_qc.py``: host numpy,
which no path of either package calls.
"""

from __future__ import annotations

import numpy as np

MAD_SCALING_FACTOR = 1.4826


def quantilef(x: np.ndarray, p: float | np.ndarray) -> np.ndarray:
    """Linear-interpolated quantile(s) with scrappie's exact index rule
    (scrappie_common.c:55-65: idx = floor(p*(n-1)), blend with idx+1)."""
    p_arr = np.atleast_1d(np.asarray(p, dtype=np.float64))
    x = np.asarray(x, dtype=np.float32)
    if x.size == 0:
        out = np.full(p_arr.shape, np.nan, dtype=np.float32)
        return out if np.ndim(p) else out[0]
    s = np.sort(x)
    idx = (p_arr * (x.size - 1)).astype(np.int64)
    rem = p_arr * (x.size - 1) - idx
    hi = np.minimum(idx + 1, x.size - 1)
    out = ((1.0 - rem) * s[idx] + rem * s[hi]).astype(np.float32)
    return out if np.ndim(p) else out[0]


def madf(x: np.ndarray, med: float | None = None) -> float:
    """Median absolute deviation scaled by 1.4826
    (scrappie_common.c:96-121; n==1 returns 0)."""
    x = np.asarray(x, dtype=np.float32)
    if x.size == 1:
        return 0.0
    m = np.median(x) if med is None else med
    return float(np.median(np.abs(x - m)) * MAD_SCALING_FACTOR)


def trim_raw_by_mad(raw: np.ndarray, chunk_size: int = 100,
                    perc: float = 0.2) -> tuple[int, int]:
    """Trim low-variance flanks: per-chunk MAD, threshold at the ``perc``
    quantile of the chunk MADs, strip leading/trailing chunks at or below it
    (scrappie_common.c:123-160).  Returns the (start, end) sample window.
    """
    assert chunk_size > 1
    assert 0.0 <= perc <= 1.0
    raw = np.asarray(raw, dtype=np.float32)
    nchunk = raw.shape[0] // chunk_size
    start, end = 0, nchunk * chunk_size
    if nchunk == 0:
        return start, end
    chunks = raw[:end].reshape(nchunk, chunk_size)
    med = np.median(chunks, axis=1, keepdims=True)
    madarr = (np.median(np.abs(chunks - med), axis=1)
              * MAD_SCALING_FACTOR).astype(np.float32)
    if chunk_size == 1:
        madarr[:] = 0.0
    thresh = quantilef(madarr, perc)
    above = madarr > thresh
    if above.any():
        first = int(np.argmax(above))
        last = int(len(above) - np.argmax(above[::-1]))
        start = first * chunk_size
        end = last * chunk_size
    else:
        start = end  # every chunk trimmed from the front, like the C loop
    return start, end


def trim_and_segment_raw(raw: np.ndarray, trim_start: int = 200,
                         trim_end: int = 10, varseg_chunk: int = 100,
                         varseg_thresh: float = 0.0) -> tuple[int, int]:
    """MAD trim then fixed start/end trims (scrappie_common.c:74-94).
    Returns (start, end); start >= end means the read is rejected."""
    start, end = trim_raw_by_mad(raw, varseg_chunk, varseg_thresh)
    return start + trim_start, end - trim_end
