"""Signal encoder of the reference CNN: two stacked Keras-v2 GRU(16) cells
with ``reset_after`` over each position's window of raw samples.  Plain
PyTorch twin of kernel F and the host helpers around it (port of
``dnascent_tpu/models/reference_cnn.py``'s ``_gru_scan`` and
``_gru_scan_pallas``).

Gate math, order [z, r, h] (recurrent activation sigmoid, activation tanh):

    z  = sigmoid(x.Wz + bxz + h.Uz + bhz)
    r  = sigmoid(x.Wr + bxr + h.Ur + bhr)
    hh = tanh(x.Wh + bxh + r * (h.Uh + bhh))
    h' = z * h + (1 - z) * hh

A masked step (padding, Keras Masking) carries both cells' states through.
On the u8 path a step is masked when its code is 0 or its dequantised value
is exactly 0.0; the dequantisation ``(q - 1) / SIG_QUANT_SCALE +
SIG_QUANT_LO`` is an IEEE f32 division here and in the kernel, because the
code q=128 lands next to 0.0 and the mask depends on how it rounds.

``gru_encoder_library`` computes the same function through
``torch.nn.GRU`` over each row's live steps, as the yardstick of kernel F's
speed (``chip_smoke.py``'s ``library_ms``); the detect path never calls it.

Weights travel as one packed f32 vector (:func:`pack_weights`), the layout
the kernel copies into shared memory: the matrices are stored transposed,
(48, 16), so each gate's 16 weights are contiguous.
"""

from __future__ import annotations

import torch
from torch.nn.utils.rnn import pack_padded_sequence

from ..models.cnn import SIG_QUANT_LO, SIG_QUANT_SCALE

GRU_UNITS = 16
GATES = 3 * GRU_UNITS
# packed layout: cell-0 input row, four bias rows (b0x, b0h, b1x, b1h), then
# the three 16x48 matrices U0, W1, U1, each transposed to (48, 16)
_VECTORS = ("k0", "b0x", "b0h", "b1x", "b1h")
_MATRICES = ("U0", "W1", "U1")
PACKED_SIZE = (len(_VECTORS) + len(_MATRICES) * GRU_UNITS) * GATES


def pack_weights(p0: dict, p1: dict) -> torch.Tensor:
    """One contiguous f32 vector of PACKED_SIZE from the two cells'
    ``kernel`` ((1, 48) and (16, 48)), ``recurrent`` (16, 48) and ``bias``
    (2, 48) tensors."""
    parts = dict(k0=p0["kernel"], b0x=p0["bias"][0], b0h=p0["bias"][1],
                 b1x=p1["bias"][0], b1h=p1["bias"][1], U0=p0["recurrent"],
                 W1=p1["kernel"], U1=p1["recurrent"])
    flat = []
    for name in _VECTORS + _MATRICES:
        t = parts[name].float()
        rows = GRU_UNITS if name in _MATRICES else 1
        if t.numel() != rows * GATES:
            raise ValueError(f"GRU weight {name} has shape {tuple(t.shape)}, "
                             f"expected ({rows}, {GATES})")
        t = t.reshape(rows, GATES)
        flat.append((t.t() if name in _MATRICES else t).reshape(-1))
    return torch.cat(flat).contiguous()


def unpack_weights(w: torch.Tensor) -> dict:
    """The (1, 48) vectors and the (16, 48) matrices of the packed vector,
    as views (the inverse of pack_weights)."""
    out, o = {}, 0
    for name in _VECTORS:
        out[name] = w[o : o + GATES].reshape(1, GATES)
        o += GATES
    for name in _MATRICES:
        out[name] = w[o : o + GATES * GRU_UNITS].reshape(GATES, GRU_UNITS).t()
        o += GATES * GRU_UNITS
    return out


def dequantise(xq: torch.Tensor):
    """(x f32, live bool) of u8 codes: x = (q - 1) / SIG_QUANT_SCALE +
    SIG_QUANT_LO by IEEE division (a 0-dim divisor on the tensor's own
    device, so no backend swaps it for a reciprocal multiply), live where
    q != 0 and x != 0.0."""
    q = xq.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=q.device)
    x = (q - 1.0) / torch.tensor(SIG_QUANT_SCALE, **f32) \
        + torch.tensor(SIG_QUANT_LO, **f32)
    return x, (q != 0.0) & (x != 0.0)


def _cell(gx: torch.Tensor, gh: torch.Tensor, h: torch.Tensor):
    u = GRU_UNITS
    z = torch.sigmoid(gx[:, :u] + gh[:, :u])
    r = torch.sigmoid(gx[:, u : 2 * u] + gh[:, u : 2 * u])
    hh = torch.tanh(gx[:, 2 * u :] + r * gh[:, 2 * u :])
    return z * h + (1.0 - z) * hh


def _product(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``h @ m`` for (N, 16) x (16, 48).  On the CPU as 16 rounded
    multiplies and adds in k order: the CPU's GEMM libraries (MKL, oneDNN)
    pick their kernels at run time from process state, so their rounding
    can differ between two runs on the same inputs, and these elementwise
    ops round the same way in every process.  On a card, cuBLAS in f32 (a
    fixed kernel for a fixed shape, and ~2000 fewer launches a step when
    training takes this scan)."""
    if h.device.type != "cpu":
        return h @ m
    acc = h[:, :1] * m[0]
    for k in range(1, h.shape[1]):
        acc = acc + h[:, k : k + 1] * m[k]
    return acc


def gru_scan_plain(x: torch.Tensor, live: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """The two cells over the sample axis: ``x`` (N, T) f32 samples,
    ``live`` (N, T) bool, ``w`` the packed weights.  Returns the second
    cell's final state, (N, 16) f32."""
    p = unpack_weights(w)
    n = x.shape[0]
    h0 = torch.zeros((n, GRU_UNITS), dtype=torch.float32, device=x.device)
    h1 = torch.zeros_like(h0)
    for t in range(x.shape[1]):
        # a (N, 1) x (1, 48) product is one rounded multiply per element
        n0 = _cell(x[:, t : t + 1] * p["k0"] + p["b0x"],
                   _product(h0, p["U0"]) + p["b0h"], h0)
        n1 = _cell(_product(n0, p["W1"]) + p["b1x"],
                   _product(h1, p["U1"]) + p["b1h"], h1)
        m = live[:, t : t + 1]
        h0 = torch.where(m, n0, h0)
        h1 = torch.where(m, n1, h1)
    return h1


def gru_encoder_plain(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain twin of kernel F: ``xq`` (N, T) u8 codes (0 = padding) ->
    (N, 16) f32."""
    x, live = dequantise(xq)
    return gru_scan_plain(x, live, w)


# Kernel F's yardstick: the same function as one library call.  A masked
# step carries both states, which is the same as deleting it, so with each
# row's live steps compacted to the front, torch.nn.GRU (cuDNN on a card)
# over a packed batch computes F.  Used by chip_smoke.py and the tests only,
# never on the detect path.

def _torch_gate_order(m: torch.Tensor) -> torch.Tensor:
    """Keras gate columns [z, r, h] -> PyTorch's [r, z, n]."""
    u = GRU_UNITS
    return torch.cat([m[..., u : 2 * u], m[..., :u], m[..., 2 * u :]], dim=-1)


def library_gru(w: torch.Tensor) -> torch.nn.GRU:
    """``torch.nn.GRU(1, 16, num_layers=2, batch_first=True)`` holding the
    packed weights ``w``, on ``w``'s device.  PyTorch's GRU is the
    ``reset_after`` form, n = tanh(W_in x + b_in + r * (W_hn h + b_hn)), and
    h' = (1 - z) * n + z * h, so only the gate order changes."""
    p = unpack_weights(w)
    gru = torch.nn.GRU(1, GRU_UNITS, num_layers=2, batch_first=True)
    gru = gru.to(w.device)
    layers = (("k0", "U0", "b0x", "b0h"), ("W1", "U1", "b1x", "b1h"))
    with torch.no_grad():
        for layer, names in enumerate(layers):
            kernel, recurrent, bx, bh = (_torch_gate_order(p[k]) for k in names)
            getattr(gru, f"weight_ih_l{layer}").copy_(kernel.t())
            getattr(gru, f"weight_hh_l{layer}").copy_(recurrent.t())
            getattr(gru, f"bias_ih_l{layer}").copy_(bx[0])
            getattr(gru, f"bias_hh_l{layer}").copy_(bh[0])
    return gru


def pack_live(xq: torch.Tensor):
    """(packed sequence of each row's live samples, in order, the rows that
    have any; those rows' indices).  ``pack_padded_sequence`` refuses length
    0, so rows with no live step are left out (None when no row is left)."""
    x, live = dequantise(xq)
    lengths = live.sum(dim=1)
    # live steps first, each group in time order (a stable sort on "dead")
    order = torch.sort((~live).to(torch.uint8), dim=1, stable=True).indices
    compact = torch.gather(x, 1, order)
    rows = torch.nonzero(lengths > 0).squeeze(1)
    if rows.numel() == 0:
        return None, rows
    packed = pack_padded_sequence(compact[rows].unsqueeze(-1),
                                  lengths[rows].cpu(), batch_first=True,
                                  enforce_sorted=False)
    return packed, rows


def gru_encoder_library(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kernel F's function through ``torch.nn.GRU`` over the live steps:
    ``xq`` (N, T) u8 codes -> (N, 16) f32, zeros for rows with no live
    step."""
    out = torch.zeros((xq.shape[0], GRU_UNITS), dtype=torch.float32,
                      device=xq.device)
    packed, rows = pack_live(xq)
    if packed is not None:
        with torch.no_grad():
            _, h_n = library_gru(w)(packed)
        out[rows] = h_n[-1]
    return out
