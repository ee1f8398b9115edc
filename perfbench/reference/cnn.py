"""Plain float32 PyTorch forwards of the two detect CNN topologies, written
for the check from their published descriptions, with TF32 off in matmuls
and cuDNN; and the length-bucket and halo-chunk rule by which detect feeds
a read's positions to its CNN.

* ``detect_cnn``: the port's ``DetectCNN`` design (flax layout): signal
  features -> dense + GELU (tanh form), core and residual embeddings,
  dense to ``d_model``, pre-norm dilated residual conv blocks (LayerNorm
  eps 1e-6 with the variance as E[x^2] - E[x]^2, 'SAME' padding), final
  LayerNorm, dense head, softmax.
* ``reference_cnn``: DNAscent v4.1.1's detect model (SavedModel layer
  numbering): two Keras GRU(16) cells (reset_after) over each position's
  samples, [GRU state, core index, residual index] zero-padded to 64
  channels, a QuartzNet-style separable-conv trunk with BatchNorm
  (eps 1e-3) and ReLU, a dense softmax head.

``control=True`` computes the same forwards one precision step below what
the configuration states: conv and dense operands in fp8 e4m3 (per-tensor
scaled) where the configuration runs them in bf16, and GRU matmul
operands rounded to TF32 where it runs them in f32.  Nothing here imports
the program or JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

SIG_QUANT_LO = -6.0
SIG_QUANT_SCALE = 254.0 / 12.0
FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().max().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32's 10-bit mantissa (nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def _dequant(q: torch.Tensor):
    """u8 codes -> (samples, live): (q - 1) / scale + lo by IEEE division;
    live where q != 0 and the sample is not exactly 0."""
    qf = q.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=q.device)
    x = (qf - 1.0) / torch.tensor(SIG_QUANT_SCALE, **f32) \
        + torch.tensor(SIG_QUANT_LO, **f32)
    return x, (qf != 0.0) & (x != 0.0)


class DetectCNN:
    def __init__(self, t: dict, arch: dict, control: bool = False):
        self.t, self.a, self.control = t, arch, control

    def receptive_field(self) -> int:
        return 1 + sum((self.a["kernel"] - 1) * d for d in self.a["dilations"])

    def _op(self, x, w):
        return (_fp8(x), _fp8(w)) if self.control else (x, w)

    def _dense(self, name, x, low=True):
        w, b = self.t[f"params/{name}/kernel"], self.t[f"params/{name}/bias"]
        if low:
            x, w = self._op(x, w)
        return x @ w + b

    def _conv(self, name, x, dilation):     # x (B, L, C)
        w, b = self.t[f"{name}/kernel"], self.t[f"{name}/bias"]  # (k, in, out)
        x, w = self._op(x, w)
        pad = (w.shape[0] - 1) * dilation // 2
        y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), padding=pad,
                     dilation=dilation)
        return y.transpose(1, 2) + b

    def _ln(self, name, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0)
        return ((x - mean) * torch.rsqrt(var + 1e-6) * self.t[f"{name}/scale"]
                + self.t[f"{name}/bias"])

    @staticmethod
    def _gelu(x):
        return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                           * (x + 0.044715 * x ** 3)))

    def __call__(self, core, res, sig_u8):
        x, live = _dequant(sig_u8)
        sig = torch.where(sig_u8 == 0, 0.0, x)
        mask = (sig != 0.0).float()
        n = torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
        mean = (sig * mask).sum(-1, keepdim=True) / n
        var = (((sig - mean) * mask) ** 2).sum(-1, keepdim=True) / n
        feats = torch.cat([sig, mask, mean, torch.sqrt(var + 1e-6),
                           torch.log(n)], dim=-1)
        s = self._gelu(self._dense("Dense_0", feats))
        c = self.t["params/Embed_0/embedding"][core]
        r = self.t["params/Embed_1/embedding"][res]
        h = self._dense("Dense_1", torch.cat([s, c, r], dim=-1))
        for i, d in enumerate(self.a["dilations"]):
            pre = f"params/ConvBlock_{i}"
            y = self._ln(f"{pre}/LayerNorm_0", h)
            y = self._gelu(self._conv(f"{pre}/Conv_0", y, d))
            h = h + self._conv(f"{pre}/Conv_1", y, 1)
        logits = self._dense("Dense_2", self._ln("params/LayerNorm_0", h),
                             low=False)
        return torch.softmax(logits, dim=-1)


class ReferenceCNN:
    """DNAscent v4.1.1's topology; tensors keyed as the SavedModel's
    (``layer<N>/...``, ``trainable<N>``), TF layouts."""

    def __init__(self, t: dict, arch: dict, control: bool = False):
        self.t, self.a, self.control = t, arch, control
        # layer numbers: prologue conv 2 + BN 3; block b starts at s = 4 +
        # 14 b: separable convs s, s+2, ..., s+10 with BNs s+1, ..., s+9
        # between them, shortcut conv s+11, BNs s+12 (main), s+13 (short);
        # epilogue convs 74, 76, 78 with BNs 75, 77
        self.blocks = [4 + 14 * b for b in range(len(arch["blocks"]))]
        self.epilogue = [(74, 75), (76, 77), (78, None)]

    def receptive_field(self) -> int:
        a = self.a
        rf = 1 + (a["prologue"][0] - 1)
        rf += sum(a["separable_per_block"] * (k - 1) for k, _, _ in a["blocks"])
        return rf + sum(k - 1 for k, _, _ in a["epilogue"])

    def _gru(self, sig_u8):
        """(N, T) u8 -> (N, 16) final state of the second cell."""
        t = self.t
        k0, u0, b0 = t["trainable0"], t["trainable1"], t["trainable2"]
        k1, u1, b1 = t["trainable3"], t["trainable4"], t["trainable5"]
        rnd = _tf32 if self.control else (lambda v: v)
        x, live = _dequant(sig_u8)
        n = x.shape[0]
        u = 16
        h0 = torch.zeros((n, u), device=x.device)
        h1 = torch.zeros((n, u), device=x.device)

        def cell(gx, gh, h):
            z = torch.sigmoid(gx[:, :u] + gh[:, :u])
            r = torch.sigmoid(gx[:, u : 2 * u] + gh[:, u : 2 * u])
            hh = torch.tanh(gx[:, 2 * u :] + r * gh[:, 2 * u :])
            return z * h + (1.0 - z) * hh

        for s in range(x.shape[1]):
            n0 = cell(x[:, s : s + 1] * k0 + b0[0], rnd(h0) @ rnd(u0) + b0[1],
                      h0)
            n1 = cell(rnd(n0) @ rnd(k1) + b1[0], rnd(h1) @ rnd(u1) + b1[1],
                      h1)
            m = live[:, s : s + 1]
            h0 = torch.where(m, n0, h0)
            h1 = torch.where(m, n1, h1)
        return h1

    def _conv(self, i, x):         # x (B, C, L)
        w, b = self.t[f"layer{i}/kernel"], self.t[f"layer{i}/bias"]
        if self.control:
            x, w = _fp8(x), _fp8(w)
        return F.conv1d(x, w.permute(2, 1, 0),
                        padding=(w.shape[0] - 1) // 2) + b[:, None]

    def _sep(self, i, x):
        dw = self.t[f"layer{i}/depthwise_kernel"]     # (k, C, 1)
        pw = self.t[f"layer{i}/pointwise_kernel"]     # (1, in, out)
        if self.control:
            x, dw, pw = _fp8(x), _fp8(dw), _fp8(pw)
        y = F.conv1d(x, dw.permute(1, 2, 0), padding=(dw.shape[0] - 1) // 2,
                     groups=dw.shape[1])
        if self.control:
            y = _fp8(y)
        y = F.conv1d(y, pw.permute(2, 1, 0))
        return y + self.t[f"layer{i}/bias"][:, None]

    def _bn(self, i, x):
        t = self.t
        inv = torch.rsqrt(t[f"layer{i}/moving_variance"] + self.a["bn_eps"])
        return ((x - t[f"layer{i}/moving_mean"][:, None]) * inv[:, None]
                * t[f"layer{i}/gamma"][:, None] + t[f"layer{i}/beta"][:, None])

    def __call__(self, core, res, sig_u8):
        B, L, T = sig_u8.shape
        h = self._gru(sig_u8.reshape(B * L, T)).reshape(B, L, 16)
        feats = torch.cat([h, core.float()[..., None], res.float()[..., None]],
                          dim=-1)
        x = F.pad(feats, (0, self.a["trunk_channels"] - feats.shape[-1]))
        x = torch.relu(self._bn(3, self._conv(2, x.transpose(1, 2))))
        n_sep = self.a["separable_per_block"]
        for s in self.blocks:
            y = x
            for j in range(n_sep - 1):
                y = torch.relu(self._bn(s + 2 * j + 1, self._sep(s + 2 * j, y)))
            y = self._bn(s + 2 * n_sep, self._sep(s + 2 * n_sep - 2, y))
            sc = self._bn(s + 2 * n_sep + 1, self._conv(s + 2 * n_sep - 1, x))
            x = torch.relu(y + sc)
        for conv, bn in self.epilogue:
            x = self._conv(conv, x)
            x = torch.relu(self._bn(bn, x) if bn is not None else x)
        logits = x.transpose(1, 2) @ self.t["trainable190"] \
            + self.t["trainable191"]
        return torch.softmax(logits, dim=-1)


def build(config: dict, tensors: dict, control: bool = False):
    kind = config["architecture"]["kind"]
    cls = {"detect_cnn": DetectCNN, "reference_cnn": ReferenceCNN}[kind]
    return cls(tensors, config["architecture"], control)


def bucket_len(n: int) -> int:
    """A CNN call's padded position count: 256, then multiples of 2048."""
    return 256 if n <= 256 else ((n + 2047) // 2048) * 2048


def read_chunks(n: int, rf: int, chunk: int) -> list[tuple]:
    """[(lo, hi, core_lo, core_hi)]: the whole read when it holds at most
    ``chunk`` positions, else chunks of ``chunk`` core positions with a halo
    of max(256, rf rounded up to 256) positions each side."""
    if n <= chunk:
        return [(0, n, 0, n)]
    halo = max(256, -(-rf // 256) * 256)
    return [(max(0, c - halo), min(n, min(n, c + chunk) + halo), c,
             min(n, c + chunk)) for c in range(0, n, chunk)]


@torch.no_grad()
def probabilities(model, reads: list, device, chunk: int = 32768,
                  max_positions: int = 1 << 18) -> list:
    """Per read (a ``Positions`` or None) its (Ct, 2) [BrdU, EdU]
    probabilities at the centre-T positions, each part of the read run
    zero-padded to its bucket length, as detect feeds its CNN."""
    prev32 = torch.backends.cuda.matmul.allow_tf32
    prevdnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rf = model.receptive_field()
        out = []
        for pos in reads:
            if pos is None:
                out.append(None)
                continue
            n = pos.coord.shape[0]
            probs = np.zeros((n, 3), np.float32)
            for lo, hi, clo, chi in read_chunks(n, rf, chunk):
                L = bucket_len(hi - lo)
                core = np.zeros((1, L), np.int64)
                res = np.zeros((1, L), np.int64)
                sig = np.zeros((1, L, pos.sig_u8.shape[1]), np.uint8)
                core[0, : hi - lo] = pos.core[lo:hi]
                res[0, : hi - lo] = pos.res[lo:hi]
                sig[0, : hi - lo] = pos.sig_u8[lo:hi]
                p = model(torch.from_numpy(core).to(device),
                          torch.from_numpy(res).to(device),
                          torch.from_numpy(sig).to(device))
                probs[clo:chi] = p[0, clo - lo : chi - lo].float().cpu().numpy()
            out.append(probs[pos.center_t][:, 1:3])
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev32
        torch.backends.cudnn.allow_tf32 = prevdnn
