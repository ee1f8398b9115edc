"""The detect CNN as an ``nn.Module`` (port of ``dnascent_tpu/models/cnn.py``
``DetectCNN``).

Inputs and output keep the JAX package's layout: core and residual
sequence indices (B, L), the raw-sample window (B, L, RAWDEPTH) as u8
(0 = padding) or float, and (B, L, 3) probabilities ordered [unmodified-T,
BrdU, EdU].  Dense layers, embeddings and convolutions run in bfloat16 with
float32 parameters, the normalisation and softmax head in float32, as the
flax model does.  Details that follow flax rather than torch's defaults:
LayerNorm eps 1e-6 with the variance as E[x^2] - E[x]^2, GELU in its tanh
form evaluated op by op in the activation dtype (as ``jax.nn.gelu`` is),
'SAME' dilated padding (2*d each side for kernel 5), and bias added after
the bf16 product is rounded.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

CORE_VOCAB = 4 ** 5 + 2      # +1 shift, 0 reserved for padding
RESIDUAL_VOCAB = 4 ** 4 + 2
RAWDEPTH = 20                # reads.h:12
N_CLASSES = 3                # [unmodified-T, BrdU, EdU]
# u8 signal quantisation: q=0 is padding; [-6, 6] maps onto [1, 255]
SIG_QUANT_LO, SIG_QUANT_HI = -6.0, 6.0
SIG_QUANT_SCALE = 254.0 / (SIG_QUANT_HI - SIG_QUANT_LO)
_BF16 = torch.bfloat16


def quantise_signal_u8(sig: np.ndarray) -> np.ndarray:
    """Host-side u8 quantisation of scaled samples (padding 0.0 stays 0)."""
    q = np.clip(np.rint((sig - SIG_QUANT_LO) * SIG_QUANT_SCALE) + 1.0,
                1.0, 255.0).astype(np.uint8)
    return np.where(sig == 0.0, np.uint8(0), q)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form) with every op rounded to ``x``'s dtype.
    It agrees with jax.nn.gelu on 99.7% of bf16 inputs; torch's fused GELU,
    which rounds once, on 55%."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` in float32: eps 1e-6, fast variance."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


class Dense(nn.Module):
    """flax ``nn.Dense`` with a compute dtype: kernel stored (out, in)."""

    def __init__(self, d_in: int, d_out: int, dtype=_BF16):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        return y + self.bias.to(self.dtype)


class Conv(nn.Module):
    """flax ``nn.Conv`` over (B, L, C) with 'SAME' padding and dilation;
    kernel stored (out, in, k) for ``conv1d``."""

    def __init__(self, d_in: int, d_out: int, kernel: int, dilation: int = 1):
        super().__init__()
        self.dilation = dilation
        self.pad = (kernel - 1) * dilation // 2
        self.weight = nn.Parameter(torch.empty(d_out, d_in, kernel))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x):
        y = F.conv1d(x.to(_BF16).transpose(1, 2), self.weight.to(_BF16),
                     padding=self.pad, dilation=self.dilation)
        return y.transpose(1, 2) + self.bias.to(_BF16)


class ConvBlock(nn.Module):
    """Pre-norm dilated residual conv block."""

    def __init__(self, features: int, kernel: int = 5, dilation: int = 1):
        super().__init__()
        self.norm = LayerNorm(features)
        self.conv0 = Conv(features, features, kernel, dilation)
        self.conv1 = Conv(features, features, 1)

    def forward(self, x):
        h = self.norm(x).to(_BF16)
        h = gelu_tanh(self.conv0(h))
        h = self.conv1(h)
        return x + h.float()


class DetectCNN(nn.Module):
    """Per-position analogue classifier with the reference's input
    contract; default width 128 with 8 dilated blocks."""

    def __init__(self, d_model: int = 128, d_core: int = 64,
                 d_residual: int = 32, d_signal: int = 96,
                 dilations: tuple = (1, 2, 4, 8, 16, 32, 1, 2),
                 kernel: int = 5):
        super().__init__()
        self.kernel = kernel
        self.dilations = tuple(dilations)
        n_feats = 2 * RAWDEPTH + 3
        self.signal_dense = Dense(n_feats, d_signal)
        self.core_embed = nn.Parameter(torch.empty(CORE_VOCAB, d_core))
        self.residual_embed = nn.Parameter(
            torch.empty(RESIDUAL_VOCAB, d_residual))
        self.in_dense = Dense(d_signal + d_core + d_residual, d_model)
        self.blocks = nn.ModuleList(
            ConvBlock(d_model, kernel, d) for d in self.dilations)
        self.norm = LayerNorm(d_model)
        self.head = Dense(d_model, N_CLASSES, dtype=torch.float32)

    def receptive_field(self) -> int:
        return 1 + sum((self.kernel - 1) * d for d in self.dilations)

    def forward(self, core_idx, residual_idx, signal):
        if signal.dtype == torch.uint8:
            q = signal.float()
            signal = torch.where(q == 0.0, 0.0,
                                 (q - 1.0) / SIG_QUANT_SCALE + SIG_QUANT_LO)
        signal = signal.float()
        mask = signal != 0.0
        maskf = mask.float()
        nvalid = torch.clamp(mask.sum(-1, keepdim=True), min=1).float()
        mean = (signal * maskf).sum(-1, keepdim=True) / nvalid
        var = (((signal - mean) * maskf) ** 2).sum(-1, keepdim=True) / nvalid
        feats = torch.cat([signal, maskf, mean, torch.sqrt(var + 1e-6),
                           torch.log(nvalid)], dim=-1)
        s = gelu_tanh(self.signal_dense(feats))
        c = F.embedding(core_idx.long(), self.core_embed.to(_BF16))
        r = F.embedding(residual_idx.long(), self.residual_embed.to(_BF16))
        x = self.in_dense(torch.cat([s, c, r], dim=-1)).float()
        for blk in self.blocks:
            x = blk(x)
        logits = self.head(self.norm(x))
        return torch.softmax(logits, dim=-1)


def _flax_layers(model: DetectCNN):
    """(flax path prefix, torch module) pairs in the flax naming order."""
    pairs = [("params/Dense_0", model.signal_dense),
             ("params/Dense_1", model.in_dense)]
    for i, blk in enumerate(model.blocks):
        pre = f"params/ConvBlock_{i}"
        pairs += [(f"{pre}/LayerNorm_0", blk.norm), (f"{pre}/Conv_0", blk.conv0),
                  (f"{pre}/Conv_1", blk.conv1)]
    pairs += [("params/LayerNorm_0", model.norm), ("params/Dense_2", model.head)]
    return pairs


def params_from_flax(model: DetectCNN, flat: dict) -> DetectCNN:
    """Load weights in the key layout ``dnascent_tpu.models.cnn.save_params``
    writes (``params/Dense_0/kernel``, ...).  Dense kernels (in, out) become
    (out, in); conv kernels (k, in, out) become (out, in, k)."""
    def take(key, shape):
        if key not in flat:
            raise KeyError(f"missing weight {key}")
        arr = torch.tensor(np.asarray(flat[key], dtype=np.float32))
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(shape)}")
        return arr

    with torch.no_grad():
        for pre, mod in _flax_layers(model):
            if isinstance(mod, LayerNorm):
                mod.scale.copy_(take(f"{pre}/scale", mod.scale.shape))
                mod.bias.copy_(take(f"{pre}/bias", mod.bias.shape))
                continue
            w = mod.weight
            if isinstance(mod, Dense):
                kern = take(f"{pre}/kernel", (w.shape[1], w.shape[0])).t()
            else:
                kern = take(f"{pre}/kernel",
                            (w.shape[2], w.shape[1], w.shape[0])).permute(2, 1, 0)
            w.copy_(kern)
            mod.bias.copy_(take(f"{pre}/bias", mod.bias.shape))
        model.core_embed.copy_(take("params/Embed_0/embedding",
                                    model.core_embed.shape))
        model.residual_embed.copy_(take("params/Embed_1/embedding",
                                        model.residual_embed.shape))
    return model


def save_params(model: DetectCNN, path: str) -> None:
    """Write the weights as the npz ``dnascent_tpu.models.cnn.save_params``
    writes, which both packages' ``detect --cnn-weights`` read: the key
    layout of ``params_from_flax`` (its inverse), Dense kernels (in, out),
    conv kernels (k, in, out), f32."""
    def arr(t):
        return t.detach().cpu().float().numpy()

    flat = {}
    for pre, mod in _flax_layers(model):
        if isinstance(mod, LayerNorm):
            flat[f"{pre}/scale"] = arr(mod.scale)
        else:
            w = mod.weight
            flat[f"{pre}/kernel"] = arr(
                w.t() if isinstance(mod, Dense) else w.permute(2, 1, 0))
        flat[f"{pre}/bias"] = arr(mod.bias)
    flat["params/Embed_0/embedding"] = arr(model.core_embed)
    flat["params/Embed_1/embedding"] = arr(model.residual_embed)
    np.savez(path, **flat)


def load_npz(model: DetectCNN, path: str) -> DetectCNN:
    with np.load(path) as data:
        return params_from_flax(model, {k: data[k] for k in data.files})


def init_untrained(model: DetectCNN, seed: int = 0) -> DetectCNN:
    """Random weights from a seeded ``torch.Generator`` (LeCun-normal
    kernels, zero biases, unit-normal embeddings scaled by 1/sqrt(width)).
    The JAX package draws its untrained weights from ``PRNGKey(0)``, which
    torch cannot reproduce, so untrained outputs of the two packages differ;
    pass the JAX weights through ``params_from_flax`` to compare them."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for _pre, mod in _flax_layers(model):
            if isinstance(mod, LayerNorm):
                continue
            w = mod.weight
            fan_in = w.shape[1] * (w.shape[2] if w.dim() == 3 else 1)
            w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(fan_in))
        for emb in (model.core_embed, model.residual_embed):
            emb.copy_(torch.randn(emb.shape, generator=g)
                      / math.sqrt(emb.shape[1]))
    return model
