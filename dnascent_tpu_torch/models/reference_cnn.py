"""The reference's trained detect-CNN topology as an ``nn.Module`` (port of
``dnascent_tpu/models/reference_cnn.py``).

The topology is fixed by the reference SavedModel's 268-tensor inventory
(``dnascent_tpu/models/reference_cnn_manifest.json``):

* a signal encoder of two stacked Keras-v2 GRU(16) cells over each
  position's window of up to RAWDEPTH=20 raw samples (u8 windows: kernel F
  on a CUDA device, ``ops/gru_cuda.py``, its plain twin on the CPU; float
  windows, which training feeds: the plain scan on any device);
* a parameter-free channel lift: [GRU state (16), core index, residual
  index] zero-padded to the trunk's 64 channels, as the JAX package
  reconstructs it (ROADMAP section 3: mirrored, not "fixed");
* a QuartzNet-style separable-conv trunk, a prologue Conv1D(64, k=3) + BN,
  five residual blocks of six SeparableConv1D (2 @ 64 ch k=5, 2 @ 128 ch
  k=9, 1 @ 256 ch k=17) with a shortcut Conv1D, and an epilogue of three
  Conv1D (256, 128, 64 ch, k=3);
* a dense (64, 3) softmax head over [unmodified-T, BrdU, EdU].

Same call as the port's ``DetectCNN``: ``forward(core_idx, residual_idx,
signal) -> (B, L, 3)``.  Precision follows the JAX module: convolution
inputs and weights in ``conv_dtype`` (bf16 by default; the depthwise output
stays in it into the pointwise conv), each conv result to f32 before its
f32 bias; BatchNorm (eps 1e-3, rsqrt), ReLU, the head and softmax in f32.
Convolutions are cuDNN/oneDNN ``conv1d`` calls ('SAME' padding, (k-1)/2 each
side), as they were XLA convolutions in the JAX package.

Two routes through the same arithmetic.  With gradients on (training) the
trunk is the module chain below.  With them off (every detect path) each
convolution is followed by one ``ops/trunk_epilogue_cuda.trunk_epilogue``
(the CUDA kernel on a card, its plain twin, the chain's own ops, on the
CPU) doing the bias, BatchNorm, residual add, ReLU and cast to the next
conv's dtype, with the conv weights in the conv dtype, BatchNorm's rsqrt
and the GRU's packed weights prepared once a model (``inference_cache``).
Both give the same bits: the same operations in the same order, rounded at
the same points.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import gru as gru_ops
from ..ops.gru_cuda import gru_encoder
from ..ops.trunk_epilogue_cuda import trunk_epilogue

N_CLASSES = 3
GRU_UNITS = gru_ops.GRU_UNITS
TRUNK_CH = 64

# trunk wiring: the manifest's layer_with_weights numbers, as the JAX
# module's _PROLOGUE/_BLOCKS/_EPILOGUE tables give them
_PROLOGUE = (2, 3)                      # Conv1D(3, 64, 64), BN
_BLOCKS = tuple(
    dict(seps=tuple(range(s, s + 12, 2)), bns=tuple(range(s + 1, s + 11, 2)),
         shortcut=s + 11, bn_main=s + 12, bn_short=s + 13)
    for s in (4, 18, 32, 46, 60))
_EPILOGUE = ((74, 75), (76, 77), (78, None))   # (conv, bn-or-None)
# (kernel, in_ch, out_ch) of each plain conv
_CONV_SHAPES = {
    2: (3, 64, 64), 15: (5, 64, 64), 29: (5, 64, 64), 43: (9, 64, 128),
    57: (9, 128, 128), 71: (17, 128, 256), 74: (3, 256, 256),
    76: (3, 256, 128), 78: (3, 128, 64),
}
# (kernel, in_ch, out_ch) of each separable conv, and channels of each BN
_SEP_SHAPES: dict = {}
_BN_CH = {3: 64, 75: 256, 77: 128}
for _blk, (_k, _cin, _cout) in zip(_BLOCKS, ((5, 64, 64), (5, 64, 64),
                                             (9, 64, 128), (9, 128, 128),
                                             (17, 128, 256))):
    for _j, _s in enumerate(_blk["seps"]):
        _SEP_SHAPES[_s] = (_k, _cin if _j == 0 else _cout, _cout)
    for _l in (*_blk["bns"], _blk["bn_main"], _blk["bn_short"]):
        _BN_CH[_l] = _cout
_BN_EPS = 1e-3   # Keras BatchNormalization default
_BN_PARTS = ("gamma", "beta", "moving_mean", "moving_variance")
# GRU cells and the head live under trainable_variables/<n> in the bundle
_TRAINABLE = {"gru0/kernel": 0, "gru0/recurrent": 1, "gru0/bias": 2,
              "gru1/kernel": 3, "gru1/recurrent": 4, "gru1/bias": 5,
              "head/kernel": 190, "head/bias": 191}


class GRUEncoder(nn.Module):
    """The two GRU(16) cells.  A u8 window, the form every detect path
    builds, runs kernel F on a CUDA device (its plain twin on the CPU).  A
    float window, the form training batches carry, runs the plain scan on
    any device, as the JAX module's float windows run its XLA scan on any
    backend; it is differentiable."""

    def __init__(self):
        super().__init__()
        u, g = GRU_UNITS, gru_ops.GATES
        self.kernel0 = nn.Parameter(torch.zeros(1, g))
        self.recurrent0 = nn.Parameter(torch.zeros(u, g))
        self.bias0 = nn.Parameter(torch.zeros(2, g))
        self.kernel1 = nn.Parameter(torch.zeros(u, g))
        self.recurrent1 = nn.Parameter(torch.zeros(u, g))
        self.bias1 = nn.Parameter(torch.zeros(2, g))

    def packed(self) -> torch.Tensor:
        return gru_ops.pack_weights(
            dict(kernel=self.kernel0, recurrent=self.recurrent0,
                 bias=self.bias0),
            dict(kernel=self.kernel1, recurrent=self.recurrent1,
                 bias=self.bias1))

    def forward(self, signal: torch.Tensor,
                packed: torch.Tensor | None = None) -> torch.Tensor:
        """(N, T) u8 codes or f32 samples (0.0 = padding) -> (N, 16);
        ``packed``: ``self.packed()`` prepared beforehand."""
        w = self.packed() if packed is None else packed
        if signal.dtype == torch.uint8:
            return gru_encoder(signal.contiguous(), w)
        x = signal.float()
        return gru_ops.gru_scan_plain(x, x != 0.0, w)


def _conv(x, w):
    """A plain conv ('SAME' padding) of ``x`` already in the conv dtype."""
    return F.conv1d(x, w, padding=(w.shape[2] - 1) // 2)


def _sep_conv(x, depthwise, pointwise):
    """Depthwise then pointwise, the depthwise result kept in the conv
    dtype."""
    y = F.conv1d(x, depthwise, padding=(depthwise.shape[2] - 1) // 2,
                 groups=depthwise.shape[0])
    return F.conv1d(y, pointwise)


class Conv(nn.Module):
    """Keras Conv1D, kernel stored (out, in, k) for ``conv1d``."""

    def __init__(self, k: int, cin: int, cout: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(cout, cin, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):   # (B, C, L) f32 -> f32
        y = _conv(x.to(self.dtype), self.weight.to(self.dtype))
        return y.float() + self.bias[:, None]


class SepConv(nn.Module):
    """Keras SeparableConv1D: depthwise (C, 1, k) then pointwise (out, C, 1);
    the depthwise result stays in the conv dtype."""

    def __init__(self, k: int, cin: int, cout: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.depthwise = nn.Parameter(torch.zeros(cin, 1, k))
        self.pointwise = nn.Parameter(torch.zeros(cout, cin, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        y = _sep_conv(x.to(self.dtype), self.depthwise.to(self.dtype),
                      self.pointwise.to(self.dtype))
        return y.float() + self.bias[:, None]


class BatchNorm(nn.Module):
    """Inference BatchNorm in f32: (x - mean) * rsqrt(var + eps) * gamma +
    beta over the channel axis of (B, C, L)."""

    def __init__(self, ch: int):
        super().__init__()
        for part in _BN_PARTS:
            self.register_parameter(part, nn.Parameter(torch.zeros(ch)))

    def inv(self) -> torch.Tensor:
        return torch.rsqrt(self.moving_variance + _BN_EPS)

    def forward(self, x):
        inv = self.inv()
        return ((x - self.moving_mean[:, None]) * inv[:, None]
                * self.gamma[:, None] + self.beta[:, None])


# the inference cache of each model, a replica's copy having its own, and
# the lock its builds take: a detect run's worker threads share one model
_INFERENCE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_INFERENCE_LOCK = threading.Lock()


def _param_key(params: list) -> tuple:
    """Each parameter's address and version counter, on the first one's
    device: an in-place change (an optimizer step, ``load_state_dict``)
    bumps a version, a move or a replaced tensor changes an address."""
    return (params[0].device,
            *((p.data_ptr(), p._version) for p in params))


class _Inference:
    """What the no-grad forward reads in place of the modules: each
    convolution's weights in the conv dtype, each epilogue's table (the
    conv's bias, then its BatchNorm's mean, ``BatchNorm.inv()``, gamma and
    beta; ``trunk_epilogue``'s layout) and the GRU's packed weights.
    ``held`` keeps the parameters' tensors alive so that no address in
    ``key`` can be reused by another tensor while the cache lives."""

    def __init__(self, model: "ReferenceDetectCNN", params: list, key: tuple):
        self.key = key
        self.held = [p.detach() for p in params]
        lay = model.layer
        self.dtype = lay(_PROLOGUE[0]).dtype
        self.gru = model.gru.packed().detach()
        self.weights = {}
        for i in _CONV_SHAPES:
            self.weights[i] = (lay(i).weight.detach().to(self.dtype),)
        for i in _SEP_SHAPES:
            self.weights[i] = (lay(i).depthwise.detach().to(self.dtype),
                               lay(i).pointwise.detach().to(self.dtype))
        bn_of = {_PROLOGUE[0]: _PROLOGUE[1], **dict(_EPILOGUE)}
        for blk in _BLOCKS:
            bn_of.update(zip(blk["seps"], (*blk["bns"], blk["bn_main"])))
            bn_of[blk["shortcut"]] = blk["bn_short"]
        self.tables = {}
        for conv, bn in bn_of.items():
            rows = [lay(conv).bias]
            if bn is not None:
                b = lay(bn)
                rows += [b.moving_mean, b.inv(), b.gamma, b.beta]
            self.tables[conv] = torch.stack([r.detach() for r in rows])

    def conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        w = self.weights[i]
        return _conv(x, *w) if len(w) == 1 else _sep_conv(x, *w)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The module chain's trunk on the lifted (B, 64, L) f32 features:
        each conv result goes through one ``trunk_epilogue``, which leaves
        it in the conv dtype for the next conv (f32 after the last)."""
        t = self.tables
        x = self.conv(_PROLOGUE[0], x.to(self.dtype))
        x = trunk_epilogue(x, t[_PROLOGUE[0]])
        for blk in _BLOCKS:
            y = x
            for s in blk["seps"][:-1]:
                y = trunk_epilogue(self.conv(s, y), t[s])
            last, short = blk["seps"][-1], blk["shortcut"]
            x = trunk_epilogue(self.conv(last, y), t[last],
                               self.conv(short, x), t[short])
        for conv, bn in _EPILOGUE:
            x = trunk_epilogue(self.conv(conv, x), t[conv],
                               out_dtype=None if bn is not None
                               else torch.float32)
        return x


class ReferenceDetectCNN(nn.Module):
    """The reference topology; ``conv_dtype`` torch.float32 gives the f32
    variant (the JAX package's ``DNASCENT_REFCNN_F32``)."""

    def __init__(self, conv_dtype=torch.bfloat16):
        super().__init__()
        self.gru = GRUEncoder()
        layers = {}
        for i, shape in _CONV_SHAPES.items():
            layers[str(i)] = Conv(*shape, conv_dtype)
        for i, shape in _SEP_SHAPES.items():
            layers[str(i)] = SepConv(*shape, conv_dtype)
        for i, ch in _BN_CH.items():
            layers[str(i)] = BatchNorm(ch)
        self.layers = nn.ModuleDict(layers)
        self.head_kernel = nn.Parameter(torch.zeros(TRUNK_CH, N_CLASSES))
        self.head_bias = nn.Parameter(torch.zeros(N_CLASSES))

    def layer(self, i: int) -> nn.Module:
        return self.layers[str(i)]

    def receptive_field(self) -> int:
        """Positions of context per output: 1 + prologue 2 + blocks
        6 * (4 + 4 + 8 + 8 + 16) + epilogue 3 * 2 = 249."""
        rf = 1 + (_CONV_SHAPES[_PROLOGUE[0]][0] - 1)
        for blk in _BLOCKS:
            rf += 6 * (_SEP_SHAPES[blk["seps"][0]][0] - 1)
        for conv, _ in _EPILOGUE:
            rf += _CONV_SHAPES[conv][0] - 1
        return rf

    def inference_cache(self) -> _Inference:
        """This model's ``_Inference``, rebuilt (under a lock) when a
        parameter changed, moved or was replaced since it was built.  The
        parameters are listed from the two levels of modules the model has
        (a fifth of ``self.parameters()``'s host time)."""
        mods = (self, self.gru, *self.layers._modules.values())
        params = [p for m in mods for p in m._parameters.values()]
        key = _param_key(params)
        cache = _INFERENCE.get(self)
        if cache is not None and cache.key == key:
            return cache
        with _INFERENCE_LOCK:
            cache = _INFERENCE.get(self)
            if cache is None or cache.key != key:
                cache = _Inference(self, params, key)
                _INFERENCE[self] = cache
        return cache

    def forward(self, core_idx, residual_idx, signal):
        fused = None if torch.is_grad_enabled() else self.inference_cache()
        B, L, T = signal.shape
        h = self.gru(signal.reshape(B * L, T),
                     None if fused is None else fused.gru)
        feats = torch.cat([h.reshape(B, L, GRU_UNITS),
                           core_idx.float()[..., None],
                           residual_idx.float()[..., None]], dim=-1)
        # parameter-free lift to the trunk's 64 channels (module docstring)
        x = F.pad(feats, (0, TRUNK_CH - feats.shape[-1])).transpose(1, 2)
        x = self._trunk(x) if fused is None else fused.trunk(x)
        logits = x.transpose(1, 2) @ self.head_kernel + self.head_bias
        return torch.softmax(logits, dim=-1)

    def _trunk(self, x):
        """The trunk as the module chain (the route gradients take)."""
        lay = self.layer
        x = torch.relu(lay(_PROLOGUE[1])(lay(_PROLOGUE[0])(x)))
        for blk in _BLOCKS:
            y = x
            for s, b in zip(blk["seps"][:-1], blk["bns"]):
                y = torch.relu(lay(b)(lay(s)(y)))
            y = lay(blk["bn_main"])(lay(blk["seps"][-1])(y))
            s = lay(blk["bn_short"])(lay(blk["shortcut"])(x))
            x = torch.relu(y + s)
        for conv, bn in _EPILOGUE:
            x = lay(conv)(x)
            x = torch.relu(lay(bn)(x) if bn is not None else x)
        return x


def params_from_tensors(model: ReferenceDetectCNN,
                        tensors: dict) -> ReferenceDetectCNN:
    """Load the ``layer<N>/<part>`` / ``trainable<N>`` numpy dict that
    ``cnn_import.load_savedmodel_tensors`` returns, transposing TF layouts:
    conv (k, in, out) -> (out, in, k), depthwise (k, C, 1) -> (C, 1, k),
    pointwise (1, in, out) -> (out, in, 1).  A missing tensor raises
    KeyError, a mis-shaped one ValueError (the JAX loader's messages)."""
    def need(key):
        if key not in tensors:
            raise KeyError(f"SavedModel tensor missing: {key}")
        return torch.tensor(np.asarray(tensors[key], dtype=np.float32))

    def load(dst, key, perm=None):
        src = need(key)
        if perm is not None and src.dim() == len(perm):
            src = src.permute(*perm)
        if src.shape != dst.shape:
            raise ValueError(f"{key} shape {tuple(src.shape)} != "
                             f"{tuple(dst.shape)}")
        dst.copy_(src)

    g = model.gru
    named = {"gru0/kernel": g.kernel0, "gru0/recurrent": g.recurrent0,
             "gru0/bias": g.bias0, "gru1/kernel": g.kernel1,
             "gru1/recurrent": g.recurrent1, "gru1/bias": g.bias1,
             "head/kernel": model.head_kernel, "head/bias": model.head_bias}
    with torch.no_grad():
        for name, n in _TRAINABLE.items():
            load(named[name], f"trainable{n}")
        for i, (k, cin, cout) in _CONV_SHAPES.items():
            shape = tuple(need(f"layer{i}/kernel").shape)
            if shape != (k, cin, cout):
                raise ValueError(f"layer{i} kernel shape {shape} != "
                                 f"{(k, cin, cout)}")
            load(model.layer(i).weight, f"layer{i}/kernel", (2, 1, 0))
            load(model.layer(i).bias, f"layer{i}/bias")
        for i in _SEP_SHAPES:
            mod = model.layer(i)
            load(mod.depthwise, f"layer{i}/depthwise_kernel", (1, 2, 0))
            load(mod.pointwise, f"layer{i}/pointwise_kernel", (2, 1, 0))
            load(mod.bias, f"layer{i}/bias")
        for i, c in _BN_CH.items():
            shape = tuple(need(f"layer{i}/gamma").shape)
            if shape != (c,):
                raise ValueError(f"layer{i} BN channels {shape} != {c}")
            for part in _BN_PARTS:
                load(getattr(model.layer(i), part), f"layer{i}/{part}")
    return model


def params_from_tree(model: ReferenceDetectCNN,
                     flat: dict) -> ReferenceDetectCNN:
    """Load the npz layout ``dnascent_tpu.models.cnn.save_params`` writes
    for ``trainCNN --fit-arch reference`` (``gru0/kernel``,
    ``layer2/kernel``, ``head/bias``, ...)."""
    tensors = {}
    for key, value in flat.items():
        tensors[f"trainable{_TRAINABLE[key]}" if key in _TRAINABLE
                else key] = value
    return params_from_tensors(model, tensors)


def save_params(model: ReferenceDetectCNN, path: str) -> None:
    """Write the weights as the npz the JAX package's ``trainCNN --fit-arch
    reference`` writes, which both packages' ``detect --cnn-weights`` read:
    the layout of ``params_from_tree`` (its inverse), TF layouts restored,
    f32."""
    def arr(t, perm=None):
        t = t.detach().cpu().float()
        return (t.permute(*perm) if perm else t).numpy()

    g = model.gru
    flat = {"gru0/kernel": arr(g.kernel0), "gru0/recurrent": arr(g.recurrent0),
            "gru0/bias": arr(g.bias0), "gru1/kernel": arr(g.kernel1),
            "gru1/recurrent": arr(g.recurrent1), "gru1/bias": arr(g.bias1),
            "head/kernel": arr(model.head_kernel),
            "head/bias": arr(model.head_bias)}
    for i in _CONV_SHAPES:
        flat[f"layer{i}/kernel"] = arr(model.layer(i).weight, (2, 1, 0))
        flat[f"layer{i}/bias"] = arr(model.layer(i).bias)
    for i in _SEP_SHAPES:
        mod = model.layer(i)
        flat[f"layer{i}/depthwise_kernel"] = arr(mod.depthwise, (2, 0, 1))
        flat[f"layer{i}/pointwise_kernel"] = arr(mod.pointwise, (2, 1, 0))
        flat[f"layer{i}/bias"] = arr(mod.bias)
    for i in _BN_CH:
        for part in _BN_PARTS:
            flat[f"layer{i}/{part}"] = arr(getattr(model.layer(i), part))
    np.savez(path, **flat)


def frozen_parameters(model: ReferenceDetectCNN) -> list:
    """The BatchNorm moving statistics: inference-time constants of the
    checkpoint, not weights, so training leaves them out of the optimizer
    (the JAX trainer's ``optax.set_to_zero``, which also spares them the
    weight decay)."""
    return [p for name, p in model.named_parameters()
            if name.rsplit(".", 1)[-1] in ("moving_mean", "moving_variance")]


def load_savedmodel(model_dir: str) -> ReferenceDetectCNN:
    """The model from a reference SavedModel directory with its
    ``variables.data-*`` shards present; the architecture is checked against
    the shipped manifest first."""
    from . import cnn_import
    problems = cnn_import.check_savedmodel_architecture(model_dir)
    if problems:
        raise ValueError("SavedModel does not match the reference detect "
                         "model architecture:\n  " + "\n  ".join(problems))
    return params_from_tensors(ReferenceDetectCNN(),
                               cnn_import.load_savedmodel_tensors(model_dir))


def synthetic_tensors(seed: int = 0) -> dict:
    """A full random tensor dict with the manifest's shapes (a copy of the
    JAX module's numpy generator, so scripts without jax can build the same
    weights; tests hold the two equal)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        scale = 1.0 / np.sqrt(max(1, np.prod(shape[:-1])))
        return rng.normal(0.0, scale, size=shape).astype(np.float32)

    t: dict = {}
    t["trainable0"] = w(1, 48)
    t["trainable1"] = w(GRU_UNITS, 48)
    t["trainable2"] = np.zeros((2, 48), np.float32)
    t["trainable3"] = w(GRU_UNITS, 48)
    t["trainable4"] = w(GRU_UNITS, 48)
    t["trainable5"] = np.zeros((2, 48), np.float32)
    t["trainable190"] = w(TRUNK_CH, N_CLASSES)
    t["trainable191"] = np.zeros(N_CLASSES, np.float32)
    for i, (k, cin, cout) in _CONV_SHAPES.items():
        t[f"layer{i}/kernel"] = w(k, cin, cout)
        t[f"layer{i}/bias"] = np.zeros(cout, np.float32)
    for i, (k, cin, cout) in _SEP_SHAPES.items():
        t[f"layer{i}/depthwise_kernel"] = w(k, cin, 1)
        t[f"layer{i}/pointwise_kernel"] = w(1, cin, cout)
        t[f"layer{i}/bias"] = np.zeros(cout, np.float32)
    for i, c in _BN_CH.items():
        t[f"layer{i}/gamma"] = np.ones(c, np.float32)
        t[f"layer{i}/beta"] = np.zeros(c, np.float32)
        t[f"layer{i}/moving_mean"] = np.zeros(c, np.float32)
        t[f"layer{i}/moving_variance"] = np.ones(c, np.float32)
    return t


def seed_affine(tensors: dict, seed: int) -> dict:
    """A copy of ``tensors`` with every bias (GRU rows, convolutions, head)
    and every BatchNorm gamma, beta, moving mean and moving variance drawn
    from ``seed``.  ``synthetic_tensors`` leaves them at zero and identity,
    as a fresh Keras model does; trained weights never do, so checks of the
    GRU encoder and the trunk run on these."""
    rng = np.random.default_rng(seed)
    out = dict(tensors)

    def normal(key, scale):
        out[key] = rng.normal(0.0, scale, tensors[key].shape).astype(
            np.float32)

    for n in (2, 5):                     # GRU (input, recurrent) bias rows
        normal(f"trainable{n}", 0.5)
    normal("trainable191", 0.5)          # head bias
    for i in (*_CONV_SHAPES, *_SEP_SHAPES):
        normal(f"layer{i}/bias", 0.1)
    for i, c in _BN_CH.items():
        out[f"layer{i}/gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        normal(f"layer{i}/beta", 0.1)
        normal(f"layer{i}/moving_mean", 0.1)
        out[f"layer{i}/moving_variance"] = rng.uniform(0.5, 2.0, c).astype(
            np.float32)
    return out

