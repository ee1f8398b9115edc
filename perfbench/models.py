"""A configuration's weights, made on the device from the seed, and the
program's CNN module loaded with them through the program's own loader.

Every tensor is drawn by one ``torch.Generator`` on the run's device in
two calls (one normal, one uniform draw for all tensors together), then
shaped and scaled: kernels LeCun-normal (1/sqrt(fan-in)), embeddings
1/sqrt(width), biases, norms and BatchNorm statistics away from their
identity values so that the check sees every affine term.
"""

from __future__ import annotations

import numpy as np
import torch


def _specs(arch: dict) -> list[tuple]:
    """(key, shape, kind, a, b): kind 'w' = normal / sqrt(fan-in), 'n' =
    normal * a + b, 'u' = uniform on [a, b)."""
    s = []
    if arch["kind"] == "detect_cnn":
        d, ds = arch["d_model"], arch["d_signal"]
        nf = 2 * arch["raw_depth"] + 3
        s += [("params/Dense_0/kernel", (nf, ds), "w", 0, 0),
              ("params/Dense_0/bias", (ds,), "n", 0.1, 0),
              ("params/Embed_0/embedding", (arch["core_vocab"], arch["d_core"]),
               "n", arch["d_core"] ** -0.5, 0),
              ("params/Embed_1/embedding",
               (arch["residual_vocab"], arch["d_residual"]), "n",
               arch["d_residual"] ** -0.5, 0),
              ("params/Dense_1/kernel",
               (ds + arch["d_core"] + arch["d_residual"], d), "w", 0, 0),
              ("params/Dense_1/bias", (d,), "n", 0.1, 0)]
        for i in range(len(arch["dilations"])):
            p = f"params/ConvBlock_{i}"
            s += [(f"{p}/LayerNorm_0/scale", (d,), "n", 0.1, 1.0),
                  (f"{p}/LayerNorm_0/bias", (d,), "n", 0.1, 0),
                  (f"{p}/Conv_0/kernel", (arch["kernel"], d, d), "w", 0, 0),
                  (f"{p}/Conv_0/bias", (d,), "n", 0.1, 0),
                  (f"{p}/Conv_1/kernel", (1, d, d), "w", 0, 0),
                  (f"{p}/Conv_1/bias", (d,), "n", 0.1, 0)]
        s += [("params/LayerNorm_0/scale", (d,), "n", 0.1, 1.0),
              ("params/LayerNorm_0/bias", (d,), "n", 0.1, 0),
              ("params/Dense_2/kernel", (d, arch["n_classes"]), "w", 0, 0),
              ("params/Dense_2/bias", (arch["n_classes"],), "n", 0.5, 0)]
        return s
    if arch["kind"] != "reference_cnn":
        raise ValueError(f"unknown architecture {arch['kind']!r}")
    u, g = arch["gru_units"], 3 * arch["gru_units"]
    s += [("trainable0", (1, g), "w", 0, 0), ("trainable1", (u, g), "w", 0, 0),
          ("trainable2", (2, g), "n", 0.5, 0), ("trainable3", (u, g), "w", 0, 0),
          ("trainable4", (u, g), "w", 0, 0), ("trainable5", (2, g), "n", 0.5, 0),
          ("trainable190", (arch["trunk_channels"], arch["n_classes"]), "w",
           0, 0),
          ("trainable191", (arch["n_classes"],), "n", 0.5, 0)]

    def conv(i, k, cin, cout):
        return [(f"layer{i}/kernel", (k, cin, cout), "w", 0, 0),
                (f"layer{i}/bias", (cout,), "n", 0.1, 0)]

    def sep(i, k, cin, cout):
        return [(f"layer{i}/depthwise_kernel", (k, cin, 1), "w", 0, 0),
                (f"layer{i}/pointwise_kernel", (1, cin, cout), "w", 0, 0),
                (f"layer{i}/bias", (cout,), "n", 0.1, 0)]

    def bn(i, c):
        return [(f"layer{i}/gamma", (c,), "u", 0.5, 1.5),
                (f"layer{i}/beta", (c,), "n", 0.1, 0),
                (f"layer{i}/moving_mean", (c,), "n", 0.1, 0),
                (f"layer{i}/moving_variance", (c,), "u", 0.5, 2.0)]

    k, cin, cout = arch["prologue"]
    s += conv(2, k, cin, cout) + bn(3, cout)
    n_sep = arch["separable_per_block"]
    for b, (k, cin, cout) in enumerate(arch["blocks"]):
        st = 4 + 14 * b
        for j in range(n_sep):
            s += sep(st + 2 * j, k, cin if j == 0 else cout, cout)
            if j < n_sep - 1:
                s += bn(st + 2 * j + 1, cout)
        s += conv(st + 2 * n_sep - 1, k, cin, cout)
        s += bn(st + 2 * n_sep, cout) + bn(st + 2 * n_sep + 1, cout)
    for (k, cin, cout), (c, b) in zip(arch["epilogue"],
                                      ((74, 75), (76, 77), (78, None))):
        s += conv(c, k, cin, cout) + (bn(b, cout) if b else [])
    return s


def make_tensors(config: dict, seed: int, device) -> dict:
    """{key: f32 tensor on ``device``} for the configuration's CNN."""
    specs = _specs(config["architecture"])
    sizes = [int(np.prod(shape)) for _, shape, _, _, _ in specs]
    g = torch.Generator(device=device).manual_seed(
        int(seed) % (1 << 63) ^ int(config["weights"]["seed_mix"]))
    normal = torch.randn(sum(sizes), generator=g, device=device)
    uniform = torch.rand(sum(sizes), generator=g, device=device)
    out, o = {}, 0
    for (key, shape, kind, a, b), n in zip(specs, sizes):
        if kind == "w":
            fan_in = int(np.prod(shape[:-1])) or 1
            v = normal[o : o + n] / np.sqrt(fan_in)
        elif kind == "n":
            v = normal[o : o + n] * a + b
        else:
            v = uniform[o : o + n] * (b - a) + a
        out[key] = v.reshape(shape).contiguous()
        o += n
    return out


def program_model(config: dict, tensors: dict, device):
    """The program's CNN module, loaded through its own loader."""
    arch = config["architecture"]
    host = {k: v.detach().cpu().numpy() for k, v in tensors.items()}
    if arch["kind"] == "detect_cnn":
        from dnascent_tpu_torch.models import cnn
        model = cnn.params_from_flax(
            cnn.DetectCNN(d_model=arch["d_model"], d_core=arch["d_core"],
                          d_residual=arch["d_residual"],
                          d_signal=arch["d_signal"],
                          dilations=tuple(arch["dilations"]),
                          kernel=arch["kernel"]), host)
    else:
        from dnascent_tpu_torch.models import reference_cnn
        model = reference_cnn.params_from_tensors(
            reference_cnn.ReferenceDetectCNN(), host)
    return model.to(device).eval()
