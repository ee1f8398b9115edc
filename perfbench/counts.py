"""The yardstick's arithmetic: the H100's published peaks, and the
operations and bytes that the window's reads need from each hand-written
kernel (A-D, F) and from each CNN topology.

Work is counted from the live shapes of the reads (events, k-mers,
window observations and states, live GRU steps), never from padded launch
shapes, so it is the same whatever implements it.  Each input byte is
counted read once and each output byte written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAKS = {
    "bf16_flops": 989e12,
    "tf32_flops": 495e12,
    "f32_flops": 67e12,
    "hbm_bytes": 3.35e12,
}
BANDWIDTH = 100           # banded DP cells a band
BAND_CELL_OPS = 10        # kernel A: emission, three candidates, two maxima
VITERBI_CELL_OPS = 26     # kernel C: three states' candidates and maxima
GRU_UNITS, GRU_GATES = 16, 48


def banded_fill(n_events: int, n_kmers: int) -> tuple[float, float]:
    """Kernel A for one read: (operations, bytes).  Live cells: one band of
    BANDWIDTH cells for each event and k-mer; reads the f32 scaled events
    and k-mer means, writes 2 bits of trace a cell and a byte a band for
    the band's move."""
    bands = n_events + n_kmers
    cells = bands * BANDWIDTH
    return (float(BAND_CELL_OPS * cells),
            float(4 * (n_events + n_kmers) + cells / 4 + bands))


def banded_chase(n_events: int, n_kmers: int) -> tuple[float, float]:
    """Kernel B for one read: (0, bytes).  The path back through the bands
    takes at most one move a band: a trace byte read and a move byte
    written a step."""
    return 0.0, float(2 * (n_events + n_kmers))


def viterbi_fill(n_obs: int, n_states: int) -> tuple[float, float]:
    """Kernel C for one window: (operations, bytes).  Live cells are
    observations x states; reads the observations (f32) and three f32
    coefficients a state, writes a code byte a cell and three f32 final
    scores a state."""
    cells = n_obs * n_states
    return (float(VITERBI_CELL_OPS * cells),
            float(4 * n_obs + 12 * n_states + cells + 12 * n_states))


def viterbi_backtrace(n_obs: int, n_states: int) -> tuple[float, float]:
    """Kernel D for one window: (0, bytes).  The path has at most n_obs +
    n_states steps: a code byte read and a path byte written a step."""
    return 0.0, float(2 * (n_obs + n_states))


def gru_encoder(live_steps: int, positions: int) -> tuple[float, float]:
    """Kernel F: (operations, bytes).  A live step multiplies the input
    row (1 x 48) and three 16 x 48 matrices (U0, W1, U1); reads a u8 code
    a step, writes 16 f32 a position."""
    macs = GRU_GATES * (1 + 3 * GRU_UNITS)
    return float(2 * macs * live_steps), float(live_steps + 64 * positions)


def cnn_flops_per_position(config: dict) -> float:
    """Multiply-add FLOPs of one position through the configuration's CNN
    (convolutions and dense layers; norms and activations left out)."""
    arch = config["architecture"]
    if arch["kind"] == "detect_cnn":
        d = arch["d_model"]
        n_feats = 2 * arch["raw_depth"] + 3
        f = 2 * n_feats * arch["d_signal"]
        f += 2 * (arch["d_signal"] + arch["d_core"] + arch["d_residual"]) * d
        f += len(arch["dilations"]) * (2 * d * d * arch["kernel"]
                                       + 2 * d * d)
        return float(f + 2 * d * arch["n_classes"])
    if arch["kind"] == "reference_cnn":
        k, cin, cout = arch["prologue"]
        f = 2 * k * cin * cout
        for k, cin, cout in arch["blocks"]:
            c = cin
            for _ in range(arch["separable_per_block"]):
                f += 2 * k * c + 2 * c * cout
                c = cout
            f += 2 * k * cin * cout          # shortcut conv
        for k, cin, cout in arch["epilogue"]:
            f += 2 * k * cin * cout
        return float(f + 2 * arch["trunk_channels"] * arch["n_classes"])
    raise ValueError(f"unknown architecture {arch['kind']!r}")


def roofline_share(ops: float, nbytes: float, peak_flops: float,
                   device_s: float):
    """Per cent of the roofline: the least time the chip could take (the
    larger of operations at ``peak_flops`` and bytes at the HBM peak) over
    the measured device seconds; None without device time or work."""
    if device_s <= 0.0 or (ops <= 0.0 and nbytes <= 0.0):
        return None
    least = max(ops / peak_flops, nbytes / PEAKS["hbm_bytes"])
    return 100.0 * least / device_s
