"""Helpers shared by the metric readers in ``perfbench/metrics/``: each
returns None where the run has nothing to read, and the harness then
leaves the metric out of the line."""

from __future__ import annotations

from . import counts

# the program's StageTimer stage names (pipeline/detect.py)
STAGES = {"prep": "prep(events+scaling+banded)",
          "eventalign": "eventalign(viterbi)", "cnn": "cnn_forward"}
# device operation names of the hand-written kernels (csrc/*.cu) and the
# peak of each kernel's operations
KERNELS = {"A": ("banded_fill_kernel", "f32_flops"),
           "B": ("banded_chase_kernel", "f32_flops"),
           "C": ("viterbi_fill_kernel", "f32_flops"),
           "D": ("viterbi_terminate_backtrace_kernel", "f32_flops"),
           "F": ("gru_encoder_kernel", "tf32_flops")}


def stage_ms_per_kbp(run, stage: str):
    tr = run.trace
    s = tr.stage_s.get(STAGES[stage]) if tr is not None else None
    if not s or tr.kbp <= 0:
        return None
    return 1000.0 * s / tr.kbp


def span_ms(run, name: str, per: str):
    """A span's milliseconds per call (``per="call"``) or per kbp the
    traced call processed (``per="kbp"``)."""
    tr = run.trace
    if tr is None or name not in tr.spans:
        return None
    s, n = tr.spans[name]
    denom = n if per == "call" else tr.kbp
    return 1000.0 * s / denom if denom else None


def kernel_seconds(tr, kernel: str) -> float:
    part = KERNELS[kernel][0]
    return sum(s for name, s in tr.kernel_s.items() if part in name)


def kernel_work(tr, kernel: str) -> tuple:
    """(operations, bytes) of a kernel in the traced window; F's from the
    live GRU steps."""
    if kernel == "F":
        return counts.gru_encoder(tr.gru_steps, tr.positions)
    return tuple(tr.work.get(kernel, (0.0, 0.0)))


def roofline(run, kernel: str):
    tr = run.trace
    if tr is None:
        return None
    ops, nbytes = kernel_work(tr, kernel)
    return counts.roofline_share(ops, nbytes,
                                 counts.PEAKS[KERNELS[kernel][1]],
                                 kernel_seconds(tr, kernel))
