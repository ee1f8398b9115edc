"""The whole pass's share of the chip's peak: the traced window's counted
work (CNN FLOPs at the bf16 peak, kernel F's at TF32, kernels A and C at
f32) as time at peak, over the traced window's wall; nothing without a
device trace."""

from perfbench import counts
from perfbench.readers import kernel_work


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0 or tr.positions == 0:
        return None
    p = counts.PEAKS
    t = tr.positions * tr.cnn_flops_per_position / p["bf16_flops"]
    if run.cell.config["architecture"]["kind"] == "reference_cnn":
        t += kernel_work(tr, "F")[0] / p["tf32_flops"]
    t += (kernel_work(tr, "A")[0] + kernel_work(tr, "C")[0]) / p["f32_flops"]
    return 100.0 * t / tr.window_s
