"""The operation and byte counters against hand-counted tiny shapes."""

import pytest

from perfbench import counts


def test_banded_fill_counts_live_bands():
    # 3 events + 2 k-mers: 5 bands of 100 cells, 10 operations a cell;
    # bytes: 4 a scaled event and k-mer mean in, 1/4 a cell of trace and a
    # byte a band out
    assert counts.banded_fill(3, 2) == (10 * 500, 4 * 5 + 500 / 4 + 5)


def test_banded_chase_counts_a_byte_each_way_a_move():
    assert counts.banded_chase(3, 2) == (0.0, 10.0)


def test_viterbi_fill_counts_live_cells():
    # 4 observations x 3 states = 12 cells at 26 operations; bytes: 4 an
    # observation, 12 a state in, a code byte a cell and 12 a state out
    assert counts.viterbi_fill(4, 3) == (26 * 12, 16 + 36 + 12 + 36)


def test_viterbi_backtrace_counts_path_steps():
    assert counts.viterbi_backtrace(4, 3) == (0.0, 14.0)


def test_gru_encoder_counts_live_steps():
    # a live step: 48 input weights + three 16 x 48 matrices, 2 FLOPs each
    ops, nbytes = counts.gru_encoder(live_steps=5, positions=2)
    assert ops == 2 * (48 + 3 * 768) * 5
    assert nbytes == 5 + 64 * 2


def test_detect_cnn_flops_by_hand():
    arch = dict(kind="detect_cnn", d_model=4, d_core=2, d_residual=1,
                d_signal=3, raw_depth=1, dilations=[1, 2], kernel=3,
                n_classes=3)
    # signal dense 2*5*3, in dense 2*(3+2+1)*4, per block 2*4*4*3 + 2*4*4,
    # head 2*4*3
    want = 30 + 48 + 2 * (96 + 32) + 24
    assert counts.cnn_flops_per_position({"architecture": arch}) == want


def test_reference_cnn_flops_by_hand():
    arch = dict(kind="reference_cnn", prologue=[3, 2, 2],
                blocks=[[3, 2, 4]], separable_per_block=2,
                epilogue=[[1, 4, 2]], trunk_channels=2, n_classes=3)
    # prologue 2*3*2*2; separable 1: depthwise 2*3*2 + pointwise 2*2*4,
    # separable 2: 2*3*4 + 2*4*4; shortcut 2*3*2*4; epilogue 2*1*4*2;
    # head 2*2*3
    want = 24 + (12 + 16) + (24 + 32) + 48 + 16 + 12
    assert counts.cnn_flops_per_position({"architecture": arch}) == want


def test_roofline_share_takes_the_binding_bound():
    peak = counts.PEAKS["f32_flops"]
    hbm = counts.PEAKS["hbm_bytes"]
    # operations bind: least time ops/peak over a device time twice that
    assert counts.roofline_share(peak, 1.0, peak, 2.0) == pytest.approx(50.0)
    # bytes bind
    assert counts.roofline_share(1.0, hbm, peak, 4.0) == pytest.approx(25.0)
    assert counts.roofline_share(1.0, 1.0, peak, 0.0) is None
    assert counts.roofline_share(0.0, 0.0, peak, 1.0) is None


def test_configured_cnns_cost_what_perf_md_states():
    """About 1.6 MFLOP a position for DetectCNN at its defaults."""
    import json
    import os
    from conftest import ROOT
    with open(os.path.join(ROOT, "perfbench/configs/detectcnn_w128.json")) as fh:
        f = counts.cnn_flops_per_position(json.load(fh))
    assert 1.5e6 < f < 1.7e6
