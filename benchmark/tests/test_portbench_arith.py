"""The yardstick's arithmetic on hand-worked cases."""
from pathlib import Path

import pytest

import harness
from yardstick import PEAK_BF16_FLOPS, PEAK_HBM_BYTES, bound, flash_bound

BENCH = Path(__file__).resolve().parents[1]
MFU = harness.load_module(BENCH / "metrics" / "mfu.serve.py")
ROOF = harness.load_module(BENCH / "metrics" / "attn_roofline.serve.py")


def test_flash_bound_by_hand():
    # (bh, n, d) = (2, 4, 8), not causal: 2 * 16 = 32 pairs, 4 * 8 flops each.
    b = flash_bound("fwd", 2, 4, 8)
    flops, nbytes = 4 * 8 * 32, 4 * 8 * 8 * 2 + 4 * 8
    assert b["bound_ms"] == pytest.approx(max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
                                          * 1e3)
    assert b["bound_by"] == "bytes"
    # causal keeps n (n + 1) / 2 pairs per head: 2 * 10 = 20.
    assert flash_bound("dkv", 2, 4, 8, causal=True)["exp_floor_ms"] == pytest.approx(
        20 / (132 * 16 * 1.83e9) * 1e3)
    assert bound(989e12, 0, PEAK_BF16_FLOPS)["bound_ms"] == pytest.approx(1e3)


def test_percentile_takes_every_sample():
    vals = list(range(1, 101))  # 1..100
    assert harness.percentile(vals, 95) == 95
    assert harness.percentile(vals[::-1], 95) == 95
    assert harness.percentile([5.0], 95) == 5.0
    assert harness.percentile(list(range(1, 201)), 95) == 190
    with pytest.raises(ValueError):
        harness.percentile([], 95)


def test_trace_reduction_by_hand():
    device = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 40.0, 50.0)]
    host = [("outer", -5.0, 60.0), ("aten::mm", 22.0, 30.0), ("cudaLaunchKernel", 35.0, 36.0)]
    r = harness.reduce_trace(device, host)
    assert r["window_s"] == pytest.approx(65e-6) and r["busy_s"] == pytest.approx(30e-6)
    assert r["device_ops"] == [["k1", pytest.approx(20e-6)], ["k2", pytest.approx(15e-6)]]
    gaps = dict((k, v) for k, v in r["idle_gaps"])
    # idle: [-5, 0] and [50, 60] under "outer", [20, 40] mid 30 under aten::mm
    assert gaps["outer"] == pytest.approx(15e-6) and gaps["aten::mm"] == pytest.approx(20e-6)
    assert harness.kernel_seconds(device, ("k2",)) == (pytest.approx(15e-6), 1)


def test_decoder_and_trunk_operations_by_hand():
    dec = [["causal-conv3d", {"in_channels": 2, "out_channels": 4, "kernel_size": 3}],
           ["depth2spacetime_upsample", {"in_channels": 4, "kernel_size": 1, "time_factor": 2,
                                         "space_factor": 2}],
           ["video-residual", {"in_channels": 4, "out_channels": 2, "kernel_size": 1}]]
    h = w = 2
    first = 2 * 27 * 2 * 4 * (h * w)                 # one frame at 2x2
    up = 2 * 1 * 4 * (4 * 8) * (h * w)               # 1x1 conv to 4 * 2 * 4 channels
    res = 2 * (2 * 4 * 4) * (4 * 2 + 2 * 2 + 4 * 2)  # 2 frames at 4x4, k = 1
    assert MFU.decoder_flops(dec, 2, h, w) == first + up + res
    desc = [["space-time_attn", {"n_rep": 2, "n_embd": 4, "n_head": 2, "d_head": 2}]]
    per = 2 * 4 * 12 + 2 * 16 + 4 * 3 * 4 + 2 * 4 * 12 + 2 * 16 + 4 * 5 * 4 + 2 * 16 * 9
    assert MFU.trunk_token_flops(desc, 3, 5, False) == 2 * per


def test_roofline_reader_counts_calls():
    model = {"dynamics": {"desc": [["space-time_attn", {"n_rep": 1, "n_embd": 8, "n_head": 2,
                                                        "d_head": 4}]]}}
    rec = {"model": model, "grid": (2, 2), "batch": 3, "steps_per_frame": 2, "keep": 5,
           "steps": [(0, 1, 2), (1, 0, 5)], "traced": [0, 1],
           "trace": ([("flash_fwd_mma_kernel<64, 4>", 0.0, 1000.0), ("gemm", 0, 50)], [])}
    per_call = flash_bound("fwd", 6, 4, 4)["bound_ms"] / 1e3
    # 3 calls a step, 5 more at the rebase (epoch 1, step 0).
    assert ROOF.read(rec) == pytest.approx(100 * 11 * per_call / 1e-3)
