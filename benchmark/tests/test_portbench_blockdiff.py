"""The block-diffusion driver end to end on the CPU at the port's compact
SDAR configuration (`sdar_compact_config()`: 2 layers 64 wide, 8 experts
at top 2): the program agrees with the plain reference, the float8
control does not, and a broken timed path reads `correct` false; the
cell's per-layer readers, the per-parameter weights and the experts'
yardstick."""
import json
import time
from pathlib import Path

import pytest
import torch

import harness

BENCH = Path(__file__).resolve().parents[1]
DRIVER = harness.load_module(BENCH / "drivers" / "blockdiff.py")
TRAFFIC = json.loads((BENCH / "traffic" / "sdar-b64-p1k-g256.json").read_text())
LIMITS = TRAFFIC["check"]["limits"]


def _run(dtype="float32", control=False, steps=12, trace=False, seed=2**33 + 7):
    from open_genie_tpu_torch.models import configs

    config = {"name": "tiny", "dtype": dtype,
              "model": json.loads(json.dumps(configs.sdar_compact_config()))}
    traffic = json.loads(json.dumps(TRAFFIC))
    traffic.update(rows=6, prompt_tokens=16, blocks=5, prefill_chunk=8, warmup_steps=2,
                   trace_steps=[6, 2])
    traffic["check"].update(rows=3, judged=2, within=5)
    return DRIVER.run({"name": "tiny"}, config, traffic, seed, 0.0, trace, time.perf_counter(),
                      device="cpu", window_steps=steps, control=control)


def test_program_matches_reference_and_control_does_not():
    res = _run(control=True)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 6 * 12
    assert res["checks"]["logit_rel_err"]["value"] < 1e-5
    assert res["checks"]["logit_far_pct"]["value"] == 0.0
    assert res["checks"]["commit_miss_pct"]["value"] == 0.0
    # the float8 control, in the program's place, fails a limit of the cell
    assert not res["control_correct"], res["control"]
    # the bf16 witness reads between the f32 program and the control
    assert (res["checks"]["logit_rel_err"]["value"] < res["witness"]["logit_rel_err"]
            < res["control"]["logit_rel_err"]), (res["witness"], res["control"])
    assert any(res["control"][k] > LIMITS[k] for k in LIMITS), res["control"]
    # a batch change (a prefill inside the window) is among the judged steps
    assert [5 // 5, 0] in [list(s) for s in res["sample"]["steps"]]
    assert res["sample"]["commits"] >= 2 * 3 * 4


def test_bf16_program_within_limits():
    res = _run(dtype="bfloat16")
    assert res["correct"], res["checks"]


def test_broken_timed_path_is_caught(monkeypatch):
    """Experts that add half what they should are caught by the logits."""
    from open_genie_tpu_torch.modules.moe import SparseMoE

    orig = SparseMoE.forward
    monkeypatch.setattr(SparseMoE, "forward", lambda self, x: 0.5 * orig(self, x))
    res = _run()
    assert not res["correct"]
    assert res["checks"]["logit_rel_err"]["value"] > LIMITS["logit_rel_err"], res["checks"]


def test_traced_run_records_spans_and_load():
    res = _run(trace=True, steps=10)
    rec = res["record"]
    assert rec["traced"] == [6, 7] and rec["trace"] is not None
    names = [s["name"] for s in rec["spans"]]
    # window steps 6 and 7: blocks 4 of batch 1 and 0 of batch 2, whose
    # prefill (2 chunks of 2 layers) runs inside the profiled part
    assert names.count("session.step") == 2 and names.count("session.prefill") == 1
    assert names.count("moe.experts") == 2 * 5 * 2 + 2 * 2
    assert len(rec["expert_load"]) == 2 * 5 * 2 + 2 * 2
    assert sorted({p["slots"] for p in rec["expert_load"]}) == [6 * 4 * 2, 6 * 8 * 2]
    rec["summary"] = harness.reduce_trace(*rec["trace"])
    mfu = harness.load_module(BENCH / "metrics" / "mfu.bd.py").read(rec)
    assert mfu is not None and mfu > 0
    # CPU spans carry no device time; the CPU trace has no K8 kernel
    for name in ("moe_ms.bd", "attn_ms.bd", "moe_roofline.bd"):
        assert harness.load_module(BENCH / "metrics" / f"{name}.py").read(rec) is None


def test_span_readers_on_a_record():
    """`attn_ms.bd` and `moe_ms.bd` read device ms a profiled step of the
    kernels their names tell apart (kernels inside CUDA graphs included),
    and nothing from a trace without them."""
    device = [("void (anonymous namespace)::block_attention_kernel<128, 2>(...)", 0.0, 500.0),
              ("void (anonymous namespace)::moe_gate_up_kernel<32>(...)", 0.0, 3000.0),
              ("void (anonymous namespace)::moe_down_kernel<32>(...)", 0.0, 1000.0),
              ("void at::native::radixSortKVInPlace<-2, -1, 64, 32, long, long>(...)", 0.0, 200.0),
              ("void at::native::searchsorted_cuda_kernel<long>(...)", 0.0, 100.0),
              ("ampere_bf16_s16816gemm_bf16_128x64", 0.0, 9000.0)]
    rec = {"traced": [16, 17], "trace": (device, [])}
    read = lambda name: harness.load_module(BENCH / "metrics" / f"{name}.py").read  # noqa: E731
    assert read("attn_ms.bd")(rec) == pytest.approx(0.25)
    assert read("moe_ms.bd")(rec) == pytest.approx(2.15)
    rec["trace"] = (device[-1:], [])
    assert read("attn_ms.bd")(rec) is None and read("moe_ms.bd")(rec) is None


def test_moe_roofline_reader_on_a_record():
    from moe_yardstick import experts_bound
    from open_genie_tpu_torch.models.configs import sdar_30b_a3b_config

    model = json.loads(json.dumps(sdar_30b_a3b_config()))
    load = [{"slots": 2048, "hit": 128}, {"slots": 2048, "hit": 120}]
    bound = experts_bound(2048, 128, 2048, 768, 8)
    assert bound["bound_by"] == "bytes"
    # 128 experts' weights: 1.21 GB, about 0.36 ms at 3.35 TB/s
    assert bound["bound_ms"] == pytest.approx(0.37, rel=0.05)
    total = bound["bound_ms"] + experts_bound(2048, 120, 2048, 768, 8)["bound_ms"]
    rec = {"model": model, "expert_load": load,
           "trace": ([("moe_gate_up_kernel<32>", 0.0, 500.0),
                      ("moe_down_kernel<32>", 600.0, 1000.0), ("other", 0.0, 5000.0)], [])}
    got = harness.load_module(BENCH / "metrics" / "moe_roofline.bd.py").read(rec)
    assert got == pytest.approx(100.0 * total / 0.9)


def test_seeded_weights_draw_each_parameter_alone():
    import seeded_weights

    spec = ((3, 5), ("normal", 0.5))
    a = seeded_weights.draw("layers.0.x", spec, 2**40 + 3, "cpu", torch.bfloat16)
    assert torch.equal(a, seeded_weights.draw("layers.0.x", spec, 2**40 + 3, "cpu",
                                              torch.bfloat16))
    assert not torch.equal(a, seeded_weights.draw("layers.1.x", spec, 2**40 + 3, "cpu",
                                                  torch.bfloat16))
    assert a.dtype == torch.bfloat16 and a.float().std() > 0.2
    one = seeded_weights.draw("n", ((4,), ("const", 1.0)), 1, "cpu", torch.float32)
    assert torch.equal(one, torch.ones(4))
    with pytest.raises(KeyError, match="do not fit"):
        seeded_weights.fill(torch.nn.Linear(2, 2), {"weight": ((2, 2), ("normal", 1.0))}, 0)
