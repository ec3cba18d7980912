"""What run.py promises: no card means no result, the result line's keys,
and nothing of JAX or the JAX package loaded by any module the benchmark
runs."""
import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

import harness
import run

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = SPEC["workloads"][0]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELL["name"],
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA device" in proc.stderr


def _fake(trace: bool) -> dict:
    model = json.loads((BENCH / "tests" / "tiny_serve.json").read_text())["model"]
    rec = {"enqueue_s": [0.1, 0.3], "steps": [(0, 0, 1), (0, 1, 2), (0, 2, 3)],
           "latency_s": [0.2, 0.2, 0.2], "traced": [1], "model": model, "grid": (4, 4),
           "batch": 4, "steps_per_frame": 3, "keep": 2,
           "trace": ([("flash_fwd_mma_kernel", 0.0, 2.0)], [("aten::mm", 0.0, 5.0)])
           if trace else None}
    return {"correct": True, "attempted": 64, "failed": 0, "memory_peak_bytes": 123,
            "e2e": {"setup_s": 1.5, "frame_ms.p95": 9.0, "frames_per_s": 3.0,
                    "peak_mem_gib": 1.0},
            "record": rec, "checks": {"a": {"value": 0.1, "limit": 1.0}}}


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_keys(monkeypatch, trace):
    monkeypatch.setattr(harness, "device_record",
                        lambda n: {"platform": "gpu", "kind": "test", "count": n})
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert run.report(SPEC, CELL, _fake(trace), trace) == 0
    line = json.loads(out.getvalue().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    want = {m["name"] for m in run.cell_metrics(SPEC, CELL["name"], trace)}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"} and line["device"]["busy_s"] > 0
        assert line["metrics"]["play.enqueue_ms"]["value"] == pytest.approx(200.0)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == want
    assert err.getvalue().splitlines()[-1] == "check a 0.1 limit 1.0"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "open_genie_tpu",
                                     "open_genie_tpu_torch"}, path


def test_a_run_loads_no_jax():
    """Every module of the benchmark, then a tiny session run, in a fresh
    process: no top-level module named jax, jaxlib, flax or open_genie_tpu
    (whole names: the port's own name begins with the last)."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]
import harness, run, calibrate, weights, yardstick
from pathlib import Path
B = Path({str(BENCH)!r})
for p in list(B.glob('drivers/*.py')) + list(B.glob('metrics/*.py')) + list(B.glob('reference/*.py')):
    harness.load_module(p)
drv = harness.load_module(B / 'drivers' / 'session.py')
cfg = json.loads((B / 'tests' / 'tiny_serve.json').read_text())
tr = json.loads((B / 'tests' / 'tiny_play.json').read_text())
res = drv.run({{'name': 'tiny'}}, cfg, tr, 3, 0.0, False, time.perf_counter(), device='cpu',
              window_steps=6)
print(json.dumps(harness.forbidden_modules()))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    """One short run of the cell on the card (`python -m pytest
    benchmark/tests -m cuda` on a machine with one)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELL["name"],
                           "--seed", str(2**31 + 7), "--seconds", "5", "--trace", "0"],
                          capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.splitlines()[-1])["correct"]
