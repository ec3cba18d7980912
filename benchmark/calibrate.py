"""Read a cell's compared numbers for the program and for its control over
many seeds, in one process, to set the cell's limits (PERF.md keeps the
readings and the limits set from them).

    python3 benchmark/calibrate.py --workload play-b32 --seeds 12 --first 3000000000 \
        --window-steps 70 --control-seeds 4

Each seed runs the cell's driver as a run does, with a window of a fixed
number of steps (long enough to pass a rebase) instead of seconds, and
its check; on the first `--control-seeds` seeds also the control, the
plain reference computed in the precision below the configuration's, put
in the program's place and judged by the same check and verdict. Prints
one JSON line per seed (with the largest readings of each number), then
for each number the largest program reading and the smallest control
reading. Exits 1 if the control ever reads correct. Needs the cell's
CUDA devices; the benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first", type=int, default=3_000_000_000)
    ap.add_argument("--window-steps", type=int, required=True)
    ap.add_argument("--control-seeds", type=int, default=4)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(BENCH))
    import run

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = run._named(spec["workloads"], args.workload, "workload")
    config = json.loads((ROOT / run._named(spec["configs"], cell["config"], "config")["file"])
                        .read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    run.environment()

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print("calibrate.py: needs CUDA devices", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import harness

    driver = harness.load_module(BENCH / "drivers" / f"{traffic['driver']}.py")
    program, control, control_correct = {}, {}, []
    for i, seed in enumerate(range(args.first, args.first + args.seeds)):
        with_control = i < args.control_seeds
        res = driver.run(cell, config, traffic, seed, 0.0, False, time.perf_counter(),
                         window_steps=args.window_steps, control=with_control)
        nums = {k: c["value"] for k, c in res["checks"].items()}
        print(json.dumps({"seed": seed, "program": nums, "correct": res["correct"],
                          "control": res.get("control"),
                          "control_correct": res.get("control_correct"),
                          "tails": res["tails"], "sample": res["sample"],
                          "check_s": res["check_s"], "setup_s": res["e2e"]["setup_s"]}),
              flush=True)
        for k, v in nums.items():
            program[k] = max(program.get(k, 0.0), v)
        if with_control:
            control_correct.append(res["control_correct"])
            for k, v in res["control"].items():
                control[k] = min(control.get(k, float("inf")), v)
    print(json.dumps({"program_max": program, "control_min": control,
                      "control_correct": control_correct}))
    return 1 if any(control_correct) else 0


if __name__ == "__main__":
    sys.exit(main())
