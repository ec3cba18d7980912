"""Metrics logging: JSONL + optional TensorBoard (twin of
`open_genie_tpu.train.metrics`).

Each `log` appends `{"step", "time", **metrics}` to
`<log_dir>/<name>_metrics.jsonl` and prints one `[step N] k=v ...` line;
TensorBoard events go beside it when `torch.utils.tensorboard` imports.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, log_dir: str = "logs", name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_metrics.jsonl")
        self._fh = open(self.path, "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # no tensorboard package: JSONL alone
            self._tb = None
        else:
            self._tb = SummaryWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time(), **metrics}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)
        line = " ".join(
            f"{k}={v:.4g}" for k, v in metrics.items() if isinstance(v, float)
        )
        print(f"[step {step}] {line}", flush=True)

    def close(self) -> None:
        self._fh.close()
        if self._tb is not None:
            self._tb.close()
