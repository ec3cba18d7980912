"""trunk_ms.serve: device milliseconds per step inside the session's
`dynamics.refine` spans (each read-only pass of the trunk and the
vocabulary head) and its `dynamics.commit` span (the pass that appends the
finished frame to the caches), by their CUDA event pairs, mean over the
profiled steps. Layer: the dynamics trunk (`models/dynamics.py::
decode_frame`, the head). Moves `frames_per_s`. Read as
`sampler_ms.serve` reads its spans."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import harness  # noqa: E402

NAMES = ("dynamics.refine", "dynamics.commit")


def read(rec):
    return harness.load_module(Path(__file__).with_name("sampler_ms.serve.py")).step_ms(
        rec, NAMES)
