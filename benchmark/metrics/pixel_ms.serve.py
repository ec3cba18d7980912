"""pixel_ms.serve: device milliseconds per step inside the session's
`tokenizer.decode_stream` span (the streaming decoder on the new token
frame), by its CUDA event pair, mean over the profiled steps. Layer: the
pixel decoder (`models/tokenizer.py::decode_stream`). Moves
`frames_per_s`. Read as `sampler_ms.serve` reads its spans."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import harness  # noqa: E402

NAMES = ("tokenizer.decode_stream",)


def read(rec):
    return harness.load_module(Path(__file__).with_name("sampler_ms.serve.py")).step_ms(
        rec, NAMES)
