"""sampler_ms.serve: device milliseconds per step inside the session's
`maskgit.sample` spans (the Gumbel draw and `maskgit_commit`), each timed
by its CUDA event pair, mean over the profiled steps. Layer: the sampler
(`models/dynamics.py::maskgit_commit`, `gumbel_noise`). Moves
`frames_per_s`.

The spans are the program's (`utils/debug.py::span`, read through
`span_record`): the last roots recorded are the profiled steps. Only the
direct children of `session.step` count, so a rebase's prefill is not
counted twice. A program without spans gives no value."""

NAMES = ("maskgit.sample",)


def step_ms(rec, names):
    """Mean over the profiled steps of the event-timed device ms of the
    `session.step` children named in `names`; None where the program
    recorded no such spans or no device times."""
    n = len(rec.get("traced") or ())
    if not n:
        return None
    try:
        from open_genie_tpu_torch.utils.debug import span_record
    except ImportError:
        return None
    spans = span_record(n)
    roots = {s["id"] for s in spans if s["parent"] is None and s["name"] == "session.step"}
    ms = [s["device_ms"] for s in spans if s["parent"] in roots and s["name"] in names]
    if not ms or None in ms:
        return None
    return sum(ms) / len(roots)


def read(rec):
    return step_ms(rec, NAMES)
