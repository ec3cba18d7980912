"""play.enqueue_ms: the host's time to enqueue one step of every player,
from the call of `InteractiveSession.step_nosync` to its return (before
the copy of the frames to the host waits for the device), by the
benchmark's clock, averaged over the window's steps outside the profiled
part. Layer: the session entry (`serve.py`). Moves `frame_ms.p95`."""


def read(rec):
    enq = rec.get("enqueue_s")
    return 1e3 * sum(enq) / len(enq) if enq else None
