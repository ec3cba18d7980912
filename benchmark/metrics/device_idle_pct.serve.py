"""device_idle_pct.serve: the share of the profiled part of the window in
which no operation ran on the device (`torch.profiler`). Layer: the
device. Moves `frames_per_s`."""


def read(rec):
    s = rec.get("summary") or {}
    if not s.get("window_s") or not s.get("busy_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
