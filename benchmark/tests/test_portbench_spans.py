"""The five readers of the program's spans on a synthetic record: a fake
span record (`utils/debug.py::span_record`) and fake device and host rows
of a trace, with answers worked by hand."""
from pathlib import Path

import pytest

import harness
from open_genie_tpu_torch.utils import debug

BENCH = Path(__file__).resolve().parents[1]
READERS = {name: harness.load_module(BENCH / "metrics" / f"{name}.py")
           for name in ("sampler_ms.serve", "trunk_ms.serve", "pixel_ms.serve",
                        "trunk_idle_ms.serve", "trunk_launches.serve")}


def _span(sid, name, parent, step, ms):
    return {"id": sid, "name": name, "parent": parent, "step": step, "device_ms": ms}


# Two profiled steps. The second rebases: its prefill's decode sits inside
# `session.rebase` and is not the step's own.
SPANS = [
    _span(0, "session.step", None, 0, 40.0),
    _span(1, "dynamics.refine", 0, 0, 3.0), _span(2, "maskgit.sample", 0, 0, 10.0),
    _span(3, "dynamics.refine", 0, 0, 3.0), _span(4, "maskgit.sample", 0, 0, 12.0),
    _span(5, "dynamics.commit", 0, 0, 4.0), _span(6, "tokenizer.decode_stream", 0, 0, 2.0),
    _span(7, "session.to_host", 0, 0, 0.5),
    _span(10, "session.step", None, 10, 140.0),
    _span(11, "session.rebase", 10, 10, 100.0),
    _span(12, "tokenizer.decode_stream", 11, 10, 7.0),
    _span(13, "dynamics.refine", 10, 10, 5.0), _span(14, "maskgit.sample", 10, 10, 14.0),
    _span(15, "dynamics.commit", 10, 10, 6.0), _span(16, "tokenizer.decode_stream", 10, 10, 3.0),
    _span(17, "session.to_host", 10, 10, 0.5),
]
# Microseconds. Idle: [15, 25] (midpoint in the refine), [40, 55] (in the
# sample), [57, 59] (in the commit), [90, 100] (after the spans): 12 us in
# the trunk's spans. Launches: at 12, 20 and 55 in them, at 35 outside.
DEVICE = [("k", 0.0, 15.0), ("k", 25.0, 40.0), ("k", 55.0, 57.0), ("k", 59.0, 90.0)]
HOST = [("session.step", 0.0, 100.0), ("dynamics.refine", 10.0, 30.0),
        ("cudaLaunchKernel", 12.0, 13.0), ("cuLaunchKernelEx", 20.0, 21.0),
        ("maskgit.sample", 30.0, 50.0), ("cudaLaunchKernel", 35.0, 36.0),
        ("dynamics.commit", 50.0, 60.0), ("aten::mm", 52.0, 58.0),
        ("cudaLaunchKernelExC", 55.0, 56.0), ("cudaMemcpyAsync", 56.0, 57.0)]
REC = {"traced": [5, 6], "trace": (DEVICE, HOST)}


@pytest.fixture
def record(monkeypatch):
    def fake(last=None):
        assert last == 2
        return list(SPANS)

    monkeypatch.setattr(debug, "span_record", fake)


def test_readers_by_hand(record):
    got = {name: mod.read(REC) for name, mod in READERS.items()}
    assert got == {
        "sampler_ms.serve": pytest.approx((10 + 12 + 14) / 2),
        "trunk_ms.serve": pytest.approx((3 + 3 + 4 + 5 + 6) / 2),
        "pixel_ms.serve": pytest.approx((2 + 3) / 2),
        "trunk_idle_ms.serve": pytest.approx(12e-3 / 2),
        "trunk_launches.serve": pytest.approx(3 / 2),
    }


@pytest.mark.parametrize("name", sorted(READERS))
def test_nothing_to_read_gives_no_value(monkeypatch, name):
    """`{}`; a program without spans (no reader function, no span rows in
    its trace); a CPU run (no device rows, no event times)."""
    read = READERS[name].read
    assert read({}) is None
    monkeypatch.delattr(debug, "span_record")
    parent = dict(REC, trace=(DEVICE, [r for r in HOST if "." not in r[0]]))
    assert read(parent) is None
    cpu_spans = [dict(s, device_ms=None) for s in SPANS]
    monkeypatch.setattr(debug, "span_record", lambda last=None: cpu_spans, raising=False)
    assert read(dict(REC, trace=([], HOST))) is None
