"""BENCHMARK.json against the benchmark's rules, and the files it names."""
import json
import re
from pathlib import Path

import pytest

import harness

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    items = SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]
    for item in items:
        assert NAME.match(item["name"]), item["name"]
        for key in ("why", "layer", "source"):
            if key in item:
                assert 1 <= len(item[key]) <= 200 and "\n" not in item[key] and "\t" not in item[key]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in SPEC[kind]]
        assert len(names) == len(set(names))


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_cells_and_their_files():
    configs = {c["name"]: c for c in SPEC["configs"]}
    used = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        used.add(w["config"])
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "drivers" / f"{traffic['driver']}.py").exists()
        reported = [m for m in SPEC["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])
    assert used == set(configs)
    for c in configs.values():
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and sorted(data["reduced"]) == sorted(c["reduced"])
    on_disk = {p.stem for p in (BENCH / "configs").glob("*.json")}
    assert on_disk == set(configs)
    traffics = {p.stem for p in (BENCH / "traffic").glob("*.json")}
    assert traffics == {w["traffic"] for w in SPEC["workloads"]}


def test_per_layer_metrics_have_readers():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        mod = harness.load_module(BENCH / "metrics" / f"{m['name']}.py")
        assert callable(mod.read) and mod.read({}) is None  # nothing to read: no value
        layers.setdefault(m["layer"], set()).add(m["name"])
    on_disk = {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")}
    assert on_disk == {m["name"] for m in SPEC["per_layer"]}


def _plain(x):
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_is_what_the_port_makes(name):
    """Each configuration file holds what its function in the port returns."""
    import importlib

    data = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    module, func = data["function"].rsplit(".", 1)
    assert _plain(getattr(importlib.import_module(module), func)()) == data["model"]
