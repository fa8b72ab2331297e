"""Every cell assembled from its files by name, and BENCHMARK.json held to its rules."""

import json
import math
import os
import re

import pytest

import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_file_keeps_its_rules():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    cells = [w["name"] for w in b["workloads"]]
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    assert {w["config"] for w in b["workloads"]} == set(configs)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        assert os.path.exists(os.path.join(harness.HERE, "metrics", m["name"] + ".py"))
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert any(w["name"] in m.get("workloads", cells) for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_cell_is_assembled_from_its_files(name):
    cell = harness.load_cell(name)
    assert cell.cfg["name"] == cell.name.split(".")[0]
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s", "call_ms_p95",
                                                    "peak_mem_gib", "setup_s"}
    assert set(cell.limits) == set(cell.entry.NAMES)
    assert all(math.isfinite(v) and v > 0 for v in cell.limits.values())
    harness.check_data(cell, ROOT)
    builder = harness.builder(cell.cfg)
    assert callable(builder.make) and callable(builder.shapes)
    for fn in ("build", "reference", "judge_call", "keep", "notes", "faults",
               "control_outputs", "golden"):
        assert callable(getattr(cell.entry, fn))
    for m in cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
