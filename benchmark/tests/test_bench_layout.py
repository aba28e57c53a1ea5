"""``BENCHMARK.json`` against the benchmark's contract, and every name in
it found as a file of the benchmark."""

import json
import os
import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_limits():
    b = _bench()
    assert list(b) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert 1 <= b["run_seconds"] <= 51
    cells = len(b["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(b["configs"]) <= 24
    # a full check at 24 cells fits in its 43,200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


def test_names_units_and_files():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        spec = harness.cell_spec(b, w["name"])  # config, mix, limits
        harness.entry_module(spec["mix"]["entry"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert callable(harness.metric_reader(m["name"]))
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    b = _bench()
    for w in b["workloads"]:
        n = w["name"]
        e2e = [m for m in b["end_to_end"] if n in m.get("workloads", [n])]
        layer = [m for m in b["per_layer"] if n in m.get("workloads", [n])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in {x["name"] for x in e2e}
