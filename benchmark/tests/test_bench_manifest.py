"""BENCHMARK.json against the contract's shape: names, units and sizes, and
a file of its own for every configuration, cell, traffic kind, per-layer
metric, FLOP count and hand kernel."""

import json
import os
import re

import pytest

from benchmark.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16 and all(PATH.match(p) for p in man["paths"])
    assert len(man["command"]) <= 32 and all(_line(w) for w in man["command"])
    assert isinstance(man["run_seconds"], int) and 1 <= man["run_seconds"] <= 51
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16 and 1 <= len(man["per_layer"]) <= 128
    assert len(json.dumps(man)) <= 64 * 1024


def test_names_units_and_lines(man):
    entries = man["configs"] + man["workloads"] + man["end_to_end"] + man["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in man[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for m in man["per_layer"]:
        assert _line(m["layer"])


def test_every_changed_key_is_explained(man):
    """Each key that BENCHMARK.json lists as changed from the source is
    explained in the configuration's file, under `changed` or `reduced`."""
    for c in man["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        told = set(cfg.get("changed", {})) | set(cfg.get("reduced", []))
        assert set(c["reduced"]) <= told, c["name"]


def test_metrics_contract(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        if "mfu" in m["name"] or m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    cells = {w["name"] for w in man["workloads"]}
    for w in cells:  # setup_s, another end-to-end metric and a per-layer metric each
        reported = [m for m in man["end_to_end"] if w in m.get("workloads", [w])]
        assert len(reported) >= 2
        assert any(w in m.get("workloads", []) for m in man["per_layer"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert set(m.get("workloads", [])) <= cells


def test_every_piece_is_a_file_found_by_name(man):
    b = os.path.join(REPO, "benchmark")
    for c in man["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert os.path.exists(os.path.join(b, "flops", c["name"] + ".py"))
    for w in man["workloads"]:
        with open(os.path.join(b, "workloads", w["name"] + ".json")) as f:
            params = json.load(f)
        assert params["config"] == w["config"] and params["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(b, "traffic", w["traffic"] + ".py"))
    for m in man["per_layer"]:
        assert os.path.exists(os.path.join(b, "metrics", m["name"] + ".py"))
    from tpuasr_torch.ops import KERNELS

    for k in KERNELS:
        assert os.path.exists(os.path.join(b, "kernels", k + ".py")), k


def test_budget_fits(man):
    """2 + 14 x cells runs of run_seconds + 60 s, 180 s of compile a cell and
    1,200 s spare fit 43,200 s with the full 24 cells."""
    n = 24
    assert (2 + 14 * n) * (man["run_seconds"] + 60) + n * 180 + 1200 <= 43200
