"""BENCHMARK.json against the contract's rules, and every name in it
resolved to the file that the harness finds by that name."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1].startswith("benchmark/")
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for e in SPEC[group]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("unit",):
            if key in e:
                assert UNIT.match(e[key]), e[key]
        for key in ("why", "layer", "source"):
            if key in e and group in ("configs", "workloads", "per_layer"):
                assert LINE.match(e[key]), e[key]
        if "better" in e:
            assert e["better"] in ("lower", "higher")


def test_configs_resolve_and_are_used():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        conf = json.load(open(os.path.join(ROOT, c["file"])))
        assert set(c["reduced"]) == set(conf["reduced"])
        assert os.path.exists(os.path.join(BENCH, "pipelines", conf["method"] + ".py"))
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads_resolve():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(BENCH, "limits", w["name"] + ".json"))


def test_metrics_resolve_and_move_a_reported_metric():
    e2e = {e["name"]: e for e in SPEC["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for e in SPEC["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0 < e["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", [])) <= cells
    for w in cells:
        assert any(w in m.get("workloads", [w]) for m in SPEC["per_layer"])
