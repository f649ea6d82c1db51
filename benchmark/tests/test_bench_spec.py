"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its file: each configuration, traffic mix, cell's limits and
per-layer reader, whose declarations agree with the spec."""

import json
import re

import pytest

from harness.cells import BENCH_DIR, ROOT, load_reader

from bench_helpers import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
S = spec()


def test_top_level_keys():
    assert set(S) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert S["paths"] == ["benchmark"]
    assert 1 <= S["run_seconds"] <= 51
    assert len(json.dumps(S)) <= 64 * 1024


def test_configs_have_their_files():
    for c in S["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200
        f = ROOT / c["file"]
        assert f == BENCH_DIR / "configs" / f"{c['name']}.json" and f.is_file()
        assert json.loads(f.read_text())["reduced"] == c["reduced"]


def test_cells_have_their_files():
    configs = {c["name"] for c in S["configs"]}
    pairs = set()
    for w in S["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH_DIR / "checks" / f"{w['name']}.json").read_text())
        assert {"vel_gap", "gradp_gap", "diag_gap"} <= set(limits)
    assert {c["name"] for c in S["configs"]} == {w["config"] for w in S["workloads"]}


def test_metrics():
    e2e = {m["name"] for m in S["end_to_end"]}
    assert "setup_s" in e2e
    for m in S["end_to_end"] + S["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in S["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("entry", S["per_layer"], ids=lambda m: m["name"])
def test_reader_declarations_match_the_spec(entry):
    r = load_reader(entry["name"])
    assert r.LAYER == entry["layer"] and r.UNIT == entry["unit"]
    assert r.MOVES == entry["moves"] and entry["moves"] in {m["name"] for m in S["end_to_end"]}
    assert r.WORKLOADS == entry.get("workloads")
    if entry["unit"] == "%" and entry["name"].endswith("_roofline"):
        assert entry["better"] == "higher"


def test_every_cell_reports_a_per_layer_and_two_end_to_end_metrics():
    for w in S["workloads"]:
        layer = [m for m in S["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        e2e = [m for m in S["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer and len(e2e) >= 2
