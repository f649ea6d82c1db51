"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric by adding files and entries alone: in a copy of the
benchmark's folder, new files are dropped in and the spec gains entries,
no file that was there is edited, and the harness runs the new cell and
reads the new metric."""

import json
import shutil

from harness.cells import BENCH_DIR, load_cell, load_reader

from bench_helpers import run_tiny, spec


def test_new_cell_config_traffic_and_metric_are_files(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    cfg = json.loads((bench / "configs" / "cavity_re1000_1024.json").read_text())
    cfg["name"] = "cavity_re400_1024"
    cfg["args"]["Re"] = 400.0
    cfg["problem"]["nu"] = 1.0 / 400.0
    (bench / "configs" / "cavity_re400_1024.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "chunks50.json").read_text())
    traffic["runner"]["log_every_chunks"] = 5
    (bench / "traffic" / "chunks50_log5.json").write_text(json.dumps(traffic))
    (bench / "checks" / "cavity1024.re400.json").write_text(
        (bench / "checks" / "cavity1024.dct.json").read_text())
    (bench / "metrics" / "chunks_traced.py").write_text(
        'LAYER = "runner"\nUNIT = "chunks"\nMOVES = "cell_updates_per_s"\n'
        'WORKLOADS = ["cavity1024.re400"]\n\n\ndef read(record):\n    return record.chunks\n')

    s = spec()
    s["configs"].append({"name": "cavity_re400_1024", "source": "Ghia, Ghia & Shin (1982)",
                         "file": "benchmark/configs/cavity_re400_1024.json", "reduced": [],
                         "why": "a test's configuration"})
    s["workloads"].append({"name": "cavity1024.re400", "config": "cavity_re400_1024",
                           "traffic": "chunks50_log5", "chips": 1, "why": "a test's cell"})
    s["per_layer"].append({"name": "chunks_traced", "unit": "chunks", "better": "higher",
                           "source": "program_span", "layer": "runner",
                           "moves": "cell_updates_per_s", "workloads": ["cavity1024.re400"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))

    after = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file() and p in before}
    assert after == before  # nothing that was there changed

    cell = load_cell("cavity1024.re400", bench)
    assert cell.problem["nu"] == 1.0 / 400.0
    assert [m["name"] for m in cell.per_layer][-1] == "chunks_traced"
    assert load_reader("chunks_traced", bench).UNIT == "chunks"
    r = run_tiny("cavity1024.re400", seed=3, bench_dir=bench, seconds=0.6, trace=True)
    assert r["correct"] is True
    assert r["metrics"]["chunks_traced"]["value"] >= 1
