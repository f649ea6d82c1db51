"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names every cell with its
configuration and its traffic. A configuration is ``configs/<config>.json``,
a traffic mix ``traffic/<traffic>.json``, the limits of a cell's output
check ``checks/<cell>.json`` and a per-layer metric's reader
``metrics/<metric>.py``, all under the benchmark's folder. Nothing here
knows a cell, a configuration or a metric by name: adding one is adding its
files and its entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything its files say."""

    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: dict          # checks/<cell>.json
    end_to_end: list      # the end_to_end entries this cell reports
    per_layer: list       # the per_layer entries this cell reports
    bench_dir: Path

    @property
    def program_args(self) -> dict:
        """The case builder's keyword arguments: the configuration's, then
        the traffic's overrides."""
        return {**self.config["args"], **self.traffic.get("args", {})}

    @property
    def problem(self) -> dict:
        """The stated problem that the plain reference solves."""
        return {**self.config["problem"], **self.traffic.get("problem", {})}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of the spec, ``BENCHMARK.json`` beside the
    benchmark's folder."""
    spec = load_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the spec has {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=load_json(bench_dir / "configs" / f"{w['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(bench_dir / "checks" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
        bench_dir=bench_dir,
    )


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``metrics/<name>.py`` (a name may hold dots, so it is
    loaded from its path, not imported by name)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
