"""Everything the benchmark finds by name, under a checkout's root: ``BENCHMARK.json``,
``port_bench/configs/<config>.json`` (the file its entry names),
``port_bench/traffic/<mix>.json``, ``port_bench/drivers/<driver>.py`` (the ``driver``
of the mix) and ``port_bench/metrics/<metric>.py``. Nothing here lists a cell, a
configuration, a mix or a metric: a new one is a new file and a new entry."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json resolved to its files."""

    workload: dict
    config: dict
    traffic: dict
    driver: object  # the module drivers/<driver>.py
    end_to_end: list  # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # (BENCHMARK.json entry, reader module) reported with --trace 1


def _applies(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def metric_module(name: str, root: Path = ROOT):
    """The reader of the per-layer metric ``name``: port_bench/metrics/<name>.py."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.m_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, resolved to its files there."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(root / conf["file"])
    traffic = load_json(root / HERE.name / "traffic" / f"{wl['traffic']}.json")
    driver = importlib.import_module(f"port_bench.drivers.{traffic['driver']}")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per = [(m, metric_module(m["name"], root)) for m in bench["per_layer"] if _applies(m, name)]
    return Cell(wl, config, traffic, driver, e2e, per)
