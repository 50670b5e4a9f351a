"""The harness on the CPU: every cell resolves to its files, ``BENCHMARK.json`` keeps
the contract's names and shapes, a new mix is a data file alone, the generators are
fixed by the seed, the roofline counts hold at known shapes, and nothing the
benchmark runs loads JAX or the JAX package."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import guard, harness
from port_bench.generate import FleetEpisodes, trot_stream
from port_bench.reference.frozen.config import make_config
from port_bench.roofline.k1f import random_sampling_work
from port_bench.roofline.peaks import least_seconds

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.resolve(name)
    assert cell.traffic["driver"] in ("fleet", "solve_stream")
    assert callable(cell.driver.run)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    reported = {m["name"] for m in cell.end_to_end}
    for entry, mod in cell.per_layer:
        assert (mod.NAME, mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
            entry["name"], entry["unit"], entry["layer"], entry["moves"], entry["source"])
        assert entry["moves"] in reported
    assert set(cell.traffic["limits"]) and all(v > 0 for v in cell.traffic["limits"].values())


def test_benchmark_keeps_the_contracts_names_and_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"]) == len(set(CELLS))
    assert names == {w["config"] for w in BENCH["workloads"]}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_a_new_mix_is_a_data_file_alone(tmp_path):
    """A copy of the checkout's benchmark files with one more mix and one more cell:
    the harness finds the mix, its configuration, its driver and its metrics."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(harness.HERE / sub, tmp_path / "port_bench" / sub)
    mix = json.loads((harness.HERE / "traffic" / "fleet_perlin_s64.json").read_text())
    mix.update(scenarios=128, what="128 perlin scenarios")
    (tmp_path / "port_bench" / "traffic" / "fleet_perlin_s128.json").write_text(json.dumps(mix))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "fleet_perlin_s128", "config": "aliengo_sampling_rs",
                               "traffic": "fleet_perlin_s128", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "fleet_perlin_s64" in m.get("workloads", ()):
            m["workloads"].append("fleet_perlin_s128")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve("fleet_perlin_s128", root=tmp_path)
    assert cell.traffic["scenarios"] == 128 and cell.driver.__name__ == "port_bench.drivers.fleet"
    assert cell.config["make_config"]["mpc_type"] == "sampling"
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "fleet_steps_per_s"}
    assert {e["name"] for e, _ in cell.per_layer} == {
        m["name"] for m in BENCH["per_layer"] if "fleet_perlin_s64" in m["workloads"]}


def test_fleet_episodes_are_fixed_by_the_seed():
    cell = harness.resolve("fleet_perlin_s64")
    traffic = dict(cell.traffic, scenarios=4)
    seed = 2 ** 31 + 12345

    def draws(s):
        ep = FleetEpisodes(cell.config["make_config"], traffic, s, "cpu")
        return [ep.draw() for _ in range(2)]

    a, b, c = draws(seed), draws(seed), draws(seed + 1)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert not torch.equal(a[0]["terrain"], c[0]["terrain"])
    assert not torch.equal(a[0]["terrain"], a[1]["terrain"])
    h = a[0]["terrain"]
    assert h.shape == (4, 64, 64) and float(h.min()) >= 0.0
    assert float(h.max()) <= cell.traffic["terrain"]["height_m"] + 1e-6


def test_trot_stream_is_fixed_by_the_seed():
    cell = harness.resolve("nominal_trot_stream")
    mc, tr = cell.config["make_config"], cell.traffic
    seed = 2 ** 31 + 54321

    def calls(s):
        it = trot_stream(mc, tr, s)
        return [next(it) for _ in range(5)]

    a, b, c = calls(seed), calls(seed), calls(seed + 1)
    for (s1, r1, q1), (s2, r2, q2) in zip(a, b):
        assert all(np.array_equal(s1[k], s2[k]) for k in s1)
        assert all(np.array_equal(r1[k], r2[k]) for k in r1)
        assert np.array_equal(q1, q2)
    assert not np.array_equal(a[0][0]["position"], c[0][0]["position"])
    # The contact sequence follows the trot's timing alone, whatever the seed.
    assert all(np.array_equal(x[2], y[2]) for x, y in zip(a, c))
    assert a[0][2].shape == (4, make_config(**mc).mpc.horizon)


def test_k1f_roofline_counts_at_known_shapes():
    cfg = make_config(robot="aliengo", mpc_type="sampling")
    # Cubic splines, H 12, two splines a leg: 504 basis nonzeros, P = 96. N = 3:
    # bands [1, 2) and [2, 3) normal, none uniform.
    flops, nbytes = random_sampling_work(cfg, 1, 3)
    assert flops == 3 * (2 * 504 + 250 * 12 + 1) + 96 * (30 * 2)
    assert nbytes == 4 * 504 + 4 * (36 + 8 * 12 + 96 + 3 + 26 + 96) + 16
    f2, b2 = random_sampling_work(cfg, 2, 3)
    assert f2 == 2 * flops and b2 == 2 * nbytes - 4 * 504
    # The fleet cells: operation-bound, 0.46 ms at 512 x 10 000 on the data sheet's peaks.
    t, bound = least_seconds(*random_sampling_work(cfg, 512, 10_000))
    assert bound == "operations" and 4.5e-4 < t < 4.7e-4


def test_guard_compares_whole_top_level_names():
    mods = ["quadruped_pympc_tamols_torch", "quadruped_pympc_tamols_torch.ops", "jaxtyping",
            "jax_utils", "flaxen", "numpy"]
    assert guard.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "quadruped_pympc_tamols_tpu",
           "quadruped_pympc_tamols_tpu.config"]
    assert guard.forbidden_modules(mods + bad) == sorted(bad)


def _python(code: str, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(cwd))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_the_harness_and_reference_load_no_jax_and_the_reference_none_of_the_port():
    code = (
        "import sys\n"
        "import port_bench.reference.fleet, port_bench.reference.gradient\n"
        "import port_bench.generate, port_bench.roofline.k1f\n"
        "print(sorted(n for n in sys.modules if n.split('.')[0] == "
        "'quadruped_pympc_tamols_torch'))\n"
        "import port_bench.run, port_bench.readings, port_bench.drivers.fleet, "
        "port_bench.drivers.solve_stream\n"
        "from port_bench import harness\n"
        "[harness.resolve(w['name']) for w in harness.load_json(harness.ROOT / "
        "'BENCHMARK.json')['workloads']]\n"
        "from port_bench.drivers.fleet import PortFleet\n"
        "import quadruped_pympc_tamols_torch.parallel, "
        "quadruped_pympc_tamols_torch.controllers.gradient\n"
        "from port_bench.guard import forbidden_modules\n"
        "print(forbidden_modules())\n")
    p = _python(code)
    assert p.returncode == 0, p.stderr
    assert p.stdout.split("\n")[:2] == ["[]", "[]"]


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", "fleet_perlin_s64",
                        "--seed", str(2 ** 31 + 7), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert "correct" not in p.stdout


def test_a_run_in_a_directory_of_the_benchmarks_files_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p, ignore=shutil.ignore_patterns("__pycache__"))
    cmd = BENCH["command"] + ["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                              "--trace", "0"]
    p = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout


def test_the_command_names_no_file_outside_its_paths():
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in Path(word).parts
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
