"""The harness on the card at a small size: a traced run of each driver is correct
and reads its per-layer metrics, and the control (the reference in TF32) is not
correct. Skips without a card; on one:
``python -m pytest -q port_bench/tests/test_port_bench_card.py``."""
from __future__ import annotations

import copy
import time

import pytest
import torch

from port_bench import harness
from port_bench.readings import CONTROLS
from port_bench.run import execute

pytestmark = pytest.mark.cuda
SEED = 2 ** 31 + 31337


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return "cuda:0"


def _small(name):
    cell = harness.resolve(name)
    cell.config = copy.deepcopy(cell.config)
    if cell.traffic["driver"] == "fleet":
        cell.traffic = dict(cell.traffic, scenarios=8, episode_ticks=20, trace_ticks=4)
    else:
        cell.traffic = dict(cell.traffic, check_calls=8, trace_calls=4)
    return cell


@pytest.mark.parametrize("name", ["fleet_perlin_s64", "nominal_trot_stream"])
def test_a_traced_run_on_the_card_is_correct(card, name):
    cell = _small(name)
    out = execute(cell, SEED, 1.0, True, card, time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0 and out["metrics"]


@pytest.mark.parametrize("name", ["fleet_perlin_s64", "nominal_trot_stream"])
def test_the_control_on_the_card_is_not_correct(card, name):
    cell = _small(name)
    out = execute(cell, SEED, 0.5, False, card, time.perf_counter(),
                  make_system=CONTROLS[cell.traffic["driver"]])
    assert not out["correct"], out["checks"]
