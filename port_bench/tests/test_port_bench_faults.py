"""The harness's judgment with the timed path broken underneath: a run drives the rest
of a cell on the CPU at a small size (no look for a card), once with the port as it
is, which has to come out correct, once with the control (the reference in TF32) in
the program's place, and once for each fault the cell can have, both of which have
to come out not correct. The fleet on the CPU takes the Philox noise the card's
kernel would draw (``drivers/fleet.py:make_system``)."""
from __future__ import annotations

import copy
import time

import numpy as np
import pytest

from port_bench import harness
from port_bench.reference.frozen.config import make_config
from port_bench.drivers import fleet, solve_stream
from port_bench.readings import CONTROLS
from port_bench.run import execute

SEED = 2 ** 31 + 977


def small_fleet():
    cell = harness.resolve("fleet_perlin_s64")
    cell.config = copy.deepcopy(cell.config)
    cell.config["make_config"]["mpc.sampling.num_samples"] = 48
    cell.traffic = dict(cell.traffic, scenarios=3, episode_ticks=3, check_ticks=3)
    return cell


def small_stream():
    """The stream at 40 Hz; the reference runs the Mehrotra budget the program runs on
    the CPU."""
    from quadruped_pympc_tamols_torch.controllers.gradient.sqp import qp_solver_for

    cell = harness.resolve("nominal_trot_stream")
    cell.config = copy.deepcopy(cell.config)
    gp = make_config(**cell.config["make_config"]).mpc.gradient
    cell.config["mehrotra_iterations"] = qp_solver_for(gp, "cpu")[1]
    cell.traffic = dict(cell.traffic, rate_hz=40, check_calls=4)
    return cell


class Faulty:
    """The port's system with one fault: ``kind`` is "unchanged" (a step that returns
    its state as it was), "half" (the second half of the scenarios left out, their
    state as it was) or "altered" (an answer altered where it is produced)."""

    def __init__(self, inner, kind):
        self.inner, self.kind = inner, kind

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def tick(self, cmd):
        before = [t.clone() for t in self.inner.tensors()]
        m = self.inner.tick(cmd)
        after = self.inner.tensors()
        if self.kind == "unchanged":
            for t, b in zip(after, before):
                t.copy_(b)
        elif self.kind == "half":
            h = after[0].shape[0] // 2
            for t, b in zip(after, before):
                t[h:] = b[h:]
        else:
            after[0][0, 5] += 0.01  # the first scenario's vertical velocity
        return m

    def call(self, state, reference, seq):
        if self.kind == "unchanged":
            if getattr(self, "_last", None) is None:
                self._last = self.inner.call(state, reference, seq)
            return self._last
        grfs, status = self.inner.call(state, reference, seq)
        grfs = np.array(grfs)
        stance = np.flatnonzero(np.asarray(seq)[:, 0] > 0)
        grfs[stance[0], 2] *= 1.1
        return grfs, status


def run_cell(cell, fault=None, seconds=1.0):
    make = None
    if fault is not None:
        base = fleet.make_system if cell.traffic["driver"] == "fleet" else solve_stream.make_system

        def make(ctx):
            return Faulty(base(ctx), fault)
    return execute(cell, SEED, seconds, False, "cpu", time.perf_counter(), make_system=make)


def test_sound_fleet_is_correct():
    out = run_cell(small_fleet())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_fleet_fault_is_not_correct(fault):
    out = run_cell(small_fleet(), fault)
    assert not out["correct"], out["checks"]


def test_sound_stream_is_correct():
    out = run_cell(small_stream())
    assert out["correct"], out["checks"]
    assert out["attempted"] == 40


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_stream_fault_is_not_correct(fault):
    out = run_cell(small_stream(), fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("small", [small_fleet, small_stream])
def test_control_is_not_correct(small):
    cell = small()
    out = execute(cell, SEED, 1.0, False, "cpu", time.perf_counter(),
                  make_system=CONTROLS[cell.traffic["driver"]])
    assert not out["correct"], out["checks"]


def test_captures_do_not_grow_in_the_window():
    """A fleet whose state tensors were replaced in the window would capture a new
    graph; the harness refuses the run. On the CPU nothing is captured, so the check
    is driven through a system that reports a capture in the window."""
    class Recapturing:
        def __init__(self, inner):
            self.inner, self.n = inner, 0

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def tick(self, cmd):
            self.n += 1
            return self.inner.tick(cmd)

        @property
        def captures(self):
            return self.n

    with pytest.raises(RuntimeError, match="captured"):
        execute(small_fleet(), SEED, 0.3, False, "cpu", time.perf_counter(),
                make_system=lambda ctx: Recapturing(fleet.make_system(ctx)))

