#!/usr/bin/env python3
"""The scenario fleet on the card fed the CPU path's own noise, against Philox.

    python3 tools/fleet_card_vs_cpu.py [cuda|cpu]

Walks 8 perlin scenarios with reflexes (N = 2 000, 0.25 m/s) for 100 ticks from
the same initial state (``init_scenario_state`` with a seeded CPU generator),
once with every tick's noise drawn as the CPU path draws it
(``ops.sampling_fleet.sample_noise``: the generator of each scenario's (seed,
offset)) and handed to the step, and on a card once more with the kernel's
Philox noise, one graph replay a tick. Every 10 ticks it prints the mean forward
distance, the mean forward velocity, the mean total vertical GRF and the
mean best cost, as JSON rows per mode. Run with ``cpu`` here and ``cuda`` on the
card: the two "cpu_noise" rows must agree (the card's K1f and step against the
CPU's plain version on the same noise), and "philox" must walk like them.
"""
from __future__ import annotations

import json
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from quadruped_pympc_tamols_torch import make_config  # noqa: E402
from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl  # noqa: E402
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk  # noqa: E402
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm  # noqa: E402
from quadruped_pympc_tamols_torch.parallel import (init_scenario_state,  # noqa: E402
                                                   make_scenario_step, make_terrain_generator)

S, N, TICKS = 8, 2000, 100


def walk(dev: str, mode: str) -> list:
    cfg = make_config("aliengo", mpc_type="sampling")
    knobs = sm.make_knobs(cfg)
    plan = sk.make_rs_plan(cfg, N, "cpu")
    step, P = make_scenario_step(cfg, N, terrain="perlin", reflexes=True, device=dev)
    st = init_scenario_state(cfg, P, S, torch.Generator().manual_seed(0),
                             make_terrain_generator("perlin", dev), device=dev)
    cmd = torch.tensor([0.25, 0.0, 0.0], device=dev)
    x0 = st.x[:, 0].clone()
    rows = []
    for k in range(TICKS):
        if mode == "cpu_noise":
            noise = fl.sample_noise(plan, knobs, st.mpc.seed.cpu(), st.mpc.offset.cpu())
            m = step(st, cmd, noise=[noise.to(dev)])
        else:
            m = step(st, cmd)
        if k % 10 == 9:
            rows.append([k + 1, float((st.x[:, 0] - x0).mean()), float(st.x[:, 3].mean()),
                         float(m[:, 3].mean()), float(m[:, 0].mean())])
    return rows


def main() -> int:
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    for mode in ("cpu_noise", "philox") if dev == "cuda" else ("cpu_noise",):
        print(mode, json.dumps(walk(dev, mode)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
