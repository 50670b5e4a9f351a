"""The readings a cell's limits are set from: the numbers its judge gives for the
program and for the control over many seeds, in one process on the card.

The control is the cell's reference put in the program's place and computed one
step of precision below the configuration's: TF32 for float32 matmuls, where the
configurations state float32 with TF32 off. A run with the control in place of the
program has to come out not correct; its numbers are the upper readings, the
program's largest over a dozen seeds or more the lower ones.

    python3 -m port_bench.readings --workload <name> --system program|control \
        --seconds <s> --seed <n> [<n> ...]

runs the cell once per seed with that system under test and prints each run's
numbers, those not compared on standard error. The benchmark's own runs never run
it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .reference.fleet import STATE_KEYS, FleetReference
from .reference.gradient import GradientReference


class ReferenceFleet:
    """The fleet's reference tick as the system under test (the fleet driver's
    interface: ``tensors``, ``load``, ``tick``, ``captures``)."""

    captures = 0

    def __init__(self, ctx):
        tr, dev, cfg = ctx.traffic, ctx.device, ctx.cfg
        sp = cfg.mpc.sampling
        self.ref = FleetReference(ctx.config["make_config"], sp.num_samples, tr["terrain"],
                                  bool(tr["reflexes"]), dev, tf32=True, block=64)
        S, P = int(tr["scenarios"]), self.ref.P
        R, C = int(tr["terrain"]["rows"]), int(tr["terrain"]["cols"])
        f = dict(device=dev)
        self.state = dict(
            x=torch.zeros(S, 12, **f), feet=torch.zeros(S, 4, 3, **f), phase=torch.zeros(S, 4, **f),
            swing_time=torch.zeros(S, 4, **f), liftoff=torch.zeros(S, 4, 3, **f),
            prev_contact=torch.ones(S, 4, **f), best=torch.zeros(S, P, **f),
            sigma=torch.full((S, P), float(sp.sigma_cem_mppi), **f),
            seed=torch.zeros(S, dtype=torch.int64, **f), offset=torch.zeros(S, dtype=torch.int64, **f),
            terrain=torch.zeros(S, R, C, **f), reflex=torch.full((S, 4), -1.0, **f),
            hitpoint=torch.zeros(S, 4, 3, **f))
        from .reference.frozen.config import GAIT_PHASE_OFFSETS
        self.phase0 = torch.tensor(GAIT_PHASE_OFFSETS[cfg.gait_params.gait_type], **f)
        self.sigma0 = float(sp.sigma_cem_mppi)

    def tensors(self) -> tuple:
        return tuple(self.state[k] for k in STATE_KEYS)

    def load(self, ep: dict) -> None:
        st = self.state
        st["terrain"].copy_(ep["terrain"])
        st["x"].copy_(ep["x"])
        st["feet"].copy_(ep["feet"])
        st["liftoff"].copy_(ep["feet"])
        st["phase"].copy_(self.phase0.expand_as(st["phase"]))
        st["swing_time"].zero_()
        st["prev_contact"].fill_(1.0)
        st["best"].zero_()
        st["sigma"].fill_(self.sigma0)
        st["seed"].copy_(ep["seed"])
        st["offset"].zero_()
        st["reflex"].fill_(-1.0)
        st["hitpoint"].zero_()

    def tick(self, cmd):
        post, metrics, _, _ = self.ref.tick(self.state, cmd)
        for k in STATE_KEYS:
            self.state[k].copy_(post[k])
        return metrics


class ReferenceGradient:
    """The gradient reference as the system under test (the solve_stream driver's
    interface: ``call``, ``U_warm``, ``reset``, ``captures``), with the controller's
    warm start and fallback, in float32 on the card with TF32 matmuls."""

    captures = 0

    def __init__(self, ctx):
        self.ref = GradientReference(ctx.config["make_config"], ctx.config["mehrotra_iterations"],
                                     device=ctx.device, dtype=torch.float32, tf32=True)
        self.reset()

    def reset(self) -> None:
        self.U_warm = np.zeros((self.ref.H, 12), np.float32)
        self.previous = np.zeros((4, 3), np.float32)

    def call(self, state, reference, seq):
        x0, feet, sq, Xref, Uref = self.ref.inputs(state, reference, seq)
        U, _ = self.ref.solve(x0, feet, sq, Xref, Uref, self.U_warm)
        if not np.all(np.isfinite(U)):
            self.U_warm = np.zeros_like(self.U_warm)
            return self.previous, 1
        U = U.astype(np.float32)
        grfs = U[0].reshape(4, 3) * sq[:, 0:1]
        self.previous = grfs
        self.U_warm = np.concatenate([U[1:], U[-1:]], axis=0)
        return grfs, 0


CONTROLS = {"fleet": ReferenceFleet, "solve_stream": ReferenceGradient}


def main(argv=None) -> int:
    from . import harness
    from .run import execute
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--system", choices=("program", "control"), required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--episode-ticks", type=int, default=None,
                    help="a fleet's episode length, for the control's short window")
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cell = harness.resolve(args.workload)
    if args.episode_ticks:
        cell.traffic = dict(cell.traffic, episode_ticks=args.episode_ticks)
    system = CONTROLS[cell.traffic["driver"]] if args.system == "control" else None
    for seed in args.seed:
        out = execute(cell, seed, args.seconds, False, "cuda:0", time.perf_counter(),
                      make_system=system)
        print(json.dumps({"workload": args.workload, "seed": seed, "system": args.system,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
