#!/usr/bin/env python3
"""Record the JAX package's MuJoCo loop as a fixture for the port's torque path.

    python tools/record_mujoco_trace.py [--seconds 1.0] [--seed 0] [--out PATH]

Runs ``quadruped_pympc_tamols_tpu.sim.run_simulation`` on the CPU for the
README's full-physics example (default configuration with
``sim.visual_foothold_adaptation = "height"``, trot, 0.3 m/s on flat ground,
N = 10 000) and saves, for every control step, every input of
``QuadrupedPyMPCWrapper.compute_actions`` (the heightmaps only on the steps that
sensed, the MuJoCo contact points of every step for the geom_contact reflex) and
its outputs: ``nmpc_GRFs``, ``nmpc_footholds``, ``optimize_swing``, ``tau``,
``des_joints_pos`` and ``des_joints_vel``. Written compressed to
``tests/fixtures/torch_mujoco_trace.npz``; ``tests/test_torch_mujoco.py`` and
``chip_smoke.py`` (phase 18) replay it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "fixtures" / "torch_mujoco_trace.npz"
# compute_actions arguments that are per-leg arrays (Legs) and plain arrays.
LEG_ARGS = ("feet_pos", "hip_pos", "joints_pos", "qpos_js", "qvel_js", "feet_jac",
            "feet_jac_dot", "feet_vel", "legs_qfrc_bias", "legs_mass_matrix",
            "legs_qfrc_passive")
VEC_ARGS = ("com_pos", "base_pos", "base_lin_vel", "base_ori_euler_xyz", "base_ang_vel",
            "ref_base_lin_vel", "ref_base_ang_vel")
MAX_CONTACTS = 4  # contact points kept per foot and step


def record_config():
    from quadruped_pympc_tamols_tpu import make_config, replace_config
    cfg = make_config("aliengo", mpc_type="sampling")
    return replace_config(cfg, **{"sim.visual_foothold_adaptation": "height"})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path, default=OUT)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT))
    import conftest  # noqa: F401  (the CPU platform the tests use)
    from quadruped_pympc_tamols_tpu.interfaces import wrapper as jwrapper
    from quadruped_pympc_tamols_tpu.sim import mujoco_env, simulation

    envs = []
    env_init = mujoco_env.QuadrupedEnv.__init__

    def init(self, *a, **kw):
        env_init(self, *a, **kw)
        envs.append(self)

    steps = []
    compute_actions = jwrapper.QuadrupedPyMPCWrapper.compute_actions

    def recorded(self, **kw):
        step = {k: np.asarray(kw[k], np.float64) for k in VEC_ARGS}
        step.update({k: np.asarray(kw[k].data, np.float64) for k in LEG_ARGS})
        step["simulation_dt"] = kw["simulation_dt"]
        hms = kw["heightmaps"]
        step["hms"] = None if hms is None else tuple(
            np.asarray(getattr(hms, f)) for f in ("center", "yaw", "resolution", "heights"))
        step["contacts"] = envs[-1].feet_contact_points()
        tau = compute_actions(self, **kw)
        step.update(tau=np.asarray(tau.data), des_q=np.asarray(self.des_joints_pos.data),
                    des_qd=np.asarray(self.des_joints_vel.data),
                    grfs=np.asarray(self.nmpc_GRFs.data, np.float64),
                    footholds=np.asarray(self.nmpc_footholds.data, np.float64),
                    optimize_swing=int(self.get_obs()["optimize_swing"]))
        steps.append(step)
        return tau

    mujoco_env.QuadrupedEnv.__init__ = init
    jwrapper.QuadrupedPyMPCWrapper.compute_actions = recorded
    cfg = record_config()
    t0 = time.perf_counter()
    res = simulation.run_simulation(cfg, episode_duration_s=args.seconds,
                                    ref_base_lin_vel=(0.3, 0.0), seed=args.seed)[0]
    wall = time.perf_counter() - t0

    out = {k: np.stack([s[k] for s in steps]) for k in (*VEC_ARGS, *LEG_ARGS)}
    out["simulation_dt"] = np.array([s["simulation_dt"] for s in steps])
    for k in ("tau", "des_q", "des_qd", "grfs", "footholds"):
        out[k] = np.stack([s[k] for s in steps])
    out["optimize_swing"] = np.array([s["optimize_swing"] for s in steps], np.int8)
    sensed = [i for i, s in enumerate(steps) if s["hms"] is not None]
    out["hm_steps"] = np.array(sensed, np.int32)
    for j, name in enumerate(("hm_center", "hm_yaw", "hm_resolution", "hm_heights")):
        out[name] = np.stack([steps[i]["hms"][j] for i in sensed]).astype(np.float32)
    # Contact points: (T, 4, MAX_CONTACTS, 6) position and normal, with counts.
    pts = np.zeros((len(steps), 4, MAX_CONTACTS, 6))
    counts = np.zeros((len(steps), 4), np.int8)
    for i, s in enumerate(steps):
        for leg, lst in enumerate(s["contacts"]):
            for k, (pos, normal) in enumerate(lst[:MAX_CONTACTS]):
                pts[i, leg, k] = np.concatenate([pos, normal])
            counts[i, leg] = min(len(lst), MAX_CONTACTS)
    out["contact_points"], out["contact_counts"] = pts, counts
    out["config_json"] = np.array(json.dumps(dataclasses.asdict(cfg), default=str))
    out["seed"] = np.array(args.seed)
    out["final_base_state"] = res.state_history[-1]
    args.out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    print(f"{len(steps)} steps ({len(sensed)} sensed, fell={res.fell}, walked "
          f"{res.distance:.4f} m) in {wall:.1f} s -> {args.out} "
          f"({args.out.stat().st_size / 1e6:.3f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
