"""One rank of the port's multi-rank parity runs on the CPU (gloo).

``tests/test_torch_parallel.py`` writes a job (the JAX package's recorded inputs
and noise, as numpy) and starts WORLD of these around a TCP store on 127.0.0.1:

    python tests/torch_parallel_worker.py JOB.npz OUT_DIR 127.0.0.1:PORT WORLD RANK

Each rank joins the group, runs every sharded-solver case whose mesh holds it and
the multi-chip fleet cases on a (2, 2) mesh (at zero noise, or on the JAX shards'
recorded noise), and writes what it computed to
OUT_DIR/rank<RANK>.npz. It imports the port only.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np
import torch


def main(job_path, out_dir, store, world, rank) -> int:
    torch.set_num_threads(1)
    import torch.distributed as dist

    from quadruped_pympc_tamols_torch import replace_config
    from quadruped_pympc_tamols_torch.controllers.sampling import SamplingState
    from quadruped_pympc_tamols_torch.interop import config_from_dict, scenario_state_from_numpy
    from quadruped_pympc_tamols_torch.parallel import (init_multihost, make_multichip_step,
                                                       make_sharded_sampling_solver,
                                                       scenario_mesh)
    from quadruped_pympc_tamols_torch.parallel.sharded import tick_inputs

    init_multihost(store, world, rank, device="cpu", timeout_s=240)
    job = dict(np.load(job_path))
    meta = json.loads(str(job["meta"]))
    cfg = config_from_dict(meta["config"])
    t = torch.from_numpy
    out = {}
    for method, n, N in meta["sharded"]:
        mesh = scenario_mesh(1, n)
        if not mesh.member:
            continue
        key = f"{method}/{n}"
        col = mesh.coords[1]
        solve, P = make_sharded_sampling_solver(cfg, mesh, N, method, device="cpu")
        st = SamplingState(t(job[f"{key}/best0"]), 7, 0,
                           torch.full((P,), cfg.mpc.sampling.sigma_cem_mppi))
        n_local = N // n
        inputs = (job["state12"], job["feet"], job["ref12"], job["seq"])
        for call in range(meta["calls"]):
            noise = t(job[f"{key}/noise{call}"][:, col * n_local:(col + 1) * n_local].copy())
            prev = st
            grfs, st, best = solve(*inputs, st, noise=noise)
            out[f"{key}/grfs{call}"] = grfs.numpy()
            out[f"{key}/params{call}"] = st.best_parameters.numpy()
            out[f"{key}/best{call}"] = best.numpy()
            out[f"{key}/sigma{call}"] = st.sigma.numpy()
            if method == "cem_mppi":
                # The same call once more for its global elite set.
                tick = tick_inputs(*inputs, float(np.float32(cfg.robot.mass)))
                elites = solve.iteration(tick, prev.best_parameters, prev.sigma, prev.seed,
                                         prev.offset, noise)[3]
                out[f"{key}/elites{call}"] = elites.numpy()

    mesh = scenario_mesh(2, 2)
    row, col = mesh.coords
    spd = meta["scenarios_per_device"]
    zero = replace_config(cfg, **{"mpc.sampling.sigma_random": (0.0, 0.0, 0.0)})
    n_local = meta["multichip_samples"] // 2
    for name, (terrain, zero_noise) in meta["multichip"].items():
        key = f"multichip/{name}"
        step, _, P = make_multichip_step(zero if zero_noise else cfg, mesh, spd,
                                         meta["multichip_samples"],
                                         None if terrain == "flat" else terrain, device="cpu")
        fields = {k[len(key) + 6:]: v for k, v in job.items() if k.startswith(key + "/init/")}
        state0 = _namespace(fields)
        full = scenario_state_from_numpy(state0, np.arange(len(fields["x"])), device="cpu")
        rows = slice(row * spd, (row + 1) * spd)
        states = type(full).from_tensors([x[rows] for x in full.tensors()])
        cmd = torch.tensor([[0.3, 0.0, 0.0]] * spd)
        metrics = []
        for tick in range(meta["ticks"]):
            noise = None if zero_noise else t(
                job[f"{key}/noise{tick}"][rows, :, col * n_local:(col + 1) * n_local].copy())
            states, m = step(states, cmd, noise=noise)
            metrics.append(m.numpy())
        out[f"{key}/metrics"] = np.stack(metrics)
        out[f"{key}/x"] = states.x.numpy()
        out[f"{key}/feet"] = states.feet.numpy()
        out[f"{key}/params"] = states.mpc.best_parameters.numpy()
    out["coords"] = np.array(mesh.coords)
    np.savez(f"{out_dir}/rank{rank}.npz", **out)
    dist.destroy_process_group()
    return 0


def _namespace(fields: dict):
    """The JAX ScenarioState's fields (mpc's as ``mpc_<name>``) as an object with
    its attribute layout, for ``interop.scenario_state_from_numpy``."""
    @dataclasses.dataclass
    class Mpc:
        best_parameters: np.ndarray
        sigma: np.ndarray

    @dataclasses.dataclass
    class State:
        x: np.ndarray
        feet: np.ndarray
        phase: np.ndarray
        swing_time: np.ndarray
        liftoff: np.ndarray
        prev_contact: np.ndarray
        terrain: np.ndarray
        reflex: np.ndarray
        hitpoint: np.ndarray
        mpc: Mpc

    mpc = Mpc(fields.pop("mpc_best_parameters"), fields.pop("mpc_sigma"))
    return State(mpc=mpc, **fields)


if __name__ == "__main__":
    job_path, out_dir, store, world, rank = sys.argv[1:6]
    sys.exit(main(job_path, out_dir, store, int(world), int(rank)))
