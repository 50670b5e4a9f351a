"""Multi-host scaling of the fleet on torch.distributed.

Counterpart of ``quadruped_pympc_tamols_tpu/parallel/multihost.py``: scenarios
shard over hosts and each solve's samples over the ranks within a host, with the
same program as the one-host mesh (``parallel/sharded.py``). One JAX device is one
rank here, and one JAX process is one host's group of ``LOCAL_WORLD_SIZE`` ranks:
ranks are numbered host-major, so the mesh's sample groups (the chatty
collectives: a MIN and a SUM a tick) stay inside a host, and the scenario groups
(one SUM a tick for the fleet metrics) cross hosts.

``launch_local_multihost(n_proc, local_devices, ...)`` spawns n_proc *
local_devices ranks of ``python -m quadruped_pympc_tamols_torch.parallel.multihost``
around a TCP store on 127.0.0.1, gloo on the CPU, one torch thread each; on a
cluster, run the module on every host with the store's address, or under
``torchrun`` (env://). The card's NCCL backend takes one rank a device, so on one
H100 the NCCL path runs at world size 1.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

TIMEOUT_S = 600.0


def find_free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_multihost(coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, device="cuda",
                   timeout_s: float = TIMEOUT_S) -> None:
    """Join the default process group, once (a second call does nothing): NCCL for
    ``device="cuda"``, gloo for the CPU. With ``coordinator_address`` ("host:port")
    the group meets at that TCP store with the given world size and rank; without
    it, at env:// (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets
    them). A collective that does not complete within ``timeout_s`` raises."""
    import torch.distributed as dist

    from ..utils.device import resolve_device

    if dist.is_initialized():
        return
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    kw = {}
    if coordinator_address is not None:
        kw = dict(init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
                  rank=int(process_id))
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)


def local_world_size() -> int:
    """Ranks a host: ``LOCAL_WORLD_SIZE`` (torchrun and ``launch_local_multihost`` set
    it), else the whole world."""
    import torch.distributed as dist

    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def multihost_mesh(samples_per_host: int | None = None):
    """The ("scenario", "sample") mesh over every rank with each sample group inside
    one host: samples_per_host (a divisor of the ranks a host; all of them if None)
    columns, each host contributing L / samples_per_host scenario rows."""
    import torch.distributed as dist

    from .sharded import scenario_mesh

    L = local_world_size()
    n = samples_per_host or L
    if L % n:
        raise ValueError(f"samples_per_host={n} must divide the ranks a host, {L}")
    if dist.get_world_size() % L:
        raise ValueError(f"{dist.get_world_size()} ranks are not whole hosts of {L}")
    return scenario_mesh(dist.get_world_size() // n, n)


def make_multihost_fleet(cfg, mesh, scenarios_per_device: int = 1, num_samples: int = 240,
                         device="cuda"):
    """The fleet step of ``make_multichip_step`` over a multi-host mesh.

    Returns ``(step, init, B, B_local)``: each rank steps and holds its own
    B_local = scenarios_per_device scenarios of the B in all, and the metrics
    ``step`` returns are the fleet's, the same on every rank."""
    from .sharded import make_multichip_step

    step, init, _ = make_multichip_step(cfg, mesh, scenarios_per_device=scenarios_per_device,
                                        num_samples=num_samples, device=device)
    return step, init, mesh.shape["scenario"] * scenarios_per_device, scenarios_per_device


def run_fleet(n_steps: int = 5, scenarios_per_device: int = 2, num_samples: int = 48,
              samples_per_host: int | None = None, seed: int = 0, robot: str = "aliengo",
              device="cuda", zero_noise: bool = False):
    """Run the closed-loop fleet over the initialized process group.

    Returns (metrics_last [vel_err, best_cost] as numpy, wall s a step after the
    first, B). ``zero_noise`` sets the random sampling's three sigmas to 0, so
    that every run of the same scenarios gives the same fleet whatever the mesh."""
    import torch

    from ..config import make_config, replace_config

    mesh = multihost_mesh(samples_per_host)
    n_sample = mesh.shape["sample"]
    cfg = make_config(robot, mpc_type="sampling")
    over = {"mpc.sampling.num_samples": num_samples}
    if zero_noise:
        over["mpc.sampling.sigma_random"] = (0.0, 0.0, 0.0)
    cfg = replace_config(cfg, **over)
    step, init, B, B_local = make_multihost_fleet(cfg, mesh, scenarios_per_device,
                                                  max(num_samples, 3 * n_sample), device)
    states = init(seed)
    dev = states.x.device
    cmd = torch.tensor([[0.3, 0.0, 0.0]] * B_local, dtype=torch.float32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    states, metrics = step(states, cmd)
    sync()
    t0 = time.perf_counter()
    for _ in range(n_steps - 1):
        states, metrics = step(states, cmd)
    sync()
    wall = (time.perf_counter() - t0) / max(1, n_steps - 1)
    return metrics.cpu().numpy(), wall, B


def launch_local_multihost(n_proc: int, local_devices: int = 2, n_steps: int = 5,
                           scenarios_per_device: int = 2, num_samples: int = 48,
                           timeout_s: float = TIMEOUT_S, zero_noise: bool = False,
                           samples_per_host: int | None = None) -> dict:
    """Spawn n_proc "hosts" of ``local_devices`` gloo ranks each on this machine
    around a TCP store on 127.0.0.1 and run the fleet. Returns rank 0's report
    (the JAX package's keys) with ``"rank_metrics"``: every rank's [vel_err,
    best_cost]. Raises, after killing every worker, if one fails or the run
    outlasts ``timeout_s``."""
    port = find_free_port()
    world = n_proc * local_devices
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1", LOCAL_WORLD_SIZE=str(local_devices))
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (repo_root, env.get("PYTHONPATH")) if p)
    procs = []
    for rank in range(world):
        cmd = [sys.executable, "-m", "quadruped_pympc_tamols_torch.parallel.multihost",
               "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
               "--process-id", str(rank), "--steps", str(n_steps),
               "--scenarios-per-device", str(scenarios_per_device),
               "--num-samples", str(num_samples), "--device", "cpu",
               "--timeout", str(timeout_s)]
        if samples_per_host:
            cmd += ["--samples-per-host", str(samples_per_host)]
        if zero_noise:
            cmd.append("--zero-noise")
        procs.append(spawn(cmd, env, repo_root))
    outs = wait_all(procs, timeout_s, "multihost worker")
    reports = [json.loads(next(line for line in out.splitlines() if line.startswith("{")))
               for out, _ in outs]
    report = dict(reports[0])
    report["rank_metrics"] = [[r["fleet_vel_err"], r["fleet_cost"]] for r in reports]
    return report


def spawn(cmd, env, cwd) -> subprocess.Popen:
    """``cmd`` started with its stdout and stderr in temporary files (read by
    ``wait_all``), so that no pipe fills while its siblings are waited for."""
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    p = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=out, stderr=err, text=True)
    p.files = (out, err)
    return p


def _read(p) -> tuple:
    texts = []
    for f in p.files:
        f.seek(0)
        texts.append(f.read())
        f.close()
    return tuple(texts)


def wait_all(procs, timeout_s: float, what: str) -> list:
    """(stdout, stderr) of every process of ``spawn`` once all have exited 0; if one
    fails or the deadline passes first, kills them all and raises with the
    failure's stderr."""
    deadline = time.time() + timeout_s
    failed = None
    while failed is None and any(p.poll() is None for p in procs):
        failed = next((p for p in procs if p.poll() not in (None, 0)), None)
        if time.time() > deadline:
            break
        time.sleep(0.05)
    if failed is None:
        failed = next((p for p in procs if p.poll() not in (None, 0)), None)
    timed_out = any(p.poll() is None for p in procs)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
    outs = [_read(p) for p in procs]
    if failed is not None or timed_out:
        i = procs.index(failed) if failed is not None else 0
        why = f"failed rc={failed.returncode}" if failed is not None else "timed out"
        raise RuntimeError(f"{what} {i} {why}:\n{outs[i][1][-4000:]}")
    return outs


def scaling_table(proc_counts=(1, 2), local_devices: int = 2, n_steps: int = 6,
                  scenarios_per_device: int = 2, num_samples: int = 48) -> list:
    """Throughput of the same fleet program at each simulated host count and its
    efficiency against the first: ``efficiency`` = thru_N / (N * thru_1), weak
    scaling, meaningful only where hosts have their own cores, and
    ``fixed_hw_efficiency`` = thru_N / thru_1, what splitting the fleet over
    processes costs on the same cores (all simulated hosts share this machine's)."""
    rows = []
    base = None
    for n in proc_counts:
        rep = launch_local_multihost(n, local_devices=local_devices, n_steps=n_steps,
                                     scenarios_per_device=scenarios_per_device,
                                     num_samples=num_samples)
        thru = rep["scenario_steps_per_s"]
        if base is None:
            base = thru / n
        rows.append({"hosts": n, "devices": rep["global_devices"],
                     "fleet_scenarios": rep["fleet_scenarios"],
                     "step_wall_ms": round(rep["step_wall_s"] * 1e3, 2),
                     "scenario_steps_per_s": thru,
                     "efficiency": round(thru / (n * base), 3),
                     "fixed_hw_efficiency": round(thru / (base * proc_counts[0]), 3)})
    return rows


def _main():
    ap = argparse.ArgumentParser(description="multi-host fleet worker (one rank)")
    ap.add_argument("--coordinator", default=None, help="host:port of the TCP store "
                    "(env:// if absent)")
    ap.add_argument("--num-processes", type=int, default=None, help="ranks in all")
    ap.add_argument("--process-id", type=int, default=None, help="this rank")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--scenarios-per-device", type=int, default=2)
    ap.add_argument("--num-samples", type=int, default=48)
    ap.add_argument("--samples-per-host", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu (gloo)")
    ap.add_argument("--zero-noise", action="store_true")
    ap.add_argument("--timeout", type=float, default=TIMEOUT_S)
    args = ap.parse_args()

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    init_multihost(args.coordinator, args.num_processes, args.process_id, args.device,
                   args.timeout)
    try:
        metrics, wall, B = run_fleet(n_steps=args.steps,
                                     scenarios_per_device=args.scenarios_per_device,
                                     num_samples=args.num_samples,
                                     samples_per_host=args.samples_per_host,
                                     device=args.device, zero_noise=args.zero_noise)
        if not np.all(np.isfinite(metrics)):
            raise AssertionError(f"non-finite fleet metrics: {metrics}")
        L = local_world_size()
        print(json.dumps({"processes": dist.get_world_size() // L,
                          "global_devices": dist.get_world_size(), "local_devices": L,
                          "rank": dist.get_rank(), "fleet_scenarios": int(B),
                          "fleet_vel_err": float(metrics[0]), "fleet_cost": float(metrics[1]),
                          "step_wall_s": wall, "scenario_steps_per_s": B / wall}), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
