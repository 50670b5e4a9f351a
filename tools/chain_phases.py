#!/usr/bin/env python3
"""Where the chain kernel's time goes on one card: its phases, timed from inside.

    python3 tools/chain_phases.py [WORK_DIR] [VARIANT ...]

For each variant below (all by default), copies the port's package into WORK_DIR
(default ``quadruped_pympc_tamols_torch/_build/chain_phases``, git-ignored) and
patches ``ops/csrc/sampling_chain.cu`` so that thread 0 of block 0 reads the global timer
(%globaltimer, ns) at the kernel's start and after each grid barrier, with one
extra, empty barrier after the first to time a barrier alone, and a barrier after
the last iteration. Then, in a process of its own, builds the copy and launches
three chained iterations of each method at N = 10 000 on chip_smoke.py's flagship
tick through the C entry, 50 times after 10 of warm-up, and prints one JSON line a
method and parametrization with the mean us of each phase as block 0 sees it:

  start        the kernel's start to the first barrier's release: the basis and
               columns staged, the key and ticket set
  barrier      one empty grid barrier
  rollout[i]   iteration i's rollout pass up to the release of the barrier after it
  finish[i]    iteration i's update pass and finish (MPPI, CEM) or block 0's
               extraction (random sampling), up to the next barrier's release

and the kernel's device time (torch.profiler, mean of the 50) beside their sum. The
stamps add a few instructions to block 0 and keep the bits; the variants other
than as-is are for timing only:

  as-is              the source as it stands
  incumbent-from-l2  every lane of the rollout phase reads the incumbent and CEM's
                     sigma from L2 (__ldcg), not from the block's copy in shared
                     memory (the same bits)
  carveout-default   the default split of L1 and shared memory, not the
                     largest shared-memory carveout
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "quadruped_pympc_tamols_torch"
SOURCE = os.path.join(PACKAGE, "ops", "csrc", "sampling_chain.cu")
N = 10_000
ITERATIONS = 3
RUNS, WARMUP = 50, 10

STAMPS = """namespace cg = cooperative_groups;

__device__ unsigned long long chain_stamps[64];
#define STAMP                                                                 \\
  if (blockIdx.x == 0 && threadIdx.x == 0) {                                  \\
    unsigned long long t_;                                                    \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                    \\
    chain_stamps[stamp_i++] = t_;                                             \\
  }

extern "C" int chain_read_stamps(unsigned long long* host) {
  return (int)cudaMemcpyFromSymbol(host, chain_stamps, sizeof(chain_stamps));
}
"""
PATCHES = [
    ("namespace cg = cooperative_groups;\n", STAMPS),
    ("  cg::grid_group grid = cg::this_grid();\n",
     "  cg::grid_group grid = cg::this_grid();\n  int stamp_i = 0;\n  STAMP\n"),
    ("  bulk_wait(&bar, 0);\n  grid.sync();\n",
     "  bulk_wait(&bar, 0);\n  grid.sync();\n  STAMP\n  grid.sync();\n  STAMP\n"),
    ("    grid.sync();\n\n    // 3.", "    grid.sync();\n    STAMP\n\n    // 3."),
    ("    if (it + 1 < iterations) grid.sync();\n", "    grid.sync();\n    STAMP\n"),
]


VARIANTS = {
    "as-is": [],
    "incumbent-from-l2": [("offset, inc_s, nullptr", "offset, inc, nullptr"),
                          ("draw_params<PL, Read::Shared>", "draw_params<PL, Read::L2>"),
                          ("ScaledNormals<Read::Shared>{sig ? sig_s : nullptr,",
                           "ScaledNormals<Read::L2>{sig,")],
    "carveout-default": [("cudaSharedmemCarveoutMaxShared", "cudaSharedmemCarveoutDefault")],
}


def make_copy(work: str, variant: str) -> str:
    root = os.path.join(work, variant)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PACKAGE), os.path.join(root, PACKAGE),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(root, SOURCE)
    with open(path) as f:
        text = f.read()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in {SOURCE} once")
        text = text.replace(old, new)
    for old, new in VARIANTS[variant]:
        if old not in text:
            raise RuntimeError(f"{variant}: {old!r} is not in {SOURCE}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return root


def run_copy(root: str, variant: str) -> None:
    """Child: the phases of the patched chain kernel in ``root``'s package."""
    sys.path.insert(0, root)
    import ctypes

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from quadruped_pympc_tamols_torch import make_config
    from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    for par in ("cubic_spline", "linear_spline", "zero_order"):
        for method in ("random_sampling", "mppi", "cem_mppi"):
            cfg = make_config("aliengo", mpc_type="sampling",
                              **{"sim.visual_foothold_adaptation": "blind",
                                 "mpc.sampling.parametrization": par,
                                 "mpc.sampling.method": method})
            plan = sk.make_rs_plan(cfg, N, dev)
            knobs = sm.make_knobs(cfg)
            H = plan.horizon
            state12 = np.zeros(12, np.float32)
            state12[2], state12[3] = cfg.sim.ref_z - 0.03, 0.1
            ref12 = np.zeros(12, np.float32)
            ref12[2], ref12[3] = cfg.sim.ref_z, 0.2
            feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0],
                             [-0.25, -0.15, 0]], np.float32)
            seq = np.ones((4, H), np.float32)
            seq[1, 6:] = seq[2, 6:] = 0.0
            share = gravity_share(torch.from_numpy(seq), cfg.robot.mass)[:, None].expand(H, 4)
            tick = sk.TickInputs(state12, feet, ref12, seq, np.ascontiguousarray(share.numpy()))
            P = plan.num_parameters
            rng = np.random.default_rng(0)
            inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
            sigma = torch.full((P,), cfg.mpc.sampling.sigma_cem_mppi, device=dev)
            lib = sm.load_chain_library(plan.horizon, plan.params_per_leg)
            lib.chain_read_stamps.restype = ctypes.c_int
            lib.chain_read_stamps.argtypes = [ctypes.c_void_p]
            args, kn = sk.kernel_args(plan, tick, 5, 0), knobs.struct()
            ws = sm.workspace(plan, knobs, dev, ITERATIONS)
            stamps = (ctypes.c_ulonglong * 64)()

            def launch():
                sm.chain_launch(lib, args, kn, method, plan, ITERATIONS, ws, inc, sigma)

            for _ in range(WARMUP):
                launch()
            torch.cuda.synchronize()
            phases = []
            for _ in range(RUNS):
                launch()
                torch.cuda.synchronize()
                if lib.chain_read_stamps(ctypes.addressof(stamps)) != 0:
                    raise RuntimeError("chain_read_stamps failed")
                s = np.array(stamps[:3 + 2 * ITERATIONS], np.float64)
                phases.append(np.diff(s) / 1e3)
            mean = np.mean(phases, axis=0)
            names = ["start", "barrier"] + [f"{p}[{i}]" for i in range(ITERATIONS)
                                            for p in ("rollout", "finish")]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(RUNS):
                    launch()
                torch.cuda.synchronize()
            dev_us = [getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
                      / e.count for e in prof.key_averages() if "chain_kernel" in e.key and e.count]
            print(json.dumps({"card": card, "variant": variant, "parametrization": par,
                              "method": method,
                              "phases_us": dict(zip(names, mean.round(3).tolist())),
                              "sum_us": round(float(mean.sum()), 3),
                              "kernel_device_us": dev_us[0] if dev_us else "not measured"}),
                  flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        run_copy(sys.argv[2], sys.argv[3])
        return 0
    work = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.join(ROOT, PACKAGE, "_build", "chain_phases"))
    os.makedirs(work, exist_ok=True)
    rc = 0
    for variant in sys.argv[2:] or VARIANTS:
        root = make_copy(work, variant)
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                              variant]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
