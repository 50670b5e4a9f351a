#!/usr/bin/env python3
"""Time kernel K1f's layouts on one card against variants of its source, to choose
the large-batch layout's design and to show what bounds it.

    python3 tools/fleet_variants.py [WORK_DIR] [VARIANT ...]

The fleet counterpart of ``tools/rollout_variants.py``. For each variant below
(all of them if none is named), copies the port's package into WORK_DIR (default
``quadruped_pympc_tamols_torch/_build/fleet_variants``, git-ignored), patches
``ops/csrc/sampling_fleet.cu`` (and, for the block size, the Python constant
checked against it), and in a process of its own builds the copy and times K1f
through its C entry, with ``tools/pass_times.py``'s ``profile`` (torch.profiler:
each kernel's mean device us a launch over 50 iterations, after 50 of warm-up)
and ``event_ms`` (the median CUDA-event ms of one iteration over 100), on
chip_smoke.py's fleet inputs at each (S, N) of SHAPES, for random sampling in
the four-lane and large-batch rollouts and for MPPI and CEM-MPPI in each of the
four layouts (the rollout's two, each with the update reading the noise back or
drawing it again). It prints one JSON line a variant and case with those times
and a digest of the iteration's costs and packed outputs (the layouts and the
variants that keep the arithmetic show one digest a case), then one with the
registers, shared memory and spills of the copy's K1f kernels (``-Xptxas -v``).

  as-is          the source as it stands
  wide-64        64 samples a large-batch block (8 blocks an SM's budget)
  wide-256       256 samples a large-batch block (2 blocks an SM's budget)
  min-blocks-3   the large-batch rollout's register budget at 3 blocks an SM
                 (168 registers a thread in place of 128)
  regen-tiles-1  the regenerating update runs one tile of 64 samples a block, as
                 the read-back one does, in place of 2
  regen-tiles-4  4 tiles a block (a 99 KB row buffer: two blocks an SM)
  noise-unrolled the large-batch rollout's draw loop over the legs unrolled
  regen-2-blocks the regenerating update pass's register budget at 2 blocks of 512
                 threads an SM (64 registers a thread, the read-back pass's) in
                 place of 3 (42)
  regen-4-blocks the same at 4 blocks (32 registers)
  no-via-lane    via_lane returns its value without the shuffle (other bits: for
                 timing only, the shuffles' cost)
  regen-stage-0  the regenerating CEM finish reads every block key from L2 and
                 stages none in shared memory
  regen-stage-4096 the same with up to 4096 keys staged (update_finish's
                 SM_STAGE_KEYS) in place of 512
  cem-no-finish  the regenerating update's finish skips the elites and the refit
                 (no sigma: for timing only)
  regen-no-draw  the regenerating update's tiles write w in place of w * noise and
                 draw nothing (other parameters: for timing only, the draws' cost)

Each copy builds only sampling_fleet.cu at the main path's (H, P_leg) = (12, 24).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "quadruped_pympc_tamols_torch"
SOURCE = os.path.join(PACKAGE, "ops", "csrc", "sampling_fleet.cu")
CONSTANT = os.path.join(PACKAGE, "ops", "sampling_fleet.py")
SHAPES = ((64, 128), (1024, 128), (64, 10_000))


def wide(samples: int):
    return {SOURCE: [("#define FLEET_WIDE_SAMPLES 128", f"#define FLEET_WIDE_SAMPLES {samples}"),
                     ("#define FLEET_WIDE_MIN_BLOCKS 4",
                      f"#define FLEET_WIDE_MIN_BLOCKS {512 // samples}")],
            CONSTANT: [("WIDE_SAMPLES = 128", f"WIDE_SAMPLES = {samples}")]}


# name: {file: [(old, new), ...]}
VARIANTS = {
    "as-is": {},
    "wide-64": wide(64),
    "wide-256": wide(256),
    "min-blocks-3": {SOURCE: [("#define FLEET_WIDE_MIN_BLOCKS 4",
                               "#define FLEET_WIDE_MIN_BLOCKS 3")]},
    "regen-tiles-1": {SOURCE: [("#define FLEET_REGEN_TILES 2", "#define FLEET_REGEN_TILES 1")]},
    "regen-tiles-4": {SOURCE: [("#define FLEET_REGEN_TILES 2", "#define FLEET_REGEN_TILES 4")]},
    "noise-unrolled": {SOURCE: [("#pragma unroll 1\n  for (int leg = 0; leg < 4; ++leg) {",
                                 "#pragma unroll\n  for (int leg = 0; leg < 4; ++leg) {")]},
    "regen-2-blocks": {SOURCE: [("#define FLEET_REGEN_MIN_BLOCKS 3",
                                 "#define FLEET_REGEN_MIN_BLOCKS 2")]},
    "regen-4-blocks": {SOURCE: [("#define FLEET_REGEN_MIN_BLOCKS 3",
                                 "#define FLEET_REGEN_MIN_BLOCKS 4")]},
    "no-via-lane": {SOURCE: [("  return __shfl_sync(0xffffffffu, v, threadIdx.x % ROLLOUT_LANES, "
                              "ROLLOUT_LANES);", "  return v;")]},
    "regen-stage-0": {SOURCE: [("#define FLEET_REGEN_STAGE_KEYS 512",
                                "#define FLEET_REGEN_STAGE_KEYS 0")]},
    "regen-stage-4096": {SOURCE: [("#define FLEET_REGEN_STAGE_KEYS 512",
                                   "#define FLEET_REGEN_STAGE_KEYS SM_STAGE_KEYS")]},
    "regen-no-draw": {SOURCE: [(
        """      const float4 z = fleet_noise4<1>(a, seed, offset, kn.sigma_mppi, sigma,
                                       i0 + tl * RS_BLOCK + nz_s[row], k, p, valid);""",
        """      const float4 z = make_float4(1.f, 1.f, 1.f, 1.f);""")]},
    "cem-no-finish": {SOURCE: [("    if (kn.cem && threadIdx.x >= SM_COL_THREADS)\n"
                                "      regen_cem_finish",
                                "    if (false)\n      regen_cem_finish")]},
}


def make_copy(work: str, name: str) -> str:
    """A patched copy of the package under work/name; returns its root."""
    root = os.path.join(work, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PACKAGE), os.path.join(root, PACKAGE),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, edits in VARIANTS[name].items():
        path = os.path.join(root, rel)
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not found in {rel}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    return root


def time_copy(root: str, name: str) -> None:
    """Child: builds the copy at root and times K1f's layouts at SHAPES."""
    sys.path[:0] = [root, ROOT, os.path.join(ROOT, "tools")]
    import numpy as np
    import torch

    import chip_smoke as cs
    import pass_times as pt
    from quadruped_pympc_tamols_torch.ops import build
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    if not build.__file__.startswith(root):
        raise RuntimeError(f"imported {build.__file__}, not the copy at {root}")
    build.SOURCES = ("sampling_fleet",)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = torch.cuda.get_device_name(0)
    layouts = {"four_lane": fl.FOUR_LANE, "four_lane_regen": fl.REGEN, "wide": fl.WIDE,
               "large_batch": fl.LARGE_BATCH}
    for method in sm.METHODS:
        cfg = cs.fleet_cfg(method)
        knobs = sm.make_knobs(cfg)
        for S, N in SHAPES:
            plan, tick, inc, sigma, seeds, offsets = cs.fleet_inputs(
                cfg, S, N, dev, np.random.default_rng(0))
            scen = fl.tick_buffer(tick)
            for lname, layout in layouts.items():
                if method == "random_sampling" and layout & fl.REGEN:
                    continue
                ws = fl.fleet_workspace(plan, knobs, S, dev, layout)

                def one():
                    fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets, 0, ws=ws,
                                       scen=scen, layout=layout)

                one()
                torch.cuda.synchronize()
                h = hashlib.sha256(ws.costs.cpu().numpy().tobytes())
                h.update(ws.out.cpu().numpy().tobytes())
                print(json.dumps({"variant": name, "card": card, "method": method, "S": S, "N": N,
                                  "layout": lname, "kernels": pt.profile(one),
                                  "event_ms": pt.event_ms(one),
                                  "digest": h.hexdigest()[:16]}), flush=True)
    p = cs.fleet_inputs(cs.fleet_cfg(), 1, 1, "cpu", np.random.default_rng(0))[0]
    pair = (p.horizon, p.params_per_leg)
    log = build.build_all((pair,))[("sampling_fleet", *pair)].with_suffix(".log")
    print(json.dumps({"variant": name, "ptxas": pt.ptxas(log)}), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        time_copy(sys.argv[2], sys.argv[3])
        return 0
    args = sys.argv[1:]
    work = os.path.abspath(args.pop(0) if args and args[0] not in VARIANTS
                           else os.path.join(ROOT, PACKAGE, "_build", "fleet_variants"))
    names = args or list(VARIANTS)
    os.makedirs(work, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name in names:
        root = make_copy(work, name)
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root, name],
                               capture_output=True, text=True)
        sys.stdout.write(child.stdout)
        if child.returncode != 0:
            raise RuntimeError(f"variant {name} failed:\n{child.stderr[-4000:]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
