#!/usr/bin/env python3
"""Time the MPPI/CEM update pass on one card against variants of its source, to
show where its time goes.

    python3 tools/update_variants.py [WORK_DIR]

For each variant below, copies the port's package into WORK_DIR (default
``quadruped_pympc_tamols_torch/_build/update_variants``, git-ignored), patches
``ops/csrc/sampling_softmax.cuh``, and runs ``tools/pass_times.py`` on the copies
in one list (as-is first and last), which prints each kernel's profiled device us
for K1b, K1c, K1e-mppi and K1e-cem and the update kernel's ptxas report. The
variants that skip work give other numbers and are for timing only.

  as-is        the source as it stands
  regenerate   each block regenerates its nonzero samples' noise from the Philox
               counters (with sigma_mppi: the CEM rows' numbers are wrong, for
               timing only) in place of reading back what the rollout pass wrote
  no-finish    every block returns after its ticket: the per-block part alone
  batch-16     16 nonzero samples loaded a round in place of 32
  batch-64     64 (a block's every sample) in place of 32
  tile-64      64 partial rows copied into shared memory at once in place of 160
  fence-acq-rel  fence.acq_rel.gpu in place of __threadfence (fence.sc) around the
               ticket
  no-select    CEM: the elites taken as samples 0..K-1, no threshold or ranking
               (for timing only)
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "quadruped_pympc_tamols_torch"
HEADER = os.path.join(PACKAGE, "ops", "csrc", "sampling_softmax.cuh")

VARIANTS = {
    "as-is": [],
    "regenerate": [("const float4 z = load_noise4<R>(noise, N, i0 + nz_s[base + r], k);",
                    "const float4 z = sm_noise4(a.seed, a.offset, i0 + nz_s[base + r], k, "
                    "make_float4(kn.sigma_mppi, kn.sigma_mppi, kn.sigma_mppi, kn.sigma_mppi));")],
    "no-finish": [("  if (!last_ticket(ticket, gridDim.x)) return;\n",
                   "  last_ticket(ticket, gridDim.x);\n  return;\n")],
    "batch-16": [("#define SM_BATCH 32 ", "#define SM_BATCH 16 ")],
    "batch-64": [("#define SM_BATCH 32 ", "#define SM_BATCH 64 ")],
    "tile-64": [("#define SM_TILE_ROWS 160 ", "#define SM_TILE_ROWS 64 ")],
    "fence-acq-rel": [("__threadfence();", 'asm volatile("fence.acq_rel.gpu;" ::: "memory");')],
    "no-select": [("  if (K > B) {\n    if (ct == 0) t0_s = ~0ull - 1ull;",
                   "  if (ct < K) elite_s[ct] = ct;\n  if (ct == 0) t0_s = 0ull;\n"
                   "  if (true) {\n    if (false) t0_s = ~0ull - 1ull;")],
}


def make_copy(work: str, name: str) -> str:
    """A patched copy of the package under work/name; returns its root."""
    root = os.path.join(work, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PACKAGE), os.path.join(root, PACKAGE),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(root, HEADER)
    with open(path) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not found in {HEADER}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return root


def main() -> int:
    work = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.join(ROOT, PACKAGE, "_build", "update_variants"))
    os.makedirs(work, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    roots = [make_copy(work, name) for name in VARIANTS]
    roots.append(roots[0])
    return subprocess.run([sys.executable, os.path.join(ROOT, "tools", "pass_times.py"), *roots]
                          ).returncode


if __name__ == "__main__":
    sys.exit(main())
