#!/usr/bin/env python3
"""Time the shared rollout pass on one card against variants of its source, to
show what bounds it.

    python3 tools/rollout_variants.py [WORK_DIR]

For each variant below, copies the port's package into WORK_DIR (default
``quadruped_pympc_tamols_torch/_build/variants``, git-ignored), patches
``ops/csrc/sampling_common.cuh`` (and, for the block sizes, the Python constant
checked against it), and in a process of its own builds the copy and times K1a's
rollout kernel with torch.profiler: the
mean device time over 50 launches of the C entry on chip_smoke.py's flagship tick
and Philox noise, at each of the sample counts listed. It prints one JSON line a
variant with those times, the rollout kernel's ptxas report, its instruction
count in the library's SASS (``cuobjdump -sass``) and a digest of the N = 10 000
costs, so that the variants which keep the arithmetic show the same digest as
``as-is``.

  as-is          the source as it stands
  one-lane-body  every lane makes all six sin/cos calls and five divisions of a
                 step itself (srb_body<false>), as one thread per sample did
  unrolled       the step loop fully unrolled
  block-8        8 samples a block in place of 16
  block-32       32 samples a block
  fast-trig      __sincosf in place of sincosf (other numbers: for timing only)
  no-body        the body update replaced by state += f dt, the force model and
                 the exchange kept (other numbers: for timing only)
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "quadruped_pympc_tamols_torch"
HEADER = os.path.join(PACKAGE, "ops", "csrc", "sampling_common.cuh")
CONSTANT = os.path.join(PACKAGE, "ops", "sampling_kernel.py")
BODY_CALL = "    srb_body<true>(st, f, a.dts[n], ft, md, leg);"
LOOP = "#pragma unroll 1  // see the note above: rolled, the body fits the instruction cache"


def block(samples: int):
    return {HEADER: [("#define ROLLOUT_SAMPLES 16", f"#define ROLLOUT_SAMPLES {samples}"),
                     ("#define ROLLOUT_MIN_BLOCKS 8",
                      f"#define ROLLOUT_MIN_BLOCKS {128 // samples}")],
            CONSTANT: [("ROLLOUT_SAMPLES = 16", f"ROLLOUT_SAMPLES = {samples}")]}


# name: ({file: [(old, new), ...]}, sample counts)
VARIANTS = {
    "as-is": ({}, (1250, 10_000)),
    "one-lane-body": ({HEADER: [(BODY_CALL, BODY_CALL.replace("<true>", "<false>"))]},
                      (1250, 10_000)),
    "unrolled": ({HEADER: [(LOOP, "#pragma unroll")]}, (1250, 10_000)),
    "block-8": (block(8), (10_000,)),
    "block-32": (block(32), (10_000,)),
    "fast-trig": ({HEADER: [("    sincosf(leg == 0", "    __sincosf(leg == 0")]}, (10_000,)),
    "no-body": ({HEADER: [(BODY_CALL, "    for (int q = 0; q < 12; ++q) "
                                      "st[q] = st[q] + f[q] * a.dts[n];")]}, (10_000,)),
}


def make_copy(work: str, name: str) -> str:
    """A patched copy of the package under work/name; returns its root."""
    root = os.path.join(work, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, PACKAGE), os.path.join(root, PACKAGE),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, edits in VARIANTS[name][0].items():
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


def sass_instructions(lib_path) -> int:
    """Instructions of the rollout kernel in a library's SASS."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "rollout_kernel" in line
        elif inside and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
            count += 1
    return count


def time_copy(root: str, counts: list) -> dict:
    """Child: builds the copy at root and times its K1a rollout kernel."""
    sys.path[:0] = [root, ROOT]
    import numpy as np
    import torch

    import chip_smoke as cs
    from quadruped_pympc_tamols_torch.ops import build
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk

    if not build.__file__.startswith(root):
        raise RuntimeError(f"imported {build.__file__}, not the copy at {root}")
    cfg = cs.main_cfg()
    shape = (cfg.mpc.horizon, sk.make_rs_plan(cfg, 1, "cpu").params_per_leg)
    lib_path = build.build_all()[("sampling_rs", *shape)]
    lib = sk.load_library(*shape)
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {"rollout_us": {}}
    for n in counts:
        plan = sk.make_rs_plan(cfg, n, dev)
        tick = cs.example_tick(cfg, plan)
        P = plan.num_parameters
        inc = torch.as_tensor(np.random.default_rng(0).standard_normal(P).astype(np.float32),
                              device=dev)
        args = sk.kernel_args(plan, tick, 5, 0)
        costs = torch.empty(n, device=dev)
        out = torch.empty(sk.OUT_WINNER + P, device=dev)
        argmin = torch.empty(1, dtype=torch.int64, device=dev)

        def launch():
            rc = lib.rs_launch(sk.ctypes.byref(args), plan.params_per_leg,
                               plan.windows.data_ptr(), inc.data_ptr(), None, None,
                               costs.data_ptr(), argmin.data_ptr(), out.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"rs_launch returned {rc}")

        for _ in range(10):
            launch()
        torch.cuda.synchronize()
        res["rollout_us"][n] = cs.pass_profile(launch, 1, False)["rollout"][1]
        if n == 10_000:
            res["costs_sha256"] = hashlib.sha256(costs.cpu().numpy().tobytes()).hexdigest()[:16]
    res["ptxas"] = cs.ptxas_of(lib_path.with_suffix(".log"), "rollout_kernel")
    res["sass_instructions"] = sass_instructions(lib_path)
    return res


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        counts = [int(x) for x in sys.argv[3].split(",")]
        print(json.dumps(time_copy(sys.argv[2], counts)), flush=True)
        return 0
    work = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.join(ROOT, PACKAGE, "_build", "variants"))
    os.makedirs(work, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for name, (_, counts) in VARIANTS.items():
        root = make_copy(work, name)
        child = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root,
                                ",".join(map(str, counts))], capture_output=True, text=True)
        if child.returncode != 0:
            raise RuntimeError(f"variant {name} failed:\n{child.stderr}")
        print(json.dumps({"variant": name, **json.loads(child.stdout.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
