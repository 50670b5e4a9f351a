"""Run one cell of the port's benchmark on the card this process runs on.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is resolved by name (``harness.py``); its
driver sets up the system, measures for ``--seconds``, then the reference judges
what the timed path produced. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``checks``: each number compared beside its limit);
the last lines of standard error give the same numbers. With ``--trace 0`` the
metrics are the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
The run exits with another code than 0, and prints no result, without a card, with
fewer cards than the cell asks for, or when JAX or the JAX package is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".port_bench_cache"
# Kernel caches at fixed paths inside the checkout, so that the first run of a cell
# there builds and later runs find what it built. The port's own nvcc libraries go
# to quadruped_pympc_tamols_torch/_build/ in the checkout.
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
# One process with few threads: the host's numpy and torch work is small.
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "1"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Context:
    """What a driver gets: the run's arguments, the cell's files, the device, and the
    harness's hooks (set-up's end, the memory peak, freeing the program, tracing).
    ``make_system`` replaces the driver's system under test (the control and the
    fault tests); ``cfg`` is the configuration as the reference's frozen copy of
    ``make_config`` resolves it."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, t_start: float,
                 make_system=None):
        import torch

        from .reference.frozen.config import make_config
        from .trace import Tracer
        self.config, self.traffic = cell.config, cell.traffic
        self.cfg = make_config(**cell.config["make_config"])
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device = torch.device(device)
        self.make_system = make_system
        self.t_start = t_start
        self.setup_s = None
        self.memory_peak_bytes = 0
        self.tracer = Tracer(self.sync, cell.driver.TRACE_SCOPE)
        self.log = log

    def sync(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark_setup_done(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start

    def read_memory_peak(self) -> None:
        import torch
        if self.device.type == "cuda":
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def execute(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
            make_system=None) -> dict:
    """Run the cell once on ``device`` and return the result object (without the
    harness's look for a card: tests run it on the CPU)."""
    from .guard import forbidden_modules
    from .trace import breakdown

    ctx = Context(cell, seed, seconds, trace, device, t_start, make_system)
    r = cell.driver.run(ctx)
    found = forbidden_modules()
    if found:
        raise ImportError(f"loaded by the run: {', '.join(found)}")
    # The mix's ``limits`` name the numbers compared; the judge's others are logged.
    limits = cell.traffic["limits"]
    checks = {k: {"value": float(r["checks"][k]), "limit": float(v)} for k, v in limits.items()}
    for k, v in r["checks"].items():
        if k not in limits:
            ctx.log(f"reading {k}: {float(v)!r} (not compared)")
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": _device_name(ctx.device), "count": 1,
           "memory_peak_bytes": ctx.memory_peak_bytes}
    out = {"correct": correct, "attempted": int(r["attempted"]), "failed": int(r["failed"])}
    if trace:
        rec = r["records"]
        run = {"cfg": ctx.cfg, "counts": r["counts"]}
        metrics = {}
        for entry, mod in cell.per_layer:
            v = mod.read(rec, run)
            if v is not None:
                metrics[entry["name"]] = {"value": float(v), "unit": entry["unit"]}
        dev["busy_s"] = rec.busy_us * 1e-6
        dev["window_s"] = rec.window_us * 1e-6
        out.update(metrics=metrics, device=dev, breakdown=breakdown(rec))
    else:
        values = dict(r["metrics"], setup_s=ctx.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
        out.update(metrics=metrics, device=dev)
    out["checks"] = checks
    return out


def _device_name(device) -> str:
    import torch
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def _power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return p.stdout.strip().replace("\n", "; ") or f"not read (exit {p.returncode})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import harness
    cell = harness.resolve(args.workload)
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"this cell needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(torch.device("cuda:0"))
    print(f"device: {torch.cuda.get_device_name(0)}; devices: {torch.cuda.device_count()}; "
          f"nvidia-smi name, power limit: {_power_limit()}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 for float32 matmuls: "
          f"{torch.backends.cuda.matmul.allow_tf32} (cuDNN {torch.backends.cudnn.allow_tf32}), "
          f"float32 matmul precision {torch.get_float32_matmul_precision()}", flush=True)
    print(f"workload {args.workload}: config {cell.workload['config']}, traffic "
          f"{cell.workload['traffic']}, driver {cell.traffic['driver']}, seed {args.seed}, "
          f"{args.seconds} s, trace {args.trace}", flush=True)
    out = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_START)
    for k, c in out["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    log(f"correct: {out['correct']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
