"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``csrc/`` is compiled for sm_90a into one shared library with a
plain C interface for each (horizon, parameters per leg) pair of
``INSTANTIATIONS``, passed as ``-DSAMPLING_H`` and ``-DSAMPLING_PL``, each in its
own nvcc process. The first use starts every missing build at once, so a first
use waits for the slowest build, not for the sum. A library's file name carries
a hash of its source, of the headers in ``csrc/`` and of the flags (the pair
included), so an edit to any of them rebuilds it. The libraries and the
compiler's ``-Xptxas -v`` reports (``.log`` beside each) go to the git-ignored
``quadruped_pympc_tamols_torch/_build/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# csrc/<name>.cu
SOURCES = ("sampling_rs", "sampling_softmax", "sampling_groups", "sampling_chain", "sampling_fleet")
# The (horizon, parameters per leg) pairs every source is built for: at horizon 12
# with 2 splines, cubic splines (the main path), linear splines and zero-order
# holds (splines.num_params_per_leg). One line adds a pair.
INSTANTIATIONS = (
    (12, 24),  # cubic_spline
    (12, 9),  # linear_spline
    (12, 36),  # zero_order
)

_LIBS: dict = {}


def _nvcc() -> str:
    candidates = [shutil.which("nvcc"),
                  os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _flags(horizon: int, params_per_leg: int) -> tuple:
    return NVCC_FLAGS + (f"-DSAMPLING_H={horizon}", f"-DSAMPLING_PL={params_per_leg}")


def _library_path(name: str, horizon: int, params_per_leg: int) -> Path:
    """Where the library of ``csrc/<name>.cu`` for the pair is, or will be, built."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_flags(horizon, params_per_leg)).encode())
    return BUILD_DIR / f"lib{name}_h{horizon}_pl{params_per_leg}_{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every (source, pair) whose library is missing, all nvcc processes
    started together, and return ``{(name, horizon, params_per_leg): library
    path}``. Raises if any build fails."""
    paths = {(name, *shape): _library_path(name, *shape)
             for name in SOURCES for shape in INSTANTIATIONS}
    todo = [key for key, lib in paths.items() if not lib.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for key in todo:
        name, shape = key[0], key[1:]
        # The child keeps its own descriptor of the log; ours closes at once.
        with open(paths[key].with_suffix(".log"), "w") as log:
            tmp = paths[key].with_suffix(f".so.tmp{os.getpid()}")
            procs.append((key, tmp, subprocess.Popen(
                [nvcc, *_flags(*shape), "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for key, tmp, proc in procs:
        if proc.wait() != 0:
            failed.append(f"{key[0]}.cu at (H, P_leg) = {key[1:]}:\n"
                          f"{paths[key].with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, paths[key])
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return paths


def load(name: str, horizon: int, params_per_leg: int) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` for the pair, built first if
    needed. Raises NotImplementedError for a pair not in ``INSTANTIATIONS``."""
    check_instantiated(horizon, params_per_leg)
    key = (name, horizon, params_per_leg)
    if key not in _LIBS:
        _LIBS[key] = ctypes.CDLL(str(build_all()[key]))
    return _LIBS[key]


def check_instantiated(horizon: int, params_per_leg: int) -> None:
    """Raise NotImplementedError, naming the built pairs, for a pair not in
    ``INSTANTIATIONS``."""
    if (horizon, params_per_leg) not in INSTANTIATIONS:
        raise NotImplementedError(
            f"the CUDA sampling kernels are built for (horizon, parameters per leg) in "
            f"{list(INSTANTIATIONS)}, not ({horizon}, {params_per_leg}); add the pair to "
            "ops/build.py:INSTANTIATIONS to build it")
