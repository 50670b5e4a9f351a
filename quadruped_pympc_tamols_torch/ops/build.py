"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``csrc/`` is compiled for sm_90a into one shared library with a
plain C interface for each (horizon, parameters per leg) pair, passed as
``-DSAMPLING_H`` and ``-DSAMPLING_PL``, each in its own nvcc process. A pair's
libraries are built the first time a solver asks for the pair (``load``), all of
its sources at once, so a first use waits for the slowest build and builds no
other pair; ``build_all`` builds several pairs together. The kernels take
``2 <= H <= MAX_HORIZON`` and ``MIN_PARAMS_PER_LEG <= P_leg <=
MAX_PARAMS_PER_LEG`` (``check_pair``): every parametrization of
``controllers/sampling/splines.py`` with P = 4 * P_leg <= 1024, the Pallas
kernel's own bound, up to horizon 128. A library's file name carries a hash of
its source, of the headers in ``csrc/`` and of the flags (the pair included), so
an edit to any of them rebuilds it.
The libraries and the compiler's ``-Xptxas -v`` reports (``.log`` beside each,
ending with the build's wall seconds) go to the git-ignored
``quadruped_pympc_tamols_torch/_build/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# csrc/<name>.cu
SOURCES = ("sampling_rs", "sampling_softmax", "sampling_groups", "sampling_chain", "sampling_fleet")
# The bounds of check_pair: RS_MAX_H and RS_MAX_PL of csrc/sampling_common.cuh.
# P = 4 * P_leg <= 1024 is the Pallas kernel's own bound (quadruped_pympc_tamols_tpu/
# ops/rollout_pallas.py:219-223); H <= 128 keeps the chain kernel's staged windows
# (384 bytes a step) beside its largest arena in a block's 227 KB; a basis window
# of four weights needs P_leg >= 4.
MAX_HORIZON = 128
MAX_PARAMS_PER_LEG = 256
MIN_PARAMS_PER_LEG = 4
# The pairs of the three parametrizations at the flagship's horizon 12 with 2
# splines: cubic splines (the main path), linear splines and zero-order holds.
MAIN_PAIRS = ((12, 24), (12, 9), (12, 36))
_SECONDS = "nvcc wall seconds:"  # the last line of a build's log

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


def build_all(pairs=MAIN_PAIRS) -> dict:
    """Compile every (source, pair) of ``pairs`` whose library is missing, all nvcc
    processes started together, and return ``{(name, horizon, params_per_leg):
    library path}``. Raises if any build fails. Each build's log ends with the
    wall seconds of its nvcc process (``nvcc_seconds``)."""
    for pair in pairs:
        check_pair(*pair)
    paths = {(name, *shape): _library_path(name, *shape)
             for name in SOURCES for shape in pairs}
    todo = [key for key, lib in paths.items() if not lib.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()

    def compile_one(key):
        name, shape = key[0], key[1:]
        tmp = paths[key].with_suffix(f".so.tmp{os.getpid()}")
        with open(paths[key].with_suffix(".log"), "w") as log:
            t0 = time.perf_counter()
            rc = subprocess.run([nvcc, *_flags(*shape), "-o", str(tmp), str(CSRC / f"{name}.cu")],
                                stdout=log, stderr=subprocess.STDOUT).returncode
            log.write(f"{_SECONDS} {time.perf_counter() - t0:.3f}\n")
        if rc == 0:
            os.replace(tmp, paths[key])
        return rc

    with ThreadPoolExecutor(len(todo)) as pool:
        rcs = list(pool.map(compile_one, todo))
    failed = [f"{key[0]}.cu at (H, P_leg) = {key[1:]}:\n"
              f"{paths[key].with_suffix('.log').read_text()}"
              for key, rc in zip(todo, rcs) if rc != 0]
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return paths


def nvcc_seconds(name: str, horizon: int, params_per_leg: int) -> float | None:
    """Wall seconds of the nvcc process that built the pair's library of
    ``csrc/<name>.cu``, from its log; None where no build log holds them."""
    log = _library_path(name, horizon, params_per_leg).with_suffix(".log")
    if not log.exists():
        return None
    lines = log.read_text().splitlines()
    if not lines or not lines[-1].startswith(_SECONDS):
        return None
    return float(lines[-1].split()[-1])


def load(name: str, horizon: int, params_per_leg: int) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` for the pair, its pair's libraries
    built first if needed. Raises NotImplementedError for a pair beyond the
    kernels' bounds (``check_pair``)."""
    key = (name, horizon, params_per_leg)
    if key not in _LIBS:
        _LIBS[key] = ctypes.CDLL(str(build_all(((horizon, params_per_leg),))[key]))
    return _LIBS[key]


def check_pair(horizon: int, params_per_leg: int) -> None:
    """Raise NotImplementedError, naming the bound, for a (horizon, parameters per
    leg) pair the kernels cannot hold."""
    if not (2 <= horizon <= MAX_HORIZON
            and MIN_PARAMS_PER_LEG <= params_per_leg <= MAX_PARAMS_PER_LEG):
        raise NotImplementedError(
            f"the CUDA sampling kernels take 2 <= horizon <= {MAX_HORIZON} and "
            f"{MIN_PARAMS_PER_LEG} <= parameters per leg <= {MAX_PARAMS_PER_LEG} (P = 4 * P_leg "
            f"<= {4 * MAX_PARAMS_PER_LEG}, the Pallas kernel's bound; the chain kernel's "
            f"staged windows), not ({horizon}, {params_per_leg})")
