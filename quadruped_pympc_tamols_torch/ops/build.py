"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source in ``csrc/`` is compiled for sm_90a into a shared library with a plain
C interface, in its own nvcc process. The first use starts every missing build
at once, so a first use waits for the slowest source, not for the sum. A
library's file name carries a hash of its source, of the headers in ``csrc/``
and of the flags, so an edit to any of them rebuilds it. The libraries and the
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
SOURCES = ("sampling_rs", "sampling_softmax", "sampling_groups")  # csrc/<name>.cu, one library each

_LIBS: dict = {}


def _nvcc() -> str:
    candidates = [shutil.which("nvcc"),
                  os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is, or will be, built."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, all nvcc processes started
    together, and return ``{name: library path}``. Raises if any build fails."""
    paths = {name: _library_path(name) for name in SOURCES}
    todo = [name for name, lib in paths.items() if not lib.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        # The child keeps its own descriptor of the log; ours closes at once.
        with open(paths[name].with_suffix(".log"), "w") as log:
            tmp = paths[name].with_suffix(f".so.tmp{os.getpid()}")
            procs.append((name, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, proc in procs:
        if proc.wait() != 0:
            failed.append(f"{name}.cu:\n{paths[name].with_suffix('.log').read_text()}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        _LIBS[name] = ctypes.CDLL(str(build_all()[name]))
    return _LIBS[name]
