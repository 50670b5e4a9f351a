"""ctypes wrapper over the native seq-locked shared-memory control bus.

Counterpart of ``quadruped_pympc_tamols_tpu/runtime/control_bus.py``, with the
same block: the reference's 75-double layout (ros2/run_controller.py:50-71), GRFs
(12), footholds (12), joint position/velocity/acceleration targets (36), predicted
base state (12), best step frequency (1) and MPC timing (2). The C++ core is the
port's own copy of ``control_bus.cpp``; it is built with g++ at first use into
``quadruped_pympc_tamols_torch/_build/``, the library named by the hash of the
source and flags, so an edit rebuilds it. A writer of either package and a reader
of the other share a bus.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PAYLOAD_DOUBLES = 75

# Field offsets inside the payload.
OFF_GRF = 0
OFF_FOOTHOLDS = 12
OFF_JOINT_POS = 24
OFF_JOINT_VEL = 36
OFF_JOINT_ACC = 48
OFF_PREDICTED = 60
OFF_FREQ = 72
OFF_TIMING = 73

SOURCE = Path(__file__).resolve().parent / "control_bus.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")
GXX_LIBS = ("-lrt", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """Where the bus library is, or will be, built."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_DIR / f"libcontrol_bus_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the bus with g++ unless its library exists; raises if g++ fails."""
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".so.tmp{os.getpid()}")
        r = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), *GXX_LIBS],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{r.stderr}")
        os.replace(tmp, so)
    return so


def _load_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.bus_open.restype = ctypes.c_void_p
        lib.bus_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32, ctypes.c_int]
        lib.bus_close.argtypes = [ctypes.c_void_p]
        lib.bus_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_uint32]
        lib.bus_read.restype = ctypes.c_uint64
        lib.bus_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
                                 ctypes.c_uint32]
        lib.bus_seq.restype = ctypes.c_uint64
        lib.bus_seq.argtypes = [ctypes.c_void_p]
        lib.bus_wait_new.restype = ctypes.c_uint64
        lib.bus_wait_new.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                     ctypes.POINTER(ctypes.c_double), ctypes.c_uint32,
                                     ctypes.c_int64]
        _lib = lib
        return lib


class ControlBus:
    """Single-writer / many-reader latest-value channel over POSIX shm."""

    def __init__(self, name: str, create: bool, n_doubles: int = PAYLOAD_DOUBLES):
        self.lib = _load_lib()
        self.n = n_doubles
        self._buf = (ctypes.c_double * n_doubles)()
        self.handle = self.lib.bus_open(name.encode(), n_doubles, 1 if create else 0)
        if not self.handle:
            raise OSError(f"failed to open control bus {name!r}")
        self.name = name

    def write(self, values: np.ndarray) -> None:
        arr = np.ascontiguousarray(values, dtype=np.float64).reshape(self.n)
        self.lib.bus_write(self.handle, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                           self.n)

    def read(self) -> tuple[int, np.ndarray]:
        seq = self.lib.bus_read(self.handle, self._buf, self.n)
        return seq, np.asarray(self._buf, dtype=np.float64).copy()

    def wait_new(self, last_seq: int, timeout_s: float = 0.1) -> tuple[int, np.ndarray | None]:
        seq = self.lib.bus_wait_new(self.handle, last_seq, self._buf, self.n,
                                    int(timeout_s * 1e6))
        if seq == 0:
            return 0, None
        return seq, np.asarray(self._buf, dtype=np.float64).copy()

    @property
    def seq(self) -> int:
        return self.lib.bus_seq(self.handle)

    def close(self):
        if self.handle:
            self.lib.bus_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def pack_control_block(grfs, footholds, joint_pos, joint_vel, joint_acc, predicted_state,
                       best_freq, t_solve_ms, t_total_ms) -> np.ndarray:
    out = np.zeros(PAYLOAD_DOUBLES)
    out[OFF_GRF:OFF_GRF + 12] = np.asarray(grfs).reshape(12)
    out[OFF_FOOTHOLDS:OFF_FOOTHOLDS + 12] = np.asarray(footholds).reshape(12)
    out[OFF_JOINT_POS:OFF_JOINT_POS + 12] = np.asarray(joint_pos).reshape(12)
    out[OFF_JOINT_VEL:OFF_JOINT_VEL + 12] = np.asarray(joint_vel).reshape(12)
    out[OFF_JOINT_ACC:OFF_JOINT_ACC + 12] = np.asarray(joint_acc).reshape(12)
    out[OFF_PREDICTED:OFF_PREDICTED + 12] = np.asarray(predicted_state).reshape(12)
    out[OFF_FREQ] = best_freq
    out[OFF_TIMING] = t_solve_ms
    out[OFF_TIMING + 1] = t_total_ms
    return out


def unpack_control_block(block: np.ndarray) -> dict:
    return dict(
        grfs=block[OFF_GRF:OFF_GRF + 12].reshape(4, 3),
        footholds=block[OFF_FOOTHOLDS:OFF_FOOTHOLDS + 12].reshape(4, 3),
        joint_pos=block[OFF_JOINT_POS:OFF_JOINT_POS + 12].reshape(4, 3),
        joint_vel=block[OFF_JOINT_VEL:OFF_JOINT_VEL + 12].reshape(4, 3),
        joint_acc=block[OFF_JOINT_ACC:OFF_JOINT_ACC + 12].reshape(4, 3),
        predicted_state=block[OFF_PREDICTED:OFF_PREDICTED + 12],
        best_freq=float(block[OFF_FREQ]),
        t_solve_ms=float(block[OFF_TIMING]),
        t_total_ms=float(block[OFF_TIMING + 1]),
    )
