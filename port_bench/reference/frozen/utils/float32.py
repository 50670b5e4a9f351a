"""Float32 host arithmetic with the bits of the JAX package's CPU float32 path.

A few host values of the JAX package come out of XLA's float32 CPU code: the
MuJoCo crouch pose (``QuadrupedEnv.reset``), the heightmap ray origins and the
per-leg swing curves of the non-analytic IK path. XLA's CPU code calls libm's
``sinf`` / ``cosf`` / ``atan2f`` / ``powf`` (numpy's float32 versions differ in
the last bit) and fuses multiply-adds. These helpers reproduce that on small
arrays, so the port's plant starts from the same bits; a closed loop that starts
one ulp away diverges from its first step, and one ulp of a swing target is
~1e-5 N m of swing torque at the default gains.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

F32 = np.float32


def _libm():
    name = ctypes.util.find_library("m")
    if name is None:
        return None
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    for fn in ("sinf", "cosf"):
        getattr(lib, fn).restype = ctypes.c_float
        getattr(lib, fn).argtypes = [ctypes.c_float]
    for fn in ("atan2f", "powf"):
        getattr(lib, fn).restype = ctypes.c_float
        getattr(lib, fn).argtypes = [ctypes.c_float, ctypes.c_float]
    return lib


_LIBM = _libm()


def _map(fn, fallback, *args):
    arrays = np.broadcast_arrays(*(np.asarray(a, F32) for a in args))
    if _LIBM is None:
        return fallback(*arrays).astype(F32)
    out = np.array([fn(*map(float, t)) for t in zip(*(a.ravel() for a in arrays))], F32)
    return out.reshape(arrays[0].shape)


def sinf(x):
    return _map(_LIBM and _LIBM.sinf, np.sin, x)


def cosf(x):
    return _map(_LIBM and _LIBM.cosf, np.cos, x)


def atan2f(y, x):
    return _map(_LIBM and _LIBM.atan2f, np.arctan2, y, x)


def powf(x, y):
    return _map(_LIBM and _LIBM.powf, np.power, x, y)


def fmaf(a, b, c):
    """a * b + c of float32 operands rounded once to float32, as a fused
    multiply-add. The product is exact in float64; the float64 sum is exact up
    to its TwoSum error, which decides the only case the float64 rounding can
    spoil: a sum that lands exactly halfway between two float32 values."""
    a, b, c = (np.asarray(x, F32).astype(np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    r = s.astype(F32)
    other = np.nextafter(r, np.where(s > r, np.inf, -np.inf).astype(F32))
    tie = (err != 0) & (2.0 * s == r.astype(np.float64) + other.astype(np.float64))
    if np.any(tie):
        r = np.where(tie, np.nextafter(s, s + err).astype(F32), r)
    return r
