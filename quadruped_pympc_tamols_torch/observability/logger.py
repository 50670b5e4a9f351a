"""Observability: episode logging and profiling hooks.

Counterpart of ``quadruped_pympc_tamols_tpu/observability/logger.py`` (the
reference's logging stack): the controller observables dict
(quadruped_pympc_wrapper.py:205-243) is collected by the wrapper already; this
module adds

* EpisodeLogger — incremental, atomically-flushed trajectory recording of env +
  controller observables (the role of MatLogger's .mat export and the H5 recorder,
  simulation.py:78-376; saved as .npz which both numpy and MATLAB load, plus
  optional .mat via scipy).
* ProfileTimer — wall-clock section timing with percentile summaries (replaces the
  reference's ad-hoc prints, e.g. centroidal_nmpc_gait_adaptive.py:1220-1228) and a
  torch.profiler trace hook for on-device kernel inspection.
"""
from __future__ import annotations

import collections
import contextlib
import os
import tempfile
import time

import numpy as np


# Loggers registered for SIGINT flushing. Weak references: a finished logger is
# garbage-collected normally and silently drops out of the flush set. ONE handler
# is installed process-wide on first use and chains to the previous handler.
_SIGINT_LOGGERS: "weakref.WeakSet" = None  # type: ignore[assignment]
_SIGINT_PREV = None


def _install_sigint_flush():
    global _SIGINT_LOGGERS, _SIGINT_PREV
    import signal
    import weakref

    if _SIGINT_LOGGERS is not None:
        return
    _SIGINT_LOGGERS = weakref.WeakSet()
    _SIGINT_PREV = signal.getsignal(signal.SIGINT)

    def _handler(signum, frame):
        for logger in list(_SIGINT_LOGGERS):
            try:
                logger.flush()
            except Exception:
                pass
        if callable(_SIGINT_PREV):
            _SIGINT_PREV(signum, frame)
        # SIG_IGN / SIG_DFL predecessors: preserve "ignore" semantics (no raise).

    signal.signal(signal.SIGINT, _handler)


class EpisodeLogger:
    def __init__(self, path: str, flush_every: int = 50, flush_on_sigint: bool = False):
        self.path = path
        self.flush_every = flush_every
        self.buffers: dict[str, list] = collections.defaultdict(list)
        self._count = 0
        if flush_on_sigint:
            # Flush on Ctrl-C (the reference MatLogger's SIGINT hook,
            # simulation.py:214-230). One process-wide handler; weakly-referenced
            # loggers so per-episode instances don't accumulate.
            _install_sigint_flush()
            _SIGINT_LOGGERS.add(self)

    def log(self, t: float, env, wrapper) -> None:
        b = self.buffers
        b["time"].append(t)
        b["base_pos"].append(env.base_pos)
        b["base_lin_vel"].append(env.base_lin_vel)
        b["base_ori_euler_xyz"].append(env.base_ori_euler_xyz)
        b["base_ang_vel"].append(env.base_ang_vel)
        b["feet_pos"].append(np.asarray(env.feet_pos().data))
        b["joints_pos"].append(np.asarray(env.joints_pos().data))
        for name, value in wrapper.get_obs().items():
            b[f"ctrl/{name}"].append(np.asarray(value, dtype=np.float64))
        self._count += 1
        if self._count % self.flush_every == 0:
            self.flush()

    def flush(self) -> None:
        """Atomic write (tmp + rename), like the reference MatLogger
        (simulation.py:214-230)."""
        arrays = {k.replace("/", "__"): np.asarray(v) for k, v in self.buffers.items()}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
        os.close(fd)
        np.savez_compressed(tmp, **arrays)  # numpy keeps the name (ends with .npz)
        os.replace(tmp, self.path)

    def save_mat(self, path: str | None = None) -> None:
        """Optional MATLAB export (reference docs/MATLAB_LOGGING.md)."""
        from scipy.io import savemat

        arrays = {k.replace("/", "__"): np.asarray(v) for k, v in self.buffers.items()}
        savemat(path or self.path.replace(".npz", ".mat"), arrays)

    def save_h5(self, path: str | None = None) -> str:
        """HDF5 trajectory export, one dataset per observable (the role of
        gym_quadruped's H5Writer in the reference, simulation.py:536-554)."""
        import h5py

        path = path or self.path.replace(".npz", ".h5")
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.h5")
        os.close(fd)
        with h5py.File(tmp, "w") as f:
            for k, v in self.buffers.items():
                f.create_dataset(k, data=np.asarray(v), compression="gzip")
        os.replace(tmp, path)
        return path


class ProfileTimer:
    """Named wall-clock sections with p50/p99 summaries."""

    def __init__(self):
        self.samples: dict[str, list] = collections.defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append((time.perf_counter() - t0) * 1e3)

    def summary(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            a = np.asarray(xs)
            out[name] = dict(count=len(a), mean_ms=float(a.mean()),
                             p50_ms=float(np.percentile(a, 50)),
                             p99_ms=float(np.percentile(a, 99)))
        return out

    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """torch.profiler trace of the host and the card for per-kernel device
        timing, written to ``logdir`` as a Chrome trace (view with
        chrome://tracing, Perfetto or TensorBoard)."""
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
