"""The JAX package's outputs that some of the port's slowest CPU tests compare
with, recorded once into ``tests/fixtures/torch_jax_references.npz``.

Each entry is made by a ``jax_*`` function of the test module that reads it
(``RECORDERS``), from the same inputs the test gives the port; those functions
run the JAX package on the CPU as the tests did before the recording. ``python
tools/record_jax_references.py`` calls every recorder and rewrites the fixture
(~1 min); a test reads its entry with ``load(name)``. The JAX package is frozen,
so the recording changes only with jaxlib's float32 code.

Beside its outputs, each entry keeps ``digest(...)`` of the inputs it was made
from (the configuration, the ticks, the seed and the run's length), under
``digest/<key>``; a test builds the same inputs for the port and holds them to
the recorded digest with ``check_inputs`` before it compares, so that an edit of
the shared input helpers shows as a stale recording."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib

import numpy as np

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_jax_references.npz"
# (entry name, "module:function") of every recorder.
RECORDERS = (
    ("ddp", "test_torch_ddp:jax_ddp_references"),
    ("nominal_loop", "test_torch_gradient_loop:jax_closed_loop"),
    ("knobs", "test_torch_gradient_loop:jax_knob_references"),
    ("ladders", "test_torch_variants:jax_ladders"),
    ("kinodynamic_run", "test_torch_variants_loop:jax_kinodynamic_run"),
    ("parallel", "test_torch_parallel:jax_parallel_references"),
    ("long_horizon", "test_torch_long_horizon:jax_long_horizon_references"),
)
_CACHE: dict = {}


def load(name: str) -> dict:
    """Entry ``name`` as {key: array}; raises if the fixture lacks it."""
    if not _CACHE:
        with np.load(FIXTURE) as f:
            _CACHE.update({k: f[k] for k in f.files})
    prefix = name + "/"
    out = {k[len(prefix):]: v for k, v in _CACHE.items() if k.startswith(prefix)}
    if not out:
        raise KeyError(f"{name} is not in {FIXTURE.name}: run python tools/record_jax_references.py")
    return out


def _feed(h, value) -> None:
    if dataclasses.is_dataclass(value):
        value = json.dumps(dataclasses.asdict(value), sort_keys=True, default=repr)
    if isinstance(value, (tuple, list)):
        h.update(b"(%d" % len(value))
        for v in value:
            _feed(h, v)
        h.update(b")")
    elif isinstance(value, (np.ndarray, np.generic)):
        a = np.ascontiguousarray(value)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    else:
        h.update(repr(value).encode())


def digest(*values) -> np.ndarray:
    """The digest of a recording's inputs: arrays by dtype, shape and bytes,
    configurations (dataclasses) by their JSON text, sequences item by item and
    anything else by its repr; a 0-d string array, as the fixture stores it."""
    h = hashlib.sha256()
    _feed(h, values)
    return np.array(h.hexdigest())


def check_inputs(entry: dict, key: str, *values) -> None:
    """Raise unless ``values`` are the inputs ``entry`` recorded as ``digest/<key>``."""
    recorded = entry.get(f"digest/{key}")
    if recorded is None or recorded.item() != digest(*values).item():
        raise AssertionError(f"the inputs of {key} are not those of the recording in "
                             f"{FIXTURE.name}: run python tools/record_jax_references.py")
