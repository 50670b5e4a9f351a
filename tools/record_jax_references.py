#!/usr/bin/env python3
"""Record the JAX package's outputs that the port's slowest CPU tests compare with.

    python tools/record_jax_references.py

Runs every recorder of ``tests/jax_references.py:RECORDERS`` (a ``jax_*``
function of a port test module: the DDP solves and controllers of
``test_torch_ddp.py``, the nominal 1 s SRB walk of ``test_torch_gradient_loop.py``,
the soft-QP ladders of ``test_torch_variants.py``, the kinodynamic MuJoCo run
of ``test_torch_variants_loop.py``, the sharded solves of ``test_torch_parallel.py``
and the long-horizon solves of ``test_torch_long_horizon.py``) with the JAX
package on the CPU, as pytest runs it, and writes
``tests/fixtures/torch_jax_references.npz``.
"""
from __future__ import annotations

import importlib
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import conftest  # noqa: F401  (JAX on the CPU, as under pytest)
    import jax_references

    arrays = {}
    for name, target in jax_references.RECORDERS:
        module, fn = target.split(":")
        t0 = time.perf_counter()
        entry = getattr(importlib.import_module(module), fn)()
        arrays.update({f"{name}/{k}": np.asarray(v) for k, v in entry.items()})
        print(f"{name}: {len(entry)} arrays in {time.perf_counter() - t0:.1f} s", flush=True)
    np.savez_compressed(jax_references.FIXTURE, **arrays)
    print(f"wrote {jax_references.FIXTURE} ({jax_references.FIXTURE.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
