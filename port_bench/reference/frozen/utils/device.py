"""Device selection for the port's entry points, and constants cached on a device."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.

    Entry points default to ``"cuda"``; without a card they raise instead of
    quietly running on the CPU. Pass ``device="cpu"`` to run the plain torch path.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the plain "
                           "torch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


_CONSTANTS: dict = {}


def device_constant(values, device, dtype=torch.float32) -> torch.Tensor:
    """``values`` (numpy or nested lists) as a tensor on ``device``, made once and
    cached: code that runs inside a CUDA-graph capture must not copy from the host,
    and a graph's warm-up runs fill the cache before the capture."""
    arr = np.ascontiguousarray(values, dtype=torch.empty((), dtype=dtype).numpy().dtype)
    key = (arr.tobytes(), arr.shape, dtype, str(torch.device(device)))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(arr, device=device)
    return t
