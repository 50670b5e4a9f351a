"""Array-first per-leg container.

``Legs`` wraps one array (numpy or torch) of shape (4, ...) in leg order
(FL, FR, RL, RR) with named accessors for host-side code. Counterpart of
``quadruped_pympc_tamols_tpu/utils/legs.py`` without the pytree registration.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..config import LEGS

_LEG_INDEX = {name: i for i, name in enumerate(LEGS)}


@dataclasses.dataclass
class Legs:
    """Stacked per-leg data: ``data`` has shape (4, ...) ordered FL, FR, RL, RR."""

    data: Any

    @classmethod
    def zeros(cls, shape=(3,), dtype=np.float32) -> "Legs":
        return cls(np.zeros((4,) + tuple(shape), dtype=dtype))

    @property
    def FL(self):
        return self.data[0]

    @property
    def FR(self):
        return self.data[1]

    @property
    def RL(self):
        return self.data[2]

    @property
    def RR(self):
        return self.data[3]

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.data[_LEG_INDEX[key]]
        return self.data[key]

    def __repr__(self):
        return f"Legs(FL={self.FL}, FR={self.FR}, RL={self.RL}, RR={self.RR})"
