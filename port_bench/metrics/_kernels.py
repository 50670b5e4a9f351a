"""Shared reading of a traced run's device records for the per-layer metrics."""
from __future__ import annotations

import re

K1F = re.compile(r"\bfleet_[a-z_]*kernel")


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def kernels(rec):
    """(name, duration us) of every kernel record of the traced window."""
    return [(n, d) for n, _, d in rec.device if not is_copy(n)]


def is_k1f(name: str) -> bool:
    return K1F.search(name) is not None


def idle_pct(rec):
    """The share of the traced window with no kernel or copy running on the card: one
    less the union of its device records over the window (the busy_s and window_s of
    the run's ``device``). The profiler's cost per launch lengthens the traced
    window, so this is an upper bound of the untraced run's idle share."""
    if rec.busy_us <= 0 or rec.window_us <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_us / rec.window_us)
