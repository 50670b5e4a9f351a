"""The on-device scenario fleet (counterpart of the JAX package's ``parallel``).

``scenario_engine`` is ported. The JAX package's sample-axis sharded solver and
multi-chip fleet step (``parallel/sharded.py``, ``parallel/multihost.py``) are
not yet: ``make_sharded_sampling_solver``, ``make_multichip_step`` and
``scenario_mesh`` raise NotImplementedError naming the ROADMAP item that ports
them.
"""
from .scenario_engine import (
    METRICS,
    ScenarioState,
    init_scenario_state,
    make_scenario_step,
    make_terrain_adapter,
    make_terrain_generator,
)

_NEXT_SLICE = ("is not ported yet: parallel/sharded.py and parallel/multihost.py on "
               "torch.distributed are ROADMAP queue 1 item 5")


def make_sharded_sampling_solver(*args, **kwargs):
    """Not ported yet (ROADMAP queue 1 item 5)."""
    raise NotImplementedError(f"make_sharded_sampling_solver {_NEXT_SLICE}")


def make_multichip_step(*args, **kwargs):
    """Not ported yet (ROADMAP queue 1 item 5)."""
    raise NotImplementedError(f"make_multichip_step {_NEXT_SLICE}")


def scenario_mesh(*args, **kwargs):
    """Not ported yet (ROADMAP queue 1 item 5)."""
    raise NotImplementedError(f"scenario_mesh {_NEXT_SLICE}")


__all__ = [
    "METRICS",
    "ScenarioState",
    "make_scenario_step",
    "init_scenario_state",
    "make_terrain_adapter",
    "make_terrain_generator",
    "make_sharded_sampling_solver",
    "make_multichip_step",
    "scenario_mesh",
]
