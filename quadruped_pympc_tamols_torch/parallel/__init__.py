"""The on-device scenario fleet and the multi-device tier (counterpart of the JAX
package's ``parallel``).

``scenario_engine``: S closed loops a tick on one device (K1f). ``sharded``: the
sample-sharded solver and the multi-chip fleet step over a ("scenario",
"sample") mesh of ranks on torch.distributed. ``multihost``: the same mesh over
hosts, its process group and its local launcher.
"""
from .multihost import (
    find_free_port,
    init_multihost,
    launch_local_multihost,
    make_multihost_fleet,
    multihost_mesh,
    run_fleet,
    scaling_table,
)
from .scenario_engine import (
    METRICS,
    ScenarioState,
    init_scenario_state,
    make_scenario_step,
    make_terrain_adapter,
    make_terrain_generator,
)
from .sharded import Mesh, make_multichip_step, make_sharded_sampling_solver, scenario_mesh

__all__ = [
    "METRICS",
    "Mesh",
    "ScenarioState",
    "make_scenario_step",
    "init_scenario_state",
    "make_terrain_adapter",
    "make_terrain_generator",
    "make_sharded_sampling_solver",
    "make_multichip_step",
    "scenario_mesh",
    "find_free_port",
    "init_multihost",
    "launch_local_multihost",
    "make_multihost_fleet",
    "multihost_mesh",
    "run_fleet",
    "scaling_table",
]
