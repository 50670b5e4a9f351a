from .sampling_kernel import (
    RSPlan,
    TickInputs,
    load_library,
    make_rs_plan,
    sampling_iteration_reference,
    sampling_rs,
)
# The module, not its wrapper of the same name: ``ops.sampling_groups.sampling_groups``.
from . import sampling_groups
from .sampling_groups import GroupInputs, GroupPlan, group_iteration_reference, make_group_plan
from .sampling_fleet import (FleetTick, fleet_iteration, fleet_iteration_reference,
                             fleet_workspace)
from .sampling_softmax import (
    Knobs,
    make_knobs,
    sampling_chain,
    softmax_iteration,
    softmax_iteration_reference,
)

__all__ = [
    "FleetTick",
    "GroupInputs",
    "GroupPlan",
    "Knobs",
    "fleet_iteration",
    "fleet_iteration_reference",
    "fleet_workspace",
    "RSPlan",
    "TickInputs",
    "group_iteration_reference",
    "load_library",
    "make_group_plan",
    "make_knobs",
    "make_rs_plan",
    "sampling_chain",
    "sampling_groups",
    "sampling_iteration_reference",
    "sampling_rs",
    "softmax_iteration",
    "softmax_iteration_reference",
]
