from .splines import make_spline_basis, num_params_per_leg
from .sampling_mpc import (FleetSamplingState, FleetSolveOutput, SamplingMPC, SamplingState,
                           SolveOutput, host_summary, make_fleet_sampling_solver,
                           make_sampling_solver)
from .gait_adaptive import (GaitAdaptiveSamplingMPC, group_operators, host_best_freq, leg_basis,
                            make_gait_adaptive_solver, timer_sequence)

__all__ = [
    "make_spline_basis",
    "num_params_per_leg",
    "FleetSamplingState",
    "FleetSolveOutput",
    "GaitAdaptiveSamplingMPC",
    "SamplingMPC",
    "SamplingState",
    "SolveOutput",
    "group_operators",
    "host_best_freq",
    "host_summary",
    "leg_basis",
    "make_fleet_sampling_solver",
    "make_gait_adaptive_solver",
    "make_sampling_solver",
    "timer_sequence",
]
