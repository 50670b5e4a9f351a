from .periodic import (GaitState, PeriodicGaitGenerator, advance_phase, contact_from_phase,
                       contact_sequence, contact_sequence_torch, make_timer_dts)
from .foothold_reference import (FootholdReferenceGenerator, raibert_footholds,
                                 raibert_footholds_torch)
from .swing import (SwingTrajectoryController, bezier_swing_refs, bezier_swing_refs_torch,
                    make_swing_ik_step, swing_refs_np)
from .terrain import TerrainEstimator, estimate_terrain, estimate_terrain_step

__all__ = [
    "GaitState",
    "advance_phase",
    "contact_from_phase",
    "PeriodicGaitGenerator",
    "contact_sequence",
    "contact_sequence_torch",
    "make_timer_dts",
    "FootholdReferenceGenerator",
    "raibert_footholds",
    "raibert_footholds_torch",
    "SwingTrajectoryController",
    "bezier_swing_refs",
    "bezier_swing_refs_torch",
    "make_swing_ik_step",
    "swing_refs_np",
    "TerrainEstimator",
    "estimate_terrain",
    "estimate_terrain_step",
]
