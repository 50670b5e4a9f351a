from .ik_solvers import NumericIK, QPIK
from .leg_ik import LegKinematics

__all__ = ["LegKinematics", "NumericIK", "QPIK"]
