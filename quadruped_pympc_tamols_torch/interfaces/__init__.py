from .wb_interface import WBInterface
from .controller_interface import SRBDControllerInterface, recenter_state_and_reference
from .wrapper import ALL_OBSERVABLES, QuadrupedPyMPCWrapper

__all__ = ["WBInterface", "SRBDControllerInterface", "recenter_state_and_reference",
           "QuadrupedPyMPCWrapper", "ALL_OBSERVABLES"]
