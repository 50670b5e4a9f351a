"""PyTorch/CUDA port of the quadruped MPC framework.

A second package beside ``quadruped_pympc_tamols_tpu`` (the JAX reference). It
runs the sampling MPC (thousands of single-rigid-body rollouts solved on an
NVIDIA Hopper card by the hand-written kernels in ``ops/csrc/``), the gradient
family's nominal RTI-SQP (``controllers/gradient/``, torch ops replayed from
CUDA graphs), the whole-body planners and torque path around them behind
``interfaces.QuadrupedPyMPCWrapper``, the SRB closed-loop harness and the MuJoCo
simulation (``sim.run_simulation``, MuJoCo imported lazily). Entry points take
``device=`` and default to ``"cuda"``; ``device="cpu"`` runs the plain torch
versions.
"""
from .config import (
    GAITS,
    LEGS,
    ROBOTS,
    Config,
    CostWeights,
    GaitParams,
    GaitType,
    GradientParams,
    MPCParams,
    RobotParams,
    SamplingParams,
    SimParams,
    TamolsParams,
    make_config,
    replace_config,
    validate_config,
)
from .utils.legs import Legs

__version__ = "0.1.0"
