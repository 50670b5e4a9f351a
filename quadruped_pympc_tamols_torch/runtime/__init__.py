"""The deployment runtime (counterpart of the JAX package's ``runtime``): the control
node and its MPC modes, the native shared-memory control bus, the ROS2 message
schemas and node (behind an rclpy import guard), the simulator node (MuJoCo, on
the CPU) and the tuning console."""
from .console import Console
from .control_bus import ControlBus, pack_control_block, unpack_control_block
from .controller_node import ControllerNode
from .ros2_node import (
    BaseState,
    BlindState,
    ControllerBridge,
    ControlSignal,
    LocalTransport,
    QuadrupedPyMPCRosNode,
    RobotStateAssembler,
    TimeDebug,
    TrajectoryGenerator,
    pack_control_signal,
    pack_trajectory_generator,
    rclpy_available,
)
from .sim_node import SimulatorNode

__all__ = [
    "Console",
    "ControlBus",
    "pack_control_block",
    "unpack_control_block",
    "ControllerNode",
    "BaseState",
    "BlindState",
    "ControllerBridge",
    "ControlSignal",
    "LocalTransport",
    "QuadrupedPyMPCRosNode",
    "RobotStateAssembler",
    "SimulatorNode",
    "TimeDebug",
    "TrajectoryGenerator",
    "pack_control_signal",
    "pack_trajectory_generator",
    "rclpy_available",
]
