"""ROS2 deployment shim: message schemas + an import-guarded rclpy node.

Counterpart of ``quadruped_pympc_tamols_tpu/runtime/ros2_node.py``. Mirrors the
reference's real-robot entry point (ros2/run_controller.py:97-107):
subscribe ``/base_state`` (dls2_interface/BaseState) and ``/blind_state``
(BlindState), publish ``/quadruped_pympc_torques`` (ControlSignal),
``/trajectory_generator`` (TrajectoryGenerator) and ``/time_debug`` (TimeDebug).

The message LAYOUTS are reproduced as plain dataclasses
(reference ros2/msgs_ws/src/dls2_interface/msg/*.msg) so the assembly and packing
logic is testable without ROS; when rclpy + dls2_interface are installed,
``QuadrupedPyMPCRosNode`` copies fields one-to-one between the wire messages and
these schemas. Everything below the message boundary is the same ControllerNode /
WBInterface stack the simulator uses.

Unlike the reference — which rebuilds MuJoCo kinematics from the estimator state
with collisions disabled (run_controller.py:453-465) — the state assembler uses
the analytic leg kinematics (kinematics/leg_ik.py, host numpy in float64 where
the JAX package's runs in float32): FK, Jacobians and foot velocities from joint
states, no physics engine in the control path. The controller's MPC runs on
``device`` ("cuda" unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np

from ..config import Config
from ..kinematics.leg_ik import LegKinematics
from ..utils.frames import euler_xyz_to_rot_np
from ..utils.legs import Legs
from .controller_node import ControllerNode

LEG_ORDER = ("FL", "FR", "RL", "RR")


def rclpy_available() -> bool:
    try:
        import rclpy  # noqa: F401
        return True
    except Exception:
        return False


# ---------------------------------------------------------------------------
# Message schemas (field-for-field with dls2_interface/msg/*.msg)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Pose:  # msg/Pose.msg
    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    orientation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))  # (w, x, y, z)


@dataclasses.dataclass
class Screw:  # msg/Screw.msg
    linear: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    angular: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))


@dataclasses.dataclass
class BaseState:  # msg/BaseState.msg
    frame_id: str = "world"
    sequence_id: int = 0
    timestamp: float = 0.0
    robot_name: str = ""
    pose: Pose = dataclasses.field(default_factory=Pose)
    velocity: Screw = dataclasses.field(default_factory=Screw)
    acceleration: Screw = dataclasses.field(default_factory=Screw)
    stance_status: List[bool] = dataclasses.field(default_factory=lambda: [True] * 4)


@dataclasses.dataclass
class BlindState:  # msg/BlindState.msg
    frame_id: str = "base"
    sequence_id: int = 0
    timestamp: float = 0.0
    robot_name: str = ""
    joints_name: List[str] = dataclasses.field(default_factory=list)
    joints_position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))
    joints_velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))
    joints_acceleration: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))
    joints_effort: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(12))
    joints_temperature: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))
    feet_contact: List[bool] = dataclasses.field(default_factory=lambda: [True] * 4)
    current_feet_positions: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))


@dataclasses.dataclass
class ControlSignal:  # msg/ControlSignal.msg
    frame_id: str = "base"
    sequence_id: int = 0
    timestamp: float = 0.0
    torques: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(12))
    signal_reconstruction_method: int = 0


@dataclasses.dataclass
class TrajectoryGenerator:  # msg/TrajectoryGenerator.msg
    frame_id: str = "world"
    sequence_id: int = 0
    timestamp: float = 0.0
    com_pose: Pose = dataclasses.field(default_factory=Pose)
    com_vel: Screw = dataclasses.field(default_factory=Screw)
    com_acc: Screw = dataclasses.field(default_factory=Screw)
    joints_position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))
    joints_velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))
    joints_acceleration: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))
    joints_effort: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(12))
    kp: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(12))
    kd: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(12))
    wrench: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(6))
    stance_legs: List[bool] = dataclasses.field(default_factory=lambda: [True] * 4)
    nominal_touch_down: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))
    touch_down: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(12))
    swing_period: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(4))
    normal_force_max: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4))
    normal_force_min: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4))


@dataclasses.dataclass
class TimeDebug:  # msg/TimeDebug.msg
    time_mpc: float = 0.0
    time_wbc: float = 0.0


@dataclasses.dataclass
class FeetContactState:  # msg/FeetContactState.msg
    frame_id: str = "world"
    sequence_id: int = 0
    timestamp: float = 0.0
    robot_name: str = ""
    feet_name: List[str] = dataclasses.field(default_factory=list)
    linear_grf_feet: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))
    angular_grf_feet: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(12))


@dataclasses.dataclass
class Imu:  # msg/Imu.msg
    frame_id: str = "base"
    sequence_id: int = 0
    timestamp: float = 0.0
    orientation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))
    orientation_covariance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(9))
    angular_velocity: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    angular_velocity_covariance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(9))
    linear_acceleration: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    linear_acceleration_covariance: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(9))


def quat_wxyz_to_euler_xyz(q) -> np.ndarray:
    """(w, x, y, z) -> intrinsic xyz Euler angles (roll, pitch, yaw)."""
    w, x, y, z = float(q[0]), float(q[1]), float(q[2]), float(q[3])
    roll = math.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = math.asin(max(-1.0, min(1.0, 2 * (w * y - z * x))))
    yaw = math.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return np.array([roll, pitch, yaw])


class RobotStateAssembler:
    """(BaseState, BlindState) -> the ControllerNode state-provider dict.

    The analytic leg kinematics supply everything the reference pulled from its
    collision-free MuJoCo pass (run_controller.py:453-465): world feet positions,
    world foot Jacobians, foot velocities and hip positions. Bias forces and leg
    mass matrices are zeroed (additive feedforward terms; the real-robot joint PD
    runs onboard, reference :85-91)."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.kin = LegKinematics(cfg.robot)

    def assemble(self, base: BaseState, blind: BlindState) -> dict:
        rpy = quat_wxyz_to_euler_xyz(base.pose.orientation)
        base_pos = np.asarray(base.pose.position, float)
        R = euler_xyz_to_rot_np(rpy)
        q = np.asarray(blind.joints_position, float).reshape(4, 3)
        qd = np.asarray(blind.joints_velocity, float).reshape(4, 3)

        feet_hip = self.kin.fk_all(q)  # hip-frame
        jac_hip = self.kin.jacobians(q)  # (4, 3, 3) hip-frame
        hips = self.kin.hips_world(base_pos, R)
        feet_world = hips + feet_hip @ R.T
        jac_world = np.einsum("ij,ljk->lik", R, jac_hip)
        v_base = np.asarray(base.velocity.linear, float)
        w_base = np.asarray(base.velocity.angular, float)
        feet_vel = (v_base[None, :]
                    + np.cross(w_base[None, :], feet_world - base_pos[None, :])
                    + np.einsum("lik,lk->li", jac_world, qd))

        return {
            "com_pos": base_pos,
            "base_pos": base_pos,
            "base_lin_vel": v_base,
            "base_ori_euler_xyz": rpy,
            "base_ang_vel": w_base,
            "feet_pos": Legs(feet_world),
            "hip_pos": Legs(hips),
            "joints_pos": Legs(q),
            "joints_vel": Legs(qd),
            "feet_jac": Legs(jac_world),
            "feet_jac_dot": Legs(np.zeros((4, 3, 3))),
            "feet_vel": Legs(feet_vel),
            "legs_qfrc_bias": Legs(np.zeros((4, 3))),
            "legs_mass_matrix": Legs(np.zeros((4, 3, 3))),
            "legs_qfrc_passive": Legs(np.zeros((4, 3))),
            "heightmaps": None,
        }


class LocalTransport:
    """In-process pub/sub with DDS-like topic semantics (depth-1, latest wins).

    Stands in for the rclpy publisher/subscription plumbing so the controller
    bridge and the simulator node can be wired back-to-back and tested without a
    ROS2 installation — the message objects crossing it are the dataclass schemas
    above, i.e. exactly what the wire conversion in QuadrupedPyMPCRosNode
    produces/consumes."""

    def __init__(self):
        self._subs: dict = {}
        self.published: dict = {}  # topic -> count (observability/tests)

    def subscribe(self, topic: str, callback):
        self._subs.setdefault(topic, []).append(callback)

    def publish(self, topic: str, msg):
        self.published[topic] = self.published.get(topic, 0) + 1
        for cb in self._subs.get(topic, ()):
            cb(msg)


class ControllerBridge:
    """Transport-agnostic controller node (reference ros2/run_controller.py:97-560):
    subscribes ``/base_state`` + ``/blind_state``, and on every :meth:`tick`
    publishes ``/quadruped_pympc_torques`` (ControlSignal),
    ``/trajectory_generator`` (TrajectoryGenerator) and ``/time_debug`` (TimeDebug).

    QuadrupedPyMPCRosNode adds the rclpy wire conversion around this; the loopback
    test pairs it with SimulatorNode over a LocalTransport."""

    def __init__(self, cfg: Config, transport, mpc_mode: str = "inline",
                 rate_hz: float = 250.0, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.transport = transport
        self.rate_hz = rate_hz
        self.assembler = RobotStateAssembler(cfg)
        self._base: Optional[BaseState] = None
        self._blind: Optional[BlindState] = None
        self._seq = 0
        feet0 = Legs(np.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                                 [-0.25, 0.15, 0], [-0.25, -0.15, 0]], float))
        self.controller = ControllerNode(cfg, feet0, mpc_mode=mpc_mode, seed=seed,
                                         device=device)
        transport.subscribe("/base_state", self._on_base)
        transport.subscribe("/blind_state", self._on_blind)

    def _on_base(self, msg: BaseState):
        self._base = msg

    def _on_blind(self, msg: BlindState):
        self._blind = msg

    def tick(self, ref_base_lin_vel, ref_base_ang_vel, now: float | None = None):
        """One control tick; returns True when a command was published."""
        # Refuse to act before the first state messages (reference :449-450).
        if self._base is None or self._blind is None:
            return False
        t0 = time.perf_counter()
        s = self.assembler.assemble(self._base, self._blind)
        tau, des_q, des_qd = self.controller.control_tick(
            lambda: s, np.asarray(ref_base_lin_vel), np.asarray(ref_base_ang_vel),
            1.0 / self.rate_hz)
        stamp = time.time() if now is None else now
        self.transport.publish("/quadruped_pympc_torques",
                               pack_control_signal(tau, self._seq, stamp))
        self.transport.publish("/trajectory_generator",
                               pack_trajectory_generator(self.controller, des_q,
                                                         des_qd, self._seq, stamp))
        self.transport.publish("/time_debug", TimeDebug(
            time_mpc=self.controller._solve_ms / 1e3,
            time_wbc=time.perf_counter() - t0))
        self._seq += 1
        return True

    def shutdown(self):
        self.controller.shutdown()


def pack_control_signal(tau: Legs, seq_id: int, timestamp: float) -> ControlSignal:
    return ControlSignal(sequence_id=seq_id, timestamp=timestamp,
                         torques=np.asarray(tau.data, float).reshape(12).copy())


def pack_trajectory_generator(node: ControllerNode, des_q: Legs, des_qd: Legs,
                              seq_id: int, timestamp: float) -> TrajectoryGenerator:
    cfg = node.cfg
    stc = node.wb.stc
    return TrajectoryGenerator(
        sequence_id=seq_id, timestamp=timestamp,
        joints_position=np.asarray(des_q.data, float).reshape(12).copy(),
        joints_velocity=np.asarray(des_qd.data, float).reshape(12).copy(),
        kp=np.full(12, cfg.sim.impedance_joint_position_gain, float),
        kd=np.full(12, cfg.sim.impedance_joint_velocity_gain, float),
        stance_legs=[bool(c) for c in node.wb.current_contact],
        nominal_touch_down=np.asarray(
            node.wb.frg.last_reference_footholds.data, float).reshape(12).copy(),
        touch_down=np.asarray(
            node.wb.frg.last_reference_footholds.data, float).reshape(12).copy(),
        swing_period=np.full(4, stc.swing_period, float),
        normal_force_max=np.full(4, cfg.mpc.grf_max, float),
        normal_force_min=np.full(4, cfg.mpc.grf_min, float),
    )


class QuadrupedPyMPCRosNode:
    """The rclpy wrapper (requires rclpy; dls2_interface msgs optional — falls back
    to std_msgs/Float64MultiArray for torques when absent)."""

    def __init__(self, cfg: Config, mpc_mode: str = "inline", rate_hz: float = 250.0,
                 device="cuda"):
        if not rclpy_available():
            raise ImportError(
                "rclpy is not installed; the controller stack runs without ROS via "
                "runtime.controller_node.ControllerNode — this class only adds the "
                "DDS topic plumbing")
        import rclpy
        from rclpy.node import Node as RclpyNode

        self.cfg = cfg
        self.assembler = RobotStateAssembler(cfg)
        self._base: Optional[BaseState] = None
        self._blind: Optional[BlindState] = None
        self._seq = 0
        self._node_impl = None
        feet0 = Legs(np.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0],
                                 [-0.25, 0.15, 0], [-0.25, -0.15, 0]], float))
        self.controller = ControllerNode(cfg, feet0, mpc_mode=mpc_mode, device=device)
        self.rate_hz = rate_hz

        try:
            from dls2_interface.msg import (  # type: ignore
                BaseState as RosBaseState,
                BlindState as RosBlindState,
                ControlSignal as RosControlSignal,
            )
            self._have_dls2 = True
        except Exception:
            self._have_dls2 = False

        outer = self

        class _Impl(RclpyNode):
            def __init__(self):
                super().__init__("Quadruped_PyMPC_Node")
                if outer._have_dls2:
                    from dls2_interface.msg import (
                        BaseState as RB,
                        BlindState as RBS,
                        ControlSignal as RCS,
                    )
                    self.create_subscription(RB, "/base_state", outer._on_base, 1)
                    self.create_subscription(RBS, "/blind_state", outer._on_blind, 1)
                    self.pub_torques = self.create_publisher(
                        RCS, "/quadruped_pympc_torques", 1)
                else:
                    from std_msgs.msg import Float64MultiArray
                    self.create_subscription(Float64MultiArray, "/base_state_raw",
                                             outer._on_base_raw, 1)
                    self.create_subscription(Float64MultiArray, "/blind_state_raw",
                                             outer._on_blind_raw, 1)
                    self.pub_torques = self.create_publisher(
                        Float64MultiArray, "/quadruped_pympc_torques", 1)
                self.create_timer(1.0 / outer.rate_hz, outer._control_callback)

        self._impl_cls = _Impl
        self._rclpy = rclpy

    # -- subscription callbacks (wire msg -> schema) -------------------------
    def _on_base(self, msg):
        self._base = BaseState(
            sequence_id=msg.sequence_id, timestamp=msg.timestamp,
            pose=Pose(np.asarray(msg.pose.position),
                      np.asarray(msg.pose.orientation)),
            velocity=Screw(np.asarray(msg.velocity.linear),
                           np.asarray(msg.velocity.angular)),
            stance_status=list(msg.stance_status))

    def _on_blind(self, msg):
        self._blind = BlindState(
            sequence_id=msg.sequence_id, timestamp=msg.timestamp,
            joints_position=np.asarray(msg.joints_position),
            joints_velocity=np.asarray(msg.joints_velocity),
            feet_contact=list(msg.feet_contact))

    def _on_base_raw(self, msg):
        d = np.asarray(msg.data)
        self._base = BaseState(pose=Pose(d[0:3], d[3:7]),
                               velocity=Screw(d[7:10], d[10:13]))

    def _on_blind_raw(self, msg):
        d = np.asarray(msg.data)
        self._blind = BlindState(joints_position=d[0:12], joints_velocity=d[12:24])

    def _control_callback(self):
        # Refuse to act before the first state messages (reference :449-450).
        if self._base is None or self._blind is None:
            return
        s = self.assembler.assemble(self._base, self._blind)
        tau, des_q, des_qd = self.controller.control_tick(
            lambda: s, np.zeros(3), np.zeros(3), 1.0 / self.rate_hz)
        sig = pack_control_signal(tau, self._seq, time.time())
        if self._have_dls2:
            from dls2_interface.msg import ControlSignal as RCS
            m = RCS()
            m.sequence_id = sig.sequence_id
            m.timestamp = sig.timestamp
            m.torques = list(sig.torques)
            self._node_impl.pub_torques.publish(m)
        else:
            from std_msgs.msg import Float64MultiArray
            m = Float64MultiArray()
            m.data = list(sig.torques)
            self._node_impl.pub_torques.publish(m)
        self._seq += 1

    def spin(self):
        self._rclpy.init()
        self._node_impl = self._impl_cls()
        try:
            self._rclpy.spin(self._node_impl)
        finally:
            self.controller.shutdown()
            self._node_impl.destroy_node()
            self._rclpy.shutdown()


def main():  # pragma: no cover - requires a ROS2 environment
    from ..config import make_config

    cfg = make_config()
    QuadrupedPyMPCRosNode(cfg).spin()


if __name__ == "__main__":  # pragma: no cover
    main()
