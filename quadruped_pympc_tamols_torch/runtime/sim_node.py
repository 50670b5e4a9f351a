"""Simulator publisher node: MuJoCo physics behind the dls2_interface topics.

Counterpart of ``quadruped_pympc_tamols_tpu/runtime/sim_node.py``; it runs on the
CPU only, where MuJoCo is installed (the card's machine has none), and loads
MuJoCo when a node is made, not when the module is imported. Counterpart of the
reference ros2/run_simulator.py:27-136 — a 500 Hz physics node
that consumes ``/quadruped_pympc_torques`` (ControlSignal) and
``/trajectory_generator`` (TrajectoryGenerator joint PD targets) and publishes
``/base_state`` (BaseState) + ``/blind_state`` (BlindState) every step, acting as a
fake robot for the controller node.

The node is transport-agnostic: pair it with ``ros2_node.LocalTransport`` and
``ros2_node.ControllerBridge`` for an in-process node<->node loopback (how
tests/test_torch_runtime.py exercises it without ROS), or wrap it with rclpy via
:func:`main` on a machine that has ROS2 installed (same import guard as
QuadrupedPyMPCRosNode).

Unlike the reference — whose ControlSignal carries feedforward torque only and
whose joint PD runs on the robot's motor drivers (run_controller.py:85-91) — this
node emulates that onboard PD explicitly: it applies
``tau + kp*(q_des - q) + kd*(qd_des - qd)`` with the gains carried by the
TrajectoryGenerator message, which is what the real drivers do with the same packet.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..utils.legs import Legs
from .ros2_node import (BaseState, BlindState, ControlSignal, Pose, Screw,
                        TrajectoryGenerator, rclpy_available)


def euler_xyz_to_quat_wxyz(rpy) -> np.ndarray:
    """Intrinsic xyz Euler -> (w, x, y, z) quaternion."""
    r, p, y = 0.5 * np.asarray(rpy, float)
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array([
        cr * cp * cy - sr * sp * sy,
        sr * cp * cy + cr * sp * sy,
        cr * sp * cy - sr * cp * sy,
        cr * cp * sy + sr * sp * cy,
    ])


class SimulatorNode:
    """MuJoCo physics node publishing estimator-shaped state messages."""

    def __init__(self, cfg: Config, transport, scene: str | None = None,
                 seed: int = 0, rate_hz: float = 500.0):
        from ..sim.mujoco_env import QuadrupedEnv

        self.cfg = cfg
        self.transport = transport
        self.env = QuadrupedEnv(cfg, scene=scene or cfg.sim.scene, seed=seed)
        self.sim_dt = 1.0 / rate_hz
        self._seq = 0
        self._tau = np.zeros((4, 3))
        self._des_q: np.ndarray | None = None
        self._des_qd = np.zeros((4, 3))
        self._kp = np.zeros((4, 3))
        self._kd = np.zeros((4, 3))
        self._tau_max = np.asarray(self.env.model.actuator_ctrlrange[:, 1]).reshape(4, 3)
        transport.subscribe("/quadruped_pympc_torques", self._on_control_signal)
        transport.subscribe("/trajectory_generator", self._on_trajectory_generator)

    # -- subscriptions (reference run_simulator.py:70-92) ---------------------
    def _on_control_signal(self, msg: ControlSignal):
        self._tau = np.asarray(msg.torques, float).reshape(4, 3)

    def _on_trajectory_generator(self, msg: TrajectoryGenerator):
        self._des_q = np.asarray(msg.joints_position, float).reshape(4, 3)
        self._des_qd = np.asarray(msg.joints_velocity, float).reshape(4, 3)
        self._kp = np.asarray(msg.kp, float).reshape(4, 3)
        self._kd = np.asarray(msg.kd, float).reshape(4, 3)

    # -- the 500 Hz scheduler tick (reference :95-124) ------------------------
    def step(self):
        """One physics step with the latest command; publishes the new state."""
        env = self.env
        tau = self._tau.copy()
        if self._des_q is not None:
            # Onboard joint PD (see module docstring).
            q = np.asarray(env.joints_pos().data).reshape(4, 3)
            qd = np.asarray(env.joints_vel().data).reshape(4, 3)
            tau = tau + self._kp * (self._des_q - q) + self._kd * (self._des_qd - qd)
        tau = np.clip(tau, -0.9 * self._tau_max, 0.9 * self._tau_max)
        env.step(Legs(tau))

        stamp = self._seq * self.sim_dt
        contact = [bool(c) for c in env.feet_contact_state()]
        base = BaseState(
            sequence_id=self._seq, timestamp=stamp,
            robot_name=self.cfg.robot.name,
            pose=Pose(position=env.base_pos.copy(),
                      orientation=euler_xyz_to_quat_wxyz(env.base_ori_euler_xyz)),
            velocity=Screw(linear=env.base_lin_vel.copy(),
                           angular=env.base_ang_vel.copy()),
            stance_status=contact)
        blind = BlindState(
            sequence_id=self._seq, timestamp=stamp,
            robot_name=self.cfg.robot.name,
            joints_position=np.asarray(env.joints_pos().data, float).reshape(12).copy(),
            joints_velocity=np.asarray(env.joints_vel().data, float).reshape(12).copy(),
            feet_contact=contact,
            current_feet_positions=np.asarray(env.feet_pos().data,
                                              float).reshape(12).copy())
        self.transport.publish("/base_state", base)
        self.transport.publish("/blind_state", blind)
        self._seq += 1


def main():  # pragma: no cover - requires a ROS2 environment
    """rclpy entry point (reference run_simulator.py:126-136)."""
    if not rclpy_available():
        raise ImportError(
            "rclpy is not installed; use SimulatorNode with a LocalTransport "
            "(see tests/test_torch_runtime.py) for the in-process pairing")
    import rclpy
    from rclpy.node import Node as RclpyNode

    from ..config import make_config
    from .ros2_node import QuadrupedPyMPCRosNode  # noqa: F401 (wire twins)

    cfg = make_config()
    rclpy.init()
    node = RclpyNode("Simulator_Node")

    try:
        from dls2_interface.msg import (BaseState as RB, BlindState as RBS,
                                        ControlSignal as RCS,
                                        TrajectoryGenerator as RTG)
    except Exception as exc:  # pragma: no cover
        raise ImportError("dls2_interface msgs not built; see runtime/msgs/") from exc

    class _WireTransport:
        """rclpy-backed transport: dataclass msgs -> wire msgs and back."""

        def __init__(self):
            self.pub_base = node.create_publisher(RB, "/base_state", 1)
            self.pub_blind = node.create_publisher(RBS, "/blind_state", 1)
            self._subs = []

        def publish(self, topic, msg):
            if topic == "/base_state":
                m = RB()
                m.sequence_id = msg.sequence_id
                m.timestamp = msg.timestamp
                m.pose.position = list(msg.pose.position)
                m.pose.orientation = list(msg.pose.orientation)
                m.velocity.linear = list(msg.velocity.linear)
                m.velocity.angular = list(msg.velocity.angular)
                m.stance_status = list(msg.stance_status)
                self.pub_base.publish(m)
            elif topic == "/blind_state":
                m = RBS()
                m.sequence_id = msg.sequence_id
                m.timestamp = msg.timestamp
                m.joints_position = list(msg.joints_position)
                m.joints_velocity = list(msg.joints_velocity)
                m.feet_contact = list(msg.feet_contact)
                m.current_feet_positions = list(msg.current_feet_positions)
                self.pub_blind.publish(m)

        def subscribe(self, topic, cb):
            if topic == "/quadruped_pympc_torques":
                node.create_subscription(
                    RCS, topic,
                    lambda m: cb(ControlSignal(sequence_id=m.sequence_id,
                                               timestamp=m.timestamp,
                                               torques=np.asarray(m.torques))), 1)
            elif topic == "/trajectory_generator":
                node.create_subscription(
                    RTG, topic,
                    lambda m: cb(TrajectoryGenerator(
                        joints_position=np.asarray(m.joints_position),
                        joints_velocity=np.asarray(m.joints_velocity),
                        kp=np.asarray(m.kp), kd=np.asarray(m.kd))), 1)

    sim = SimulatorNode(cfg, _WireTransport())
    node.create_timer(sim.sim_dt, sim.step)
    try:
        rclpy.spin(node)
    finally:
        node.destroy_node()
        rclpy.shutdown()


if __name__ == "__main__":  # pragma: no cover
    main()
