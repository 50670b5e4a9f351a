"""The port's deployment runtime (``runtime/*``) against the JAX package's on the CPU:
the native control bus (the JAX package's bus tests, and a bus written by one
package and read by the other), the control node inline on the recorded MuJoCo
trace (``tests/fixtures/torch_mujoco_trace.npz``) and its background modes as the
JAX package tests them, the ROS2 shim's state assembler and controller bridge on
the same messages, the message IDL twins, the rclpy guard, the console, and a
simulator-node loopback.

Tolerances: the inline node's torques, joint targets and joint velocities to 1e-6
(``test_torch_mujoco.py``'s TORQUE_ATOL: the same inputs, zero noise); the state
assembler 1e-5 (the JAX package's kinematics run in float32, the port's in
float64); the bridge's published torques 1e-3 N m on the same messages (the MPC
sees those float32-vs-float64 states); the loopback's base state 1e-3 and feet
1e-4, ``test_torch_mujoco.py``'s closed-loop tolerances.
"""
import dataclasses
import os
import pathlib
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.planner.heightmap import GridHeightMap as JaxGrid
from quadruped_pympc_tamols_tpu.runtime import ros2_node as jax_ros2
from quadruped_pympc_tamols_tpu.runtime.control_bus import ControlBus as JaxBus
from quadruped_pympc_tamols_tpu.runtime.controller_node import ControllerNode as JaxNode
from quadruped_pympc_tamols_tpu.utils.legs import Legs as JaxLegs
from quadruped_pympc_tamols_torch import make_config, replace_config
from quadruped_pympc_tamols_torch.interop import config_from_dict
from quadruped_pympc_tamols_torch.runtime import (BaseState, BlindState, ControllerBridge,
                                                  ControllerNode, LocalTransport,
                                                  QuadrupedPyMPCRosNode, RobotStateAssembler,
                                                  pack_control_signal, rclpy_available)
from quadruped_pympc_tamols_torch.runtime import ros2_node as rn
from quadruped_pympc_tamols_torch.runtime.control_bus import (PAYLOAD_DOUBLES, ControlBus,
                                                              pack_control_block,
                                                              unpack_control_block)
from quadruped_pympc_tamols_torch.sim.trace import ControlTrace
from quadruped_pympc_tamols_torch.utils.legs import Legs

torch.set_num_threads(1)
threadpool_limits(1)
CPU = "cpu"
TORQUE_ATOL = 1e-6
ASSEMBLY_ATOL = 1e-5
BRIDGE_ATOL = 1e-3
TRACE_STEPS = 60
ZERO = {"mpc.sampling.num_samples": 32, "mpc.sampling.sigma_random": (0.0, 0.0, 0.0)}
FEET0 = np.asarray([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                   float)


def _bus_name(tag):
    return f"/qpympc_torch_{tag}_{os.getpid()}"


def test_bus_roundtrip():
    name = _bus_name("rt")
    w = ControlBus(name, create=True)
    r = ControlBus(name, create=False)
    try:
        assert r.read()[0] == 0
        block = pack_control_block(np.arange(12), np.arange(12) + 100, np.zeros(12),
                                   np.zeros(12), np.zeros(12), np.arange(12) * 0.5, 1.8, 0.7,
                                   1.2)
        w.write(block)
        seq, data = r.read()
        assert seq == 2
        d = unpack_control_block(data)
        np.testing.assert_allclose(d["grfs"].reshape(12), np.arange(12))
        np.testing.assert_allclose(d["footholds"].reshape(12), np.arange(12) + 100)
        assert d["best_freq"] == 1.8 and d["t_solve_ms"] == 0.7
    finally:
        r.close()
        w.close()


def test_bus_concurrent_reader_never_tears():
    """A writer thread hammers the bus; every snapshot a reader takes holds one
    publish's value throughout."""
    name = _bus_name("tear")
    w = ControlBus(name, create=True)
    r = ControlBus(name, create=False)
    stop = threading.Event()

    def writer():
        i = 0
        while not stop.is_set():
            w.write(np.full(PAYLOAD_DOUBLES, float(i)))
            i += 1

    th = threading.Thread(target=writer)
    th.start()
    torn, reads = [], 0
    try:
        t_end = time.time() + 1.0
        while time.time() < t_end:
            seq, data = r.read()
            if seq:
                if not np.all(data == data[0]):
                    torn.append(data)
                reads += 1
        assert reads > 1000 and not torn
    finally:
        stop.set()
        th.join()
        r.close()
        w.close()


def test_bus_wait_new():
    w = ControlBus(_bus_name("wait"), create=True)
    try:
        assert w.wait_new(0, timeout_s=0.05) == (0, None)
        w.write(np.full(PAYLOAD_DOUBLES, 7.0))
        seq, data = w.wait_new(0, timeout_s=0.5)
        assert seq == 2 and data[0] == 7.0
    finally:
        w.close()


def test_bus_is_shared_with_the_jax_package():
    """One shm name: the JAX package's bus writes and the port's reads, then the
    other way round; the same block layout and seq-lock on both sides."""
    name = _bus_name("x")
    jw = JaxBus(name, create=True)
    tr = ControlBus(name, create=False)
    try:
        block = pack_control_block(np.arange(12), np.ones(12), np.zeros(12), np.zeros(12),
                                   np.zeros(12), np.arange(12) * 0.25, 2.2, 0.5, 0.9)
        jw.write(block)
        seq, data = tr.read()
        assert seq == 2
        np.testing.assert_array_equal(data, block)
        tw = ControlBus(name, create=False)
        tw.write(block * 2.0)
        seq, data = jw.read()
        assert seq == 4
        np.testing.assert_array_equal(data, block * 2.0)
        tw.close()
    finally:
        tr.close()
        jw.close()


def _trace_states(trace, steps):
    """(port provider dict, JAX provider dict) of the first ``steps`` trace steps."""
    out = []
    for i in range(steps):
        kw = trace.inputs(i)
        s = {k: kw[k] for k in ("com_pos", "base_pos", "base_lin_vel", "base_ori_euler_xyz",
                                "base_ang_vel", "feet_pos", "hip_pos", "joints_pos",
                                "feet_jac", "feet_jac_dot", "feet_vel", "legs_qfrc_bias",
                                "legs_mass_matrix", "legs_qfrc_passive", "heightmaps")}
        s["joints_vel"] = kw["qvel_js"]
        j = {k: (JaxLegs(np.asarray(v.data).copy()) if isinstance(v, Legs) else v)
             for k, v in s.items()}
        hms = s["heightmaps"]
        j["heightmaps"] = None if hms is None else JaxGrid(
            *(jnp.asarray(getattr(hms, leaf).numpy())
              for leaf in ("center", "yaw", "resolution", "heights")))
        out.append((s, j, kw["ref_base_lin_vel"], kw["ref_base_ang_vel"], kw["simulation_dt"]))
    return out


def test_inline_node_matches_jax_on_the_recorded_trace():
    """The recorded configuration ("height" footholds) at N = 32 and zero noise: both
    packages' inline ControllerNode solve every tick of the first TRACE_STEPS steps
    of the recorded MuJoCo loop; tau, des_q and des_qd to 1e-6."""
    trace = ControlTrace()
    jc = jax_make_config("aliengo", mpc_type="sampling",
                         **{"sim.visual_foothold_adaptation": "height", **ZERO})
    tc = config_from_dict(dataclasses.asdict(jc))
    assert replace_config(config_from_dict(trace.config), **ZERO) == tc
    feet0 = trace.inputs(0)["feet_pos"].data
    node = ControllerNode(tc, Legs(feet0.copy()), device=CPU)
    jnode = JaxNode(jc, JaxLegs(feet0.copy()))
    try:
        for s, j, v, w, dt in _trace_states(trace, TRACE_STEPS):
            tau, dq, dqd = node.control_tick(lambda: s, v, w, dt)
            jtau, jdq, jdqd = jnode.control_tick(lambda: j, v, w, dt)
            for a, b in ((tau, jtau), (dq, jdq), (dqd, jdqd)):
                np.testing.assert_allclose(np.asarray(a.data), np.asarray(b.data), rtol=0,
                                           atol=TORQUE_ATOL)
        assert node.solves == TRACE_STEPS
    finally:
        node.shutdown()
        jnode.shutdown()


@pytest.mark.parametrize("mode", ["pipelined", "thread", "shared_memory"])
def test_node_modes(mode):
    """The JAX package's mode test (tests/test_runtime.py): standing on full stance,
    the background modes (and the pipelined one) produce stance torques within a
    deadline, and they are finite; the background modes count their solves."""
    cfg = make_config("aliengo", mpc_type="sampling", gait="full_stance")
    cfg = replace_config(cfg, **{"mpc.sampling.num_samples": 200,
                                 "sim.visual_foothold_adaptation": "blind"})
    feet = Legs(FEET0.copy())
    node = ControllerNode(cfg, feet, mpc_mode=mode, bus_name=_bus_name(mode), device=CPU)

    def provider():
        return dict(com_pos=np.array([0.0, 0.0, 0.33]), base_pos=np.array([0.0, 0.0, 0.35]),
                    base_lin_vel=np.zeros(3), base_ori_euler_xyz=np.zeros(3),
                    base_ang_vel=np.zeros(3), feet_pos=feet,
                    hip_pos=Legs(FEET0 + np.array([0, 0, 0.35])),
                    joints_pos=Legs(np.tile([0.0, 0.8, -1.6], (4, 1))),
                    joints_vel=Legs.zeros((3,)), feet_jac=Legs(np.tile(np.eye(3), (4, 1, 1))),
                    feet_jac_dot=Legs.zeros((3, 3)), feet_vel=Legs.zeros((3,)),
                    legs_qfrc_bias=Legs.zeros((3,)),
                    legs_mass_matrix=Legs(np.tile(np.eye(3) * 0.1, (4, 1, 1))))

    try:
        assert (mode == "pipelined") == node.cfg.mpc.sampling.pipelined
        deadline = time.time() + 20.0
        tau = np.zeros((4, 3))
        while time.time() < deadline:
            tau = np.asarray(node.control_tick(provider, np.zeros(3), np.zeros(3),
                                               cfg.sim.dt)[0].data)
            if np.any(np.abs(tau) > 1.0):
                break
            time.sleep(0.01)
        assert np.any(np.abs(tau) > 1.0), f"{mode}: no torque produced"
        assert np.all(np.isfinite(tau)) and node.solves >= 1
    finally:
        node.shutdown()


def _standing_messages(cfg, module, kin):
    base_pos = np.array([0.0, 0.0, cfg.sim.ref_z])
    q = np.asarray(kin.ik_world(FEET0, base_pos, np.eye(3)), float)
    q = q + np.random.default_rng(0).normal(0, 0.02, q.shape)
    base = module.BaseState(
        pose=module.Pose(position=base_pos + [0.01, -0.02, 0.0],
                         orientation=np.array([0.999, 0.02, -0.03, 0.01]) / np.linalg.norm(
                             [0.999, 0.02, -0.03, 0.01])),
        velocity=module.Screw(linear=np.array([0.1, 0.02, 0.0]),
                              angular=np.array([0.0, 0.1, 0.05])))
    blind = module.BlindState(joints_position=q.reshape(12),
                              joints_velocity=np.linspace(-0.5, 0.5, 12))
    return base, blind


def test_state_assembler_matches_jax():
    """RobotStateAssembler on the same BaseState/BlindState: every field of the
    provider dict to 1e-5 (float32 on the JAX side), and FK on the IK-seeded joints
    reproduces the feet."""
    from quadruped_pympc_tamols_torch.kinematics import LegKinematics

    cfg = make_config("aliengo", mpc_type="sampling")
    base, blind = _standing_messages(cfg, rn, LegKinematics(cfg.robot))
    s = RobotStateAssembler(cfg).assemble(base, blind)
    jbase = jax_ros2.BaseState(pose=jax_ros2.Pose(base.pose.position, base.pose.orientation),
                               velocity=jax_ros2.Screw(base.velocity.linear,
                                                       base.velocity.angular))
    jblind = jax_ros2.BlindState(joints_position=blind.joints_position,
                                 joints_velocity=blind.joints_velocity)
    j = jax_ros2.RobotStateAssembler(jax_make_config("aliengo", mpc_type="sampling")).assemble(
        jbase, jblind)
    assert sorted(s) == sorted(j)
    for k, v in s.items():
        if v is None:
            assert j[k] is None
            continue
        a = np.asarray(v.data if isinstance(v, Legs) else v)
        b = np.asarray(j[k].data if hasattr(j[k], "data") else j[k])
        np.testing.assert_allclose(a, b, rtol=0, atol=ASSEMBLY_ATOL, err_msg=k)
    np.testing.assert_allclose(np.asarray(s["feet_pos"].data)[:, 2], 0.0, atol=0.05)


def test_controller_bridge_matches_jax():
    """ControllerBridge on both sides over a LocalTransport, the same messages, N =
    32 at zero noise: it refuses to act before the state messages, then publishes
    ControlSignal, TrajectoryGenerator and TimeDebug each tick; torques to 1e-3 N m
    and the trajectory generator's targets to 1e-5."""
    from quadruped_pympc_tamols_torch.kinematics import LegKinematics

    over = {"sim.visual_foothold_adaptation": "blind", **ZERO}
    tc = make_config("aliengo", mpc_type="sampling", **over)
    jc = jax_make_config("aliengo", mpc_type="sampling", **over)
    base, blind = _standing_messages(tc, rn, LegKinematics(tc.robot))
    bus, jbus = LocalTransport(), jax_ros2.LocalTransport()
    ctl = ControllerBridge(tc, bus, device=CPU)
    jctl = jax_ros2.ControllerBridge(jc, jbus)
    got, jgot = [], []
    bus.subscribe("/quadruped_pympc_torques", got.append)
    jbus.subscribe("/quadruped_pympc_torques", jgot.append)
    tg, jtg = [], []
    bus.subscribe("/trajectory_generator", tg.append)
    jbus.subscribe("/trajectory_generator", jtg.append)
    try:
        assert ctl.tick(np.array([0.2, 0, 0]), np.zeros(3)) is False
        bus.publish("/base_state", base)
        bus.publish("/blind_state", blind)
        jbus.publish("/base_state", jax_ros2.BaseState(
            pose=jax_ros2.Pose(base.pose.position, base.pose.orientation),
            velocity=jax_ros2.Screw(base.velocity.linear, base.velocity.angular)))
        jbus.publish("/blind_state", jax_ros2.BlindState(
            joints_position=blind.joints_position, joints_velocity=blind.joints_velocity))
        for k in range(5):
            assert ctl.tick(np.array([0.2, 0, 0]), np.zeros(3), now=float(k))
            assert jctl.tick(np.array([0.2, 0, 0]), np.zeros(3), now=float(k))
        assert bus.published["/time_debug"] == 5 and len(got) == len(jgot) == 5
        for a, b in zip(got, jgot):
            assert a.sequence_id == b.sequence_id and a.timestamp == b.timestamp
            np.testing.assert_allclose(a.torques, b.torques, rtol=0, atol=BRIDGE_ATOL)
        for a, b in zip(tg, jtg):
            for f in ("joints_position", "joints_velocity", "kp", "kd", "swing_period",
                      "normal_force_max", "normal_force_min", "nominal_touch_down"):
                np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=0, atol=1e-5,
                                           err_msg=f)
            assert a.stance_legs == b.stance_legs
        assert np.all(np.isfinite(pack_control_signal(Legs(np.ones((4, 3))), 1, 0.0).torques))
    finally:
        ctl.shutdown()
        jctl.shutdown()


def _msg_fields(path):
    fields = []
    for line in path.read_text().splitlines():
        line = line.split("#", 1)[0].strip()
        if line:
            typ, name = line.split()
            fields.append((typ, name))
    return fields


def test_msg_idl_matches_dataclasses():
    """The port's copy of the dls2_interface .msg files is the JAX package's, and
    field for field the port's dataclass schemas, with no orphan message."""
    msg_dir = pathlib.Path(rn.__file__).parent / "msgs" / "dls2_interface" / "msg"
    jax_dir = pathlib.Path(jax_ros2.__file__).parent / "msgs" / "dls2_interface" / "msg"
    schemas = {"Pose": rn.Pose, "Screw": rn.Screw, "BaseState": rn.BaseState,
               "BlindState": rn.BlindState, "ControlSignal": rn.ControlSignal,
               "TrajectoryGenerator": rn.TrajectoryGenerator, "TimeDebug": rn.TimeDebug,
               "FeetContactState": rn.FeetContactState, "Imu": rn.Imu}
    for name, cls in schemas.items():
        assert (msg_dir / f"{name}.msg").read_text() == (jax_dir / f"{name}.msg").read_text()
        idl = _msg_fields(msg_dir / f"{name}.msg")
        assert [n for _, n in idl] == [f.name for f in dataclasses.fields(cls)], name
    assert {p.stem for p in msg_dir.glob("*.msg")} == set(schemas)


def test_rclpy_node_guard():
    cfg = make_config("aliengo", mpc_type="sampling")
    if rclpy_available():
        pytest.skip("rclpy installed; guard not exercised")
    with pytest.raises(ImportError, match="rclpy"):
        QuadrupedPyMPCRosNode(cfg, device=CPU)
    assert BaseState().pose.orientation[0] == 1.0 and len(BlindState().joints_position) == 12


def test_console_commands():
    """The JAX package's console tests (tests/test_runtime.py) on the port's wrapper."""
    from quadruped_pympc_tamols_torch.interfaces import QuadrupedPyMPCWrapper
    from quadruped_pympc_tamols_torch.runtime import Console

    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.num_samples": 64,
                                                         "sim.visual_foothold_adaptation":
                                                             "blind"})
    w = QuadrupedPyMPCWrapper(cfg, Legs(FEET0.copy()), device=CPU)
    con = Console(w)
    assert "walking" in con.execute("start") and con.walking
    con.execute("vel 0.4 0.0 0.1")
    np.testing.assert_allclose(con.velocity_cmd[:2], [0.4, 0.0])
    assert "pace" in con.execute("gait pace")
    assert w.wb_interface.pgg.step_freq == 1.4
    con.execute("step_freq 2.0")
    assert w.wb_interface.pgg.step_freq == 2.0
    con.execute("stance_width 0.12")
    assert w.wb_interface.frg.hip_offset == 0.12
    assert "unknown command" in con.execute("bogus 1")
    assert "unknown gait" in con.execute("gait bogus")
    assert "kp=30" in con.execute("impedance_gains 30 3")
    assert con.impedance_gains == (30.0, 3.0)
    con.execute("pitch_delta 0.05")
    con.execute("pitch_delta 0.02")
    te = w.wb_interface.terrain_estimator
    assert abs(te.pitch_offset - 0.07) < 1e-9
    _, pitch, _ = te.compute_terrain_estimation(np.zeros(3), 0.0, Legs(FEET0.copy()))
    assert abs(pitch - 0.07) < 1e-6
    assert "stopped" in con.execute("stop")


def test_sim_node_loopback_matches_jax():
    """SimulatorNode <-> ControllerBridge over a LocalTransport for 0.5 s (250
    physics steps, the controller at 250 Hz) on both sides at N = 32 and zero
    noise: the same message counts, base states to 1e-3 and feet to 1e-4."""
    pytest.importorskip("mujoco")
    from quadruped_pympc_tamols_tpu.runtime import SimulatorNode as JaxSimNode
    from quadruped_pympc_tamols_torch.runtime import SimulatorNode

    over = {"sim.visual_foothold_adaptation": "blind", **ZERO}
    sides = []
    for make, Sim, Bridge, Transport, kw in (
            (make_config, SimulatorNode, ControllerBridge, LocalTransport, {"device": CPU}),
            (jax_make_config, JaxSimNode, jax_ros2.ControllerBridge, jax_ros2.LocalTransport,
             {})):
        cfg = make("aliengo", mpc_type="sampling", **over)
        bus = Transport()
        sim = Sim(cfg, bus, scene="flat", rate_hz=500.0)
        ctl = Bridge(cfg, bus, mpc_mode="inline", rate_hz=250.0, **kw)
        states = []
        try:
            for t in range(250):
                sim.step()
                if t % 2 == 0:
                    assert ctl.tick(np.array([0.25, 0, 0]), np.zeros(3), now=t * sim.sim_dt)
                states.append(np.concatenate([sim.env.base_pos, sim.env.base_lin_vel,
                                              sim.env.base_ori_euler_xyz,
                                              sim.env.base_ang_vel]))
            feet = np.asarray(sim.env.feet_pos().data)
        finally:
            ctl.shutdown()
        assert bus.published["/base_state"] == 250 and bus.published["/time_debug"] == 125
        sides.append((np.array(states), feet))
    (s, f), (js, jf) = sides
    assert np.all(s[:, 2] > 0.5 * make_config("aliengo").sim.ref_z)
    np.testing.assert_allclose(s, js, rtol=0, atol=1e-3)
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-4)
