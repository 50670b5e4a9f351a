"""Parametric MJCF generation: quadruped robot + terrain scenes (numpy only).

The port's own copy of ``quadruped_pympc_tamols_tpu/sim/mjcf.py``: for every
robot and scene it produces the same XML string, so the MuJoCo model of the
port's plant is the JAX package's. The robot MJCF is generated from RobotParams
so the model's kinematics match the analytic FK/IK (kinematics/leg_ik.py);
terrain scenes (flat, random_boxes, perlin, ramp, slippery, stairs, stepping
stones and the course scenes) are generated procedurally.
"""
from __future__ import annotations

import io

import numpy as np

from ..config import RobotParams


def quadruped_mjcf(rp: RobotParams, scene: str = "flat", friction: float = 0.8,
                   seed: int = 0, leg_mass_fraction: float = 0.15) -> str:
    """Build a complete MJCF scene string for the given robot + terrain.

    ``leg_mass_fraction`` sets how much of the robot mass the legs carry (default
    ~15%, matching the reference robots). The SRB/kinodynamic controllers model a
    heavy trunk with massless legs, so raising it probes the model-mismatch
    envelope (tests/test_mujoco_sim.py heavy-leg robustness)."""
    d = rp.hip_offset_y
    l3, l4 = rp.thigh_length, rp.calf_length
    trunk_x = rp.hip_x * 2 * 1.15
    trunk_y = rp.hip_y * 2 + 0.04
    trunk_z = 0.45 * rp.hip_height * 0.5

    # Link masses: the SRB controllers assume a heavy trunk (see docstring).
    m_leg = leg_mass_fraction * rp.mass / 4
    m_hip, m_thigh, m_calf = 0.35 * m_leg, 0.45 * m_leg, 0.2 * m_leg
    m_trunk = rp.mass - 4 * m_leg
    I = rp.inertia_matrix()
    fullinertia = f"{I[0,0]:.6f} {I[1,1]:.6f} {I[2,2]:.6f} {I[0,1]:.6f} {I[0,2]:.6f} {I[1,2]:.6f}"

    tau_max = rp.mass * 9.81 * max(l3, l4) * 0.9  # ~54 Nm for aliengo (real: 44-55)

    legs = []
    # Joint ranges come from RobotParams.joint_limits — the same limits the
    # analytic IK clamps to (kinematics/leg_ik.py), so sim stops and commanded
    # targets agree.
    (h_lo, h_hi), (t_lo, t_hi), (c_lo, c_hi) = rp.joint_limits
    for name, sx, sy in (("FL", 1, 1), ("FR", 1, -1), ("RL", -1, 1), ("RR", -1, -1)):
        hip_pos = f"{sx * rp.hip_x:.4f} {sy * rp.hip_y:.4f} 0"
        abd = f"0 {sy * d:.4f} 0"
        legs.append(f"""
      <body name="{name}_hip" pos="{hip_pos}">
        <joint name="{name}_hip_joint" type="hinge" axis="1 0 0" range="{h_lo} {h_hi}" damping="0.01"/>
        <geom type="cylinder" size="0.035 0.02" quat="0.707 0 0.707 0" mass="{m_hip:.3f}"/>
        <body name="{name}_thigh" pos="{abd}">
          <joint name="{name}_thigh_joint" type="hinge" axis="0 1 0" range="{t_lo} {t_hi}" damping="0.01"/>
          <geom type="capsule" fromto="0 0 0  0 0 {-l3:.4f}" size="0.022" mass="{m_thigh:.3f}"/>
          <body name="{name}_calf" pos="0 0 {-l3:.4f}">
            <joint name="{name}_calf_joint" type="hinge" axis="0 1 0" range="{c_lo} {c_hi}" damping="0.01"/>
            <geom type="capsule" fromto="0 0 0  0 0 {-l4:.4f}" size="0.016" mass="{m_calf:.3f}"/>
            <geom name="{name}_foot" type="sphere" pos="0 0 {-l4:.4f}" size="0.02"
                  friction="{friction} 0.02 0.01" mass="0.05"/>
            <site name="{name}_foot_site" pos="0 0 {-l4:.4f}" size="0.005"/>
          </body>
        </body>
      </body>""")

    actuators = "\n".join(
        f'    <motor name="{leg}_{j}" joint="{leg}_{j}_joint" ctrlrange="{-tau_max:.1f} {tau_max:.1f}"/>'
        for leg in ("FL", "FR", "RL", "RR") for j in ("hip", "thigh", "calf"))

    start_z = rp.hip_height + 0.03 + _terrain_z0(scene)

    return f"""<mujoco model="{rp.name}_qpympc">
  <compiler angle="radian" autolimits="true"/>
  <option timestep="0.002" integrator="Euler" gravity="0 0 -9.81"/>
  <default>
    <geom contype="1" conaffinity="1" condim="3" friction="{friction} 0.02 0.01"/>
  </default>
  <worldbody>
{terrain_bodies(scene, friction, seed)}
    <body name="trunk" pos="0 0 {start_z:.3f}">
      <freejoint name="root"/>
      <inertial pos="0 0 0" mass="{m_trunk:.3f}" fullinertia="{fullinertia}"/>
      <geom type="box" size="{trunk_x/2:.3f} {trunk_y/2:.3f} {trunk_z:.3f}" mass="0"
            contype="1" conaffinity="0"/>
      <site name="imu" pos="0 0 0" size="0.01"/>
{''.join(legs)}
    </body>
  </worldbody>
  <actuator>
{actuators}
  </actuator>
</mujoco>"""


def _terrain_z0(scene: str) -> float:
    return 0.0


def terrain_bodies(scene: str, friction: float, seed: int = 0) -> str:
    """Procedural terrain, mirroring the reference's built-in scenes
    (config.py:275-279)."""
    rng = np.random.default_rng(seed)
    out = io.StringIO()
    if scene == "flat":
        out.write('    <geom name="floor" type="plane" size="30 30 0.1" pos="0 0 0" group="2"/>\n')
    elif scene == "slippery":
        out.write(f'    <geom name="floor" type="plane" size="30 30 0.1" pos="0 0 0" '
                  f'friction="0.35 0.02 0.01"/>\n')
    elif scene == "ramp":
        # 15 deg uphill whose surface starts AT ground level at x=0.8 (the old
        # buried-box construction emerged from the floor as a knife-edge wedge
        # mid-slope, which is what robots actually failed on).
        import math
        ang = 0.2618
        out.write('    <geom name="floor" type="plane" size="30 30 0.1" pos="0 0 0" group="2"/>\n')
        nx, nz = -math.sin(ang), math.cos(ang)
        cx = 0.8 + 2.0 * math.cos(ang) - 0.05 * nx
        cz = 2.0 * math.sin(ang) - 0.05 * nz
        out.write(f'    <geom name="ramp" type="box" size="2 2 0.05" group="2" '
                  f'pos="{cx:.3f} 0 {cz:.3f}" euler="0 {-ang:.4f} 0"/>\n')
    elif scene == "stairs":
        out.write('    <geom name="floor" type="plane" size="30 30 0.1" pos="0 0 0" group="2"/>\n')
        for i in range(8):
            h = 0.06 * (i + 1)
            out.write(f'    <geom type="box" size="0.15 1.5 {h/2:.3f}" group="2" '
                      f'pos="{1.0 + 0.3*i:.2f} 0 {h/2:.3f}"/>\n')
    elif scene == "random_boxes":
        out.write('    <geom name="floor" type="plane" size="30 30 0.1" pos="0 0 0" group="2"/>\n')
        for i in range(40):
            x, y = rng.uniform(0.8, 6.0), rng.uniform(-2.0, 2.0)
            h = rng.uniform(0.02, 0.08)
            s = rng.uniform(0.1, 0.3)
            out.write(f'    <geom type="box" size="{s:.2f} {s:.2f} {h/2:.3f}" group="2" '
                      f'pos="{x:.2f} {y:.2f} {h/2:.3f}"/>\n')
    elif scene == "stepping_stones":
        # The reference's six-section course, to spec
        # (docs/STEPPING_STONES_TERRAIN.md:9-46, :126-135): flat start (2 m) ->
        # 15 deg uphill (3 m) -> flat (1 m) -> stepping stones (4 m; r=0.15 m
        # cylinders whose TOPS sit 0.05 m above the base surface, 0.4 m spacing,
        # 3 per row, alternating half-spacing row offsets = plum-blossom) ->
        # flat (1 m) -> 15 deg downhill (3 m). Deterministic (regression scene).
        import math
        ang = math.radians(15.0)
        run, rise = 3.0 * math.cos(ang), 3.0 * math.sin(ang)
        x_up0 = 1.0                      # uphill starts (spawn flat is 2 m)
        x_up1 = x_up0 + run              # uphill ends
        x_f1 = x_up1 + 1.0               # flat1 ends / stones start
        x_st1 = x_f1 + 4.0               # stones end
        x_f2 = x_st1 + 1.0               # flat2 ends / downhill starts
        z_top = rise
        out.write('    <geom name="floor" type="plane" size="40 40 0.1" pos="0 0 0" group="2"/>\n')
        # Uphill box: top surface from (x_up0, 0) to (x_up1, z_top).
        nx, nz = -math.sin(ang), math.cos(ang)  # top-surface normal (rot -15deg about y)
        cx = (x_up0 + x_up1) / 2 - 0.05 * nx
        cz = z_top / 2 - 0.05 * nz
        out.write(f'    <geom name="uphill" type="box" size="1.52 1.5 0.05" group="2" '
                  f'pos="{cx:.3f} 0 {cz:.3f}" euler="0 {-ang:.4f} 0"/>\n')
        # Flat1 + stones base + flat2: one solid deck at z_top (stones rise 0.05
        # above it, so a missed stone is a 5 cm step down onto solid ground).
        deck_half = (x_f2 - x_up1) / 2 + 0.02
        out.write(f'    <geom name="deck" type="box" size="{deck_half:.3f} 1.5 0.10" group="2" '
                  f'pos="{(x_up1 + x_f2) / 2:.3f} 0 {z_top - 0.10:.3f}"/>\n')
        for ix in range(10):
            x = x_f1 + 0.2 + 0.4 * ix
            ys = (-0.4, 0.0, 0.4) if ix % 2 == 0 else (-0.2, 0.2, 0.6)
            for y in ys:
                out.write(f'    <geom type="cylinder" size="0.15 0.025" group="2" '
                          f'pos="{x:.3f} {y:.2f} {z_top + 0.025:.3f}"/>\n')
        # Downhill box: top from (x_f2, z_top) to (x_f2 + run, 0).
        cx = x_f2 + run / 2 + 0.05 * (-math.sin(-ang))
        cz = z_top / 2 - 0.05 * nz
        out.write(f'    <geom name="downhill" type="box" size="1.52 1.5 0.05" group="2" '
                  f'pos="{cx:.3f} 0 {cz:.3f}" euler="0 {ang:.4f} 0"/>\n')
    elif scene == "stepping_stones_chasm":
        # Harder-than-reference variant kept as a stress test: the same stone
        # radius/spacing but over 0.3 m deep gaps and a square grid (no
        # plum-blossom offsets), with +-3 cm placement jitter.
        out.write('    <geom name="floor" type="plane" size="30 30 0.1" pos="0 0 -0.3" group="2"/>\n')
        out.write('    <geom name="start" type="box" size="1.0 1.5 0.15" pos="-0.5 0 -0.15" group="2"/>\n')
        for ix in range(6):
            for iy in range(-2, 3):
                x = 0.8 + 0.4 * ix + rng.uniform(-0.03, 0.03)
                y = 0.4 * iy + rng.uniform(-0.03, 0.03)
                out.write(f'    <geom type="cylinder" size="0.15 0.15" group="2" '
                          f'pos="{x:.2f} {y:.2f} -0.15"/>\n')
        out.write('    <geom name="end" type="box" size="1.0 1.5 0.15" pos="4.1 0 -0.15" group="2"/>\n')
    elif scene == "trip_bar":
        # A low bar across the path that a swing foot strikes mid-swing: the
        # early-stance reflex (geom_contact mode) must trigger and re-plan the
        # swing from the hitpoint (reference early_stance_detector.py:90-115).
        out.write('    <geom name="floor" type="plane" size="30 30 0.1" pos="0 0 0" group="2"/>\n')
        out.write('    <geom name="bar" type="box" size="0.03 1.5 0.04" pos="0.45 0 0.04" group="2"/>\n')
    elif scene == "perlin" or scene == "rough":
        out.write('    <geom name="floor" type="plane" size="30 30 0.1" pos="0 0 0" group="2"/>\n')
        for i in range(120):
            x, y = rng.uniform(0.6, 8.0), rng.uniform(-2.5, 2.5)
            h = rng.uniform(0.01, 0.05)
            s = rng.uniform(0.08, 0.2)
            out.write(f'    <geom type="box" size="{s:.2f} {s:.2f} {h/2:.3f}" group="2" '
                      f'pos="{x:.2f} {y:.2f} {h/2:.3f}" euler="0 0 {rng.uniform(0,1.5):.2f}"/>\n')
    else:
        raise ValueError(f"unknown scene {scene!r}")
    return out.getvalue()
