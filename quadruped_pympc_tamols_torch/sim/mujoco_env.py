"""Self-contained MuJoCo quadruped environment (host numpy; heightmaps as tensors).

Counterpart of ``quadruped_pympc_tamols_tpu/sim/mujoco_env.py`` (the reference's
gym_quadruped QuadrupedEnv + HeightMap sensors): builds the robot and scene from
the parametric MJCF (``sim/mjcf.py``), exposes the state readers the control stack
consumes (reference simulation.py:617-650: Jacobians, mass matrices and bias
forces per leg) and ray-casts heightmaps for the TAMOLS planner, returned as the
port's ``GridHeightMap`` on the planner's device.

The crouch pose of ``reset`` and the rays' origins are computed in float32 with
the bits of the JAX package's XLA code (``utils/float32.py``), so the port's
plant starts and senses exactly where the JAX package's does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import LEGS, Config
from ..kinematics.leg_ik import LegKinematics
from ..planner.heightmap import GridHeightMap
from ..utils.device import resolve_device
from ..utils.float32 import F32, cosf, sinf
from ..utils.legs import Legs
from .mjcf import quadruped_mjcf

try:
    import mujoco
except ImportError:  # pragma: no cover
    mujoco = None


class QuadrupedEnv:
    def __init__(self, cfg: Config, scene: str | None = None, friction: float = 0.8,
                 seed: int = 0, leg_mass_fraction: float = 0.15):
        if mujoco is None:
            raise ImportError("mujoco is not available")
        self.cfg = cfg
        self.scene = scene or cfg.sim.scene
        xml = quadruped_mjcf(cfg.robot, self.scene, friction, seed,
                             leg_mass_fraction=leg_mass_fraction)
        self.model = mujoco.MjModel.from_xml_string(xml)
        self.data = mujoco.MjData(self.model)
        self.sim_dt = self.model.opt.timestep

        self._foot_site_ids = [mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_SITE,
                                                 f"{leg}_foot_site") for leg in LEGS]
        self._foot_geom_ids = [mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_GEOM,
                                                 f"{leg}_foot") for leg in LEGS]
        self._hip_body_ids = [mujoco.mj_name2id(self.model, mujoco.mjtObj.mjOBJ_BODY,
                                                f"{leg}_hip") for leg in LEGS]
        # Joint velocity / position indices per leg (after the 6-DoF free joint).
        self.legs_qvel_idx = Legs(np.asarray(
            [[6 + 3 * i, 7 + 3 * i, 8 + 3 * i] for i in range(4)]))
        self.legs_qpos_idx = Legs(np.asarray(
            [[7 + 3 * i, 8 + 3 * i, 9 + 3 * i] for i in range(4)]))
        self.reset()

    def reset(self, base_pos=None, joints=None):
        mujoco.mj_resetData(self.model, self.data)
        if base_pos is not None:
            self.data.qpos[0:3] = base_pos
        if joints is None:
            # Nominal crouch from the analytic IK at standing height, feet just
            # above the local ground (base height minus the standing clearance),
            # in the JAX package's float32 (a level base: the hips are the base
            # plus their offsets).
            rp = self.cfg.robot
            base = np.asarray(self.data.qpos[0:3])
            fz = float(base[2]) - (rp.hip_height + 0.03) + 0.02
            feet = np.array([[base[0] + rp.hip_x, base[1] + rp.hip_y + rp.hip_offset_y, fz],
                             [base[0] + rp.hip_x, base[1] - rp.hip_y - rp.hip_offset_y, fz],
                             [base[0] - rp.hip_x, base[1] + rp.hip_y + rp.hip_offset_y, fz],
                             [base[0] - rp.hip_x, base[1] - rp.hip_y - rp.hip_offset_y, fz]])
            kin = LegKinematics(rp)
            p_hip = feet.astype(F32) - (base.astype(F32) + kin.hip_offsets_b)
            joints = kin.ik_all_f32(p_hip).reshape(12)
        self.data.qpos[7:19] = joints
        mujoco.mj_forward(self.model, self.data)
        return self

    def step(self, tau: Legs):
        self.data.ctrl[:] = np.asarray(tau.data).reshape(12)
        mujoco.mj_step(self.model, self.data)

    # -- state readers -------------------------------------------------
    @property
    def base_pos(self):
        return np.asarray(self.data.qpos[0:3]).copy()

    @property
    def base_lin_vel(self):
        return np.asarray(self.data.qvel[0:3]).copy()

    @property
    def base_ang_vel(self):
        """Body-frame angular velocity (free joint convention)."""
        return np.asarray(self.data.qvel[3:6]).copy()

    @property
    def base_ori_euler_xyz(self):
        w, x, y, z = self.data.qpos[3:7]
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        pitch = np.arcsin(np.clip(2 * (w * y - z * x), -1, 1))
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        return np.array([roll, pitch, yaw])

    @property
    def com_pos(self):
        return np.asarray(self.data.subtree_com[1]).copy()  # trunk subtree CoM

    def feet_pos(self) -> Legs:
        return Legs(np.stack([np.asarray(self.data.site_xpos[i]).copy()
                              for i in self._foot_site_ids]))

    def feet_vel(self) -> Legs:
        out = np.zeros((4, 3))
        jacp = np.zeros((3, self.model.nv))
        for k, sid in enumerate(self._foot_site_ids):
            mujoco.mj_jacSite(self.model, self.data, jacp, None, sid)
            out[k] = jacp @ self.data.qvel
        return Legs(out)

    def hip_positions(self) -> Legs:
        return Legs(np.stack([np.asarray(self.data.xpos[i]).copy()
                              for i in self._hip_body_ids]))

    def joints_pos(self) -> Legs:
        return Legs(np.asarray(self.data.qpos[7:19]).reshape(4, 3).copy())

    def joints_vel(self) -> Legs:
        return Legs(np.asarray(self.data.qvel[6:18]).reshape(4, 3).copy())

    def feet_jacobians(self) -> Legs:
        """(4, 3, 3) world-frame foot Jacobians w.r.t. each leg's joints."""
        out = np.zeros((4, 3, 3))
        jacp = np.zeros((3, self.model.nv))
        for k, sid in enumerate(self._foot_site_ids):
            mujoco.mj_jacSite(self.model, self.data, jacp, None, sid)
            out[k] = jacp[:, 6 + 3 * k: 9 + 3 * k]
        return Legs(out)

    def feet_jacobians_dot(self, h: float = 1e-4) -> Legs:
        """Finite-difference J_dot over one step of size h along qvel, the state
        restored afterwards (JAX package :140-153)."""
        J0 = np.asarray(self.feet_jacobians().data)
        qpos = self.data.qpos.copy()
        qvel = self.data.qvel.copy()
        mujoco.mj_integratePos(self.model, self.data.qpos, self.data.qvel, h)
        mujoco.mj_forward(self.model, self.data)
        J1 = np.asarray(self.feet_jacobians().data)
        self.data.qpos[:] = qpos
        self.data.qvel[:] = qvel
        mujoco.mj_forward(self.model, self.data)
        return Legs((J1 - J0) / h)

    def legs_mass_matrix(self) -> Legs:
        M = np.zeros((self.model.nv, self.model.nv))
        mujoco.mj_fullM(self.model, self.data, M)
        return Legs(np.stack([M[6 + 3 * k: 9 + 3 * k, 6 + 3 * k: 9 + 3 * k] for k in range(4)]))

    def legs_qfrc_bias(self) -> Legs:
        return Legs(np.asarray(self.data.qfrc_bias[6:18]).reshape(4, 3).copy())

    def legs_qfrc_passive(self) -> Legs:
        return Legs(np.asarray(self.data.qfrc_passive[6:18]).reshape(4, 3).copy())

    def feet_contact_state(self) -> np.ndarray:
        """(4,) 1 where the foot geom touches anything."""
        out = np.zeros(4)
        for c in self.data.contact[: self.data.ncon]:
            for k, gid in enumerate(self._foot_geom_ids):
                if c.geom1 == gid or c.geom2 == gid:
                    out[k] = 1.0
        return out

    def srb_inertia(self) -> np.ndarray:
        """(3, 3) whole-robot composite inertia about the robot CoM in the base
        frame (the SRB model's convention; reference
        centroidal_nmpc_nominal.py:1297-1330). A loop over every body: callers pass
        the bound method, and only a controller that consumes it calls it."""
        m = self.model
        d = self.data
        com = self.com_pos
        I_w = np.zeros((3, 3))
        for b in range(1, m.nbody):
            mass = m.body_mass[b]
            if mass <= 0:
                continue
            R = d.ximat[b].reshape(3, 3)  # inertial-frame orientation in world
            I_b = R @ np.diag(m.body_inertia[b]) @ R.T
            r = d.xipos[b] - com
            I_w += I_b + mass * (np.dot(r, r) * np.eye(3) - np.outer(r, r))
        R_b2w = d.xmat[1].reshape(3, 3)  # trunk is body 1 (freejoint root)
        return R_b2w.T @ I_w @ R_b2w

    def feet_contact_points(self) -> list:
        """Per-leg list of (pos (3,), normal (3,)) world-frame contact points for
        the geom_contact reflex trigger (reference early_stance_detector.py:90-115),
        the normal flipped to point into the foot."""
        out: list = [[], [], [], []]
        for c in self.data.contact[: self.data.ncon]:
            for k, gid in enumerate(self._foot_geom_ids):
                if c.geom1 == gid or c.geom2 == gid:
                    # MuJoCo's contact normal points from geom1 toward geom2.
                    normal = np.asarray(c.frame[:3]).copy()
                    if c.geom1 == gid:
                        normal = -normal
                    out[k].append((np.asarray(c.pos).copy(), normal))
        return out

    # -- terrain sensing ------------------------------------------------
    def _raycast(self, center_xy, yaw, rows, cols, resolution):
        """Heights (rows, cols) float32 under a yaw-aligned grid (JAX package
        :212-235): vertical rays from 5 m, terrain geoms (group 2) only, -5 where
        nothing is hit. The cells' xy is GridHeightMap.cell_world_xy in float32."""
        center = np.asarray(center_xy, F32)
        yaw, res = F32(yaw), F32(resolution)
        gx = (np.arange(rows, dtype=F32) - F32((rows - 1) / 2.0))[:, None] * res
        gy = (np.arange(cols, dtype=F32) - F32((cols - 1) / 2.0))[None, :] * res
        c, s = cosf(yaw), sinf(yaw)
        wx = center[0] + c * gx - s * gy
        wy = center[1] + s * gx + c * gy
        heights = np.zeros((rows, cols), F32)
        geomid = np.zeros(1, np.int32)
        geomgroup = np.zeros(6, np.uint8)
        geomgroup[2] = 1
        down = np.array([0.0, 0.0, -1.0])
        for i in range(rows):
            for j in range(cols):
                start = np.array([wx[i, j], wy[i, j], 5.0])
                dist = mujoco.mj_ray(self.model, self.data, start, down, geomgroup, 1, -1,
                                     geomid)
                heights[i, j] = 5.0 - dist if dist >= 0 else -5.0
        return center, yaw, res, heights

    def heightmap(self, center_xy, yaw: float, rows: int = 13, cols: int = 7,
                  resolution: float = 0.04, device="cuda") -> GridHeightMap:
        """Ray-cast heightmap around a point (counterpart of gym_quadruped's
        HeightMap sensor, reference simulation.py:489-509) on ``device``."""
        dev = resolve_device(device)
        return GridHeightMap(*(torch.as_tensor(x, device=dev) for x in
                               self._raycast(center_xy, yaw, rows, cols, resolution)))

    def leg_heightmaps(self, ref_feet: Legs, yaw: float, device="cuda") -> GridHeightMap:
        """Leg-stacked GridHeightMap (leaves with a leading 4) around the reference
        footholds, on ``device``: the TAMOLS planner's input."""
        dev = resolve_device(device)
        tp = self.cfg.tamols
        grids = [self._raycast(np.asarray(ref_feet[leg])[:2], yaw, tp.heightmap_rows,
                               tp.heightmap_cols, tp.heightmap_resolution) for leg in LEGS]
        return GridHeightMap(*(torch.as_tensor(np.stack(x), device=dev) for x in zip(*grids)))
