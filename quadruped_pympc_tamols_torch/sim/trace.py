"""Replay a recorded MuJoCo control loop through the port.

``tools/record_mujoco_trace.py`` saves every input of the JAX package's
``QuadrupedPyMPCWrapper.compute_actions`` over an episode, with its outputs, to
an ``.npz`` (``tests/fixtures/torch_mujoco_trace.npz``). ``ControlTrace`` reads
it back: ``inputs(i)`` gives step i's keyword arguments for the port's
``compute_actions`` (heightmaps as the port's GridHeightMap on the planner's
device), and ``torque_args(i)`` the arguments of
``WBInterface.compute_stance_and_swing_torque`` with the recorded solve.
No MuJoCo is needed.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from ..planner.heightmap import GridHeightMap
from ..utils.legs import Legs

FIXTURE = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fixtures" / \
    "torch_mujoco_trace.npz"
LEG_ARGS = ("feet_pos", "hip_pos", "joints_pos", "qpos_js", "qvel_js", "feet_jac",
            "feet_jac_dot", "feet_vel", "legs_qfrc_bias", "legs_mass_matrix",
            "legs_qfrc_passive")
VEC_ARGS = ("com_pos", "base_pos", "base_lin_vel", "base_ori_euler_xyz", "base_ang_vel",
            "ref_base_lin_vel", "ref_base_ang_vel")


class ControlTrace:
    def __init__(self, path=FIXTURE):
        with np.load(path) as f:
            self.arrays = {k: f[k] for k in f.files}
        self.config = json.loads(str(self.arrays["config_json"]))
        self.steps = len(self.arrays["tau"])
        self._sensed = {int(s): k for k, s in enumerate(self.arrays["hm_steps"])}

    def heightmaps(self, i, device="cpu"):
        """Step i's leg-stacked GridHeightMap on ``device``, or None if the loop
        did not sense on that step."""
        k = self._sensed.get(i)
        if k is None:
            return None
        a = self.arrays
        return GridHeightMap(*(torch.tensor(a[name][k], device=device) for name in
                               ("hm_center", "hm_yaw", "hm_resolution", "hm_heights")))

    def contact_points(self, i):
        """Step i's per-leg lists of (pos, normal) MuJoCo contact points."""
        a = self.arrays
        return [[(p[:3].copy(), p[3:].copy())
                 for p in a["contact_points"][i, leg, :a["contact_counts"][i, leg]]]
                for leg in range(4)]

    def inputs(self, i, device="cpu", contact_points=False):
        """Keyword arguments of compute_actions at step i."""
        a = self.arrays
        kw = {k: a[k][i].copy() for k in VEC_ARGS}
        kw.update({k: Legs(a[k][i].copy()) for k in LEG_ARGS})
        kw["simulation_dt"] = float(a["simulation_dt"][i])
        kw["heightmaps"] = self.heightmaps(i, device)
        kw["contact_points"] = self.contact_points(i) if contact_points else None
        return kw

    def update_args(self, i, device="cpu"):
        """Arguments of WBInterface.update_state_and_reference at step i."""
        kw = self.inputs(i, device)
        return dict(com_pos=kw["com_pos"], base_pos=kw["base_pos"],
                    base_lin_vel=kw["base_lin_vel"],
                    base_ori_euler_xyz=kw["base_ori_euler_xyz"],
                    base_ang_vel=kw["base_ang_vel"], feet_pos=kw["feet_pos"],
                    hip_pos=kw["hip_pos"], joints_pos=kw["joints_pos"],
                    heightmaps=kw["heightmaps"], simulation_dt=kw["simulation_dt"],
                    ref_base_lin_vel=kw["ref_base_lin_vel"],
                    ref_base_ang_vel=kw["ref_base_ang_vel"])

    def torque_args(self, i, optimize_swing=None, best_sample_freq=None,
                    contact_points=False):
        """Arguments of WBInterface.compute_stance_and_swing_torque at step i with
        the recorded GRFs and footholds."""
        a = self.arrays
        kw = self.inputs(i, contact_points=contact_points)
        return dict(simulation_dt=kw["simulation_dt"], qpos_js=kw["qpos_js"],
                    qvel_js=kw["qvel_js"], feet_jac=kw["feet_jac"],
                    feet_jac_dot=kw["feet_jac_dot"], feet_pos=kw["feet_pos"],
                    feet_vel=kw["feet_vel"], legs_qfrc_bias=kw["legs_qfrc_bias"],
                    legs_mass_matrix=kw["legs_mass_matrix"],
                    nmpc_GRFs=Legs(a["grfs"][i].copy()),
                    nmpc_footholds=Legs(a["footholds"][i].copy()),
                    optimize_swing=int(a["optimize_swing"][i] if optimize_swing is None
                                       else optimize_swing),
                    best_sample_freq=(self.config["gait_params"]["step_freq"]
                                      if best_sample_freq is None else best_sample_freq),
                    base_pos=kw["base_pos"], base_rpy=kw["base_ori_euler_xyz"],
                    legs_qfrc_passive=kw["legs_qfrc_passive"],
                    contact_points=kw["contact_points"])
