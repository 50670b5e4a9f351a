"""Interactive tuning console.

Counterpart of ``quadruped_pympc_tamols_tpu/runtime/console.py`` over the port's
``QuadrupedPyMPCWrapper``, and of the reference readline CLI (ros2/console.py:27-175): start/stop
walking, gait switching, step frequency / duty factor / stance width, swing and
impedance gains, height and pitch offsets — applied live to a running wrapper or
ControllerNode. Commands are plain callables so the console also works scripted
(tests) without a TTY.
"""
from __future__ import annotations

import shlex

import numpy as np

from ..config import GAITS


class Console:
    def __init__(self, wrapper):
        """``wrapper`` is a QuadrupedPyMPCWrapper (or anything with wb_interface)."""
        self.wrapper = wrapper
        self.velocity_cmd = np.zeros(3)
        self.yaw_rate_cmd = 0.0
        self.walking = False
        self.impedance_gains = None  # (kp, kd) once set via impedance_gains
        self.commands = {
            "start": self.cmd_start, "stop": self.cmd_stop, "vel": self.cmd_vel,
            "gait": self.cmd_gait, "step_freq": self.cmd_step_freq,
            "duty_factor": self.cmd_duty_factor, "stance_width": self.cmd_stance_width,
            "step_height": self.cmd_step_height, "swing_gains": self.cmd_swing_gains,
            "height_delta": self.cmd_height_delta, "help": self.cmd_help,
            "impedance_gains": self.cmd_impedance_gains,
            "pitch_delta": self.cmd_pitch_delta,
        }

    # -- commands ----------------------------------------------------------
    def cmd_start(self):
        self.walking = True
        return "walking"

    def cmd_stop(self):
        self.walking = False
        self.velocity_cmd[:] = 0.0
        return "stopped"

    def cmd_vel(self, vx, vy=0.0, yaw_rate=0.0):
        self.velocity_cmd = np.array([float(vx), float(vy), 0.0])
        self.yaw_rate_cmd = float(yaw_rate)
        return f"vel {self.velocity_cmd[:2]} yaw_rate {self.yaw_rate_cmd}"

    def cmd_gait(self, name):
        if name not in GAITS:
            return f"unknown gait {name!r}; options: {sorted(GAITS)}"
        wb = self.wrapper.wb_interface
        g = GAITS[name]
        wb.pgg.gait_type = g.gait_type
        wb.pgg.previous_gait_type = g.gait_type
        wb.pgg.duty_factor = g.duty_factor
        wb.pgg.step_freq = g.step_freq
        wb.pgg.reset()
        wb.frg.stance_time = g.stance_time
        wb.stc.regenerate_swing_trajectory_generator(wb.step_height, g.swing_period)
        return f"gait -> {name}"

    def cmd_step_freq(self, f):
        wb = self.wrapper.wb_interface
        wb.pgg.step_freq = float(f)
        wb.frg.stance_time = wb.pgg.duty_factor / wb.pgg.step_freq
        wb.stc.regenerate_swing_trajectory_generator(
            wb.step_height, (1 - wb.pgg.duty_factor) / wb.pgg.step_freq)
        return f"step_freq -> {f}"

    def cmd_duty_factor(self, d):
        wb = self.wrapper.wb_interface
        wb.pgg.duty_factor = float(d)
        return f"duty_factor -> {d}"

    def cmd_stance_width(self, offset):
        self.wrapper.wb_interface.frg.hip_offset = float(offset)
        return f"hip_offset -> {offset}"

    def cmd_step_height(self, h):
        wb = self.wrapper.wb_interface
        wb.step_height = float(h)
        wb.stc.step_height = float(h)
        return f"step_height -> {h}"

    def cmd_swing_gains(self, kp, kd):
        stc = self.wrapper.wb_interface.stc
        stc.position_gain_fb = float(kp)
        stc.velocity_gain_fb = float(kd)
        return f"swing gains kp={kp} kd={kd}"

    def cmd_height_delta(self, dz):
        # Applied through the CoM-offset hack slot the reference exposes
        # (foothold_reference_generator.py:32-33).
        self.wrapper.wb_interface.frg.com_pos_offset_b[2] += float(dz)
        return f"com z offset -> {self.wrapper.wb_interface.frg.com_pos_offset_b[2]:.3f}"

    def cmd_impedance_gains(self, kp, kd):
        """Joint-PD impedance gains (reference console.py impedance commands).
        Stored on the console; the driving loop (controller node / sim harness)
        reads them when applying the joint PD."""
        self.impedance_gains = (float(kp), float(kd))
        return f"impedance gains kp={kp} kd={kd}"

    def cmd_pitch_delta(self, dp):
        """Reference-pitch offset (reference console.py pitch commands)."""
        te = self.wrapper.wb_interface.terrain_estimator
        te.pitch_offset += float(dp)
        return f"pitch offset -> {te.pitch_offset:.3f}"

    def cmd_help(self):
        return "commands: " + " ".join(sorted(self.commands))

    # -- dispatch ----------------------------------------------------------
    def execute(self, line: str) -> str:
        parts = shlex.split(line)
        if not parts:
            return ""
        name, args = parts[0], parts[1:]
        fn = self.commands.get(name)
        if fn is None:
            return f"unknown command {name!r} ({self.cmd_help()})"
        try:
            return str(fn(*args))
        except TypeError as e:
            return f"usage error: {e}"

    def repl(self):  # pragma: no cover - interactive only
        import readline  # noqa: F401  (history/editing)

        print(self.cmd_help())
        while True:
            try:
                line = input("qpympc> ")
            except (EOFError, KeyboardInterrupt):
                break
            if line.strip() in ("exit", "quit"):
                break
            out = self.execute(line)
            if out:
                print(out)
