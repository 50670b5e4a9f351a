"""Deployment-path control node: the whole-body loop fed by an MPC in one of four modes.

Counterpart of ``quadruped_pympc_tamols_tpu/runtime/controller_node.py`` (reference
ros2/run_controller.py:97-560) without ROS. Each ``control_tick`` updates the
planners, takes an MPC solution and maps it to joint torques; the MPC runs

* "inline": in the tick, every tick;
* "pipelined": inline with ``mpc.sampling.pipelined`` (the sampling family hands
  back the previous tick's solution and leaves this tick's solve on the card);
* "thread": in a background thread that solves the latest inputs over and over
  and publishes each solution under a lock; the tick takes the latest;
* "shared_memory": as "thread", publishing through the native seq-locked
  ``ControlBus`` (``runtime/control_bus.cpp``), the layout a separate MPC process
  uses on a robot.

State I/O is a provider callable returning the dict of the MuJoCo env's readers
(``sim/simulation.py``), so the same node runs against a simulator, a recorded
loop (``sim/trace.py``) or a state estimator.

On the card, "thread" and "shared_memory" give the MPC thread its own CUDA stream
and the control thread another: a solver that captures a CUDA graph at its first
call (the gradient family, ``utils/graphs.py``, with ``capture_error_mode=
"thread_local"``) captures on the MPC thread while the control thread may launch
the TAMOLS scorer at an apex, and that work must never join the capturing stream.
A solution is published only once its device-to-host copy has completed (the
interface returns host arrays after waiting for it) and as copies, so that a
pinned buffer the solver reuses at its next tick is never read. The MPC thread
gains only while it waits on the card: its host code holds the GIL as the
control thread's does.
"""
from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..config import Config, replace_config
from ..interfaces.controller_interface import SRBDControllerInterface
from ..interfaces.wb_interface import WBInterface
from ..utils.device import resolve_device
from ..utils.legs import Legs
from .control_bus import ControlBus, pack_control_block, unpack_control_block

MODES = ("inline", "pipelined", "thread", "shared_memory")


class ControllerNode:
    def __init__(self, cfg: Config, initial_feet_pos: Legs, mpc_mode: str = "inline",
                 bus_name: str = "/qpympc_control", seed: int = 0, device="cuda"):
        if mpc_mode not in MODES:
            raise ValueError(f"mpc_mode must be one of {MODES}, not {mpc_mode!r}")
        self.device = resolve_device(device)
        if mpc_mode == "pipelined":
            cfg = replace_config(cfg, **{"mpc.sampling.pipelined": True})
            mpc_mode = "inline"
        self.cfg = cfg
        self.mpc_mode = mpc_mode
        self.wb = WBInterface(cfg, initial_feet_pos, device=self.device)
        self.ctrl = SRBDControllerInterface(cfg, seed=seed, device=self.device)
        self._latest = None
        self._latest_lock = threading.Lock()
        self._mpc_inputs = None
        self._stop = threading.Event()
        self._solve_ms = 0.0
        self.solves = 0  # solves completed (the background modes' rate)
        self._error = None  # what stopped the MPC thread, raised by the next tick
        self.best_freq = cfg.gait_params.step_freq
        self.bus = None
        cuda = self.device.type == "cuda"
        background = mpc_mode in ("thread", "shared_memory")
        self._ctrl_stream = torch.cuda.Stream(self.device) if cuda and background else None
        self._mpc_stream = torch.cuda.Stream(self.device) if cuda and background else None
        if self._mpc_stream is not None:
            # The interfaces' buffers were filled on the current stream above.
            current = torch.cuda.current_stream(self.device)
            self._mpc_stream.wait_stream(current)
            self._ctrl_stream.wait_stream(current)
        self._thread = None
        if mpc_mode == "thread":
            self._thread = threading.Thread(target=self._mpc_thread_main, daemon=True)
        elif mpc_mode == "shared_memory":
            self.bus = ControlBus(bus_name, create=True)
            self._thread = threading.Thread(target=self._mpc_bus_main, daemon=True)
        if self._thread is not None:
            self._thread.start()

    # ------------------------------------------------------------------
    def _on_stream(self, stream):
        return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()

    def _solve(self, inputs):
        state_current, ref_state, contact_sequence, optimize_swing, cur, prev, phase = inputs
        t0 = time.perf_counter()
        grfs, footholds, freq, predicted = self.ctrl.compute_control(
            state_current, ref_state, contact_sequence, current_contact=cur,
            previous_contact=prev, phase_signal=phase, optimize_swing=optimize_swing)
        self._solve_ms = (time.perf_counter() - t0) * 1e3
        self.solves += 1
        return (Legs(np.array(grfs.data)), Legs(np.array(footholds.data)), freq,
                np.array(predicted))

    def _background(self, publish):
        try:
            with self._on_stream(self._mpc_stream):
                while not self._stop.is_set():
                    inputs = self._mpc_inputs
                    if inputs is None:
                        time.sleep(0.0005)
                        continue
                    publish(self._solve(inputs))
        except BaseException as e:  # the control thread re-raises it at its next tick
            self._error = e
            raise

    def _mpc_thread_main(self):
        def publish(out):
            with self._latest_lock:
                self._latest = out

        self._background(publish)

    def _mpc_bus_main(self):
        def publish(out):
            grfs, footholds, freq, predicted = out
            self.bus.write(pack_control_block(
                grfs.data, footholds.data, np.zeros(12), np.zeros(12), np.zeros(12),
                np.asarray(predicted).reshape(-1)[:12], freq, self._solve_ms, 0.0))

        self._background(publish)

    # ------------------------------------------------------------------
    def control_tick(self, state_provider, ref_base_lin_vel, ref_base_ang_vel,
                     simulation_dt: float):
        """One whole-body tick: update the planners, take an MPC solution (solve it
        inline, or read the latest the MPC thread published), map torques.

        ``state_provider()`` returns the robot state dict with the keys of the
        MuJoCo env's readers (``sim/simulation.py``). Before the first published
        solution the background modes command zero GRFs at the current feet."""
        with self._on_stream(self._ctrl_stream):
            return self._tick(state_provider, ref_base_lin_vel, ref_base_ang_vel, simulation_dt)

    def _tick(self, state_provider, ref_base_lin_vel, ref_base_ang_vel, simulation_dt):
        s = state_provider()
        (state_current, ref_state, contact_sequence, _, optimize_swing) = \
            self.wb.update_state_and_reference(
                s["com_pos"], s["base_pos"], s["base_lin_vel"], s["base_ori_euler_xyz"],
                s["base_ang_vel"], s["feet_pos"], s["hip_pos"], s["joints_pos"],
                s.get("heightmaps"), simulation_dt, ref_base_lin_vel, ref_base_ang_vel)
        inputs = (state_current, ref_state, contact_sequence, optimize_swing,
                  np.array(self.wb.current_contact), np.array(self.wb.previous_contact),
                  np.array(self.wb.pgg.phase_signal))
        if self.mpc_mode == "inline":
            grfs, footholds, freq, _ = self._solve(inputs)
        else:
            if self._error is not None:
                raise RuntimeError("the MPC thread failed") from self._error
            self._mpc_inputs = inputs
            if self.mpc_mode == "thread":
                with self._latest_lock:
                    out = self._latest
                seq = 0 if out is None else 1
            else:
                seq, block = self.bus.read()
                if seq:
                    d = unpack_control_block(block)
                    out = (Legs(d["grfs"]), Legs(d["footholds"]), d["best_freq"], None)
            if seq == 0:
                grfs, footholds, freq = Legs.zeros((3,)), s["feet_pos"], self.best_freq
            else:
                grfs, footholds, freq, _ = out
        self.best_freq = freq

        return self.wb.compute_stance_and_swing_torque(
            simulation_dt, s["joints_pos"], s["joints_vel"], s["feet_jac"], s["feet_jac_dot"],
            s["feet_pos"], s["feet_vel"], s["legs_qfrc_bias"], s["legs_mass_matrix"], grfs,
            footholds, optimize_swing, freq, base_pos=s["base_pos"],
            base_rpy=s["base_ori_euler_xyz"], legs_qfrc_passive=s.get("legs_qfrc_passive"),
            contact_points=s.get("contact_points"),
            nmpc_joints_pos=getattr(self.ctrl, "nmpc_joints_pos", None),
            nmpc_joints_vel=getattr(self.ctrl, "nmpc_joints_vel", None))

    def shutdown(self):
        """Stop the MPC thread (after the solve in progress) and close the bus; raises
        if the thread has not stopped within a minute."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            if self._thread.is_alive():
                raise RuntimeError("the MPC thread did not stop within 60 s")
        if self.bus is not None:
            self.bus.close()
            self.bus = None
