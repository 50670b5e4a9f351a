"""MPC controller dispatch layer.

Counterpart of ``quadruped_pympc_tamols_tpu/interfaces/controller_interface.py``
(reference interfaces/srbd_controller_interface.py:27-245): builds the controller
from the config, reads its one host result per tick, masks the returned GRFs by
the current contact (:225-230) and undoes the float32 recentering. Ported: the
sampling family with the gait-adaptive sampler (``mpc.optimize_step_freq``), and
the gradient family: the nominal RTI-SQP (``mpc.type="nominal"``, its RTI split,
the DDP solver under ``mpc.gradient.use_DDP``, and in
``SRBDBatchedControllerInterface`` its batched gait-frequency search), and the
variant core (``VariantGradientMPC``) for the stability, ZMP and
foothold-optimization knobs of "nominal" and for the types "input_rates",
"lyapunov", "collaborative" and "kinodynamic", whose joint trajectories the
interface hands on as ``nmpc_joints_pos`` / ``nmpc_joints_vel``. Both families
track the reference footholds and ignore the TAMOLS boxes
(``ref_foot_constraints``), as the JAX interface does.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..controllers.gradient.sqp import BatchedGradientMPC, GradientMPC
from ..controllers.gradient.variants import VariantGradientMPC
from ..controllers.sampling.gait_adaptive import GaitAdaptiveSamplingMPC, host_best_freq
from ..controllers.sampling.sampling_mpc import SamplingMPC, host_summary
from ..gait.periodic import contact_sequence, make_timer_dts
from ..utils.legs import Legs


def recenter_state_and_reference(state_current: dict, ref_state: dict):
    """Shift the world so the base is at xy = 0 (reference perform_scaling,
    centroidal_nmpc_nominal.py:1116-1135): float32 solvers lose torque-arm
    precision at O(100 m) absolute coordinates. Returns (state, ref, shift);
    position-valued outputs must add ``shift`` back."""
    shift = np.zeros(3)
    shift[:2] = np.asarray(state_current["position"], np.float64).reshape(3)[:2]
    state_current = dict(state_current)
    ref_state = dict(ref_state)
    for k in ("position", "foot_FL", "foot_FR", "foot_RL", "foot_RR"):
        state_current[k] = np.asarray(state_current[k], np.float64).reshape(3) - shift
    for k in ("ref_position", "ref_foot_FL", "ref_foot_FR", "ref_foot_RL", "ref_foot_RR"):
        ref_state[k] = np.asarray(ref_state[k], np.float64).reshape(-1, 3) - shift
    ref_state["ref_position"] = ref_state["ref_position"].reshape(3)
    return state_current, ref_state, shift


class SRBDControllerInterface:
    def __init__(self, cfg: Config, seed: int = 42, device="cuda"):
        self.cfg = cfg
        self.type = cfg.mpc.type
        self.best_sample_freq = cfg.gait_params.step_freq
        gp = cfg.mpc.gradient
        if self.type == "sampling":
            if cfg.mpc.optimize_step_freq:
                self.controller = GaitAdaptiveSamplingMPC(cfg, seed=seed, device=device)
            else:
                self.controller = SamplingMPC(cfg, seed=seed, device=device)
        elif self.type == "nominal":
            if gp.use_static_stability or gp.use_zmp_stability or gp.use_foothold_optimization:
                self.controller = VariantGradientMPC(cfg, "nominal", device=device)
            else:
                self.controller = GradientMPC(cfg, device=device)
        elif self.type in ("input_rates", "lyapunov", "collaborative", "kinodynamic"):
            self.controller = VariantGradientMPC(cfg, self.type, device=device)
        else:
            raise ValueError(f"unsupported mpc type {self.type!r}")
        self._inflight = None
        self.nmpc_joints_pos = self.nmpc_joints_vel = None
        # Only the nominal RTI solver consumes runtime inertia (JAX package
        # :63-66); callers use this to skip computing the composite tensor, a loop
        # over every MuJoCo body, and ``compute_control`` evaluates a callable
        # ``inertia`` only for it.
        self.consumes_inertia = isinstance(self.controller, GradientMPC)

    def compute_control(self, state_current: dict, ref_state: dict, contact_sequence,
                        inertia=None, mass=None, external_wrenches=None,
                        current_contact=None, previous_contact=None,
                        phase_signal=None, optimize_swing: int = 0):
        """Returns (nmpc_GRFs: Legs, nmpc_footholds: Legs, best_sample_freq,
        nmpc_predicted_state)."""
        cur = np.asarray(current_contact if current_contact is not None
                         else contact_sequence[:, 0], np.float32)
        prev = np.asarray(previous_contact if previous_contact is not None else cur, np.float32)
        state_current, ref_state, shift = recenter_state_and_reference(state_current, ref_state)
        if self.type == "sampling":
            grfs, footholds, predicted = self._sampling_control(
                state_current, ref_state, contact_sequence, cur, prev, phase_signal,
                optimize_swing)
        else:
            # Runtime inertia reaches the solver only where it is consumed; a
            # callable is evaluated only then (JAX package :111-125).
            extra = {}
            if inertia is not None and self.consumes_inertia:
                extra = dict(inertia=inertia() if callable(inertia) else inertia, mass=mass)
            grfs, footholds, predicted, _, _ = self.controller.compute_control(
                state_current, ref_state, contact_sequence,
                external_wrenches=external_wrenches, **extra)
            # The kinodynamic variant's joint trajectories, for the whole-body layer
            # (reference srbd_controller_interface.py:184-207).
            self.nmpc_joints_pos = getattr(self.controller, "nmpc_joints_pos", None)
            self.nmpc_joints_vel = getattr(self.controller, "nmpc_joints_vel", None)

        # Mask by current contact (reference srbd_controller_interface.py:225-230).
        grfs = grfs * cur[:, None]
        footholds = np.asarray(footholds, np.float64) + shift
        predicted = np.asarray(predicted, np.float64).copy()
        predicted[:3] = predicted[:3] + shift
        return Legs(grfs), Legs(footholds), self.best_sample_freq, predicted

    def _sampling_control(self, state_current, ref_state, contact_sequence, cur, prev,
                          phase_signal, optimize_swing):
        """The sampling family's tick: (GRFs, footholds, predicted state), host numpy."""
        if self.cfg.mpc.optimize_step_freq:
            out = self.controller.compute_control(
                state_current, ref_state, contact_sequence, cur, prev,
                phase_signal if phase_signal is not None else np.zeros(4),
                self.best_sample_freq, optimize_swing)
        else:
            out = self.controller.compute_control(state_current, ref_state, contact_sequence,
                                                  cur, prev)
        if self.cfg.mpc.sampling.pipelined:
            # Async pipelining (config sampling.pipelined): return the PREVIOUS
            # tick's solution, whose summary copy has completed during the plant
            # step, and leave this tick's solve in flight. The warm start and the
            # random stream already advanced; only the host result is one tick stale.
            prev_out, self._inflight = self._inflight, out
            if prev_out is not None:
                out = prev_out
        grfs, predicted, _ = host_summary(out)
        if self.cfg.mpc.optimize_step_freq and optimize_swing:
            self.best_sample_freq = host_best_freq(out)
        footholds = np.stack([np.asarray(ref_state[f"ref_foot_{leg}"]).reshape(3)
                              for leg in ("FL", "FR", "RL", "RR")])
        return grfs, footholds, predicted

    def compute_rti(self):
        """RTI preparation phase for the next tick (JAX package :135-139): the
        nominal solver dispatches its preparation without waiting (with
        ``mpc.gradient.use_RTI``); a no-op on the sampling family, whose warm-start
        shift runs after the solve."""
        if hasattr(self.controller, "compute_rti_prepare"):
            self.controller.compute_rti_prepare()

    def reset(self):
        self.controller.reset()
        self.best_sample_freq = self.cfg.gait_params.step_freq
        self._inflight = None


class SRBDBatchedControllerInterface:
    """Batched gait-frequency optimization of the gradient family (counterpart of
    the JAX package's, reference interfaces/srbd_batched_controller_interface.py:
    32-80): one batched solve over the candidate frequencies."""

    def __init__(self, cfg: Config, device="cuda"):
        self.cfg = cfg
        self.controller = BatchedGradientMPC(cfg, device=device)

    def optimize_gait(self, state_current: dict, ref_state: dict, pgg_phase_signal,
                      pgg_duty_factor):
        """Builds one contact sequence per candidate step frequency from the current
        gait phase (reference :64-76) and returns the best frequency."""
        # The same float32 recentering as the main solve; only a frequency comes back.
        state_current, ref_state, _ = recenter_state_and_reference(state_current, ref_state)
        t_off = make_timer_dts(self.cfg.mpc)
        freqs = np.asarray(self.cfg.mpc.step_freq_available, np.float32)
        phase = np.tile(np.asarray(pgg_phase_signal, np.float32), (len(freqs), 1))
        seqs = contact_sequence(phase, freqs, pgg_duty_factor, t_off)
        _, best = self.controller.optimize_gait(state_current, ref_state, seqs)
        return best
