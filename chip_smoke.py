#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Builds the port's kernels from the sources in the checkout (one nvcc per source
and (horizon, parameters per leg) pair, all started together), holds each against
its plain torch version at the main path's shapes, drives the slices' paths (the
sampling MPC walking the SRB harness, README quickstart) through the kernels, and
times them; then the same for the linear-spline and zero-order parametrizations;
then the TAMOLS foothold planner, card against CPU, and the default configuration
walking over sensed terrain with it; then the torque path and the wrapper on a
recorded MuJoCo loop; then the gradient family's nominal RTI-SQP (CUDA graphs of
torch ops): its solve against the CPU and float64, its QP ladder, its walks and
the wrapper with it; then the gradient variants and the DDP solver, each solve
one CUDA graph: against the CPU and float64, their ticks, their walks and the
kinodynamic wrapper; then the scenario fleet's kernel K1f and the fleet's
walks and throughput. It imports neither JAX nor the JAX package.
It exits non-zero without a CUDA device or without the package beside it.

Output: the card's name and power limit, one line per phase, for each row the
rollout pass's device time and its kernel's registers, shared memory and spills
(from the build's ``-Xptxas -v`` log), the same for the update pass of the MPPI
and CEM rows (K1b, K1c, K1e-mppi, K1e-cem), the extraction kernel of the random
sampling rows (K1a, K1e-rs) and the chain kernel of the K1d rows, a "tamols:"
line with phases 16-17's numbers as JSON, a "torque:" line with phase 18's, a
"gradient:" line with phases 19-21's, a "variants:" line with phases 22-24's, a
"fleet:" line with phases 25-27's, a ``{"kernels": ...}`` line (rows of
the main path's cubic splines, then ``-lin`` and ``-zo`` rows, then K1f's), and as the last
line ``{"ok": true, "device": {...}}``.

Phases (each raises on failure; every path is driven with all launch counts set
to 0 just before it and read just after):
  1. K1a against its plain version on the same injected noise, N = 10 000,
     H = 12, P = 96 (the main path's shape: cubic splines, 2 splines).
  2. K1a's Philox noise: band statistics, the incumbent column, determinism (bits
     of a rerun), and the plain version reproducing the kernel's costs on the
     dumped noise.
  3. The first slice's path: SRBClosedLoopHarness(cfg, device="cuda").run(3.0,
     [0.3, 0, 0]) at N = 10 000 (random sampling, one iteration) must walk,
     with K1a launched once per MPC tick.
  4. Times of K1a: the kernel and its plain version (CUDA events, median of 100
     launches), the device time of its rollout and extraction kernels, the
     per-tick solve with its host glue, the harness's rate, and a profile of 50
     solve ticks (device time per recorded launch).
  5. K1b (MPPI) and K1c (CEM-MPPI) at N = 10 000: costs against the plain
     version on the same injected noise; the optimizer step against the plain
     combine on the kernel's own costs (beta exactly, parameters and sigma' to
     1e-5, elite indices exactly); a NaN state, where every cost ties at 1e6;
     Philox noise, dumped and checked the same way, bit-identical on a rerun.
  6. K1d, the chain kernel: three chained iterations of each method in one
     launch; iteration i repeats bit for bit as one K1a/K1b/K1c iteration from
     iteration i - 1's device outputs, and passes the phase-5 checks on its dumped
     noise; the chain kernel's machine code reads nothing through the read-only
     (non-coherent) path but sincosf's constant table.
  7. The MPPI x 3 walk (one K1d launch a tick, no K1b) must walk; the profiler
     over 50 solve ticks must see exactly one device-to-host copy a tick, the
     chain kernel once a tick and no memset; then MPPI x 1 (one K1b launch a
     tick) runs TICK_LOOP ticks through its controller on the flagship inputs.
  8. A CEM-MPPI closed loop (3 iterations a tick, one K1d launch) for 3 s: finite
     GRFs and a sigma inside [cem_sigma_min, cem_sigma_max] on every tick. The JAX
     reference falls in this configuration too, so the walk is not asserted.
     Then CEM-MPPI x 1 (one K1c launch a tick) for TICK_LOOP ticks, held so.
  9. Times of K1b and K1c, and of K1d (MPPI x 3, CEM x 3 and random sampling x 3
     as one solve) through its wrapper sampling_chain, through its C entry with
     prebuilt arguments and on the card, beside the successive single launches
     that chained them before (through the wrapper and prebuilt); their plain
     versions and bounds, the chain kernel's blocks an SM, and the solve tick with
     its host glue for MPPI x 3 and CEM x 3.
 10. K1e (gait-adaptive groups, K = 3) for each method at N = 10 000, 9999 samples
     evaluated: against the plain version on injected numpy noise and on its
     dumped Philox noise (band edges of N over 9999 samples), bit-identical on a
     rerun; a NaN state, where every cost is 1e6 plus its group's offset, so the
     winner is the first sample of the lowest-offset group, CEM's elites its first
     samples, and the solver maps that group to its frequency.
 11. This slice's path: the gait-adaptive quickstart walk (mpc.optimize_step_freq)
     for random sampling and MPPI must walk with K1e launched once a tick and K1a-K1c
     never; a CEM-MPPI gait-adaptive closed loop keeps finite GRFs and its sigma in
     range; the profiler over 50 solve ticks must see one device-to-host copy a tick.
 12. Times of K1e per method (and the device time of each of its kernels), its
     plain version and bound, and the gait-adaptive solve tick with its host glue.
 13. For linear splines (P = 36) and zero-order holds (P = 144): phases 1-2, 5-6
     and 10, each kernel against its plain version on injected noise and on its
     Philox noise, bit-equal on a rerun, and MPPI x 3 chained.
 14. Their paths, each with the launch counts zeroed before and read after: the
     walks whose JAX reference walks (random sampling x 1 with either, 300 K1a
     launches; MPPI x 3 with zero-order holds, 300 K1d launches) must walk; MPPI x 3
     with linear splines, CEM-MPPI x 3 (K1d), MPPI x 1 and CEM-MPPI x 1 (K1b, K1c)
     and the gait-adaptive solver's three methods with either run TICK_LOOP ticks
     through their controller on the flagship inputs, held per solve (finite
     summaries, CEM's sigma in range).
 15. Their times, as phases 4, 9 and 12, and the update pass's and the chain
     kernel's blocks an SM.
 16. The TAMOLS foothold scorer (torch ops, no kernel of its own), "tamols" and
     "height", on the card against the same scorer on the CPU: the three terrains
     of tests/test_tamols.py at the default 13 x 7 grid, each with its nominal
     input and 16 seeded random seed/hip sets; the same feasibility and chosen cell
     (another cell only where the CPU's two best costs tie within 1e-5, printed),
     footholds within 1e-5 m, finite costs within a relative 1e-5. Then its host ms
     per apex call with its one copy back, its launches and device time per call
     (torch.profiler) and one device-to-host copy a call.
 17. The default configuration's path ("tamols", random sampling x 1, cubic
     splines, N = 10 000, H = 12, on K1a): 3 s at 0.3 m/s on flat ground and onto a
     5 cm step up at x > 0.6 m, and "height" on the step, sensing as the JAX
     package's MuJoCo loop does and snapping touchdowns to the terrain. Each must
     walk, trigger the adaptation at least 6 times and launch K1a once an MPC tick
     (300); printed beside the JAX package's walk: the triggers, the scorer's ms
     per apex call and launches per call, the median solve tick on apex ticks and
     on the others, and the harness's rate.
 18. The torque path and the facade (``QuadrupedPyMPCWrapper``), host numpy around
     the card's solve, on the JAX package's recorded MuJoCo loop
     (tests/fixtures/torch_mujoco_trace.npz: 1 s of the README's full-physics
     example, "height", N = 10 000; MuJoCo itself is not on the card's machine):
     (a) WBInterface with its planner on the card, fed the recorded GRFs and
     footholds, gives the JAX package's tau, des_q and des_qd to 1e-6 on all 500
     steps; (b) the recorded observations through
     QuadrupedPyMPCWrapper(..., device="cuda").compute_actions with the card's own
     solve: finite torques, stance tau = -J^T f minus the passive forces to 1e-9,
     swing-leg GRFs exactly zero on MPC ticks, the inertia callable never
     evaluated, K1a launched once an MPC tick (100), one device-to-host copy a
     tick that solves (one more on a tick with an apex call) and no operation
     on the card on any other tick; then the host clock of compute_actions
     (median, p99) on MPC ticks and on the others, and its split by layer.
 19. The gradient family's nominal solve (make_config("aliengo",
     mpc_type="nominal"): H = 12, 144 variables, 288 rows, Mehrotra, "balance"),
     torch ops replayed from one captured CUDA graph a phase, no kernel of its
     own: (a) the five golden scenarios' QPs assembled on the card and on the CPU,
     each solve's first-stage GRFs against the float64 reference of the same QP
     (the card's gap at most max(2 x the CPU port's at the card's budget, 0.01 N),
     and the card within 0.01 N of the CPU port at that budget); (b) the graph
     replay bit-equal to the eager function on the card and to a rerun,
     feedback(prepare(x0), x0) bit-equal to solve(x0), a NaN state taking the
     fallback; (c) the host clock (median of 200, each with its one copy) of the
     solve tick from the graph and eagerly, the feedback-phase tick and the
     K = 3 batched solve (its costs against the CPU's at the card's budget);
     (d) device time and kernels a tick (torch.profiler) and exactly one copy a
     tick (host count; the profiler records no more than one a tick); (e) torch.linalg.cholesky_ex, torch.cholesky_solve and two
     torch.linalg.solve_triangular calls on the 144 x 144 Newton matrix.
 20. The QP ladder on the card: 20 real ticks of the SRB harness (nominal,
     blind, 0.3 m/s), first-stage GRF gap to float64 under 0.6 N and 2.5e-3 of
     the weight at the card's budget (tests/test_f64_ladder.py:42-56), and the
     gaps at LADDER_BUDGETS.
 21. Nominal walks on the card beside the JAX package's CPU rows: blind, use_RTI
     (the split: one solve, then a preparation and a feedback each tick, the
     preparation dispatched after each solve as the wrapper does) and the
     default configuration (TAMOLS) onto the 5 cm step, each in the band with
     every solve a graph replay and no sampling kernel; mpc.optimize_step_freq
     through SRBDBatchedControllerInterface.optimize_gait in the harness, one
     batched replay a touch-down window, the frequencies beside the CPU's; the
     recorded MuJoCo loop through QuadrupedPyMPCWrapper with the nominal MPC:
     finite torques, one copy an MPC tick and one an apex call, nothing on the
     card otherwise, and the host clock of compute_actions. Their numbers are
     the "gradient:" JSON line.
 22. The gradient variant core (torch ops, one captured CUDA graph a solve, no
     kernel of its own), for each row of VARIANT_ROWS (the walk table's but
     ddp, plus the foothold boxes and the crawl's ZMP rows) on the golden trot
     tick (a crawl's: the three-stance one): (a) the QP assembled on the card
     against the CPU port from the same inputs, 1e-4 of the largest entry;
     (b) on the card's QP and VARIANT_ENSEMBLE seeded perturbations of its
     Hessian, the first-stage force inputs (GRFs; input_rates' GRF rates) of
     the card's solve and of the CPU port's at the card's budget against the
     float64 solution of the same (soft-augmented) QP: on the tick's QP the
     card's gap at most max(2 x the CPU's, 0.01), on the perturbed copies the
     spread of both, reported; (c) the graph replay bit-equal to the
     eager function on the card and to a rerun, and a NaN state taking the
     fallback; (d) the host clock of the solve tick (median of 200, each with
     its one copy), and kernels and device us a tick with exactly one copy a
     tick (torch.profiler, host count). No sampling kernel launches.
 23. The DDP solver: the sequential and associative Riccati passes on the card
     against each other and the CPU at the shapes of
     tests/test_parallel_riccati.py:31-41 (atol 2e-3, rtol 1e-3); GradientMPC
     with use_DDP as a graph bit-equal to eager on the golden trot and push
     ticks (trot at H = 24), and its
     solve tick at H = 12 (sequential) and H = 24 ("auto": associative).
 24. The variant walks on the card, 3 s at 0.3 m/s blind, one a row of
     VARIANT_WALKS, beside the JAX package's CPU rows (JAX_CPU_VARIANT_WALKS):
     the band where the JAX row walks, upright at height for the static crawl;
     every solve a graph replay, no sampling kernel. The kinodynamic
     controller through QuadrupedPyMPCWrapper on the recorded MuJoCo loop (the
     SRB harness feeds zero joint angles): finite torques, the OCP's
     first-stage joints as the whole-body layer's joint targets on every step,
     one copy an MPC tick (one more an apex call), nothing on the card between.
     Their numbers are the "variants:" JSON line.
 25. K1f, the scenario-axis kernel of the fleet (ops/csrc/sampling_fleet.cu), in
     both its layouts (the four-lane one and the large-batch one the wrapper
     runs from sampling_fleet.CROSSOVER samples in all): each against its plain
     version for each method on injected noise at FLEET_CHECKS (64 scenarios at
     N = 10 000, 1024 and 64 at the JAX bench's 128, ragged 3 x 63 and 2 x 65)
     and the two against each other bit for bit (costs, argmin keys, outputs);
     on Philox noise every layout, its update reading the noise back or drawing
     it again, bit for bit, the noise the pass drew checked against the plain
     version (distinct a scenario, a rerun bit for bit); one scenario in each
     layout bit-equal to K1a / K1b / K1c at their seed and offset; each layout's
     times and passes at FLEET_TIMES, the nonzero softmax weights, K1f's ptxas
     figures, and the crossover sweep (FLEET_SWEEP).
 26. The fleet walks on the card, each tick one replay of the captured graph:
     64 scenarios on perlin terrain with reflexes, random sampling, N = 10 000,
     3 s at 0.25 m/s, every scenario above 0.1 m and the mean forward distance
     within FLEET_DX_BAND of the JAX package's CPU row; a flat MPPI fleet, and a
     flat CEM-MPPI fleet for TICK_LOOP ticks (all three on the large-batch
     layout); the same three for TICK_LOOP ticks at 64 x 128 (the four-lane
     layout); K1f launched once a tick in the layout its S x N picks (plus the
     capture's warm-up runs) and no other sampling kernel or layout; the profiler
     sees one rollout of that layout and one extraction or update a tick and no
     device-to-host copy.
 27. Fleet throughput: scenario-steps per second at S = 64, 256 and 1024 with
     N = 128 and at 64 and 256 with N = 10 000 (perlin, reflexes; graph replays
     on the host clock), the eager tick's host ms, kernels and device us a tick
     and K1f's passes' us (torch.profiler). Phases 25-27 print the "fleet:" JSON
     line and add K1f's rows, one a method and layout, to the kernels line.
 28. The sharded solver: (a) the two knobs the sample-sharded merge needs (the
     drawn column 0 on K1a-K1c and K1f in both layouts, the caller's beta and the
     unnormalized sums on K1b and K1c) against the plain versions, bit-equal
     at their defaults; (b) ``parallel.make_sharded_sampling_solver`` at world size
     1 (NCCL) bit-equal to the single iteration on the same noise, one K1a/K1b/K1c
     launch a call and no K1d, its solve tick (median of 200) beside SamplingMPC's;
     (c) two ranks on the one card over gloo (``--gloo-rank``, host-staged), their
     merge against the plain two-rank merge.
 29. ``parallel.make_multichip_step`` at world size 1: 64 scenarios x 10 000 samples,
     flat and over boxes, 3 s; K1f once a tick; every scenario upright and moving;
     scenario-steps/s beside phase 27's.
 30. ``runtime.ControllerNode`` on the card in the four modes (inline, pipelined,
     thread, shared_memory) for the default configuration and the nominal one over
     the recorded MuJoCo loop: finite torques, K1a once a solve, control_tick host
     ms (median, p99), solves a second; the control bus's write -> read latency.
     Phases 28-30 print the "parallel:" and "runtime:" JSON lines and add their
     launches to the kernels line's K1a-K1c and K1f rows.
 31. The ZMP-band cost (weight 500) on every kernel at N = 10 000, P = 96, on a trot
     with the base 5 cm off the diagonals: K1a, K1b, K1c, K1d (MPPI x 3 and CEM x 3,
     bit-equal to single iterations), K1e (each method) and K1f (each method, both
     layouts, 4 scenarios) against their plain versions, and the band each adds (its
     costs less its costs at weight 0) against the plain band sample by sample; at
     weight 0 every kernel's outputs bit-equal to its outputs at weight 0 with a
     margin every ZMP point lies outside (``OFF_MARGIN``); the rollout pass's device
     us with the band and without. (That no bit moved from the parent commit at
     weight 0 is ``tools/cost_digest.py PARENT_TREE THIS_TREE``'s to show.)
 32. The stone-field entry's sampling knobs (the band at 500, equilibrium_share,
     random sampling) walking the SRB harness 3 s at 0.3 m/s at N = 2 000 and
     10 000, blind on flat ground and with TAMOLS over the 5 cm step, K1a once an
     MPC tick, each beside the JAX package's walk on the CPU (``JAX_CPU_ZMP_WALKS``).
 33. The pair grid ``PAIR_GRID`` ((8, cubic, 2), (16, cubic, 3), (24, cubic, 4),
     (12, linear, 4), (24, zero-order)) built cold together (each pair's seconds);
     at each pair K1a-K1c at N = 10 000 against their plain versions with their
     times, passes and bounds, and K1d, K1e and K1f at PAIR_N against theirs.
 34. CEM with K = 33, 100 and 1 000 of N = 10 000 on K1c, K1d, K1e-cem and K1f (three
     layouts): elite sets equal to the plain selection's, sigma within tolerance,
     the update pass's device us.
 35. ``gait.make_swing_ik_step`` on the card (one CUDA graph) against the CPU over 300
     scripted steps, both generators; its host ms a call with the joints read back.
     Phases 31-35 print the "last slice:" JSON line and add their figures to the
     kernels line's rows.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_MAIN = 10_000
TIMED_RUNS = 100
PLAIN_RUNS = 30
WALK_S, WALK_VEL = 3.0, np.array([0.3, 0.0, 0.0])
# Published FP32 (non-tensor) peak and HBM rate of one H100 SXM at 700 W.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# The kernels' costs are held to their plain version by ops/cost_checks.py: sample
# by sample, and beyond its DRIFT_H (the long pairs of PAIR_GRID, on its
# standing_trot_tick) with the plain version's float64 costs beside.
GRF_ATOL = 1e-3  # N: forces are O(100 N); ~1e-5 relative rounding
STATE_ATOL = 1e-5  # one 0.02 s Euler step from O(1) states
PARAM_ATOL = 1e-6  # the winner is incumbent + noise, rounded once
# The MPPI / CEM step on the kernel's own costs: the weighted sums and the elite
# variance run in another order than torch's (per block, then over blocks).
COMBINE_ATOL = 1e-5
# The JAX package's SRB harness on the CPU, same command (3 s at 0.3 m/s, N = 10 000):
# distance (m), min z (m), max |roll|,|pitch| (rad); `python tests/test_torch_harness.py`
# (with the argument `gait` for the gait-adaptive rows).
JAX_CPU_WALKS = {"random_sampling x 1": (0.8959, 0.3307, 0.0440),
                 "mppi x 3": (0.9095, 0.3444, 0.0229), "cem_mppi x 3": (3.5631, -2.8293, 59.5867),
                 "gait random_sampling": (0.8505, 0.3470, 0.0360),
                 "gait mppi": (0.9036, 0.3484, 0.0260),
                 "gait cem_mppi": (2.8593, 0.2533, 136.8255),
                 "random_sampling x 1 linear_spline": (0.9304, 0.3454, 0.0271),
                 "random_sampling x 1 zero_order": (0.7062, 0.3480, 0.4042),
                 "mppi x 3 zero_order": (0.9069, 0.3476, 0.0249)}
# The parametrizations the kernels are built for at horizon 12: the main path's
# cubic splines (24 parameters per leg), then linear splines (9) and zero-order
# holds (36), with the suffix of their rows in the kernels line.
MAIN_PAR = "cubic_spline"
NEW_PARS = ("linear_spline", "zero_order")
PAR_SUFFIX = {"cubic_spline": "", "linear_spline": "-lin", "zero_order": "-zo"}
TICK_LOOP = 30  # solve ticks of a path driven on the flagship inputs (phase 14)
GAIT_FREQS = (2.4, 1.3, 2.0)  # phase 10: the lowest offset (1.3 Hz, 0) is not the first group
GAIT_PHASE = np.array([0.3, 0.8, 0.8, 0.3], np.float32)


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def main_cfg(par=MAIN_PAR, **over):
    from quadruped_pympc_tamols_torch import make_config
    return make_config("aliengo", mpc_type="sampling",
                       **{"sim.visual_foothold_adaptation": "blind",
                          "mpc.sampling.parametrization": par, **over})


def softmax_cfg(method, par=MAIN_PAR, iterations=3):
    return main_cfg(par, **{"mpc.sampling.method": method,
                            "mpc.sampling.num_iterations": iterations})


def gait_cfg(method, par=MAIN_PAR, **over):
    return main_cfg(par, **{"mpc.optimize_step_freq": True, "mpc.sampling.method": method,
                            **over})


def example_tick(cfg, plan):
    """The flagship solve's inputs: a trot sequence with FR and RL lifting at step 6."""
    from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
    from quadruped_pympc_tamols_torch.ops.sampling_kernel import TickInputs
    import torch

    H = plan.horizon
    state12 = np.zeros(12, np.float32)
    state12[2], state12[3] = cfg.sim.ref_z - 0.03, 0.1
    ref12 = np.zeros(12, np.float32)
    ref12[2], ref12[3] = cfg.sim.ref_z, 0.2
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                    np.float32)
    seq = np.ones((4, H), np.float32)
    seq[1, 6:] = 0.0
    seq[2, 6:] = 0.0
    share = gravity_share(torch.from_numpy(seq), cfg.robot.mass)[:, None].expand(H, 4).numpy()
    return TickInputs(state12, feet, ref12, seq, np.ascontiguousarray(share))


def numpy_noise(plan, rng):
    """Three-band noise like the kernel's, drawn with numpy; column 0 zero."""
    from quadruped_pympc_tamols_torch.ops.sampling_kernel import band_edges
    P, N = plan.num_parameters, plan.num_samples
    s1, s2, s3 = plan.sigma_random
    b1, b2 = band_edges(N)
    z = np.zeros((P, N), np.float32)
    z[:, 1:b1] = s1 * rng.standard_normal((P, b1 - 1))
    z[:, b1:b2] = s2 * rng.standard_normal((P, b2 - b1))
    z[:, b2:] = rng.uniform(-s3, s3, (P, N - b2))
    return z


def plain_on_device(plan, tick, incumbent, noise):
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    t = sk.tick_tensors(tick, incumbent.device)
    return sk.sampling_iteration_reference(noise, incumbent, plan.W, *t, plan.dts, plan.q_diag,
                                           plan.srbd, plan.fm, plan.zmp_weight, plan.zmp_margin)


def check_against_plain(plan, tick, incumbent, noise, costs_k, out_k, label):
    """Phase-1 checks; returns the error figures."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops.cost_checks import COST_ATOL, COST_RTOL, DRIFT_H

    ref = plain_on_device(plan, tick, incumbent, noise)
    cost_err = check_costs(costs_k, ref.costs, label, plan.horizon,
                           plain_costs_f64(plan, tick, incumbent, noise)
                           if plan.horizon > DRIFT_H else None)
    k_idx, r_idx = int(out_k[25]), int(ref.best_index)
    if k_idx != r_idx:
        a, b = float(ref.costs[k_idx]), float(ref.costs[r_idx])
        if abs(a - b) > COST_ATOL + COST_RTOL * abs(b):
            raise AssertionError(f"{label}: argmin {k_idx} (cost {a}) vs plain {r_idx} ({b})")
    # The kernel's winner, extracted by the plain formulas.
    winner = incumbent + noise[:, k_idx]
    t = sk.tick_tensors(tick, winner.device)
    grfs, state = sk.step0_reference(winner, plan.W, t[0], t[1], t[3], t[4], plan.dts,
                                     plan.srbd, plan.fm)
    errs = {
        "cost": cost_err,
        "best_cost": abs(float(out_k[0]) - float(ref.costs[k_idx])),
        "grf": float((out_k[1:13] - grfs.reshape(12)).abs().max()),
        "state": float((out_k[13:25] - state).abs().max()),
        "winner": float((out_k[sk.OUT_WINNER:] - winner).abs().max()),
    }
    if errs["best_cost"] > COST_ATOL + COST_RTOL * abs(float(ref.costs[k_idx])):
        raise AssertionError(f"{label}: best cost {float(out_k[0])} vs {float(ref.costs[k_idx])}")
    for key, tol in (("grf", GRF_ATOL), ("state", STATE_ATOL), ("winner", PARAM_ATOL)):
        if not errs[key] <= tol:
            raise AssertionError(f"{label}: {key} error {errs[key]} > {tol}")
    return errs, ref


def plain_costs_f64(plan, tick, incumbent, noise):
    """The plain rollout's costs in float64 (the tick's float32 inputs promoted)."""
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops.cost_checks import f64
    t = sk.tick_tensors(tick, incumbent.device)
    return sk.rollout_costs_reference(incumbent.double()[:, None] + noise.double(),
                                      plan.W.double(), *t, plan.dts, plan.q_diag, f64(plan.srbd),
                                      plan.fm, plan.zmp_weight, plan.zmp_margin)


def check_costs(costs_k, costs_p, label, horizon=0, costs_64=None):
    """Kernel costs (..., N) against plain costs by ``cost_checks.check_sample_costs``
    (beyond DRIFT_H with the plain version's float64 costs, whose figures it logs);
    returns the largest absolute error over the samples it holds."""
    from quadruped_pympc_tamols_torch.ops.cost_checks import DRIFT_H, check_sample_costs
    try:
        r = check_sample_costs(costs_k, costs_p, costs_64 if horizon > DRIFT_H else None)
    except AssertionError as e:
        raise AssertionError(f"{label}: {e}") from None
    if horizon > DRIFT_H:
        log(f"{label} costs: {json.dumps(r)}")
    return r["max_abs_err"]


def gap(a, b) -> float:
    """Largest absolute difference, NaN against NaN counting as 0."""
    import torch
    d = (a - b).abs()
    return float(torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d), d).max())


def check_softmax(plan, knobs, tick, inc, noise, costs_k, out_k, sigma_k, elites_k, label):
    """K1b / K1c checks: costs against the plain rollout on the same noise; the
    optimizer step against the plain combine applied to the kernel's own costs;
    the fully plain result's distance printed beside. Returns the error figures."""
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
    from quadruped_pympc_tamols_torch.ops.cost_checks import DRIFT_H

    t = sk.tick_tensors(tick, inc.device)
    plain = sm.softmax_iteration_reference(noise, inc, plan.W, *t, plan.dts, plan.q_diag,
                                           plan.srbd, plan.fm, knobs, plan.zmp_weight,
                                           plan.zmp_margin)
    errs = {"cost": check_costs(costs_k, plain.costs, label, plan.horizon,
                                plain_costs_f64(plan, tick, inc, noise)
                                if plan.horizon > DRIFT_H else None)}
    ref = sm.softmax_combine_reference(costs_k, noise, inc, plan.W, t[0], t[1], t[3], t[4],
                                       plan.dts, plan.srbd, plan.fm, knobs)
    if float(out_k[0]) != float(ref.beta) or int(out_k[25]) != int(ref.best_index):
        raise AssertionError(f"{label}: beta {float(out_k[0])} at {int(out_k[25])} vs "
                             f"{float(ref.beta)} at {int(ref.best_index)}")
    new_k = out_k[sk.OUT_WINNER:]
    errs["params"] = gap(new_k, ref.new_params)
    errs["grf"] = gap(out_k[1:13], ref.grfs.reshape(12))
    errs["state"] = gap(out_k[13:25], ref.next_state)
    errs["params_vs_fully_plain"] = gap(new_k, plain.new_params)
    tols = [("params", COMBINE_ATOL), ("grf", GRF_ATOL), ("state", STATE_ATOL)]
    if knobs.cem:
        if not elites_match(knobs, elites_k, ref.elites):
            raise AssertionError(f"{label}: elites {elites_k.tolist()} vs {ref.elites.tolist()}")
        errs["sigma"] = gap(sigma_k, ref.sigma)
        errs["sigma_vs_fully_plain"] = gap(sigma_k, plain.sigma)
        tols.append(("sigma", sigma_atol(knobs, ref.sigma)))
    for key, tol in tols:
        if not errs[key] <= tol:
            raise AssertionError(f"{label}: {key} error {errs[key]} > {tol}")
    return errs


def elites_match(knobs, got, want) -> bool:
    """The kernel's elites against the plain version's, which lists them in (cost,
    index) order: the same list up to the key lists' LIST_ELITE, the same set
    above it, which the kernels list in index order."""
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
    K = knobs.n_elite
    got, want = got.long().reshape(-1, K).tolist(), want.long().reshape(-1, K).tolist()
    return got == (want if K <= sm.LIST_ELITE else [sorted(w) for w in want])


def sigma_atol(knobs, sigma) -> float:
    """The refit sigma's tolerance: COMBINE_ATOL up to the key lists' 32 elites;
    above them the refit sums up to 1000 squares in another order than
    torch.var, so 1e-4 of sigma on top."""
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
    if knobs.n_elite <= sm.LIST_ELITE:
        return COMBINE_ATOL
    return COMBINE_ATOL + 1e-4 * float(sigma.abs().max())


def time_cuda(fn, runs=TIMED_RUNS, warmup=10) -> float:
    """Median milliseconds of ``fn`` over ``runs`` launches, CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def time_layer(obj, name, acc, key):
    """Wrap obj.name so its host wall time accumulates into acc[key]."""
    fn = getattr(obj, name)

    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            acc[key] += time.perf_counter() - t0

    setattr(obj, name, wrapped)


def tick_dicts(tick):
    """The flagship tick as the controller's state and reference dicts."""
    st, ref = {}, {}
    legs = ("FL", "FR", "RL", "RR")
    st.update(position=tick.state12[:3], linear_velocity=tick.state12[3:6],
              orientation=tick.state12[6:9], angular_velocity=tick.state12[9:12],
              **{f"foot_{n}": tick.feet[i] for i, n in enumerate(legs)})
    ref.update(ref_position=tick.ref12[:3], ref_linear_velocity=tick.ref12[3:6],
               ref_orientation=tick.ref12[6:9], ref_angular_velocity=tick.ref12[9:12],
               **{f"ref_foot_{n}": tick.feet[i] for i, n in enumerate(legs)})
    return st, ref


def tick_call(mpc, tick):
    """One control tick on the flagship inputs as a function: compute_control and
    the read of its one host summary (and, gait-adaptive, of its frequency)."""
    from quadruped_pympc_tamols_torch.controllers.sampling import (GaitAdaptiveSamplingMPC,
                                                                   host_best_freq, host_summary)
    st, ref = tick_dicts(tick)
    ones = np.ones(4, np.float32)
    if isinstance(mpc, GaitAdaptiveSamplingMPC):
        def call():
            out = mpc.compute_control(st, ref, tick.contact_seq, ones, ones, GAIT_PHASE, 1.4, 1)
            host_summary(out)
            host_best_freq(out)
        return call
    return lambda: host_summary(mpc.compute_control(st, ref, tick.contact_seq, ones, ones))


def solve_tick_ms(mpc, tick, n=200) -> float:
    """Median host milliseconds of one compute_control plus its summary read."""
    return median_host_ms(tick_call(mpc, tick), n)


def median_host_ms(call, n) -> float:
    """Median host milliseconds of ``call`` over n calls after 10 warm-up calls."""
    ms = []
    for i in range(n + 10):
        t0 = time.perf_counter()
        call()
        if i >= 10:
            ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


# torch.profiler loses records on the H100: windows of 50 launches recorded 23
# and 0 of them, one of 50 ticks 47 of 50 device-to-host copies. So every window
# is the active step of a profiler schedule after a warm-up step of the same
# work, with PROFILE_PAD_S of idle time before and after the work inside it
# (``profile_window``; tools/profiler_windows.py counts the losses with and
# without the pads), and a window that still recorded fewer than a check needs,
# or nothing, is profiled again, up to PROFILE_WINDOWS windows in all. The
# active step also receives, now and then, the last device records of the
# warm-up step (a window of 20 nominal ticks held 21 copies and ~760 kernels
# more than 20 ticks launch; such a copy started 50.0-51.0 ms before the
# profiled call, a pad of 50 ms earlier, tools/profiler_records.py): ``window_rows``
# keeps only the records of the profiled call, so a lost record never adds one
# and a count above what the check allows fails at once.
PROFILE_WINDOWS = 5
PROFILE_PAD_S = 0.2  # see window_rows
PROFILED_CALL = "chip_smoke profiled call"


def profile_window(run):
    """torch.profiler over one call of ``run`` (which ends in a synchronize), after
    a warm-up step of the same call, with PROFILE_PAD_S idle before and after it;
    returns (the profiler, wall seconds of the profiled call). The call is the
    range PROFILED_CALL of the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        run()
        prof.step()
        time.sleep(PROFILE_PAD_S)
        t0 = time.perf_counter()
        with record_function(PROFILED_CALL):
            run()
        wall = time.perf_counter() - t0
        time.sleep(PROFILE_PAD_S)
        prof.step()
    return prof, wall


def window_rows(prof):
    """(device, host, outside) of a ``profile_window``: device maps a record's
    name (a kernel, Memcpy or Memset) to (records, device us) over the device
    records of the profiled call; host maps a host row's name (operators, runtime
    calls) to its records; outside counts the device records left out. A device
    record belongs to the call if it starts within half a pad (PROFILE_PAD_S / 2)
    of the call's host range: the warm-up step's records, which the active step
    receives now and then, start a whole pad or more before it, and the call's
    own device records have started up to ~6 ms past the end of its host range
    (once up to ~40 ms on both sides: records left out then count as lost). With a
    pad of 50 ms a warm-up step's copy once started inside that margin and counted
    as the call's, hence the pad of 200 ms."""
    from torch.autograd import DeviceType

    events = prof.events()
    span = next(e.time_range for e in events if e.name == PROFILED_CALL)
    margin_us = PROFILE_PAD_S / 2 * 1e6
    device, host, outside = {}, {}, 0
    for e in events:
        if e.name == PROFILED_CALL or e.name.startswith("ProfilerStep"):
            continue
        if e.device_type == DeviceType.CPU:
            host[e.name] = host.get(e.name, 0) + 1
        elif span.start - margin_us <= e.time_range.start <= span.end + margin_us:
            n, us = device.get(e.name, (0, 0.0))
            device[e.name] = (n + 1, us + e.time_range.elapsed_us())
        else:
            outside += 1
    return device, host, outside


def host_d2h_copies(call, n) -> int:
    """Device-to-host copies that n calls of ``call`` issue through torch's
    dispatcher, counted on the host: every op that reads a CUDA tensor and yields
    a CPU tensor or a Python scalar. Unlike the profiler's device records, none
    is lost."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        copies = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            if any(t.is_cuda for t in ins) and any(
                    isinstance(t, (bool, int, float)) or isinstance(t, torch.Tensor)
                    and t.device.type == "cpu" for t in tree_leaves(out)):
                Count.copies += 1
            return out

    with Count():
        for _ in range(n):
            call()
    torch.cuda.synchronize()
    return Count.copies


def profile_ticks(mpc, tick, n=50, expect=None, d2h=None, absent=(), call=None) -> dict:
    """Device time per launch of each kernel (its device time over the launches
    the profiler recorded, as ``pass_profile`` takes it), the recorded launches,
    the device's busy share and the device-to-host copies over n solve ticks,
    from the torch.profiler records inside the ticks (``window_rows``); "not
    measured" where the profiler sees no device time.
    A count short of the ticks' launches means lost records: the busy share
    counts only what was recorded. ``expect`` maps a substring of device rows'
    names to launches a tick: the rows' recorded launches must lie in (half, all]
    of them (see ``once_an_iteration``), and a short window is profiled again
    (PROFILE_WINDOWS). ``d2h``, where given, is the device-to-host copies a tick:
    n more ticks must issue exactly that many through torch (``host_d2h_copies``),
    and the profiler must record no more of them ("DtoH") than that. No device row
    may hold a substring of ``absent`` (a lost record never adds one). Nothing is
    caught: a failed tick or a profiler that cannot start fails the run. ``call``
    replaces the sampling tick on the flagship inputs."""
    import torch

    call = call or tick_call(mpc, tick)
    if d2h is not None:
        copies = host_d2h_copies(call, n)
        if copies != d2h * n:
            raise AssertionError(f"{n} ticks issued {copies} device-to-host copies, "
                                 f"want {d2h * n}")
        expect = {**(expect or {}), "DtoH": d2h}

    def ticks():
        for _ in range(n):
            call()
        torch.cuda.synchronize()

    for window in range(PROFILE_WINDOWS):
        prof, wall_s = profile_window(ticks)
        wall_us = wall_s * 1e6
        kernels, _, outside = window_rows(prof)
        found = sorted(k for k in kernels if any(tag in k for tag in absent))
        if found:
            raise AssertionError(f"{n} ticks recorded {found}, which they must not launch")
        short = {}
        for tag, per_tick in (expect or {}).items():
            count, want = sum(v[0] for k, v in kernels.items() if tag in k), per_tick * n
            if count > want:
                raise AssertionError(f"{tag}: {count} recorded in {n} ticks, want {want}")
            if count <= want / 2:
                short[tag] = count
        if not short:
            break
        if window == PROFILE_WINDOWS - 1:
            raise AssertionError(f"{PROFILE_WINDOWS} profiler windows of {n} ticks recorded "
                                 f"only {short} of {expect} a tick")
        log(f"  profiler window {window + 1} recorded {short} in {n} ticks; profiling again")
    busy_us = sum(v[1] for v in kernels.values())
    if busy_us == 0:
        return {"not measured": "no device time in the trace"}
    return {"ticks": n, "window_ms_per_tick": wall_us / n / 1e3,
            "device_busy_share_recorded": busy_us / wall_us,
            "d2h_copies": sum(v[0] for k, v in kernels.items() if "DtoH" in k),
            "host_d2h_copies": None if d2h is None else d2h * n,
            "device_records_outside_the_window": outside,
            "device_us_per_launch": {k: v[1] / v[0] for k, v in sorted(kernels.items())},
            "launches": {k: v[0] for k, v in sorted(kernels.items())}}


# The kernels of the rows, by pass: the profiler's row names hold these, and so
# do the names of their entry functions in the ptxas log (the chain kernel's
# MPPI/CEM instantiation, <..., false>, is mangled with "Lb0E"; random sampling's
# with "Lb1E").
PASSES = {"rollout": "rollout_kernel", "update": "sm_update_kernel",
          "extract": "rs_extract_kernel", "chain": "chain_kernel",
          "fleet_rollout": "fleet_rollout_kernel", "fleet_update": "fleet_update_kernel",
          "fleet_extract": "fleet_extract_kernel", "fleet_rollout_wide": "fleet_rollout_wide_kernel"}
PTXAS_ENTRY = {**{k: (v,) for k, v in PASSES.items()}, "chain": ("chain_kernel", "Lb0E")}


def once_an_iteration(tag, count, iterations):
    """Raise unless the profiler's count of ``tag`` says one launch an iteration.
    torch.profiler loses kernel records (on the H100 it has recorded 41 of 50 and
    149 of 150), so a count down to half passes; two launches an iteration would
    double it and none would leave it at 0, and a lost record never adds one."""
    if not iterations / 2 < count <= iterations:
        raise AssertionError(f"{tag}: {count} launches recorded in {iterations} iterations, "
                             "want one an iteration")


def pass_profile(fn, iterations, passes, n=50) -> dict:
    """{pass: (kernel name, mean device us a launch)} for each of ``passes`` (keys
    of PASSES) over n calls of fn (fn is warm, ``iterations`` launches of each
    pass a call), from torch.profiler. A window in which a pass recorded half of
    its launches or fewer, or none, is profiled again (PROFILE_WINDOWS). Raises if
    a kernel ran more than ``iterations`` times a call, or if no window recorded
    more than half of each pass's launches (see ``once_an_iteration``)."""
    import torch

    def calls():
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    want = {k: PASSES[k] for k in passes}
    for window in range(PROFILE_WINDOWS):
        prof, _ = profile_window(calls)
        found, counts = {}, {}
        for key, (count, dev_us) in window_rows(prof)[0].items():
            for short, tag in want.items():
                if tag in key:
                    if count > n * iterations:
                        once_an_iteration(tag, count, n * iterations)
                    found[short] = (key.split("(")[0], dev_us / count)
                    counts[tag] = count
        if found.keys() == want.keys() and all(c > n * iterations / 2 for c in counts.values()):
            break
        if window == PROFILE_WINDOWS - 1:
            if found.keys() != want.keys():
                raise AssertionError(f"{PROFILE_WINDOWS} profiler windows saw only "
                                     f"{sorted(found)} of {sorted(want)}")
            break
        log(f"  profiler window {window + 1} recorded {counts} of {n * iterations} launches "
            f"each of {sorted(want.values())}; profiling again")
    for tag, count in counts.items():
        once_an_iteration(tag, count, n * iterations)
    return found


def ptxas_of(log_path, *parts) -> dict:
    """Registers, shared memory, stack and spills of the kernel whose entry
    function's name holds every one of ``parts``, from the library's ``-Xptxas -v``
    log."""
    import re
    entry, found = False, {}
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = all(part in line for part in parts)
        elif entry and "spill" in line:
            stack, stores, loads = map(int, re.findall(r"(\d+) bytes", line))
            found.update(stack_bytes=stack, spill_store_bytes=stores, spill_load_bytes=loads)
        elif entry and "registers" in line:
            found["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            m = re.search(r"(\d+) bytes smem", line)
            found["smem_bytes"] = int(m.group(1)) if m else 0
    if "registers" not in found:
        raise AssertionError(f"no {parts} in {log_path.name}")
    return found


def constant_loads(lib_path, kernel) -> list:
    """The loads through the read-only, non-coherent path (LDG...CONSTANT) in the
    machine code of the functions whose names hold ``kernel`` (cuobjdump), but for
    reads of the library's own constant tables, whose address is an offset from a
    base in constant bank 4 (sincosf's argument-reduction table): their lines."""
    import os
    import re
    from quadruped_pympc_tamols_torch.ops import build
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    insn = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?PT?\d*\s+)?([A-Z0-9_.]+)\s+([^;]*);")
    functions, bad, code = 0, [], None

    def writer(before, reg):  # the last instruction before this one that writes reg
        for op, args in reversed(before):
            if args.split(",")[0].strip() == reg:
                return op, args
        return None, ""

    for line in sass.splitlines() + ["Function : (end)"]:
        if "Function :" in line:
            code = [] if kernel in line else None
            functions += code is not None
            continue
        m = insn.search(line)
        if code is None or not m:
            continue
        op, args = m.groups()
        if op.startswith("LDG") and "CONSTANT" in op:
            addr = re.search(r"\[(R\d+)(?:\.64)?[^\]]*\]\s*$", args.strip())
            _, sum_args = writer(code, addr.group(1)) if addr else (None, "")
            base = re.search(r"\b(UR\d+)\b", sum_args)
            _, base_args = writer(code, base.group(1)) if base else (None, "")
            if "c[0x4]" not in base_args:
                bad.append(line.strip())
        code.append((op, args))
    if functions == 0:
        raise AssertionError(f"no {kernel} in the machine code of {lib_path.name}")
    return bad


def iteration_flops(plan, nnz) -> int:
    """Operations one K1a iteration needs per sample: one FMA per nonzero of the
    basis it evaluates (``nnz``; make_rs_plan checks that W is zero outside the
    own-leg blocks, and basis_windows that each row's nonzeros lie in its window:
    one for a zero-order hold, two for a linear spline), ~250 flops per rollout step (force model,
    torques, rotations, gyroscopic term, Euler update, cost), ~30 flops per
    Box-Muller normal."""
    return 2 * nnz + 250 * plan.horizon + 30 * plan.num_parameters


def basis_nnz(blocks) -> int:
    """Nonzeros of basis blocks or of the weights of basis windows (a tensor or an
    array)."""
    import torch
    return int(torch.count_nonzero(torch.as_tensor(blocks)))


def window_floats(plan) -> int:
    """Floats of the plan's basis windows, the kernels' basis input."""
    return int(plan.windows.numel())


def bound_ms(flops, nbytes) -> tuple:
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def k1a_bound_ms(plan, iterations=1) -> tuple:
    """Least time of ``iterations`` K1a solves on an H100: (ms, "bytes" or
    "operations"). Bytes: the basis windows and the incumbent read once, N costs
    and the packed output written once, per iteration."""
    P, N = plan.num_parameters, plan.num_samples
    return bound_ms(iterations * N * iteration_flops(plan, basis_nnz(plan.windows[:, :4])),
                    iterations * 4 * (window_floats(plan) + P + N + 26 + P))  # out: [cost, 12, 12, index, P]


def softmax_bound_ms(plan, knobs, iterations=1) -> tuple:
    """Least time of ``iterations`` K1b / K1c iterations on an H100. Per sample
    per iteration, K1a's count plus ~2P + 20 flops for the weight, its
    exponential and the weighted sum (writing the noise and reading it back is
    the design's choice and not counted; the K-elite selection and refit are
    O(N + K P)).
    Bytes: the basis windows, the incumbent (and sigma) read, N costs, the packed
    output (and sigma', elites) written, once per iteration."""
    P, N = plan.num_parameters, plan.num_samples
    flops = N * (iteration_flops(plan, basis_nnz(plan.windows[:, :4])) + 2 * P + 20)
    nbytes = 4 * (window_floats(plan) + P + N + 26 + P)
    if knobs.cem:
        nbytes += 4 * (2 * P + knobs.n_elite)
    return bound_ms(iterations * flops, iterations * nbytes)


def group_bound_ms(gplan, knobs, groups) -> tuple:
    """Least time of one K1e solve on an H100: per evaluated sample (K*Ng) K1a's
    count with its group's basis block, plus the softmax's ~2P + 20 flops for MPPI
    / CEM. Bytes: the per-tick
    group buffer (K groups' basis windows, contact and share columns, offsets), the
    static step-0 windows, the incumbent (and sigma) read; K*Ng costs and the
    packed output (and sigma', elites) written."""
    p = gplan.base
    H, P, n, K = p.horizon, p.num_parameters, gplan.num_used, gplan.num_groups
    softmax = knobs.method != "random_sampling"
    flops = sum(gplan.group_size * iteration_flops(p, basis_nnz(b)) for b in groups.blocks)
    flops += n * (2 * P + 20 if softmax else 0)
    nbytes = 4 * (K * (window_floats(p) + 8 * H + 1) + 12 * 8 + P + n + 26 + P)
    if knobs.cem:
        nbytes += 4 * (2 * P + knobs.n_elite)
    return bound_ms(flops, nbytes)


# Launch counts by kernel: K1a counts in sampling_rs.launches, K1b and K1c in
# softmax_iteration.launches["mppi"] and ["cem_mppi"], K1d (the chain kernel, one
# launch a chained solve) in sampling_chain.launches[method], K1e in
# sampling_groups.launches[method], K1f in sampling_fleet.fleet_iteration.launches[method]
# (the four-lane layout) and .launches_wide[method] (the large-batch layout) (counted
# by the wrapper through utils/graphs.py:count_launch: a launch captured into the
# fleet's graph is recorded at the capture and counted at each replay).
COUNTED = ("K1a", "K1b", "K1c", "K1d_rs", "K1d_mppi", "K1d_cem", "K1e_rs", "K1e_mppi",
           "K1e_cem", "K1f_rs", "K1f_mppi", "K1f_cem", "K1f_rs_wide", "K1f_mppi_wide",
           "K1f_cem_wide")


def reset_counts():
    from quadruped_pympc_tamols_torch import ops
    ops.sampling_rs.launches = 0
    ops.softmax_iteration.launches.update(mppi=0, cem_mppi=0)
    ops.sampling_chain.launches.update(random_sampling=0, mppi=0, cem_mppi=0)
    ops.sampling_groups.sampling_groups.launches.update(random_sampling=0, mppi=0, cem_mppi=0)
    ops.fleet_iteration.launches.update(random_sampling=0, mppi=0, cem_mppi=0)
    ops.fleet_iteration.launches_wide.update(random_sampling=0, mppi=0, cem_mppi=0)


def read_counts() -> dict:
    from quadruped_pympc_tamols_torch import ops
    sm = ops.softmax_iteration.launches
    ch = ops.sampling_chain.launches
    sg = ops.sampling_groups.sampling_groups.launches
    fl = ops.fleet_iteration.launches
    fw = ops.fleet_iteration.launches_wide
    return {"K1a": ops.sampling_rs.launches, "K1b": sm["mppi"], "K1c": sm["cem_mppi"],
            "K1d_rs": ch["random_sampling"], "K1d_mppi": ch["mppi"], "K1d_cem": ch["cem_mppi"],
            "K1e_rs": sg["random_sampling"], "K1e_mppi": sg["mppi"], "K1e_cem": sg["cem_mppi"],
            "K1f_rs": fl["random_sampling"], "K1f_mppi": fl["mppi"], "K1f_cem": fl["cem_mppi"],
            "K1f_rs_wide": fw["random_sampling"], "K1f_mppi_wide": fw["mppi"],
            "K1f_cem_wide": fw["cem_mppi"]}


def walk(cfg, label, want_counts, min_dist=None):
    """The README quickstart walk on the card with the launch counts zeroed just
    before and read just after; raises unless it walks the band of
    tests/test_closed_loop_walking.py:18-29 (``min_dist`` in place of its
    distance, if given) with ``want_counts(ticks)`` launches."""
    import torch
    from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness

    h = SRBClosedLoopHarness(cfg, seed=0, device="cuda")
    layer_s = {"planners": 0.0, "solve (controller + kernels + copy)": 0.0, "plant": 0.0}
    time_layer(h.wb, "update_state_and_reference", layer_s, "planners")
    time_layer(h.ctrl, "compute_control", layer_s, "solve (controller + kernels + copy)")
    time_layer(h, "_plant_step", layer_s, "plant")
    reset_counts()
    t0 = time.perf_counter()
    hist = h.run(WALK_S, WALK_VEL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    ticks = int(round(WALK_S / cfg.sim.dt)) // h._mpc_every
    dist, min_z, tilt, _ = walk_band(label, cfg, hist, min_dist)
    check_counts(label, counts, want_counts, ticks)
    log(f"{label}: ok; walked {dist:.4f} m in {WALK_S} s, min z {min_z:.4f}, "
        f"max |roll|,|pitch| {tilt:.4f}; launches {counts} for "
        f"{ticks} ticks; wall {wall:.3f} s ({wall / WALK_S:.3f} s per simulated s); host "
        f"time by layer {({k: round(v, 4) for k, v in layer_s.items()})} s, rest "
        f"{wall - sum(layer_s.values()):.4f} s (swing feet, loop)")
    return counts, wall, (dist, min_z, tilt)


def walk_band(label, cfg, hist, min_dist=None) -> tuple:
    """Raise unless the history stays in the band of
    tests/test_closed_loop_walking.py:18-29 (walking ``min_dist``, if given, in
    place of half the commanded distance); returns (distance, min z, max
    |roll|,|pitch|, mean z of the second half - ref_z)."""
    z = hist[:, 2]
    dist = hist[-1, 0] - hist[0, 0]
    if not np.all(np.isfinite(hist)):
        raise AssertionError(f"{label}: state diverged")
    if not (np.all(z > 0.15) and np.all(np.abs(hist[:, 6:8]) < 0.5)):
        raise AssertionError(f"{label}: fell (min z {z.min()}, max |rp| "
                             f"{np.abs(hist[:, 6:8]).max()})")
    if not dist > (0.5 * WALK_VEL[0] * WALK_S if min_dist is None else min_dist):
        raise AssertionError(f"{label}: walked {dist} m of {WALK_VEL[0] * WALK_S}")
    dz = np.mean(z[len(z) // 2:]) - cfg.sim.ref_z
    if not abs(dz) < 0.08:
        raise AssertionError(f"{label}: mean height off the reference")
    return float(dist), float(z.min()), float(np.abs(hist[:, 6:8]).max()), float(dz)


def check_counts(label, counts, want_counts, ticks):
    if counts != want_counts(ticks) or ticks == 0:
        raise AssertionError(f"{label}: launches {counts} for {ticks} MPC ticks, want "
                             f"{want_counts(ticks)}")


def counts_of(**nonzero):
    """want_counts for ``walk``: the named kernels launched so many times per
    tick, every other counted kernel not at all."""
    return lambda ticks: {name: nonzero.get(name, 0) * ticks for name in COUNTED}


def phase_softmax(dev, rng, par=MAIN_PAR, phase="phase 5"):
    """Phase 5 (13 for the other parametrizations): K1b and K1c against the plain
    version at N = 10 000."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    errs = {}
    for method in ("mppi", "cem_mppi"):
        label = f"{phase} {method}" + (f" {par}" if par != MAIN_PAR else "")
        cfg = softmax_cfg(method, par)
        plan = sk.make_rs_plan(cfg, N_MAIN, dev)
        knobs = sm.make_knobs(cfg)
        tick = example_tick(cfg, plan)
        P = plan.num_parameters
        inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
        sigma = torch.as_tensor(rng.uniform(0.3, 4.0, P).astype(np.float32), device=dev)
        scale = sigma.cpu().numpy()[:, None] if knobs.cem else knobs.sigma_mppi
        noise = (rng.standard_normal((P, N_MAIN)) * scale).astype(np.float32)
        noise[:, 0] = 0.0
        noise = torch.as_tensor(noise, device=dev)

        def run(tk, seed=0, noise_in=None, noise_out=None):
            return sm.softmax_iteration(plan, knobs, tk, inc, sigma, seed, 0, noise_in=noise_in,
                                        noise_out=noise_out)

        res = run(tick, noise_in=noise)
        torch.cuda.synchronize()
        e = check_softmax(plan, knobs, tick, inc, noise, *res, label)
        nan_tick = tick._replace(state12=np.full(12, np.nan, np.float32))
        res_nan = run(nan_tick, noise_in=noise)
        torch.cuda.synchronize()
        check_softmax(plan, knobs, nan_tick, inc, noise, *res_nan, f"{label} ties")
        if not bool((res_nan[0] == 1.0e6).all()):
            raise AssertionError(f"{label}: a NaN state left unsaturated costs")
        if knobs.cem and res_nan[3].tolist() != list(range(knobs.n_elite)):
            raise AssertionError(f"{label}: tied elites {res_nan[3].tolist()}")
        dump = torch.empty(P, N_MAIN, device=dev)
        res_px = run(tick, seed=1234, noise_out=dump)
        res_px2 = run(tick, seed=1234)
        torch.cuda.synchronize()
        for a, b in zip(res_px, res_px2):
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{label}: a rerun gave other bits")
        if not bool((dump[:, 0] == 0).all()):
            raise AssertionError(f"{label}: column 0 (the incumbent) is not zero")
        std = (dump[:, 1:].double().std(dim=1) / (sigma.double() if knobs.cem
                                                  else knobs.sigma_mppi))
        if not bool(((std - 1.0).abs() < 6.0 / np.sqrt(2.0 * N_MAIN)).all()):  # 6 sd
            raise AssertionError(f"{label}: Philox noise std / sigma {std}")
        e_px = check_softmax(plan, knobs, tick, inc, dump, *res_px, f"{label} philox")
        errs[method] = e
        log(f"{label} (N={N_MAIN}, P={P}): ok; injected noise {e}; Philox noise {e_px}; "
            f"NaN state: all costs 1e6, elites "
            f"{res_nan[3].tolist() if knobs.cem else 'n/a'}")
    return errs


def phase_chain(dev, rng, par=MAIN_PAR, phase="phase 6"):
    """Phase 6 (13 for the other parametrizations): K1d, three chained iterations
    of each method in one launch of the chain kernel, against single iterations;
    and the chain kernel's machine code."""
    import torch
    from quadruped_pympc_tamols_torch.ops import build
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    p = sk.make_rs_plan(main_cfg(par), 1, "cpu")
    lib = build.build_all()[("sampling_chain", p.horizon, p.params_per_leg)]
    nc = constant_loads(lib, PASSES["chain"])
    if nc:
        raise AssertionError(f"{phase} {par}: the chain kernel reads through the read-only path "
                             f"(what it writes itself must be read from L2): {nc}")
    log(f"{phase} {par}: the chain kernel's SASS (cuobjdump) holds no LDG.CONSTANT load but "
        "for sincosf's reduction table")
    worst = 0.0
    for method in ("random_sampling", "mppi", "cem_mppi"):
        cfg = softmax_cfg(method, par)
        plan = sk.make_rs_plan(cfg, N_MAIN, dev)
        knobs = sm.make_knobs(cfg)
        tick = example_tick(cfg, plan)
        P = plan.num_parameters
        inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
        sig = torch.full((P,), cfg.mpc.sampling.sigma_cem_mppi, device=dev)
        head = f"{phase} {method}" + (f" {par}" if par != MAIN_PAR else "")
        reset_counts()
        res = sm.sampling_chain(plan, knobs, tick, inc, sig, 77, 40, 3)
        counts = read_counts()
        want = counts_of(**{"K1d_" + {"random_sampling": "rs", "mppi": "mppi",
                                      "cem_mppi": "cem"}[method]: 1})(1)
        if counts != want:
            raise AssertionError(f"{head}: launches {counts}, want {want}")
        errs = []
        for i, r in enumerate(res):
            dump = torch.empty(P, N_MAIN, device=dev)
            label = f"{head} iteration {i}"
            if method == "random_sampling":
                one = sk.sampling_rs(plan, tick, inc, 77, 40 + i, noise_out=dump) + (sig, None)
            else:
                one = sm.softmax_iteration(plan, knobs, tick, inc, sig, 77, 40 + i,
                                           noise_out=dump)
            torch.cuda.synchronize()
            for a, b in zip(one, r):
                if a is not None and not torch.equal(a, b):
                    raise AssertionError(f"{label}: the chain differs from one iteration")
            if method == "random_sampling":
                e, _ = check_against_plain(plan, tick, inc, dump, r.costs, r.out, label)
            else:
                e = check_softmax(plan, knobs, tick, inc, dump, *r, label)
            errs.append(e)
            worst = max(worst, e["cost"])
            inc, sig = r.out[sk.OUT_WINNER:], r.sigma
        log(f"{head} x 3: ok, one launch, bit-equal to single iterations; per iteration {errs}")
    return worst


def cem_loop(cfg, label, want_counts, jax_walk=None):
    """A CEM-MPPI closed loop for 3 s on the card: finite GRFs and a sigma inside
    [cem_sigma_min, cem_sigma_max] on every tick, ``want_counts(ticks)`` launches.
    The JAX reference falls in such loops, so the walk is not asserted."""
    import torch
    from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness

    sp = cfg.mpc.sampling
    h = SRBClosedLoopHarness(cfg, seed=0, device="cuda")
    seen = []
    solve = h.ctrl.controller.compute_control

    def recorded(*a, **kw):
        out = solve(*a, **kw)
        seen.append((out.grfs, out.sigma))  # device tensors, each tick's own
        return out

    h.ctrl.controller.compute_control = recorded
    reset_counts()
    hist = h.run(WALK_S, WALK_VEL)
    torch.cuda.synchronize()
    counts = read_counts()
    ticks = int(round(WALK_S / cfg.sim.dt)) // h._mpc_every
    want = want_counts(ticks)
    if counts != want or len(seen) != ticks:
        raise AssertionError(f"{label}: launches {counts} for {ticks} ticks, want {want}")
    grfs = torch.stack([g for g, _ in seen])
    sig = torch.stack([s for _, s in seen])
    if not bool(torch.isfinite(grfs).all()):
        raise AssertionError(f"{label}: non-finite GRFs")
    if not bool(((sig >= sp.cem_sigma_min) & (sig <= sp.cem_sigma_max)).all()):
        raise AssertionError(f"{label}: sigma left [{sp.cem_sigma_min}, {sp.cem_sigma_max}]: "
                             f"{float(sig.min())}, {float(sig.max())}")
    fin = np.isfinite(hist).all(axis=1)
    dist = hist[fin][-1, 0] - hist[0, 0]
    stats = (float(dist), float(hist[fin, 2].min()), float(np.abs(hist[fin, 6:8]).max()))
    log(f"{label}: ok; {ticks} ticks with finite GRFs and sigma in [{float(sig.min()):.4f}, "
        f"{float(sig.max()):.4f}]; launches {counts}; distance, min z, max |roll|,|pitch| "
        f"{stats} over {int(fin.sum())} finite steps of {len(hist)}"
        + (f" (JAX package on the CPU: {jax_walk})" if jax_walk else ""))
    return counts, stats


def phase_softmax_times(dev, rng, par=MAIN_PAR, phase="phase 9"):
    """Phase 9 (15 for the other parametrizations): times of K1b and K1c and their
    plain versions, and of K1d for each method: the chain kernel through its
    wrapper, through its C entry with prebuilt arguments and on the card, beside
    the successive single launches that chained before; the blocks an SM of the
    update pass and of the chain kernel."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.sampling import SamplingMPC
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for method in ("mppi", "cem_mppi", "random_sampling"):
        cfg = softmax_cfg(method, par)
        plan = sk.make_rs_plan(cfg, N_MAIN, dev)
        knobs = sm.make_knobs(cfg)
        tick = example_tick(cfg, plan)
        P = plan.num_parameters
        inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
        sig = torch.full((P,), cfg.mpc.sampling.sigma_cem_mppi, device=dev)
        kn = knobs.struct()
        # Through the C entries with the argument blocks built once, so the events
        # see the launches (and memsets), not Python's packing: one iteration, the
        # chain kernel (chain_prebuilt), and the three single iterations that
        # chained before it (successive_prebuilt); K1d also through its wrapper,
        # sampling_chain, as the solver calls it, and the single iterations through
        # theirs (successive: what sampling_chain did before the chain kernel).
        args = [sk.kernel_args(plan, tick, 5, i) for i in range(3)]
        ws = [sm.workspace(plan, knobs, dev) for _ in range(3)]
        clib = sm.load_chain_library(plan.horizon, plan.params_per_leg)
        cws = sm.workspace(plan, knobs, dev, 3)

        def chain_prebuilt():
            sm.chain_launch(clib, args[0], kn, method, plan, 3, cws, inc, sig, stream=stream)

        def successive():
            x, s = inc, sig
            for i in range(3):
                if method == "random_sampling":
                    _, o = sk.sampling_rs(plan, tick, x, 5, i)
                else:
                    _, o, s, _ = sm.softmax_iteration(plan, knobs, tick, x, s, 5, i)
                x = o[sk.OUT_WINNER:]

        r = out[method] = {
            "chain_ms": time_cuda(lambda: sm.sampling_chain(plan, knobs, tick, inc, sig, 5, 0, 3)),
            "chain_prebuilt_ms": time_cuda(chain_prebuilt),
            "chain_passes": pass_profile(chain_prebuilt, 1, ("chain",)),
            "successive_ms": time_cuda(successive),
            "chain_blocks_per_sm": sm.chain_blocks_per_sm(plan, knobs),
            "chain_bound": (k1a_bound_ms(plan, 3) if method == "random_sampling"
                            else softmax_bound_ms(plan, knobs, 3))}
        chain_line = (
            f"K1d {method} x 3 through sampling_chain {r['chain_ms']:.4f} ms, through its C "
            f"entry with prebuilt arguments {r['chain_prebuilt_ms']:.4f} ms, chain kernel "
            f"{r['chain_passes']['chain'][1]:.2f} us on the card (torch.profiler), "
            f"{r['chain_blocks_per_sm']} blocks an SM x {sms} SMs; the successive single "
            f"launches through their wrappers {r['successive_ms']:.4f} ms")
        if method == "random_sampling":
            log(f"{phase} {par} (P={P}): {chain_line}; bound {r['chain_bound'][0]:.5f} ms "
                f"({r['chain_bound'][1]})")
            continue
        lib = sm.load_library(plan.horizon, plan.params_per_leg)

        def one():
            sm.launch(lib, args[0], kn, plan, ws[0], inc, sig, stream=stream)

        def successive_prebuilt():
            x, s = inc, sig
            for i in range(3):
                sm.launch(lib, args[i], kn, plan, ws[i], x, s, stream=stream)
                x, s = ws[i].out[sk.OUT_WINNER:], ws[i].sigma

        t = sk.tick_tensors(tick, dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def plain(iterations=1):
            x, s = inc, sig
            for _ in range(iterations):
                z = torch.randn(P, N_MAIN, device=dev, generator=gen)
                noise = z * (s[:, None] if knobs.cem else knobs.sigma_mppi)
                noise[:, 0] = 0.0
                res = sm.softmax_iteration_reference(noise, x, plan.W, *t, plan.dts, plan.q_diag,
                                                     plan.srbd, plan.fm, knobs)
                x, s = res.new_params, res.sigma if knobs.cem else s

        r.update({
            "ms": time_cuda(one), "passes": pass_profile(one, 1, ("rollout", "update")),
            "plain_ms": time_cuda(plain, runs=PLAIN_RUNS),
            "successive_prebuilt_ms": time_cuda(successive_prebuilt),
            "chain_plain_ms": time_cuda(lambda: plain(3), runs=PLAIN_RUNS // 3),
            "bound": softmax_bound_ms(plan, knobs),
            "tick_ms": solve_tick_ms(SamplingMPC(cfg, device="cuda"), tick),
            "tick1_ms": solve_tick_ms(SamplingMPC(softmax_cfg(method, par, iterations=1),
                                                  device="cuda"), tick),
            "blocks_per_sm": sm.update_blocks_per_sm(plan, knobs)})
        log(f"{phase} {method} {par} (P={P}): update pass {r['blocks_per_sm']} blocks an SM "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor); one iteration {r['ms']:.4f} ms "
            f"(median of {TIMED_RUNS}; memset + 2 launches), plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]}); {chain_line}, prebuilt "
            f"{r['successive_prebuilt_ms']:.4f} ms; plain x 3 {r['chain_plain_ms']:.4f} ms, "
            f"bound {r['chain_bound'][0]:.5f} ms; solve tick with host glue (median of 200) "
            f"{r['tick_ms']:.4f} ms at 3 iterations, {r['tick1_ms']:.4f} ms at 1")
    return out


def check_groups(gplan, knobs, tick, groups, inc, noise, res, label) -> dict:
    """K1e checks: costs against the plain group rollout on the same noise; the best
    index the argmin of the kernel's own costs; the optimizer step against the plain
    one on those costs (the winner and its step-0 extraction, or K1b/K1c's combine).
    Returns the error figures."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
    from quadruped_pympc_tamols_torch.ops.cost_checks import DRIFT_H, f64

    costs_k, out_k, sigma_k, elites_k = res
    p, dev = gplan.base, inc.device
    t = sk.tick_tensors(tick, dev)
    g = [torch.as_tensor(x, device=dev) for x in (groups.contact, groups.share, groups.offsets)]
    plain = sg.group_costs_reference(inc[:, None] + noise, groups.dense(dev), *g, t[0], t[1],
                                     t[2], p.dts, p.q_diag, p.srbd, p.fm, p.zmp_weight,
                                     p.zmp_margin)
    plain64 = None
    if p.horizon > DRIFT_H:
        plain64 = sg.group_costs_reference(
            inc.double()[:, None] + noise.double(), groups.dense(dev).double(), *(f64(x) for x in g), t[0],
            t[1], t[2], p.dts, p.q_diag, f64(p.srbd), p.fm, p.zmp_weight, p.zmp_margin)
    errs = {"cost": check_costs(costs_k, plain, label, p.horizon, plain64)}
    k = int(out_k[25])
    if k != int(torch.argmin(costs_k)) or float(out_k[0]) != float(costs_k[k]):
        raise AssertionError(f"{label}: best {k} ({float(out_k[0])}) is not the argmin of the "
                             "kernel's costs")
    new_k = out_k[sk.OUT_WINNER:]
    if knobs.method == "random_sampling":
        winner = inc + noise[:, k]
        grfs, state = sk.step0_reference(winner, p.W, t[0], t[1], t[3], t[4], p.dts, p.srbd, p.fm)
        errs.update(winner=gap(new_k, winner), grf=gap(out_k[1:13], grfs.reshape(12)),
                    state=gap(out_k[13:25], state))
        tols = [("winner", PARAM_ATOL), ("grf", GRF_ATOL), ("state", STATE_ATOL)]
    else:
        ref = sm.softmax_combine_reference(costs_k, noise, inc, p.W, t[0], t[1], t[3], t[4], p.dts,
                                           p.srbd, p.fm, knobs)
        errs.update(params=gap(new_k, ref.new_params), grf=gap(out_k[1:13], ref.grfs.reshape(12)),
                    state=gap(out_k[13:25], ref.next_state))
        tols = [("params", COMBINE_ATOL), ("grf", GRF_ATOL), ("state", STATE_ATOL)]
        if knobs.cem:
            if not elites_match(knobs, elites_k, ref.elites):
                raise AssertionError(f"{label}: elites {elites_k.tolist()} vs "
                                     f"{ref.elites.tolist()}")
            errs["sigma"] = gap(sigma_k, ref.sigma)
            tols.append(("sigma", sigma_atol(knobs, ref.sigma)))
    for key, tol in tols:
        if not errs[key] <= tol:
            raise AssertionError(f"{label}: {key} error {errs[key]} > {tol}")
    errs["best_group"] = k // gplan.group_size
    return errs


def phase_groups(dev, rng, par=MAIN_PAR, phase="phase 10"):
    """Phase 10 (13 for the other parametrizations): K1e against its plain version
    at N = 10 000, K = 3."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.sampling import (GaitAdaptiveSamplingMPC,
                                                                   group_operators, host_best_freq)
    from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    errs = {}
    ones = np.ones(4, np.float32)
    for method in ("random_sampling", "mppi", "cem_mppi"):
        label = f"{phase} {method}" + (f" {par}" if par != MAIN_PAR else "")
        cfg = gait_cfg(method, par, **{"mpc.step_freq_available": GAIT_FREQS})
        gplan = sg.make_group_plan(cfg, N_MAIN, dev)
        knobs = sm.make_knobs(cfg)
        P, n, Ng = gplan.base.num_parameters, gplan.num_used, gplan.group_size
        if (n, Ng) != (3 * (N_MAIN // 3), N_MAIN // 3):
            raise AssertionError(f"{label}: {n} samples in groups of {Ng}")
        tick = example_tick(cfg, gplan.base)
        groups = group_operators(cfg, GAIT_PHASE, np.asarray(GAIT_FREQS, np.float32))
        inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
        sigma = torch.as_tensor(rng.uniform(0.3, 4.0, P).astype(np.float32), device=dev)
        if method == "random_sampling":
            noise = numpy_noise(gplan.base, rng)[:, :n]
        else:
            scale = sigma.cpu().numpy()[:, None] if knobs.cem else knobs.sigma_mppi
            noise = (rng.standard_normal((P, n)) * scale).astype(np.float32)
            noise[:, 0] = 0.0
        noise = torch.as_tensor(np.ascontiguousarray(noise), device=dev)

        def run(tk, seed=0, noise_in=None, noise_out=None):
            return sg.sampling_groups(gplan, knobs, tk, groups, inc, sigma, seed, 0,
                                      noise_in=noise_in, noise_out=noise_out)

        res = run(tick, noise_in=noise)
        torch.cuda.synchronize()
        e = check_groups(gplan, knobs, tick, groups, inc, noise, res, label)
        # A NaN state: every cost is 1e6 plus its group's offset.
        nan_tick = tick._replace(state12=np.full(12, np.nan, np.float32))
        res_nan = run(nan_tick, noise_in=noise)
        torch.cuda.synchronize()
        check_groups(gplan, knobs, nan_tick, groups, inc, noise, res_nan, f"{label} ties")
        offs = torch.as_tensor(groups.offsets, device=dev).repeat_interleave(Ng)
        low = int(np.argmin(groups.offsets))
        if not torch.equal(res_nan[0], 1.0e6 + offs) or int(res_nan[1][25]) != low * Ng:
            raise AssertionError(f"{label}: NaN state: winner {int(res_nan[1][25])}, want "
                                 f"{low * Ng}, or costs other than 1e6 + offset")
        elites = res_nan[3].tolist() if knobs.cem else None
        if knobs.cem and elites != list(range(low * Ng, low * Ng + knobs.n_elite)):
            raise AssertionError(f"{label}: tied elites {elites}")
        # Philox noise: dumped, rerun, bands of N over the 9999 evaluated samples.
        dump = torch.empty(P, n, device=dev)
        res_px = run(tick, seed=1234, noise_out=dump)
        res_px2 = run(tick, seed=1234)
        torch.cuda.synchronize()
        for a, b in zip(res_px, res_px2):
            if a is not None and not torch.equal(a, b):
                raise AssertionError(f"{label}: a rerun gave other bits")
        if not bool((dump[:, 0] == 0).all()):
            raise AssertionError(f"{label}: column 0 (the incumbent) is not zero")
        if method == "random_sampling":
            s1, s2, s3 = gplan.base.sigma_random
            b1, b2 = sk.band_edges(N_MAIN)
            bands = (("gauss1", 1, b1, s1), ("gauss2", b1, b2, s2),
                     ("uniform", b2, n, s3 / np.sqrt(3.0)))
            for name, lo, hi, sd in bands:
                band = dump[:, lo:hi].double()
                if abs(float(band.mean())) > 0.01 * sd or abs(float(band.std()) / sd - 1.0) > 0.02:
                    raise AssertionError(f"{label}: band {name} [{lo}, {hi}) mean "
                                         f"{float(band.mean())} std {float(band.std())}")
            if float(dump[:, b2:].abs().max()) > s3:
                raise AssertionError(f"{label}: uniform band leaves +-{s3}")
            noise_note = f"bands [1, {b1}), [{b1}, {b2}), [{b2}, {n})"
        else:
            std = dump[:, 1:].double().std(dim=1) / (sigma.double() if knobs.cem
                                                      else knobs.sigma_mppi)
            if not bool(((std - 1.0).abs() < 6.0 / np.sqrt(2.0 * n)).all()):  # 6 sd
                raise AssertionError(f"{label}: Philox noise std / sigma {std}")
            noise_note = "std / sigma within 6 sd of 1"
        e_px = check_groups(gplan, knobs, tick, groups, inc, dump, res_px, f"{label} philox")
        # The solver maps the best group to its frequency: on the NaN state the
        # lowest-offset group wins when the candidates are optimized, else the nominal.
        mpc = GaitAdaptiveSamplingMPC(cfg, device=dev)
        st, ref = tick_dicts(nan_tick)
        freqs = [host_best_freq(mpc.compute_control(st, ref, tick.contact_seq, ones, ones,
                                                    GAIT_PHASE, 1.4, opt)) for opt in (1, 0)]
        if freqs != [float(np.float32(GAIT_FREQS[low])), float(np.float32(1.4))]:
            raise AssertionError(f"{label}: best frequencies {freqs}")
        errs[method] = e
        log(f"{label} (N={N_MAIN}, K=3, {n} evaluated in groups of {Ng}): ok; injected noise "
            f"{e}; Philox noise {e_px} ({noise_note}); NaN state: costs 1e6 + offsets "
            f"{groups.offsets.tolist()}, winner {low * Ng}, elites {elites}; solver frequencies "
            f"{freqs}")
    return errs


def phase_group_times(dev, rng, par=MAIN_PAR, phase="phase 12"):
    """Phase 12 (15 for the other parametrizations): times of K1e per method, its
    plain version and its bound."""
    import dataclasses

    import torch
    from quadruped_pympc_tamols_torch.controllers.sampling import (GaitAdaptiveSamplingMPC,
                                                                   group_operators)
    from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    stream = torch.cuda.current_stream(dev).cuda_stream
    out = {}
    for method in ("random_sampling", "mppi", "cem_mppi"):
        cfg = gait_cfg(method, par)
        gplan = sg.make_group_plan(cfg, N_MAIN, dev)
        lib = sg.load_library(gplan.base.horizon, gplan.base.params_per_leg)
        knobs = sm.make_knobs(cfg)
        tick = example_tick(cfg, gplan.base)
        groups = group_operators(cfg, GAIT_PHASE,
                                 np.asarray(cfg.mpc.step_freq_available, np.float32))
        p, P, n = gplan.base, gplan.base.num_parameters, gplan.num_used
        inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
        sig = torch.full((P,), cfg.mpc.sampling.sigma_cem_mppi, device=dev)
        # Through the C entry with the argument block and the group buffer built once,
        # so the events see the memset and the launches; the wrapper (which also
        # packs, pins and copies the group buffer) is timed beside.
        buf = torch.as_tensor(sg.pack_groups(groups), device=dev)
        args = sk.kernel_args(p, tick, 5, 0)
        args.num_samples = n
        ws = sm.workspace(dataclasses.replace(p, num_samples=n), knobs, dev)
        t = sk.tick_tensors(tick, dev)
        g = [torch.as_tensor(x, device=dev) for x in (groups.contact, groups.share, groups.offsets)]
        Wg = groups.dense(dev)
        gen = torch.Generator(device=dev).manual_seed(0)

        def plain():
            z = torch.randn(P, n, device=dev, generator=gen)
            noise = z * (sig[:, None] if knobs.cem else knobs.sigma_mppi)
            noise[:, 0] = 0.0
            sg.group_iteration_reference(noise, inc, Wg, *g, p.W, *t, p.dts, p.q_diag, p.srbd,
                                         p.fm, knobs)

        host_us = []
        for _ in range(200):
            t0 = time.perf_counter()
            group_operators(cfg, GAIT_PHASE, np.asarray(cfg.mpc.step_freq_available, np.float32))
            host_us.append((time.perf_counter() - t0) * 1e6)

        def launch():
            sg.launch(lib, args, knobs, gplan, ws, buf, inc, sig, stream=stream)

        out[method] = {
            "operators_us": statistics.median(host_us),
            "ms": time_cuda(launch),
            "passes": pass_profile(launch, 1, ("rollout", "update" if method != "random_sampling"
                                               else "extract")),
            "wrapper_ms": time_cuda(lambda: sg.sampling_groups(gplan, knobs, tick, groups, inc,
                                                               sig, 5, 0)),
            "plain_ms": time_cuda(plain, runs=PLAIN_RUNS),
            "bound": group_bound_ms(gplan, knobs, groups),
            "tick_ms": solve_tick_ms(GaitAdaptiveSamplingMPC(cfg, device="cuda"), tick)}
        r = out[method]
        log(f"{phase} {method} {par}: K1e {r['ms']:.4f} ms (median of {TIMED_RUNS}, C entry with "
            f"prebuilt arguments), through its wrapper {r['wrapper_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]}); "
            f"gait-adaptive solve tick with host glue {r['tick_ms']:.4f} ms (median of 200), "
            f"of which the host's group_operators {r['operators_us']:.1f} us (median of 200)")
    return out


def phase_rs(dev, rng, par=MAIN_PAR, phase=None):
    """Phases 1-2 (13 for the other parametrizations): K1a against its plain version
    on injected noise at N = 10 000, then its Philox noise: band statistics, the
    incumbent column, determinism, and the plain version reproducing the kernel's
    costs on the dumped noise. Returns the injected noise's error figures."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk

    one, two = ("phase 1", "phase 2") if phase is None else (f"{phase} K1a {par}",) * 2
    cfg = main_cfg(par)
    plan = sk.make_rs_plan(cfg, N_MAIN, dev)
    tick = example_tick(cfg, plan)
    P = plan.num_parameters
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32) * 2.0, device=dev)
    noise = torch.as_tensor(numpy_noise(plan, rng), device=dev)
    costs_k, out_k = sk.sampling_rs(plan, tick, inc, 0, 0, noise_in=noise)
    torch.cuda.synchronize()
    errs, _ = check_against_plain(plan, tick, inc, noise, costs_k, out_k, one)
    log(f"{one} (N={N_MAIN}, H={plan.horizon}, P={P}): ok; max abs err {errs}")

    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
    dump = torch.empty(P, N_MAIN, device=dev)
    dump2 = torch.empty_like(dump)
    costs_k, out_k = sk.sampling_rs(plan, tick, inc, 1234, 7, noise_out=dump)
    costs_2, out_2 = sk.sampling_rs(plan, tick, inc, 1234, 7, noise_out=dump2)
    torch.cuda.synchronize()
    if not (torch.equal(dump, dump2) and torch.equal(costs_k, costs_2)
            and torch.equal(out_k, out_2)):
        raise AssertionError(f"{two}: the same (seed, offset) gave other bits")
    sk.sampling_rs(plan, tick, inc, 1234, 8, noise_out=dump2)
    torch.cuda.synchronize()
    if torch.equal(dump, dump2):
        raise AssertionError(f"{two}: a new offset gave the same noise")
    if not bool((dump[:, 0] == 0).all()):
        raise AssertionError(f"{two}: column 0 (the incumbent) is not exactly zero")
    s1, s2, s3 = plan.sigma_random
    b1, b2 = sk.band_edges(N_MAIN)
    stats = {}
    for name, lo, hi, sigma in (("gauss1", 1, b1, s1), ("gauss2", b1, b2, s2),
                                ("uniform", b2, N_MAIN, s3 / np.sqrt(3.0))):
        band = dump[:, lo:hi].double()
        mean, std = float(band.mean()), float(band.std())
        stats[name] = (mean, std)
        if abs(mean) > 0.01 * sigma or abs(std / sigma - 1.0) > 0.02:
            raise AssertionError(f"{two}: band {name} mean {mean} std {std}, want 0, {sigma}")
    u = dump[:, b2:]
    if float(u.min()) < -s3 or float(u.max()) > s3:
        raise AssertionError(f"{two}: uniform band leaves +-{s3}")
    errs2, _ = check_against_plain(plan, tick, inc, dump, costs_k, out_k, f"{two} philox")
    log(f"{two} philox: ok; bit-equal on a rerun; band (mean, std) {stats}; plain on dumped "
        f"noise max abs err {errs2}")
    return errs


def rs_times(dev, rng, par=MAIN_PAR, phase="phase 4"):
    """Phase 4 (15 for the other parametrizations): K1a through its C entry with the
    argument block built once, so the events see the memset and the two launches,
    not Python's packing; its passes, its plain version and its bound."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk

    cfg = main_cfg(par)
    plan = sk.make_rs_plan(cfg, N_MAIN, dev)
    tick = example_tick(cfg, plan)
    P = plan.num_parameters
    noise = torch.as_tensor(numpy_noise(plan, rng), device=dev)
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
    lib = sk.load_library(plan.horizon, plan.params_per_leg)
    args = sk.kernel_args(plan, tick, 5, 0)
    costs_t = torch.empty(N_MAIN, device=dev)
    out_t = torch.empty(sk.OUT_WINNER + P, device=dev)
    argmin_t = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = lib.rs_launch(sk.ctypes.byref(args), plan.params_per_leg, plan.windows.data_ptr(),
                           inc.data_ptr(), None, None, costs_t.data_ptr(), argmin_t.data_ptr(),
                           out_t.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"rs_launch returned {rc}")

    r = {"ms": time_cuda(launch), "passes": pass_profile(launch, 1, ("rollout", "extract")),
         "plain_ms": time_cuda(lambda: plain_on_device(plan, tick, inc, noise), runs=50),
         "bound": k1a_bound_ms(plan)}
    log(f"{phase} K1a {par} (P={P}): {r['ms']:.4f} ms (median of {TIMED_RUNS}, two launches + "
        f"memset), rs_extract_kernel {r['passes']['extract'][1]:.2f} us on the card "
        f"(torch.profiler), plain version {r['plain_ms']:.4f} ms, bound {r['bound'][0]:.5f} ms "
        f"({r['bound'][1]})")
    return r


def tick_loop(mpc, tick, label, want_counts, n=TICK_LOOP):
    """n solve ticks of a controller on ``tick``, through compute_control and the
    read of its host summary, with the launch counts zeroed just before and read
    just after; raises unless they are ``want_counts(n)``, every summary is finite
    with its best cost under the 1e6 saturation and, for CEM-MPPI, every sigma
    stays inside [cem_sigma_min, cem_sigma_max]. Returns the counts."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.sampling import (GaitAdaptiveSamplingMPC,
                                                                   host_summary)
    sp = mpc.cfg.mpc.sampling
    st, ref = tick_dicts(tick)
    ones = np.ones(4, np.float32)
    gait = (GAIT_PHASE, 1.4, 1) if isinstance(mpc, GaitAdaptiveSamplingMPC) else ()
    summaries, sigmas = [], []
    reset_counts()
    for _ in range(n):
        out = mpc.compute_control(st, ref, tick.contact_seq, ones, ones, *gait)
        grfs, state, cost = host_summary(out)
        summaries.append(np.concatenate([grfs.ravel(), state, [cost]]))
        sigmas.append(out.sigma)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts != want_counts(n):
        raise AssertionError(f"{label}: launches {counts} for {n} ticks, want {want_counts(n)}")
    if not (np.isfinite(np.stack(summaries)).all()
            and max(x[-1] for x in summaries) < 1e6):
        raise AssertionError(f"{label}: a non-finite summary or a saturated best cost")
    sig = torch.stack(sigmas)
    if sp.method == "cem_mppi" and not bool(((sig >= sp.cem_sigma_min)
                                             & (sig <= sp.cem_sigma_max)).all()):
        raise AssertionError(f"{label}: sigma left [{sp.cem_sigma_min}, {sp.cem_sigma_max}]")
    log(f"{label}: ok; {n} ticks with finite summaries (last best cost "
        f"{summaries[-1][-1]:.4f}); launches {counts}")
    return counts


# -- phases 16-17: the TAMOLS foothold planner (no kernel of its own) -------------------
# Terrains for torch tensors, and for the numpy floats of the harness's touchdowns:
# the three of tests/test_tamols.py for the scorer, flat ground and a 5 cm step up
# at x > 0.6 m for the walks.
def flat(x, y):
    return 0.0 * x


def step_edge(x, y):
    return (x > 0.3) * 0.10


def stones(x, y):
    import torch
    cx, cy = torch.round(x / 0.4) * 0.4, torch.round(y / 0.4) * 0.4
    return torch.where((x - cx) ** 2 + (y - cy) ** 2 <= 0.09**2, 0.0, -0.30)


def step_up(x, y):
    return (x > 0.6) * 0.05


SCORER_TERRAINS = {"flat": flat, "step_edge": step_edge, "stones": stones}
SCORER_RANDOM_SETS = 16
# The scorer on the card against the CPU: footholds and boxes (m), best costs
# relative with a floor for the roughness of an exactly flat patch (rounding noise
# of the 9 x 9 projector product, ~1e-17).
SCORER_POS_ATOL, SCORER_COST_RTOL, SCORER_COST_ATOL = 1e-5, 1e-5, 1e-9
# (strategy, terrain) of the walks, and the JAX package's SRB harness walking each
# on the CPU with the same sensing, 3 s at 0.3 m/s, N = 10 000: apex triggers,
# distance (m), min z (m), max |roll|,|pitch| (rad), mean z of the second half -
# ref_z (m); `python tests/test_torch_tamols.py`.
TAMOLS_WALKS = {("tamols", "flat"): flat, ("tamols", "step"): step_up,
                ("height", "step"): step_up}
JAX_CPU_TAMOLS_WALKS = {("tamols", "flat"): (8, 0.8897, 0.3135, 0.1246, -0.0220),
                        ("tamols", "step"): (8, 0.8610, 0.3123, 0.1192, -0.0150),
                        ("height", "step"): (8, 0.8601, 0.3386, 0.0770, 0.0195)}
MIN_TRIGGERS = 6
NOMINAL_FEET = np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0], [-0.25, 0.15, 0.0],
                         [-0.25, -0.15, 0.0]])


def tamols_cfg(strategy):
    """The default configuration (random sampling x 1, cubic splines, N = 10 000,
    H = 12) with the given foothold strategy; "tamols" is the default."""
    from quadruped_pympc_tamols_torch import make_config
    return make_config("aliengo", mpc_type="sampling",
                       **{"sim.visual_foothold_adaptation": strategy})


def scorer_inputs(cfg, terrain, rng, k):
    """Input set k of the scorer on a terrain, on the CPU: 0 the nominal stance of
    tests/test_tamols.py, then seeded random seeds, hips, base state, contacts,
    feet, anchors and swing times. Returns (heightmaps, args)."""
    from quadruped_pympc_tamols_torch.planner import heightmap_from_fn
    tp = cfg.tamols
    seeds, t_remain = NOMINAL_FEET.copy(), np.full(4, 1e3)
    hips, feet = seeds + np.array([0.0, 0.0, cfg.robot.hip_height]), seeds.copy()
    base_pos, base_vel, contact = np.array([0.0, 0.0, 0.35]), np.array([0.2, 0.0, 0.0]), np.zeros(4)
    if k > 0:
        seeds = seeds + rng.normal(0.0, [0.06, 0.04, 0.01], (4, 3))
        hips = seeds + np.array([0.0, 0.0, 0.35]) + rng.normal(0.0, 0.03, (4, 3))
        feet = seeds - np.array([0.1, 0.0, 0.0]) + rng.normal(0.0, 0.04, (4, 3))
        base_pos = base_pos + rng.normal(0.0, 0.03, 3)
        base_vel = rng.normal([0.3, 0.0, 0.0], 0.2, 3)
        contact = rng.integers(0, 2, 4).astype(np.float64)
        t_remain = rng.uniform(0.02, 0.3, 4)
    anchor = feet + rng.normal(0.0, 0.02, (4, 3))
    hms = heightmap_from_fn(terrain, seeds[:, :2], np.zeros(4), tp.heightmap_resolution,
                            tp.heightmap_rows, tp.heightmap_cols, device="cpu")
    return hms, (seeds, hips, base_pos, base_vel, contact, feet, anchor, t_remain)


def hms_to(hms, dev):
    import dataclasses
    return type(hms)(*(getattr(hms, f.name).to(dev) for f in dataclasses.fields(hms)))


def phase_scorer(dev, rng) -> dict:
    """Phase 16: the TAMOLS scorer ("tamols" and "height") on the card against the
    same scorer on the CPU, on the terrains of tests/test_tamols.py at the default
    13 x 7 grid, each with its nominal input and SCORER_RANDOM_SETS random ones:
    the same feasibility, the same chosen cell (a different one only where the
    CPU's two best costs lie within SCORER_COST_RTOL, printed), footholds and boxes
    to SCORER_POS_ATOL, finite best costs to SCORER_COST_RTOL. Then per apex call on
    the card: host ms of TamolsPlanner.compute_adaptation with its one copy back
    (median of 100), the CPU's, the kernel launches and device time (torch.profiler)
    and the copies."""
    import torch
    from quadruped_pympc_tamols_torch.planner import TamolsPlanner, make_tamols_scorer

    out = {}
    for strategy in ("tamols", "height"):
        cfg = tamols_cfg(strategy)
        on_cpu = make_tamols_scorer(cfg, strategy, "cpu")
        on_card = make_tamols_scorer(cfg, strategy, dev)
        pos_err = cost_err = cell_err = 0.0
        allowed, legs, fallbacks = [], 0, 0
        for name, terrain in SCORER_TERRAINS.items():
            for k in range(1 + SCORER_RANDOM_SETS):
                hms, args = scorer_inputs(cfg, terrain, rng, k)
                want = on_cpu(hms, *args)
                got = [x.cpu() for x in on_card(hms_to(hms, dev), *args)]
                label = f"phase 16 {strategy} {name} set {k}"
                if not torch.equal(got[4], want.feasible):
                    raise AssertionError(f"{label}: feasible {got[4]} on the card, "
                                         f"{want.feasible} on the CPU")
                same = torch.ones(4, dtype=torch.bool)
                if strategy == "tamols":
                    cell_k, cell_c = got[5].argmin(1), want.cell_costs.argmin(1)
                    same = cell_k == cell_c
                    for leg in torch.nonzero(~same).flatten().tolist():
                        two = torch.sort(want.cell_costs[leg]).values[:2]
                        if not (two[1] - two[0]) <= SCORER_COST_RTOL * two[0].abs():
                            raise AssertionError(f"{label} leg {leg}: cell {cell_k[leg]} on "
                                                 f"the card, {cell_c[leg]} on the CPU")
                        allowed.append((label, leg, two.tolist()))
                        log(f"{label} leg {leg}: cell {int(cell_k[leg])} on the card, "
                            f"{int(cell_c[leg])} on the CPU, whose two best costs "
                            f"{two.tolist()} lie within {SCORER_COST_RTOL}")
                    finite = (want.cell_costs < 1e10) & (got[5] < 1e10)
                    if finite.any():
                        cell_err = max(cell_err, float(((got[5] - want.cell_costs).abs()
                                                        / want.cell_costs.abs().clamp(min=1e-30)
                                                        )[finite].max()))
                for i, field in ((0, "footholds"), (1, "constraints_lo"),
                                 (2, "constraints_hi")):
                    d = (got[i] - getattr(want, field)).abs()[same]
                    err = float(d.max()) if d.numel() else 0.0
                    if not err <= SCORER_POS_ATOL:
                        raise AssertionError(f"{label}: {field} differ by {err} m")
                    pos_err = max(pos_err, err)
                fin = want.feasible & same
                gap = (got[3] - want.best_cost).abs()[fin]
                if not bool((gap <= SCORER_COST_ATOL + SCORER_COST_RTOL
                             * want.best_cost.abs()[fin]).all()):
                    raise AssertionError(f"{label}: best costs {got[3]} on the card, "
                                         f"{want.best_cost} on the CPU")
                if fin.any():
                    cost_err = max(cost_err, float((gap / want.best_cost.abs()[fin]
                                                    .clamp(min=1e-30)).max()))
                if not bool(torch.isfinite(got[0]).all()):
                    raise AssertionError(f"{label}: non-finite footholds")
                legs += 4
                fallbacks += int((~want.feasible).sum())
        # Per apex call: the planner on the nominal step-edge input, as the walks call it.
        hms, args = scorer_inputs(cfg, step_edge, rng, 0)
        hms_card = hms_to(hms, dev)
        timing = {}
        for where, planner, h in (("card", TamolsPlanner(cfg, device=dev), hms_card),
                                  ("cpu", TamolsPlanner(cfg, device="cpu"), hms)):
            def call(planner=planner, h=h):
                planner.compute_adaptation(h, *args[:6], own_anchor=args[6], t_remain=args[7])
            timing[where] = (median_host_ms(call, 100), call)
        card_call = timing["card"][1]
        copies = host_d2h_copies(card_call, 20)
        if copies != 20:
            raise AssertionError(f"phase 16 {strategy}: 20 apex calls issued {copies} "
                                 "device-to-host copies, want one a call")
        prof = scorer_profile(card_call)
        out[strategy] = {"ms": timing["card"][0], "cpu_ms": timing["cpu"][0], **prof,
                         "pos_max_abs_err": pos_err, "best_cost_max_rel_err": cost_err,
                         "cell_cost_max_rel_err": cell_err, "allowed_cells": len(allowed)}
        log(f"phase 16 {strategy}: ok; {legs} legs ({fallbacks} fall back) on "
            f"{len(SCORER_TERRAINS)} terrains x {1 + SCORER_RANDOM_SETS} inputs agree with "
            f"the CPU: footholds and boxes to {pos_err:.3g} m, best costs to {cost_err:.3g} "
            f"relative, every finite cell cost to {cell_err:.3g}; {len(allowed)} legs took "
            f"another of two cells tied within {SCORER_COST_RTOL}")
        log(f"phase 16 {strategy}: per apex call on the card {timing['card'][0]:.4f} ms host "
            f"clock with its one copy back (median of 100; CPU {timing['cpu'][0]:.4f} ms); "
            f"profile {prof}")
    return out


def scorer_profile(call, n=20) -> dict:
    """Kernel launches, copies and device time per call of ``call`` (n calls a
    window) from torch.profiler. A window is complete where its device kernel
    records equal its host records of launch calls (cudaLaunchKernel,
    cuLaunchKernel and their variants) and divide by n; a lost record breaks
    either, so an incomplete window is profiled again (PROFILE_WINDOWS), and if
    none is complete the fullest is reported with ``complete`` false."""
    import torch

    def calls():
        for _ in range(n):
            call()
        torch.cuda.synchronize()

    best = None
    for window in range(PROFILE_WINDOWS):
        prof, wall_s = profile_window(calls)
        device, host, _ = window_rows(prof)
        api = sum(count for key, count in host.items() if "LaunchKernel" in key)
        kernels = copies = 0
        busy_us = 0.0
        for key, (count, dev_us) in device.items():
            busy_us += dev_us
            if "Memcpy" in key:
                copies += count
            elif "Memset" not in key:
                kernels += count
        complete = api == kernels and kernels > 0 and kernels % n == 0
        r = {"launches_per_call": kernels / n, "launch_api_calls_per_call": api / n,
             "copies_per_call": copies / n, "device_us_per_call": busy_us / n,
             "window_ms_per_call": wall_s * 1e3 / n, "complete": complete}
        if best is None or kernels > best["launches_per_call"] * n:
            best = r
        if complete:
            return r
        log(f"  profiler window {window + 1}: {kernels} kernel records, {api} launches in "
            f"{n} calls; profiling again")
    return best


def tamols_walk(strategy, terrain, fn, launches_per_call) -> dict:
    """Phase 17: the default configuration walking the SRB harness on the card for
    WALK_S at WALK_VEL over ``fn``, sensing as the JAX package's MuJoCo loop does
    (while the planner waits for its apex, one grid per leg around the last
    reference footholds at the base yaw, from tamols.heightmap_*), touchdowns
    snapped to the terrain; the launch counts zeroed just before and read just
    after. Raises unless it walks the band with K1a once an MPC tick and at least
    MIN_TRIGGERS apex calls."""
    import torch
    from quadruped_pympc_tamols_torch.planner import heightmap_from_fn
    from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness

    label = f"phase 17 {strategy} {terrain}"
    cfg = tamols_cfg(strategy)
    tp = cfg.tamols
    h = SRBClosedLoopHarness(cfg, seed=0, terrain_fn=fn, device="cuda")
    # Host seconds of each layer in the current step (0: not called in it).
    rec = {"plan": 0.0, "solve": 0.0, "apex": 0.0}
    time_layer(h.wb, "update_state_and_reference", rec, "plan")
    time_layer(h.ctrl, "compute_control", rec, "solve")
    time_layer(h.wb.vfa, "compute_adaptation", rec, "apex")
    n = int(round(WALK_S / cfg.sim.dt))
    hist, steps, sense_s = np.zeros((n, 12)), [], 0.0
    reset_counts()
    t_start = time.perf_counter()
    for i in range(n):
        rec.update(plan=0.0, solve=0.0, apex=0.0)
        hms = None
        if not h.wb.vfa.initialized:
            t0 = time.perf_counter()
            ref = np.asarray(h.wb.frg.last_reference_footholds.data)
            hms = heightmap_from_fn(fn, ref[:, :2], np.full(4, h.x[8]), tp.heightmap_resolution,
                                    tp.heightmap_rows, tp.heightmap_cols, device="cuda")
            sense_s += time.perf_counter() - t0
        hist[i] = h.step(WALK_VEL, heightmaps=hms)
        steps.append({k: v * 1e3 for k, v in rec.items()})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = read_counts()
    ticks = n // h._mpc_every
    dist, min_z, tilt, dz = walk_band(label, cfg, hist)
    check_counts(label, counts, counts_of(K1a=1), ticks)
    apex = [s["apex"] for s in steps if s["apex"] > 0.0]
    if len(apex) < MIN_TRIGGERS:
        raise AssertionError(f"{label}: the adaptation triggered {len(apex)} times, want at "
                             f"least {MIN_TRIGGERS}")
    # Control periods of one MPC tick (mpc_every steps, the first solving): the
    # planners' and the solve's host ms, on periods with an apex call and without.
    periods = [steps[p:p + h._mpc_every] for p in range(0, n, h._mpc_every)]
    per = {True: ([], []), False: ([], [])}
    for period in periods:
        is_apex = any(s["apex"] > 0.0 for s in period)
        per[is_apex][0].append(period[0]["solve"])
        per[is_apex][1].append(sum(s["plan"] for s in period) + period[0]["solve"])
    med = statistics.median
    r = {"walked_m": dist, "min_z_m": min_z, "max_tilt_rad": tilt, "mean_z_minus_ref_m": dz,
         "triggers": len(apex), "scorer_ms_per_apex_call": statistics.median(apex),
         "scorer_ms_per_apex_call_max": max(apex), "scorer_launches_per_call": launches_per_call,
         "solve_tick_ms_apex": med(per[True][0]), "solve_tick_ms_other": med(per[False][0]),
         "control_period_ms_apex": med(per[True][1]),
         "control_period_ms_other": med(per[False][1]), "apex_periods": len(per[True][0]),
         "harness_s_per_sim_s": wall / WALK_S, "sensing_s": sense_s, "launches": counts}
    log(f"{label}: ok; walked {dist:.4f} m, min z {min_z:.4f} m, max |roll|,|pitch| "
        f"{tilt:.4f} rad, mean z of the second half - ref_z {dz:+.4f} m; JAX package on the "
        f"CPU (triggers, walked, min z, max tilt, mean z - ref_z): "
        f"{JAX_CPU_TAMOLS_WALKS.get((strategy, terrain), 'not measured')}")
    log(f"{label}: {len(apex)} apex calls, the scorer {r['scorer_ms_per_apex_call']:.4f} ms "
        f"host clock a call with its one copy (median; max {max(apex):.4f}), "
        f"{launches_per_call} launches a call (phase 16); solve tick (median) "
        f"{r['solve_tick_ms_apex']:.4f} ms on the {len(per[True][0])} apex ticks, "
        f"{r['solve_tick_ms_other']:.4f} ms on the others; planners + solve a 10 ms tick "
        f"{r['control_period_ms_apex']:.4f} / {r['control_period_ms_other']:.4f} ms; "
        f"sensing {sense_s:.3f} s; launches {counts} for {ticks} ticks; harness "
        f"{wall / WALK_S:.3f} s wall per simulated s")
    return r

# -- phase 18: the torque path and the wrapper on a recorded MuJoCo loop ----------------
TRACE_ATOL = 1e-6  # tau (N m), des_q (rad), des_qd (rad/s) against the JAX package
STANCE_ATOL = 1e-9  # stance tau against -J^T f - qfrc_passive, both float64 on the host
TIMED_REPLAYS = 3  # timed passes over the trace (the first warms the planner up)


def phase_torque_trace() -> dict:
    """Phase 18 (a): WBInterface (planner on the card) on the recorded loop with
    the recorded GRFs and footholds; the largest error of each output."""
    from quadruped_pympc_tamols_torch.interfaces import WBInterface
    from quadruped_pympc_tamols_torch.interop import config_from_dict
    from quadruped_pympc_tamols_torch.sim.trace import ControlTrace
    from quadruped_pympc_tamols_torch.utils.legs import Legs

    trace = ControlTrace()
    a = trace.arrays
    wb = WBInterface(config_from_dict(trace.config), Legs(a["feet_pos"][0].copy()),
                     device="cuda")
    worst = {"tau": 0.0, "des_q": 0.0, "des_qd": 0.0}
    for i in range(trace.steps):
        wb.update_state_and_reference(**trace.update_args(i, device="cuda"))
        out = wb.compute_stance_and_swing_torque(**trace.torque_args(i))
        for name, x in zip(worst, out):
            worst[name] = max(worst[name], float(np.abs(x.data - a[name][i]).max()))
    if not max(worst.values()) <= TRACE_ATOL:
        raise AssertionError(f"phase 18 (a): torque path off the JAX package: {worst}")
    log(f"phase 18 (a): ok; {trace.steps} recorded steps through WBInterface (planner on "
        f"the card), largest error against the JAX package {worst}")
    return worst


def card_ops_counter():
    """A TorchDispatchMode counting, per step, the ops that read or write a CUDA
    tensor and the device-to-host copies among them (as host_d2h_copies)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Count(TorchDispatchMode):
        ops = copies = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            outs = tree_leaves(out)
            if any(t.is_cuda for t in ins) or any(
                    isinstance(t, torch.Tensor) and t.is_cuda for t in outs):
                Count.ops += 1
            if any(t.is_cuda for t in ins) and any(
                    isinstance(t, (bool, int, float)) or isinstance(t, torch.Tensor)
                    and t.device.type == "cpu" for t in outs):
                Count.copies += 1
            return out

    return Count


def _never():
    raise AssertionError("the sampling path evaluated the inertia callable")


def wrapper_replay(trace, counted: bool) -> dict:
    """Phase 18 (b): one pass of the recorded observations through
    QuadrupedPyMPCWrapper(..., device="cuda").compute_actions, the launch counts
    zeroed just before and read just after. ``counted``: check every step (see
    phase 18) under card_ops_counter; otherwise time each call and each layer."""
    import torch
    from quadruped_pympc_tamols_torch.interfaces import QuadrupedPyMPCWrapper
    from quadruped_pympc_tamols_torch.interop import config_from_dict
    from quadruped_pympc_tamols_torch.utils.legs import Legs

    cfg = config_from_dict(trace.config)
    w = QuadrupedPyMPCWrapper(cfg, Legs(trace.arrays["feet_pos"][0].copy()), seed=0,
                              device="cuda")
    wb = w.wb_interface
    layer = {"planners": 0.0, "apex": 0.0, "solve": 0.0, "torque path": 0.0}
    time_layer(wb, "update_state_and_reference", layer, "planners")
    time_layer(wb.vfa, "compute_adaptation", layer, "apex")
    time_layer(w.srbd_controller_interface, "compute_control", layer, "solve")
    time_layer(wb, "compute_stance_and_swing_torque", layer, "torque path")
    inputs = [trace.inputs(i) for i in range(trace.steps)]  # heightmaps on the host
    Count = card_ops_counter()
    mpc_ms, other_ms, per_layer = [], [], {k: [] for k in layer}
    apex_steps = copies = 0
    reset_counts()
    for i, kw in enumerate(inputs):
        layer.update({k: 0.0 for k in layer})
        Count.ops = Count.copies = 0
        t0 = time.perf_counter()
        if counted:
            with Count():
                tau = w.compute_actions(**kw, inertia=_never)
        else:
            tau = w.compute_actions(**kw, inertia=_never)
        ms = (time.perf_counter() - t0) * 1e3
        mpc = i % w._mpc_every == 0
        apex = layer["apex"] > 0.0
        apex_steps += apex
        (mpc_ms if mpc else other_ms).append(ms)
        for k, v in layer.items():
            per_layer[k].append(v * 1e3)
        if not counted:
            continue
        tau = np.asarray(tau.data)
        label = f"phase 18 (b) step {i}"
        if not np.all(np.isfinite(tau)):
            raise AssertionError(f"{label}: torques not finite")
        stance = wb.current_contact == 1
        f = np.asarray(w.nmpc_GRFs.data)
        want = -np.einsum("lji,lj->li", kw["feet_jac"].data, f) - kw["legs_qfrc_passive"].data
        if not np.all(np.abs(tau[stance] - want[stance]) <= STANCE_ATOL):
            raise AssertionError(f"{label}: stance torque is not -J^T f - qfrc_passive")
        if mpc and np.any(f[~stance] != 0.0):
            raise AssertionError(f"{label}: swing-leg GRFs {f[~stance]}")
        if Count.copies != int(mpc) + int(apex):
            raise AssertionError(f"{label}: {Count.copies} device-to-host copies, want "
                                 f"{int(mpc) + int(apex)} (MPC tick {mpc}, apex call {apex})")
        if not (mpc or apex) and Count.ops:
            raise AssertionError(f"{label}: {Count.ops} operations on the card between solves")
        copies += Count.copies
    torch.cuda.synchronize()
    counts = read_counts()
    ticks = trace.steps // w._mpc_every
    check_counts("phase 18 (b)", counts, counts_of(K1a=1), ticks)
    med = statistics.median

    def p99(xs):
        return float(np.percentile(xs, 99))

    return {"launches": counts, "mpc_ticks": ticks, "apex_steps": apex_steps,
            "d2h_copies": copies, "compute_actions_ms_mpc_median": med(mpc_ms),
            "compute_actions_ms_mpc_p99": p99(mpc_ms),
            "compute_actions_ms_other_median": med(other_ms),
            "compute_actions_ms_other_p99": p99(other_ms),
            "layer_ms_median": {k: med(v) for k, v in per_layer.items()},
            "layer_ms_mean": {k: float(np.mean(v)) for k, v in per_layer.items()}}


def phase_wrapper(trace_worst) -> dict:
    """Phase 18 (b): the counted replay, then TIMED_REPLAYS timed ones (the last
    is reported)."""
    from quadruped_pympc_tamols_torch.sim.trace import ControlTrace

    trace = ControlTrace()
    r = wrapper_replay(trace, counted=True)
    log(f"phase 18 (b): ok; {trace.steps} recorded steps through QuadrupedPyMPCWrapper on "
        f"the card: launches {r['launches']} for {r['mpc_ticks']} MPC ticks, "
        f"{r['d2h_copies']} device-to-host copies ({r['apex_steps']} apex calls), none and "
        f"no operation on the card on the other ticks; stance tau = -J^T f - qfrc_passive "
        f"to {STANCE_ATOL}, swing GRFs zero, inertia never evaluated")
    for _ in range(TIMED_REPLAYS):
        timed = wrapper_replay(trace, counted=False)
    log(f"phase 18 (b): compute_actions host clock (pass {TIMED_REPLAYS} of "
        f"{TIMED_REPLAYS}): MPC ticks median {timed['compute_actions_ms_mpc_median']:.4f} ms, "
        f"p99 {timed['compute_actions_ms_mpc_p99']:.4f} ms; other ticks median "
        f"{timed['compute_actions_ms_other_median']:.4f} ms, p99 "
        f"{timed['compute_actions_ms_other_p99']:.4f} ms; per step by layer (mean ms) "
        f"{({k: round(v, 4) for k, v in timed['layer_ms_mean'].items()})}")
    return {"trace_max_abs_err": trace_worst, "counted": r, "timed": timed}


# -- phases 19-21: the gradient family's nominal RTI-SQP on the card -------------------
GRAD_F64_FLOOR = 0.01  # N: the floor of the first-stage GRF bound against float64
GRAD_TIMED = 200  # host-clock ticks behind each median
LADDER_MAX_N, LADDER_REL = 0.6, 2.5e-3  # tests/test_f64_ladder.py:42-56
LADDER_BUDGETS = (8, 10, 12, 14)  # Mehrotra iterations the ladder reports beside the card's
# Steps of the harness with mpc.optimize_step_freq (phase 21): its touch-down
# windows open at steps 202, 380 and 559 (none in the first 30 MPC ticks).
GAIT_STEPS = 600
# The JAX package's nominal walks on the CPU (3 s at 0.3 m/s): walked m, min z m,
# max |roll|,|pitch| rad, apex calls, mean z of the second half - ref_z m;
# `python tests/test_torch_gradient.py`.
JAX_CPU_GRADIENT_WALKS = {"blind": (0.8928, 0.3484, 0.0077, 0, -0.0010),
                          "rti": (0.9082, 0.3500, 0.0120, 0, 0.0033),
                          "tamols_step": (0.9142, 0.3480, 0.0812, 8, 0.0084)}


def grad_cfg(**over):
    from quadruped_pympc_tamols_torch import make_config
    return make_config("aliengo", mpc_type="nominal", **over)


def eager(mpc):
    """``mpc`` with every phase run eagerly on its device (the graphs' plain version)."""
    for name in ("_solve_dev", "_prepare_dev", "_feedback_dev"):
        if getattr(mpc, name) is not None:  # no split under use_DDP
            setattr(mpc, name, getattr(mpc, name).fn)
    return mpc


def grad_inputs(mpc, name):
    """(x0, feet_traj, seq, Xref, Uref) of a golden scenario's first tick."""
    from quadruped_pympc_tamols_torch.utils.verification import golden_nominal_scenarios
    state, ref, seq = golden_nominal_scenarios(mpc.cfg)[name]
    seq = np.asarray(seq, np.float32)
    x0, feet = mpc._build_inputs(state, ref, seq)
    Xref, Uref = mpc._build_refs(state, ref, seq)
    return x0, feet, seq, Xref, Uref


def at_card_budget(make):
    """``make()`` with the CPU's QP iteration budget set to the card's, so that a CPU
    controller is compared with the card's on the same iterations."""
    from quadruped_pympc_tamols_torch.controllers.gradient import sqp
    budget = sqp.qp_solver_for
    sqp.qp_solver_for = lambda gp, device="cuda": budget(gp, "cuda")
    try:
        return make()
    finally:
        sqp.qp_solver_for = budget


def same_bits(a, b) -> bool:
    return all(np.array_equal(x, y, equal_nan=True) for x, y in zip(a, b))


def golden_gaps(cfg) -> dict:
    """Phase 19 (a): each golden scenario's QP assembled on the card and on the CPU,
    solved at each device's budget (and the CPU at the card's), each against the
    float64 solution of the same QP; first-stage GRF gaps in N."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.gradient import GradientMPC, make_rti_solver_split
    from quadruped_pympc_tamols_torch.controllers.gradient.sqp import qp_solver_for
    from quadruped_pympc_tamols_torch.utils.verification import (golden_nominal_scenarios,
                                                                 pdip_solve_np_f64)
    host = GradientMPC(cfg, device="cpu")
    out = {}
    card_iters = qp_solver_for(cfg.mpc.gradient, "cuda")[1]
    for device in ("cuda", "cpu"):
        *_, assemble = make_rti_solver_split(cfg, return_assembler=True, device=device)
        fn, iters = qp_solver_for(cfg.mpc.gradient, device)
        for name in golden_nominal_scenarios(cfg):
            ins = grad_inputs(host, name)
            q = assemble(*(torch.as_tensor(a, device=device)[None] for a in (*ins, ins[4])))
            z64 = pdip_solve_np_f64(*(a[0].cpu().numpy() for a in q))[0][:12]
            for label, it in ((device, iters), (f"{device}@{card_iters}", card_iters)):
                z = fn(*q, iters=it).z[0, :12].cpu().numpy()
                out.setdefault(name, {})[label] = z
            out[name][f"f64 {device}"] = z64
    gaps = {}
    for name, z in out.items():
        g = {"card_gap_N": float(np.abs(z["cuda"] - z["f64 cuda"]).max()),
             "cpu_gap_N": float(np.abs(z["cpu"] - z["f64 cpu"]).max()),
             "cpu_gap_at_card_budget_N": float(np.abs(z[f"cpu@{card_iters}"]
                                                      - z["f64 cpu"]).max()),
             "card_minus_cpu_same_budget_N": float(np.abs(z["cuda"] - z[f"cpu@{card_iters}"])
                                                   .max())}
        g["bound_N"] = max(2 * g["cpu_gap_at_card_budget_N"], GRAD_F64_FLOOR)
        if not g["card_gap_N"] <= g["bound_N"]:
            raise AssertionError(f"phase 19 {name}: card {g['card_gap_N']} N off float64, "
                                 f"bound {g['bound_N']}")
        if not g["card_minus_cpu_same_budget_N"] <= GRAD_F64_FLOOR:
            raise AssertionError(f"phase 19 {name}: card {g['card_minus_cpu_same_budget_N']} N "
                                 f"off the CPU port at the same budget")
        gaps[name] = g
    return gaps


def grad_tick(mpc, name, **kw):
    """One controller tick on a golden scenario: compute_control, its one copy."""
    from quadruped_pympc_tamols_torch.utils.verification import golden_nominal_scenarios
    state, ref, seq = golden_nominal_scenarios(mpc.cfg)[name]
    return lambda: mpc.compute_control(state, ref, seq, **kw)


def phase_gradient_solve() -> dict:
    """Phase 19: the nominal solve on the card (see the module docstring)."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.gradient import BatchedGradientMPC, GradientMPC
    from quadruped_pympc_tamols_torch.gait.periodic import contact_sequence, make_timer_dts
    from quadruped_pympc_tamols_torch.utils.verification import golden_nominal_scenarios

    if torch.backends.cuda.matmul.allow_tf32 or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("phase 19: TF32 is on for float32 matmuls")
    cfg = grad_cfg()
    r = {"golden": golden_gaps(cfg)}
    log(f"phase 19 (a): golden QPs, first-stage GRF gaps to float64 (card at its budget, CPU "
        f"at 14 and at the card's): {json.dumps(r['golden'])}")
    graphed, plain = GradientMPC(cfg, device="cuda"), eager(GradientMPC(cfg, device="cuda"))
    for name in golden_nominal_scenarios(cfg):
        ins = grad_inputs(graphed, name)
        a = graphed.solve(*ins, ins[4])
        if not (same_bits(a, plain.solve(*ins, ins[4])) and same_bits(a, graphed.solve(*ins,
                                                                                      ins[4]))):
            raise AssertionError(f"phase 19 {name}: graph replay, eager run and rerun differ")
        split = graphed.feedback(graphed.prepare(*ins, ins[4]), *ins)
        if not same_bits(a, split):
            raise AssertionError(f"phase 19 {name}: feedback(prepare(x0), x0) != solve(x0)")
    state, ref, seq = golden_nominal_scenarios(cfg)["trot_nominal"]
    mpc = GradientMPC(cfg, device="cuda")
    g0 = mpc.compute_control(state, ref, seq)[0]
    bad = dict(state, position=np.array([np.nan, 0.0, 0.32]))
    grfs, _, _, status, _ = mpc.compute_control(bad, ref, seq)
    if status != 1 or not np.array_equal(grfs, g0):
        raise AssertionError("phase 19: a NaN state did not take the fallback")
    log("phase 19 (b): ok; graph replay bit-equal to the eager function on the card and to a "
        "rerun, feedback(prepare(x0), x0) == solve(x0) bit for bit, a NaN state takes the "
        "fallback (status 1, the previous GRFs)")

    # Host-clock ticks, each with its one copy.
    t = {"solve_tick_graph_ms": median_host_ms(grad_tick(mpc, "trot_nominal"), GRAD_TIMED),
         "solve_tick_eager_ms": median_host_ms(grad_tick(eager(GradientMPC(cfg)),
                                                         "trot_nominal"), GRAD_TIMED)}
    rti = GradientMPC(grad_cfg(**{"mpc.gradient.use_RTI": True}), device="cuda")
    tick = grad_tick(rti, "trot_nominal")
    tick()
    fb = []
    for i in range(GRAD_TIMED + 10):
        rti.compute_rti_prepare()
        torch.cuda.synchronize()  # the plant step the preparation overlaps
        t0 = time.perf_counter()
        tick()
        if i >= 10:
            fb.append((time.perf_counter() - t0) * 1e3)
    t["feedback_tick_ms"] = statistics.median(fb)
    if rti._feedback_dev.replays != GRAD_TIMED + 10:
        raise AssertionError("phase 19: the RTI ticks did not run the feedback phase")
    gcfg = grad_cfg(**{"mpc.optimize_step_freq": True})
    freqs = np.asarray(gcfg.mpc.step_freq_available, np.float32)
    seqs = contact_sequence(np.tile(np.float32([0.1, 0.6, 0.6, 0.1]), (len(freqs), 1)), freqs,
                            gcfg.gait_params.duty_factor, make_timer_dts(gcfg.mpc))
    batched = BatchedGradientMPC(gcfg, device="cuda")
    t["batched_k3_ms"] = median_host_ms(lambda: batched.optimize_gait(state, ref, seqs),
                                        GRAD_TIMED)
    cpu_costs, cpu_best = at_card_budget(lambda: BatchedGradientMPC(gcfg, device="cpu")) \
        .optimize_gait(state, ref, seqs)
    costs, best = batched.optimize_gait(state, ref, seqs)
    if best != cpu_best or not np.allclose(costs, cpu_costs, rtol=1e-3):
        raise AssertionError(f"phase 19: batched costs {costs} / {cpu_costs}")
    r["times"] = t
    log(f"phase 19 (c): host clock, median of {GRAD_TIMED}: {json.dumps(t)}; K = 3 costs "
        f"{costs.tolist()} (CPU at the card's budget {cpu_costs.tolist()}), best {best} Hz on "
        f"both")

    # Device time and launches a tick (torch.profiler), one copy a tick (host count).
    Count = card_ops_counter()
    with Count():
        grad_tick(eager(GradientMPC(cfg)), "trot_nominal")()
    r["eager_ops_per_tick"] = Count.ops
    # One copy a tick: counted on the host, and no more than one recorded a tick.
    for name, call, n in (("graph", grad_tick(mpc, "trot_nominal"), 20),
                          ("eager", grad_tick(eager(GradientMPC(cfg)), "trot_nominal"), 5)):
        r[f"profile_{name}"] = profile_ticks(None, None, n=n, d2h=1, call=call)
    for key in ("profile_graph", "profile_eager"):
        # A graph's device-to-device copies may be recorded as a kernel,
        # "memcpy32_post" (49 a tick): copies, not kernels.
        summarize_profile(r[key])
    log(f"phase 19 (d): {r['eager_ops_per_tick']} torch operations on the card in one eager "
        f"tick; graph ticks {json.dumps(r['profile_graph'])}; eager ticks "
        f"{json.dumps(r['profile_eager'])}")

    # The library's own factorization and solve on a 144 x 144 Newton matrix of a real tick.
    from quadruped_pympc_tamols_torch.controllers.gradient import make_rti_solver_split
    *_, assemble = make_rti_solver_split(cfg, return_assembler=True, device="cuda")
    ins = grad_inputs(mpc, "trot_nominal")
    Hm, g, C, d = assemble(*(torch.as_tensor(a, device="cuda")[None] for a in (*ins, ins[4])))
    K = Hm + C.transpose(-1, -2) @ C
    L, _ = torch.linalg.cholesky_ex(K)
    b = g[..., None]
    r["cholesky_ex_ms"] = time_cuda(lambda: torch.linalg.cholesky_ex(K))
    r["cholesky_solve_ms"] = time_cuda(lambda: torch.cholesky_solve(b, L))
    r["two_solve_triangular_ms"] = time_cuda(lambda: torch.linalg.solve_triangular(
        L.transpose(-1, -2), torch.linalg.solve_triangular(L, b, upper=False), upper=True))
    log(f"phase 19 (e): torch.linalg.cholesky_ex {r['cholesky_ex_ms']:.4f} ms, "
        f"torch.cholesky_solve {r['cholesky_solve_ms']:.4f} ms, two "
        f"torch.linalg.solve_triangular {r['two_solve_triangular_ms']:.4f} ms a call on the "
        f"144 x 144 Newton matrix (CUDA events, median of {TIMED_RUNS})")
    return r


def phase_gradient_ladder() -> dict:
    """Phase 20: 20 real ticks of the port's SRB harness on the card (nominal blind,
    0.3 m/s), each tick's QP against float64 at the card's budget (held to the
    JAX test's bound) and at LADDER_BUDGETS."""
    from quadruped_pympc_tamols_torch.utils.verification import (capture_tick_qps,
                                                                 qp_ladder_report)
    cfg = grad_cfg(**{"sim.visual_foothold_adaptation": "blind"})
    ticks = capture_tick_qps(cfg, n_ticks=20, device="cuda")
    r = qp_ladder_report(cfg, ticks=ticks, device="cuda")
    r["budgets"] = {it: qp_ladder_report(cfg, ticks=ticks, device="cuda", iters=it)
                    for it in LADDER_BUDGETS}
    if not (r["n_ticks"] == 20 and r["f64_mu_max"] < 1e-10
            and r["qp_gap_vs_f64_max_N"] < LADDER_MAX_N and r["qp_gap_vs_f64_rel"] < LADDER_REL):
        raise AssertionError(f"phase 20: ladder {r}")
    log(f"phase 20: ok; 20 real ticks at {r['qp_iters']} iterations: first-stage GRF gap to "
        f"float64 max {r['qp_gap_vs_f64_max_N']:.4f} N, mean {r['qp_gap_vs_f64_mean_N']:.4f} "
        f"N, {r['qp_gap_vs_f64_rel']:.2e} of the weight (bound {LADDER_MAX_N} N, "
        f"{LADDER_REL}); by budget (max N): "
        f"{({k: round(v['qp_gap_vs_f64_max_N'], 4) for k, v in r['budgets'].items()})}")
    return r


def gradient_walk(label, cfg, terrain=None) -> dict:
    """Phase 21: the SRB harness on the card for WALK_S at WALK_VEL (sensing as
    phase 17 over ``terrain``); raises unless it walks the band with no sampling
    kernel launched and every solve a graph replay."""
    import torch
    from quadruped_pympc_tamols_torch.planner import heightmap_from_fn
    from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness

    h = SRBClosedLoopHarness(cfg, seed=0, terrain_fn=terrain, device="cuda")
    mpc = h.ctrl.controller
    if cfg.mpc.gradient.use_RTI:
        # The RTI split as the wrapper runs it: the preparation dispatched after
        # each solve (the harness, like the JAX one, only solves).
        solve = h.ctrl.compute_control

        def compute_control(*a, **kw):
            out = solve(*a, **kw)
            h.ctrl.compute_rti()
            return out
        h.ctrl.compute_control = compute_control
    calls = [0]
    if h.wb.vfa is not None:
        fn = h.wb.vfa.compute_adaptation

        def counted(*a, **kw):
            calls[0] += 1
            return fn(*a, **kw)
        h.wb.vfa.compute_adaptation = counted
    tp, n = cfg.tamols, int(round(WALK_S / cfg.sim.dt))
    hist = np.zeros((n, 12))
    reset_counts()
    t0 = time.perf_counter()
    for i in range(n):
        hms = None
        if terrain is not None and not h.wb.vfa.initialized:
            ref = np.asarray(h.wb.frg.last_reference_footholds.data)
            hms = heightmap_from_fn(terrain, ref[:, :2], np.full(4, h.x[8]),
                                    tp.heightmap_resolution, tp.heightmap_rows,
                                    tp.heightmap_cols, device="cuda")
        hist[i] = h.step(WALK_VEL, heightmaps=hms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks = n // h._mpc_every
    dist, min_z, tilt, dz = walk_band(label, cfg, hist)
    check_counts(label, read_counts(), counts_of(), ticks)
    replays = {k: getattr(mpc, f"_{k}_dev").replays for k in ("solve", "prepare", "feedback")}
    rti = cfg.mpc.gradient.use_RTI
    want = {"solve": 1, "prepare": ticks, "feedback": ticks - 1} if rti else \
        {"solve": ticks, "prepare": 0, "feedback": 0}
    if replays != want:
        raise AssertionError(f"{label}: graph replays {replays}, want {want}")
    r = {"walked_m": dist, "min_z_m": min_z, "max_tilt_rad": tilt, "mean_z_minus_ref_m": dz,
         "apex_calls": calls[0], "graph_replays": replays, "ticks": ticks,
         "harness_s_per_sim_s": wall / WALK_S}
    log(f"{label}: ok; walked {dist:.4f} m, min z {min_z:.4f} m, max |roll|,|pitch| "
        f"{tilt:.4f} rad, mean z - ref_z {dz:+.4f} m, {calls[0]} apex calls; graph replays "
        f"{replays} for {ticks} ticks, no sampling kernel; harness {wall / WALK_S:.3f} s wall "
        f"per simulated s; JAX package on the CPU: "
        f"{JAX_CPU_GRADIENT_WALKS[label.rsplit(' ', 1)[1]]}")
    return r


def gait_search(device) -> dict:
    """Phase 21: the SRB harness with mpc.optimize_step_freq and the nominal MPC on
    ``device`` (at the card's QP budget) for GAIT_STEPS; at each touch-down window
    (optimize_swing) one SRBDBatchedControllerInterface.optimize_gait over the K
    candidates, whose frequency the harness hands to the gait. Returns the (step, Hz) chosen and, on
    the card, the batched graph's replays."""
    from quadruped_pympc_tamols_torch.interfaces.controller_interface import (
        SRBDBatchedControllerInterface)
    from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness

    cfg = grad_cfg(**{"sim.visual_foothold_adaptation": "blind", "mpc.optimize_step_freq": True})
    h, batched = at_card_budget(lambda: (SRBClosedLoopHarness(cfg, seed=0, device=device),
                                         SRBDBatchedControllerInterface(cfg, device=device)))
    update, chosen = h.wb.update_state_and_reference, []

    def searched(*a, **kw):
        out = update(*a, **kw)
        if out[4]:
            best = batched.optimize_gait(out[0], out[1], h.wb.pgg.phase_signal,
                                         h.wb.pgg.duty_factor)
            h.ctrl.best_sample_freq = h.best_freq = best
            chosen.append((h._step, float(best)))
        return out

    h.wb.update_state_and_reference = searched
    for _ in range(GAIT_STEPS):
        h.step(WALK_VEL)
    return {"chosen": chosen, "batched_replays": batched.controller.inner._solve_dev.replays,
            "final_step_freq": float(h.wb.pgg.step_freq)}


def nominal_replay(cfg, counted=False, label="phase 21 wrapper", joints=False) -> dict:
    """The recorded MuJoCo observations through QuadrupedPyMPCWrapper with the
    gradient MPC of ``cfg`` on the card: finite torques, the host clock of each
    step, (``counted``) one copy an MPC tick and one an apex call, nothing on the
    card on any other step, and (``joints``) the kinodynamic OCP's first-stage
    joint positions as the whole-body layer's joint targets on every step."""
    import torch
    from quadruped_pympc_tamols_torch.interfaces import QuadrupedPyMPCWrapper
    from quadruped_pympc_tamols_torch.sim.trace import ControlTrace
    from quadruped_pympc_tamols_torch.utils.legs import Legs

    trace = ControlTrace()
    w = QuadrupedPyMPCWrapper(cfg, Legs(trace.arrays["feet_pos"][0].copy()), device="cuda")
    mpc_ms, other_ms, copies, apex = [], [], 0, [0]
    Count = card_ops_counter()
    wb = w.wb_interface
    fn = wb.vfa.compute_adaptation

    def counted_apex(*a, **kw):
        apex[0] += 1
        return fn(*a, **kw)

    wb.vfa.compute_adaptation = counted_apex
    inputs = [trace.inputs(i, device="cuda") for i in range(trace.steps)]
    for i, kw in enumerate(inputs):
        mpc = i % w._mpc_every == 0
        apex_before = apex[0]
        Count.ops = Count.copies = 0
        t0 = time.perf_counter()
        if counted:
            with Count():
                tau = w.compute_actions(**kw)
        else:
            tau = w.compute_actions(**kw)
        (mpc_ms if mpc else other_ms).append((time.perf_counter() - t0) * 1e3)
        if not np.all(np.isfinite(tau.data)):
            raise AssertionError(f"{label} step {i}: torques not finite")
        want = int(mpc) + apex[0] - apex_before
        if counted and (Count.copies != want or (want == 0 and Count.ops)):
            raise AssertionError(f"{label} step {i}: {Count.copies} copies and "
                                 f"{Count.ops} card operations, want {want} copies")
        if joints:
            q_now = np.asarray(kw["qpos_js"].data).reshape(4, 3)
            plan = np.asarray(w.srbd_controller_interface.nmpc_joints_pos)[0].reshape(4, 3)
            if not np.allclose(np.asarray(w.des_joints_pos.data).reshape(4, 3),
                               q_now + np.clip(plan - q_now, -3.0, 3.0), rtol=0, atol=1e-6):
                raise AssertionError(f"{label} step {i}: joint targets are not the OCP's")
        copies += Count.copies
    torch.cuda.synchronize()
    replays = w.srbd_controller_interface.controller._solve_dev.replays
    if replays != trace.steps // w._mpc_every:
        raise AssertionError(f"{label}: {replays} graph replays")
    med = statistics.median

    def p99(xs):
        return float(np.percentile(xs, 99))

    return {"steps": trace.steps, "solve_replays": replays, "d2h_copies": copies,
            "apex_calls": apex[0],
            "compute_actions_ms_mpc_median": med(mpc_ms),
            "compute_actions_ms_mpc_p99": p99(mpc_ms),
            "compute_actions_ms_other_median": med(other_ms),
            "compute_actions_ms_other_p99": p99(other_ms)}


def phase_gradient_walks() -> dict:
    """Phase 21: the walks, the batched gait interface and the wrapper."""
    from quadruped_pympc_tamols_torch.interop import config_from_dict
    from quadruped_pympc_tamols_torch.sim.trace import ControlTrace

    blind = {"sim.visual_foothold_adaptation": "blind"}
    r = {"walks": {
        "blind": gradient_walk("phase 21 blind", grad_cfg(**blind)),
        "rti": gradient_walk("phase 21 rti", grad_cfg(**blind, **{"mpc.gradient.use_RTI": True})),
        "tamols_step": gradient_walk("phase 21 tamols_step", grad_cfg(), step_up)}}
    card, cpu = gait_search("cuda"), gait_search("cpu")
    if not card["chosen"] or card["batched_replays"] != len(card["chosen"]) \
            or [c[0] for c in card["chosen"]] != [c[0] for c in cpu["chosen"]]:
        raise AssertionError(f"phase 21 gait: searches {card} / {cpu}")
    r["gait"] = {"card": card, "cpu": cpu, "same_frequencies": card["chosen"] == cpu["chosen"]}
    log(f"phase 21 gait: ok; {GAIT_STEPS} steps with mpc.optimize_step_freq: one batched K = 3 "
        f"graph replay in each of {len(card['chosen'])} touch-down windows; (step, Hz) on the "
        f"card {card['chosen']}, on the CPU {cpu['chosen']}")
    recorded = config_from_dict(ControlTrace().config)
    ncfg = dataclasses.replace(recorded, mpc=dataclasses.replace(recorded.mpc, type="nominal"))
    counted = nominal_replay(ncfg, counted=True)
    timed = nominal_replay(ncfg)
    r["wrapper"] = {**timed, "d2h_copies": counted["d2h_copies"],
                    "apex_calls": counted["apex_calls"]}
    log(f"phase 21 wrapper: ok; {timed['steps']} recorded steps through QuadrupedPyMPCWrapper "
        f"with the nominal MPC on the card: finite torques, {timed['solve_replays']} graph "
        f"replays, {counted['d2h_copies']} device-to-host copies ({counted['apex_calls']} apex "
        f"calls), nothing on the card on the other steps; compute_actions MPC ticks median "
        f"{timed['compute_actions_ms_mpc_median']:.4f} ms, p99 "
        f"{timed['compute_actions_ms_mpc_p99']:.4f}; other ticks median "
        f"{timed['compute_actions_ms_other_median']:.4f} ms, p99 "
        f"{timed['compute_actions_ms_other_p99']:.4f}")
    return r


# -- phases 22-24: the gradient variant core and the DDP solver on the card ------------
# (mpc_type, gait, overrides) of the variant rows: the walk table of PERF.md
# (tests/test_torch_variants_loop.py WALKS) but ddp, with the foothold boxes and
# the crawl's ZMP rows beside them in phase 22.
VARIANT_ROWS = {
    "input_rates": ("input_rates", "trot", {}),
    "lyapunov": ("lyapunov", "trot", {}),
    "collaborative": ("collaborative", "trot", {}),
    "zmp": ("nominal", "trot", {"mpc.gradient.use_zmp_stability": True}),
    "foothold": ("nominal", "trot", {"mpc.gradient.use_foothold_optimization": True}),
    "static_crawl": ("nominal", "crawl", {"mpc.gradient.use_static_stability": True}),
    "kinodynamic": ("kinodynamic", "trot", {}),
    "foothold_constraints": ("nominal", "trot", {"mpc.gradient.use_foothold_optimization": True,
                                                 "mpc.gradient.use_foothold_constraints": True}),
    "zmp_crawl": ("nominal", "crawl", {"mpc.gradient.use_zmp_stability": True}),
}
# Rows walked in phase 24 (kinodynamic runs the recorded MuJoCo loop instead: the
# SRB harness feeds zero joint angles, and the JAX package's kinodynamic walk
# diverges there) and whether the JAX package's row walks the band.
VARIANT_WALKS = {"input_rates": True, "lyapunov": True, "collaborative": True, "zmp": True,
                 "foothold": True, "ddp": True, "static_crawl": False}
# The JAX package's variant walks on the CPU (3 s at 0.3 m/s, blind): walked m, min
# z m, max |roll|,|pitch| rad, mean z of the second half m;
# `python tests/test_torch_variants_loop.py`.
JAX_CPU_VARIANT_WALKS = {"input_rates": (0.7821, 0.3308, 0.0313, 0.3343),
                         "lyapunov": (0.5959, 0.3485, 0.0210, 0.3505),
                         "collaborative": (1.2680, 0.3430, 0.0528, 0.3465),
                         "zmp": (0.8930, 0.3488, 0.0078, 0.3493),
                         "foothold": (0.9034, 0.3485, 0.0086, 0.3491),
                         "ddp": (0.8914, 0.3473, 0.0082, 0.3481),
                         "static_crawl": (0.3218, 0.3417, 0.1730, 0.3473)}
VARIANT_ENSEMBLE = 1  # seeded perturbations of each QP in phase 22 (b)
VARIANT_PERTURB = 3e-7  # relative, on the Hessian: the card's and the CPU's assembly differ so
RICCATI_SHAPES = ((16, 4, 2), (12, 12, 12), (64, 6, 3))  # tests/test_parallel_riccati.py:31-41
LEGS4 = ("FL", "FR", "RL", "RR")


def variant_cfg(row, **extra):
    from quadruped_pympc_tamols_torch import make_config
    if row == "ddp":
        return grad_cfg(**{"mpc.gradient.use_DDP": True}, **extra)
    mpc_type, gait, over = VARIANT_ROWS[row]
    return make_config("aliengo", mpc_type=mpc_type, gait=gait, **over, **extra)


def variant_of(cfg) -> str:
    return "nominal" if cfg.mpc.type == "nominal" else cfg.mpc.type


def variant_tick(cfg):
    """The golden trot tick (a crawl's: the three-stance one, where its rows are
    active) with joint angles from the IK of its feet: (state, reference, seq)."""
    from quadruped_pympc_tamols_torch.kinematics.leg_ik import LegKinematics
    from quadruped_pympc_tamols_torch.utils.frames import euler_xyz_to_rot_np
    from quadruped_pympc_tamols_torch.utils.verification import golden_nominal_scenarios
    name = "three_stance_nominal" if cfg.sim.gait == "crawl" else "trot_nominal"
    state, ref, seq = golden_nominal_scenarios(cfg)[name]
    state = dict(state)
    feet = np.stack([state[f"foot_{leg}"] for leg in LEGS4])
    q0 = LegKinematics(cfg.robot).ik_world(feet, state["position"],
                                           euler_xyz_to_rot_np(state["orientation"]))
    for i, leg in enumerate(LEGS4):
        state[f"joint_{leg}"] = q0[i]
    return state, ref, seq


def solve_inputs(mpc, tick):
    """The host inputs compute_control hands ``mpc.solve`` on ``tick``."""
    fn, got = mpc.solve, []

    def solve(*a):
        got.append([np.array(x, np.float32) for x in a])
        return fn(*a)
    mpc.solve = solve
    mpc.compute_control(*tick)
    mpc.solve = fn
    return got[0]


def variant_qp_gaps(cfg, q, S, iters) -> tuple:
    """First-stage force-input gaps to float64 of the variant solve (hard or soft,
    as the variant core solves it) at ``iters`` on the card and on the CPU, for q
    and VARIANT_ENSEMBLE seeded perturbations of its Hessian: (card, CPU)."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.gradient.qp import soft_qp_solve
    from quadruped_pympc_tamols_torch.controllers.gradient.variants import variant_qp_solver
    from quadruped_pympc_tamols_torch.utils.verification import (pdip_solve_np_f64,
                                                                 soft_qp_augment_np)
    gp = cfg.mpc.gradient
    fn, _ = variant_qp_solver(gp, "cuda")
    q = [np.asarray(a, np.float32) for a in q]
    n = q[1].shape[0]
    nu = n // cfg.mpc.horizon
    forces = slice(nu - 12, nu)
    rng = np.random.default_rng(22)
    qps = [q]
    for _ in range(VARIANT_ENSEMBLE):
        E = rng.normal(0, VARIANT_PERTURB, q[0].shape)
        qps.append([(q[0] * (1 + (E + E.T) / 2)).astype(np.float32)] + q[1:])
    gaps = []
    for qq in qps:
        z64 = pdip_solve_np_f64(*(qq if S is None else soft_qp_augment_np(
            *qq, S, gp.slack_l1, gp.slack_l2)))[0]
        row = []
        for device in ("cuda", "cpu"):
            t = [torch.as_tensor(a, device=device)[None] for a in qq]
            if S is None:
                z = fn(*t, iters=iters).z[0]
            else:
                z = soft_qp_solve(*t, torch.as_tensor(S, device=device), zl=gp.slack_l1,
                                  Zl=gp.slack_l2, solver=fn, iters=iters).z[0]
            row.append(float(np.abs(z.cpu().numpy()[forces] - z64[forces]).max()))
        gaps.append(row)
    gaps = np.asarray(gaps)
    return gaps[:, 0], gaps[:, 1]


def summarize_profile(p) -> dict:
    """Kernels and device microseconds a tick from a profile_ticks result (a
    graph's device-to-device copies may be recorded as kernels: not counted)."""
    if "launches" in p:
        p["kernels_per_tick"] = sum(v for k, v in p["launches"].items()
                                    if "memcpy" not in k.lower()
                                    and "memset" not in k.lower()) / p["ticks"]
        p["device_us_per_tick"] = sum(p["device_us_per_launch"][k] * v
                                      for k, v in p["launches"].items()) / p["ticks"]
        p.pop("device_us_per_launch")
        p.pop("launches")
    return p


def phase_variant_solves() -> dict:
    """Phase 22: each variant row's solve on the card (see the module docstring)."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.gradient import VariantGradientMPC
    from quadruped_pympc_tamols_torch.controllers.gradient.variants import (
        make_variant_solver, variant_qp_solver)

    out = {}
    for row in VARIANT_ROWS:
        label = f"phase 22 {row}"
        t_row = time.perf_counter()
        cfg = variant_cfg(row)
        tick = variant_tick(cfg)
        reset_counts()
        host = VariantGradientMPC(cfg, variant_of(cfg), device="cpu")
        ins = solve_inputs(host, tick)
        # (a) the QP assembled on the card and on the CPU from the same inputs.
        _, _, asm_cpu, S = make_variant_solver(cfg, host.spec, return_assembler=True,
                                               device="cpu")
        graphed = VariantGradientMPC(cfg, variant_of(cfg), device="cuda")
        _, _, asm_card, _ = make_variant_solver(cfg, graphed.spec, return_assembler=True,
                                                device="cuda")
        q_cpu = [a.numpy() for a in asm_cpu(*(torch.from_numpy(a) for a in ins))]
        q_card = [a.cpu().numpy() for a in asm_card(*(torch.from_numpy(a).cuda() for a in ins))]
        rel = {part: float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
               for part, a, b in zip(("Hm", "g", "Cb", "d"), q_card, q_cpu)}
        if max(rel.values()) > 1e-4:
            raise AssertionError(f"{label} (a): card's QP off the CPU port's: {rel}")
        # (b) first-stage forces against float64, on the card's QP and perturbed
        # copies: the card and the CPU port, both at the card's budget.
        card_iters = variant_qp_solver(cfg.mpc.gradient, "cuda")[1]
        card_gaps, cpu_gaps = variant_qp_gaps(cfg, q_card, S, card_iters)
        # Held on the tick's own QP, as phase 19 holds the golden QPs; the
        # perturbed copies show the spread of a chaotic iterate (kinodynamic:
        # 0.004-0.10 N on the card, 0.003-0.03 on the CPU) and are not held.
        if not card_gaps[0] <= max(2 * cpu_gaps[0], GRAD_F64_FLOOR):
            raise AssertionError(f"{label} (b): card {card_gaps[0]} off float64, CPU port at "
                                 f"the card's budget {cpu_gaps[0]}")
        # (c) graph replay bit-equal to the eager function and to a rerun; the fallback.
        plain = VariantGradientMPC(cfg, variant_of(cfg), device="cuda")
        plain._solve_dev = plain._solve_dev.fn
        a, b, c = graphed.solve(*ins), plain.solve(*ins), graphed.solve(*ins)
        if not (same_bits(a, b) and same_bits(a, c)):
            raise AssertionError(f"{label} (c): graph replay, eager run and rerun differ")
        g0 = graphed.compute_control(*tick)[0]
        bad = dict(tick[0], position=np.array([np.nan, 0.0, 0.32]))
        grfs, _, _, status, _ = graphed.compute_control(bad, *tick[1:])
        if status != 1 or not np.array_equal(grfs, g0):
            raise AssertionError(f"{label} (c): a NaN state did not take the fallback")
        # (d) the host clock of the solve tick, its device time and kernels.
        mpc = VariantGradientMPC(cfg, variant_of(cfg), device="cuda")

        def call(mpc=mpc):
            mpc.compute_control(*tick)
        ms = median_host_ms(call, GRAD_TIMED)
        prof = summarize_profile(profile_ticks(None, None, n=20, d2h=1, call=call))
        check_counts(label, read_counts(), counts_of(), 1)
        out[row] = {"n_variables": host.dims.nU, "qp_rows": q_cpu[3].shape[0],
                    "soft_slacks": 0 if S is None else S.shape[1], "card_vs_cpu_qp_rel": rel,
                    "card_gap_N": card_gaps.tolist(), "cpu_gap_at_card_budget_N":
                    cpu_gaps.tolist(), "qp_iters": card_iters, "solve_tick_ms": ms,
                    "graph_captures": mpc._solve_dev.captures, "profile": prof,
                    "phase_s": time.perf_counter() - t_row}
        unit = "N/s (GRF rates)" if row == "input_rates" else "N"
        log(f"{label}: ok; {host.dims.nU} variables, {q_cpu[3].shape[0]} rows, "
            f"{out[row]['soft_slacks']} slacks; QP card/CPU rel {max(rel.values()):.2e}; "
            f"first-stage force gap to float64 card {card_gaps[0]:.4f} {unit} (CPU port at "
            f"{card_iters} iterations {cpu_gaps[0]:.4f}; on {VARIANT_ENSEMBLE} perturbed "
            f"copies card {np.round(card_gaps[1:], 4).tolist()}, CPU "
            f"{np.round(cpu_gaps[1:], 4).tolist()}); graph == eager == rerun; "
            f"NaN fallback; solve tick {ms:.4f} ms (median of {GRAD_TIMED}); "
            f"{json.dumps(prof)}; {out[row]['phase_s']:.1f} s")
    return out


def random_ltv(H, n, m, seed):
    """The random LTV problem of tests/test_parallel_riccati.py:13-28."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(H, n, n)) * 0.3 + np.eye(n)
    c = rng.normal(size=(H, n)) * 0.1
    G = rng.normal(size=(H, n, m))
    Q = np.stack([A @ A.T * 0.1 + 0.5 * np.eye(n) for A in rng.normal(size=(H, n, n))])
    q = rng.normal(size=(H, n))
    R = np.tile(np.eye(m), (H, 1, 1))
    A = rng.normal(size=(n, n))
    return [np.asarray(a, np.float32) for a in (F, c, G, Q, q, R, A @ A.T * 0.1 + np.eye(n),
                                                rng.normal(size=n))]


def phase_ddp() -> dict:
    """Phase 23: the Riccati passes and the DDP solve on the card."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.gradient import GradientMPC, parallel_riccati

    r = {"riccati": {}}
    for seed, (H, n, m) in enumerate(RICCATI_SHAPES):
        args = random_ltv(H, n, m, seed)
        runs = {(dev, kind): [x.cpu().numpy() for x in getattr(
                    parallel_riccati, f"lqr_backward_{kind}")(
                    *(torch.from_numpy(a).to(dev) for a in args))]
                for dev in ("cuda", "cpu") for kind in ("sequential", "associative")}
        err = {}
        for a, b in ((("cuda", "associative"), ("cuda", "sequential")),
                     (("cuda", "sequential"), ("cpu", "sequential")),
                     (("cuda", "associative"), ("cpu", "associative"))):
            for x, y in zip(runs[a], runs[b]):
                if not np.allclose(x, y, atol=2e-3, rtol=1e-3):
                    raise AssertionError(f"phase 23 {(H, n, m)}: {a} against {b}")
            err[f"{a[0]} {a[1]} - {b[0]} {b[1]}"] = max(float(np.abs(x - y).max())
                                                         for x, y in zip(runs[a], runs[b]))
        r["riccati"]["x".join(map(str, (H, n, m)))] = err
    log(f"phase 23 Riccati: ok; max abs differences {json.dumps(r['riccati'])} (atol 2e-3, "
        f"rtol 1e-3)")
    for label, over in (("H12", {}), ("H24", {"mpc.horizon": 24, "mpc.horizon_fine_grained": 2})):
        cfg = variant_cfg("ddp", **over)
        # riccati_backward "auto": the associative pass from H = 24 (ddp.py).
        mode = "associative" if cfg.mpc.horizon >= 24 else "sequential"
        graphed, plain = GradientMPC(cfg, device="cuda"), eager(GradientMPC(cfg, device="cuda"))
        for name in ("trot_nominal", "push_nominal") if label == "H12" else ("trot_nominal",):
            ins = grad_inputs(graphed, name)
            a = graphed.solve(*ins, ins[4])
            if not (same_bits(a, plain.solve(*ins, ins[4]))
                    and same_bits(a, graphed.solve(*ins, ins[4]))):
                raise AssertionError(f"phase 23 {label} {name}: graph replay, eager run and "
                                     f"rerun differ")
        reset_counts()
        call = grad_tick(GradientMPC(cfg, device="cuda"), "trot_nominal")
        ms = median_host_ms(call, GRAD_TIMED)
        prof = summarize_profile(profile_ticks(None, None, n=20, d2h=1, call=call))
        check_counts(f"phase 23 {label}", read_counts(), counts_of(), 1)
        r[label] = {"riccati_backward": mode, "solve_tick_ms": ms, "profile": prof}
        log(f"phase 23 DDP {label} (riccati_backward auto: {mode}, {cfg.mpc.horizon} stages): "
            f"ok; graph == eager == rerun on golden ticks; solve tick {ms:.4f} ms (median of "
            f"{GRAD_TIMED}); {json.dumps(prof)}")
    return r


def variant_walk(row) -> dict:
    """Phase 24: the SRB harness on the card, WALK_S at WALK_VEL, blind; raises
    unless the row walks the band (where the JAX package's walks) or stays upright
    and at height (static_crawl), with no sampling kernel launched and every
    solve a graph replay."""
    import torch
    from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness

    label = f"phase 24 {row}"
    cfg = variant_cfg(row, **{"sim.visual_foothold_adaptation": "blind"})
    h = SRBClosedLoopHarness(cfg, seed=0, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    hist = h.run(WALK_S, WALK_VEL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ticks = int(round(WALK_S / cfg.sim.dt)) // h._mpc_every
    check_counts(label, read_counts(), counts_of(), ticks)
    replays = h.ctrl.controller._solve_dev.replays
    if replays != ticks:
        raise AssertionError(f"{label}: {replays} graph replays for {ticks} ticks")
    z = hist[:, 2]
    dist, tilt = float(hist[-1, 0] - hist[0, 0]), float(np.abs(hist[:, 6:8]).max())
    dz = float(np.mean(z[len(z) // 2:]) - cfg.sim.ref_z)
    if VARIANT_WALKS[row]:
        walk_band(label, cfg, hist)
    elif not (np.all(np.isfinite(hist)) and z.min() > 0.15 and tilt < 0.5 and abs(dz) < 0.08):
        raise AssertionError(f"{label}: not upright at height (min z {z.min()}, tilt {tilt}, "
                             f"mean z - ref_z {dz})")
    r = {"walked_m": dist, "min_z_m": float(z.min()), "max_tilt_rad": tilt,
         "mean_z_second_half_m": float(np.mean(z[len(z) // 2:])), "ticks": ticks,
         "graph_replays": replays, "harness_s_per_sim_s": wall / WALK_S}
    log(f"{label}: ok; walked {dist:.4f} m, min z {z.min():.4f} m, max |roll|,|pitch| "
        f"{tilt:.4f} rad, mean z of the second half {r['mean_z_second_half_m']:.4f} m; {replays} "
        f"graph replays, no sampling kernel; harness {wall / WALK_S:.3f} s wall per simulated "
        f"s; JAX package on the CPU: {JAX_CPU_VARIANT_WALKS.get(row)}")
    return r


def phase_variant_walks() -> dict:
    """Phase 24: the variant walks and the kinodynamic wrapper on the recorded loop."""
    from quadruped_pympc_tamols_torch.interop import config_from_dict
    from quadruped_pympc_tamols_torch.sim.trace import ControlTrace

    r = {"walks": {row: variant_walk(row) for row in VARIANT_WALKS}}
    recorded = config_from_dict(ControlTrace().config)
    kcfg = dataclasses.replace(recorded, mpc=dataclasses.replace(recorded.mpc, type="kinodynamic"))
    reset_counts()
    counted = nominal_replay(kcfg, counted=True, label="phase 24 kinodynamic wrapper",
                             joints=True)
    timed = nominal_replay(kcfg, label="phase 24 kinodynamic wrapper")
    check_counts("phase 24 kinodynamic wrapper", read_counts(), counts_of(), 1)
    r["kinodynamic_wrapper"] = {**timed, "d2h_copies": counted["d2h_copies"],
                                "apex_calls": counted["apex_calls"]}
    log(f"phase 24 kinodynamic wrapper: ok; {timed['steps']} recorded steps through "
        f"QuadrupedPyMPCWrapper with the kinodynamic MPC on the card: finite torques, the "
        f"OCP's joint trajectories the whole-body layer's joint targets on every step, "
        f"{timed['solve_replays']} graph replays, {counted['d2h_copies']} device-to-host "
        f"copies ({counted['apex_calls']} apex calls); compute_actions MPC ticks median "
        f"{timed['compute_actions_ms_mpc_median']:.4f} ms, p99 "
        f"{timed['compute_actions_ms_mpc_p99']:.4f}; other ticks median "
        f"{timed['compute_actions_ms_other_median']:.4f} ms")
    return r


# -- phases 25-27: the scenario fleet on K1f ------------------------------------------

FLEET_S = 64  # scenarios of the fleet's walks and checks
FLEET_VEL, FLEET_SECONDS = 0.25, 3.0  # tests/test_parallel.py's command, 3 s
FLEET_Z_MIN = 0.1  # every scenario stays above it (tests/test_parallel.py:93)
# K1f against its plain version, in both layouts: (S, N) at production width, the
# JAX bench's fleet shape (bench.py:358-395: 64 scenarios of 128 samples) and its
# largest S, and ragged S and N.
FLEET_CHECKS = ((FLEET_S, N_MAIN), (1024, 128), (FLEET_S, 128), (3, 63), (2, 65))
# K1f's times in each layout (phase 25), and the shapes of the crossover sweep:
# one iteration's device time in each layout from one wave of the four-lane
# rollout to production width.
FLEET_TIMES = ((FLEET_S, 128), (1024, 128), (FLEET_S, N_MAIN))
FLEET_SWEEP = ((64, 128), (128, 128), (192, 128), (256, 128), (384, 128), (512, 128),
               (64, 1000), (1024, 128), (64, 2500), (64, N_MAIN))
# (S, N), perlin, reflexes; 256 x 10 000 is ROADMAP queue 1 item 5's density step.
FLEET_THROUGHPUT = ((64, 128), (256, 128), (1024, 128), (64, N_MAIN), (256, N_MAIN))
FLEET_TIMED_TICKS = 50
FLEET_PASSES = {k: v for k, v in PASSES.items() if k.startswith("fleet_")}
# The JAX package's perlin fleet with reflexes on the CPU, 8 scenarios, 3 s at 0.25
# m/s, N = 10 000 (`python tests/test_torch_fleet.py 8 3.0 10000`): min z (m), mean
# forward distance (m), reflex firings. The port walks other heightfields (its own
# draws) and 64 scenarios, so its mean distance is held to a band around this row.
JAX_CPU_FLEET_WALK = {"min_z": 0.3432, "mean_dx": 0.7383, "reflex_triggers": 96.0}
FLEET_DX_BAND = 0.25  # relative: other heightfields and noise than the JAX row's


def fleet_cfg(method="random_sampling"):
    from quadruped_pympc_tamols_torch import make_config
    return make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})


def fleet_inputs(cfg, S, N, dev, rng, rest=False):
    """(plan, tick, incumbents, sigmas, seeds, offsets) of S distinct scenarios on
    the card: trot sequences at random phases, perturbed states and feet; with
    ``rest`` the base at rest under a reference at rest (the long pairs)."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk

    plan = sk.make_rs_plan(cfg, N, dev)
    H, P = plan.horizon, plan.num_parameters
    st = np.zeros((S, 12), np.float32)
    st[:, 2] = cfg.sim.ref_z - 0.03 + 0.01 * rng.standard_normal(S)
    st[:, 3] = 0.0 if rest else 0.2 * rng.standard_normal(S)
    feet = NOMINAL_FEET + 0.01 * rng.standard_normal((S, 4, 3))
    ref = np.zeros((S, 12), np.float32)
    ref[:, 2], ref[:, 3] = cfg.sim.ref_z, 0.0 if rest else 0.3
    ph = rng.random((S, 1)) + np.array([0.0, 0.5, 0.5, 0.0])
    contact = np.mod(ph[:, :, None] + 1.4 * 0.02 * np.arange(H), 1.0) < 0.6
    n = contact.sum(1)
    share = np.broadcast_to((cfg.robot.mass * 9.81 / np.maximum(n, 1))[:, :, None], (S, H, 4))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    tick = fl.FleetTick(t(st), t(feet), t(ref), t(contact), t(share))
    return (plan, tick, t(0.5 * rng.standard_normal((S, P))), t(0.5 + rng.random((S, P))),
            torch.arange(S, dtype=torch.int64, device=dev) + 11,
            torch.arange(S, dtype=torch.int64, device=dev) * 3)


def fleet_noise(plan, knobs, S, rng, dev):
    """(S, P, N) numpy noise of the method's distribution, column 0 zero."""
    import torch
    if knobs.method == "random_sampling":
        z = np.stack([numpy_noise(plan, rng) for _ in range(S)])
    else:
        z = rng.standard_normal((S, plan.num_parameters, plan.num_samples)).astype(np.float32)
        z *= 1.0 if knobs.cem else knobs.sigma_mppi
        z[:, :, 0] = 0.0
    return torch.as_tensor(z, device=dev)


def fleet_check(plan, knobs, tick, inc, sigma, noise, res, label) -> dict:
    """K1f's result res = (costs, out, sigma', elites) against its plain version
    on the same noise: the costs against the plain rollout (COST_RTOL, COST_ATOL);
    the optimizer step and the extraction against the plain step on the kernel's
    own costs: the argmin index and beta exactly, the winner (PARAM_ATOL) or the
    softmax parameters and sigma' (COMBINE_ATOL), the elites exactly, GRFs
    (GRF_ATOL) and states (STATE_ATOL). Returns the largest errors."""
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops.cost_checks import DRIFT_H, f64
    costs_k, out_k, sigma_k, elites_k = res
    plain = fl.fleet_iteration_reference(plan, knobs, tick, inc, sigma, noise)
    errs = {"cost": check_costs(costs_k, plain.costs, label, plan.horizon,
                                fl.fleet_iteration_reference(f64(plan), knobs, f64(tick),
                                                             inc.double(), f64(sigma),
                                                             noise.double()).costs
                                if plan.horizon > DRIFT_H else None)}
    ref = fl.fleet_iteration_reference(plan, knobs, tick, inc, sigma, noise, costs=costs_k)
    if not (bool((out_k[:, 0] == ref.out[:, 0]).all())
            and bool((out_k[:, 25] == ref.out[:, 25]).all())):
        raise AssertionError(f"{label}: beta or its index differ from the plain step on the "
                             "kernel's costs")
    errs["grf"] = gap(out_k[:, 1:13], ref.out[:, 1:13])
    errs["state"] = gap(out_k[:, 13:25], ref.out[:, 13:25])
    errs["params"] = gap(out_k[:, 26:], ref.out[:, 26:])
    errs["params_vs_fully_plain"] = gap(out_k[:, 26:], plain.out[:, 26:])
    tols = [("grf", GRF_ATOL), ("state", STATE_ATOL),
            ("params", PARAM_ATOL if knobs.method == "random_sampling" else COMBINE_ATOL)]
    if knobs.cem:
        if not elites_match(knobs, elites_k, ref.elites):
            raise AssertionError(f"{label}: elites differ from the plain step's")
        errs["sigma"] = gap(sigma_k, ref.sigma)
        tols.append(("sigma", sigma_atol(knobs, ref.sigma)))
    for key, tol in tols:
        if not errs[key] <= tol:
            raise AssertionError(f"{label}: {key} error {errs[key]} > {tol}")
    return errs


def fleet_bound_ms(plan, knobs, S) -> tuple:
    """Least time of one K1f iteration for S scenarios on an H100: S times K1a's
    (random sampling) or K1b/K1c's operations (``k1a_bound_ms``,
    ``softmax_bound_ms``); bytes: the basis windows once (shared by the scenarios),
    and per scenario its tick row, seed and offset, incumbent (and sigma) read and
    its N costs and packed output (and sigma', elites) written."""
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    H, P, N = plan.horizon, plan.num_parameters, plan.num_samples
    flops = N * iteration_flops(plan, basis_nnz(plan.windows[:, :4]))
    if knobs.method != "random_sampling":
        flops += N * (2 * P + 20)
    per = 4 * (fl.row_floats(H) + P + N + 26 + P) + 16
    if knobs.cem:
        per += 4 * (2 * P + knobs.n_elite)
    return bound_ms(S * flops, 4 * window_floats(plan) + S * per)


def fleet_layouts(method) -> dict:
    """K1f's layouts worth timing for a method: {name: layout}. Random sampling has
    no update pass, so REGEN changes nothing for it."""
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    if method == "random_sampling":
        return {"four_lane": fl.FOUR_LANE, "large_batch": fl.LARGE_BATCH}
    return {"four_lane": fl.FOUR_LANE, "four_lane_regen": fl.REGEN, "wide_read_back": fl.WIDE,
            "large_batch": fl.LARGE_BATCH}


def fleet_run(plan, knobs, tick, inc, sigma, seeds, offsets, layout, noise=None,
              keep_noise=False) -> tuple:
    """One K1f iteration in ``layout`` on a workspace of its own: (costs, out,
    sigma', elites, argmin keys (S,), the kept noise or None), cloned."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    ws = fl.fleet_workspace(plan, knobs, inc.shape[0], inc.device, layout, keep_noise)
    res = fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets, 0, noise, ws=ws,
                             layout=layout)
    torch.cuda.synchronize()
    return tuple(None if x is None else x.clone() for x in (*res, ws.argmin[0::2], ws.noise))


def same_tensors(a, b) -> bool:
    """Bit-equality of two tuples of tensors (None where both have none)."""
    import torch
    return all((x is None and y is None) or (x is not None and y is not None
                                             and torch.equal(x, y)) for x, y in zip(a, b))


def fleet_crossover(dev, rng) -> dict:
    """Device us of one K1f iteration (its rollout and its extraction or update
    pass, torch.profiler, mean of 20 launches through the wrapper with a prebuilt
    workspace) in the four-lane and the large-batch layout at each (S, N) of
    FLEET_SWEEP, for random sampling and MPPI. The crossover is the smallest S * N
    of the sweep from which the large-batch layout takes less device time at every
    larger S * N for both (None if it never does). CUDA events would time the
    host's enqueue at the small shapes, where a pass takes ~10-25 us."""
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    rows = []
    for method in ("random_sampling", "mppi"):
        cfg = fleet_cfg(method)
        knobs = sm.make_knobs(cfg)
        second = "fleet_extract" if method == "random_sampling" else "fleet_update"
        for S, N in FLEET_SWEEP:
            plan, tick, inc, sigma, seeds, offsets = fleet_inputs(cfg, S, N, dev, rng)
            scen = fl.tick_buffer(tick)
            r = {"method": method, "S": S, "N": N}
            for name, layout in (("four_lane", fl.FOUR_LANE), ("large_batch", fl.LARGE_BATCH)):
                ws = fl.fleet_workspace(plan, knobs, S, dev, layout)

                def launch():
                    fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets, 0, ws=ws,
                                       scen=scen, layout=layout)

                rollout = "fleet_rollout_wide" if layout & fl.WIDE else "fleet_rollout"
                prof = pass_profile(launch, 1, (rollout, second), n=20)
                r[name + "_us"] = sum(us for _, us in prof.values())
            rows.append(r)
    sizes = sorted({r["S"] * r["N"] for r in rows})
    crossover = None
    for size in reversed(sizes):
        if all(r["large_batch_us"] < r["four_lane_us"] for r in rows if r["S"] * r["N"] >= size):
            crossover = size
    return {"rows": rows, "crossover": crossover, "wrapper_crossover": fl.CROSSOVER}


def phase_fleet_kernels(dev, rng, libs) -> dict:
    """Phase 25: K1f against its plain version for each method at FLEET_CHECKS in
    both layouts, the four-lane and the large-batch one: on injected noise, each
    against the plain version and the two bit for bit (costs, argmin keys,
    outputs); on Philox noise (kept by the workspace), a rerun bit for bit, the
    noise against the plain version, distinct scenarios' streams, the two rollouts
    and (MPPI, CEM) the update that reads the noise back and the one that draws it
    again, all bit for bit; S = 1 in each layout bit-equal to K1a / K1b / K1c at
    their seed and offset; then its times in each layout at FLEET_TIMES: through its
    wrapper with a prebuilt workspace (CUDA events) and its passes on the card
    (torch.profiler); at (FLEET_S, N_MAIN) its plain version and its bound; the
    ptxas figures of every K1f kernel; and the crossover sweep."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    out = {}
    for method in sm.METHODS:
        cfg = fleet_cfg(method)
        knobs = sm.make_knobs(cfg)
        errs = {}
        for S, N in FLEET_CHECKS:
            plan, tick, inc, sigma, seeds, offsets = fleet_inputs(cfg, S, N, dev, rng)
            noise = fleet_noise(plan, knobs, S, rng, dev)
            label = f"phase 25 K1f {method} S={S} N={N}"
            runs, e = {}, {}
            for name, layout in (("four_lane", fl.FOUR_LANE), ("large_batch", fl.LARGE_BATCH)):
                runs[name] = fleet_run(plan, knobs, tick, inc, sigma, seeds, offsets, layout, noise)
                e[name] = fleet_check(plan, knobs, tick, inc, sigma, noise, runs[name][:4],
                                      f"{label} {name}")
            if not same_tensors(runs["four_lane"][:5], runs["large_batch"][:5]):
                raise AssertionError(f"{label}: the layouts differ on the same injected noise")
            # Philox noise, kept: every layout, a rerun, the noise against the plain version.
            philox = {name: fleet_run(plan, knobs, tick, inc, sigma, seeds, offsets, layout,
                                      keep_noise=True)
                      for name, layout in fleet_layouts(method).items()}
            again = fleet_run(plan, knobs, tick, inc, sigma, seeds, offsets, fl.LARGE_BATCH,
                              keep_noise=True)
            first = philox["four_lane"]
            for name, res in {**philox, "rerun": again}.items():
                if not (same_tensors(first[:5], res[:5]) and same_tensors(first[5:], res[5:])):
                    raise AssertionError(f"{label}: {name} on Philox noise differs from the "
                                         "four-lane layout's bits")
            kept = first[5]
            if kept is not None:
                if not bool((kept[:, :, 0] == 0).all()):
                    raise AssertionError(f"{label}: the incumbent's column of the noise is not 0")
                e["philox"] = fleet_check(plan, knobs, tick, inc, sigma, kept, first[:4],
                                          label + " Philox")["cost"]
                if S > 1 and torch.equal(kept[0], kept[1]):
                    raise AssertionError(f"{label}: two scenarios drew the same noise")
                if not knobs.cem:
                    std = float(kept[:, :, 1:].std())
                    if abs(std / knobs.sigma_mppi - 1.0) > 0.05:
                        raise AssertionError(f"{label}: Philox noise std {std}")
            errs[f"S{S} N{N}"] = e
            log(f"{label}: both layouts bit-equal on injected and Philox noise"
                f"{' (read-back and regenerating updates too)' if kept is not None else ''}; "
                f"{e}")
        # S = 1 at K1a's / K1b's / K1c's seed and offset: their bits, in both layouts.
        plan, tick, inc, sigma, _, _ = fleet_inputs(cfg, 1, N_MAIN, dev, rng)
        seed, offset = 1234, 77
        one = sk.TickInputs(*(x[0].cpu().numpy() for x in tick))
        if method == "random_sampling":
            c2, o2 = sk.sampling_rs(plan, one, inc[0].contiguous(), seed, offset)
            s2 = None
        else:
            c2, o2, s2, _ = sm.softmax_iteration(plan, knobs, one, inc[0].contiguous(),
                                                 sigma[0].contiguous(), seed, offset)
        for layout in (fl.FOUR_LANE, fl.LARGE_BATCH):
            c1, o1, s1, _, _, _ = fleet_run(plan, knobs, tick, inc, sigma,
                                            torch.tensor([seed], device=dev),
                                            torch.tensor([offset], device=dev), layout)
            if not (torch.equal(c1[0], c2) and torch.equal(o1[0], o2)
                    and (not knobs.cem or torch.equal(s1[0], s2))):
                raise AssertionError(f"phase 25 K1f {method} layout {layout}: S = 1 is not the "
                                     "single kernel's bits")
        # Times in each layout.
        times = {}
        for S, N in FLEET_TIMES:
            plan, tick, inc, sigma, seeds, offsets = fleet_inputs(cfg, S, N, dev, rng)
            scen = fl.tick_buffer(tick)
            for name, layout in fleet_layouts(method).items():
                ws = fl.fleet_workspace(plan, knobs, S, dev, layout)

                def launch():
                    fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets, 0, ws=ws,
                                       scen=scen, layout=layout)

                rollout = "fleet_rollout_wide" if layout & fl.WIDE else "fleet_rollout"
                passes = (rollout, "fleet_extract" if method == "random_sampling"
                          else "fleet_update")
                r = {"ms": time_cuda(launch, runs=50),
                     "passes": pass_profile(launch, 1, passes, n=20)}
                if method != "random_sampling":
                    # The softmax weights exp(-(c - beta)/T) that are not 0: the
                    # samples whose noise the update pass reads or draws again.
                    w = torch.exp(-(ws.costs - ws.costs.min(1, keepdim=True).values)
                                  / knobs.temperature)
                    r["nonzero_weights"] = int((w != 0).sum())
                times[f"S{S} N{N} {name}"] = r
                log(f"phase 25 K1f {method} S={S} N={N} {name}: {r['ms']:.4f} ms through the "
                    f"wrapper (median of 50), passes {r['passes']}")
        plan, tick, inc, sigma, seeds, offsets = fleet_inputs(cfg, FLEET_S, N_MAIN, dev, rng)
        noise = fleet_noise(plan, knobs, FLEET_S, rng, dev)
        main = f"S{FLEET_S} N{N_MAIN}"
        r = {"errs": errs, "times": times,
             "plain_ms": time_cuda(lambda: fl.fleet_iteration_reference(
                 plan, knobs, tick, inc, sigma, noise), runs=5, warmup=2),
             "bound": fleet_bound_ms(plan, knobs, FLEET_S)}
        log(f"phase 25 K1f {method} {main}: four-lane {times[main + ' four_lane']['ms']:.4f} ms, "
            f"large-batch {times[main + ' large_batch']['ms']:.4f} ms, plain version "
            f"{r['plain_ms']:.3f} ms, bound {r['bound'][0]:.5f} ms ({r['bound'][1]})")
        out[method] = r
    p = sk.make_rs_plan(fleet_cfg(), 1, "cpu")
    log_path = libs[("sampling_fleet", p.horizon, p.params_per_leg)].with_suffix(".log")
    ptx = {}
    for i, method in enumerate(sm.METHODS):
        for kname in ("fleet_rollout_kernel", "fleet_rollout_wide_kernel"):
            ptx[f"{kname} {method}"] = ptxas_of(log_path, kname, f"Li{i}EE")
    for regen in (0, 1):
        ptx[f"fleet_update_kernel regen={regen}"] = ptxas_of(log_path, "fleet_update_kernel",
                                                             f"Lb{regen}EE")
    ptx["fleet_extract_kernel"] = ptxas_of(log_path, "fleet_extract_kernel")
    log(f"phase 25 K1f ptxas: {json.dumps(ptx)}")
    cross = fleet_crossover(dev, rng)
    log(f"phase 25 K1f crossover sweep (iteration ms in each layout): {json.dumps(cross)}")
    out["ptxas"] = ptx
    out["crossover"] = cross
    return out


def fleet_state(cfg, S, N, terrain, reflexes, seed=0):
    """(step, state, cmd) of an S-scenario fleet on the card."""
    import torch
    from quadruped_pympc_tamols_torch.parallel import (init_scenario_state, make_scenario_step,
                                                       make_terrain_generator)
    step, P = make_scenario_step(cfg, N, terrain=terrain, reflexes=reflexes)
    gen = make_terrain_generator(terrain) if terrain else None
    st = init_scenario_state(cfg, P, S, torch.Generator().manual_seed(seed), gen)
    return step, st, torch.tensor([FLEET_VEL, 0.0, 0.0], device="cuda")


def fleet_walk(label, method, terrain, reflexes, S=FLEET_S, N=N_MAIN, ticks=None) -> dict:
    """A fleet walk on the card, each tick one replay of the captured graph, with
    the launch counts zeroed just before and read just after: every scenario
    above FLEET_Z_MIN all the way, K1f launched once a tick in the layout the
    wrapper picks for S x N (the wrapper's count: the capture's warm-up launches,
    then what the capture recorded, added at each replay) and no other sampling
    kernel or layout; then the profiler over 50 more ticks: one rollout of that
    layout and one extraction or update pass a tick and no device-to-host copy
    (none through torch either, counted on the host)."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.utils.graphs import WARMUP

    cfg = fleet_cfg(method)
    step, st, cmd = fleet_state(cfg, S, N, terrain, reflexes)
    ticks = ticks or int(round(FLEET_SECONDS * cfg.sim.mpc_frequency))
    x0 = st.x[:, 0].clone()
    zmin = st.x[:, 2].clone()
    trig = torch.zeros((), device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(ticks):
        m = step(st, cmd)
        zmin = torch.minimum(zmin, st.x[:, 2])
        trig = trig + m[:, 4].sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    wide = bool(fl.fleet_layout(S, N) & fl.WIDE)
    key = {"random_sampling": "K1f_rs", "mppi": "K1f_mppi", "cem_mppi": "K1f_cem"}[method]
    key += "_wide" if wide else ""
    # The first tick captures the graph after WARMUP eager runs, which launch K1f too.
    want = {**counts_of(**{key: 1})(ticks), key: ticks + WARMUP}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} for {ticks} ticks, want {want}")
    if step.graph.captures != 1 or step.graph.replays != ticks:
        raise AssertionError(f"{label}: {step.graph.captures} captures, {step.graph.replays} "
                             f"replays in {ticks} ticks")
    if not bool(torch.isfinite(st.x).all()) or float(zmin.min()) <= FLEET_Z_MIN:
        raise AssertionError(f"{label}: a scenario fell (min z {float(zmin.min()):.4f})")
    w = {"ticks": ticks, "scenarios": S, "num_samples": N, "terrain": terrain,
         "reflexes": reflexes, "layout": "large_batch" if wide else "four_lane",
         "launches": counts[key], "min_z": float(zmin.min()),
         "mean_dx": float((st.x[:, 0] - x0).mean()), "reflex_triggers": float(trig),
         "wall_ms_per_tick": wall / ticks * 1e3}
    second = FLEET_PASSES["fleet_extract" if method == "random_sampling" else "fleet_update"]

    def call():
        step(st, cmd)

    copies = host_d2h_copies(call, 10)
    if copies:
        raise AssertionError(f"{label}: {copies} device-to-host copies in 10 ticks")
    rollout = FLEET_PASSES["fleet_rollout_wide" if wide else "fleet_rollout"]
    prof = profile_ticks(None, None, expect={rollout: 1, second: 1}, absent=("DtoH",), call=call)
    recorded = prof.get("launches", {})
    w.update({
         "kernels_per_tick_recorded": sum(recorded.values()) / 50,
         "device_us_per_tick_recorded": sum(prof["device_us_per_launch"][k] * n
                                            for k, n in recorded.items()) / 50
         if recorded else "not measured",
         "device_busy_share_recorded": prof.get("device_busy_share_recorded"),
         "k1f_us": {k.split("(")[0]: v for k, v in prof.get("device_us_per_launch", {}).items()
                    if "fleet_" in k}})
    log(f"{label}: {json.dumps(w)}")
    return w


def phase_fleet_walks() -> dict:
    """Phase 26: the perlin fleet with reflexes at production width (random
    sampling, N = 10 000: the large-batch layout) beside the JAX package's CPU row,
    and a flat MPPI fleet; CEM-MPPI's fleet for TICK_LOOP ticks (its single-robot
    loop falls in both packages, so it is held per tick: finite, upright). Then the
    same three fleets for TICK_LOOP ticks at the JAX bench's 64 x 128, where the
    wrapper picks the four-lane layout."""
    perlin = fleet_walk("phase 26 perlin fleet", "random_sampling", "perlin", True)
    want = JAX_CPU_FLEET_WALK["mean_dx"]
    if abs(perlin["mean_dx"] / want - 1.0) > FLEET_DX_BAND:
        raise AssertionError(f"phase 26: mean forward distance {perlin['mean_dx']:.4f} m vs "
                             f"the JAX package's {want:.4f} m")
    log(f"phase 26: JAX package on the CPU (8 scenarios): {JAX_CPU_FLEET_WALK}")
    flat = fleet_walk("phase 26 flat MPPI fleet", "mppi", None, False)
    cem = fleet_walk("phase 26 flat CEM-MPPI fleet", "cem_mppi", None, False, ticks=TICK_LOOP)
    small = {f"{key}_n128": fleet_walk(f"phase 26 {label} fleet N=128", method, terrain, terrain
                                       is not None, N=128, ticks=TICK_LOOP)
             for key, label, method, terrain in (("perlin_rs", "perlin", "random_sampling",
                                                  "perlin"),
                                                 ("flat_mppi", "flat MPPI", "mppi", None),
                                                 ("flat_cem_loop", "flat CEM-MPPI", "cem_mppi",
                                                  None))}
    return {"perlin_rs": perlin, "flat_mppi": flat, "flat_cem_loop": cem, **small}


def phase_fleet_throughput() -> dict:
    """Phase 27: scenario-steps per second of the perlin fleet with reflexes at
    FLEET_THROUGHPUT, from FLEET_TIMED_TICKS graph replays on the host clock; the
    host ms a tick eagerly (the same tick's torch ops and K1f launches, not
    captured); the rollout pass's share of the card (device us a tick and the
    K1f passes' us, torch.profiler). Phase 25 reports K1f's ptxas figures."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl

    rows = {}
    for S, N in FLEET_THROUGHPUT:
        step, st, cmd = fleet_state(fleet_cfg(), S, N, "perlin", True, seed=1)
        for _ in range(3):
            step(st, cmd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FLEET_TIMED_TICKS):
            step(st, cmd)
        torch.cuda.synchronize()
        graph_s = (time.perf_counter() - t0) / FLEET_TIMED_TICKS
        t0 = time.perf_counter()
        for _ in range(5):
            step.tick(*st.tensors(), cmd)
        torch.cuda.synchronize()
        eager_s = (time.perf_counter() - t0) / 5

        def call():
            step(st, cmd)

        # "fleet_rollout" names the rollout of either layout (fleet_rollout_kernel,
        # fleet_rollout_wide_kernel); the layout is the wrapper's choice for S x N.
        prof = profile_ticks(None, None, n=20, expect={"fleet_rollout": 1}, call=call)
        rec = prof.get("launches", {})
        us = prof.get("device_us_per_launch", {})
        r = {"layout": "large_batch" if fl.fleet_layout(S, N) & fl.WIDE else "four_lane",
             "scenario_steps_per_s": S / graph_s, "graph_ms_per_tick": graph_s * 1e3,
             "eager_host_ms_per_tick": eager_s * 1e3,
             "kernels_per_tick_recorded": sum(rec.values()) / 20,
             "device_us_per_tick_recorded": sum(us[k] * n for k, n in rec.items()) / 20,
             "k1f_rollout_us": next((v for k, v in us.items() if "fleet_rollout" in k), None),
             "k1f_extract_us": next((v for k, v in us.items() if "fleet_extract" in k), None),
             "device_busy_share_recorded": prof.get("device_busy_share_recorded")}
        rows[f"S{S} N{N}"] = r
        log(f"phase 27 fleet S={S} N={N}: {json.dumps(r)}")
    return rows


def fleet_rows(fleet_k, fleet_walks) -> list:
    """K1f's rows of the kernels line, one a method and layout, from phases 25-26:
    the four-lane layout's launches on the fleets at the JAX bench's 64 x 128
    (phase 26's N=128 loops), the large-batch layout's on the fleets at 64 x
    10 000 (the perlin walk for random sampling, the flat walks for MPPI and
    CEM-MPPI); the time, passes, ptxas figures and errors of each at (FLEET_S,
    N_MAIN), its times at FLEET_TIMES beside them. Raises for a row launched no
    time on its path."""
    rows = []
    main_shape = f"S{FLEET_S} N{N_MAIN}"
    for method, short, walk_key in (("random_sampling", "K1f-rs", "perlin_rs"),
                                    ("mppi", "K1f-mppi", "flat_mppi"),
                                    ("cem_mppi", "K1f-cem", "flat_cem_loop")):
        r = fleet_k[method]
        for layout, suffix, walk_run in (("four_lane", "", walk_key + "_n128"),
                                         ("large_batch", "-wide", walk_key)):
            t = r["times"][f"{main_shape} {layout}"]
            e = r["errs"][main_shape][layout]
            wide = layout == "large_batch"
            row_f = {"name": f"fleet_iteration, {method}, "
                             f"{'large-batch' if wide else 'four-lane'} layout ({short}{suffix})",
                     "route": "cuda",
                     "source": "quadruped_pympc_tamols_torch/ops/csrc/sampling_fleet.cu",
                     "replaces": "quadruped_pympc_tamols_tpu/parallel/scenario_engine.py:220",
                     "replaces_note": "no pl.pallas_call: the JAX fleet jax.vmaps the XLA solver "
                                      "make_sampling_solver over its scenarios",
                     "launches": fleet_walks[walk_run]["launches"], "max_abs_err": e["cost"],
                     "ms": t["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                     "bound_by": r["bound"][1], "library_ms": None, "parametrization": MAIN_PAR,
                     "scenarios": FLEET_S, "num_samples": N_MAIN,
                     "launches_on": f"{fleet_walks[walk_run]['scenarios']} x "
                                    f"{fleet_walks[walk_run]['num_samples']}",
                     **{f"{k}_max_abs_err": v for k, v in e.items() if k != "cost"},
                     "times": {k: v for k, v in r["times"].items() if k.endswith(" " + layout)}}
            rollout_k = "fleet_rollout_wide_kernel" if wide else "fleet_rollout_kernel"
            row_f["rollout_ptxas"] = fleet_k["ptxas"][f"{rollout_k} {method}"]
            if method != "random_sampling":
                row_f["update_ptxas"] = fleet_k["ptxas"][f"fleet_update_kernel regen={int(wide)}"]
            for pass_name, (kname, us) in t["passes"].items():
                row_f[f"{pass_name}_kernel_us"] = us
                log(f"{pass_name} pass of {row_f['name']}: {kname} {us:.2f} us a launch "
                    f"(torch.profiler, mean of 20 calls)")
            if not row_f["launches"] > 0:
                raise AssertionError(f"{row_f['name']}: no launch on its path")
            rows.append(row_f)
    return rows


# -- phases 28-30: the sharded solver, the multi-chip fleet step and the runtime -------
SHARDED_TIMED = 200  # sharded solve ticks behind each median (phase 28)
GLOO_RANKS = 2  # phase 28 (c): ranks on the one card over gloo
MULTICHIP_S = 64  # phase 29: scenarios of the one rank
NODE_MODES = ("inline", "pipelined", "thread", "shared_memory")
BUS_SAMPLES = 2000  # phase 30: bus write -> read latencies behind the median


def knob_noise(plan, knobs, rng, dev, sigma=None):
    """(P, N) injected noise of the method's distribution with column 0 drawn too,
    as a sample shard other than the first draws it."""
    import torch
    if knobs.method == "random_sampling":
        z = numpy_noise(plan, rng)
        z[:, 0] = plan.sigma_random[1] * rng.standard_normal(plan.num_parameters)
    else:
        z = rng.standard_normal((plan.num_parameters, plan.num_samples)).astype(np.float32)
        z *= (sigma.cpu().numpy()[:, None] if knobs.cem else knobs.sigma_mppi)
    return torch.as_tensor(z.astype(np.float32), device=dev)


def single_iteration(plan, knobs, tick, inc, sigma, seed, offset, noise_in=None, **kw):
    """K1a or K1b/K1c through its wrapper, the noise it drew kept unless injected:
    (costs, out, sigma', elites, noise), cloned after a sync."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    drawn = None if noise_in is not None else torch.empty(plan.num_parameters, plan.num_samples,
                                                          device=inc.device)
    if knobs.method == "random_sampling":
        res = (*sk.sampling_rs(plan, tick, inc, seed, offset, noise_in, drawn), None, None)
    else:
        res = sm.softmax_iteration(plan, knobs, tick, inc, sigma, seed, offset, noise_in, drawn,
                                   **kw)
    torch.cuda.synchronize()
    return tuple(None if x is None else x.clone() for x in res) + (
        noise_in if noise_in is not None else drawn,)


def same_results(a, b) -> bool:
    import torch
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def phase_knobs(dev, rng) -> dict:
    """Phase 28 (a): the sharded solve's two knobs against the plain versions at the
    main path's shapes. The drawn column 0 on K1a, K1b, K1c (N = 10 000) and K1f in
    both layouts (64 x 10 000 large-batch, 64 x 128 four-lane): on Philox noise it
    changes column 0 alone, and the result holds against the plain version on the
    noise the kernel drew (K1a: check_against_plain; K1b/K1c: check_softmax, K1f:
    fleet_check); on injected noise it changes no bit. The caller's beta and the
    unnormalized sums on K1b and K1c: handed their own beta back, the outputs are the plain
    launch's bit for bit and incumbent + S / Z is the kernel's new parameters bit
    for bit; with beta 3 below it, the sums against softmax_sums on the kernel's
    own costs and noise (Z rtol 1e-5, S / Z atol COMBINE_ATOL)."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    errs = {}
    for method in sm.METHODS:
        cfg = main_cfg(**{"mpc.sampling.method": method})
        knobs = sm.make_knobs(cfg)
        plan = sk.make_rs_plan(cfg, N_MAIN, dev)
        col0 = sk.with_drawn_column0(plan)
        tick = example_tick(cfg, plan)
        P = plan.num_parameters
        inc = torch.as_tensor(0.3 * rng.standard_normal(P).astype(np.float32), device=dev)
        sigma = torch.as_tensor((0.5 + rng.random(P)).astype(np.float32), device=dev)
        label = f"phase 28 (a) {method}"
        base = single_iteration(plan, knobs, tick, inc, sigma, 21, 4)
        drawn = single_iteration(col0, knobs, tick, inc, sigma, 21, 4)
        if not (torch.equal(base[4][:, 1:], drawn[4][:, 1:]) and not bool(base[4][:, 0].any())
                and bool(drawn[4][:, 0].any())):
            raise AssertionError(f"{label}: the drawn column 0 changed more than column 0")
        if method == "random_sampling":
            e, _ = check_against_plain(col0, tick, inc, drawn[4], drawn[0], drawn[1], label)
        else:
            e = check_softmax(col0, knobs, tick, inc, drawn[4], drawn[0], drawn[1], drawn[2],
                              drawn[3], label)
        e["col0_std_over_sigma"] = float(drawn[4][:, 0].std()) / (
            plan.sigma_random[1] if method == "random_sampling" else
            float(sigma.mean()) if knobs.cem else knobs.sigma_mppi)
        noise = knob_noise(plan, knobs, rng, dev, sigma)
        if not same_results(single_iteration(plan, knobs, tick, inc, sigma, 21, 4, noise),
                         single_iteration(col0, knobs, tick, inc, sigma, 21, 4, noise)):
            raise AssertionError(f"{label}: the drawn column 0 moved injected noise's bits")
        if method != "random_sampling":
            sums = torch.empty(P + 1, device=dev)
            own = single_iteration(plan, knobs, tick, inc, sigma, 21, 4,
                                   merge_beta=lambda lo: lo.clone(), sums=sums)
            if not (same_results(base, own) and torch.equal(inc + sums[:P] / sums[P], own[1][26:])):
                raise AssertionError(f"{label}: the caller's own beta moved the bits")
            shifted = single_iteration(plan, knobs, tick, inc, sigma, 21, 4,
                                       merge_beta=lambda lo: lo - 3.0, sums=sums)
            S, Z = sm.softmax_sums(shifted[0], shifted[4], shifted[1][0] - 3.0, knobs.temperature)
            e["sums_Z_rel_err"] = abs(float(sums[P]) / float(Z) - 1.0)
            e["sums_S_over_Z_err"] = gap(sums[:P] / sums[P], S / Z)
            if not (e["sums_Z_rel_err"] <= 1e-5 and e["sums_S_over_Z_err"] <= COMBINE_ATOL
                    and torch.equal(shifted[1][26:], inc + sums[:P] / sums[P])):
                raise AssertionError(f"{label}: the sums off softmax_sums: {e}")
        errs[method] = e
        # K1f in each layout.
        for S_, N_, layout in ((FLEET_S, N_MAIN, fl.LARGE_BATCH), (FLEET_S, 128, fl.FOUR_LANE)):
            fplan, ftick, finc, fsig, seeds, offsets = fleet_inputs(cfg, S_, N_, dev, rng)

            def run(p, **kw):
                ws = fl.fleet_workspace(p, knobs, S_, dev, layout, keep_noise=True)
                res = fl.fleet_iteration(p, knobs, ftick, finc, fsig, seeds, offsets, ws=ws,
                                         layout=layout, **kw)
                torch.cuda.synchronize()
                return tuple(None if x is None else x.clone() for x in (*res, ws.noise))

            flabel = f"{label} K1f {S_} x {N_}"
            fb, fd = run(fplan), run(sk.with_drawn_column0(fplan))
            if fb[4] is not None:
                ok = torch.equal(fb[4][:, :, 1:], fd[4][:, :, 1:]) and bool(fd[4][:, :, 0].any())
                fleet_check(fplan, knobs, ftick, finc, fsig, fd[4], fd[:4], flabel)
            else:
                ok = torch.equal(fb[0][:, 1:], fd[0][:, 1:]) and not torch.equal(fb[0][:, 0],
                                                                                 fd[0][:, 0])
            if not ok:
                raise AssertionError(f"{flabel}: the drawn column 0 changed more than column 0")
            z = torch.randn(S_, P, N_, device=dev) * 0.3
            if not same_results(run(fplan, noise_in=z)[:4],
                                run(sk.with_drawn_column0(fplan), noise_in=z)[:4]):
                raise AssertionError(f"{flabel}: the drawn column 0 moved injected noise's bits")
    log(f"phase 28 (a): ok; the drawn column 0 on K1a-K1c and K1f and the caller's beta and "
        f"sums on K1b and K1c against the plain versions: {json.dumps(errs)}")
    return errs


def sharded_noise(cfg, knobs, rng, dev, sigma, shards):
    """(P, N_MAIN) injected noise of a whole sharded solve of ``shards`` shards, and
    the samples a shard: column 0 of every shard after the first drawn, the
    first's zero."""
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    z = knob_noise(sk.make_rs_plan(cfg, N_MAIN, "cpu"), knobs, rng, dev, sigma)
    z[:, 0] = 0.0
    return z.contiguous(), N_MAIN // shards


def phase_sharded(dev, rng, tick_ms) -> dict:
    """Phase 28 (b): the sharded solver at world size 1 (NCCL, in this process; the
    group stays up for phase 29), N = 10 000, H = 12, cubic splines, each method,
    against the iteration SamplingMPC runs (the K1a/K1b/K1c wrapper) on the same
    injected noise: best cost and parameters bit for bit (the merge of one shard
    adds nothing, and incumbent + S / Z is the kernel's own finish), CEM's sigma
    within COMBINE_ATOL (refit on the elite columns in torch, not in the kernel),
    GRFs within GRF_ATOL (torch's extraction); one K1a/K1b/K1c launch a call and no
    K1d. Then SHARDED_TIMED solve ticks on Philox noise, the counts zeroed just
    before and read just after, their median host ms beside SamplingMPC's solve
    tick (``tick_ms``, one iteration, this run)."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.sampling import SamplingState
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
    from quadruped_pympc_tamols_torch.parallel import (find_free_port, init_multihost,
                                                       make_sharded_sampling_solver,
                                                       scenario_mesh)

    init_multihost(f"127.0.0.1:{find_free_port()}", 1, 0, device="cuda")
    mesh = scenario_mesh(1, 1)
    out = {}
    for method, key in (("random_sampling", "K1a"), ("mppi", "K1b"), ("cem_mppi", "K1c")):
        cfg = main_cfg(**{"mpc.sampling.method": method})
        knobs = sm.make_knobs(cfg)
        solve, P = make_sharded_sampling_solver(cfg, mesh, N_MAIN, method)
        plan = solve.plan
        tick = example_tick(cfg, plan)
        inc = torch.as_tensor(0.3 * rng.standard_normal(P).astype(np.float32), device=dev)
        sigma = torch.as_tensor((0.5 + rng.random(P)).astype(np.float32), device=dev)
        noise, _ = sharded_noise(cfg, knobs, rng, dev, sigma, 1)
        label = f"phase 28 (b) {method}"
        reset_counts()
        grfs, st, best = solve(tick.state12, tick.feet, tick.ref12, tick.contact_seq,
                               SamplingState(inc, 21, 4, sigma), noise=noise)
        torch.cuda.synchronize()
        check_counts(label, read_counts(), counts_of(**{key: 1}), 1)
        ref = single_iteration(plan, knobs, tick, inc, sigma, 21, 4, noise)
        e = {"grf": gap(grfs.reshape(12), ref[1][1:13])}
        if not (torch.equal(best, ref[1][0:1]) and torch.equal(st.best_parameters, ref[1][26:])
                and e["grf"] <= GRF_ATOL and st.offset == 5):
            raise AssertionError(f"{label}: off the single iteration: {e}, best "
                                 f"{float(best)} vs {float(ref[1][0])}")
        if knobs.cem:
            e["sigma"] = gap(st.sigma, ref[2])
            if not e["sigma"] <= COMBINE_ATOL:
                raise AssertionError(f"{label}: sigma off by {e['sigma']}")
        state = SamplingState(inc, 21, 4, sigma)

        def call():
            nonlocal state
            g, state, _ = solve(tick.state12, tick.feet, tick.ref12, tick.contact_seq, state)
            g.cpu()

        for _ in range(10):
            call()
        torch.cuda.synchronize()
        reset_counts()
        ms = median_host_ms(call, SHARDED_TIMED)
        counts = read_counts()
        check_counts(label + " timed", counts, counts_of(**{key: 1}), SHARDED_TIMED + 10)
        e.update(best_cost_and_params="bit-equal", launches=counts[key],
                 sharded_tick_ms=ms, sampling_mpc_tick_ms=tick_ms[method])
        out[method] = e
        log(f"{label}: ok; bit-equal best cost and parameters to the single iteration on "
            f"the same noise, {json.dumps(e)}")
    return out


def gloo_child(store: str, rank: int) -> int:
    """Phase 28 (c), one rank: GLOO_RANKS ranks on the one card over gloo (CUDA
    tensors staged through host memory), each method's sharded solve of N = 10 000
    on injected noise against the plain two-rank merge (the same solve with
    device="cpu" over the same group). Prints its gaps as one JSON line."""
    import torch
    import torch.distributed as dist
    from quadruped_pympc_tamols_torch.controllers.sampling import SamplingState
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
    from quadruped_pympc_tamols_torch.ops.cost_checks import COST_RTOL
    from quadruped_pympc_tamols_torch.parallel import (init_multihost,
                                                       make_sharded_sampling_solver,
                                                       scenario_mesh)

    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    init_multihost(store, GLOO_RANKS, rank, device="cpu", timeout_s=300)
    mesh = scenario_mesh(1, GLOO_RANKS)
    col = mesh.coords[1]
    report = {}
    for k, (method, key) in enumerate((("random_sampling", "K1a"), ("mppi", "K1b"),
                                       ("cem_mppi", "K1c"))):
        cfg = main_cfg(**{"mpc.sampling.method": method})
        knobs = sm.make_knobs(cfg)
        rng = np.random.default_rng(100 + k)  # the same draws on every rank
        solves = {d: make_sharded_sampling_solver(cfg, mesh, N_MAIN, method, device=d)[0]
                  for d in ("cuda", "cpu")}
        plan = solves["cuda"].plan
        P = plan.num_parameters
        tick = example_tick(cfg, plan)
        inc = (0.3 * rng.standard_normal(P)).astype(np.float32)
        sigma = (0.5 + rng.random(P)).astype(np.float32)
        full, n_local = sharded_noise(cfg, knobs, rng, "cpu", torch.from_numpy(sigma),
                                      GLOO_RANKS)
        mine = full[:, col * n_local:(col + 1) * n_local].contiguous()
        res = {}
        for d, solve in solves.items():
            reset_counts()
            g, st, best = solve(tick.state12, tick.feet, tick.ref12, tick.contact_seq,
                                SamplingState(torch.from_numpy(inc).to(d), 21, 4,
                                              torch.from_numpy(sigma).to(d)),
                                noise=mine.to(d))
            counts = read_counts()
            res[d] = (g.cpu(), st.best_parameters.cpu(), best.cpu(), st.sigma.cpu(), counts)
        c, p = res["cuda"], res["cpu"]
        e = {"grf": gap(c[0], p[0]), "params": gap(c[1], p[1]),
             "best_cost_rel": abs(float(c[2]) / float(p[2]) - 1.0),
             "launches": c[4][key], "launches_cpu": p[4][key]}
        if knobs.cem:
            e["sigma"] = gap(c[3], p[3])
        tol = PARAM_ATOL if method == "random_sampling" else COMBINE_ATOL
        if not (e["params"] <= tol and e["grf"] <= GRF_ATOL and e["best_cost_rel"] <= COST_RTOL
                and e.get("sigma", 0.0) <= COMBINE_ATOL and e["launches"] == 1
                and e["launches_cpu"] == 0):
            raise AssertionError(f"phase 28 (c) rank {rank} {method}: {e}")
        report[method] = e
    print(json.dumps({"rank": rank, "gaps": report}), flush=True)
    dist.destroy_process_group()
    return 0


def phase_gloo() -> dict:
    """Phase 28 (c): GLOO_RANKS processes of ``gloo_child`` on the one card."""
    from pathlib import Path

    from quadruped_pympc_tamols_torch.parallel.multihost import find_free_port, spawn, wait_all

    here = Path(__file__).resolve().parent
    store = f"127.0.0.1:{find_free_port()}"
    t0 = time.perf_counter()
    procs = [spawn([sys.executable, str(here / "chip_smoke.py"), "--gloo-rank", str(r), store],
                   dict(os.environ), here) for r in range(GLOO_RANKS)]
    outs = wait_all(procs, 600.0, "phase 28 (c) rank")
    reports = [json.loads(next(line for line in o.splitlines() if line.startswith("{")))
               for o, _ in outs]
    r = {"ranks": GLOO_RANKS, "wall_s": time.perf_counter() - t0,
         "gaps": {rep["rank"]: rep["gaps"] for rep in reports}}
    log(f"phase 28 (c): ok; {GLOO_RANKS} ranks on the one card over gloo, the merged "
        f"output against the plain {GLOO_RANKS}-rank merge on the same noise: {json.dumps(r)}")
    return r


def phase_multichip(fleet_tp) -> dict:
    """Phase 29: make_multichip_step at world size 1 (the NCCL group of phase 28) on
    K1f: MULTICHIP_S scenarios x 10 000 samples, flat and over boxes, FLEET_SECONDS
    at 0.25 m/s, the counts zeroed just before and read just after: K1f (the
    large-batch layout S x N picks) once a tick and no other kernel, every scenario
    above FLEET_Z_MIN, the fleet moving forward, finite metrics; scenario-steps/s
    on the host clock (eager ticks: gloo and NCCL calls are not captured) beside
    phase 27's scenario-engine figure at the same S x N."""
    import torch
    import torch.distributed as dist
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.parallel import make_multichip_step, scenario_mesh

    mesh = scenario_mesh(1, 1)
    out = {}
    key = "K1f_rs_wide" if fl.fleet_layout(MULTICHIP_S, N_MAIN) & fl.WIDE else "K1f_rs"
    for terrain in (None, "boxes"):
        cfg = fleet_cfg()
        step, init, _ = make_multichip_step(cfg, mesh, MULTICHIP_S, N_MAIN, terrain)
        st = init(seed=0)
        cmd = torch.tensor([[FLEET_VEL, 0.0, 0.0]] * MULTICHIP_S, device="cuda")
        ticks = int(round(FLEET_SECONDS * cfg.sim.mpc_frequency))
        x0 = st.x[:, 0].clone()
        zmin = st.x[:, 2].clone()
        label = f"phase 29 multichip {terrain or 'flat'}"
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(ticks):
            st, m = step(st, cmd)
            zmin = torch.minimum(zmin, st.x[:, 2])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        check_counts(label, counts, counts_of(**{key: 1}), ticks)
        dx = float((st.x[:, 0] - x0).mean())
        if not (bool(torch.isfinite(st.x).all()) and bool(torch.isfinite(m).all())
                and float(zmin.min()) > FLEET_Z_MIN and dx > 0.0):
            raise AssertionError(f"{label}: min z {float(zmin.min())}, mean dx {dx}")
        r = {"scenarios": MULTICHIP_S, "num_samples": N_MAIN, "ticks": ticks,
             "launches": counts[key],
             "layout": key, "min_z": float(zmin.min()), "mean_dx": dx,
             "fleet_vel_err": float(m[0]), "fleet_cost": float(m[1]),
             "ms_per_tick": wall / ticks * 1e3, "scenario_steps_per_s": MULTICHIP_S * ticks / wall,
             "scenario_engine_steps_per_s_phase27":
                 fleet_tp.get(f"S{MULTICHIP_S} N{N_MAIN}", {}).get("scenario_steps_per_s")}
        out[terrain or "flat"] = r
        log(f"{label}: ok; {json.dumps(r)}")
    dist.destroy_process_group()
    return out


def bus_latency() -> dict:
    """Phase 30 (c): the control bus's write -> read latency: a writer thread stamps
    each block with the host clock, a reader waits on the seq-lock (wait_new)."""
    import threading
    from quadruped_pympc_tamols_torch.runtime.control_bus import (OFF_TIMING, PAYLOAD_DOUBLES,
                                                                  ControlBus)

    name = f"/qpympc_smoke_lat_{os.getpid()}"
    w, r = ControlBus(name, create=True), ControlBus(name, create=False)
    lat, stop = [], threading.Event()

    def writer():
        block = np.zeros(PAYLOAD_DOUBLES)
        while not stop.is_set():
            block[OFF_TIMING + 1] = time.perf_counter()
            w.write(block)
            time.sleep(0.0005)

    th = threading.Thread(target=writer)
    th.start()
    try:
        seq = 0
        while len(lat) < BUS_SAMPLES:
            seq, data = r.wait_new(seq, timeout_s=1.0)
            if not seq:
                raise AssertionError("phase 30 (c): the bus published nothing for 1 s")
            lat.append((time.perf_counter() - data[OFF_TIMING + 1]) * 1e6)
    finally:
        stop.set()
        th.join()
        r.close()
        w.close()
    return {"samples": BUS_SAMPLES, "write_to_read_us_median": statistics.median(lat),
            "write_to_read_us_p99": float(np.percentile(lat, 99))}


NODE_WARMUP_S = 60.0  # at most, for a node's first two solves (a graph's capture)


def node_run(cfg, mode, inputs, feet0, label) -> dict:
    """Phase 30: ControllerNode(cfg, mode) on the card over the recorded trace, one
    control tick a step paced at the simulation step (a tick that overruns it
    starts the next at once), after ticks on the first step until the node has
    completed two solves (the gradient family captures its graphs at its first
    solve, on the MPC thread in the background modes); the counts zeroed just
    before the timed ticks and read just after: finite torques; control_tick host
    ms, median and p99; the solves completed in the window (per second)."""
    import torch
    from quadruped_pympc_tamols_torch.runtime import ControllerNode
    from quadruped_pympc_tamols_torch.utils.legs import Legs

    node = ControllerNode(cfg, Legs(feet0.copy()), mode,
                          bus_name=f"/qpympc_smoke_{os.getpid()}_{label.replace(' ', '_')}")
    ms = []
    try:
        kw0 = inputs[0]
        s0 = dict(kw0, joints_vel=kw0["qvel_js"])
        deadline = time.perf_counter() + NODE_WARMUP_S
        while node.solves < 2:
            node.control_tick(lambda: s0, kw0["ref_base_lin_vel"], kw0["ref_base_ang_vel"],
                              kw0["simulation_dt"])
            time.sleep(kw0["simulation_dt"])
            if time.perf_counter() > deadline:
                raise AssertionError(f"{label}: {node.solves} solves in {NODE_WARMUP_S} s")
        torch.cuda.synchronize()
        reset_counts()
        solves0 = node.solves
        t_start = time.perf_counter()
        next_t = t_start
        for kw in inputs:
            s = dict(kw, joints_vel=kw["qvel_js"])
            t0 = time.perf_counter()
            tau, _, _ = node.control_tick(lambda: s, kw["ref_base_lin_vel"],
                                          kw["ref_base_ang_vel"], kw["simulation_dt"])
            ms.append((time.perf_counter() - t0) * 1e3)
            if not np.all(np.isfinite(np.asarray(tau.data))):
                raise AssertionError(f"{label}: torques not finite")
            next_t = max(next_t + kw["simulation_dt"], time.perf_counter())
            time.sleep(max(0.0, next_t - time.perf_counter()))
        wall = time.perf_counter() - t_start
        solves = node.solves - solves0
    finally:
        node.shutdown()
    torch.cuda.synchronize()
    return {"ticks": len(inputs), "control_tick_ms_median": statistics.median(ms),
            "control_tick_ms_p99": float(np.percentile(ms, 99)),
            "control_tick_ms_max": max(ms), "solves": solves, "solves_per_s": solves / wall,
            "wall_s": wall, "launches": read_counts()}


def phase_nodes() -> dict:
    """Phase 30: ControllerNode on the card in each mode for the default
    configuration (sampling, TAMOLS footholds, N = 10 000) and mpc_type="nominal",
    the recorded MuJoCo loop (500 steps) as the state provider. Inline and
    pipelined solve every tick: K1a once a tick for the default configuration (as
    phase 18's wrapper once an MPC tick), none for the nominal; thread and
    shared_memory launch K1a once a completed solve (give or take the one in flight
    when the window opens or the node shuts down). Then the bus's latency."""
    from quadruped_pympc_tamols_torch import make_config
    from quadruped_pympc_tamols_torch.sim.trace import ControlTrace

    trace = ControlTrace()
    inputs = [trace.inputs(i, device="cuda") for i in range(trace.steps)]
    feet0 = trace.arrays["feet_pos"][0]
    out = {}
    for family, cfg in (("sampling", make_config("aliengo")),
                        ("nominal", make_config("aliengo", mpc_type="nominal"))):
        for mode in NODE_MODES:
            label = f"phase 30 {family} {mode}"
            r = node_run(cfg, mode, inputs, feet0, label)
            solves, got = r["solves"], r["launches"]
            k1a = got["K1a"]
            others = {k: v for k, v in got.items() if k != "K1a" and v}
            inline = mode in ("inline", "pipelined")
            if family == "sampling":
                ok = k1a == solves if inline else abs(k1a - solves) <= 1
            else:
                ok = k1a == 0
            if not ok or others or solves == 0 or (inline and solves != len(inputs)):
                raise AssertionError(f"{label}: {solves} solves, launches {got}")
            r["launches"] = k1a
            out[f"{family} {mode}"] = r
            log(f"{label}: ok; {json.dumps(r)}")
    out["bus"] = bus_latency()
    log(f"phase 30 (c): ok; {json.dumps(out['bus'])}")
    return out


# -- phases 31-35: the ZMP band, the pair grid, CEM above the key lists, swing-IK -------

ZMP_WEIGHT = 500.0  # the stone-field entry's (tests/test_closed_loop_walking.py:554)
ZMP_KNOBS = {"mpc.sampling.zmp_weight": ZMP_WEIGHT, "mpc.sampling.equilibrium_share": True}
# Phase 31's second weight-0 run: a margin that every ZMP point lies outside, so
# that the band, were any of it computed and kept, would move every two-stance cost.
OFF_MARGIN = -1.0
# The JAX package's SRB walks with the stone-field knobs on the CPU, 3 s at 0.3 m/s:
# (samples, strategy, terrain) -> (distance, min z, max |roll|,|pitch|);
# `python tests/test_torch_sampling_cases.py` (phase 32 prints them beside the card's).
JAX_CPU_ZMP_WALKS = {(2000, "blind", "flat"): (0.95, 0.3423, 0.0512),
                     (2000, "tamols", "step"): (0.8978, 0.3428, 0.1148),
                     (10_000, "blind", "flat"): (0.874, 0.3341, 0.0866),
                     (10_000, "tamols", "step"): (0.9064, 0.3314, 0.1189)}
# Phase 33's (horizon, splines) pairs: name -> (parametrization, H, splines); the
# last four (LONG_PAIRS) beyond the bound the kernels had before their basis windows.
PAIR_GRID = {"8-cubic-2": ("cubic_spline", 8, 2), "16-cubic-3": ("cubic_spline", 16, 3),
             "24-cubic-4": ("cubic_spline", 24, 4), "12-linear-4": ("linear_spline", 12, 4),
             "24-zero_order": ("zero_order", 24, 2), "32-cubic-2": ("cubic_spline", 32, 2),
             "40-cubic-8": ("cubic_spline", 40, 8), "48-zero_order": ("zero_order", 48, 2),
             "85-zero_order": ("zero_order", 85, 2)}
LONG_PAIRS = ("32-cubic-2", "40-cubic-8", "48-zero_order", "85-zero_order")
LONG_TICKS = 5  # phase 36: solve ticks of each entry point at each long pair
LONG_WALK = "32-cubic-2"  # phase 36's 3 s SRB walk, random sampling, N = 10 000
# The JAX package's walk of the same configuration on the CPU (distance, min z, max
# |roll|,|pitch|): `PYTHONPATH=. python tests/test_torch_harness.py horizon 32 0`.
# It walks short of the band's 0.45 m (the port's walk is held to half its distance).
JAX_CPU_LONG_WALK = (0.4263, 0.3115, 0.0731)
PAIR_N = 2000  # samples of phase 33's K1d, K1e and K1f checks (K1a-K1c at N_MAIN)
LARGE_ELITES = (33, 100, 1000)  # phase 34's CEM elite counts
SWING_STEPS = 300  # phase 35's scripted control steps
# Per sample and step, the band's operations: the ZMP point (~6) and six segment
# distances (~25 each with the clip and the square root).
ZMP_FLOPS_PER_STEP = 160
# Phase 31's band tolerance a sample: absolute, and relative to the sample's cost.
BAND_ATOL, BAND_RTOL = 1e-3, 2e-6


def zmp_tick(cfg, H):
    """Phase 31's solve: a trot (the diagonals stand in turn two steps each, a
    four-stance step between) with the base 5 cm off the diagonals' crossing, so
    that the two-stance ZMP leaves the band's margin."""
    from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
    from quadruped_pympc_tamols_torch.ops.sampling_kernel import TickInputs
    import torch

    seq = np.ones((4, H), np.float32)
    for n in range(H):
        if n % 5 in (1, 2):
            seq[[1, 2], n] = 0.0
        elif n % 5 in (3, 4):
            seq[[0, 3], n] = 0.0
    state12 = np.zeros(12, np.float32)
    state12[1:5] = 0.05, cfg.sim.ref_z - 0.03, 0.2, 0.05
    ref12 = np.zeros(12, np.float32)
    ref12[1:4] = 0.05, cfg.sim.ref_z, 0.3
    feet = np.array([[0.27, 0.16, 0], [0.27, -0.16, 0], [-0.25, 0.16, 0.05], [-0.25, -0.16, 0]],
                    np.float32)
    share = gravity_share(torch.from_numpy(seq), cfg.robot.mass)[:, None].expand(H, 4).numpy()
    return TickInputs(state12, feet, ref12, seq, np.ascontiguousarray(share))


def fleet_of(tick, S, rng, dev, nudge=0.01):
    """The single tick as S scenarios, each state and foot nudged by ``nudge``."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    return fl.FleetTick(
        t(np.repeat(tick.state12[None], S, 0) + nudge * rng.standard_normal((S, 12))),
        t(np.repeat(tick.feet[None], S, 0) + nudge * rng.standard_normal((S, 4, 3))),
        t(np.repeat(tick.ref12[None], S, 0)), t(np.repeat(tick.contact_seq[None], S, 0)),
        t(np.repeat(tick.share[None], S, 0)))


def band_of(costs, costs0, plain, plain0, label) -> dict:
    """The band as a kernel adds it (its costs at ZMP_WEIGHT less its costs at
    weight 0 on the same noise) against the plain version's band: each sample's
    to BAND_ATOL plus BAND_RTOL of that sample's plain cost (a few float32
    rounding steps of its running sum); the mean of those errors within a tenth of
    the mean tolerance (rounding of either sign averages out, a term off or left
    out does not); and the kernel's own band above 1e-3 on at least a hundredth of
    the samples. Returns its figures, each error beside its tolerance."""
    band, band_p = (costs - costs0).double().flatten(), (plain - plain0).double().flatten()
    gap = band - band_p
    tol = BAND_ATOL + BAND_RTOL * plain.double().abs().flatten()
    worst = int((gap.abs() / tol).argmax())
    r = {"band_worst_err": float(gap[worst]), "band_worst_tol": float(tol[worst]),
         "band_max_abs_err": float(gap.abs().max()), "band_mean_err": float(gap.mean()),
         "band_mean_tol": 0.1 * float(tol.mean()),
         "band_active_share": float((band > 1e-3).double().mean()),
         "band_active_share_plain": float((band_p > 1e-3).double().mean()),
         "band_max": float(band_p.max()), "band_mean": float(band_p.mean())}
    if not abs(r["band_worst_err"]) <= r["band_worst_tol"]:
        raise AssertionError(f"{label}: sample {worst}'s band is {r['band_worst_err']} off the "
                             f"plain one's (> {r['band_worst_tol']})")
    if not abs(r["band_mean_err"]) <= r["band_mean_tol"]:
        raise AssertionError(f"{label}: the band's mean error {r['band_mean_err']} exceeds "
                             f"{r['band_mean_tol']}")
    if not r["band_active_share"] >= max(1, band.numel() // 100) / band.numel():
        raise AssertionError(f"{label}: the kernel's band moved a share "
                             f"{r['band_active_share']} of the costs")
    return r


def off_bits(a, b, label) -> None:
    """Raise unless the outputs a and b (tuples of tensors or None) are bit-equal."""
    import torch
    for x, y in zip(a, b, strict=True):
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            raise AssertionError(f"{label}: the outputs at weight 0 depend on the band's margin")


def k1a_pass_us(plan, tick, inc, dev, passes=("rollout",)) -> dict:
    """K1a's passes through its C entry with the argument block built once."""
    import torch
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk

    lib = sk.load_library(plan.horizon, plan.params_per_leg)
    args = sk.kernel_args(plan, tick, 5, 0)
    costs_t = torch.empty(plan.num_samples, device=dev)
    out_t = torch.empty(sk.OUT_WINNER + plan.num_parameters, device=dev)
    argmin_t = torch.empty(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = lib.rs_launch(sk.ctypes.byref(args), plan.params_per_leg, plan.windows.data_ptr(),
                           inc.data_ptr(), None, None, costs_t.data_ptr(), argmin_t.data_ptr(),
                           out_t.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"rs_launch returned {rc}")

    return {"ms": time_cuda(launch), "passes": pass_profile(launch, 1, passes)}


def phase_zmp(dev, rng) -> dict:
    """Phase 31: every kernel with the ZMP band at weight 500 on the trot tick at
    N = 10 000 (P = 96) against its plain version, the band each adds against the
    plain band; K1d's chain bit-equal to its single iterations; every kernel's
    outputs at weight 0 bit-equal to its outputs at weight 0 with OFF_MARGIN (the
    band's inputs reach nothing where it is off); the rollout pass's device us with
    the band and without."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.sampling import group_operators
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    cfgs = {w: main_cfg(**{"mpc.sampling.zmp_weight": w}) for w in (ZMP_WEIGHT, 0.0)}
    cfgs["off"] = main_cfg(**{"mpc.sampling.zmp_weight": 0.0,
                              "mpc.sampling.zmp_margin": OFF_MARGIN})
    plans = {w: sk.make_rs_plan(c, N_MAIN, dev) for w, c in cfgs.items()}
    plan, plan0 = plans[ZMP_WEIGHT], plans[0.0]
    tick = zmp_tick(cfgs[0.0], plan.horizon)
    P = plan.num_parameters
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
    sigma = torch.as_tensor(rng.uniform(0.3, 4.0, P).astype(np.float32), device=dev)
    t = sk.tick_tensors(tick, dev)
    out = {}

    def plain_costs(p, noise):
        return sk.rollout_costs_reference(inc[:, None] + noise, p.W, *t, p.dts, p.q_diag, p.srbd,
                                          p.fm, p.zmp_weight, p.zmp_margin)

    # K1a, K1b, K1c on numpy noise.
    noise_rs = torch.as_tensor(numpy_noise(plan, rng), device=dev)
    res = [sk.sampling_rs(p, tick, inc, 0, 0, noise_in=noise_rs) for p in plans.values()]
    torch.cuda.synchronize()
    off_bits(res[1], res[2], "phase 31 K1a")
    errs, _ = check_against_plain(plan, tick, inc, noise_rs, *res[0], "phase 31 K1a")
    out["K1a"] = {**errs, **band_of(res[0][0], res[1][0], plain_costs(plan, noise_rs),
                                    plain_costs(plan0, noise_rs), "phase 31 K1a")}
    for method, short in (("mppi", "K1b"), ("cem_mppi", "K1c")):
        knobs = sm.make_knobs(cfgs[0.0], method)
        z = rng.standard_normal((P, N_MAIN)).astype(np.float32)
        noise = torch.as_tensor(z, device=dev) * (sigma[:, None] if knobs.cem
                                                  else knobs.sigma_mppi)
        noise[:, 0] = 0.0
        res = [sm.softmax_iteration(p, knobs, tick, inc, sigma, 0, 0, noise_in=noise)
               for p in plans.values()]
        torch.cuda.synchronize()
        off_bits(res[1], res[2], f"phase 31 {short}")
        errs = check_softmax(plan, knobs, tick, inc, noise, *res[0], f"phase 31 {short}")
        out[short] = {**errs, **band_of(res[0][0], res[1][0], plain_costs(plan, noise),
                                        plain_costs(plan0, noise), f"phase 31 {short}")}
    # K1d, MPPI x 3 and CEM x 3: the chain bit-equal to single iterations, the first
    # of which is held against the plain version on the noise it drew.
    for method, short in (("mppi", "K1d"), ("cem_mppi", "K1d_cem")):
        knobs = sm.make_knobs(cfgs[0.0], method)
        chains = {w: sm.sampling_chain(p, knobs, tick, inc, sigma, 7, 3, 3)
                  for w, p in plans.items()}
        dump = torch.empty(P, N_MAIN, device=dev)
        x, s = inc, sigma
        singles = []
        for it in range(3):
            r = sm.softmax_iteration(plan, knobs, tick, x, s, 7, 3 + it,
                                     noise_out=dump if it == 0 else None)
            if it == 0:
                torch.cuda.synchronize()
                errs = check_softmax(plan, knobs, tick, inc, dump, *r, f"phase 31 {short}")
                first_plain = plain_costs(plan, dump)
                first_plain0 = plain_costs(plan0, dump)
            singles.append(tuple(None if y is None else y.clone() for y in r))
            x, s = r[1][sk.OUT_WINNER:], r[2]
        torch.cuda.synchronize()
        off_bits([x for r in chains[0.0] for x in r], [x for r in chains["off"] for x in r],
                 f"phase 31 {short}")
        for a, b in zip(chains[ZMP_WEIGHT], singles):
            if not (torch.equal(a.costs, b[0]) and torch.equal(a.out, b[1])
                    and (not knobs.cem or torch.equal(a.sigma, b[2]))):
                raise AssertionError(f"phase 31 {short}: the chain differs from its single "
                                     "iterations")
        out[short] = {**errs, **band_of(chains[ZMP_WEIGHT][0].costs, chains[0.0][0].costs,
                                        first_plain, first_plain0, f"phase 31 {short}")}
    # K1e, each method, on numpy noise (each group's own contact columns).
    gcfgs = {w: gait_cfg("random_sampling", **{"mpc.sampling.zmp_weight": w})
             for w in (ZMP_WEIGHT, 0.0)}
    gcfgs["off"] = gait_cfg("random_sampling", **{"mpc.sampling.zmp_weight": 0.0,
                                                  "mpc.sampling.zmp_margin": OFF_MARGIN})
    gplans = {w: sg.make_group_plan(c, N_MAIN, dev) for w, c in gcfgs.items()}
    groups = group_operators(gcfgs[0.0], GAIT_PHASE, np.asarray(GAIT_FREQS, np.float32))
    g = [torch.as_tensor(x, device=dev) for x in (groups.contact, groups.share, groups.offsets)]
    n = gplans[0.0].num_used
    for method, short in (("random_sampling", "K1e-rs"), ("mppi", "K1e-mppi"),
                          ("cem_mppi", "K1e-cem")):
        knobs = sm.make_knobs(gcfgs[0.0], method)
        noise = torch.as_tensor(rng.standard_normal((P, n)).astype(np.float32), device=dev)
        noise = noise * (sigma[:, None] if knobs.cem else 3.0)
        noise[:, 0] = 0.0
        res = {w: sg.sampling_groups(gp, knobs, tick, groups, inc, sigma, 0, 0, noise_in=noise)
               for w, gp in gplans.items()}
        torch.cuda.synchronize()
        off_bits(res[0.0], res["off"], f"phase 31 {short}")
        errs = check_groups(gplans[ZMP_WEIGHT], knobs, tick, groups, inc, noise,
                            res[ZMP_WEIGHT], f"phase 31 {short}")
        plain = {w: sg.group_costs_reference(inc[:, None] + noise, groups.dense(dev), *g, t[0],
                                             t[1], t[2], gp.base.dts, gp.base.q_diag,
                                             gp.base.srbd, gp.base.fm, gp.base.zmp_weight,
                                             gp.base.zmp_margin)
                 for w, gp in gplans.items() if w != "off"}
        out[short] = {**errs, **band_of(res[ZMP_WEIGHT][0], res[0.0][0], plain[ZMP_WEIGHT],
                                        plain[0.0], f"phase 31 {short}")}
    # K1f, both layouts, four scenarios of 10 000 on numpy noise.
    S = 4
    ftick = fleet_of(tick, S, rng, dev)
    finc = inc.repeat(S, 1)
    fsig = sigma.repeat(S, 1)
    seeds = torch.arange(S, dtype=torch.int64, device=dev) + 11
    offsets = torch.zeros(S, dtype=torch.int64, device=dev)
    for method, short in (("random_sampling", "K1f-rs"), ("mppi", "K1f-mppi"),
                          ("cem_mppi", "K1f-cem")):
        knobs = sm.make_knobs(cfgs[0.0], method)
        noise = fleet_noise(plan, knobs, S, rng, dev)
        if knobs.cem:
            noise = noise * fsig[:, :, None]
        for layout, tag in ((fl.FOUR_LANE, ""), (fl.WIDE, "-wide")):
            res = {w: fleet_run(p, knobs, ftick, finc, fsig, seeds, offsets, layout, noise)[:4]
                   for w, p in plans.items()}
            off_bits(res[0.0], res["off"], f"phase 31 {short}{tag}")
            errs = fleet_check(plan, knobs, ftick, finc, fsig, noise, res[ZMP_WEIGHT],
                               f"phase 31 {short}{tag}")
            plain = {w: fl.fleet_iteration_reference(p, knobs, ftick, finc, fsig, noise).costs
                     for w, p in plans.items() if w != "off"}
            out[short + tag] = {**errs, **band_of(res[ZMP_WEIGHT][0], res[0.0][0],
                                                   plain[ZMP_WEIGHT], plain[0.0],
                                                   f"phase 31 {short}{tag}")}
    for short, r in out.items():
        log(f"phase 31 {short}: ok; weight 0 bit-equal at margin {OFF_MARGIN}; against the "
            f"plain version with the band {r}")
    # The rollout pass with the band and without (K1a's C entry, the same inputs).
    times = {w: k1a_pass_us(plans[w], tick, inc, dev) for w in (ZMP_WEIGHT, 0.0)}
    flops = iteration_flops(plan, basis_nnz(plan.windows[:, :4])) * N_MAIN
    bound = bound_ms(flops + N_MAIN * plan.horizon * ZMP_FLOPS_PER_STEP, 4 * (
        window_floats(plan) + P + N_MAIN + 26 + P))
    r = {"rollout_us_band": times[ZMP_WEIGHT]["passes"]["rollout"][1],
         "rollout_us_no_band": times[0.0]["passes"]["rollout"][1],
         "k1a_ms_band": times[ZMP_WEIGHT]["ms"], "k1a_ms_no_band": times[0.0]["ms"],
         "plain_ms_band": time_cuda(lambda: plain_on_device(plan, tick, inc, noise_rs), runs=20),
         "bound_ms_band": bound[0], "bound_by": bound[1], "kernels": out}
    log(f"phase 31: the rollout pass {r['rollout_us_band']:.2f} us with the band, "
        f"{r['rollout_us_no_band']:.2f} us without (torch.profiler, mean of 50); K1a "
        f"{r['k1a_ms_band']:.4f} / {r['k1a_ms_no_band']:.4f} ms; plain version with the band "
        f"{r['plain_ms_band']:.4f} ms; bound with the band {bound[0]:.5f} ms ({bound[1]})")
    return r


def zmp_walk(num_samples, strategy, terrain) -> dict:
    """Phase 32: the stone-field entry's sampling knobs (the ZMP band at 500,
    equilibrium_share, random sampling) walking the SRB harness on the card for
    WALK_S at WALK_VEL, blind or with TAMOLS sensing as phase 17 does; the launch
    counts zeroed just before and read just after (K1a once an MPC tick)."""
    import torch
    from quadruped_pympc_tamols_torch.planner import heightmap_from_fn
    from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness

    label = f"phase 32 N={num_samples} {strategy} {terrain}"
    cfg = main_cfg(**{**ZMP_KNOBS, "mpc.sampling.num_samples": num_samples,
                      "sim.visual_foothold_adaptation": strategy})
    fn = TAMOLS_WALKS.get((strategy, terrain), flat)
    h = SRBClosedLoopHarness(cfg, seed=0, terrain_fn=fn, device="cuda")
    tp = cfg.tamols
    n = int(round(WALK_S / cfg.sim.dt))
    hist = np.zeros((n, 12))
    reset_counts()
    t0 = time.perf_counter()
    for i in range(n):
        hms = None
        if h.wb.vfa is not None and not h.wb.vfa.initialized:
            ref = np.asarray(h.wb.frg.last_reference_footholds.data)
            hms = heightmap_from_fn(fn, ref[:, :2], np.full(4, h.x[8]), tp.heightmap_resolution,
                                    tp.heightmap_rows, tp.heightmap_cols, device="cuda")
        hist[i] = h.step(WALK_VEL, heightmaps=hms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    ticks = n // h._mpc_every
    dist, min_z, tilt, dz = walk_band(label, cfg, hist)
    check_counts(label, counts, counts_of(K1a=1), ticks)
    jax_row = JAX_CPU_ZMP_WALKS.get((num_samples, strategy, terrain), "not measured")
    log(f"{label}: ok; walked {dist:.4f} m, min z {min_z:.4f} m, max |roll|,|pitch| "
        f"{tilt:.4f} rad; JAX package on the CPU (distance, min z, max tilt): {jax_row}; "
        f"K1a {counts['K1a']} launches for {ticks} ticks; {wall / WALK_S:.3f} s wall per "
        "simulated s")
    return {"walked_m": dist, "min_z_m": min_z, "max_tilt_rad": tilt, "mean_z_minus_ref_m": dz,
            "launches": counts["K1a"], "ticks": ticks, "harness_s_per_sim_s": wall / WALK_S,
            "jax_cpu": jax_row}


def phase_zmp_walks() -> dict:
    return {f"N={n} {s} {t}": zmp_walk(n, s, t) for n, s, t in JAX_CPU_ZMP_WALKS}


def pair_cfg(name, **over):
    par, H, splines = PAIR_GRID[name]
    return main_cfg(par, **{"mpc.horizon": H, "mpc.sampling.num_splines": splines, **over})


def phase_pairs(dev, rng) -> dict:
    """Phase 33: the pair grid's libraries built cold, all together (each pair's
    seconds are its slowest nvcc process's); at each pair K1a, K1b and K1c at
    N = 10 000 against their plain versions with their times, passes and bounds,
    and K1d (MPPI x 3 and CEM x 3, bit-equal to single iterations), K1e (each
    method) and K1f (each method, both layouts, 2 scenarios) at PAIR_N against
    theirs. The pairs up to DRIFT_H run on phase 31's zmp_tick, the long ones on
    cost_checks.standing_trot_tick."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.sampling import group_operators
    from quadruped_pympc_tamols_torch.ops import build
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
    from quadruped_pympc_tamols_torch.ops.cost_checks import (DRIFT_H, MAX_SATURATED,
                                                              standing_trot_tick)

    pairs = {}
    for name in PAIR_GRID:
        p = sk.make_rs_plan(pair_cfg(name), 1, "cpu")
        pairs[name] = (p.horizon, p.params_per_leg)
    t0 = time.perf_counter()
    libs = build.build_all(tuple(pairs.values()))
    total = time.perf_counter() - t0
    build_s = {pair: max(build.nvcc_seconds(name, *pair) or 0.0 for name in build.SOURCES)
               for pair in pairs.values()}
    log(f"phase 33: the grid's {len(pairs) * len(build.SOURCES)} libraries built cold together "
        f"in {total:.1f} s; slowest nvcc a pair {build_s}")
    out = {}
    for name, pair in pairs.items():
        cfg = pair_cfg(name)
        plan = sk.make_rs_plan(cfg, N_MAIN, dev)
        long = plan.horizon > DRIFT_H
        tick = (standing_trot_tick if long else zmp_tick)(cfg, plan.horizon)
        P = plan.num_parameters
        inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
        sigma = torch.as_tensor(rng.uniform(0.3, 4.0, P).astype(np.float32), device=dev)
        # The plain version takes 0.16-0.39 s a call beyond H = 24: fewer timed runs.
        plain_runs = 5 if long else 20
        r = {"horizon": pair[0], "params_per_leg": pair[1], "P": P,
             "build_s": build_s[pair],
             "ptxas": {"rollout": ptxas_of(libs[("sampling_rs", *pair)].with_suffix(".log"),
                                           "rollout_kernel"),
                       "update": ptxas_of(libs[("sampling_softmax", *pair)].with_suffix(".log"),
                                          "sm_update_kernel"),
                       "chain": ptxas_of(libs[("sampling_chain", *pair)].with_suffix(".log"),
                                         *PTXAS_ENTRY["chain"])}}
        noise = torch.as_tensor(numpy_noise(plan, rng), device=dev)
        res = sk.sampling_rs(plan, tick, inc, 0, 0, noise_in=noise)
        torch.cuda.synchronize()
        r["K1a"], _ = check_against_plain(plan, tick, inc, noise, *res, f"phase 33 {name} K1a")
        k1a = k1a_pass_us(plan, tick, inc, dev, ("rollout", "extract"))
        r["K1a"].update(ms=k1a["ms"], passes=k1a["passes"], bound_ms=k1a_bound_ms(plan)[0],
                        bound_by=k1a_bound_ms(plan)[1],
                        plain_ms=time_cuda(lambda: plain_on_device(plan, tick, inc, noise),
                                           runs=plain_runs, warmup=2))
        for method, short in (("mppi", "K1b"), ("cem_mppi", "K1c")):
            knobs = sm.make_knobs(cfg, method)
            z = torch.as_tensor(rng.standard_normal((P, N_MAIN)).astype(np.float32), device=dev)
            z = z * (sigma[:, None] if knobs.cem else knobs.sigma_mppi)
            z[:, 0] = 0.0

            def call(knobs=knobs, z=z):
                return sm.softmax_iteration(plan, knobs, tick, inc, sigma, 0, 0, noise_in=z)

            res = call()
            torch.cuda.synchronize()
            e = check_softmax(plan, knobs, tick, inc, z, *res, f"phase 33 {name} {short}")
            t_ = sk.tick_tensors(tick, dev)
            b = softmax_bound_ms(plan, knobs)
            e.update(ms=time_cuda(call), passes=pass_profile(call, 1, ("rollout", "update")),
                     bound_ms=b[0], bound_by=b[1],
                     plain_ms=time_cuda(lambda knobs=knobs, z=z: sm.softmax_iteration_reference(
                         z, inc, plan.W, *t_, plan.dts, plan.q_diag, plan.srbd, plan.fm, knobs),
                         runs=plain_runs, warmup=2))
            r[short] = e
        small = sk.make_rs_plan(cfg, PAIR_N, dev)
        for method in ("mppi", "cem_mppi"):
            knobs = sm.make_knobs(cfg, method)
            chain = sm.sampling_chain(small, knobs, tick, inc, sigma, 7, 3, 3)
            x, s = inc, sigma
            for it, a in enumerate(chain):
                b = sm.softmax_iteration(small, knobs, tick, x, s, 7, 3 + it)
                torch.cuda.synchronize()
                if not (torch.equal(a.costs, b[0]) and torch.equal(a.out, b[1])):
                    raise AssertionError(f"phase 33 {name} K1d {method}: the chain differs "
                                         "from its single iterations")
                saturated = float((a.costs == sk.COST_SATURATION).double().mean())
                if long and not saturated <= MAX_SATURATED:
                    raise AssertionError(f"phase 33 {name} K1d {method}: {saturated} of "
                                         f"iteration {it}'s costs saturate")
                x, s = b[1][sk.OUT_WINNER:].clone(), b[2]
        r["K1d"] = "bit-equal to single iterations (MPPI x 3, CEM x 3)"
        gcfg = pair_cfg(name, **{"mpc.optimize_step_freq": True})
        gplan = sg.make_group_plan(gcfg, PAIR_N, dev)
        groups = group_operators(gcfg, GAIT_PHASE, np.asarray(gcfg.mpc.step_freq_available,
                                                              np.float32))
        for method in sm.METHODS:
            knobs = sm.make_knobs(gcfg, method)
            z = torch.as_tensor(rng.standard_normal((P, gplan.num_used)).astype(np.float32),
                                device=dev) * (sigma[:, None] if knobs.cem else 3.0)
            z[:, 0] = 0.0
            res = sg.sampling_groups(gplan, knobs, tick, groups, inc, sigma, 0, 0, noise_in=z)
            torch.cuda.synchronize()
            r[f"K1e {method}"] = check_groups(gplan, knobs, tick, groups, inc, z, res,
                                              f"phase 33 {name} K1e {method}")
        S = 2
        ftick = fleet_of(tick, S, rng, dev, 0.001 if long else 0.01)
        finc, fsig = inc.repeat(S, 1), sigma.repeat(S, 1)
        seeds = torch.arange(S, dtype=torch.int64, device=dev) + 5
        offsets = torch.zeros(S, dtype=torch.int64, device=dev)
        for method in sm.METHODS:
            knobs = sm.make_knobs(cfg, method)
            z = fleet_noise(small, knobs, S, rng, dev)
            if knobs.cem:
                z = z * fsig[:, :, None]
            for layout, tag in ((fl.FOUR_LANE, ""), (fl.WIDE, "-wide")):
                res = fleet_run(small, knobs, ftick, finc, fsig, seeds, offsets, layout, z)[:4]
                r[f"K1f {method}{tag}"] = fleet_check(small, knobs, ftick, finc, fsig, z, res,
                                                      f"phase 33 {name} K1f {method}{tag}")
        log(f"phase 33 {name} (H={pair[0]}, P_leg={pair[1]}, P={P}): ok; cold build "
            f"{r['build_s']:.1f} s; K1a {r['K1a']['ms']:.4f} ms (rollout "
            f"{r['K1a']['passes']['rollout'][1]:.2f} us, bound {r['K1a']['bound_ms']:.5f} ms, "
            f"plain {r['K1a']['plain_ms']:.4f} ms); K1b {r['K1b']['ms']:.4f} ms (update "
            f"{r['K1b']['passes']['update'][1]:.2f} us); K1c {r['K1c']['ms']:.4f} ms (update "
            f"{r['K1c']['passes']['update'][1]:.2f} us); K1d, K1e and K1f against their plain "
            "versions")
        out[name] = r
    return {"build_total_s": total, "pairs": out}


def phase_long_paths(dev, rng) -> dict:
    """Phase 36: the entry points at each of LONG_PAIRS, each driven with the launch
    counts zeroed just before and read just after: SamplingMPC with random sampling
    (K1a) and MPPI x 3 (K1d), GaitAdaptiveSamplingMPC with MPPI (K1e), LONG_TICKS
    ticks each at N = 10 000 on cost_checks.standing_trot_tick with finite
    summaries; the fleet solve for 2 scenarios of PAIR_N samples (K1f four-lane,
    random sampling) and 4 of 10 000 (K1f large-batch, MPPI) at rest, finite
    outputs, at most MAX_SATURATED of the costs saturated; the sharded solve at world size 1 (NCCL,
    its own group) with MPPI (K1b), its best parameters bit-equal to the single
    iteration's on the same noise. Then the 3 s SRB walk at LONG_WALK, random
    sampling, N = 10 000 (K1a once a tick), upright and at least half as far as
    JAX_CPU_LONG_WALK."""
    import torch
    import torch.distributed as dist
    from quadruped_pympc_tamols_torch.controllers.sampling import (FleetSamplingState,
                                                                   GaitAdaptiveSamplingMPC,
                                                                   SamplingMPC, SamplingState,
                                                                   make_fleet_sampling_solver)
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
    from quadruped_pympc_tamols_torch.ops.cost_checks import MAX_SATURATED, standing_trot_tick
    from quadruped_pympc_tamols_torch.ops.sampling_kernel import COST_SATURATION
    from quadruped_pympc_tamols_torch.parallel import (find_free_port, init_multihost,
                                                       make_sharded_sampling_solver,
                                                       scenario_mesh)

    init_multihost(f"127.0.0.1:{find_free_port()}", 1, 0, device="cuda")
    mesh = scenario_mesh(1, 1)
    out = {}
    for name in LONG_PAIRS:
        par, H, splines = PAIR_GRID[name]
        r, label = {}, f"phase 36 {name}"

        def cfg_of(**over):
            return pair_cfg(name, **over)

        tick = standing_trot_tick(cfg_of(), H)
        for key, mpc in (("K1a", SamplingMPC(cfg_of(), device="cuda")),
                         ("K1d_mppi", SamplingMPC(cfg_of(**{"mpc.sampling.method": "mppi",
                                                            "mpc.sampling.num_iterations": 3}),
                                                  device="cuda")),
                         ("K1e_mppi", GaitAdaptiveSamplingMPC(cfg_of(**{
                             "mpc.optimize_step_freq": True, "mpc.sampling.method": "mppi"}),
                             device="cuda"))):
            r[key] = tick_loop(mpc, tick, f"{label} {type(mpc).__name__} {key}",
                               counts_of(**{key: 1}), n=LONG_TICKS)[key]
        for method, S, N in (("random_sampling", 2, PAIR_N), ("mppi", 4, N_MAIN)):
            fcfg = cfg_of(**{"mpc.sampling.method": method})
            _, ftick, inc, sigma, seeds, offsets = fleet_inputs(fcfg, S, N, dev, rng, rest=True)
            solve, _ = make_fleet_sampling_solver(fcfg, N, device="cuda")
            key = {"random_sampling": "K1f_rs", "mppi": "K1f_mppi"}[method]
            key += "_wide" if fl.fleet_layout(S, N) & fl.WIDE else ""
            ones = torch.ones(S, 4, device=dev)
            reset_counts()
            res, st = solve(ftick.state12, ftick.feet, ftick.ref12, ftick.feet,
                            ftick.contact_seq, ones, ones,
                            FleetSamplingState(inc, sigma, seeds, offsets))
            torch.cuda.synchronize()
            check_counts(f"{label} fleet {method}", read_counts(), counts_of(**{key: 1}), 1)
            if not all(bool(torch.isfinite(x).all()) for x in (res.grfs, res.predicted_state,
                                                               st.best_parameters)):
                raise AssertionError(f"{label} fleet {method}: non-finite outputs")
            saturated = float((res.costs == COST_SATURATION).double().mean())
            if not (saturated <= MAX_SATURATED and bool((res.best_cost < COST_SATURATION).all())):
                raise AssertionError(f"{label} fleet {method}: {saturated} of the costs saturate, "
                                     f"best costs {res.best_cost.tolist()}")
            r[key] = 1
        scfg = cfg_of(**{"mpc.sampling.method": "mppi"})
        knobs = sm.make_knobs(scfg)
        solve, P = make_sharded_sampling_solver(scfg, mesh, N_MAIN, "mppi")
        inc = torch.as_tensor(0.3 * rng.standard_normal(P).astype(np.float32), device=dev)
        sigma = torch.full((P,), scfg.mpc.sampling.sigma_cem_mppi, device=dev)
        noise, _ = sharded_noise(scfg, knobs, rng, dev, sigma, 1)
        reset_counts()
        grfs, st, best = solve(tick.state12, tick.feet, tick.ref12, tick.contact_seq,
                               SamplingState(inc, 21, 4, sigma), noise=noise)
        torch.cuda.synchronize()
        check_counts(f"{label} sharded", read_counts(), counts_of(K1b=1), 1)
        ref = single_iteration(solve.plan, knobs, tick, inc, sigma, 21, 4, noise)
        if not (torch.equal(best, ref[1][0:1]) and torch.equal(st.best_parameters, ref[1][26:])):
            raise AssertionError(f"{label} sharded: off the single iteration")
        r["K1b_sharded"] = 1
        out[name] = {"horizon": H, "launches": r}
        log(f"{label} (H={H}, {par}, {splines} splines): ok; SamplingMPC (random sampling, "
            f"MPPI x 3), GaitAdaptiveSamplingMPC, the fleet solve (both layouts) and the "
            f"sharded solve on the card; launches {r}")
    dist.destroy_process_group()
    counts, wall, (dist_m, min_z, tilt) = walk(pair_cfg(LONG_WALK), f"phase 36 walk {LONG_WALK}",
                                               counts_of(K1a=1), 0.5 * JAX_CPU_LONG_WALK[0])
    out["walk"] = {"pair": LONG_WALK, "distance": dist_m, "min_z": min_z, "max_tilt": tilt,
                   "launches": counts["K1a"], "harness_s_per_sim_s": wall / WALK_S,
                   "jax_cpu": JAX_CPU_LONG_WALK}
    log(f"phase 36 walk {LONG_WALK}: JAX package on the CPU (distance, min z, max "
        f"|roll|,|pitch|): {JAX_CPU_LONG_WALK}")
    return out


def phase_large_k(dev, rng) -> dict:
    """Phase 34: CEM with K = 33, 100 and 1000 of N = 10 000 on K1c, K1d (CEM x 3),
    K1e-cem (three groups of 3333) and K1f (two scenarios, both layouts, and the
    large-batch one drawing its noise again): costs against the plain rollout, the
    elite set equal to the plain selection's on the kernel's own costs
    (``elites_match``), sigma within its tolerance; the update pass's device us."""
    import torch
    from quadruped_pympc_tamols_torch.controllers.sampling import group_operators
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    out = {}
    for K in LARGE_ELITES:
        cfg = main_cfg(**{"mpc.sampling.method": "cem_mppi", "mpc.sampling.cem_elite": K})
        plan = sk.make_rs_plan(cfg, N_MAIN, dev)
        knobs = sm.make_knobs(cfg)
        tick = example_tick(cfg, plan)
        P = plan.num_parameters
        inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
        sigma = torch.as_tensor(rng.uniform(0.3, 4.0, P).astype(np.float32), device=dev)
        z = torch.as_tensor(rng.standard_normal((P, N_MAIN)).astype(np.float32), device=dev)
        z = z * sigma[:, None]
        z[:, 0] = 0.0

        def call(z=z, plan=plan, knobs=knobs, tick=tick, inc=inc, sigma=sigma):
            return sm.softmax_iteration(plan, knobs, tick, inc, sigma, 0, 0, noise_in=z)

        res = call()
        torch.cuda.synchronize()
        r = {"K1c": check_softmax(plan, knobs, tick, inc, z, *res, f"phase 34 K={K} K1c")}
        t_ = sk.tick_tensors(tick, dev)
        b = softmax_bound_ms(plan, knobs)
        r["K1c"].update(passes=pass_profile(call, 1, ("rollout", "update")), ms=time_cuda(call),
                        bound_ms=b[0], bound_by=b[1], plain_ms=time_cuda(
                            lambda: sm.softmax_iteration_reference(
                                z, inc, plan.W, *t_, plan.dts, plan.q_diag, plan.srbd, plan.fm,
                                knobs), runs=20))
        chain = sm.sampling_chain(plan, knobs, tick, inc, sigma, 7, 3, 3)
        x, s = inc, sigma
        for it, a in enumerate(chain):
            b = sm.softmax_iteration(plan, knobs, tick, x, s, 7, 3 + it)
            torch.cuda.synchronize()
            if not (torch.equal(a.costs, b[0]) and torch.equal(a.out, b[1])
                    and torch.equal(a.sigma, b[2]) and torch.equal(a.elites, b[3])):
                raise AssertionError(f"phase 34 K={K} K1d: the chain differs from its single "
                                     "iterations")
            x, s = b[1][sk.OUT_WINNER:].clone(), b[2]
        r["K1d"] = "bit-equal to three single iterations"
        gcfg = gait_cfg("cem_mppi", **{"mpc.sampling.cem_elite": K})
        gplan = sg.make_group_plan(gcfg, N_MAIN, dev)
        groups = group_operators(gcfg, GAIT_PHASE, np.asarray(GAIT_FREQS, np.float32))
        gz = z[:, :gplan.num_used].contiguous()
        res = sg.sampling_groups(gplan, knobs, tick, groups, inc, sigma, 0, 0, noise_in=gz)
        torch.cuda.synchronize()
        r["K1e-cem"] = check_groups(gplan, knobs, tick, groups, inc, gz, res,
                                    f"phase 34 K={K} K1e-cem")
        S = 2
        ftick = fleet_of(tick, S, rng, dev)
        finc, fsig = inc.repeat(S, 1), sigma.repeat(S, 1)
        seeds = torch.arange(S, dtype=torch.int64, device=dev) + 5
        offsets = torch.zeros(S, dtype=torch.int64, device=dev)
        fz = fleet_noise(plan, knobs, S, rng, dev) * fsig[:, :, None]
        for layout, tag in ((fl.FOUR_LANE, "K1f-cem"), (fl.WIDE, "K1f-cem-wide")):
            res = fleet_run(plan, knobs, ftick, finc, fsig, seeds, offsets, layout, fz)[:4]
            r[tag] = fleet_check(plan, knobs, ftick, finc, fsig, fz, res, f"phase 34 K={K} {tag}")
        res = fleet_run(plan, knobs, ftick, finc, fsig, seeds, offsets, fl.LARGE_BATCH,
                        keep_noise=True)
        r["K1f-cem-regen"] = fleet_check(plan, knobs, ftick, finc, fsig, res[5], res[:4],
                                         f"phase 34 K={K} K1f-cem-regen")
        log(f"phase 34 K={K}: ok; elite sets equal to the plain selection's on K1c, K1e-cem "
            f"and K1f (three layouts), K1d bit-equal; sigma error K1c "
            f"{r['K1c']['sigma']:.2e}; K1c {r['K1c']['ms']:.4f} ms, update pass "
            f"{r['K1c']['passes']['update'][1]:.2f} us (torch.profiler), bound "
            f"{r['K1c']['bound_ms']:.5f} ms, plain version {r['K1c']['plain_ms']:.4f} ms")
        out[K] = r
    return out


def swing_script(k):
    """Control step k's inputs of tests/test_torch_swing_ik.py:scripted."""
    period = (0.35 + 0.01 * np.arange(4)).astype(np.float32)
    t = np.mod(0.002 * k + np.array([0.0, 0.17, 0.17, 0.0]), period).astype(np.float32)
    lift_off = np.array([[0.3, 0.15, 0.0], [0.3, -0.15, 0.01], [-0.2, 0.15, 0.0],
                         [-0.2, -0.15, 0.02]], np.float32)
    lift_off[:, 0] += np.float32(0.001 * k)
    touch_down = (lift_off + [0.1, 0.0, 0.03]).astype(np.float32)
    mask = (np.mod(k // 60 + np.arange(4), 2) == 0).astype(np.float32)
    base = np.array([0.05 + 0.001 * k, 0.0, 0.33], np.float32)
    rpy = np.array([0.02 * np.sin(0.05 * k), 0.03 * np.cos(0.03 * k), 0.01 * k], np.float32)
    return (t, period, np.full(4, 0.08, np.float32), lift_off, touch_down, mask,
            (lift_off + 0.01).astype(np.float32), base, rpy)


def phase_swing_ik() -> dict:
    """Phase 35: gait.make_swing_ik_step on the card (one CUDA graph a call) against
    the same step on the CPU over SWING_STEPS scripted steps, both generators, to
    float32 tolerance (positions 1e-6 m, velocities 1e-5, accelerations 1e-4,
    joints 1e-5 rad, as tests/test_torch_swing_ik.py holds the CPU to JAX); its
    host ms a call with the joints read back (the counterpart of BENCH_r05's
    wb_swing_ik_tick_ms)."""
    import torch
    from quadruped_pympc_tamols_torch.gait import make_swing_ik_step

    robot = main_cfg().robot
    out = {}
    for gen in ("bezier_ref", "explicit"):
        card, cpu = make_swing_ik_step(robot, gen, "cuda"), make_swing_ik_step(robot, gen, "cpu")
        worst = [0.0] * 4
        for k in range(SWING_STEPS):
            x = [torch.from_numpy(a) for a in swing_script(k)]
            got = [y.cpu() for y in card(*x)]
            want = cpu(*x)
            for i, tol in enumerate((1e-6, 1e-5, 1e-4, 1e-5)):
                err = float((got[i] - want[i]).abs().max())
                worst[i] = max(worst[i], err)
                if not err <= tol + 1e-5 * float(want[i].abs().max()):
                    raise AssertionError(f"phase 35 {gen}: output {i} off the CPU by {err}")
        inputs = [torch.from_numpy(a).pin_memory() for a in swing_script(7)]
        ms = []
        for k in range(SWING_STEPS):
            t0 = time.perf_counter()
            card(*inputs)[3].cpu()
            ms.append((time.perf_counter() - t0) * 1e3)
        r = {"max_abs_err": dict(zip(("pos", "vel", "acc", "q"), worst)),
             "host_ms_a_call": statistics.median(ms), "host_ms_p99": float(np.percentile(ms, 99)),
             "captures": card.captures, "replays": card.replays}
        if card.captures != 1:
            raise AssertionError(f"phase 35 {gen}: {card.captures} captures")
        log(f"phase 35 {gen}: ok; card against the CPU over {SWING_STEPS} steps {r['max_abs_err']};"
            f" {r['host_ms_a_call']:.4f} ms host clock a call with the joints read back (median, "
            f"p99 {r['host_ms_p99']:.4f}); one graph, {card.replays} replays")
        out[gen] = r
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import quadruped_pympc_tamols_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}", file=sys.stderr)
        return 2
    from quadruped_pympc_tamols_torch.controllers.sampling import (GaitAdaptiveSamplingMPC,
                                                                   SamplingMPC)
    from quadruped_pympc_tamols_torch.ops import build
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
    from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    libs = build.build_all()
    for H, P_leg in build.MAIN_PAIRS:
        sk.load_library(H, P_leg)
        sm.load_library(H, P_leg)
        sm.load_chain_library(H, P_leg)
        sg.load_library(H, P_leg)
        fl.load_library(H, P_leg)
    log(f"build: {len(libs)} libraries ({len(build.SOURCES)} sources x (H, P_leg) in "
        f"{list(build.MAIN_PAIRS)}) in {time.perf_counter() - t0:.1f} s (one nvcc per "
        f"source and pair, started together)")
    for (name, H, P_leg), lib_path in libs.items():
        for line in lib_path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas {name} H={H} P_leg={P_leg}: {line.strip()}")

    t_lap = [time.perf_counter(), "phases 1-2"]

    def lap(next_group):
        """Log the seconds the group of phases that ends here took."""
        now = time.perf_counter()
        log(f"time: {t_lap[1]}: {now - t_lap[0]:.1f} s")
        t_lap[:] = [now, next_group]

    # -- phases 1-2: K1a against its plain version, same noise; Philox noise ------------
    rng = np.random.default_rng(0)
    cfg = main_cfg()
    plan = sk.make_rs_plan(cfg, N_MAIN, dev)
    tick = example_tick(cfg, plan)
    errs_rs = {MAIN_PAR: phase_rs(dev, rng)}

    lap("phase 3")
    # -- phase 3: the first slice's path ----------------------------------------------
    counts_rs, wall, _ = walk(cfg, "phase 3", counts_of(K1a=1))
    log(f"phase 3: JAX package on the CPU (distance, min z, max |roll|,|pitch|): "
        f"{JAX_CPU_WALKS['random_sampling x 1']}")

    lap("phase 4")
    # -- phase 4: times of K1a --------------------------------------------------------
    t_rs = {MAIN_PAR: rs_times(dev, rng)}
    mpc = SamplingMPC(cfg, device="cuda")
    tick_med = solve_tick_ms(mpc, tick)
    log(f"phase 4: profile of 50 solve ticks: {profile_ticks(mpc, tick)}")
    log(f"phase 4: solve tick with host glue {tick_med:.4f} ms (median of 200); harness "
        f"{wall / WALK_S:.3f} s wall per simulated s")

    lap("phases 5-6")
    # -- phases 5-6: K1b, K1c and K1d against their plain version ---------------------
    errs_sm = {MAIN_PAR: phase_softmax(dev, rng)}
    chain_err = {MAIN_PAR: phase_chain(dev, rng)}

    lap("phase 7")
    # -- phase 7: MPPI x 3 on the chain kernel, MPPI x 1 on K1b -------------------------
    mcfg = softmax_cfg("mppi")
    counts_mppi, wall_mppi, _ = walk(mcfg, "phase 7", counts_of(K1d_mppi=1))
    log(f"phase 7: JAX package on the CPU: {JAX_CPU_WALKS['mppi x 3']}")
    # One device-to-host copy and one chain kernel a tick; no memset, and no
    # launch of the single iterations' kernels.
    prof = profile_ticks(SamplingMPC(mcfg, device="cuda"), tick, expect={PASSES["chain"]: 1},
                         d2h=1, absent=("Memset", PASSES["rollout"], PASSES["update"]))
    log(f"phase 7: profile of 50 MPPI x 3 solve ticks: {prof}")
    counts_k1b = tick_loop(SamplingMPC(softmax_cfg("mppi", iterations=1), device="cuda"), tick,
                           "phase 7 mppi x 1", counts_of(K1b=1))

    lap("phase 8")
    # -- phase 8: CEM-MPPI closed loop; CEM-MPPI x 1 on K1c ----------------------------
    counts_cem, _ = cem_loop(softmax_cfg("cem_mppi"), "phase 8", counts_of(K1d_cem=1),
                             JAX_CPU_WALKS["cem_mppi x 3"])
    counts_k1c = tick_loop(SamplingMPC(softmax_cfg("cem_mppi", iterations=1), device="cuda"),
                           tick, "phase 8 cem_mppi x 1", counts_of(K1c=1))

    lap("phase 9")
    # -- phase 9: times of K1b, K1c, K1d ------------------------------------------------
    t9 = {MAIN_PAR: phase_softmax_times(dev, rng)}

    lap("phase 10")
    # -- phase 10: K1e against its plain version ---------------------------------------
    errs_g = {MAIN_PAR: phase_groups(dev, rng)}

    lap("phase 11")
    # -- phase 11: this slice's path, gait-adaptive sampling ---------------------------
    walks = {}
    for method, key in (("random_sampling", "K1e_rs"), ("mppi", "K1e_mppi")):
        walks[method] = walk(gait_cfg(method), f"phase 11 {method}", counts_of(**{key: 1}))
        log(f"phase 11 {method}: JAX package on the CPU (distance, min z, max |roll|,|pitch|): "
            f"{JAX_CPU_WALKS['gait ' + method]}")
    counts_gcem, _ = cem_loop(gait_cfg("cem_mppi"), "phase 11 cem_mppi", counts_of(K1e_cem=1),
                              JAX_CPU_WALKS["gait cem_mppi"])
    prof = profile_ticks(GaitAdaptiveSamplingMPC(gait_cfg("random_sampling"), device="cuda"),
                         tick, d2h=1)
    log(f"phase 11: profile of 50 gait-adaptive solve ticks: {prof}")

    lap("phase 12")
    # -- phase 12: times of K1e ---------------------------------------------------------
    t12 = {MAIN_PAR: phase_group_times(dev, rng)}

    # Launches of each row on its path: (short name, parametrization) -> count.
    launches = {("K1a", MAIN_PAR): counts_rs["K1a"], ("K1b", MAIN_PAR): counts_k1b["K1b"],
                ("K1c", MAIN_PAR): counts_k1c["K1c"], ("K1d", MAIN_PAR): counts_mppi["K1d_mppi"],
                ("K1d_cem", MAIN_PAR): counts_cem["K1d_cem"],
                ("K1e-rs", MAIN_PAR): walks["random_sampling"][0]["K1e_rs"],
                ("K1e-mppi", MAIN_PAR): walks["mppi"][0]["K1e_mppi"],
                ("K1e-cem", MAIN_PAR): counts_gcem["K1e_cem"]}

    lap("phase 13")
    # -- phase 13: the other parametrizations' kernels against their plain versions ----
    for par in NEW_PARS:
        errs_rs[par] = phase_rs(dev, rng, par, "phase 13")
        errs_sm[par] = phase_softmax(dev, rng, par, "phase 13")
        chain_err[par] = phase_chain(dev, rng, par, "phase 13")
        errs_g[par] = phase_groups(dev, rng, par, "phase 13")

    lap("phase 14")
    # -- phase 14: their paths ----------------------------------------------------------
    # The walks whose JAX reference walks (random sampling x 1 with each, MPPI x 3
    # with zero-order holds); every other method through its controller on the
    # flagship inputs, TICK_LOOP ticks.
    for par in NEW_PARS:
        c, _, _ = walk(main_cfg(par), f"phase 14 random_sampling x 1 {par}", counts_of(K1a=1))
        log(f"phase 14 random_sampling x 1 {par}: JAX package on the CPU: "
            f"{JAX_CPU_WALKS['random_sampling x 1 ' + par]}")
        launches[("K1a", par)] = c["K1a"]
    c, _, _ = walk(softmax_cfg("mppi", "zero_order"), "phase 14 mppi x 3 zero_order",
                   counts_of(K1d_mppi=1))
    log(f"phase 14 mppi x 3 zero_order: JAX package on the CPU: "
        f"{JAX_CPU_WALKS['mppi x 3 zero_order']}")
    launches[("K1d", "zero_order")] = c["K1d_mppi"]
    c = tick_loop(SamplingMPC(softmax_cfg("mppi", "linear_spline"), device="cuda"), tick,
                  "phase 14 mppi x 3 linear_spline", counts_of(K1d_mppi=1))
    launches[("K1d", "linear_spline")] = c["K1d_mppi"]
    for par in NEW_PARS:
        c = tick_loop(SamplingMPC(softmax_cfg("cem_mppi", par), device="cuda"), tick,
                      f"phase 14 cem_mppi x 3 {par}", counts_of(K1d_cem=1))
        launches[("K1d_cem", par)] = c["K1d_cem"]
        for method, short in (("mppi", "K1b"), ("cem_mppi", "K1c")):
            c = tick_loop(SamplingMPC(softmax_cfg(method, par, iterations=1), device="cuda"),
                          tick, f"phase 14 {method} x 1 {par}", counts_of(**{short: 1}))
            launches[(short, par)] = c[short]
        for method, key in (("random_sampling", "K1e_rs"), ("mppi", "K1e_mppi"),
                            ("cem_mppi", "K1e_cem")):
            c = tick_loop(GaitAdaptiveSamplingMPC(gait_cfg(method, par), device="cuda"), tick,
                          f"phase 14 gait {method} {par}", counts_of(**{key: 1}))
            launches[("K1e-" + key[4:], par)] = c[key]

    lap("phase 15")
    # -- phase 15: their times ----------------------------------------------------------
    for par in NEW_PARS:
        t_rs[par] = rs_times(dev, rng, par, "phase 15")
        t9[par] = phase_softmax_times(dev, rng, par, "phase 15")
        t12[par] = phase_group_times(dev, rng, par, "phase 15")

    lap("phase 16")
    # -- phase 16: the TAMOLS scorer on the card against the CPU; its cost a call ------
    scorer = phase_scorer(dev, rng)

    lap("phase 17")
    # -- phase 17: the default configuration's walks with TAMOLS / "height" ------------
    tamols_walks = {f"{st} {ter}": tamols_walk(st, ter, fn, scorer[st]["launches_per_call"])
                    for (st, ter), fn in TAMOLS_WALKS.items()}

    lap("phase 18")
    # -- phase 18: the torque path and the wrapper on the recorded MuJoCo loop --------
    torque = phase_wrapper(phase_torque_trace())

    lap("phases 19-21")
    # -- phases 19-21: the gradient family's nominal RTI-SQP ----------------------------
    gradient = {"solve": phase_gradient_solve(), "ladder": phase_gradient_ladder(),
                **phase_gradient_walks()}

    lap("phases 22-24")
    # -- phases 22-24: the variant core and the DDP solver -------------------------------
    variants = {"solves": phase_variant_solves(), "ddp": phase_ddp(), **phase_variant_walks()}

    lap("phases 25-27")
    # -- phases 25-27: the scenario fleet on K1f -----------------------------------------
    fleet_k = phase_fleet_kernels(dev, rng, libs)
    fleet_walks = phase_fleet_walks()
    fleet_tp = phase_fleet_throughput()

    lap("phases 28-30")
    # -- phases 28-30: the sharded solver, the multi-chip fleet step, the runtime --------
    knob_errs = phase_knobs(dev, rng)
    sharded = phase_sharded(dev, rng, {"random_sampling": tick_med,
                                       "mppi": t9[MAIN_PAR]["mppi"]["tick1_ms"],
                                       "cem_mppi": t9[MAIN_PAR]["cem_mppi"]["tick1_ms"]})
    gloo = phase_gloo()
    multichip = phase_multichip(fleet_tp)
    nodes = phase_nodes()

    lap("phase 31")
    # -- phases 31-35: the ZMP band, the pair grid, CEM above 32 elites, swing-IK -------
    zmp = phase_zmp(dev, rng)
    lap("phase 32")
    zmp_walks = phase_zmp_walks()
    lap("phase 33")
    pair_grid = phase_pairs(dev, rng)
    lap("phase 34")
    large_k = phase_large_k(dev, rng)
    lap("phase 35")
    swing_ik = phase_swing_ik()
    lap("phase 36")
    long_paths = phase_long_paths(dev, rng)

    def row(name, source, short, par, err, ms, plain, bound, passes, **extra):
        return {"name": f"{name} ({short}{PAR_SUFFIX[par]})", "route": "cuda",
                "source": f"quadruped_pympc_tamols_torch/ops/csrc/{source}.cu",
                "replaces": "quadruped_pympc_tamols_tpu/ops/rollout_pallas.py:818",
                "launches": launches[(short, par)], "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
                "library_ms": None, "parametrization": par, **extra, "_passes": passes}

    kernels = []
    for par in (MAIN_PAR, *NEW_PARS):
        e, r = errs_rs[par], t_rs[par]
        is_main = par == MAIN_PAR
        kernels.append(row("sampling_rs", "sampling_rs", "K1a", par, e["cost"], r["ms"],
                           r["plain_ms"], r["bound"], r["passes"], grf_max_abs_err=e["grf"],
                           state_max_abs_err=e["state"],
                           **({"solve_tick_ms": tick_med, "harness_s_per_sim_s": wall / WALK_S,
                               "launches_tamols_walks": {k: w["launches"]["K1a"]
                                                         for k, w in tamols_walks.items()},
                               "launches_wrapper_replay": torque["counted"]["launches"]["K1a"]}
                              if is_main else {})))
        for method, short in (("mppi", "K1b"), ("cem_mppi", "K1c")):
            e, r = errs_sm[par][method], t9[par][method]
            extra = {"sigma_max_abs_err": e["sigma"]} if "sigma" in e else {}
            kernels.append(row(f"softmax_iteration, {method}", "sampling_softmax", short, par,
                               e["cost"], r["ms"], r["plain_ms"], r["bound"], r["passes"],
                               params_max_abs_err=e["params"], solve_tick_ms=r["tick1_ms"],
                               update_blocks_per_sm=r["blocks_per_sm"], **extra))
        # K1d, the chain kernel: its launches on the MPPI x 3 path (one a tick); its
        # ms is sampling_chain's, wrapper included; beside it the successive single
        # iterations that chained before it, and the CEM x 3 and random sampling x 3
        # chains.
        r, rc, rr = t9[par]["mppi"], t9[par]["cem_mppi"], t9[par]["random_sampling"]
        kernels.append(row("sampling_chain, MPPI x 3", "sampling_chain", "K1d", par,
                           chain_err[par], r["chain_ms"], r["chain_plain_ms"], r["chain_bound"],
                           r["chain_passes"], ms_c_entry_prebuilt_args=r["chain_prebuilt_ms"],
                           successive_single_launches_ms=r["successive_ms"],
                           successive_single_launches_prebuilt_ms=r["successive_prebuilt_ms"],
                           chain_blocks_per_sm=r["chain_blocks_per_sm"],
                           solve_tick_ms=r["tick_ms"],
                           cem_x3={"launches": launches[("K1d_cem", par)], "ms": rc["chain_ms"],
                                   "ms_c_entry_prebuilt_args": rc["chain_prebuilt_ms"],
                                   "chain_kernel_us": rc["chain_passes"]["chain"][1],
                                   "successive_single_launches_ms": rc["successive_ms"],
                                   "solve_tick_ms": rc["tick_ms"],
                                   "chain_blocks_per_sm": rc["chain_blocks_per_sm"],
                                   "bound_ms": rc["chain_bound"][0]},
                           random_sampling_x3={
                               "ms": rr["chain_ms"], "ms_c_entry_prebuilt_args":
                               rr["chain_prebuilt_ms"],
                               "chain_kernel_us": rr["chain_passes"]["chain"][1],
                               "successive_single_launches_ms": rr["successive_ms"],
                               "chain_blocks_per_sm": rr["chain_blocks_per_sm"],
                               "bound_ms": rr["chain_bound"][0]},
                           **({"harness_s_per_sim_s": wall_mppi / WALK_S} if is_main else {})))
        for method, short in (("random_sampling", "K1e-rs"), ("mppi", "K1e-mppi"),
                              ("cem_mppi", "K1e-cem")):
            r, e = t12[par][method], errs_g[par][method]
            extra = {f"{k}_max_abs_err": e[k] for k in ("grf", "state", "params", "sigma")
                     if k in e}
            if is_main and method in walks:
                extra["harness_s_per_sim_s"] = walks[method][1] / WALK_S
            kernels.append(row(f"sampling_groups, {method}", "sampling_groups", short, par,
                               e["cost"], r["ms"], r["plain_ms"], r["bound"], r["passes"],
                               ms_through_wrapper=r["wrapper_ms"], solve_tick_ms=r["tick_ms"],
                               host_group_operators_us=r["operators_us"], **extra))
    # The kernels of each row: device time a launch and the ptxas report of the
    # kernel in the row's library (K1d: the chain kernel's MPPI/CEM instantiation).
    for r in kernels:
        p = sk.make_rs_plan(main_cfg(r["parametrization"]), 1, "cpu")
        lib = libs[(r["source"].rsplit("/", 1)[1][:-3], p.horizon, p.params_per_leg)]
        for pass_name, (kname, us) in r.pop("_passes").items():
            ptx = ptxas_of(lib.with_suffix(".log"), *PTXAS_ENTRY[pass_name])
            r[f"{pass_name}_kernel_us"] = us
            r[f"{pass_name}_ptxas"] = ptx
            log(f"{pass_name} pass of {r['name']}: {kname} {us:.2f} us a launch (torch.profiler, "
                f"mean of 50 calls); ptxas: {ptx}")
        if not r["launches"] > 0:
            raise AssertionError(f"{r['name']}: no launch on its path")
    kernels += fleet_rows(fleet_k, fleet_walks)
    # Phases 28-30's launches and the knobs' errors on the rows that run them.
    for r in kernels:
        short = r["name"].rsplit("(", 1)[1][:-1]
        method = {"K1a": "random_sampling", "K1b": "mppi", "K1c": "cem_mppi"}.get(short)
        if method:
            r["launches_sharded"] = sharded[method]["launches"]
            r["sharded_knobs_max_abs_err"] = knob_errs[method]
        if short == "K1a":
            r["launches_node_inline"] = nodes["sampling inline"]["launches"]
        if short == "K1f-rs-wide":
            r["launches_multichip"] = sum(m["launches"] for k, m in multichip.items())
        # Phases 31-34 on the main path's rows.
        zkey = {"K1d": "K1d"}.get(short, short)
        if zkey in zmp["kernels"]:
            r["zmp_band"] = zmp["kernels"][zkey]
        if short == "K1d":
            r["zmp_band_cem_x3"] = zmp["kernels"]["K1d_cem"]
        if short == "K1a":
            r["zmp_rollout_us"] = {"band": zmp["rollout_us_band"],
                                   "no_band": zmp["rollout_us_no_band"]}
            r["zmp_bound_ms"] = zmp["bound_ms_band"]
            r["zmp_plain_ms"] = zmp["plain_ms_band"]
            r["launches_zmp_walks"] = {k: w["launches"] for k, w in zmp_walks.items()}
        if short in ("K1a", "K1b", "K1c"):
            r["pair_grid"] = {
                name: {"ms": g[short]["ms"], "passes_us": {k: v[1] for k, v in
                                                           g[short]["passes"].items()},
                       "bound_ms": g[short]["bound_ms"], "plain_ms": g[short]["plain_ms"],
                       "max_abs_err": g[short]["cost"], "build_s": g["build_s"],
                       "ptxas": g["ptxas"]["rollout" if short == "K1a" else "update"]}
                for name, g in pair_grid["pairs"].items()}
        # Phase 36's paths at the long pairs, on the rows whose kernels they launch.
        key36 = {"K1a": "K1a", "K1b": "K1b_sharded", "K1d": "K1d_mppi", "K1e-mppi": "K1e_mppi",
                 "K1f-rs": "K1f_rs", "K1f-mppi-wide": "K1f_mppi_wide"}.get(short)
        if key36 and r["parametrization"] == MAIN_PAR:
            r["launches_long_pairs"] = {name: p["launches"][key36] for name, p in
                                        long_paths.items() if name in LONG_PAIRS}
        if short == "K1a" and r["parametrization"] == MAIN_PAR:
            r["launches_long_walk"] = long_paths["walk"]["launches"]
        if short == "K1c":
            r["large_k"] = {str(K): {"ms": v["K1c"]["ms"],
                                     "update_us": v["K1c"]["passes"]["update"][1],
                                     "bound_ms": v["K1c"]["bound_ms"],
                                     "plain_ms": v["K1c"]["plain_ms"],
                                     "sigma_max_abs_err": v["K1c"]["sigma"]}
                            for K, v in large_k.items()}
    fleet = {"kernels": {m: {"errs": fleet_k[m]["errs"], "times": fleet_k[m]["times"]}
                         for m in sm.METHODS},
             "ptxas": fleet_k["ptxas"], "crossover": fleet_k["crossover"], "walks": fleet_walks,
             "throughput": fleet_tp, "jax_cpu_walk": JAX_CPU_FLEET_WALK}
    log(f"fleet: {json.dumps(fleet)}")
    log(f"tamols: {json.dumps({'scorer': scorer, 'walks': tamols_walks})}")
    log(f"torque: {json.dumps(torque)}")
    log(f"gradient: {json.dumps(gradient)}")
    log(f"variants: {json.dumps(variants)}")
    parallel = {"knobs": knob_errs, "sharded": sharded, "gloo": gloo, "multichip": multichip}
    log(f"parallel: {json.dumps(parallel)}")
    log(f"runtime: {json.dumps(nodes)}")
    last = {"zmp": {k: v for k, v in zmp.items() if k != "kernels"}, "zmp_walks": zmp_walks,
            "pair_build_s": {k: g["build_s"] for k, g in pair_grid["pairs"].items()},
            "pair_build_total_s": pair_grid["build_total_s"],
            "large_k": {str(K): {k: v[k] for k in ("K1c", "K1e-cem", "K1f-cem",
                                                    "K1f-cem-wide", "K1f-cem-regen")}
                        for K, v in large_k.items()},
            "swing_ik": swing_ik, "long_paths": long_paths}
    log(f"last slice: {json.dumps(last, default=str)}")
    lap("the kernels line")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--gloo-rank":
        sys.exit(gloo_child(sys.argv[3], int(sys.argv[2])))
    sys.exit(main())
