"""The port's gait-adaptive sampling (``controllers/sampling/gait_adaptive.py`` and the
plain version of kernel K1e, ``ops/sampling_groups.py``) on the CPU against the JAX
package, at small sizes.

Inputs come from ``np.random.default_rng``. Tolerances: the timer's contact
sequences exactly (both float32, the same order of operations); the basis atol
1e-6 (float32 cubic terms, powers by multiplication in both); costs rtol 1e-5
(both float32, other fusion); the MPPI update, CEM elites and sigma on the same
costs and noise rtol 2e-5 (sums in another order); solver GRFs atol 1e-4, the
best frequency exactly. The kernel itself is held against this plain version on
the card (test_torch_cuda_kernel.py, chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxState
from quadruped_pympc_tamols_tpu.controllers.sampling import gait_adaptive as jga
from quadruped_pympc_tamols_tpu.controllers.sampling import rollout as jroll
from quadruped_pympc_tamols_tpu.dynamics import srbd as jsrbd
from quadruped_pympc_tamols_tpu.ops import make_pallas_gait_adaptive_solver
from quadruped_pympc_tamols_tpu.sim import SRBClosedLoopHarness as JaxHarness
from quadruped_pympc_tamols_torch.controllers.sampling import (group_operators, host_best_freq,
                                                               leg_basis,
                                                               make_gait_adaptive_solver,
                                                               timer_sequence)
from quadruped_pympc_tamols_torch.controllers.sampling.splines import make_step_major_basis
from quadruped_pympc_tamols_torch.interop import config_from_dict, sampling_state_from_numpy
from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness

torch.set_num_threads(1)
BLIND = {"sim.visual_foothold_adaptation": "blind"}
# Candidate sets whose winner is not the first group: 1.3 Hz pays no offset. The
# solver tests run two groups: the JAX solver unrolls one rollout per group, and
# its compile time grows with them.
FREQS = (2.4, 1.3, 2.0)
FREQS2 = (2.4, 1.3)
# Phases with a leg at the wrap (1.0), legs just below the duty boundary 0.65 and
# legs in swing, so that groups start with swing legs (counters of -1).
PHASES = np.array([[0.5, 1.0, 1.0, 0.5], [0.64, 0.62, 0.9, 0.99], [0.3, 0.8, 0.8, 0.3],
                   [0.0, 0.5, 0.5, 0.0], [0.6499, 0.15, 0.15, 0.6499]], np.float32)


def _cfgs(**over):
    j = jax_make_config("aliengo", mpc_type="sampling",
                        **{**BLIND, "mpc.optimize_step_freq": True, **over})
    return j, config_from_dict(dataclasses.asdict(j))


def _scene(H=12):
    state12 = np.zeros(12, np.float32)
    state12[2], state12[3] = 0.31, 0.1
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                    np.float32)
    ref12 = np.zeros(12, np.float32)
    ref12[2], ref12[3] = 0.35, 0.2
    seq = np.ones((4, H), np.float32)
    seq[1, H // 2:] = seq[2, H // 2:] = 0.0
    return state12, feet, ref12, seq


def test_timer_sequence_matches_jax_exactly():
    """Each candidate frequency in float32, as the JAX solver passes it, from
    phases at the wrap and near the duty boundary; the batched call equals the
    per-frequency calls."""
    _, tc = _cfgs()
    duty, dt, H = tc.gait_params.duty_factor, tc.mpc.dt, tc.mpc.horizon
    freqs = np.array([1.4, 2.0, 2.4, 1.3], np.float32)
    one = jax.vmap(lambda p, f: jga._timer_sequence(p, f, duty, dt, H), (None, 0))
    want = np.asarray(jax.jit(jax.vmap(one, (0, None)))(jnp.asarray(PHASES), jnp.asarray(freqs)))
    for i, phase in enumerate(PHASES):
        np.testing.assert_array_equal(timer_sequence(phase, freqs, duty, dt, H), want[i])
        for k, f in enumerate(freqs):
            np.testing.assert_array_equal(timer_sequence(phase, f, duty, dt, H), want[i, k])


def test_leg_basis_matches_jax():
    """All three parametrizations on random contact sequences with swing starts;
    the counter-zero basis of the step-0 extraction equals the static basis's
    first 12 rows (q = 0)."""
    rng = np.random.default_rng(0)
    H = 12
    for param, S in (("cubic_spline", 2), ("linear_spline", 3), ("zero_order", 2)):
        _, tc = _cfgs(**{"mpc.sampling.parametrization": param, "mpc.sampling.num_splines": S})
        P_leg = sk.make_rs_plan(tc, 3, "cpu").params_per_leg
        seq = (rng.random((4, 4, H)) < 0.6).astype(np.float32)
        seq[:, 0, :3] = 0.0  # a swing start
        counters = np.cumsum(seq, axis=-1) - np.float32(1.0)
        hl = np.sum(seq, axis=-1) + np.float32(1.0)
        basis = jax.jit(jax.vmap(lambda c, h: jga._traced_leg_basis(param, c, h, H, S, P_leg)))
        want = np.asarray(basis(jnp.asarray(counters), jnp.asarray(hl)))
        np.testing.assert_allclose(leg_basis(param, counters, hl, H, S, P_leg), want, rtol=0,
                                   atol=1e-6)
        zero = leg_basis(param, np.zeros((4, 1), np.float32), np.ones(4, np.float32), H, S, P_leg)
        step0 = make_step_major_basis(param, H, S)[0:12]
        for leg in range(4):
            np.testing.assert_array_equal(zero[leg, 0],
                                          step0[leg * 3:leg * 3 + 3, leg * P_leg:(leg + 1) * P_leg])


def _jax_group_costs(jc, params, phase, freqs, state12, feet, ref12):
    """JAX building blocks of one gait-adaptive iteration's costs (gait_adaptive.py
    :162-182): _timer_sequence, _traced_leg_basis, rollout_costs_soa, + offset."""
    sp = jc.mpc.sampling
    H, S = jc.mpc.horizon, sp.num_splines
    P_leg = params.shape[0] // 4
    K = len(freqs)
    Ng = params.shape[1] // K
    fm = jroll.ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                                jc.mpc.grf_min, jc.mpc.grf_max, jc.mpc.mu)
    srbd = jsrbd.make_params(jc)

    def group(params_g, phase, f):
        seq = jga._timer_sequence(phase, f, jc.gait_params.duty_factor, jc.mpc.dt, H)
        Wleg = jga._traced_leg_basis(sp.parametrization, jnp.cumsum(seq, axis=1) - 1.0,
                                     jnp.sum(seq, axis=1) + 1.0, H, S, P_leg)
        pg = params_g.reshape(4, P_leg, Ng)
        raw = jnp.moveaxis(jnp.einsum("lhap,lpn->lhan", Wleg, pg), 0, 1).reshape(H, 12, Ng)
        share = srbd.mass * 9.81 / jnp.maximum(jnp.sum(seq, axis=0), 1.0)
        c = jroll.rollout_costs_soa(jnp.asarray(state12), jnp.asarray(feet), jnp.asarray(ref12),
                                    raw, seq, share, jc.mpc.dts(), jc.mpc.cost.as_vector(), srbd,
                                    fm, 1.0e6)
        return c + (f - 1.3) ** 2 * 100.0

    groups = jnp.asarray(params[:, :K * Ng]).reshape(-1, K, Ng).transpose(1, 0, 2)
    costs = jax.jit(jax.vmap(group, (0, None, 0)))(groups, jnp.asarray(phase),
                                                    jnp.asarray(freqs, jnp.float32))
    return np.asarray(costs).reshape(-1)


def test_group_costs_and_optimizer_step_match_jax():
    """Costs of injected parameters, three groups, a NaN column among them; then
    the MPPI update, the CEM elites and the sigma refit on the same costs and
    noise against the JAX expressions (gait_adaptive.py:211-226)."""
    jc, tc = _cfgs(**{"mpc.step_freq_available": FREQS})
    rng = np.random.default_rng(1)
    K, Ng = 3, 64
    P = 96
    state12, feet, ref12, _ = _scene()
    inc = (rng.standard_normal(P) * 2.0).astype(np.float32)
    noise = (rng.standard_normal((P, K * Ng)) * 3.0).astype(np.float32)
    noise[:, 0] = 0.0
    noise[5, 70] = np.nan
    params = inc[:, None] + noise
    phase = PHASES[1]
    groups = group_operators(tc, phase, np.asarray(FREQS, np.float32))
    plan = sk.make_rs_plan(tc, K * Ng, "cpu")
    t = torch.from_numpy
    costs = sg.group_costs_reference(t(params), groups.dense("cpu"), t(groups.contact),
                                     t(groups.share), t(groups.offsets), t(state12), t(feet),
                                     t(ref12), plan.dts, plan.q_diag, plan.srbd, plan.fm)
    want = _jax_group_costs(jc, params, phase, FREQS, state12, feet, ref12)
    np.testing.assert_allclose(costs.numpy(), want, rtol=1e-5)
    assert costs[70] == 1.0e6 + groups.offsets[1]

    sp = jc.mpc.sampling
    c = jnp.asarray(costs.numpy())
    w = jnp.exp(-(c - jnp.min(c)) / sp.mppi_temperature)
    new_j = jnp.asarray(inc) + jnp.asarray(noise) @ (w / jnp.sum(w))
    elite_j = jax.lax.top_k(-c, sp.cem_elite)[1]
    var = jnp.var(jnp.asarray(noise)[:, elite_j], axis=1, ddof=1) + 1e-8
    sigma_j = jnp.clip(jnp.sqrt(var), sp.cem_sigma_min, sp.cem_sigma_max)
    knobs = sm.make_knobs(tc, "cem_mppi")
    _, new = sm.mppi_update(costs, t(noise), t(inc), knobs.temperature)
    elites = sm.cem_elites(costs, knobs.n_elite)
    sigma = sm.cem_refit(t(noise), elites, knobs.sigma_min, knobs.sigma_max)
    np.testing.assert_allclose(new.numpy(), np.asarray(new_j), rtol=2e-5)
    np.testing.assert_array_equal(elites.numpy(), np.asarray(elite_j))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_j), rtol=2e-5)


def _solve_both(jc, tc, N, phase, optimize_swing, jax_solve, inc):
    """One zero-noise solve of the JAX solver and of the port's CPU solver."""
    state12, feet, ref12, seq = _scene(tc.mpc.horizon)
    ref_feet = feet + np.float32(0.05)
    cur = seq[:, 0].copy()
    prev = np.ones(4, np.float32)
    P = inc.shape[0]
    jst = JaxState(jnp.asarray(inc), jax.random.PRNGKey(0), jnp.zeros(P, jnp.float32))
    jout, _ = jax_solve(*(jnp.asarray(x) for x in (state12, feet, ref12, ref_feet, phase)),
                        jnp.float32(1.4), jnp.asarray(optimize_swing),
                        *(jnp.asarray(x) for x in (seq, cur, prev)), jst)
    solve, _ = make_gait_adaptive_solver(tc, N, device="cpu")
    tout, tnew = solve(state12, feet, ref12, ref_feet, phase, 1.4, optimize_swing, seq, cur, prev,
                       sampling_state_from_numpy(inc, np.zeros(P), seed=0, device="cpu"))
    assert tnew.offset == 1
    return jout, tout


@pytest.mark.parametrize("method", ["random_sampling", "mppi", "cem_mppi"])
def test_zero_noise_solver_matches_jax(method):
    """JAX make_gait_adaptive_solver against the port's solver at zero noise, with
    and without optimize_swing; the 1.3 Hz group (not the first) wins."""
    over = {"mpc.step_freq_available": FREQS2, "mpc.sampling.method": method,
            "mpc.sampling.num_samples": 99, "mpc.sampling.sigma_random": (0.0, 0.0, 0.0),
            "mpc.sampling.sigma_mppi": 0.0}
    jc, tc = _cfgs(**over)
    N = 99  # 2 groups of 49, the last sample not evaluated
    jax_solve, P = jga.make_gait_adaptive_solver(jc, N)
    inc = (np.random.default_rng(2).standard_normal(P) * 3.0).astype(np.float32)
    for optimize_swing, want_freq in ((True, np.float32(1.3)), (False, np.float32(1.4))):
        jout, tout = _solve_both(jc, tc, N, PHASES[2], optimize_swing, jax_solve, inc)
        assert tout.costs.shape == (98,)
        np.testing.assert_allclose(tout.costs.numpy(), np.asarray(jout.costs), rtol=1e-5)
        np.testing.assert_allclose(float(tout.best_cost), float(jout.best_cost), rtol=1e-5)
        assert host_best_freq(tout) == float(jout.best_freq) == float(want_freq)
        np.testing.assert_allclose(tout.grfs.numpy(), np.asarray(jout.grfs), rtol=0, atol=1e-4)
        np.testing.assert_allclose(tout.predicted_state.numpy(), np.asarray(jout.predicted_state),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tout.best_parameters.numpy(), np.asarray(jout.best_parameters),
                                   atol=1e-5)
        if method == "cem_mppi":
            np.testing.assert_allclose(tout.sigma.numpy(), np.asarray(jout.sigma), rtol=2e-5)


def test_zero_noise_solver_matches_pallas():
    """The one comparison against the Pallas kernel itself: its gait-adaptive solver
    in interpret mode at horizon 1, three groups of one 128-sample tile, zero
    noise. Every sample of a group is the incumbent, so both pick the 1.3 Hz group
    (the Pallas solver by its per-group combine, the port by the first index)."""
    over = {"mpc.horizon": 1, "mpc.step_freq_available": FREQS,
            "mpc.sampling.sigma_random": (0.0, 0.0, 0.0)}
    jc, tc = _cfgs(**over)
    N = 3 * 128
    pallas, P = make_pallas_gait_adaptive_solver(jc, num_samples=N, interpret=True, tile=128)
    inc = (np.random.default_rng(3).standard_normal(P) * 3.0).astype(np.float32)
    jout, tout = _solve_both(jc, tc, N, PHASES[2], True, pallas, inc)
    assert tout.costs.shape == (N,)
    assert host_best_freq(tout) == float(jout.best_freq) == float(np.float32(1.3))
    np.testing.assert_allclose(float(tout.best_cost), float(jout.best_cost), rtol=1e-5)
    np.testing.assert_allclose(tout.grfs.numpy(), np.asarray(jout.grfs), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tout.predicted_state.numpy(), np.asarray(jout.predicted_state),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout.best_parameters.numpy(), np.asarray(jout.best_parameters),
                               atol=1e-5)


def test_cpu_wrapper_runs_the_plain_version():
    """On CPU tensors ``sampling_groups`` runs the plain version: noise from the CPU
    stream of (seed, offset), its first K*Ng columns; the packed output in K1a's
    layout; no launch counted."""
    _, tc = _cfgs(**{"mpc.step_freq_available": FREQS})
    N = 100
    plan = sg.make_group_plan(tc, N, "cpu")
    assert (plan.num_groups, plan.group_size, plan.num_used) == (3, 33, 99)
    state12, feet, ref12, seq = _scene()
    share = np.broadcast_to((np.float32(tc.robot.mass) * np.float32(9.81)
                             / np.maximum(seq.sum(0), 1))[:, None], (12, 4))
    tick = sk.TickInputs(state12, feet, ref12, seq, np.ascontiguousarray(share))
    groups = group_operators(tc, PHASES[2], np.asarray(FREQS, np.float32))
    before = dict(sg.sampling_groups.launches)
    t = torch.from_numpy
    inc = t(np.random.default_rng(4).standard_normal(96).astype(np.float32))
    sigma = torch.full((96,), 2.0)
    for method in ("random_sampling", "mppi", "cem_mppi"):
        knobs = sm.make_knobs(tc, method)
        dump = torch.empty(96, 99)
        costs, out, sig, el = sg.sampling_groups(plan, knobs, tick, groups, inc, sigma, 9, 4,
                                                 noise_out=dump)
        want = sg.sample_noise_reference(plan, knobs, sk.cpu_generator(9, 4), sigma)
        assert torch.equal(dump, want)
        b = plan.base
        res = sg.group_iteration_reference(
            want, inc, groups.dense("cpu"), t(groups.contact), t(groups.share), t(groups.offsets),
            b.W, *sk.tick_tensors(tick, "cpu"), b.dts, b.q_diag, b.srbd, b.fm, knobs)
        assert torch.equal(costs, res.costs) and costs.shape == (99,)
        assert torch.equal(out, sk.pack_result(res.best_cost, res.grfs, res.next_state,
                                               res.best_index, res.new_params))
        assert int(res.best_group) == int(res.best_index) // 33
        if knobs.cem:
            assert torch.equal(sig, res.sigma) and torch.equal(el, res.elites)
        else:
            assert sig is sigma and el is None
    assert sg.sampling_groups.launches == before


def test_zero_noise_closed_loop_matches_jax():
    """The JAX harness against the port's, optimize_step_freq on, zero noise, the
    same nonzero incumbent. Both gaits start 350 steps (0.7 s at 1.4 Hz) into their
    cycle, so that the touch-down window opens at step 30, an MPC tick, and the
    solve there picks the frequency. State histories atol 1e-3 (float32 plants,
    float32 against float64 swing curves, as test_torch_harness.py) and the same
    pgg.step_freq after every step: it switches from 1.4 to 1.3 Hz and holds."""
    over = {"mpc.sampling.num_samples": 99, "mpc.sampling.sigma_random": (0.0, 0.0, 0.0),
            "mpc.step_freq_available": FREQS2}
    jc, tc = _cfgs(**over)
    jh = JaxHarness(jc, seed=0)
    th = SRBClosedLoopHarness(tc, seed=0, device="cpu")
    P = th.ctrl.controller.num_parameters
    inc = (np.random.default_rng(0).standard_normal(P) * 4.0).astype(np.float32)
    js = jh.ctrl.controller.state
    jh.ctrl.controller.state = JaxState(jnp.asarray(inc), js.key, js.sigma)
    th.ctrl.controller.state = sampling_state_from_numpy(inc, np.zeros(P), 0, device="cpu")
    for h in (jh, th):
        h.wb.pgg.set_phase_signal(np.mod(h.wb.pgg.phase_signal + 350 * tc.sim.dt * 1.4, 1.0))
    fired = []
    update = th.wb.update_state_and_reference

    def recorded(*a, **kw):
        r = update(*a, **kw)
        fired.append(r[4])
        return r

    th.wb.update_state_and_reference = recorded
    vel = np.array([0.3, 0.0, 0.0])
    jhist, thist, jf, tf = [], [], [], []
    for _ in range(40):
        jhist.append(jh.step(vel))
        jf.append(jh.wb.pgg.step_freq)
        thist.append(th.step(vel))
        tf.append(th.wb.pgg.step_freq)
    assert [k for k, f in enumerate(fired) if f] == [30] and 30 % th._mpc_every == 0
    assert tf == jf and tf[29] == 1.4 and tf[30:] == [float(np.float32(1.3))] * 10
    np.testing.assert_allclose(np.array(thist), np.array(jhist), atol=1e-3)
