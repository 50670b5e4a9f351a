"""The plain version of kernels K1b, K1c and K1d (``ops/sampling_softmax.py``) on the
CPU against the JAX package, on injected noise, and the chained solver of each
method against the Pallas solver at zero noise.

The JAX side is ``controllers/sampling/rollout.py:rollout_costs_soa`` plus the XLA
solver's optimizer step (JAX ``controllers/sampling/sampling_mpc.py:166-176``:
softmax update, ``jax.lax.top_k`` elites, ddof-1 refit) and its step-0
extraction (:221-226). Tolerances: costs rtol 1e-5 (both float32, other fusion),
new parameters and sigma atol 1e-5 (sums in another order), GRFs and the
predicted state rtol/atol 1e-5 (test_torch_sampling.py's). The weights
exp(-(c - beta)/T) turn a 1e-6 relative cost difference at costs of O(1e3) into
a ~1e-3 relative weight difference, so the optimizer step is held against the
XLA step applied to the port's own costs, and the costs separately. The kernels
themselves are held against this plain version on the card
(test_torch_cuda_kernel.py, chip_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu import replace_config as jax_replace_config
from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxState
from quadruped_pympc_tamols_tpu.controllers.sampling import rollout as jroll
from quadruped_pympc_tamols_tpu.dynamics import srbd as jsrbd
from quadruped_pympc_tamols_tpu.ops import make_pallas_sampling_solver
from quadruped_pympc_tamols_torch.controllers.sampling import make_sampling_solver
from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
from quadruped_pympc_tamols_torch.interop import config_from_dict, sampling_state_from_numpy
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

torch.set_num_threads(1)
N = 256


def _cfgs(**over):
    j = jax_replace_config(jax_make_config("aliengo", mpc_type="sampling"), **over)
    return j, config_from_dict(dataclasses.asdict(j))


def _scene(H=12):
    state12 = np.zeros(12, np.float32)
    state12[2], state12[3] = 0.31, 0.1
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                    np.float32)
    ref12 = np.zeros(12, np.float32)
    ref12[2], ref12[3] = 0.35, 0.2
    seq = np.ones((4, H), np.float32)
    seq[1, 6:] = seq[2, 6:] = 0.0
    return state12, feet, ref12, seq


def _inputs(tc, method, seed):
    """Incumbent (P,), sigma (P,) and (P, N) noise from numpy, column 0 zero."""
    rng = np.random.default_rng(seed)
    P = sk.make_rs_plan(tc, N, "cpu").num_parameters
    inc = (rng.standard_normal(P) * 2.0).astype(np.float32)
    sigma = rng.uniform(0.3, 4.0, P).astype(np.float32)
    scale = sigma[:, None] if method == "cem_mppi" else np.float32(tc.mpc.sampling.sigma_mppi)
    noise = (rng.standard_normal((P, N)) * scale).astype(np.float32)
    noise[:, 0] = 0.0
    return inc, sigma, noise


def _jax_step(jc, W, inc, noise, state12, feet, ref12, seq, share, costs=None):
    """The XLA solver's iteration on injected noise, as numpy."""
    sp = jc.mpc.sampling
    fm = jroll.ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                                jc.mpc.grf_min, jc.mpc.grf_max, jc.mpc.mu)
    W, noise, inc = jnp.asarray(W), jnp.asarray(noise), jnp.asarray(inc)
    H = seq.shape[1]
    if costs is None:
        raw = (W @ (inc[:, None] + noise)).reshape(H, 12, noise.shape[1])
        costs = jroll.rollout_costs_soa(jnp.asarray(state12), jnp.asarray(feet),
                                        jnp.asarray(ref12), raw, jnp.asarray(seq),
                                        jnp.asarray(share), jc.mpc.dts(), jc.mpc.cost.as_vector(),
                                        jsrbd.make_params(jc), fm)
    costs = jnp.asarray(costs)
    beta = jnp.min(costs)
    w = jnp.exp(-(costs - beta) / sp.mppi_temperature)
    new = inc + noise @ (w / jnp.sum(w))
    elites = jax.lax.top_k(-costs, sp.cem_elite)[1]
    var = jnp.var(noise[:, elites], axis=1, ddof=1) + 1e-8
    sigma = jnp.clip(jnp.sqrt(var), sp.cem_sigma_min, sp.cem_sigma_max)
    rows = jroll.apply_force_model_rows(W[0:12] @ new, jnp.asarray(seq)[:, 0],
                                        jnp.asarray(share)[0], fm)
    grfs = jnp.stack(rows).reshape(4, 3)
    state1 = jsrbd.integrate_euler(jnp.asarray(state12), jnp.asarray(feet), grfs,
                                   jnp.asarray(seq)[:, 0], jsrbd.make_params(jc),
                                   jc.mpc.dts()[0])
    return {k: np.asarray(v) for k, v in dict(costs=costs, beta=beta, new=new, elites=elites,
                                                sigma=sigma, grfs=grfs, state1=state1).items()}


def _assert_matches(res, j, cem):
    np.testing.assert_allclose(res.costs.numpy(), j["costs"], rtol=1e-5)
    np.testing.assert_allclose(float(res.beta), float(j["beta"]), rtol=1e-5)
    np.testing.assert_allclose(res.new_params.numpy(), j["new"], atol=1e-5)
    np.testing.assert_allclose(res.grfs.numpy(), j["grfs"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res.next_state.numpy(), j["state1"], rtol=1e-5, atol=1e-5)
    if cem:
        np.testing.assert_array_equal(res.elites.numpy(), j["elites"])
        np.testing.assert_allclose(res.sigma.numpy(), j["sigma"], atol=1e-5)
    else:
        assert res.sigma is None and res.elites is None


@pytest.mark.parametrize("method, seed, saturated", [
    ("mppi", 0, False), ("mppi", 1, False), ("cem_mppi", 0, False), ("cem_mppi", 1, False),
    ("mppi", 2, True), ("cem_mppi", 2, True)])
def test_iteration_reference_matches_jax(method, seed, saturated):
    """One MPPI / CEM-MPPI iteration on the same noise. ``saturated``: a NaN base
    state, so every cost saturates to 1e6 and all samples tie (as after a fall):
    the weights are all 1 and the elites are samples 0..K-1."""
    jc, tc = _cfgs(**{"mpc.sampling.method": method})
    plan = sk.make_rs_plan(tc, N, "cpu")
    knobs = sm.make_knobs(tc)
    state12, feet, ref12, seq = _scene()
    if saturated:
        state12 = np.full(12, np.nan, np.float32)
    inc, _, noise = _inputs(tc, method, seed)
    share = gravity_share(torch.from_numpy(seq), tc.robot.mass)
    t = torch.from_numpy
    res = sm.softmax_iteration_reference(t(noise), t(inc), plan.W, t(state12), t(feet), t(ref12),
                                         t(seq), share, plan.dts, plan.q_diag, plan.srbd,
                                         plan.fm, knobs)
    j = _jax_step(jc, plan.W.numpy(), inc, noise, state12, feet, ref12, seq, share.numpy())
    np.testing.assert_allclose(res.costs.numpy(), j["costs"], rtol=1e-5)
    j = _jax_step(jc, plan.W.numpy(), inc, noise, state12, feet, ref12, seq, share.numpy(),
                  costs=res.costs.numpy())
    _assert_matches(res, j, knobs.cem)
    assert not saturated or bool((res.costs == 1.0e6).all())


def test_cem_elite_ties_follow_jax_top_k():
    """4 finite costs among 1e6 saturations: the elites are the 4 finite samples,
    then the lowest-index saturated ones, as jax.lax.top_k takes them (torch.topk
    takes others), and the refit sigma on the same noise equals the XLA one."""
    jc, tc = _cfgs(**{"mpc.sampling.method": "cem_mppi"})
    plan = sk.make_rs_plan(tc, N, "cpu")
    knobs = sm.make_knobs(tc)
    inc, _, noise = _inputs(tc, "cem_mppi", 3)
    costs = np.full(N, 1.0e6, np.float32)
    costs[[17, 60, 130, 201]] = [3.5, 1.25, 7.0, 2.0]
    state12, feet, _, seq = _scene()
    share = gravity_share(torch.from_numpy(seq), tc.robot.mass)
    t = torch.from_numpy
    res = sm.softmax_combine_reference(t(costs), t(noise), t(inc), plan.W, t(state12), t(feet),
                                       t(seq), share, plan.dts, plan.srbd, plan.fm, knobs)
    j = _jax_step(jc, plan.W.numpy(), inc, noise, state12, feet, None, seq, share.numpy(),
                  costs=costs)
    assert res.elites.tolist() == [60, 201, 17, 130, 0, 1, 2, 3, 4, 5] == j["elites"].tolist()
    _assert_matches(res, j, True)


def test_cem_solver_elite_ties_follow_jax_top_k():
    """The CPU solver from a NaN base state: every cost saturates, so all samples
    tie. Its refit sigma must come from samples 0..K-1 of the noise it drew (the
    CPU stream of its (seed, offset)), as the XLA refit with jax.lax.top_k does."""
    jc, tc = _cfgs(**{"mpc.sampling.method": "cem_mppi"})
    solve, P = make_sampling_solver(tc, N, device="cpu")
    rng = np.random.default_rng(4)
    inc = rng.standard_normal(P).astype(np.float32)
    sigma0 = rng.uniform(0.5, 3.0, P).astype(np.float32)
    _, feet, ref12, seq = _scene()
    state12 = np.full(12, np.nan, np.float32)
    ones = np.ones(4, np.float32)
    st = sampling_state_from_numpy(inc, sigma0, seed=3, device="cpu")
    out, new = solve(state12, feet, ref12, feet, seq, ones, ones, st)
    assert bool((out.costs == 1.0e6).all())
    z = torch.randn(P, N - 1, generator=sk.cpu_generator(3, 0)) * torch.from_numpy(sigma0)[:, None]
    noise = np.concatenate([np.zeros((P, 1), np.float32), z.numpy()], axis=1)
    idx = jax.lax.top_k(-jnp.asarray(out.costs.numpy()), jc.mpc.sampling.cem_elite)[1]
    var = jnp.var(jnp.asarray(noise)[:, idx], axis=1, ddof=1) + 1e-8
    want = jnp.clip(jnp.sqrt(var), jc.mpc.sampling.cem_sigma_min, jc.mpc.sampling.cem_sigma_max)
    np.testing.assert_allclose(new.sigma.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_wrappers_run_the_plain_version():
    """On CPU tensors the K1b/K1c wrapper packs the plain iteration in K1a's layout,
    drawing from the CPU stream of (seed, offset) when no noise is given, and
    counts no launch."""
    _, tc = _cfgs()
    plan = sk.make_rs_plan(tc, N, "cpu")
    state12, feet, ref12, seq = _scene()
    share = gravity_share(torch.from_numpy(seq), tc.robot.mass)
    tick = sk.TickInputs(state12, feet, ref12, seq, share[:, None].expand(12, 4).numpy())
    t = torch.from_numpy
    before = dict(sm.softmax_iteration.launches)
    for method in ("mppi", "cem_mppi"):
        knobs = sm.make_knobs(tc, method)
        inc, sigma, noise = _inputs(tc, method, 5)
        res = sm.softmax_iteration_reference(t(noise), t(inc), plan.W, t(state12), t(feet),
                                             t(ref12), t(seq), t(tick.share), plan.dts,
                                             plan.q_diag, plan.srbd, plan.fm, knobs)
        costs, out, sig, el = sm.softmax_iteration(plan, knobs, tick, t(inc), t(sigma), 0, 0,
                                                   noise_in=t(noise))
        if knobs.cem:
            assert torch.equal(sig, res.sigma) and torch.equal(el, res.elites)
        else:
            assert torch.equal(sig, t(sigma)) and el is None
        assert torch.equal(costs, res.costs)
        assert torch.equal(out, sk.pack_result(res.beta, res.grfs, res.next_state,
                                               res.best_index, res.new_params))
        dump = torch.empty(plan.num_parameters, N)
        sm.softmax_iteration(plan, knobs, tick, t(inc), t(sigma), 9, 4, noise_out=dump)
        assert torch.equal(dump, sm.sample_noise_reference(
            plan.num_parameters, N, knobs, sk.cpu_generator(9, 4), t(sigma)))
    assert sm.softmax_iteration.launches == before


@pytest.mark.parametrize("method", ["random_sampling", "mppi", "cem_mppi"])
def test_chain_repeats_single_iterations(method):
    """K1d's plain path: iteration i equals one iteration from iteration i - 1's
    result (parameters, and sigma for CEM) at offset + i."""
    _, tc = _cfgs(**{"mpc.sampling.num_samples": 64})
    plan = sk.make_rs_plan(tc, 64, "cpu")
    knobs = sm.make_knobs(tc, method)
    state12, feet, ref12, seq = _scene()
    share = gravity_share(torch.from_numpy(seq), tc.robot.mass)
    tick = sk.TickInputs(state12, feet, ref12, seq, share[:, None].expand(12, 4).numpy())
    inc = torch.from_numpy(_inputs(tc, method, 6)[0])
    sigma = torch.full((plan.num_parameters,), 2.0)
    counts = (lambda: (sk.sampling_rs.launches, dict(sm.softmax_iteration.launches),
                       dict(sm.sampling_chain.launches)))
    before = counts()
    res = sm.sampling_chain(plan, knobs, tick, inc, sigma, 8, 2, 3)
    assert len(res) == 3
    assert counts() == before
    for i, r in enumerate(res):
        if method == "random_sampling":
            one = sk.sampling_rs(plan, tick, inc, 8, 2 + i) + (sigma, None)
        else:
            one = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 8, 2 + i)
        for a, b in zip(one, r):
            assert (a is None and b is None) or torch.equal(a, b)
        inc, sigma = r.out[sk.OUT_WINNER:], r.sigma
    assert not torch.equal(res[0].out, res[2].out)


def _chain_against_pallas(method, **over):
    """``method`` x 3 through the port's CPU solver against the Pallas solver in
    interpret mode at zero noise, at horizon 2 and one 128-sample tile
    (test_torch_sampling.py's interpret-mode size): every candidate is the
    incumbent, so each iteration keeps it. Tolerances: GRFs and the predicted state
    1e-5 (test_torch_sampling.py's), the best cost rtol 1e-4; the parameters atol
    1e-5, since the Pallas solver averages the 128 equal parameter vectors (S / Z,
    or its tied winners) where the port adds the zero-noise step to the incumbent:
    rounding, not 0."""
    over = {"mpc.horizon": 2, "mpc.sampling.method": method, "mpc.sampling.num_iterations": 3,
            **over}
    jc, tc = _cfgs(**over)
    pallas, P = make_pallas_sampling_solver(jc, num_samples=128, interpret=True, tile=128)
    state12, feet, ref12, seq = _scene(H=2)
    ref_feet = feet + np.float32(0.05)
    ones = np.ones(4, np.float32)
    inc = (np.random.default_rng(0).standard_normal(P) * 3.0).astype(np.float32)
    jst = JaxState(jnp.asarray(inc), jax.random.PRNGKey(0), jnp.zeros(P, jnp.float32))
    jout, _ = pallas(*(jnp.asarray(x) for x in (state12, feet, ref12, ref_feet, seq, ones, ones)),
                     jst)
    solve, _ = make_sampling_solver(tc, 128, device="cpu")
    tout, tnew = solve(state12, feet, ref12, ref_feet, seq, ones, ones,
                       sampling_state_from_numpy(inc, np.zeros(P), seed=0, device="cpu"))
    np.testing.assert_allclose(tout.grfs.numpy(), np.asarray(jout.grfs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout.predicted_state.numpy(), np.asarray(jout.predicted_state),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tout.best_cost), float(jout.best_cost), rtol=1e-4)
    np.testing.assert_allclose(tout.best_parameters.numpy(), np.asarray(jout.best_parameters),
                               atol=1e-5)
    np.testing.assert_array_equal(tout.sigma.numpy(), np.asarray(jout.sigma))
    assert tnew.offset == 3


def test_mppi_chain_matches_pallas_at_zero_noise():
    """MPPI x 3 against the Pallas solver at zero noise (``_chain_against_pallas``)."""
    _chain_against_pallas("mppi", **{"mpc.sampling.sigma_mppi": 0.0})


@pytest.mark.parametrize("method, over", [
    ("random_sampling", {"mpc.sampling.sigma_random": (0.0, 0.0, 0.0)}),
    # The refit sigma sqrt(0 + 1e-8) clipped to [0, 0]: the noise stays zero.
    ("cem_mppi", {"mpc.sampling.cem_sigma_min": 0.0, "mpc.sampling.cem_sigma_max": 0.0})])
def test_chain_matches_pallas_at_zero_noise(method, over):
    """Random sampling x 3 and CEM-MPPI x 3 against the Pallas solver at zero noise
    (``_chain_against_pallas``); for CEM the sigma passed from iteration to
    iteration, 0 in both."""
    _chain_against_pallas(method, **over)
