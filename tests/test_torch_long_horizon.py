"""Long horizons and large parameter counts: the basis windows every CUDA kernel
takes (K1a-K1f), and the port's plain solver against the JAX package's XLA solver
at pairs beyond the flagship's.

The kernels read each basis row as a window of four weights and the leg-major
index of its first parameter (``sampling_kernel.basis_windows``); placed back on
their rows the windows must give the dense basis exactly, for every
parametrization and for the gait-adaptive solver's traced bases, at every pair
the kernels take (P = 4 * P_leg <= 1024, H <= 128). The plain path is held to
the XLA solver (JAX ``controllers/sampling/sampling_mpc.py:make_sampling_solver``)
at zero noise with a nonzero incumbent, with test_torch_parametrizations.py's
tolerances (GRFs and the predicted state 1e-5, the best cost rtol 1e-4, the
parameters atol 1e-6, CEM's sigma atol 1e-6), and on the XLA solver's own noise
(rebuilt from its key, as test_torch_fleet.py does) at (48, zero-order), where
the samples differ: the costs up to 1.25 times the lowest rtol 1e-5 (those above
drift over 48 steps: rtol 1e-2), the rest 1e-5, the softmax step held against
JAX's moved by the port's own weights. The JAX sides cost 2-4 s a solve at these
horizons, so they are recorded in ``tests/fixtures/torch_jax_references.npz``
(``jax_long_horizon_references``; ``python tools/record_jax_references.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from jax_references import check_inputs, digest, load
from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu import replace_config as jax_replace_config
from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.sampling import (FleetSamplingState,
                                                               group_operators,
                                                               make_fleet_sampling_solver,
                                                               make_sampling_solver)
from quadruped_pympc_tamols_torch.controllers.sampling.splines import make_step_major_basis
from quadruped_pympc_tamols_torch.interop import config_from_dict, sampling_state_from_numpy
from quadruped_pympc_tamols_torch.ops import build
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk

threadpool_limits(1)
torch.set_num_threads(1)

METHODS = ("random_sampling", "mppi", "cem_mppi")
N = 256  # samples of the zero-noise solves
N_NOISY = 64  # samples of the solve on the XLA solver's noise
NOISY_KEY = 5
TOL = 1e-5
# The noisy solve's costs up to NEAR times the lowest (12-38 samples of 64, among
# them every one whose softmax weight at temperature 1 is not 0 in float32) are
# held at TOL (largest error seen 7.6e-6); in the others the rollout drifts over 48
# steps (costs up to 460 times the lowest), so that the two packages' float32
# rounding grows to at most 0.5 % (largest seen 0.49 %), held at FAR_RTOL.
NEAR = 1.25
FAR_RTOL = 1e-2
# name -> (parametrization, horizon, splines)
WINDOW_PAIRS = {"2-zero_order": ("zero_order", 2, 2), "12-cubic-2": ("cubic_spline", 12, 2),
                "24-cubic-4": ("cubic_spline", 24, 4), "40-cubic-8": ("cubic_spline", 40, 8),
                "85-zero_order": ("zero_order", 85, 2),
                "64-linear-20": ("linear_spline", 64, 20)}
SOLVER_PAIRS = {"32-cubic-2": ("cubic_spline", 32, 2), "48-zero_order": ("zero_order", 48, 2),
                "85-zero_order": ("zero_order", 85, 2)}


def pair_over(name, pairs=SOLVER_PAIRS):
    par, H, S = pairs[name]
    return {"mpc.horizon": H, "mpc.sampling.parametrization": par, "mpc.sampling.num_splines": S}


def _cfgs(zero_noise=True, **over):
    """(jax cfg, port cfg), at zero exploration noise unless asked otherwise."""
    if zero_noise:
        over = {"mpc.sampling.sigma_random": (0.0, 0.0, 0.0), "mpc.sampling.sigma_mppi": 0.0,
                **over}
    j = jax_replace_config(jax_make_config("aliengo", mpc_type="sampling"), **over)
    return j, config_from_dict(dataclasses.asdict(j))


def _scene(H):
    """A tick: the base 5 cm under its reference and pushed forward, legs 1 and 2
    in swing over the second half of the horizon, all in stance now and before."""
    state12 = np.zeros(12, np.float32)
    state12[2], state12[3] = 0.31, 0.1
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                    np.float32)
    ref12 = np.zeros(12, np.float32)
    ref12[2], ref12[3] = 0.35, 0.2
    seq = np.ones((4, H), np.float32)
    seq[1, H // 2:] = seq[2, H // 2:] = 0.0
    cur = np.ones(4, np.float32)
    return state12, feet, ref12, feet + np.float32(0.05), seq, cur, cur


def _incumbent(P, seed):
    return (np.random.default_rng(seed).standard_normal(P) * 3.0).astype(np.float32)


def _sigma(P):
    return (0.5 + np.random.default_rng(9).random(P)).astype(np.float32)


def _jax_noise(cfg, method, key, sigma):
    """The XLA solver's draw of one iteration from its state's key (JAX
    sampling_mpc.py:_sample_noise after the split in _one_iteration)."""
    sp, n = cfg.mpc.sampling, N_NOISY
    _, sub = jax.random.split(key)
    P = sigma.shape[0]
    if method == "random_sampling":
        n3 = n // 3
        k1, k2, k3 = jax.random.split(sub, 3)
        noise = jnp.concatenate([
            jnp.zeros((P, 1)), sp.sigma_random[0] * jax.random.normal(k1, (P, n3)),
            sp.sigma_random[1] * jax.random.normal(k2, (P, n3)),
            jax.random.uniform(k3, (P, n - 1 - 2 * n3), minval=-sp.sigma_random[2],
                               maxval=sp.sigma_random[2])], axis=1)
    elif method == "mppi":
        noise = jnp.concatenate([jnp.zeros((P, 1)),
                                 sp.sigma_mppi * jax.random.normal(sub, (P, n - 1))], axis=1)
    else:
        noise = jnp.concatenate([jnp.zeros((P, 1)),
                                 jax.random.normal(sub, (P, n - 1)) * sigma[:, None]], axis=1)
    return np.asarray(jax.jit(lambda x: x.astype(jnp.float32))(noise))


def jax_long_horizon_references() -> dict:
    """The JAX package's side of this file (tests/jax_references.py): the XLA
    solver's outputs at zero noise for each pair and method, and on its own noise
    at (48, zero-order)."""
    from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxState
    from quadruped_pympc_tamols_tpu.controllers.sampling import make_sampling_solver as jsolver

    out = {}

    def keep(key, jout, jst, inputs):
        out[f"{key}/grfs"] = np.asarray(jout.grfs)
        out[f"{key}/predicted_state"] = np.asarray(jout.predicted_state)
        out[f"{key}/best_cost"] = np.asarray(jout.best_cost)
        out[f"{key}/costs"] = np.asarray(jout.costs)
        out[f"{key}/best_parameters"] = np.asarray(jst.best_parameters)
        out[f"{key}/sigma"] = np.asarray(jst.sigma)
        out[f"digest/{key}"] = digest(*inputs)

    for name in SOLVER_PAIRS:
        for method in METHODS:
            jc, _ = _cfgs(**pair_over(name), **{"mpc.sampling.method": method})
            solve, P = jsolver(jc, num_samples=N)
            inc, scene = _incumbent(P, 2), _scene(jc.mpc.horizon)
            jst = JaxState(jnp.asarray(inc), jax.random.PRNGKey(0), jnp.zeros(P, jnp.float32))
            jout, jst2 = solve(*(jnp.asarray(x) for x in scene), jst)
            keep(f"zero/{name}/{method}", jout, jst2, (jc, N, inc, *scene))
    for method in METHODS:
        jc, _ = _cfgs(False, **pair_over("48-zero_order"), **{"mpc.sampling.method": method})
        solve, P = jsolver(jc, num_samples=N_NOISY)
        inc, sigma, scene = _incumbent(P, 4), _sigma(P), _scene(jc.mpc.horizon)
        jst = JaxState(jnp.asarray(inc), jax.random.PRNGKey(NOISY_KEY), jnp.asarray(sigma))
        jout, jst2 = solve(*(jnp.asarray(x) for x in scene), jst)
        keep(f"noisy/{method}", jout, jst2, (jc, N_NOISY, inc, sigma, NOISY_KEY, *scene))
    return out


def _dense(win, P_leg):
    """Windows (..., R, 8) placed back on their rows: (..., R, 4 * P_leg)."""
    cols = win[..., 4].copy().view(np.int32)[..., None] + np.arange(sk.WINDOW)
    out = np.zeros(win.shape[:-1] + (4 * P_leg,), np.float32)
    np.put_along_axis(out, cols, win[..., :sk.WINDOW], axis=-1)
    return out


@pytest.mark.parametrize("name", list(WINDOW_PAIRS))
def test_windows_reproduce_the_dense_bases(name):
    """The plan's windows give make_step_major_basis exactly, each window within its
    row's leg; the gait-adaptive groups' windows (the traced bases of three
    candidate frequencies at two gait phases, as group_operators hands them to
    pack_groups, and as basis_windows finds them in the dense blocks) give their
    dense bases; the pair is within the kernels' bounds."""
    par, H, S = WINDOW_PAIRS[name]
    cfg = make_config("aliengo", **pair_over(name, WINDOW_PAIRS),
                      **{"mpc.optimize_step_freq": True})
    plan = sk.make_rs_plan(cfg, 8, "cpu")
    P_leg = plan.params_per_leg
    build.check_pair(H, P_leg)
    win = plan.windows.numpy()
    assert win.shape == (H * 12, sk.WINDOW_FLOATS)
    np.testing.assert_array_equal(_dense(win, P_leg), make_step_major_basis(par, H, S))
    first = win[:, 4].copy().view(np.int32)
    assert np.all(first // P_leg == (np.arange(H * 12) % 12) // 3)
    assert np.all(first % P_leg <= P_leg - sk.WINDOW)
    for phase in ([0.3, 0.8, 0.8, 0.3], [0.05, 0.55, 0.95, 0.45]):
        groups = group_operators(cfg, np.asarray(phase, np.float32),
                                 np.asarray(cfg.mpc.step_freq_available, np.float32))
        dense = groups.dense("cpu").numpy()
        for gwin in (groups.windows, sk.basis_windows(groups.blocks, P_leg)):
            np.testing.assert_array_equal(_dense(gwin, P_leg), dense)
            first = gwin[..., 4].copy().view(np.int32)
            assert np.all(first // P_leg == (np.arange(H * 12) % 12) // 3)


def test_windows_refuse_a_row_wider_than_four():
    """A row whose nonzeros span five parameters raises NotImplementedError naming
    the window; four at the leg's end fit."""
    blocks = np.zeros((12, 8), np.float32)
    blocks[:, 4:] = 1.0
    assert sk.basis_windows(blocks, 8)[:, :4].all()
    blocks[5, 3] = 0.5
    with pytest.raises(NotImplementedError, match="window of 4"):
        sk.basis_windows(blocks, 8)


def _check(tout, got_params, got_sigma, ref, cem, sigma_atol):
    np.testing.assert_allclose(tout.grfs.numpy().reshape(4, 3), ref["grfs"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tout.predicted_state.numpy().reshape(12), ref["predicted_state"],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(tout.best_cost), float(ref["best_cost"]), rtol=1e-4)
    np.testing.assert_allclose(got_params, ref["best_parameters"], atol=1e-6)
    if cem:
        np.testing.assert_allclose(got_sigma, ref["sigma"], atol=sigma_atol)


@pytest.mark.parametrize("name", list(SOLVER_PAIRS))
def test_plain_solver_matches_xla_at_zero_noise(name):
    """Random sampling, MPPI and CEM-MPPI, one iteration each, at zero noise around
    a nonzero incumbent, against the XLA solver: every sample is the incumbent, so
    its cost, step-0 GRFs and state are the incumbent's, and CEM's refit is the
    clipped floor."""
    ref_all = load("long_horizon")
    for method in METHODS:
        jc, tc = _cfgs(**pair_over(name), **{"mpc.sampling.method": method})
        solve, P = make_sampling_solver(tc, N, device="cpu")
        inc, scene = _incumbent(P, 2), _scene(tc.mpc.horizon)
        key = f"zero/{name}/{method}"
        check_inputs(ref_all, key, jc, N, inc, *scene)
        ref = {k[len(key) + 1:]: v for k, v in ref_all.items() if k.startswith(key + "/")}
        st = sampling_state_from_numpy(inc, np.zeros(P, np.float32), seed=0, device="cpu")
        tout, st2 = solve(*scene, st)
        _check(tout, st2.best_parameters.numpy(), st2.sigma.numpy(), ref, method == "cem_mppi",
               1e-6)


def test_plain_solver_matches_xla_on_its_noise():
    """(48, zero-order), P = 576, each method on the XLA solver's own noise (its
    key's draw, handed to the port's solve): the costs up to 1.25 times the lowest
    rtol 1e-5 (the drifted ones 1e-2, see NEAR) and the same argmin; for MPPI and CEM the
    update against JAX's step moved by the port's own softmax weights (a float32
    cost gap becomes a ~1e-3 relative weight gap at temperature 1)."""
    ref_all = load("long_horizon")
    for method in METHODS:
        jc, tc = _cfgs(False, **pair_over("48-zero_order"), **{"mpc.sampling.method": method})
        solve, P = make_fleet_sampling_solver(tc, N_NOISY, device="cpu")
        inc, sigma, scene = _incumbent(P, 4), _sigma(P), _scene(tc.mpc.horizon)
        key = f"noisy/{method}"
        check_inputs(ref_all, key, jc, N_NOISY, inc, sigma, NOISY_KEY, *scene)
        ref = {k[len(key) + 1:]: v for k, v in ref_all.items() if k.startswith(key + "/")}
        noise = _jax_noise(jc, method, jax.random.PRNGKey(NOISY_KEY), jnp.asarray(sigma))
        assert np.any(noise[:, 1:] != 0.0)

        def t(x):
            return torch.as_tensor(np.array(x, np.float32))[None]

        st = FleetSamplingState(t(inc), t(sigma), torch.zeros(1, dtype=torch.int64),
                                torch.zeros(1, dtype=torch.int64))
        out, st2 = solve(*(t(x) for x in scene), st, noise=[t(noise)])
        costs, want_costs = out.costs[0].double().numpy(), ref["costs"].astype(np.float64)
        near = want_costs < NEAR * want_costs.min()
        assert near.sum() >= 8
        np.testing.assert_allclose(costs[near], want_costs[near], rtol=TOL)
        np.testing.assert_allclose(costs[~near], want_costs[~near], rtol=FAR_RTOL)
        assert int(np.argmin(costs)) == int(np.argmin(want_costs))
        want = np.asarray(ref["best_parameters"], np.float64)
        if method != "random_sampling":
            def weights(c):
                w = np.exp(-(c - c.min()) / tc.mpc.sampling.mppi_temperature)
                return w / w.sum()

            want = want + noise.astype(np.float64) @ (weights(costs) - weights(want_costs))
        assert not np.allclose(want, inc, atol=1e-3)  # the samples moved the solution
        np.testing.assert_allclose(st2.best_parameters[0].numpy(), want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out.grfs[0].numpy(), ref["grfs"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out.predicted_state[0].numpy(), ref["predicted_state"],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(float(out.best_cost[0]), float(ref["best_cost"]), rtol=TOL)
        if method == "cem_mppi":
            np.testing.assert_allclose(st2.sigma[0].numpy(), ref["sigma"], rtol=TOL, atol=TOL)
