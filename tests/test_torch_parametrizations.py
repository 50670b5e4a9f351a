"""The linear-spline and zero-order parametrizations of the port (plain torch path)
against the JAX package's solvers, and the basis windows the CUDA kernels take for
them.

At horizon 12 with 2 splines, linear splines have 9 parameters per leg and
zero-order holds 36 (cubic splines, the main path, 24). The kernels are built for
these three (horizon, parameters per leg) pairs; each basis row reaches them as
its window of four weights. Solvers are compared at zero noise with a
nonzero incumbent, as in test_torch_sampling.py, with its tolerances
(tests/test_pallas_solvers.py:66-73): GRFs and the predicted state 1e-5, the best
cost rtol 1e-4, the best parameters atol 1e-6; CEM's refit sigma atol 1e-6. The
gait-adaptive solver keeps test_torch_gait_adaptive.py's: GRFs atol 1e-4, costs
and the state rtol 1e-5, parameters atol 1e-5, sigma rtol 2e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu import replace_config as jax_replace_config
from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxState
from quadruped_pympc_tamols_tpu.controllers.sampling import gait_adaptive as jga
from quadruped_pympc_tamols_tpu.controllers.sampling import make_sampling_solver as jax_solver
from quadruped_pympc_tamols_tpu.ops import make_pallas_sampling_solver
from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.sampling import (group_operators, host_best_freq,
                                                               make_gait_adaptive_solver,
                                                               make_sampling_solver)
from quadruped_pympc_tamols_torch.controllers.sampling.splines import make_step_major_basis
from quadruped_pympc_tamols_torch.interop import config_from_dict, sampling_state_from_numpy
from quadruped_pympc_tamols_torch.ops import build
from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk

torch.set_num_threads(1)
N = 256
NEW = ("linear_spline", "zero_order")


def _cfgs(**over):
    """(jax cfg, port cfg) at zero exploration noise."""
    over = {"mpc.sampling.sigma_random": (0.0, 0.0, 0.0), "mpc.sampling.sigma_mppi": 0.0,
            **over}
    j = jax_replace_config(jax_make_config("aliengo", mpc_type="sampling"), **over)
    return j, config_from_dict(dataclasses.asdict(j))


def _scene(H):
    state12 = np.zeros(12, np.float32)
    state12[2], state12[3] = 0.31, 0.1
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                    np.float32)
    ref12 = np.zeros(12, np.float32)
    ref12[2], ref12[3] = 0.35, 0.2
    seq = np.ones((4, H), np.float32)
    seq[1, H // 2:] = seq[2, H // 2:] = 0.0
    return state12, feet, ref12, feet + np.float32(0.05), seq


def _run_both(jsolve, P, tcfg, inc, n):
    """One zero-noise solve of the JAX solver and of the port's CPU solver, all legs
    in stance now and before (no lift-off reset)."""
    state12, feet, ref12, ref_feet, seq = _scene(tcfg.mpc.horizon)
    cur = np.ones(4, np.float32)
    jst = JaxState(jnp.asarray(inc), jax.random.PRNGKey(0), jnp.zeros(P, jnp.float32))
    jout, _ = jsolve(*(jnp.asarray(x) for x in (state12, feet, ref12, ref_feet, seq, cur, cur)),
                     jst)
    tsolve, P2 = make_sampling_solver(tcfg, n, device="cpu")
    assert P2 == P
    tst = sampling_state_from_numpy(inc, np.zeros(P, np.float32), seed=0, device="cpu")
    tout, _ = tsolve(state12, feet, ref12, ref_feet, seq, cur, cur, tst)
    return jout, tout


def _assert_same(jout, tout):
    np.testing.assert_allclose(tout.grfs.numpy(), np.asarray(jout.grfs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout.predicted_state.numpy(), np.asarray(jout.predicted_state),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tout.best_cost), float(jout.best_cost), rtol=1e-4)
    np.testing.assert_allclose(tout.best_parameters.numpy(), np.asarray(jout.best_parameters),
                               atol=1e-6)


def _incumbent(P, seed):
    return (np.random.default_rng(seed).standard_normal(P) * 3.0).astype(np.float32)


@pytest.mark.parametrize("parametrization", NEW)
def test_softmax_methods_match_xla_at_zero_noise(parametrization):
    """MPPI and CEM-MPPI, one iteration each, against the XLA solver."""
    for method in ("mppi", "cem_mppi"):
        jc, tc = _cfgs(**{"mpc.sampling.parametrization": parametrization,
                          "mpc.sampling.method": method})
        xla, P = jax_solver(jc, num_samples=N)
        assert P == {"linear_spline": 36, "zero_order": 144}[parametrization]
        jout, tout = _run_both(xla, P, tc, _incumbent(P, 2), N)
        _assert_same(jout, tout)
        if method == "cem_mppi":
            # Every elite is the incumbent: the refit sigma is the clipped floor.
            np.testing.assert_allclose(tout.sigma.numpy(), np.asarray(jout.sigma), atol=1e-6)


def test_zero_order_matches_pallas_at_zero_noise():
    """Random sampling against the Pallas solver in interpret mode, at horizon 2
    (6 parameters per leg) and one 128-sample tile, as test_torch_sampling.py does
    for the main path."""
    jc, tc = _cfgs(**{"mpc.horizon": 2, "mpc.sampling.parametrization": "zero_order"})
    pallas, P = make_pallas_sampling_solver(jc, num_samples=128, interpret=True, tile=128)
    assert P == 24
    jout, tout = _run_both(pallas, P, tc, _incumbent(P, 3), 128)
    _assert_same(jout, tout)


def test_gait_adaptive_zero_order_matches_jax_at_zero_noise():
    """The gait-adaptive solver with zero-order holds (each group's one-hot basis
    follows its stance counters) against JAX make_gait_adaptive_solver, random
    sampling and CEM-MPPI, with optimize_swing: the 1.3 Hz group (not the first)
    wins. Two groups of 49, the last sample not evaluated."""
    n = 99
    for method in ("random_sampling", "cem_mppi"):
        jc, tc = _cfgs(**{"mpc.sampling.parametrization": "zero_order",
                          "mpc.step_freq_available": (2.4, 1.3), "mpc.sampling.method": method})
        jsolve, P = jga.make_gait_adaptive_solver(jc, n)
        assert P == 144
        inc = _incumbent(P, 4)
        state12, feet, ref12, ref_feet, seq = _scene(tc.mpc.horizon)
        phase = np.array([0.1, 0.6, 0.6, 0.1], np.float32)
        cur, prev = seq[:, 0].copy(), np.ones(4, np.float32)
        jst = JaxState(jnp.asarray(inc), jax.random.PRNGKey(0), jnp.zeros(P, jnp.float32))
        jout, _ = jsolve(*(jnp.asarray(x) for x in (state12, feet, ref12, ref_feet, phase)),
                         jnp.float32(1.4), jnp.asarray(True),
                         *(jnp.asarray(x) for x in (seq, cur, prev)), jst)
        solve, _ = make_gait_adaptive_solver(tc, n, device="cpu")
        tout, _ = solve(state12, feet, ref12, ref_feet, phase, 1.4, True, seq, cur, prev,
                        sampling_state_from_numpy(inc, np.zeros(P), seed=0, device="cpu"))
        assert tout.costs.shape == (98,)
        np.testing.assert_allclose(tout.costs.numpy(), np.asarray(jout.costs), rtol=1e-5)
        assert host_best_freq(tout) == float(jout.best_freq) == float(np.float32(1.3))
        np.testing.assert_allclose(tout.grfs.numpy(), np.asarray(jout.grfs), rtol=0, atol=1e-4)
        np.testing.assert_allclose(tout.predicted_state.numpy(), np.asarray(jout.predicted_state),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tout.best_parameters.numpy(), np.asarray(jout.best_parameters),
                                   atol=1e-5)
        if method == "cem_mppi":
            np.testing.assert_allclose(tout.sigma.numpy(), np.asarray(jout.sigma), rtol=2e-5)


def test_padded_basis_blocks_reproduce_the_step_major_basis():
    """The kernels' basis layouts, with numpy: the static basis windows
    (``RSPlan.windows``) and the group buffer's windows (``pack_groups``), four
    weights and the leg-major index of the first parameter a row, at linear
    splines' 9 parameters per leg, cubic splines' 24 and zero-order holds' 36;
    placed back on their rows they give make_step_major_basis and the groups'
    dense bases. Every pair passes the shape check, horizon 10 and horizon 25 with
    cubic splines too; a pair beyond the kernels' bounds (horizon 129, zero-order
    holds at horizon 86, 22 cubic splines: P = 4 * P_leg > 1024) raises and names
    them."""
    def dense_of(win, P_leg):
        cols = win[..., 4].copy().view(np.int32)[..., None] + np.arange(sk.WINDOW)
        out = np.zeros(win.shape[:-1] + (4 * P_leg,), np.float32)
        np.put_along_axis(out, cols, win[..., :sk.WINDOW], axis=-1)
        return out

    for parametrization, P_leg in (("cubic_spline", 24), ("linear_spline", 9),
                                   ("zero_order", 36)):
        cfg = make_config("aliengo", **{"mpc.sampling.parametrization": parametrization,
                                        "mpc.optimize_step_freq": True})
        plan = sk.make_rs_plan(cfg, 64, "cpu")
        assert (plan.horizon, plan.params_per_leg) in build.MAIN_PAIRS
        assert plan.params_per_leg == P_leg
        sk.check_kernel_shape(plan)
        H = plan.horizon
        win = plan.windows.numpy()
        assert win.shape == (H * 12, sk.WINDOW_FLOATS) and not win[:, 5:].any()
        np.testing.assert_array_equal(dense_of(win, P_leg),
                                      make_step_major_basis(parametrization, H, 2))
        groups = group_operators(cfg, np.array([0.3, 0.8, 0.8, 0.3], np.float32),
                                 np.asarray(cfg.mpc.step_freq_available, np.float32))
        K = groups.blocks.shape[0]
        packed = sg.pack_groups(groups)[:K * H * 12 * sk.WINDOW_FLOATS].reshape(
            K, H * 12, sk.WINDOW_FLOATS)
        np.testing.assert_array_equal(dense_of(packed, P_leg), groups.dense("cpu").numpy())
    for over in ({"mpc.horizon": 10}, {"mpc.horizon": 25}):
        sk.check_kernel_shape(sk.make_rs_plan(make_config("aliengo", **over), 64, "cpu"))
    for over in ({"mpc.horizon": 129},
                 {"mpc.horizon": 86, "mpc.sampling.parametrization": "zero_order"},
                 {"mpc.sampling.num_splines": 22}):
        plan = sk.make_rs_plan(make_config("aliengo", **over), 64, "cpu")
        with pytest.raises(NotImplementedError, match=r"horizon <= 128 and 4 <= parameters per "
                                                      r"leg <= 256 \(P = 4 \* P_leg <= 1024"):
            sk.check_kernel_shape(plan)
