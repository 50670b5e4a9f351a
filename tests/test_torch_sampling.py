"""The port's sampling MPC (plain torch path) against the JAX package's solvers.

The random streams differ by construction (threefry, the TPU's on-core PRNG,
Philox / torch.Generator), so solvers are compared at zero noise with a nonzero
incumbent carried over through ``interop`` (the kernel's plain version on
injected noise is in test_torch_sampling_kernel.py). Tolerances follow tests/test_pallas_solvers.py:66-73: GRFs and
the predicted state 1e-5, best cost rtol 1e-4, best parameters atol 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu import replace_config as jax_replace_config
from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxState
from quadruped_pympc_tamols_tpu.controllers.sampling import make_sampling_solver as jax_solver
from quadruped_pympc_tamols_tpu.ops import make_pallas_sampling_solver
from quadruped_pympc_tamols_torch.controllers.sampling import make_sampling_solver
from quadruped_pympc_tamols_torch.interop import config_from_dict, sampling_state_from_numpy

torch.set_num_threads(1)
N = 256


def _cfgs(**over):
    """(jax cfg, port cfg) at zero exploration noise."""
    over = {"mpc.sampling.sigma_random": (0.0, 0.0, 0.0), "mpc.sampling.sigma_mppi": 0.0,
            **over}
    j = jax_replace_config(jax_make_config("aliengo", mpc_type="sampling"), **over)
    return j, config_from_dict(dataclasses.asdict(j))


def _scene(H=12):
    state12 = np.zeros(12, np.float32)
    state12[2], state12[3] = 0.31, 0.1
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                    np.float32)
    ref12 = np.zeros(12, np.float32)
    ref12[2], ref12[3] = 0.35, 0.2
    ref_feet = feet + np.float32(0.05)
    seq = np.ones((4, H), np.float32)
    seq[1, 6:] = seq[2, 6:] = 0.0
    return state12, feet, ref12, ref_feet, seq


def _incumbent(P, seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal(P) * scale).astype(np.float32)


def _run_both(jsolve, P, tcfg, inc, cur, prev, sigma=0.0, method=None, n=N):
    state12, feet, ref12, ref_feet, seq = _scene(tcfg.mpc.horizon)
    jst = JaxState(jnp.asarray(inc), jax.random.PRNGKey(0), jnp.full(P, sigma, jnp.float32))
    jout, jnew = jsolve(jnp.asarray(state12), jnp.asarray(feet), jnp.asarray(ref12),
                        jnp.asarray(ref_feet), jnp.asarray(seq), jnp.asarray(cur),
                        jnp.asarray(prev), jst)
    tsolve, P2 = make_sampling_solver(tcfg, n, method, device="cpu")
    assert P2 == P
    tst = sampling_state_from_numpy(inc, np.full(P, sigma, np.float32), seed=0, device="cpu")
    tout, tnew = tsolve(state12, feet, ref12, ref_feet, seq, cur, prev, tst)
    return jout, tout, tnew


def _assert_same(jout, tout):
    np.testing.assert_allclose(tout.grfs.numpy(), np.asarray(jout.grfs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout.predicted_state.numpy(), np.asarray(jout.predicted_state),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tout.best_cost), float(jout.best_cost), rtol=1e-4)
    np.testing.assert_allclose(tout.best_parameters.numpy(), np.asarray(jout.best_parameters),
                               atol=1e-6)


def test_random_sampling_matches_xla_at_zero_noise():
    jc, tc = _cfgs()
    xla, P = jax_solver(jc, num_samples=N)
    assert P == 96
    cur = np.array([1, 1, 1, 1], np.float32)
    jout, tout, tnew = _run_both(xla, P, tc, _incumbent(P), cur, cur)
    _assert_same(jout, tout)
    assert tout.costs.shape == (N,)
    assert torch.all(tout.costs == tout.costs[0])  # every candidate is the incumbent
    assert tnew.offset == 1


def test_random_sampling_matches_pallas_at_zero_noise():
    """Against the Pallas solver in interpret mode, at horizon 2 and one 128-sample
    tile: the interpret-mode compile grows with the unrolled horizon (5 s at
    H = 2, 13 s at H = 4, ~40 s at H = 12 on one CPU core), and the XLA test above
    covers H = 12."""
    jc, tc = _cfgs(**{"mpc.horizon": 2})
    pallas, P = make_pallas_sampling_solver(jc, num_samples=128, interpret=True, tile=128)
    assert P == 96
    cur = np.array([1, 1, 1, 1], np.float32)
    jout, tout, _ = _run_both(pallas, P, tc, _incumbent(P), cur, cur, n=128)
    _assert_same(jout, tout)


@pytest.mark.parametrize("over", [
    {"mpc.sampling.equilibrium_share": True},
    {"mpc.sampling.shift_solution": True},
    {"mpc.sampling.zmp_weight": 500.0},
    {"mpc.sampling.parametrization": "linear_spline"},
])
def test_random_sampling_options_match_xla(over):
    """Options the XLA solver honours (the Pallas one ignores the share and shift)."""
    jc, tc = _cfgs(**over)
    xla, P = jax_solver(jc, num_samples=N)
    jout, tout, _ = _run_both(xla, P, tc, _incumbent(P, 1), np.ones(4, np.float32),
                              np.ones(4, np.float32))
    _assert_same(jout, tout)


@pytest.mark.parametrize("method", ["mppi", "cem_mppi"])
def test_softmax_methods_match_xla_at_zero_noise(method):
    jc, tc = _cfgs(**{"mpc.sampling.method": method})
    xla, P = jax_solver(jc, num_samples=N)
    # CEM draws with the carried per-parameter sigma: zero it too.
    jout, tout, tnew = _run_both(xla, P, tc, _incumbent(P, 2), np.ones(4, np.float32),
                                 np.ones(4, np.float32), sigma=0.0)
    _assert_same(jout, tout)
    if method == "cem_mppi":
        # All elites equal the incumbent: the refit sigma is the clipped floor.
        np.testing.assert_allclose(tnew.sigma.numpy(), np.asarray(jout.sigma), atol=1e-6)


@pytest.mark.parametrize("method", ["random_sampling", "mppi"])
def test_chained_solve_matches_xla_at_zero_noise(method):
    """Three chained iterations a solve (num_iterations = 3) against the XLA
    solver's scan; the offset advances by one per iteration."""
    jc, tc = _cfgs(**{"mpc.sampling.method": method, "mpc.sampling.num_iterations": 3})
    xla, P = jax_solver(jc, num_samples=N)
    jout, tout, tnew = _run_both(xla, P, tc, _incumbent(P, 5), np.ones(4, np.float32),
                                 np.ones(4, np.float32))
    _assert_same(jout, tout)
    assert tnew.offset == 3


def test_liftoff_reset_and_swing_feet_match_xla():
    """FR lifts off this tick: its incumbent block resets to zero, and its foot is
    replaced by its reference foothold."""
    jc, tc = _cfgs()
    xla, P = jax_solver(jc, num_samples=N)
    cur = np.array([1, 0, 1, 1], np.float32)
    prev = np.ones(4, np.float32)
    inc = _incumbent(P, 3)
    jout, tout, _ = _run_both(xla, P, tc, inc, cur, prev)
    _assert_same(jout, tout)
    best = tout.best_parameters.numpy()
    assert np.all(best[24:48] == 0.0) and np.all(best[:24] == inc[:24])


def test_shift_solution_moves_first_knots():
    jc, tc = _cfgs(**{"mpc.sampling.shift_solution": True})
    xla, P = jax_solver(jc, num_samples=N)
    inc = _incumbent(P, 4)
    jout, tout, _ = _run_both(xla, P, tc, inc, np.ones(4, np.float32), np.ones(4, np.float32))
    best = tout.best_parameters.numpy().reshape(4, 24)
    assert not np.allclose(best[:, [1, 5, 9]], inc.reshape(4, 24)[:, [1, 5, 9]])
    np.testing.assert_allclose(tout.best_parameters.numpy(), np.asarray(jout.best_parameters),
                               atol=1e-6)


def test_real_noise_solves_improve_and_stay_finite():
    """With real noise the CPU solve chain keeps finite GRFs and its best cost
    never exceeds the incumbent's (the incumbent is always candidate 0)."""
    tc = config_from_dict(dataclasses.asdict(jax_make_config("aliengo")))
    solve, P = make_sampling_solver(tc, N, device="cpu")
    state12, feet, ref12, ref_feet, seq = _scene()
    st = sampling_state_from_numpy(np.zeros(P), np.full(P, 3.0), seed=7, device="cpu")
    ones = np.ones(4, np.float32)
    for k in range(3):
        out, st = solve(state12, feet, ref12, ref_feet, seq, ones, ones, st)
        assert float(out.best_cost) <= float(out.costs[0])
        assert torch.isfinite(out.grfs).all() and st.offset == k + 1
        fz = out.grfs[:, 2]
        assert torch.all(fz >= 0) and abs(float(fz.sum()) - 24.637 * 9.81) < 150.0


def test_cuda_solver_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tc = _cfgs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_sampling_solver(tc, N)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sampling_state_from_numpy(np.zeros(96), np.zeros(96), 0)
