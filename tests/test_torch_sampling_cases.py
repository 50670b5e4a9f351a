"""The sampling configurations the CUDA kernels took last, on the port's plain
versions on the CPU against the JAX package's XLA solvers: the ZMP-band cost
(``sampling.zmp_weight`` 500 with ``equilibrium_share``, the stone-field entry's
knobs), (horizon, splines) pairs other than the flagship's, and CEM with more
elites than the kernels' per-block key lists hold (K = 33 and 100).

Noise is injected or zero, never a shared seed: ``SamplingMPC``'s solver and the
gait-adaptive one run at zero exploration noise around a nonzero incumbent, as
``test_torch_parametrizations.py`` runs them (its tolerances: GRFs and the
predicted state 1e-5, the best cost rtol 1e-4, the parameters atol 1e-6; the
gait-adaptive costs rtol 1e-5); ``make_fleet_sampling_solver`` runs on the JAX
solver's own noise rebuilt from its keys, as ``test_torch_fleet.py`` runs it
(every output rtol and atol 1e-5, the softmax update against JAX's moved by the
port's own weights). The elite sets are exact: jax.lax.top_k's on JAX's costs
equal ``cem_elites`` on the port's.

``python tests/test_torch_sampling_cases.py [row ...]`` prints the JAX package's
SRB walks with the stone-field knobs that ``chip_smoke.py`` phase 32 prints
beside the card's (``JAX_CPU_ZMP_WALKS``; ~20-90 s a walk).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu import replace_config as jax_replace_config
from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxState
from quadruped_pympc_tamols_tpu.controllers.sampling import gait_adaptive as jga
from quadruped_pympc_tamols_tpu.controllers.sampling import make_sampling_solver as jax_solver
from quadruped_pympc_tamols_torch.controllers.sampling import (FleetSamplingState,
                                                               make_fleet_sampling_solver,
                                                               make_gait_adaptive_solver,
                                                               make_sampling_solver)
from quadruped_pympc_tamols_torch.interop import config_from_dict, sampling_state_from_numpy
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

threadpool_limits(1)
torch.set_num_threads(1)
N = 96  # samples of a zero-noise solve
S, NF = 2, 150  # scenarios and samples of a fleet solve on the JAX noise
SOLVE_TOL = 1e-5
ZMP = {"mpc.sampling.zmp_weight": 500.0, "mpc.sampling.equilibrium_share": True}
# (horizon, parametrization, splines) of chip_smoke.py phase 33's grid held here.
PAIRS = {"8-cubic-2": (8, "cubic_spline", 2), "12-linear-4": (12, "linear_spline", 4)}


def cfgs(zero_noise=False, **over):
    """(JAX config, port config) with ``over``; exploration noise off on request."""
    if zero_noise:
        over = {"mpc.sampling.sigma_random": (0.0, 0.0, 0.0), "mpc.sampling.sigma_mppi": 0.0,
                **over}
    j = jax_replace_config(jax_make_config("aliengo", mpc_type="sampling"), **over)
    return j, config_from_dict(dataclasses.asdict(j))


def trot(H, S=None):
    """A trot's contact sequence (4, H): the diagonals in turn, two steps each
    with a four-stance step between, and the scene around it: a base 5 cm off
    the diagonals' crossing moving forward, its feet and their references."""
    seq = np.ones((4, H), np.float32)
    for n in range(H):
        if n % 5 in (1, 2):
            seq[[1, 2], n] = 0.0
        elif n % 5 in (3, 4):
            seq[[0, 3], n] = 0.0
    state12 = np.zeros(12, np.float32)
    state12[1:5] = 0.05, 0.31, 0.1, 0.02
    feet = np.array([[0.27, 0.16, 0], [0.27, -0.16, 0], [-0.25, 0.16, 0.05], [-0.25, -0.16, 0]],
                    np.float32)
    ref12 = np.zeros(12, np.float32)
    ref12[1:4] = 0.05, 0.33, 0.3
    return state12, feet, ref12, (feet + np.float32(0.05)).astype(np.float32), seq


def solve_both(jc, tc, inc, n=N):
    """One zero-noise solve of the JAX XLA solver and of the port's CPU solver at
    the trot tick, all legs in stance now and before."""
    xla, P = jax_solver(jc, num_samples=n)
    state12, feet, ref12, ref_feet, seq = trot(tc.mpc.horizon)
    cur = np.ones(4, np.float32)
    jst = JaxState(jnp.asarray(inc[:P]), jax.random.PRNGKey(0), jnp.zeros(P, jnp.float32))
    jout, _ = xla(*(jnp.asarray(x) for x in (state12, feet, ref12, ref_feet, seq, cur, cur)), jst)
    solve, P2 = make_sampling_solver(tc, n, device="cpu")
    assert P2 == P
    tout, _ = solve(state12, feet, ref12, ref_feet, seq, cur, cur,
                    sampling_state_from_numpy(inc[:P], np.zeros(P, np.float32), seed=0,
                                              device="cpu"))
    np.testing.assert_allclose(tout.grfs.numpy(), np.asarray(jout.grfs), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tout.predicted_state.numpy(), np.asarray(jout.predicted_state),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tout.best_cost), float(jout.best_cost), rtol=1e-4)
    np.testing.assert_allclose(tout.best_parameters.numpy(), np.asarray(jout.best_parameters),
                               atol=1e-6)
    return jout, tout


def check_band(port, port0, jax_, jax0):
    """The band as each package adds it (its costs at weight 500 less its costs at
    weight 0 on the same inputs, where the rest of the cost cancels to the running
    sum's rounding) equal to 2e-3 plus 1e-6 of the cost; active (above 0.05) on at
    least a tenth of the samples. Returns the port's band."""
    band, jband = np.asarray(port) - np.asarray(port0), np.asarray(jax_) - np.asarray(jax0)
    np.testing.assert_allclose(band, jband, rtol=0,
                               atol=2e-3 + 1e-6 * float(np.abs(np.asarray(jax_)).max()))
    assert (jband > 0.05).sum() >= max(1, jband.size // 10)
    return band


def incumbent(seed, P=400):
    return (np.random.default_rng(seed).standard_normal(P) * 3.0).astype(np.float32)


def jax_noise(cfg, method, n):
    """jit(vmap(key, sigma) -> noise (P, n)): the JAX solver's own draw of its first
    iteration (JAX sampling_mpc.py:104-123 after the split at :157)."""
    sp = cfg.mpc.sampling

    def draw(key, sigma):
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
        return noise.astype(jnp.float32)

    return jax.jit(jax.vmap(draw))


def fleet_both(jc, tc, seed=11):
    """One solve of S scenarios of the trot tick (each nudged) by jax.vmap of the
    JAX XLA solver and by the port's fleet solver on its noise. Returns (jax
    output, jax state, port output, port state, noise)."""
    method = tc.mpc.sampling.method
    rng = np.random.default_rng(seed)
    jsolve, P = jax_solver(jc, NF)
    state12, feet, ref12, ref_feet, seq = trot(tc.mpc.horizon)
    inputs = [np.repeat(x[None], S, 0) for x in (state12, feet, ref12, ref_feet, seq)]
    inputs[0] = (inputs[0] + 0.01 * rng.standard_normal((S, 12))).astype(np.float32)
    inputs[1] = (inputs[1] + 0.01 * rng.standard_normal((S, 4, 3))).astype(np.float32)
    cur = inputs[4][:, :, 0].copy()
    inputs += [cur, np.ones((S, 4), np.float32)]
    best = (0.5 * rng.standard_normal((S, P))).astype(np.float32)
    sigma = (0.5 + rng.random((S, P))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    jout, jst = jax.jit(jax.vmap(jsolve))(*(jnp.asarray(a) for a in inputs),
                                          JaxState(jnp.asarray(best), keys, jnp.asarray(sigma)))
    noise = np.asarray(jax_noise(jc, method, NF)(keys, jnp.asarray(sigma)))
    solve, P2 = make_fleet_sampling_solver(tc, NF, device="cpu")
    assert P2 == P

    def t(a):
        return torch.as_tensor(np.asarray(a))

    st = FleetSamplingState(t(best), t(sigma), torch.arange(S), torch.zeros(S, dtype=torch.int64))
    out, st2 = solve(*(t(a) for a in inputs), st, noise=[t(noise)])
    np.testing.assert_allclose(out.costs.numpy(), np.asarray(jout.costs), rtol=SOLVE_TOL)
    want = np.asarray(jst.best_parameters, np.float64)
    if method != "random_sampling":
        # The softmax weights turn the costs' float32 gap into a ~1e-3 relative
        # weight gap: JAX's step is moved by the port's own weights.
        def weights(c):
            w = np.exp(-(c - c.min(1, keepdims=True)) / tc.mpc.sampling.mppi_temperature)
            return w / w.sum(1, keepdims=True)

        want = want + np.einsum("spn,sn->sp", noise.astype(np.float64),
                                weights(out.costs.double().numpy())
                                - weights(np.asarray(jout.costs, np.float64)))
    np.testing.assert_allclose(st2.best_parameters.numpy(), want, rtol=SOLVE_TOL, atol=SOLVE_TOL)
    for got, w in ((out.grfs, jout.grfs), (out.predicted_state, jout.predicted_state),
                   (st2.sigma, jst.sigma)):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=SOLVE_TOL, atol=SOLVE_TOL)
    return jout, jst, out, st2, noise


# -- the ZMP band ----------------------------------------------------------------------

def test_zmp_band_sampling_solver_matches_jax():
    """SamplingMPC's solver (random sampling) at zero noise: the port's solve with
    the band equals JAX's, and so does the band itself."""
    (j, t), (j0, t0) = [solve_both(*cfgs(True, **{**ZMP, "mpc.sampling.zmp_weight": w}),
                                   incumbent(1)) for w in (500.0, 0.0)]
    check_band([float(t.best_cost)], [float(t0.best_cost)], [float(j.best_cost)],
               [float(j0.best_cost)])


def test_zmp_band_gait_adaptive_matches_jax():
    """The gait-adaptive solver (three step frequencies, each group with its own
    timer contact) at zero noise: every group's cost with the band equals JAX's,
    and so does the band."""
    costs, jcosts = {}, {}
    for w in (500.0, 0.0):
        jc, tc = cfgs(True, **{**ZMP, "mpc.sampling.zmp_weight": w,
                               "mpc.step_freq_available": (1.4, 2.0, 2.4),
                               "mpc.sampling.method": "mppi"})
        jsolve, P = jga.make_gait_adaptive_solver(jc, 99)
        inc = incumbent(4)[:P]
        state12, feet, ref12, ref_feet, seq = trot(tc.mpc.horizon)
        phase = np.array([0.1, 0.6, 0.6, 0.1], np.float32)
        cur, prev = seq[:, 0].copy(), np.ones(4, np.float32)
        jst = JaxState(jnp.asarray(inc), jax.random.PRNGKey(0), jnp.zeros(P, jnp.float32))
        jout, _ = jsolve(*(jnp.asarray(x) for x in (state12, feet, ref12, ref_feet, phase)),
                         jnp.float32(1.4), jnp.asarray(True),
                         *(jnp.asarray(x) for x in (seq, cur, prev)), jst)
        solve, _ = make_gait_adaptive_solver(tc, 99, device="cpu")
        tout, _ = solve(state12, feet, ref12, ref_feet, phase, 1.4, True, seq, cur, prev,
                        sampling_state_from_numpy(inc, np.zeros(P), seed=0, device="cpu"))
        np.testing.assert_allclose(tout.costs.numpy(), np.asarray(jout.costs), rtol=1e-5)
        np.testing.assert_allclose(tout.grfs.numpy(), np.asarray(jout.grfs), atol=1e-4)
        costs[w], jcosts[w] = tout.costs.numpy(), np.asarray(jout.costs)
    check_band(costs[500.0], costs[0.0], jcosts[500.0], jcosts[0.0])


def test_zmp_band_fleet_solver_matches_jax():
    """make_fleet_sampling_solver on the JAX solver's own noise (CEM-MPPI): costs,
    update, GRFs, state and sigma against jax.vmap of the XLA solver, and the band
    against JAX's."""
    method = "cem_mppi"
    jout, _, out, _, _ = fleet_both(*cfgs(**ZMP, **{"mpc.sampling.method": method}))
    jout0, _, out0, _, _ = fleet_both(*cfgs(**{**ZMP, "mpc.sampling.zmp_weight": 0.0,
                                                "mpc.sampling.method": method}))
    check_band(out.costs.numpy(), out0.costs.numpy(), jout.costs, jout0.costs)


# -- other (horizon, splines) pairs -----------------------------------------------------

@pytest.mark.parametrize("pair", list(PAIRS))
def test_pairs_match_jax(pair):
    """At two pairs of phase 33's grid: SamplingMPC's solver at zero noise (random
    sampling) and the fleet solver on the JAX noise (CEM-MPPI) against the JAX
    solvers, the plan's parameters per leg those of the pair."""
    H, par, ns = PAIRS[pair]
    over = {"mpc.horizon": H, "mpc.sampling.parametrization": par,
            "mpc.sampling.num_splines": ns}
    solve_both(*cfgs(True, **over), incumbent(2))
    jc, tc = cfgs(**over, **{"mpc.sampling.method": "cem_mppi"})
    _, jst, _, _, _ = fleet_both(jc, tc)
    assert jst.best_parameters.shape[1] == {"8-cubic-2": 96, "12-linear-4": 60}[pair]


# -- CEM above the key lists ------------------------------------------------------------

@pytest.mark.parametrize("n_elite", [33, 100])
def test_large_cem_elites_match_jax(n_elite):
    """CEM-MPPI with K = 33 and 100 of 150 samples on the JAX noise: the refit sigma
    against JAX's, and the elite set exactly jax.lax.top_k's on JAX's costs."""
    jc, tc = cfgs(**{"mpc.sampling.method": "cem_mppi", "mpc.sampling.cem_elite": n_elite})
    jout, _, out, _, _ = fleet_both(jc, tc, seed=13)
    got = sm.cem_elites(out.costs, n_elite)
    want = np.asarray(jax.lax.top_k(-jout.costs, n_elite)[1])
    for s in range(S):
        assert sorted(got[s].tolist()) == sorted(want[s].tolist())


# The JAX package's SRB walks with the stone-field knobs, as chip_smoke.py phase 32
# walks the port (3 s at 0.3 m/s; blind on flat ground, TAMOLS over the 5 cm step
# of phases 16-17, sensed as test_torch_tamols.py senses it): row -> (samples,
# foothold strategy, terrain).
ZMP_WALKS = {0: (2000, "blind", "flat"), 1: (2000, "tamols", "step"),
             2: (10_000, "blind", "flat"), 3: (10_000, "tamols", "step")}


def jax_zmp_walk(num_samples, strategy, terrain, duration=3.0):
    """(distance (m), min z (m), max |roll|,|pitch| (rad)) of the JAX harness."""
    from quadruped_pympc_tamols_tpu.sim import SRBClosedLoopHarness
    from test_torch_tamols import WALK_TERRAINS, _sense_jax

    cfg = jax_make_config("aliengo", mpc_type="sampling", **{
        **ZMP, "mpc.sampling.method": "random_sampling",
        "mpc.sampling.num_samples": num_samples, "sim.visual_foothold_adaptation": strategy})
    fn = WALK_TERRAINS[terrain]
    h = SRBClosedLoopHarness(cfg, seed=0, terrain_fn=fn)
    n = int(round(duration / cfg.sim.dt))
    hist = np.zeros((n, 12))
    for i in range(n):
        hist[i] = h.step(np.array([0.3, 0.0, 0.0]),
                         heightmaps=_sense_jax(h.wb, fn, h.x[8], cfg.tamols))
    return (float(hist[-1, 0] - hist[0, 0]), float(hist[:, 2].min()),
            float(np.abs(hist[:, 6:8]).max()))


if __name__ == "__main__":
    import conftest  # noqa: F401  (JAX on the CPU, as under pytest)

    for row in [int(a) for a in sys.argv[1:]] or list(ZMP_WALKS):
        print(row, ZMP_WALKS[row], "(distance, min z, max |roll|,|pitch|):",
              tuple(round(v, 4) for v in jax_zmp_walk(*ZMP_WALKS[row])), flush=True)
