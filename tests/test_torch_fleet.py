"""The port's scenario fleet (``parallel/scenario_engine.py``) against the JAX
package's on the CPU: the terrain generators on the JAX package's own draws, the
device twins of the gait planners, the batched TAMOLS adapter, the batched
sampling solve on the JAX solver's own noise, and closed loops of several
scenarios from one state carried across by ``interop.scenario_state_from_numpy``.

The port's random streams cannot match ``jax.random``, so nothing is compared by
a shared seed: the tests rebuild the JAX draws (the heightfields' lattices, the
solver's noise, JAX ``controllers/sampling/sampling_mpc.py:104-123``) from the
JAX keys and hand them to the port. Tolerances: the box and stair fields exactly
(comparisons and a product of the same float32 operands); perlin 1e-6 m (its
linear resize sums the lattice in another order); the twins 1e-6 (float32, other
fusion); the adapter's footholds 1e-6 m (the same cells, whose world xy XLA
forms with fused multiply-adds, so an ulp apart) and each scenario's slice
bit-equal to the one-robot scorer; the solve's costs rtol 1e-5, GRFs, states,
sigma and parameters 1e-5 (test_torch_softmax_kernel.py's; MPPI's and CEM's
parameters against JAX's step moved by the port's own softmax weights, which
amplify the costs' float32 gap); the closed loops' states 1e-4 over 30 ticks
(float32 SRB substeps drift apart by ulps a tick) and the reflex counts exactly.

``PYTHONPATH=. python tests/test_torch_fleet.py [scenarios seconds samples]``
prints the JAX package's perlin fleet walk (``chip_smoke.py``'s
``JAX_CPU_FLEET_WALK``: 8 3.0 10000, ~2-4 min)."""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxSamplingState
from quadruped_pympc_tamols_tpu.controllers.sampling import make_sampling_solver as jax_solver
from quadruped_pympc_tamols_tpu.gait.foothold_reference import raibert_footholds as j_raibert
from quadruped_pympc_tamols_tpu.gait.periodic import contact_sequence as j_contact
from quadruped_pympc_tamols_tpu.gait.swing import bezier_swing_refs as j_bezier
from quadruped_pympc_tamols_tpu.parallel import scenario_engine as jse
from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.sampling import (FleetSamplingState,
                                                               make_fleet_sampling_solver)
from quadruped_pympc_tamols_torch.gait import (bezier_swing_refs_torch, contact_sequence_torch,
                                               make_timer_dts, raibert_footholds_torch)
from quadruped_pympc_tamols_torch.interop import heightmaps_from_numpy, scenario_state_from_numpy
from quadruped_pympc_tamols_torch.parallel import (init_scenario_state, make_scenario_step,
                                                   make_terrain_adapter, make_terrain_generator)
from quadruped_pympc_tamols_torch.planner.tamols import make_tamols_scorer

torch.set_num_threads(1)
threadpool_limits(1)
N = 48  # samples a scenario
S = 3
CPU = "cpu"
TWIN_ATOL = 1e-6
ADAPT_ATOL = 1e-6  # m: the same cells, their world xy to an ulp
SOLVE_TOL = 1e-5
LOOP_ATOL = 1e-4


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.array(x), dtype=dtype)


def jax_draws(kind, key):
    """The random draws of the JAX generator ``make_terrain_generator(kind)(key)``
    (JAX ``parallel/scenario_engine.py:84-134``), rebuilt from its key."""
    if kind == "boxes":
        k1, k2, k3 = jax.random.split(key, 3)
        return dict(centers=jax.random.uniform(k1, (20, 2), minval=jnp.asarray([0.7, -2.0]),
                                               maxval=jnp.asarray([4.2, 2.0])),
                    half=jax.random.uniform(k2, (20, 2), minval=0.08, maxval=0.3),
                    heights=jax.random.uniform(k3, (20,), minval=0.02, maxval=0.08))
    k1, k2 = jax.random.split(key)
    if kind == "stairs":
        return dict(rise=jax.random.uniform(k1, minval=0.03, maxval=0.06),
                    run=jax.random.uniform(k2, minval=0.28, maxval=0.4))
    return dict(coarse=jax.random.uniform(k1, (9, 9), minval=-1.0, maxval=1.0),
                fine=jax.random.uniform(k2, (17, 17), minval=-1.0, maxval=1.0))


def stacked_draws(kind, keys):
    per = [jax_draws(kind, k) for k in keys]
    return {name: np.stack([np.asarray(d[name]) for d in per]) for name in per[0]}


@pytest.mark.parametrize("kind", ["boxes", "stairs", "perlin"])
def test_terrain_generators_match_jax_on_its_draws(kind):
    keys = jax.random.split(jax.random.PRNGKey(1), S)
    want = np.stack([np.asarray(jse.make_terrain_generator(kind)(k)) for k in keys])
    got = make_terrain_generator(kind, CPU).build(stacked_draws(kind, keys)).numpy()
    assert got.shape == (S, 64, 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 if kind == "perlin" else 0.0)
    assert np.all(got[:, :6] == 0.0)  # the flat spawn pad
    assert not np.allclose(got[0], got[1])
    # The port's own draws make distinct fields of the same shape and range.
    own = make_terrain_generator(kind, CPU)(torch.Generator().manual_seed(0), S).numpy()
    assert own.shape == (S, 64, 64) and np.all(own >= 0.0) and np.max(own) > 0.01
    assert np.all(own[:, :6] == 0.0) and not np.allclose(own[0], own[1])


def test_device_twins_match_jax():
    rng = np.random.default_rng(3)
    cfg = jax_make_config("aliengo", mpc_type="sampling")
    gp = cfg.gait_params
    t_off = make_timer_dts(make_config("aliengo", mpc_type="sampling").mpc)
    phase = rng.random((S, 4)).astype(np.float32)
    want = j_contact(jnp.asarray(phase), gp.step_freq, gp.duty_factor, jnp.asarray(t_off))
    got = contact_sequence_torch(_t(phase), gp.step_freq, gp.duty_factor, _t(t_off))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    pos = rng.normal(size=(S, 3)).astype(np.float32) * [1, 1, 0.05] + [0, 0, 0.35]
    rpy = (0.2 * rng.normal(size=(S, 3))).astype(np.float32)
    vel = (0.3 * rng.normal(size=(S, 2))).astype(np.float32)
    ref = (0.3 * rng.normal(size=(S, 2))).astype(np.float32)
    hips = (pos[:, None] + rng.normal(size=(S, 4, 3)) * 0.2).astype(np.float32)
    lz = (0.05 * rng.random((S, 4))).astype(np.float32)
    args = (gp.stance_time, cfg.robot.hip_height, cfg.sim.ref_z)
    want = j_raibert(*(jnp.asarray(a) for a in (pos, rpy, vel, ref, hips, lz)), *args)
    got = raibert_footholds_torch(*(_t(a) for a in (pos, rpy, vel, ref, hips, lz)), *args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TWIN_ATOL)

    t = (rng.random((S, 4)) * 0.3).astype(np.float32)
    period = (0.2 + 0.1 * rng.random((S, 4))).astype(np.float32)
    sh = (0.1 + 0.05 * rng.random((S, 4))).astype(np.float32)
    lo, td = (rng.normal(size=(2, S, 4, 3)) * 0.1).astype(np.float32)
    want = j_bezier(*(jnp.asarray(a) for a in (t, period, sh, lo, td)))
    got = bezier_swing_refs_torch(*(_t(a) for a in (t, period, sh, lo, td)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TWIN_ATOL * 10)


def _adapter_inputs(rng, terrain):
    """S scenarios walking over ``terrain`` (S, R, C): seeds, hips, base, yaw,
    contacts, feet and anchors."""
    base = np.stack([0.8 + 1.5 * rng.random(S), 0.2 * rng.normal(size=S),
                     0.35 + 0.02 * rng.random(S)], 1).astype(np.float32)
    yaw = (0.3 * rng.normal(size=S)).astype(np.float32)
    hip_b = np.array([[0.24, 0.13, 0], [0.24, -0.13, 0], [-0.24, 0.13, 0], [-0.24, -0.13, 0]])
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.stack([np.stack([c, -s, 0 * c], 1), np.stack([s, c, 0 * c], 1),
                    np.stack([0 * c, 0 * c, 1 + 0 * c], 1)], 1)
    hips = (base[:, None] + hip_b @ rot.transpose(0, 2, 1)).astype(np.float32)
    seeds = (hips + [0.1, 0.0, -0.35] + 0.05 * rng.normal(size=(S, 4, 3))).astype(np.float32)
    feet = (hips + [0.0, 0.0, -0.35] + 0.03 * rng.normal(size=(S, 4, 3))).astype(np.float32)
    vel = np.concatenate([0.3 + 0.1 * rng.normal(size=(S, 2)), np.zeros((S, 1))], 1)
    cur = np.array([[1, 0, 0, 1], [0, 1, 1, 0], [1, 1, 0, 1]], np.float32)[:S]
    anchor = np.where(cur[..., None] == 0, feet - [0.05, 0, 0], feet).astype(np.float32)
    return (terrain, seeds, hips, base, vel.astype(np.float32), yaw, cur, feet, anchor)


@pytest.mark.parametrize("kind", ["perlin", "boxes"])
def test_terrain_adapter_matches_jax_and_the_one_robot_scorer(kind):
    rng = np.random.default_rng(5)
    keys = jax.random.split(jax.random.PRNGKey(7), S)
    terrain = np.asarray(make_terrain_generator(kind, CPU).build(stacked_draws(kind, keys)))
    inputs = _adapter_inputs(rng, terrain)
    cfg = make_config("aliengo", mpc_type="sampling")
    jad = jax.jit(jax.vmap(jse.make_terrain_adapter(jax_make_config("aliengo",
                                                                    mpc_type="sampling"))))
    jfh, jtd = jad(*(jnp.asarray(a) for a in inputs))
    fh, td = make_terrain_adapter(cfg, CPU)(*(_t(a) for a in inputs))
    np.testing.assert_allclose(fh.numpy(), np.asarray(jfh), rtol=0, atol=ADAPT_ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=0, atol=ADAPT_ATOL)
    assert np.any(np.abs(fh.numpy() - inputs[1]) > 1e-3), "no foothold moved"

    # Each scenario's slice is the one-robot scorer's result on its own grids.
    single = make_tamols_scorer(cfg, strategy="tamols", device=CPU)
    tp = cfg.tamols
    from quadruped_pympc_tamols_torch.planner.heightmap import GridHeightMap, lookup_nearest
    for s in range(S):
        _, seeds, hips, base, vel, yaw, cur, feet, anchor = (a[s] for a in inputs)
        ghm = GridHeightMap(_t([2.0, 0.0]), _t(0.0), _t(0.08), _t(terrain[s]))
        hms = heightmaps_from_numpy(seeds[:, :2], np.full(4, yaw), np.full(4, tp.heightmap_resolution),
                                    np.zeros((4, tp.heightmap_rows, tp.heightmap_cols)), device=CPU)
        hms.heights = lookup_nearest(ghm, hms.cell_world_xy())
        res = single(hms, seeds, hips, base, vel, cur, feet, anchor)
        assert torch.equal(res.footholds, fh[s])


def _jax_noise(cfg, method, n):
    """jit(vmap(key, sigma) -> (noise (P, n), key')): the JAX solver's own draw of
    one iteration (JAX sampling_mpc.py:104-123 after the split at :157)."""
    sp = cfg.mpc.sampling

    def draw(key, sigma):
        key, sub = jax.random.split(key)
        P = sigma.shape[0]
        n3 = n // 3
        if method == "random_sampling":
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
        return noise.astype(jnp.float32), key

    return jax.jit(jax.vmap(draw))


def _solve_inputs(rng, cfg, H):
    state = np.zeros((S, 12), np.float32)
    state[:, 2] = cfg.sim.ref_z - 0.03 + 0.01 * rng.normal(size=S)
    state[:, 3:6] = 0.1 * rng.normal(size=(S, 3))
    state[:, 6:9] = 0.03 * rng.normal(size=(S, 3))
    feet = np.array([[0.27, 0.2, 0], [0.27, -0.2, 0], [-0.27, 0.2, 0], [-0.27, -0.2, 0]])
    feet = (feet + 0.02 * rng.normal(size=(S, 4, 3))).astype(np.float32)
    ref = np.zeros((S, 12), np.float32)
    ref[:, 2], ref[:, 3] = cfg.sim.ref_z, 0.3
    ref_feet = (feet + [0.08, 0, 0]).astype(np.float32)
    ph = rng.random((S, 1)) + np.array([0.0, 0.5, 0.5, 0.0])
    seq = (np.mod(ph[:, :, None] + 1.4 * 0.02 * np.arange(H), 1.0) < 0.6).astype(np.float32)
    prev = np.array([[1, 1, 1, 1], [1, 0, 0, 1], [0, 1, 1, 0]], np.float32)[:S]
    return state, feet, ref, ref_feet, seq, seq[:, :, 0].copy(), prev


@pytest.mark.parametrize("method,over", [
    ("random_sampling", {}),
    ("mppi", {"mpc.sampling.shift_solution": True}),
    ("cem_mppi", {"mpc.sampling.equilibrium_share": True}),
])
def test_batched_solve_matches_jax_on_its_noise(method, over):
    over = {"mpc.sampling.method": method, **over}
    jcfg = jax_make_config("aliengo", mpc_type="sampling", **over)
    cfg = make_config("aliengo", mpc_type="sampling", **over)
    rng = np.random.default_rng(11)
    jsolve, P = jax_solver(jcfg, N)
    inputs = _solve_inputs(rng, cfg, cfg.mpc.horizon)
    best = (0.3 * rng.normal(size=(S, P))).astype(np.float32)
    sigma = (0.5 + rng.random((S, P))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), S)
    jout, jst = jax.jit(jax.vmap(jsolve))(*(jnp.asarray(a) for a in inputs),
                                          JaxSamplingState(jnp.asarray(best), keys,
                                                           jnp.asarray(sigma)))
    noise, _ = _jax_noise(jcfg, method, N)(keys, jnp.asarray(sigma))
    solve, P2 = make_fleet_sampling_solver(cfg, N, device=CPU)
    assert P2 == P
    st = FleetSamplingState(_t(best), _t(sigma), torch.arange(S), torch.zeros(S, dtype=torch.int64))
    out, st2 = solve(*(_t(a) for a in inputs), st, noise=[_t(noise)])
    np.testing.assert_allclose(out.costs.numpy(), np.asarray(jout.costs), rtol=SOLVE_TOL)
    np.testing.assert_allclose(out.best_cost.numpy(), np.asarray(jout.best_cost), rtol=SOLVE_TOL)
    want_params = np.asarray(jst.best_parameters, np.float64)
    if method != "random_sampling":
        # The softmax weights turn the costs' float32 gap into a ~1e-3 relative
        # weight gap, so the update is held against JAX's step moved by the
        # port's own weights (test_torch_softmax_kernel.py holds it so too).
        def weights(c):
            w = np.exp(-(c - c.min(1, keepdims=True)) / cfg.mpc.sampling.mppi_temperature)
            return w / w.sum(1, keepdims=True)

        shift = np.einsum("spn,sn->sp", np.asarray(noise, np.float64),
                          weights(out.costs.double().numpy()) - weights(
                              np.asarray(jout.costs, np.float64)))
        want_params = want_params + shift
    np.testing.assert_allclose(st2.best_parameters.numpy(), want_params, rtol=SOLVE_TOL,
                               atol=SOLVE_TOL)
    for got, want in ((out.grfs, jout.grfs), (out.predicted_state, jout.predicted_state),
                      (st2.sigma, jst.sigma)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SOLVE_TOL, atol=SOLVE_TOL)
    assert torch.equal(st2.offset, torch.ones(S, dtype=torch.int64))


def _fleet_pair(terrain, reflexes, n_scen, num_samples):
    jcfg = jax_make_config("aliengo", mpc_type="sampling")
    cfg = make_config("aliengo", mpc_type="sampling")
    jstep, P = jse.make_scenario_step(jcfg, num_samples, terrain=terrain, reflexes=reflexes)
    gen = jse.make_terrain_generator(terrain) if terrain else None
    keys = jax.random.split(jax.random.PRNGKey(0), n_scen)
    jstates = jax.vmap(lambda k: jse.init_scenario_state(jcfg, P, k, gen))(keys)
    step, P2 = make_scenario_step(cfg, num_samples, terrain=terrain, reflexes=reflexes,
                                  device=CPU)
    assert P2 == P
    return jcfg, jax.jit(jax.vmap(jstep, in_axes=(0, None))), jstates, step, P


@pytest.mark.parametrize("terrain,reflexes,ticks", [(None, False, 30), ("perlin", True, 30)])
def test_closed_loop_matches_jax(terrain, reflexes, ticks):
    n_scen = 4
    jcfg, jstep, js, step, P = _fleet_pair(terrain, reflexes, n_scen, N)
    ts = scenario_state_from_numpy(js, seeds=np.arange(n_scen), device=CPU)
    draw = _jax_noise(jcfg, jcfg.mpc.sampling.method, N)
    cmd = np.asarray([0.25, 0.0, 0.0], np.float32)
    trig_j = trig_t = 0.0
    for _ in range(ticks):
        noise, _ = draw(js.mpc.key, js.mpc.sigma)
        js, jm = jstep(js, jnp.asarray(cmd))
        m = step(ts, _t(cmd), noise=[_t(noise)])
        trig_j += float(np.sum(np.asarray(jm["reflex_triggers"])))
        trig_t += float(m[:, 4].sum())
    for name in ("x", "feet", "phase", "swing_time", "liftoff", "prev_contact", "reflex",
                 "hitpoint"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=LOOP_ATOL, err_msg=name)
    np.testing.assert_allclose(ts.mpc.best_parameters.numpy(),
                               np.asarray(js.mpc.best_parameters), atol=1e-3)
    np.testing.assert_allclose(m[:, 1:4].numpy(), np.stack([np.asarray(jm[k]) for k in (
        "vel_error", "height_error", "grf_total")], 1), rtol=1e-4, atol=LOOP_ATOL)
    assert trig_t == trig_j
    if reflexes:
        assert trig_t > 0, "no reflex fired on perlin terrain"
    assert np.all(ts.x[:, 2].numpy() > 0.1)


def test_fleet_walks_on_its_own_draws():
    """The port's own generator and Philox seeds: a perlin fleet with reflexes
    walks forward upright (tests/test_parallel.py's band)."""
    cfg = make_config("aliengo", mpc_type="sampling")
    step, P = make_scenario_step(cfg, N, terrain="perlin", reflexes=True, device=CPU)
    st = init_scenario_state(cfg, P, 4, torch.Generator().manual_seed(2),
                             make_terrain_generator("perlin", CPU), device=CPU)
    x0 = st.x[:, 0].clone()
    cmd = torch.tensor([0.25, 0.0, 0.0])
    for _ in range(60):
        m = step(st, cmd)
    assert torch.all(torch.isfinite(m)) and torch.all(st.x[:, 2] > 0.1)
    assert float(torch.mean(st.x[:, 0] - x0)) > 0.05
    assert torch.equal(st.mpc.offset, torch.full((4,), 60))


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = make_config("aliengo", mpc_type="sampling")
    for call in (lambda: make_scenario_step(cfg, N),
                 lambda: make_terrain_generator("perlin"),
                 lambda: make_terrain_adapter(cfg),
                 lambda: init_scenario_state(cfg, 96, 2, torch.Generator()),
                 lambda: make_fleet_sampling_solver(cfg, N)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def reference_walk(n_scen=8, seconds=3.0, num_samples=128):
    """The JAX package's perlin fleet with reflexes at 0.25 m/s: (min z, mean
    forward distance, reflex firings)."""
    jcfg = jax_make_config("aliengo", mpc_type="sampling")
    jstep, P = jse.make_scenario_step(jcfg, num_samples, terrain="perlin", reflexes=True)
    gen = jse.make_terrain_generator("perlin")
    keys = jax.random.split(jax.random.PRNGKey(0), n_scen)
    js = jax.vmap(lambda k: jse.init_scenario_state(jcfg, P, k, gen))(keys)
    vstep = jax.jit(jax.vmap(jstep, in_axes=(0, None)))
    x0 = np.asarray(js.x)[:, 0].copy()
    trig, zmin = 0.0, np.inf
    for _ in range(int(round(seconds * jcfg.sim.mpc_frequency))):
        js, m = vstep(js, jnp.asarray([0.25, 0.0, 0.0], jnp.float32))
        trig += float(np.sum(np.asarray(m["reflex_triggers"])))
        zmin = min(zmin, float(np.min(np.asarray(js.x)[:, 2])))
    return dict(min_z=zmin, mean_dx=float(np.mean(np.asarray(js.x)[:, 0] - x0)),
                reflex_triggers=trig)


if __name__ == "__main__":
    import json

    sys.path.insert(0, "tests")
    import conftest  # noqa: F401  (the JAX package on the CPU, as under pytest)

    args = [float(a) if "." in a else int(a) for a in sys.argv[1:]]
    print(json.dumps(reference_walk(*args)))


def test_large_batch_layout_plan():
    """K1f's large-batch layout on the CPU, as pure functions: the basis windows of
    each parametrization give the JAX basis's per-leg products (the rows' nonzeros
    all lie in their window), and the wrapper's layout follows CROSSOVER."""
    from quadruped_pympc_tamols_tpu.controllers.sampling.splines import (
        make_step_major_basis as jax_basis)
    from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk

    rng = np.random.default_rng(0)
    for par in ("cubic_spline", "linear_spline", "zero_order"):
        cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.parametrization": par})
        plan = sk.make_rs_plan(cfg, 8, "cpu")
        PL, H = plan.params_per_leg, plan.horizon
        win = plan.windows.numpy()
        first = win[:, 4].copy().view(np.int32)
        cols = first[:, None] + np.arange(sk.WINDOW)
        dense = np.zeros((H * 12, 4 * PL), np.float64)
        np.put_along_axis(dense, cols, win[:, :sk.WINDOW].astype(np.float64), axis=1)
        W = np.asarray(jax_basis(par, H, cfg.mpc.sampling.num_splines), np.float64)
        np.testing.assert_array_equal(dense, W)
        assert np.all(cols // PL == (np.arange(H * 12) % 12 // 3)[:, None])  # within the leg
        prm = rng.standard_normal(4 * PL)
        np.testing.assert_allclose((win[:, :sk.WINDOW] * prm[cols]).sum(1), W @ prm, atol=1e-6)
    assert fl.fleet_layout(1, fl.CROSSOVER - 1) == fl.FOUR_LANE
    assert fl.fleet_layout(1, fl.CROSSOVER) == fl.LARGE_BATCH
    assert fl.fleet_layout(64, 10_000) == fl.LARGE_BATCH == fl.WIDE | fl.REGEN
    with pytest.raises(NotImplementedError, match="window"):
        sk.basis_windows(np.ones((12, 8), np.float32), 8)
