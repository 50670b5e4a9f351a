"""The port's multi-device tier (``parallel/sharded.py``, ``parallel/multihost.py``)
against the JAX package's on the CPU, the port's ranks as gloo processes.

The JAX side is recorded (``tests/jax_references.py``, ``jax_parallel_references``
below): its sharded solver on meshes (1, 2) and (1, 4) of the 8 virtual CPU
devices of ``tests/conftest.py`` for each method, two carried calls at N = 240
(CEM-MPPI 256), with the very noise each shard drew, rebuilt by the same
``jax.random`` calls as JAX ``parallel/sharded.py:58-83`` (the recorder checks
itself: the lowest cost over its re-drawn noise is the solver's best cost); and
its multi-chip fleet step on a (2, 2) mesh, two scenarios a device, five ticks at
zero noise, flat and over boxes, and flat at the configuration's own sigma_random
with each scenario's shard noise a tick (the same ``jax.random`` calls, keyed on
the scenario's key), from its own initial states. The port's ranks
(``tests/torch_parallel_worker.py``, four gloo processes started once for the
module) are fed that noise and those states (``interop.scenario_state_from_numpy``).

Tolerances, the one-robot sampling parity tests' (``test_torch_softmax_kernel.py``,
``test_torch_fleet.py``): GRFs rtol/atol 1e-5, the best cost rtol 1e-5, parameters
and sigma atol 1e-5 (sums over the samples and the shards in another order), the
CEM elite sets exactly; the fleet's states and metrics 1e-5 over five ticks. The
local multi-host launch of 2 hosts x 2 ranks at zero noise equals a one-rank run of
the same scenarios to 1e-6, and its metrics are identical on every rank.
"""
import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from jax_references import check_inputs, digest
from jax_references import load as load_jax
from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu import replace_config as jax_replace_config
from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.sampling import SamplingState
from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
from quadruped_pympc_tamols_torch.ops import sampling_kernel as rs
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
from quadruped_pympc_tamols_torch.parallel import launch_local_multihost
from quadruped_pympc_tamols_torch.parallel.multihost import find_free_port, spawn, wait_all

torch.set_num_threads(1)
threadpool_limits(1)
ROOT = Path(__file__).resolve().parents[1]
METHODS = ("random_sampling", "mppi", "cem_mppi")
MESHES = (2, 4)  # sample shards: meshes (1, 2) and (1, 4)
SAMPLES = {"random_sampling": 240, "mppi": 240, "cem_mppi": 256}
CALLS = 2
KEY = 7
WORLD = 4
TERRAINS = ("flat", "boxes")
# The multi-chip cases: name -> (terrain, zero noise). "noisy" draws at the
# configuration's sigma_random, so that the winner merge over the two sample
# shards of a row picks from both.
MULTICHIP = {"flat": ("flat", True), "boxes": ("boxes", True), "noisy": ("flat", False)}
MULTICHIP_SAMPLES = 48
SCENARIOS_PER_DEVICE = 2
TICKS = 5
TOL = 1e-5
FLEET_TOL = 1e-5


def sharded_inputs(P: int):
    """One trotting tick: state, feet, reference, contact sequence (FL and RR in
    stance for the first half of the horizon, FR and RL for the second) and a
    nonzero incumbent, float32."""
    f = np.float32
    state12 = np.array([0.01, -0.02, 0.31, 0.15, 0.02, 0.0, 0.02, -0.01, 0.05, 0.0, 0.1, 0.0], f)
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]], f)
    ref12 = np.array([0, 0, 0.35, 0.3, 0, 0, 0, 0, 0, 0, 0, 0], f)
    seq = np.zeros((4, 12), f)
    seq[[0, 3], :6] = 1.0
    seq[[1, 2], 6:] = 1.0
    best0 = np.random.default_rng(5).normal(0.0, 1.5, P).astype(f)
    return state12, feet, ref12, seq, best0


def jax_shard_noise(cfg, method, key, sigma, n_local, shard, P):
    """The noise shard ``shard`` of JAX's sharded solver draws (``sharded.py:58-83``)."""
    sp = cfg.mpc.sampling
    key = jax.random.fold_in(key, shard)
    keep = 1.0 if shard == 0 else 0.0
    n3 = n_local // 3
    if method == "random_sampling":
        k1, k2, k3, k4 = jax.random.split(key, 4)
        g1 = sp.sigma_random[0] * jax.random.normal(k1, (P, n3))
        g2 = sp.sigma_random[1] * jax.random.normal(k2, (P, n3))
        u3 = jax.random.uniform(k3, (P, n_local - 1 - 2 * n3), minval=-sp.sigma_random[2],
                                maxval=sp.sigma_random[2])
        col0 = (1.0 - keep) * sp.sigma_random[1] * jax.random.normal(k4, (P, 1))
        return jnp.concatenate([col0, g1, g2, u3], 1).astype(jnp.float32)
    scale = sigma[:, None] if method == "cem_mppi" else sp.sigma_mppi
    k1, k2 = jax.random.split(key)
    col0 = (1.0 - keep) * scale * jax.random.normal(k2, (P, 1))
    return jnp.concatenate([col0, scale * jax.random.normal(k1, (P, n_local - 1))],
                           1).astype(jnp.float32)


def jax_fleet_noise(cfg, keys, n_local, shards, P):
    """(B, P, shards * n_local): the noise every scenario's shards draw in JAX's
    multi-chip tick from its key, shard after shard."""
    return np.concatenate([np.asarray(jax.jit(jax.vmap(
        lambda k, i=i: jax_shard_noise(cfg, "random_sampling", k, None, n_local, i, P)))(keys))
        for i in range(shards)], axis=2)


def _jax_costs(cfg, n_local):
    """JAX's shard cost function (``sharded.py:84-90``), jitted."""
    from quadruped_pympc_tamols_tpu.controllers.sampling.rollout import (ForceModelParams,
                                                                         rollout_costs_soa)
    from quadruped_pympc_tamols_tpu.controllers.sampling.splines import make_step_major_basis
    from quadruped_pympc_tamols_tpu.dynamics.srbd import make_params

    sp, H = cfg.mpc.sampling, cfg.mpc.horizon
    W = make_step_major_basis(sp.parametrization, H, sp.num_splines)
    srbd = make_params(cfg)
    fm = ForceModelParams(sp.max_force_x / sp.max_force_z, sp.max_force_y / sp.max_force_z,
                          cfg.mpc.grf_min, cfg.mpc.grf_max, cfg.mpc.mu)

    @jax.jit
    def costs(state12, feet, ref12, seq, params_vec):
        raw = (W @ params_vec).reshape(H, 12, n_local)
        share = srbd.mass * 9.81 / jnp.maximum(jnp.sum(seq, axis=0), 1.0)
        return rollout_costs_soa(state12, feet, ref12, raw, seq, share, cfg.mpc.dts(),
                                 cfg.mpc.cost.as_vector(), srbd, fm)

    return costs


def jax_parallel_references() -> dict:
    """The JAX package's side of this file (tests/jax_references.py): the sharded
    solver's two calls a case with each shard's noise and CEM's elite set, and the
    multi-chip fleet's initial states, metrics and final states."""
    from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxState
    from quadruped_pympc_tamols_tpu.parallel import (make_multichip_step,
                                                     make_sharded_sampling_solver, scenario_mesh)

    out = {}
    cfg = jax_make_config("aliengo", mpc_type="sampling")
    for method in METHODS:
        for n in MESHES:
            key, N = f"sharded/{method}/{n}", SAMPLES[method]
            n_local = N // n
            solve, P = make_sharded_sampling_solver(cfg, scenario_mesh(1, n), num_samples=N,
                                                    method=method)
            state12, feet, ref12, seq, best0 = sharded_inputs(P)
            st = JaxState(jnp.asarray(best0), jax.random.PRNGKey(KEY),
                          jnp.full(P, cfg.mpc.sampling.sigma_cem_mppi, jnp.float32))
            costs_of = _jax_costs(cfg, n_local)
            for call in range(CALLS):
                # Jitted as the solver's shard_map is: an eager draw can round
                # sigma * normal otherwise.
                shards = [jax.jit(lambda k, s, i=i: jax_shard_noise(cfg, method, k, s, n_local,
                                                                    i, P))(st.key, st.sigma)
                          for i in range(n)]
                grfs, st2, best = solve(state12, feet, ref12, seq, st)
                costs = [np.asarray(costs_of(state12, feet, ref12, seq,
                                             st.best_parameters[:, None] + z)) for z in shards]
                low = min(float(c.min()) for c in costs)
                assert low == float(best), (key, call, low, float(best))
                if method == "cem_mppi":
                    k = min(cfg.mpc.sampling.cem_elite, n_local)
                    local = [np.asarray(jax.lax.top_k(-jnp.asarray(c), k)[1]) for c in costs]
                    vals = np.concatenate([c[li] for c, li in zip(costs, local)])
                    gi = np.asarray(jax.lax.top_k(-jnp.asarray(vals),
                                                  cfg.mpc.sampling.cem_elite)[1])
                    idx = np.concatenate([i * n_local + li for i, li in enumerate(local)])
                    out[f"{key}/elites{call}"] = idx[gi]
                out[f"{key}/noise{call}"] = np.concatenate([np.asarray(z) for z in shards], 1)
                out[f"{key}/grfs{call}"] = np.asarray(grfs)
                out[f"{key}/params{call}"] = np.asarray(st2.best_parameters)
                out[f"{key}/best{call}"] = np.asarray(best)
                out[f"{key}/sigma{call}"] = np.asarray(st2.sigma)
                st = st2
            out[f"digest/{key}"] = digest(cfg, method, n, N, KEY, CALLS, state12, feet, ref12,
                                          seq, best0)
    zero = jax_replace_config(cfg, **{"mpc.sampling.sigma_random": (0.0, 0.0, 0.0)})
    mesh = scenario_mesh(2, 2)
    B = 2 * SCENARIOS_PER_DEVICE
    for name, (terrain, zero_noise) in MULTICHIP.items():
        key = f"multichip/{name}"
        c = zero if zero_noise else cfg
        step, init, P = make_multichip_step(c, mesh, SCENARIOS_PER_DEVICE, MULTICHIP_SAMPLES,
                                            None if terrain == "flat" else terrain)
        states = init(seed=0)
        for field in ("x", "feet", "phase", "swing_time", "liftoff", "prev_contact", "terrain",
                      "reflex", "hitpoint"):
            out[f"{key}/init/{field}"] = np.asarray(getattr(states, field))
        out[f"{key}/init/mpc_best_parameters"] = np.asarray(states.mpc.best_parameters)
        out[f"{key}/init/mpc_sigma"] = np.asarray(states.mpc.sigma)
        cmd = jnp.tile(jnp.asarray([0.3, 0.0, 0.0], jnp.float32), (B, 1))
        metrics = []
        for tick in range(TICKS):
            if not zero_noise:
                out[f"{key}/noise{tick}"] = jax_fleet_noise(c, states.mpc.key,
                                                            MULTICHIP_SAMPLES // 2, 2, P)
            states, m = step(states, cmd)
            metrics.append(np.asarray(m))
        out[f"{key}/metrics"] = np.stack(metrics)
        out[f"{key}/x"] = np.asarray(states.x)
        out[f"{key}/feet"] = np.asarray(states.feet)
        out[f"{key}/params"] = np.asarray(states.mpc.best_parameters)
        out[f"digest/{key}"] = (digest(c, terrain, SCENARIOS_PER_DEVICE, MULTICHIP_SAMPLES, TICKS)
                                if zero_noise else digest(c, name, terrain, SCENARIOS_PER_DEVICE,
                                                          MULTICHIP_SAMPLES, TICKS))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's side: WORLD gloo ranks of tests/torch_parallel_worker.py fed the
    recorded inputs, run once; {rank: its outputs}."""
    ref = load_jax("parallel")
    jc = jax_make_config("aliengo", mpc_type="sampling")
    tmp = tmp_path_factory.mktemp("ranks")
    job, sharded = {}, []
    for method in METHODS:
        for n in MESHES:
            key, N = f"sharded/{method}/{n}", SAMPLES[method]
            state12, feet, ref12, seq, best0 = sharded_inputs(4 * 24)
            check_inputs(ref, key, jc, method, n, N, KEY, CALLS, state12, feet, ref12, seq,
                         best0)
            sharded.append((method, n, N))
            job[f"{method}/{n}/best0"] = best0
            for call in range(CALLS):
                job[f"{method}/{n}/noise{call}"] = ref[f"{key}/noise{call}"]
    zero = jax_replace_config(jc, **{"mpc.sampling.sigma_random": (0.0, 0.0, 0.0)})
    for name, (terrain, zero_noise) in MULTICHIP.items():
        key = f"multichip/{name}"
        if zero_noise:
            check_inputs(ref, key, zero, terrain, SCENARIOS_PER_DEVICE, MULTICHIP_SAMPLES, TICKS)
        else:
            check_inputs(ref, key, jc, name, terrain, SCENARIOS_PER_DEVICE, MULTICHIP_SAMPLES,
                         TICKS)
        job.update({k: v for k, v in ref.items()
                    if k.startswith(f"{key}/init/") or k.startswith(f"{key}/noise")})
    job.update(dict(zip(("state12", "feet", "ref12", "seq"), sharded_inputs(96)[:4])))
    meta = {"config": dataclasses.asdict(make_config("aliengo", mpc_type="sampling")),
            "sharded": sharded, "calls": CALLS, "multichip": MULTICHIP,
            "scenarios_per_device": SCENARIOS_PER_DEVICE,
            "multichip_samples": MULTICHIP_SAMPLES, "ticks": TICKS}
    job["meta"] = np.array(json.dumps(meta, default=lambda e: e.name))
    np.savez(tmp / "job.npz", **job)
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
    store = f"127.0.0.1:{find_free_port()}"
    procs = [spawn([sys.executable, str(ROOT / "tests" / "torch_parallel_worker.py"),
                    str(tmp / "job.npz"), str(tmp), store, str(WORLD), str(r)], env, ROOT)
             for r in range(WORLD)]
    wait_all(procs, 300.0, "parallel worker")
    return {r: dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)}


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("method", METHODS)
def test_sharded_solver_matches_jax(ranks, method, n):
    """Two carried calls of the sharded solver on the JAX shards' own noise: GRFs,
    parameters, best cost, sigma and CEM's elite set, every rank of the mesh alike."""
    ref = load_jax("parallel")
    key = f"{method}/{n}"
    for call in range(CALLS):
        got = ranks[0]
        j = {k: ref[f"sharded/{key}/{k}{call}"] for k in ("grfs", "params", "best", "sigma")}
        np.testing.assert_allclose(got[f"{key}/grfs{call}"], j["grfs"], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got[f"{key}/params{call}"], j["params"], atol=TOL)
        np.testing.assert_allclose(got[f"{key}/best{call}"][0], j["best"], rtol=TOL)
        np.testing.assert_allclose(got[f"{key}/sigma{call}"], j["sigma"], atol=TOL)
        if method == "cem_mppi":
            np.testing.assert_array_equal(got[f"{key}/elites{call}"],
                                          ref[f"sharded/{key}/elites{call}"])
        for r in range(1, n):
            for k in ("grfs", "params", "best", "sigma"):
                np.testing.assert_array_equal(ranks[r][f"{key}/{k}{call}"],
                                              got[f"{key}/{k}{call}"])


@pytest.mark.parametrize("terrain", list(MULTICHIP))
def test_multichip_step_matches_jax(ranks, terrain):
    """Five ticks of the (2, 2) fleet from JAX's initial states, at zero noise
    (flat, boxes) and on each JAX shard's own noise ("noisy", where the winner of
    a scenario comes from either shard of its row): every rank's metrics are
    JAX's, each scenario row's states are JAX's rows, and the two sample shards of
    a row hold the same states."""
    ref = load_jax("parallel")
    key = f"multichip/{terrain}"
    for r, out in ranks.items():
        row, col = out["coords"]
        rows = slice(row * SCENARIOS_PER_DEVICE, (row + 1) * SCENARIOS_PER_DEVICE)
        np.testing.assert_allclose(out[f"{key}/metrics"], ref[f"{key}/metrics"], rtol=FLEET_TOL,
                                   atol=FLEET_TOL)
        for name in ("x", "feet", "params"):
            np.testing.assert_allclose(out[f"{key}/{name}"], ref[f"{key}/{name}"][rows],
                                       atol=FLEET_TOL, err_msg=f"rank {r} {name}")
            twin = next(o for o in ranks.values() if o["coords"][0] == row
                        and o["coords"][1] != col)
            np.testing.assert_array_equal(out[f"{key}/{name}"], twin[f"{key}/{name}"])
    assert np.all(ref[f"{key}/x"][:, 2] > 0.1)


def test_local_multihost_launch_matches_one_rank():
    """2 hosts x 2 gloo ranks at zero noise: finite metrics, the same on every rank,
    and equal to one rank running the same scenarios, so the collectives reduce
    what they should."""
    four = launch_local_multihost(2, 2, n_steps=3, zero_noise=True, timeout_s=180)
    one = launch_local_multihost(1, 1, n_steps=3, zero_noise=True, timeout_s=180,
                                 scenarios_per_device=4)
    assert (four["processes"], four["global_devices"], four["local_devices"]) == (2, 4, 2)
    assert four["fleet_scenarios"] == one["fleet_scenarios"] == 4
    m = np.array(four["rank_metrics"])
    assert np.all(np.isfinite(m)) and np.all(m == m[0])
    np.testing.assert_allclose(m[0], one["rank_metrics"][0], rtol=1e-6, atol=1e-6)


def test_knobs_plain_versions():
    """The knobs' plain versions: with the drawn column 0 only column 0 of the CPU
    noise changes (random sampling from N(0, sigma2)), on K1a-K1c's and K1f's
    plain paths; the caller's beta and the unnormalized sums give incumbent + S /
    Z, the kernel's finish, on K1b/K1c's, and the sums come only with a beta."""
    cfg = make_config("aliengo", mpc_type="sampling")
    plan = rs.make_rs_plan(cfg, 63, "cpu")
    gen = rs.cpu_generator(3, 1)
    a, b = (rs.sample_noise_reference(p, rs.cpu_generator(3, 1))
            for p in (plan, rs.with_drawn_column0(plan)))
    assert torch.equal(a[:, 1:], b[:, 1:]) and not a[:, 0].any() and b[:, 0].abs().min() > 0
    assert rs.RSArgs.from_buffer_copy(rs.with_drawn_column0(plan).args_template).draw_col0 == 1
    state12, feet, ref12, seq, best0 = sharded_inputs(plan.num_parameters)
    share = np.repeat((cfg.robot.mass * np.float32(9.81) / np.maximum(seq.sum(0), 1))[:, None],
                      4, 1).astype(np.float32)
    tick = rs.TickInputs(state12, feet, ref12, seq, share)
    inc = torch.from_numpy(best0)
    for method in ("mppi", "cem_mppi"):
        knobs = sm.make_knobs(cfg, method)
        sigma = torch.full((plan.num_parameters,), 0.5)
        noise = sm.sample_noise_reference(plan.num_parameters, 63, knobs, gen, sigma, True)
        plain = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 3, 1, noise_in=noise)
        sums = torch.empty(plan.num_parameters + 1)
        shifted = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 3, 1, noise_in=noise,
                                       merge_beta=lambda lo: lo - 1.0, sums=sums)
        torch.testing.assert_close(shifted[1][rs.OUT_WINNER:], plain[1][rs.OUT_WINNER:],
                                   atol=TOL, rtol=0)
        torch.testing.assert_close(inc + sums[:-1] / sums[-1], shifted[1][rs.OUT_WINNER:])
        w = torch.exp(-(plain[0] - (plain[0].min() - 1.0)) / knobs.temperature)
        torch.testing.assert_close(sums[-1], w.sum())
        # K1f's plain noise draws column 0 as the single sampler's does.
        fz = fl.sample_noise(rs.with_drawn_column0(plan), knobs, torch.tensor([3]),
                             torch.tensor([1]), sigma[None])
        assert torch.equal(fz[0], sm.sample_noise_reference(
            plan.num_parameters, 63, knobs, rs.cpu_generator(3, 1), sigma, True))
    with pytest.raises(ValueError, match="only with merge_beta"):
        sm.softmax_iteration(plan, knobs, tick, inc, sigma, 3, 1, sums=sums)


def test_sharded_state_carries_seed_and_offset():
    """The sharded solve's next state keeps the seed and advances the offset by one,
    as the JAX solver splits its key once a call, and every shard but the first
    keys its Philox on a seed of its own."""
    from quadruped_pympc_tamols_torch.parallel.sharded import shard_seed

    assert shard_seed(11, 0) == 11 and len({shard_seed(11, c) for c in range(4)}) == 4
    t = torch.tensor([11, 12])
    assert torch.equal(shard_seed(t, 0), t) and not torch.equal(shard_seed(t, 1), t)
