"""The port's terrain-aware foothold planner against the JAX package on the CPU:
heightmaps, the TAMOLS scorer for every knob branch and the "height" strategy,
WBInterface with the planner at the swing apex, and a zero-noise closed loop over
sensed terrain. Both sides get the same inputs, made from a seed with numpy; the
port's heightmaps are the JAX ones' leaves (``interop.heightmaps_from_numpy``)
unless a test holds the port's own sensing."""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.controllers.sampling import SamplingState as JaxState
from quadruped_pympc_tamols_tpu.planner import heightmap_from_fn as jax_heightmap_from_fn
from quadruped_pympc_tamols_tpu.planner import lookup_nearest as jax_lookup_nearest
from quadruped_pympc_tamols_tpu.planner import make_tamols_scorer as jax_make_tamols_scorer
from quadruped_pympc_tamols_tpu.sim import SRBClosedLoopHarness as JaxHarness
from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.interfaces import WBInterface
from quadruped_pympc_tamols_torch.interop import (config_from_dict, heightmaps_from_numpy,
                                                  sampling_state_from_numpy)
from quadruped_pympc_tamols_torch.planner import (TamolsPlanner, heightmap_from_fn,
                                                  lookup_nearest, make_tamols_scorer, stack_legs)
from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness
from quadruped_pympc_tamols_torch.utils.legs import Legs

torch.set_num_threads(1)
# Footholds and boxes (m); costs relative, with a floor for the roughness of an
# exactly flat patch, which is rounding noise (~1e-17) of either side's 9 x 9
# projector product.
POS_ATOL, COST_RTOL, COST_ATOL = 1e-5, 1e-5, 1e-9


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else jnp


# The terrains of tests/test_tamols.py, for jnp arrays and torch tensors alike.
def flat(x, y):
    return 0.0 * x


def step_edge(x, y):
    """10 cm step up at x > 0.3."""
    return _xp(x).where(x > 0.3, 0.10, 0.0)


def stones(x, y):
    """Raised circles of radius 0.09 on a 0.4 m grid over 30 cm deep gaps."""
    xp = _xp(x)
    cx = xp.round(x / 0.4) * 0.4
    cy = xp.round(y / 0.4) * 0.4
    return xp.where((x - cx) ** 2 + (y - cy) ** 2 <= 0.09**2, 0.0, -0.30)


def step_up(x, y):
    """The walks' terrain: a 5 cm step up at x > 0.6 m (numpy floats too)."""
    return (x > 0.6) * 0.05


TERRAINS = {"flat": flat, "step_edge": step_edge, "stones": stones}
NOMINAL = np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0], [-0.25, 0.15, 0.0],
                    [-0.25, -0.15, 0.0]])


def _jax_hms(terrain, seeds, yaw=0.0, rows=13, cols=7, resolution=0.04):
    hms = [jax_heightmap_from_fn(terrain, s[:2], yaw, resolution, rows, cols) for s in seeds]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *hms)


def _port_hms(jax_hms):
    return heightmaps_from_numpy(*(np.asarray(x) for x in (jax_hms.center, jax_hms.yaw,
                                                          jax_hms.resolution, jax_hms.heights)),
                                 device="cpu")


@pytest.mark.parametrize("yaw", [0.0, 0.3])
def test_heightmaps_match_jax(yaw):
    """cell_world_xy, heightmap_from_fn (one grid and four in one batch against
    four stacked JAX grids) and lookup_nearest, with points far outside the grid
    clamping to its border."""
    rng = np.random.default_rng(1)
    centers = NOMINAL[:, :2] + rng.uniform(-0.05, 0.05, (4, 2))
    jh = _jax_hms(stones, centers, yaw)
    th = heightmap_from_fn(stones, centers, np.full(4, yaw), device="cpu")
    one = heightmap_from_fn(stones, centers[1], yaw, device="cpu")
    np.testing.assert_allclose(th.cell_world_xy().numpy(), np.asarray(jax.vmap(
        lambda h: h.cell_world_xy())(jh)), atol=1e-6)
    np.testing.assert_array_equal(th.heights.numpy(), np.asarray(jh.heights))
    np.testing.assert_array_equal(one.heights.numpy(), np.asarray(jh.heights)[1])
    assert th.heights.dtype == torch.float32 and stack_legs([one] * 4).heights.shape == (4, 13, 7)

    pts = centers[:, None, :] + rng.uniform(-0.35, 0.35, (4, 200, 2))
    pts[:, :5] = [[10.0, 10.0], [-10.0, 3.0], [0.0, -7.0], [5.0, 0.0], [-0.3, 9.0]]
    pts = pts.astype(np.float32)
    want = np.asarray(jax.vmap(jax_lookup_nearest)(jh, jnp.asarray(pts)))
    got = lookup_nearest(_port_hms(jh), torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(lookup_nearest(one, torch.from_numpy(pts[1])).numpy(), want[1])
    # The clamped corners are border cells of the grid.
    border = np.concatenate([jh.heights[:, 0], jh.heights[:, -1], jh.heights[:, :, 0],
                             jh.heights[:, :, -1]], axis=1)
    assert all(np.isin(got[leg, :5], np.asarray(border[leg])).all() for leg in range(4))


def _scorer_inputs(terrain, rng, k):
    """Input set k on a terrain: 0 the nominal stance of tests/test_tamols.py, 1
    the same with the hips out of reach (every leg falls back), then random
    seeds, hips, base state, contacts, feet and swing times."""
    seeds = NOMINAL.copy()
    if k >= 2:
        seeds = seeds + rng.normal(0.0, [0.06, 0.04, 0.01], (4, 3))
    hips = seeds + np.array([0.0, 0.0, 0.35])
    feet = seeds.copy()
    base_pos, base_vel = np.array([0.0, 0.0, 0.35]), np.array([0.2, 0.0, 0.0])
    contact, t_remain = np.zeros(4), np.full(4, 1e3)  # 1e3: no flight-time gate
    if k == 1:
        hips = hips + 5.0
    if k >= 2:
        hips = hips + rng.normal(0.0, 0.03, (4, 3))
        feet = seeds - np.array([0.1, 0.0, 0.0]) + rng.normal(0.0, 0.04, (4, 3))
        base_pos = base_pos + rng.normal(0.0, 0.03, 3)
        base_vel = rng.normal([0.3, 0.0, 0.0], 0.2, 3)
        contact = rng.integers(0, 2, 4).astype(np.float64)
        t_remain = rng.uniform(0.02, 0.3, 4)
    anchor = feet + rng.normal(0.0, 0.02, (4, 3))
    return _jax_hms(terrain, seeds), (seeds, hips, base_pos, base_vel, contact, feet, anchor,
                                      t_remain)


# Knob sets that reach every branch of the scorer, and the "height" strategy.
KNOBS = {
    "defaults": {},
    "support": {"tamols.support_margin": 0.015, "tamols.weight_support": 20.0},
    "fallback_foot_progression": {"tamols.fallback": "foot", "tamols.min_advance": 0.35,
                                  "tamols.weight_progression": 50.0},
    "flight_time_predicted_hip": {"tamols.max_foot_speed": 1.5,
                                  "tamols.predict_hip_at_touchdown": True},
    "lane_separation_stability_hard": {"tamols.lateral_margin": 0.05,
                                       "tamols.foot_separation": 0.12,
                                       "tamols.stability_hard": True,
                                       "tamols.stability_soft": False,
                                       "tamols.weight_nominal_kinematic": 2.0},
    "ellipse": {"tamols.search_radius_forward": 0.15, "tamols.search_radius_back": 0.08},
    "height": {"sim.visual_foothold_adaptation": "height"},
}


@pytest.mark.parametrize("knobs", list(KNOBS), ids=list(KNOBS))
def test_scorer_matches_jax(knobs):
    """On the flat, step-edge and stones terrains, 6 input sets each: the same
    feasibility and chosen cell, footholds and boxes to POS_ATOL, costs to
    COST_RTOL; the sets reach both a feasible and a fallback leg."""
    jc = jax_make_config("aliengo", **KNOBS[knobs])
    strategy = jc.sim.visual_foothold_adaptation
    tc = config_from_dict(dataclasses.asdict(jc))
    jax_adapt = jax_make_tamols_scorer(jc, strategy)
    adapt = make_tamols_scorer(tc, strategy, device="cpu")
    rng = np.random.default_rng(7)
    feasible = []
    for name, terrain in TERRAINS.items():
        for k in range(6):
            jh, args = _scorer_inputs(terrain, rng, k)
            want = jax_adapt(jh, *args)
            got = adapt(_port_hms(jh), *args)
            label = f"{knobs} {name} set {k}"
            np.testing.assert_array_equal(got.feasible.numpy(), np.asarray(want.feasible), label)
            for field in ("footholds", "constraints_lo", "constraints_hi"):
                np.testing.assert_allclose(getattr(got, field).numpy(),
                                           np.asarray(getattr(want, field)), rtol=0,
                                           atol=POS_ATOL, err_msg=f"{label} {field}")
            np.testing.assert_allclose(got.best_cost.numpy(), np.asarray(want.best_cost),
                                       rtol=COST_RTOL, atol=COST_ATOL, err_msg=label)
            feasible.append(got.feasible.numpy())
    feasible = np.concatenate(feasible)
    assert feasible.all() if strategy == "height" else (feasible.any() and not feasible.all())


_JAX_SENSORS = {}


def _sense_jax(wb, terrain, yaw, tp):
    """The JAX MuJoCo loop's sensing rule (sim/simulation.py:140-146): grids
    around the last reference footholds while the planner waits for its apex,
    the four legs' heightmap_from_fn in one jitted program."""
    if wb.vfa is None or wb.vfa.initialized:
        return None
    key = (terrain, tp.heightmap_resolution, tp.heightmap_rows, tp.heightmap_cols)
    if key not in _JAX_SENSORS:
        _JAX_SENSORS[key] = jax.jit(jax.vmap(
            lambda c, y: jax_heightmap_from_fn(terrain, c, y, *key[1:]), in_axes=(0, None)))
    ref = np.asarray(wb.frg.last_reference_footholds.data)
    return _JAX_SENSORS[key](jnp.asarray(ref[:, :2], jnp.float32), jnp.float32(yaw))


def _sense_port(wb, terrain, yaw, tp, device):
    """The same rule with the port's heightmap_from_fn: four grids, one batch."""
    if wb.vfa is None or wb.vfa.initialized:
        return None
    ref = np.asarray(wb.frg.last_reference_footholds.data)
    return heightmap_from_fn(terrain, ref[:, :2], np.full(4, yaw), tp.heightmap_resolution,
                             tp.heightmap_rows, tp.heightmap_cols, device=device)


def _count_calls(planner):
    """Wrap planner.compute_adaptation to count its calls (apex triggers)."""
    fn, calls = planner.compute_adaptation, [0]

    def counted(*a, **kw):
        calls[0] += 1
        return fn(*a, **kw)

    planner.compute_adaptation = counted
    return calls


def _retargets(stc):
    return [(m, None if p is None else p.tolist(), None if v is None else v.tolist(), a)
            for m, p, v, a in zip(stc.retarget_moments, stc.retarget_points,
                                  stc.retarget_vels, stc.retarget_apexes)]


def test_wb_interface_with_tamols_matches_jax():
    """update_state_and_reference with the planner on the same scripted base and
    feet walking onto the step-edge terrain for 300 steps, sensing as the JAX
    MuJoCo loop does: identical contact sequences, the adaptation triggered on
    the same steps, reference footholds and constraint boxes to POS_ATOL, and the
    same swing re-plans, here velocity-matched (the closed loop below holds the
    default re-plan from the measured foot)."""
    from quadruped_pympc_tamols_tpu.interfaces import WBInterface as JaxWB
    from quadruped_pympc_tamols_tpu.utils.legs import Legs as JaxLegs

    jc = jax_make_config("aliengo", mpc_type="sampling",
                         **{"tamols.retarget_velocity_match": True})
    tc = config_from_dict(dataclasses.asdict(jc))
    rng = np.random.default_rng(0)
    feet0 = np.array([[0.24, 0.15, 0], [0.24, -0.15, 0], [-0.24, 0.15, 0], [-0.24, -0.15, 0]])
    twb = WBInterface(tc, Legs(feet0.copy()), device="cpu")
    jwb = JaxWB(jc, JaxLegs(feet0.copy()))
    tcalls, jcalls = _count_calls(twb.vfa), _count_calls(jwb.vfa)
    replans = 0
    for k in range(300):
        base = np.array([0.0015 * k, 0.0, 0.35]) + rng.normal(0, 0.002, 3)
        rpy, vel = rng.normal(0, 0.02, 3), np.array([0.3, 0.0, 0.0]) + rng.normal(0, 0.05, 3)
        feet = feet0 + [0.0015 * k, 0, 0] + rng.normal(0, 0.01, (4, 3))
        hips = base + np.array([[0.24, 0.05, 0], [0.24, -0.05, 0], [-0.24, 0.05, 0],
                                [-0.24, -0.05, 0]])
        jhm = _sense_jax(jwb, step_edge, rpy[2], jc.tamols)
        assert twb.vfa.initialized == jwb.vfa.initialized
        args = dict(com_pos=base, base_pos=base, base_lin_vel=vel, base_ori_euler_xyz=rpy,
                    base_ang_vel=rng.normal(0, 0.05, 3), simulation_dt=0.002,
                    ref_base_lin_vel=np.array([0.3, 0.0, 0.0]), ref_base_ang_vel=np.zeros(3))
        _, tr, tseq, _, _ = twb.update_state_and_reference(
            feet_pos=Legs(feet.copy()), hip_pos=Legs(hips), joints_pos=Legs.zeros((3,)),
            heightmaps=None if jhm is None else _port_hms(jhm), **args)
        _, jr, jseq, _, _ = jwb.update_state_and_reference(
            feet_pos=JaxLegs(feet.copy()), hip_pos=JaxLegs(hips), joints_pos=JaxLegs.zeros((3,)),
            heightmaps=jhm, **args)
        np.testing.assert_array_equal(tseq, jseq)
        assert tcalls == jcalls
        # The swing clocks advance after the step, as the harness advances them.
        twb.stc.update_swing_time(twb.current_contact, 0.002)
        jwb.stc.update_swing_time(jwb.current_contact, 0.002)
        for key in ("ref_foot_FL", "ref_foot_FR", "ref_foot_RL", "ref_foot_RR", "ref_position"):
            np.testing.assert_allclose(tr[key], jr[key], rtol=0, atol=POS_ATOL, err_msg=key)
        tbox, jbox = tr["ref_foot_constraints"], jr["ref_foot_constraints"]
        assert (tbox is None) == (jbox is None)
        if tbox is not None:
            np.testing.assert_allclose(np.stack(tbox), np.stack([np.asarray(b) for b in jbox]),
                                       rtol=0, atol=POS_ATOL)
        if tcalls[0]:
            np.testing.assert_array_equal(twb.vfa.last_feasible, jwb.vfa.last_feasible)
        assert _retargets(twb.stc) == _retargets(jwb.stc)
        replans += sum(p is not None for p in twb.stc.retarget_points)
    assert tcalls[0] >= 2, f"the adaptation triggered {tcalls[0]} times"
    assert replans > 0


def test_zero_noise_closed_loop_over_sensed_terrain_matches_jax():
    """The default configuration (TAMOLS) at N = 32 and zero exploration noise
    walking onto the 5 cm step for 0.4 s, each harness sensing with its own
    package's heightmap_from_fn: the same apex triggers, state histories to
    atol 1e-3 and feet to 1e-4, as test_zero_noise_closed_loop_matches_jax."""
    over = {"mpc.sampling.num_samples": 32, "mpc.sampling.sigma_random": (0.0, 0.0, 0.0)}
    jc = jax_make_config("aliengo", mpc_type="sampling", **over)
    tc = config_from_dict(dataclasses.asdict(jc))
    assert tc.sim.visual_foothold_adaptation == "tamols"
    jh = JaxHarness(jc, seed=0, terrain_fn=step_up)
    th = SRBClosedLoopHarness(tc, seed=0, terrain_fn=step_up, device="cpu")
    P = th.ctrl.controller.num_parameters
    inc = (np.random.default_rng(0).standard_normal(P) * 4.0).astype(np.float32)
    js = jh.ctrl.controller.state
    jh.ctrl.controller.state = JaxState(jnp.asarray(inc), js.key, js.sigma)
    th.ctrl.controller.state = sampling_state_from_numpy(inc, np.zeros(P), 0, device="cpu")
    vel = np.array([0.3, 0.0, 0.0])
    jcalls, tcalls = _count_calls(jh.wb.vfa), _count_calls(th.wb.vfa)
    jhist, thist = np.zeros((200, 12)), np.zeros((200, 12))
    for i in range(200):
        jhist[i] = jh.step(vel, heightmaps=_sense_jax(jh.wb, step_up, jh.x[8], jc.tamols))
        thist[i] = th.step(vel, heightmaps=_sense_port(th.wb, step_up, th.x[8], tc.tamols,
                                                       "cpu"))
        assert tcalls == jcalls
        assert _retargets(th.wb.stc) == _retargets(jh.wb.stc)
    assert tcalls[0] >= 1
    np.testing.assert_allclose(thist, jhist, atol=1e-3)
    np.testing.assert_allclose(th.feet, jh.feet, atol=1e-4)
    np.testing.assert_allclose(th.wb.vfa.footholds_adaptation, jh.wb.vfa.footholds_adaptation,
                               atol=POS_ATOL)


def test_default_config_constructs_with_the_planner():
    """make_config("aliengo", mpc_type="sampling") defaults to TAMOLS: the port's
    WBInterface and harness construct with it on the CPU, with "height" too, and a
    planner asked for the card without one raises instead of using the CPU."""
    cfg = make_config("aliengo", mpc_type="sampling")
    assert cfg.sim.visual_foothold_adaptation == "tamols"
    h = SRBClosedLoopHarness(cfg, device="cpu")
    assert isinstance(h.wb.vfa, TamolsPlanner) and h.wb.vfa.device.type == "cpu"
    hcfg = make_config("aliengo", mpc_type="sampling", **{"sim.visual_foothold_adaptation":
                                                          "height"})
    wb = WBInterface(hcfg, Legs(h.default_feet.copy()), device="cpu")
    assert wb.vfa.strategy == "height"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TamolsPlanner(cfg)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            WBInterface(cfg, Legs(h.default_feet.copy()))


# The TAMOLS walks of the port (chip_smoke.py): (strategy, terrain name).
WALKS = (("tamols", "flat"), ("tamols", "step"), ("height", "step"))
WALK_TERRAINS = {"flat": flat, "step": step_up}


def reference_walks(num_samples=10_000, duration=3.0, vel=(0.3, 0.0, 0.0), walks=WALKS):
    """The JAX package's SRB harness walking the default configuration with the
    given strategy over sensed terrain (sensing as ``_sense_jax``): (strategy,
    terrain, triggers, distance (m), min z (m), max |roll|,|pitch| (rad), mean z
    of the second half - ref_z (m), wall s)."""
    rows = []
    for strategy, terrain in walks:
        cfg = jax_make_config("aliengo", mpc_type="sampling", **{
            "mpc.sampling.num_samples": num_samples,
            "sim.visual_foothold_adaptation": strategy})
        fn = WALK_TERRAINS[terrain]
        h = JaxHarness(cfg, seed=0, terrain_fn=fn)
        calls = _count_calls(h.wb.vfa)
        n = int(round(duration / cfg.sim.dt))
        hist = np.zeros((n, 12))
        t0 = time.perf_counter()
        for i in range(n):
            hist[i] = h.step(np.asarray(vel), heightmaps=_sense_jax(h.wb, fn, h.x[8], cfg.tamols))
        z = hist[:, 2]
        rows.append((strategy, terrain, calls[0], hist[-1, 0] - hist[0, 0], z.min(),
                     np.abs(hist[:, 6:8]).max(), np.mean(z[n // 2:]) - cfg.sim.ref_z,
                     time.perf_counter() - t0))
    return rows


if __name__ == "__main__":
    # python tests/test_torch_tamols.py [row ...]: the JAX reference's TAMOLS walks
    # on the CPU, on the platform the tests use (tests/conftest.py), for PERF.md
    # and chip_smoke.py; with row numbers, only those rows of WALKS.
    import sys

    import conftest  # noqa: F401

    picked = [WALKS[int(a)] for a in sys.argv[1:]] or WALKS
    for row in reference_walks(walks=picked):
        print("%s, %s: %d triggers, walked %.4f m, min z %.4f m, max |roll|,|pitch| %.4f rad, "
              "mean z of the second half - ref_z %+.4f m, wall %.1f s" % row, flush=True)
