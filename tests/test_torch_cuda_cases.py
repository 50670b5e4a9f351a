"""The sampling kernels K1a-K1f on the cases they took last: the ZMP-band cost,
(horizon, splines) pairs other than the flagship's, and CEM with more elites than
the per-block key lists hold.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest --noconftest -q tests/test_torch_cuda_cases.py`` (each pair's
libraries are built at their first use). Each kernel runs on injected noise and
is held against its plain torch version as ``chip_smoke.py`` holds it: costs
rtol 1e-4 with a 1e-2 floor (FMA contraction and the order of the basis sums;
beyond horizon 24, at the long pairs, on a standing trot, with the float64
split of ``ops/cost_checks.py``: ``assert_costs``),
the optimizer step against the plain step on the kernel's own costs (beta and
the argmin exactly, new parameters atol 1e-5, GRFs atol 1e-3 N, the predicted
state atol 1e-5), the elite set exactly. Sigma atol 1e-5 up to 32 elites; above
32 the refit sums up to 1000 squares in another order than torch.var, so rtol
1e-4 and atol 1e-5. The chain kernel K1d is held bit for bit to the successive
single iterations it replaces, as ``tests/test_torch_cuda_chain.py`` holds it.
"""
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
from quadruped_pympc_tamols_torch.ops import build
from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
from quadruped_pympc_tamols_torch.ops.cost_checks import (DRIFT_H, check_sample_costs, f64,
                                                          standing_trot_tick)

pytestmark = pytest.mark.cuda

ZMP_WEIGHT = 500.0  # the stone-field entry's (tests/test_closed_loop_walking.py)
# Phase 33's grid: (parametrization, horizon, splines).
PAIRS = {"8-cubic-2": ("cubic_spline", 8, 2), "16-cubic-3": ("cubic_spline", 16, 3),
         "24-cubic-4": ("cubic_spline", 24, 4), "12-linear-4": ("linear_spline", 12, 4),
         "24-zero_order": ("zero_order", 24, 2), "32-cubic-2": ("cubic_spline", 32, 2),
         "40-cubic-8": ("cubic_spline", 40, 8), "48-zero_order": ("zero_order", 48, 2),
         "85-zero_order": ("zero_order", 85, 2)}


def assert_costs(costs, ref, horizon, ref64):
    """Kernel costs (..., N) against plain ones by ``cost_checks.check_sample_costs``;
    beyond DRIFT_H with ``ref64()``, the plain version's costs in float64."""
    check_sample_costs(costs, ref, ref64() if horizon > DRIFT_H else None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the sampling kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def case_cfg(par="cubic_spline", horizon=12, splines=2, **over):
    return make_config("aliengo", **{"sim.visual_foothold_adaptation": "blind",
                                     "mpc.horizon": horizon,
                                     "mpc.sampling.parametrization": par,
                                     "mpc.sampling.num_splines": splines, **over})


def trot_tick(cfg):
    """A trot: the diagonal pairs (0, 3) and (1, 2) stand in turn two steps each,
    with a four-stance step between, so the ZMP band's two-stance masks switch;
    the base stands 2 cm to the left of the diagonals' crossing."""
    H = cfg.mpc.horizon
    state12 = np.zeros(12, np.float32)
    state12[1:5] = 0.02, cfg.sim.ref_z - 0.03, 0.2, 0.05
    ref12 = np.zeros(12, np.float32)
    ref12[1:4] = 0.02, cfg.sim.ref_z, 0.3
    feet = np.array([[0.27, 0.16, 0], [0.27, -0.16, 0], [-0.25, 0.16, 0.05], [-0.25, -0.16, 0]],
                    np.float32)
    seq = np.ones((4, H), np.float32)
    for n in range(H):
        phase = n % 5
        if phase in (1, 2):
            seq[[1, 2], n] = 0.0
        elif phase in (3, 4):
            seq[[0, 3], n] = 0.0
    share = gravity_share(torch.from_numpy(seq), cfg.robot.mass)[:, None].expand(H, 4)
    return sk.TickInputs(state12, feet, ref12, seq, np.ascontiguousarray(share.numpy()))


def pair_tick(cfg):
    """trot_tick up to DRIFT_H; beyond it cost_checks.standing_trot_tick, on which
    the long rollouts stay finite."""
    H = cfg.mpc.horizon
    return standing_trot_tick(cfg, H) if H > DRIFT_H else trot_tick(cfg)


def inputs(plan, knobs, n, dev, seed, scale=1.0):
    """Incumbent, CEM sigma and injected noise (sigma_mppi's 3 for the others),
    sigma and noise times ``scale``."""
    rng = np.random.default_rng(seed)
    P = plan.num_parameters
    inc = torch.as_tensor(0.5 * rng.standard_normal(P).astype(np.float32), device=dev)
    sigma = torch.as_tensor(scale * rng.uniform(0.3, 3.0, P).astype(np.float32), device=dev)
    noise = torch.as_tensor(rng.standard_normal((P, n)).astype(np.float32), device=dev)
    noise = noise * (sigma[:, None] if knobs.cem else 3.0 * scale)
    noise[:, 0] = 0.0
    return inc, sigma, noise.contiguous()


def plain_costs(plan, tick, inc, noise, dev, zmp=None):
    t = sk.tick_tensors(tick, dev)
    return sk.rollout_costs_reference(inc[:, None] + noise, plan.W, *t, plan.dts, plan.q_diag,
                                      plan.srbd, plan.fm,
                                      plan.zmp_weight if zmp is None else zmp, plan.zmp_margin)


def check_band(costs, costs0, plain, plain0):
    """The band as the kernel adds it (its costs at ZMP_WEIGHT less its costs at
    weight 0, on the same noise) against the band of the plain version, as
    ``chip_smoke.py`` phase 31 holds it: each sample's to atol 1e-3 plus rtol 2e-6
    of that sample's plain cost (the running sum's rounding); the mean error within
    a tenth of the mean tolerance; and active: the kernel's own band raises at
    least a tenth of the costs."""
    band = (costs - costs0).double().flatten()
    band_plain = (plain - plain0).double().flatten()
    gap = (band - band_plain).abs()
    tol = 1e-3 + 2e-6 * plain.double().abs().flatten()
    worst = int((gap / tol).argmax())
    assert gap[worst] <= tol[worst], (worst, float(gap[worst]), float(tol[worst]))
    assert abs(float((band - band_plain).mean())) <= 0.1 * float(tol.mean())
    assert (band > 1e-3).sum().item() > band.numel() // 10


def check_step(plan, knobs, tick, inc, noise, costs, out, sigma, elites, dev):
    """The optimizer step against the plain one on the kernel's own costs."""
    t = sk.tick_tensors(tick, dev)
    ref = sm.softmax_combine_reference(costs, noise, inc, plan.W, t[0], t[1], t[3], t[4],
                                       plan.dts, plan.srbd, plan.fm, knobs)
    assert float(out[0]) == float(ref.beta)
    assert int(out[25]) == int(ref.best_index)
    torch.testing.assert_close(out[sk.OUT_WINNER:], ref.new_params, rtol=0, atol=1e-5)
    torch.testing.assert_close(out[1:13], ref.grfs.reshape(12), rtol=0, atol=1e-3)
    torch.testing.assert_close(out[13:25], ref.next_state, rtol=0, atol=1e-5)
    if knobs.cem:
        check_elites(knobs, elites, ref.elites, sigma, ref.sigma)


def check_elites(knobs, elites, ref_elites, sigma, ref_sigma):
    if knobs.n_elite <= sm.LIST_ELITE:
        assert elites.tolist() == ref_elites.tolist()
        torch.testing.assert_close(sigma, ref_sigma, rtol=0, atol=1e-5)
    else:  # the kernels list the set in index order, the plain version in (cost, index)
        assert elites.tolist() == sorted(ref_elites.tolist())
        torch.testing.assert_close(sigma, ref_sigma, rtol=1e-4, atol=1e-5)


def check_single(plan, knobs, tick, inc, sigma, noise, dev):
    """K1a, K1b or K1c on injected noise against the plain version; its costs and
    the plain ones."""
    if knobs.method == "random_sampling":
        costs, out = sk.sampling_rs(plan, tick, inc, 0, 0, noise_in=noise)
    else:
        costs, out, sig, el = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 0, 0,
                                                   noise_in=noise)
    torch.cuda.synchronize()
    assert_costs(costs, plain_costs(plan, tick, inc, noise, dev), plan.horizon,
                 lambda: plain_costs(f64(plan), tick, inc.double(), noise.double(), dev))
    if knobs.method == "random_sampling":
        k = int(out[25])
        assert k == int(torch.argmin(costs)) and float(out[0]) == float(costs[k])
        torch.testing.assert_close(out[sk.OUT_WINNER:], inc + noise[:, k], rtol=0, atol=1e-6)
    else:
        check_step(plan, knobs, tick, inc, noise, costs, out, sig, el, dev)
    return costs, plain_costs(plan, tick, inc, noise, dev)


def check_chain(plan, knobs, tick, inc, sigma):
    """K1d: three iterations in one launch, bit-equal to three single iterations."""
    before = sm.sampling_chain.launches[knobs.method]
    chain = sm.sampling_chain(plan, knobs, tick, inc, sigma, 7, 3, 3)
    assert sm.sampling_chain.launches[knobs.method] == before + 1
    singles = sm.sampling_chain(plan, knobs, tick, inc, sigma, 7, 3, 1)
    x, s = singles[0].out[sk.OUT_WINNER:], singles[0].sigma
    for it in (1, 2):
        if knobs.method == "random_sampling":
            c, o = sk.sampling_rs(plan, tick, x, 7, 3 + it)
            singles.append(sm.IterationResult(c, o, s, None))
        else:
            c, o, s2, e = sm.softmax_iteration(plan, knobs, tick, x, s, 7, 3 + it)
            singles.append(sm.IterationResult(c, o, s2, e))
            s = s2
        x = singles[-1].out[sk.OUT_WINNER:]
    torch.cuda.synchronize()
    for a, b in zip(chain, singles):
        assert torch.equal(a.costs, b.costs) and torch.equal(a.out, b.out)
        if knobs.cem:
            assert torch.equal(a.sigma, b.sigma) and torch.equal(a.elites, b.elites)
    return chain


def group_case(cfg, knobs, n, dev, seed, scale=1.0):
    from quadruped_pympc_tamols_torch.controllers.sampling import group_operators
    plan = sg.make_group_plan(cfg, n, dev)
    groups = group_operators(cfg, np.array([0.3, 0.8, 0.8, 0.3], np.float32),
                             np.asarray(cfg.mpc.step_freq_available, np.float32))
    inc, sigma, noise = inputs(plan.base, knobs, plan.num_used, dev, seed, scale)
    return plan, groups, inc, sigma, noise


def check_groups(cfg, knobs, tick, n, dev, seed, scale=1.0):
    """K1e on injected noise against the plain group rollout and step; its costs
    and the plain ones."""
    plan, groups, inc, sigma, noise = group_case(cfg, knobs, n, dev, seed, scale)
    costs, out, sig, el = sg.sampling_groups(plan, knobs, tick, groups, inc, sigma, 0, 0,
                                             noise_in=noise)
    torch.cuda.synchronize()
    t = sk.tick_tensors(tick, dev)
    g = [torch.as_tensor(x, device=dev) for x in (groups.contact, groups.share, groups.offsets)]
    b = plan.base
    ref = sg.group_costs_reference(inc[:, None] + noise, groups.dense(dev), *g, t[0], t[1], t[2],
                                   b.dts, b.q_diag, b.srbd, b.fm, b.zmp_weight, b.zmp_margin)
    assert_costs(costs, ref, b.horizon, lambda: sg.group_costs_reference(
        inc.double()[:, None] + noise.double(), groups.dense(dev).double(),
        *(x.double() for x in g), t[0], t[1], t[2], b.dts, b.q_diag, f64(b.srbd), b.fm,
        b.zmp_weight, b.zmp_margin))
    if knobs.method == "random_sampling":
        k = int(out[25])
        assert k == int(torch.argmin(costs)) and float(out[0]) == float(costs[k])
    else:
        check_step(b, knobs, tick, inc, noise, costs, out, sig, el, dev)
    return costs, ref


def fleet_case(cfg, knobs, S, N, dev, seed, scale=1.0):
    """S scenarios of the pair's tick, each state and foot nudged by 1 cm (1 mm
    beyond DRIFT_H)."""
    rng = np.random.default_rng(seed)
    plan = sk.make_rs_plan(cfg, N, dev)
    tick = pair_tick(cfg)
    nudge = 0.001 if plan.horizon > DRIFT_H else 0.01
    P = plan.num_parameters

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    st = np.repeat(tick.state12[None], S, 0) + nudge * rng.standard_normal((S, 12))
    feet = np.repeat(tick.feet[None], S, 0) + nudge * rng.standard_normal((S, 4, 3))
    ftick = fl.FleetTick(t(st), t(feet), t(np.repeat(tick.ref12[None], S, 0)),
                         t(np.repeat(tick.contact_seq[None], S, 0)),
                         t(np.repeat(tick.share[None], S, 0)))
    inc = t(0.5 * rng.standard_normal((S, P)))
    sigma = t(scale * rng.uniform(0.3, 3.0, (S, P)))
    noise = t(rng.standard_normal((S, P, N))) * (sigma[:, :, None] if knobs.cem else 3.0 * scale)
    noise[:, :, 0] = 0.0
    seeds = torch.arange(S, dtype=torch.int64, device=dev) + 5
    offsets = torch.arange(S, dtype=torch.int64, device=dev) * 2
    return plan, ftick, inc, sigma, noise.contiguous(), seeds, offsets


def check_fleet(cfg, knobs, S, N, layout, dev, seed, scale=1.0):
    """K1f in ``layout`` against the plain version; its costs and the plain ones.
    With REGEN the noise is the kernel's own Philox draw (kept by the workspace);
    else injected."""
    plan, tick, inc, sigma, noise, seeds, offsets = fleet_case(cfg, knobs, S, N, dev, seed,
                                                               scale)
    if layout & fl.REGEN:
        ws = fl.fleet_workspace(plan, knobs, S, dev, layout, keep_noise=True)
        costs, out, sig, el = fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets,
                                                 ws=ws, layout=layout)
        noise = ws.noise if knobs.method != "random_sampling" else None
    else:
        costs, out, sig, el = fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets,
                                                 noise_in=noise, layout=layout)
    torch.cuda.synchronize()
    if noise is None:  # random sampling's REGEN draw: the costs alone are its own
        return costs, None
    ref = fl.fleet_iteration_reference(plan, knobs, tick, inc, sigma, noise)
    assert_costs(costs, ref.costs, plan.horizon, lambda: fl.fleet_iteration_reference(
        f64(plan), knobs, f64(tick), inc.double(), sigma.double(), noise.double()).costs)
    own = fl.fleet_iteration_reference(plan, knobs, tick, inc, sigma, noise, costs=costs)
    torch.testing.assert_close(out[:, 0], own.out[:, 0], rtol=0, atol=0)
    torch.testing.assert_close(out[:, 25], own.out[:, 25], rtol=0, atol=0)
    torch.testing.assert_close(out[:, sk.OUT_WINNER:], own.out[:, sk.OUT_WINNER:], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(out[:, 1:13], own.out[:, 1:13], rtol=0, atol=1e-3)
    torch.testing.assert_close(out[:, 13:25], own.out[:, 13:25], rtol=0, atol=1e-5)
    if knobs.cem:
        for s in range(S):
            check_elites(knobs, el[s], own.elites[s], sig[s], own.sigma[s])
    return costs.clone(), ref.costs


# -- the ZMP band on every kernel ------------------------------------------------------

ZMP_KERNELS = ["K1a", "K1b", "K1c", "K1d", "K1e-rs", "K1e-mppi", "K1e-cem", "K1f-four",
               "K1f-wide"]


@pytest.mark.parametrize("kernel", ZMP_KERNELS)
def test_zmp_band_on_every_kernel(cuda_device, kernel):
    """At weight 500 on the trot tick, N = 1000 (three scenarios for K1f), forces
    ten times the usual noise: each kernel against its plain version, and the
    band it adds (its costs less its costs at weight 0) against the plain band;
    K1d bit-equal to its single iterations, its band on iteration 0."""
    dev = cuda_device
    method = {"K1a": "random_sampling", "K1b": "mppi", "K1c": "cem_mppi", "K1d": "mppi",
              "K1e-rs": "random_sampling", "K1e-mppi": "mppi", "K1e-cem": "cem_mppi",
              "K1f-four": "cem_mppi", "K1f-wide": "mppi"}[kernel]
    over = {"mpc.optimize_step_freq": True} if kernel.startswith("K1e") else {}
    cfgs = [case_cfg(**over, **{"mpc.sampling.zmp_weight": w}) for w in (ZMP_WEIGHT, 0.0)]
    knobs = sm.make_knobs(cfgs[0], method)
    tick = trot_tick(cfgs[0])
    if kernel.startswith("K1e"):
        runs = [check_groups(cfg, knobs, tick, 1000, dev, 3, scale=10.0) for cfg in cfgs]
    elif kernel.startswith("K1f"):
        layout = fl.FOUR_LANE if kernel == "K1f-four" else fl.WIDE
        runs = [check_fleet(cfg, knobs, 3, 1000, layout, dev, 4, scale=10.0) for cfg in cfgs]
    elif kernel == "K1d":
        plans = [sk.make_rs_plan(cfg, 1000, dev) for cfg in cfgs]
        inc, sigma, _ = inputs(plans[0], knobs, 1000, dev, 5, scale=10.0)
        chains = [check_chain(plan, knobs, tick, inc, sigma) for plan in plans]
        band = chains[0][0].costs - chains[1][0].costs
        assert (band > 1e-3).sum().item() > 100 and float(band.min()) >= -1e-2
        return
    else:
        plans = [sk.make_rs_plan(cfg, 1000, dev) for cfg in cfgs]
        inc, sigma, noise = inputs(plans[0], knobs, 1000, dev, 5, scale=10.0)
        runs = [check_single(plan, knobs, tick, inc, sigma, noise, dev) for plan in plans]
    (costs, plain), (costs0, plain0) = runs
    check_band(costs, costs0, plain, plain0)


# -- the pair grid ---------------------------------------------------------------------

@pytest.mark.parametrize("family", ["K1a-K1c", "K1d", "K1e", "K1f"])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_pair_grid(cuda_device, pair, family):
    """Each kernel family at each pair of the grid, N = 500, against its plain
    version (K1d bit-equal to its single iterations)."""
    dev = cuda_device
    par, H, ns = PAIRS[pair]
    cfg = case_cfg(par, H, ns, **({"mpc.optimize_step_freq": True} if family == "K1e" else {}))
    plan = sk.make_rs_plan(cfg, 500, dev)
    build.check_pair(plan.horizon, plan.params_per_leg)
    tick = pair_tick(cfg)
    for i, method in enumerate(sm.METHODS):
        knobs = sm.make_knobs(cfg, method)
        if family == "K1a-K1c":
            check_single(plan, knobs, tick, *inputs(plan, knobs, 500, dev, 10 + i), dev)
        elif family == "K1d":
            inc, sigma, _ = inputs(plan, knobs, 500, dev, 20 + i)
            check_chain(plan, knobs, tick, inc, sigma)
        elif family == "K1e":
            check_groups(cfg, knobs, tick, 500, dev, 30 + i)
        else:
            for layout in (fl.FOUR_LANE, fl.WIDE):
                check_fleet(cfg, knobs, 2, 500, layout, dev, 40 + i)


def test_pair_beyond_the_bound_raises(cuda_device):
    """A pair beyond the kernels' bounds (H > 128, or P = 4 * P_leg > 1024: 22 cubic
    splines) raises one NotImplementedError naming them."""
    from quadruped_pympc_tamols_torch.controllers.sampling import make_sampling_solver
    for over in ({"mpc.horizon": 129}, {"mpc.sampling.num_splines": 22}):
        with pytest.raises(NotImplementedError, match=r"horizon <= 128 and 4 <= parameters per "
                                                      r"leg <= 256 \(P = 4 \* P_leg <= 1024"):
            make_sampling_solver(case_cfg(**over), 1000, device=cuda_device)


# -- CEM with more elites than the key lists hold --------------------------------------

@pytest.mark.parametrize("kernel", ["K1c", "K1d", "K1e-cem", "K1f-four", "K1f-regen"])
@pytest.mark.parametrize("n_elite", [33, 100, 1000])
def test_large_elite_counts(cuda_device, n_elite, kernel):
    """CEM at K = 33, 100 and 1000 of N = 3000: the elite set exactly
    jax.lax.top_k's (lowest index first on equal costs), listed in index order, and
    sigma within tolerance; then on a NaN state, where every cost is 1e6 and the
    elites are samples 0..K-1."""
    dev = cuda_device
    N = 3000
    over = {"mpc.sampling.cem_elite": n_elite}
    if kernel == "K1e-cem":
        over["mpc.optimize_step_freq"] = True
    cfg = case_cfg(**over)
    knobs = sm.make_knobs(cfg, "cem_mppi")
    assert knobs.n_elite == n_elite
    tick = trot_tick(cfg)
    if kernel == "K1e-cem":
        check_groups(cfg, knobs, tick, N, dev, 50)
        return
    if kernel.startswith("K1f"):
        layout = fl.FOUR_LANE if kernel == "K1f-four" else fl.LARGE_BATCH
        check_fleet(cfg, knobs, 2, N, layout, dev, 51)
        return
    plan = sk.make_rs_plan(cfg, N, dev)
    inc, sigma, noise = inputs(plan, knobs, N, dev, 52)
    if kernel == "K1d":
        check_chain(plan, knobs, tick, inc, sigma)
        return
    check_single(plan, knobs, tick, inc, sigma, noise, dev)
    nan_tick = tick._replace(state12=np.full(12, np.nan, np.float32))
    _, _, _, el = sm.softmax_iteration(plan, knobs, nan_tick, inc, sigma, 0, 0, noise_in=noise)
    assert el.tolist() == list(range(n_elite))
