"""Kernels K1a (ops/csrc/sampling_rs.cu), K1b and K1c (ops/csrc/sampling_softmax.cu), K1d
(ops/csrc/sampling_chain.cu) and K1e (ops/csrc/sampling_groups.cu) against their plain
torch versions on the card.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest tests/test_torch_cuda_kernel.py -m cuda``. Tolerances as in
chip_smoke.py: costs rtol 1e-4 / atol 1e-2, GRFs atol 1e-3 N, the predicted state
atol 1e-5 (FMA contraction and the order of the basis sums). The MPPI / CEM
optimizer step is held against the plain combine applied to the kernel's own
costs and the same noise (the weights amplify cost rounding through exp): beta
exactly, the new parameters and sigma' to atol 1e-5 (sums in another order),
the elite indices exactly."""
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1a has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tick(cfg):
    H = cfg.mpc.horizon
    state12 = np.zeros(12, np.float32)
    state12[2], state12[3] = cfg.sim.ref_z - 0.03, 0.1
    ref12 = np.zeros(12, np.float32)
    ref12[2], ref12[3] = cfg.sim.ref_z, 0.2
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                    np.float32)
    seq = np.ones((4, H), np.float32)
    seq[1, 6:] = seq[2, 6:] = 0.0
    share = gravity_share(torch.from_numpy(seq), cfg.robot.mass)[:, None].expand(H, 4)
    return sk.TickInputs(state12, feet, ref12, seq, np.ascontiguousarray(share.numpy()))


@pytest.mark.parametrize("num_samples", [10_000, 1000, 97])
def test_kernel_matches_plain_version(cuda_device, num_samples):
    cfg = make_config("aliengo", **{"sim.visual_foothold_adaptation": "blind"})
    plan = sk.make_rs_plan(cfg, num_samples, cuda_device)
    tick = _tick(cfg)
    rng = np.random.default_rng(num_samples)
    P = plan.num_parameters
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32) * 2.0, device=cuda_device)
    noise = torch.as_tensor((rng.standard_normal((P, num_samples)) * 3.0).astype(np.float32),
                            device=cuda_device)
    noise[:, 0] = 0.0
    before = sk.sampling_rs.launches
    costs, out = sk.sampling_rs(plan, tick, inc, 0, 0, noise_in=noise)
    assert sk.sampling_rs.launches == before + 1
    t = lambda x: torch.as_tensor(x, device=cuda_device)  # noqa: E731
    ref = sk.sampling_iteration_reference(noise, inc, plan.W, t(tick.state12), t(tick.feet),
                                          t(tick.ref12), t(tick.contact_seq), t(tick.share),
                                          plan.dts, plan.q_diag, plan.srbd, plan.fm)
    torch.testing.assert_close(costs, ref.costs, rtol=1e-4, atol=1e-2)
    k = int(out[25])
    assert k == int(ref.best_index) or \
        abs(float(ref.costs[k]) - float(ref.best_cost)) <= 1e-2 + 1e-4 * float(ref.best_cost)
    winner = inc + noise[:, k]
    torch.testing.assert_close(out[sk.OUT_WINNER:], winner, rtol=0, atol=1e-6)
    if k == int(ref.best_index):
        torch.testing.assert_close(out[1:13], ref.grfs.reshape(12), rtol=0, atol=1e-3)
        torch.testing.assert_close(out[13:25], ref.next_state, rtol=0, atol=1e-5)


def _check_combine(plan, knobs, tick, inc, noise, costs, out, sigma, elites, dev):
    """The kernel's optimizer step against the plain combine on its own costs."""
    t = sk.tick_tensors(tick, dev)
    ref = sm.softmax_combine_reference(costs, noise, inc, plan.W, t[0], t[1], t[3], t[4],
                                       plan.dts, plan.srbd, plan.fm, knobs)
    assert float(out[0]) == float(ref.beta)
    assert int(out[25]) == int(ref.best_index)
    torch.testing.assert_close(out[sk.OUT_WINNER:], ref.new_params, rtol=0, atol=1e-5)
    torch.testing.assert_close(out[1:13], ref.grfs.reshape(12), rtol=0, atol=1e-3)
    torch.testing.assert_close(out[13:25], ref.next_state, rtol=0, atol=1e-5, equal_nan=True)
    if knobs.cem:
        assert elites.tolist() == ref.elites.tolist()
        torch.testing.assert_close(sigma, ref.sigma, rtol=0, atol=1e-5)


def _check_costs(plan, tick, inc, noise, costs, dev):
    t = sk.tick_tensors(tick, dev)
    ref = sk.rollout_costs_reference(inc[:, None] + noise, plan.W, t[0], t[1], t[2], t[3], t[4],
                                     plan.dts, plan.q_diag, plan.srbd, plan.fm)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("num_samples", [10_000, 1000, 97])
@pytest.mark.parametrize("method", ["mppi", "cem_mppi"])
def test_softmax_kernel_matches_plain_version(cuda_device, method, num_samples):
    """K1b / K1c on injected noise; then on a NaN state, where every cost saturates
    to 1e6 and the elites must be samples 0..K-1 (jax.lax.top_k's ties)."""
    cfg = make_config("aliengo", **{"sim.visual_foothold_adaptation": "blind"})
    plan = sk.make_rs_plan(cfg, num_samples, cuda_device)
    knobs = sm.make_knobs(cfg, method)
    tick = _tick(cfg)
    rng = np.random.default_rng(num_samples + 1)
    P = plan.num_parameters
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=cuda_device)
    sigma = torch.as_tensor(rng.uniform(0.3, 4.0, P).astype(np.float32), device=cuda_device)
    noise = torch.as_tensor(rng.standard_normal((P, num_samples)).astype(np.float32),
                            device=cuda_device) * (sigma[:, None] if knobs.cem else 3.0)
    noise[:, 0] = 0.0
    nan_state = tick._replace(state12=np.full(12, np.nan, np.float32))
    for tk in (tick, nan_state):
        want = dict(sm.softmax_iteration.launches)
        want[method] += 1
        costs, out, sig, el = sm.softmax_iteration(plan, knobs, tk, inc, sigma, 0, 0,
                                                   noise_in=noise)
        assert sm.softmax_iteration.launches == want
        torch.cuda.synchronize()
        _check_costs(plan, tk, inc, noise, costs, cuda_device)
        _check_combine(plan, knobs, tk, inc, noise, costs, out, sig, el, cuda_device)
    assert bool((costs == 1.0e6).all())
    if knobs.cem:
        assert el.tolist() == list(range(knobs.n_elite))


@pytest.mark.parametrize("num_samples", [10_000, 1000, 97])
def test_chained_kernels_match_single_iterations(cuda_device, num_samples):
    """K1d: three chained iterations of each method with Philox noise, one launch
    of the chain kernel (counted in sampling_chain.launches, not in the single
    iterations' counts). Iteration i repeats bit for bit as one iteration from
    iteration i - 1's device outputs at offset + i, and its dumped noise passes the
    plain checks."""
    cfg = make_config("aliengo", **{"sim.visual_foothold_adaptation": "blind"})
    plan = sk.make_rs_plan(cfg, num_samples, cuda_device)
    tick = _tick(cfg)
    P = plan.num_parameters
    rng = np.random.default_rng(7)
    inc0 = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=cuda_device)
    sig0 = torch.full((P,), 3.0, device=cuda_device)
    for method in ("random_sampling", "mppi", "cem_mppi"):
        knobs = sm.make_knobs(cfg, method)
        want = [sk.sampling_rs.launches, dict(sm.softmax_iteration.launches),
                dict(sm.sampling_chain.launches)]
        want[2][method] += 1
        res = sm.sampling_chain(plan, knobs, tick, inc0, sig0, 11, 5, 3)
        assert [sk.sampling_rs.launches, sm.softmax_iteration.launches,
                sm.sampling_chain.launches] == want
        assert len(res) == 3
        inc, sig = inc0, sig0
        for i, r in enumerate(res):
            dump = torch.empty(P, num_samples, device=cuda_device)
            if method == "random_sampling":
                costs, out = sk.sampling_rs(plan, tick, inc, 11, 5 + i, noise_out=dump)
            else:
                costs, out, s2, el = sm.softmax_iteration(plan, knobs, tick, inc, sig, 11, 5 + i,
                                                          noise_out=dump)
                assert torch.equal(s2, r.sigma)
                assert (el is None and r.elites is None) or torch.equal(el, r.elites)
            torch.cuda.synchronize()
            assert torch.equal(costs, r.costs) and torch.equal(out, r.out)
            _check_costs(plan, tick, inc, dump, costs, cuda_device)
            if method == "random_sampling":
                k = int(out[25])
                torch.testing.assert_close(out[sk.OUT_WINNER:], inc + dump[:, k], rtol=0,
                                           atol=1e-6)
            else:
                _check_combine(plan, knobs, tick, inc, dump, costs, out, s2, el, cuda_device)
            inc, sig = r.out[sk.OUT_WINNER:], r.sigma


def _check_group_kernel(plan, knobs, tick, groups, inc, noise, costs, out, sig, el, dev):
    """K1e's costs against the plain group rollout on the same noise, and its
    optimizer step against the plain one on its own costs."""
    t = sk.tick_tensors(tick, dev)
    g = [torch.as_tensor(x, device=dev) for x in (groups.contact, groups.share, groups.offsets)]
    ref = sg.group_costs_reference(inc[:, None] + noise, groups.dense(dev), *g, t[0], t[1], t[2],
                                   plan.base.dts, plan.base.q_diag, plan.base.srbd, plan.base.fm)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-2)
    if knobs.method != "random_sampling":
        _check_combine(plan.base, knobs, tick, inc, noise, costs, out, sig, el, dev)
        return
    k = int(out[25])
    assert k == int(torch.argmin(costs)) and float(out[0]) == float(costs[k])
    winner = inc + noise[:, k]
    torch.testing.assert_close(out[sk.OUT_WINNER:], winner, rtol=0, atol=1e-6)
    grfs, state = sk.step0_reference(winner, plan.base.W, t[0], t[1], t[3], t[4], plan.base.dts,
                                     plan.base.srbd, plan.base.fm)
    torch.testing.assert_close(out[1:13], grfs.reshape(12), rtol=0, atol=1e-3)
    torch.testing.assert_close(out[13:25], state, rtol=0, atol=1e-5, equal_nan=True)


@pytest.mark.parametrize("method", ["random_sampling", "mppi", "cem_mppi"])
def test_group_kernel_matches_plain_version(cuda_device, method):
    """K1e at N = 10 000: three groups of 3333, sample 9999 not evaluated. On
    injected noise; on a NaN state, where every cost is 1e6 plus its group's offset,
    so the winner is the first sample of the 1.3 Hz group and CEM's elites its first
    samples; on Philox noise, dumped, bit-identical on a rerun."""
    from quadruped_pympc_tamols_torch.controllers.sampling import group_operators
    cfg = make_config("aliengo", **{"sim.visual_foothold_adaptation": "blind",
                                    "mpc.optimize_step_freq": True,
                                    "mpc.step_freq_available": (2.4, 1.3, 2.0)})
    plan = sg.make_group_plan(cfg, 10_000, cuda_device)
    assert (plan.group_size, plan.num_used) == (3333, 9999)
    knobs = sm.make_knobs(cfg, method)
    tick = _tick(cfg)
    groups = group_operators(cfg, np.array([0.3, 0.8, 0.8, 0.3], np.float32),
                             np.asarray(cfg.mpc.step_freq_available, np.float32))
    rng = np.random.default_rng(12)
    P, n = plan.base.num_parameters, plan.num_used
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=cuda_device)
    sigma = torch.as_tensor(rng.uniform(0.3, 4.0, P).astype(np.float32), device=cuda_device)
    noise = torch.as_tensor(rng.standard_normal((P, n)).astype(np.float32),
                            device=cuda_device) * (sigma[:, None] if knobs.cem else 3.0)
    noise[:, 0] = 0.0
    nan_state = tick._replace(state12=np.full(12, np.nan, np.float32))
    for tk in (tick, nan_state):
        want = dict(sg.sampling_groups.launches)
        want[method] += 1
        res = sg.sampling_groups(plan, knobs, tk, groups, inc, sigma, 0, 0, noise_in=noise)
        assert sg.sampling_groups.launches == want
        torch.cuda.synchronize()
        _check_group_kernel(plan, knobs, tk, groups, inc, noise, *res, cuda_device)
    costs, out, _, el = res
    offsets = torch.as_tensor(groups.offsets, device=cuda_device).repeat_interleave(3333)
    assert torch.equal(costs, 1.0e6 + offsets)
    assert int(out[25]) == 3333
    if knobs.cem:
        assert el.tolist() == list(range(3333, 3333 + knobs.n_elite))
    dump = torch.empty(P, n, device=cuda_device)
    res = sg.sampling_groups(plan, knobs, tick, groups, inc, sigma, 5, 2, noise_out=dump)
    res2 = sg.sampling_groups(plan, knobs, tick, groups, inc, sigma, 5, 2)
    torch.cuda.synchronize()
    for a, b in zip(res, res2):
        assert (a is None and b is None) or torch.equal(a, b)
    assert bool((dump[:, 0] == 0).all())
    _check_group_kernel(plan, knobs, tick, groups, inc, dump, *res, cuda_device)


def test_cuda_solver_refuses_unported_paths(cuda_device):
    """The solvers refuse only a (horizon, parameters per leg) pair beyond the
    kernels' bounds, with one NotImplementedError naming them; the ZMP-band cost
    and other pairs (horizon 10 with cubic splines and zero-order holds) solve on
    the kernels, the sampling solver and the gait-adaptive one. Every method at 1
    and 3 iterations (K1a/K1b/K1c once, or the chain kernel K1d once), and the
    gait-adaptive solver's three, build and solve on the kernels with each
    parametrization."""
    from quadruped_pympc_tamols_torch.controllers.sampling import (make_gait_adaptive_solver,
                                                                   make_sampling_solver)
    from quadruped_pympc_tamols_torch.controllers.sampling.sampling_mpc import SamplingState
    base = {"sim.visual_foothold_adaptation": "blind"}
    gait = {**base, "mpc.optimize_step_freq": True}
    ones = np.ones(4, np.float32)
    for over in ({"mpc.sampling.zmp_weight": 500.0}, {"mpc.horizon": 10},
                 {"mpc.horizon": 10, "mpc.sampling.parametrization": "zero_order"}):
        cfg = make_config("aliengo", **base, **over)
        tick = _tick(cfg)
        solve, P = make_sampling_solver(cfg, 1000, device=cuda_device)
        state = SamplingState(torch.zeros(P, device=cuda_device), 0, 0,
                              torch.full((P,), 2.0, device=cuda_device))
        out, _ = solve(tick.state12, tick.feet, tick.ref12, tick.feet, tick.contact_seq, ones,
                       ones, state)
        assert bool(torch.isfinite(out.summary).all())
        gsolve, P = make_gait_adaptive_solver(make_config("aliengo", **gait, **over), 1000,
                                              "mppi", cuda_device)
        out, _ = gsolve(tick.state12, tick.feet, tick.ref12, tick.feet,
                        np.array([0.3, 0.8, 0.8, 0.3], np.float32), 1.4, True, tick.contact_seq,
                        ones, ones, state)
        assert bool(torch.isfinite(out.summary).all())
    for over in ({"mpc.horizon": 129},
                 {"mpc.horizon": 86, "mpc.sampling.parametrization": "zero_order"}):
        with pytest.raises(NotImplementedError, match="horizon <= 128"):
            make_sampling_solver(make_config("aliengo", **base, **over), 1000,
                                 device=cuda_device)
        with pytest.raises(NotImplementedError, match="horizon <= 128"):
            make_gait_adaptive_solver(make_config("aliengo", **gait, **over), 1000,
                                      device=cuda_device)
    tick = _tick(make_config("aliengo", **base))
    ones = np.ones(4, np.float32)
    for par in ("cubic_spline", "linear_spline", "zero_order"):
        for method in ("random_sampling", "mppi", "cem_mppi"):
            for iterations in (1, 3):
                cfg = make_config("aliengo", **base, **{
                    "mpc.sampling.parametrization": par, "mpc.sampling.method": method,
                    "mpc.sampling.num_iterations": iterations})
                solve, P = make_sampling_solver(cfg, 1000, device=cuda_device)
                state = SamplingState(torch.zeros(P, device=cuda_device), 0, 0,
                                      torch.full((P,), 2.0, device=cuda_device))
                counts = (lambda: (sk.sampling_rs.launches, dict(sm.softmax_iteration.launches),
                                   dict(sm.sampling_chain.launches)))
                want = counts()
                if iterations > 1:  # K1d: one launch of the chain kernel
                    want[2][method] += 1
                elif method == "random_sampling":
                    want = (want[0] + 1,) + want[1:]
                else:
                    want[1][method] += 1
                out, _ = solve(tick.state12, tick.feet, tick.ref12, tick.feet, tick.contact_seq,
                               ones, ones, state)
                assert counts() == want
                assert bool(torch.isfinite(out.summary).all())
            gsolve, P = make_gait_adaptive_solver(
                make_config("aliengo", **gait, **{"mpc.sampling.parametrization": par}), 1000,
                method, cuda_device)
            before = sg.sampling_groups.launches[method]
            state = SamplingState(torch.zeros(P, device=cuda_device), 0, 0,
                                  torch.full((P,), 2.0, device=cuda_device))
            out, _ = gsolve(tick.state12, tick.feet, tick.ref12, tick.feet,
                            np.array([0.3, 0.8, 0.8, 0.3], np.float32), 1.4, True,
                            tick.contact_seq, ones, ones, state)
            assert sg.sampling_groups.launches[method] == before + 1
            assert bool(torch.isfinite(out.summary).all())
