"""The shared rollout pass of kernels K1a, K1b and K1e (``rollout_kernel`` in
ops/csrc/sampling_common.cuh: four lanes per sample, blocks of
``sampling_kernel.ROLLOUT_SAMPLES`` samples) at the geometry's edges, against the
plain torch versions on the card.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest --noconftest tests/test_torch_cuda_rollout.py -m cuda``. The
sample counts leave a ragged last block (1, 2, 63, 65 and 10 001 samples in
blocks of 16) and K1e's group size is no multiple of the block, so samples past
a group's end run on a clamped index and must write nothing. Tolerances as in
test_torch_cuda_kernel.py: costs rtol 1e-4 / atol 1e-2, GRFs atol 1e-3 N, the
predicted state atol 1e-5 (FMA contraction and the order of the basis sums), the
winner atol 1e-6, the MPPI step against the plain combine on the kernel's own
costs to atol 1e-5 with beta exact. Every case runs with the main path's cubic
splines (24 parameters per leg), linear splines (9, whose leg draws three Philox
chunks and uses nine of their twelve values) and zero-order holds (36)."""
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

pytestmark = pytest.mark.cuda

RAGGED = [1, 2, 63, 65, 10_001]
BASE = {"sim.visual_foothold_adaptation": "blind"}
PARS = ["cubic_spline", "linear_spline", "zero_order"]


def _cfg(par="cubic_spline", **over):
    return make_config("aliengo", **BASE, **{"mpc.sampling.parametrization": par, **over})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the rollout pass has no CPU mode)")
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


def _inputs(P, n, seed, dev, scale=3.0):
    rng = np.random.default_rng(seed)
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
    noise = torch.as_tensor((rng.standard_normal((P, n)) * scale).astype(np.float32), device=dev)
    noise[:, 0] = 0.0
    return inc, noise


def _plain_costs(plan, tick, inc, noise, dev):
    t = sk.tick_tensors(tick, dev)
    return sk.rollout_costs_reference(inc[:, None] + noise, plan.W, t[0], t[1], t[2], t[3], t[4],
                                      plan.dts, plan.q_diag, plan.srbd, plan.fm)


@pytest.mark.parametrize("num_samples", RAGGED)
@pytest.mark.parametrize("par", PARS)
def test_k1a_ragged_matches_plain_version(cuda_device, par, num_samples):
    cfg = _cfg(par)
    plan = sk.make_rs_plan(cfg, num_samples, cuda_device)
    tick = _tick(cfg)
    inc, noise = _inputs(plan.num_parameters, num_samples, num_samples, cuda_device)
    costs, out = sk.sampling_rs(plan, tick, inc, 0, 0, noise_in=noise)
    torch.cuda.synchronize()
    ref = _plain_costs(plan, tick, inc, noise, cuda_device)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-2)
    k = int(out[25])
    assert k == int(torch.argmin(costs)) and float(out[0]) == float(costs[k])
    winner = inc + noise[:, k]
    torch.testing.assert_close(out[sk.OUT_WINNER:], winner, rtol=0, atol=1e-6)
    t = sk.tick_tensors(tick, cuda_device)
    grfs, state = sk.step0_reference(winner, plan.W, t[0], t[1], t[3], t[4], plan.dts, plan.srbd,
                                     plan.fm)
    torch.testing.assert_close(out[1:13], grfs.reshape(12), rtol=0, atol=1e-3)
    torch.testing.assert_close(out[13:25], state, rtol=0, atol=1e-5)


@pytest.mark.parametrize("par", PARS)
def test_four_lane_extraction_matches_plain_version(cuda_device, par):
    """K1a's and K1e-rs's winner extraction (``rs_extract``: the winner's
    parameters regenerated from Philox, step 0 on four lanes, one per leg) against
    the plain step-0 extraction of the winner, on the dumped noise at N = 10 000,
    and on a NaN state, where every cost ties at 1e6, the winner is sample 0 and
    the predicted state is NaN in both."""
    from quadruped_pympc_tamols_torch.controllers.sampling import group_operators
    N = 10_000
    cfg = _cfg(par, **{"mpc.optimize_step_freq": True})
    plan = sk.make_rs_plan(cfg, N, cuda_device)
    gplan = sg.make_group_plan(cfg, N, cuda_device)
    knobs = sm.make_knobs(cfg, "random_sampling")
    groups = group_operators(cfg, np.array([0.3, 0.8, 0.8, 0.3], np.float32),
                             np.asarray(cfg.mpc.step_freq_available, np.float32))
    P = plan.num_parameters
    inc, _ = _inputs(P, 1, 8, cuda_device)
    for tick in (_tick(cfg), _tick(cfg)._replace(state12=np.full(12, np.nan, np.float32))):
        t = sk.tick_tensors(tick, cuda_device)
        dump = torch.empty(P, N, device=cuda_device)
        gdump = torch.empty(P, gplan.num_used, device=cuda_device)
        outs = [(sk.sampling_rs(plan, tick, inc, 4, 1, noise_out=dump), dump),
                (sg.sampling_groups(gplan, knobs, tick, groups, inc, None, 4, 1,
                                    noise_out=gdump)[:2], gdump)]
        torch.cuda.synchronize()
        for (costs, out), noise in outs:
            k = int(out[25])
            assert k == int(torch.argmin(costs)) and float(out[0]) == float(costs[k])
            winner = inc + noise[:, k]
            assert torch.equal(out[sk.OUT_WINNER:], winner)
            grfs, state = sk.step0_reference(winner, plan.W, t[0], t[1], t[3], t[4], plan.dts,
                                             plan.srbd, plan.fm)
            torch.testing.assert_close(out[1:13], grfs.reshape(12), rtol=0, atol=1e-3)
            torch.testing.assert_close(out[13:25], state, rtol=0, atol=1e-5, equal_nan=True)
            if np.isnan(tick.state12).all():
                assert k == 0 and bool(torch.isnan(out[13:25]).all())


@pytest.mark.parametrize("num_samples", RAGGED)
@pytest.mark.parametrize("par", PARS)
def test_k1b_ragged_matches_plain_version(cuda_device, par, num_samples):
    cfg = _cfg(par)
    plan = sk.make_rs_plan(cfg, num_samples, cuda_device)
    knobs = sm.make_knobs(cfg, "mppi")
    tick = _tick(cfg)
    inc, noise = _inputs(plan.num_parameters, num_samples, num_samples + 1, cuda_device)
    costs, out, _, _ = sm.softmax_iteration(plan, knobs, tick, inc, None, 0, 0, noise_in=noise)
    torch.cuda.synchronize()
    torch.testing.assert_close(costs, _plain_costs(plan, tick, inc, noise, cuda_device),
                               rtol=1e-4, atol=1e-2)
    t = sk.tick_tensors(tick, cuda_device)
    ref = sm.softmax_combine_reference(costs, noise, inc, plan.W, t[0], t[1], t[3], t[4],
                                       plan.dts, plan.srbd, plan.fm, knobs)
    assert float(out[0]) == float(ref.beta) and int(out[25]) == int(ref.best_index)
    torch.testing.assert_close(out[sk.OUT_WINNER:], ref.new_params, rtol=0, atol=1e-5)
    torch.testing.assert_close(out[1:13], ref.grfs.reshape(12), rtol=0, atol=1e-3)
    torch.testing.assert_close(out[13:25], ref.next_state, rtol=0, atol=1e-5)


@pytest.mark.parametrize("method", ["random_sampling", "mppi", "cem_mppi"])
@pytest.mark.parametrize("par", PARS)
def test_k1e_group_size_off_the_block(cuda_device, par, method):
    """Three groups of 33 samples (N = 100, sample 99 not evaluated). 33 is no
    multiple of the block's 16 samples, so each group's last block holds one live
    sample and 15 that run on a clamped index and must write nothing."""
    from quadruped_pympc_tamols_torch.controllers.sampling import group_operators
    cfg = _cfg(par, **{"mpc.optimize_step_freq": True,
                       "mpc.step_freq_available": (2.4, 1.3, 2.0)})
    plan = sg.make_group_plan(cfg, 100, cuda_device)
    assert (plan.group_size, plan.num_used) == (33, 99)
    assert plan.group_size % sk.ROLLOUT_SAMPLES != 0
    knobs = sm.make_knobs(cfg, method)
    tick = _tick(cfg)
    groups = group_operators(cfg, np.array([0.3, 0.8, 0.8, 0.3], np.float32),
                             np.asarray(cfg.mpc.step_freq_available, np.float32))
    P, n = plan.base.num_parameters, plan.num_used
    inc, noise = _inputs(P, n, 21, cuda_device)
    sigma = torch.full((P,), 2.0, device=cuda_device)
    costs, out, _, el = sg.sampling_groups(plan, knobs, tick, groups, inc, sigma, 0, 0,
                                           noise_in=noise)
    torch.cuda.synchronize()
    t = sk.tick_tensors(tick, cuda_device)
    g = [torch.as_tensor(x, device=cuda_device)
         for x in (groups.contact, groups.share, groups.offsets)]
    ref = sg.group_costs_reference(inc[:, None] + noise, groups.dense(cuda_device), *g, t[0],
                                   t[1], t[2], plan.base.dts, plan.base.q_diag, plan.base.srbd,
                                   plan.base.fm)
    torch.testing.assert_close(costs, ref, rtol=1e-4, atol=1e-2)
    if method == "random_sampling":
        k = int(out[25])
        assert k == int(torch.argmin(costs)) and float(out[0]) == float(costs[k])
        torch.testing.assert_close(out[sk.OUT_WINNER:], inc + noise[:, k], rtol=0, atol=1e-6)
        return
    p = plan.base
    comb = sm.softmax_combine_reference(costs, noise, inc, p.W, t[0], t[1], t[3], t[4], p.dts,
                                        p.srbd, p.fm, knobs)
    assert float(out[0]) == float(comb.beta) and int(out[25]) == int(comb.best_index)
    torch.testing.assert_close(out[sk.OUT_WINNER:], comb.new_params, rtol=0, atol=1e-5)
    if knobs.cem:
        assert el.tolist() == comb.elites.tolist()


@pytest.mark.parametrize("par", PARS)
def test_philox_and_injected_noise_give_the_same_bits(cuda_device, par):
    """Each kernel's Philox noise, dumped through noise_out and fed back as
    noise_in, gives bit-equal costs and the same argmin: the four lanes of a
    sample draw its noise with the counters one thread per sample used. A rerun
    repeats every output's bits (at 9 parameters per leg a lane stores and reads
    back only its nine values of three Philox chunks)."""
    from quadruped_pympc_tamols_torch.controllers.sampling import group_operators
    cfg = _cfg(par)
    N = 1001
    plan = sk.make_rs_plan(cfg, N, cuda_device)
    tick = _tick(cfg)
    P = plan.num_parameters
    inc, _ = _inputs(P, 1, 5, cuda_device)
    sigma = torch.as_tensor(np.random.default_rng(6).uniform(0.3, 4.0, P).astype(np.float32),
                            device=cuda_device)
    dump = torch.empty(P, N, device=cuda_device)
    c1, o1 = sk.sampling_rs(plan, tick, inc, 9, 4, noise_out=dump)
    c2, o2 = sk.sampling_rs(plan, tick, inc, 9, 4, noise_in=dump)
    torch.cuda.synchronize()
    assert torch.equal(c1, c2) and torch.equal(o1, o2)
    c3, o3 = sk.sampling_rs(plan, tick, inc, 9, 4)
    torch.cuda.synchronize()
    assert torch.equal(c1, c3) and torch.equal(o1, o3)
    for method in ("mppi", "cem_mppi"):
        knobs = sm.make_knobs(cfg, method)
        r1 = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 9, 4, noise_out=dump)
        r2 = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 9, 4, noise_in=dump)
        torch.cuda.synchronize()
        assert torch.equal(r1[0], r2[0]) and int(r1[1][25]) == int(r2[1][25])
        r3 = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 9, 4)
        torch.cuda.synchronize()
        assert all(a is None or torch.equal(a, b) for a, b in zip(r1, r3))
    gcfg = _cfg(par, **{"mpc.optimize_step_freq": True})
    gplan = sg.make_group_plan(gcfg, N, cuda_device)
    groups = group_operators(gcfg, np.array([0.3, 0.8, 0.8, 0.3], np.float32),
                             np.asarray(gcfg.mpc.step_freq_available, np.float32))
    gdump = torch.empty(P, gplan.num_used, device=cuda_device)
    for method in ("random_sampling", "mppi", "cem_mppi"):
        knobs = sm.make_knobs(gcfg, method)
        r1 = sg.sampling_groups(gplan, knobs, tick, groups, inc, sigma, 9, 4, noise_out=gdump)
        r2 = sg.sampling_groups(gplan, knobs, tick, groups, inc, sigma, 9, 4, noise_in=gdump)
        torch.cuda.synchronize()
        assert torch.equal(r1[0], r2[0]) and int(r1[1][25]) == int(r2[1][25])
        r3 = sg.sampling_groups(gplan, knobs, tick, groups, inc, sigma, 9, 4)
        torch.cuda.synchronize()
        assert all(a is None or torch.equal(a, b) for a, b in zip(r1, r3))
