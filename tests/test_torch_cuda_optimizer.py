"""The update pass of kernels K1b, K1c, K1e-mppi and K1e-cem (``sm_update_kernel`` in
ops/csrc/sampling_softmax.cuh) against the plain combine ``softmax_combine_reference``
applied to the kernel's own costs and the same noise, on the card.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest --noconftest -q tests/test_torch_cuda_optimizer.py``. The pass
compacts each block's nonzero weights, reads their noise back (injected, or as
the rollout pass wrote it), and finishes in the block that takes the last ticket.
The cases cover its edges: one block (N = 1, whose only block is the last), ragged
last blocks (63, 65, 10 001), every weight nonzero (temperature 1e6: every sample
summed, in batches) against T = 1 (some weights underflow to 0), CEM with K = 2,
10 and 32 (at 32 the B*K candidate keys outgrow the shared stage), ties at the 1e6
saturation from a NaN state, K1e with groups of 33, a rerun on Philox noise, and
launches that reuse one workspace (each iteration's memset resets the ticket).
The temperatures, the elite counts, K1e and the rerun run with cubic splines
(P = 96), linear splines (P = 36) and zero-order holds (P = 144, whose partial
rows of 145 columns are summed two columns a thread in the finish).
Tolerances as in chip_smoke.py: beta and the elite indices exactly, the new
parameters and sigma' to atol 1e-5 (sums in another order than torch's), GRFs
atol 1e-3 N, the state atol 1e-5 (NaN where the state is NaN)."""
import dataclasses

import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
from quadruped_pympc_tamols_torch.ops import sampling_groups as sg
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

pytestmark = pytest.mark.cuda

BASE = {"sim.visual_foothold_adaptation": "blind"}
PARS = ["cubic_spline", "linear_spline", "zero_order"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the update pass has no CPU mode)")
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


def _inputs(P, n, seed, dev, cem=False):
    """Incumbent (P,), noise (P, n) with column 0 zero, and sigma (P,) in [0.3, 4]:
    the noise is standard normals times sigma (CEM) or times sigma_mppi = 3."""
    rng = np.random.default_rng(seed)
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
    sig = rng.uniform(0.3, 4.0, P).astype(np.float32)
    noise = rng.standard_normal((P, n)) * (sig[:, None] if cem else 3.0)
    noise = torch.as_tensor(noise.astype(np.float32), device=dev)
    noise[:, 0] = 0.0
    return inc, noise, torch.as_tensor(sig, device=dev)


def _check(plan, knobs, tick, inc, noise, res, dev):
    """The kernel's step against the plain combine on its own costs; returns the
    plain result."""
    costs, out, sigma, elites = res
    torch.cuda.synchronize()
    t = sk.tick_tensors(tick, dev)
    ref = sm.softmax_combine_reference(costs, noise, inc, plan.W, t[0], t[1], t[3], t[4],
                                       plan.dts, plan.srbd, plan.fm, knobs)
    assert float(out[0]) == float(ref.beta) and int(out[25]) == int(ref.best_index)
    torch.testing.assert_close(out[sk.OUT_WINNER:], ref.new_params, rtol=0, atol=1e-5)
    torch.testing.assert_close(out[1:13], ref.grfs.reshape(12), rtol=0, atol=1e-3)
    torch.testing.assert_close(out[13:25], ref.next_state, rtol=0, atol=1e-5, equal_nan=True)
    if knobs.cem:
        assert elites.tolist() == ref.elites.tolist()
        torch.testing.assert_close(sigma, ref.sigma, rtol=0, atol=1e-5)
    return ref


def _iteration(cuda_device, num_samples, method, seed, par="cubic_spline", **knob_over):
    cfg = make_config("aliengo", **BASE, **{"mpc.sampling.parametrization": par})
    plan = sk.make_rs_plan(cfg, num_samples, cuda_device)
    knobs = dataclasses.replace(sm.make_knobs(cfg, method), **knob_over)
    tick = _tick(cfg)
    inc, noise, sigma = _inputs(plan.num_parameters, num_samples, seed, cuda_device,
                                knobs.cem)
    res = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 0, 0, noise_in=noise)
    return plan, knobs, tick, inc, noise, res


@pytest.mark.parametrize("num_samples", [1, 63, 65, 10_001])
def test_mppi_update_at_ragged_block_counts(cuda_device, num_samples):
    plan, knobs, tick, inc, noise, res = _iteration(cuda_device, num_samples, "mppi", num_samples)
    _check(plan, knobs, tick, inc, noise, res, cuda_device)


@pytest.mark.parametrize("temperature", [1e6, 1.0])
@pytest.mark.parametrize("par", PARS)
def test_weights_all_nonzero_or_almost_all_zero(cuda_device, par, temperature):
    """At T = 1e6 every weight is nonzero, so every sample of every block is
    summed (two batches a block); at T = 1 some weights underflow to 0."""
    plan, knobs, tick, inc, noise, res = _iteration(cuda_device, 10_000, "mppi", 3, par,
                                                    temperature=temperature)
    ref = _check(plan, knobs, tick, inc, noise, res, cuda_device)
    nonzero = int((torch.exp(-(res[0] - ref.beta) / temperature) != 0).sum())
    if temperature > 1.0:
        assert nonzero == 10_000
    else:
        assert 1 <= nonzero < 10_000


@pytest.mark.parametrize("n_elite", [2, 10, 32])
@pytest.mark.parametrize("par", PARS)
def test_cem_elites_and_refit(cuda_device, par, n_elite):
    plan, knobs, tick, inc, noise, res = _iteration(cuda_device, 10_000, "cem_mppi", n_elite,
                                                    par, n_elite=n_elite)
    _check(plan, knobs, tick, inc, noise, res, cuda_device)
    assert res[3].shape == (n_elite,)


def test_cem_ties_at_the_saturation(cuda_device):
    """A NaN state saturates every cost at 1e6: every weight is 1 and the elites
    are the first K samples, as jax.lax.top_k takes ties."""
    cfg = make_config("aliengo", **BASE)
    plan = sk.make_rs_plan(cfg, 10_000, cuda_device)
    knobs = sm.make_knobs(cfg, "cem_mppi")
    tick = _tick(cfg)._replace(state12=np.full(12, np.nan, np.float32))
    inc, noise, sigma = _inputs(plan.num_parameters, 10_000, 8, cuda_device, cem=True)
    res = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 0, 0, noise_in=noise)
    _check(plan, knobs, tick, inc, noise, res, cuda_device)
    assert bool((res[0] == 1.0e6).all())
    assert res[3].tolist() == list(range(knobs.n_elite))


@pytest.mark.parametrize("method", ["mppi", "cem_mppi"])
@pytest.mark.parametrize("par", PARS)
def test_k1e_update_with_groups_off_the_block(cuda_device, par, method):
    """Three groups of 33 samples (N = 100, sample 99 not evaluated): the update
    pass runs over 99 samples in two blocks, the second ragged."""
    from quadruped_pympc_tamols_torch.controllers.sampling import group_operators
    cfg = make_config("aliengo", **BASE, **{"mpc.sampling.parametrization": par,
                                            "mpc.optimize_step_freq": True,
                                            "mpc.step_freq_available": (2.4, 1.3, 2.0)})
    plan = sg.make_group_plan(cfg, 100, cuda_device)
    assert (plan.group_size, plan.num_used) == (33, 99)
    knobs = sm.make_knobs(cfg, method)
    tick = _tick(cfg)
    groups = group_operators(cfg, np.array([0.3, 0.8, 0.8, 0.3], np.float32),
                             np.asarray(cfg.mpc.step_freq_available, np.float32))
    inc, noise, sigma = _inputs(plan.base.num_parameters, plan.num_used, 21, cuda_device,
                                knobs.cem)
    res = sg.sampling_groups(plan, knobs, tick, groups, inc, sigma, 0, 0, noise_in=noise)
    _check(plan.base, knobs, tick, inc, noise, res, cuda_device)


@pytest.mark.parametrize("par", PARS)
def test_rerun_repeats_the_bits(cuda_device, par):
    """Philox noise, no float atomics: the same inputs give the same bits."""
    cfg = make_config("aliengo", **BASE, **{"mpc.sampling.parametrization": par})
    plan = sk.make_rs_plan(cfg, 10_000, cuda_device)
    tick = _tick(cfg)
    inc, _, sigma = _inputs(plan.num_parameters, 1, 4, cuda_device)
    for method in ("mppi", "cem_mppi"):
        knobs = sm.make_knobs(cfg, method)
        r1 = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 11, 2)
        r2 = sm.softmax_iteration(plan, knobs, tick, inc, sigma, 11, 2)
        torch.cuda.synchronize()
        for a, b in zip(r1, r2):
            assert a is None or torch.equal(a, b)


def test_reused_workspace_gives_the_fresh_result(cuda_device):
    """Two iterations into one workspace, then the second one into a fresh one:
    the reused workspace ends with the fresh one's bits, so the memset reset the
    ticket and the last block of the second launch finished it."""
    cfg = make_config("aliengo", **BASE)
    plan = sk.make_rs_plan(cfg, 10_000, cuda_device)
    tick = _tick(cfg)
    inc, _, sigma = _inputs(plan.num_parameters, 1, 6, cuda_device)
    lib = sm.load_library(plan.horizon, plan.params_per_leg)
    for method in ("mppi", "cem_mppi"):
        knobs = sm.make_knobs(cfg, method)
        kn = knobs.struct()
        reused, fresh = sm.workspace(plan, knobs, cuda_device), sm.workspace(plan, knobs,
                                                                             cuda_device)
        for offset in (1, 2):
            sm.launch(lib, sk.kernel_args(plan, tick, 13, offset), kn, plan, reused, inc, sigma)
        sm.launch(lib, sk.kernel_args(plan, tick, 13, 2), kn, plan, fresh, inc, sigma)
        torch.cuda.synchronize()
        for name in ("costs", "out", "sigma", "elites"):
            a, b = getattr(reused, name), getattr(fresh, name)
            assert a is None or torch.equal(a, b), name
