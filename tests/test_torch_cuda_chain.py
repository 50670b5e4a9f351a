"""Kernel K1d (ops/csrc/sampling_chain.cu): every chained iteration of a tick in one
cooperative launch, against successive single iterations on the card.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest --noconftest tests/test_torch_cuda_chain.py -m cuda``. The
contract is bits, not tolerances: iteration i of the one launch equals one K1a,
K1b or K1c iteration launched from iteration i - 1's outputs of the launch (costs,
packed output, CEM's sigma and elites), for each method and parametrization, at
sample counts that leave ragged rollout tiles (16 samples) and update tiles (64),
at CEM elite counts 2, 10 and 32, on grids of 1 and 7 blocks as well as the
co-resident grid, on a NaN state where every cost ties at 1e6, and on a rerun.
The single iterations themselves are held against the plain version in
test_torch_cuda_kernel.py, test_torch_cuda_rollout.py and
test_torch_cuda_optimizer.py."""
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

pytestmark = pytest.mark.cuda

PARS = ["cubic_spline", "linear_spline", "zero_order"]
METHODS = ["random_sampling", "mppi", "cem_mppi"]
ITERATIONS = 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the chain kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(par="cubic_spline", **over):
    return make_config("aliengo", **{"sim.visual_foothold_adaptation": "blind",
                                     "mpc.sampling.parametrization": par, **over})


def _tick(cfg, nan_state=False):
    H = cfg.mpc.horizon
    state12 = np.zeros(12, np.float32)
    state12[2], state12[3] = cfg.sim.ref_z - 0.03, 0.1
    if nan_state:
        state12[:] = np.nan
    ref12 = np.zeros(12, np.float32)
    ref12[2], ref12[3] = cfg.sim.ref_z, 0.2
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                    np.float32)
    seq = np.ones((4, H), np.float32)
    seq[1, 6:] = seq[2, 6:] = 0.0
    share = gravity_share(torch.from_numpy(seq), cfg.robot.mass)[:, None].expand(H, 4)
    return sk.TickInputs(state12, feet, ref12, seq, np.ascontiguousarray(share.numpy()))


def _setup(dev, par, method, num_samples, **over):
    cfg = _cfg(par, **over)
    plan = sk.make_rs_plan(cfg, num_samples, dev)
    knobs = sm.make_knobs(cfg, method)
    rng = np.random.default_rng(num_samples)
    P = plan.num_parameters
    inc = torch.as_tensor(rng.standard_normal(P).astype(np.float32), device=dev)
    sigma = torch.as_tensor(rng.uniform(0.3, 4.0, P).astype(np.float32), device=dev)
    return cfg, plan, knobs, inc, sigma


def _same_bits(a, b) -> bool:
    """Both None, or the same shape and bits (NaNs included)."""
    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _assert_single_iterations(plan, knobs, tick, inc, sigma, seed, offset, res):
    """Iteration i of ``res`` bit-equal to one single iteration from iteration
    i - 1's outputs of the chain (the caller's incumbent and sigma at i = 0)."""
    assert len(res) == ITERATIONS
    for i, r in enumerate(res):
        if knobs.method == "random_sampling":
            one = sk.sampling_rs(plan, tick, inc, seed, offset + i) + (sigma, None)
        else:
            one = sm.softmax_iteration(plan, knobs, tick, inc, sigma, seed, offset + i)
        torch.cuda.synchronize()
        for name, a, b in zip(("costs", "out", "sigma", "elites"), one, r):
            assert _same_bits(a, b), f"iteration {i}: {name}"
        inc, sigma = r.out[sk.OUT_WINNER:], r.sigma


@pytest.mark.parametrize("num_samples", [1, 63, 65, 10_001])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("par", PARS)
def test_chain_is_bit_equal_to_single_iterations(cuda_device, par, method, num_samples):
    """One launch, counted once in sampling_chain.launches and not at all in the
    single iterations' counts. CEM needs 2 elites, so at N = 1 both refuse."""
    cfg, plan, knobs, inc, sigma = _setup(cuda_device, par, method, num_samples)
    tick = _tick(cfg)
    if knobs.cem and num_samples < 2:
        with pytest.raises(NotImplementedError):
            sm.sampling_chain(plan, knobs, tick, inc, sigma, 11, 5, ITERATIONS)
        return
    before = (sk.sampling_rs.launches, dict(sm.softmax_iteration.launches))
    want = dict(sm.sampling_chain.launches)
    want[method] += 1
    res = sm.sampling_chain(plan, knobs, tick, inc, sigma, 11, 5, ITERATIONS)
    assert sm.sampling_chain.launches == want
    assert (sk.sampling_rs.launches, sm.softmax_iteration.launches) == before
    _assert_single_iterations(plan, knobs, tick, inc, sigma, 11, 5, res)
    if num_samples > 1:
        assert not torch.equal(res[0].out, res[-1].out)


@pytest.mark.parametrize("n_elite", [2, 10, 32])
@pytest.mark.parametrize("par", PARS)
def test_cem_chain_at_elite_counts(cuda_device, par, n_elite):
    cfg, plan, knobs, inc, sigma = _setup(cuda_device, par, "cem_mppi", 1000,
                                          **{"mpc.sampling.cem_elite": n_elite})
    tick = _tick(cfg)
    res = sm.sampling_chain(plan, knobs, tick, inc, sigma, 3, 0, ITERATIONS)
    assert all(r.elites.numel() == n_elite for r in res)
    _assert_single_iterations(plan, knobs, tick, inc, sigma, 3, 0, res)


@pytest.mark.parametrize("max_blocks", [1, 7, 0])
@pytest.mark.parametrize("method", METHODS)
def test_grid_size_does_not_change_the_bits(cuda_device, method, max_blocks):
    """The C entry on 1 block, 7 blocks and the co-resident grid (0): the same
    bits as single iterations, whichever block runs a tile."""
    cfg, plan, knobs, inc, sigma = _setup(cuda_device, "cubic_spline", method, 10_001)
    tick = _tick(cfg)
    lib = sm.load_chain_library(plan.horizon, plan.params_per_leg)
    ws = sm.workspace(plan, knobs, cuda_device, ITERATIONS)
    sm.chain_launch(lib, sk.kernel_args(plan, tick, 11, 5), knobs.struct(), method, plan,
                    ITERATIONS, ws, inc, sigma, max_blocks=max_blocks)
    res = [sm.IterationResult(ws.costs[i], ws.out[i], ws.sigma[i] if knobs.cem else sigma,
                              ws.elites[i] if knobs.cem else None) for i in range(ITERATIONS)]
    _assert_single_iterations(plan, knobs, tick, inc, sigma, 11, 5, res)


@pytest.mark.parametrize("method", METHODS)
def test_nan_state_ties_and_a_rerun(cuda_device, method):
    """A NaN state: every cost saturates to 1e6, so every iteration's argmin is
    sample 0 (jnp.argmin) and CEM's elites are samples 0..K-1 (jax.lax.top_k);
    the chain still equals the single iterations. A rerun of either state repeats
    every bit."""
    cfg, plan, knobs, inc, sigma = _setup(cuda_device, "cubic_spline", method, 10_000)
    for nan_state in (True, False):
        tick = _tick(cfg, nan_state)
        res = sm.sampling_chain(plan, knobs, tick, inc, sigma, 7, 2, ITERATIONS)
        again = sm.sampling_chain(plan, knobs, tick, inc, sigma, 7, 2, ITERATIONS)
        torch.cuda.synchronize()
        for r, s in zip(res, again):
            assert all(_same_bits(a, b) for a, b in zip(r, s))
        if nan_state:
            for r in res:
                assert bool((r.costs == 1.0e6).all()) and int(r.out[25]) == 0
                if knobs.cem:
                    assert r.elites.tolist() == list(range(knobs.n_elite))
        _assert_single_iterations(plan, knobs, tick, inc, sigma, 7, 2, res)


def test_chain_refuses_a_grid_that_is_not_resident(cuda_device):
    """More blocks than the card holds at once: the cooperative launch is refused
    and the wrapper raises; it never falls back to successive launches."""
    cfg, plan, knobs, inc, sigma = _setup(cuda_device, "cubic_spline", "mppi", 1000)
    tick = _tick(cfg)
    lib = sm.load_chain_library(plan.horizon, plan.params_per_leg)
    resident = (sm.chain_blocks_per_sm(plan, knobs)
                * torch.cuda.get_device_properties(cuda_device).multi_processor_count)
    ws = sm.workspace(plan, knobs, cuda_device, ITERATIONS)
    before = dict(sm.softmax_iteration.launches)
    with pytest.raises(RuntimeError, match="sampling_chain launch failed"):
        sm.chain_launch(lib, sk.kernel_args(plan, tick, 1, 0), knobs.struct(), "mppi", plan,
                        ITERATIONS, ws, inc, sigma, max_blocks=resident + 1)
    assert sm.softmax_iteration.launches == before
