"""Kernel K1f (``ops/csrc/sampling_fleet.cu``: the rollout pass and the extraction
or update pass with a scenario axis) against its plain version
``fleet_iteration_reference`` on the card, and the fleet's tick as a CUDA graph.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest --noconftest -q tests/test_torch_cuda_fleet.py``. The cases
cover ragged sample counts (63, 65: the last rollout and update blocks cut short)
and scenario counts (1, 3, 7), every method, S = 1 bit-equal to K1a, K1b and K1c
on the same seed and offset, a rerun on Philox noise bit for bit, launches that
reuse one workspace, the fleet's graph bit-equal to its eager tick, and its
replays counting the K1f launches its capture recorded.
Tolerances as chip_smoke.py's: costs rtol 1e-5 with a 1e-2 floor (the rollout's
float32 ops in another fusion than torch's); the optimizer step against the plain
step on the kernel's own costs: the argmin index, beta and the elites exactly,
parameters and sigma atol 1e-5, GRFs atol 1e-3 N, states atol 1e-5."""
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm
from quadruped_pympc_tamols_torch.parallel import (ScenarioState, init_scenario_state,
                                                   make_scenario_step, make_terrain_generator)

pytestmark = pytest.mark.cuda

METHODS = ["random_sampling", "mppi", "cem_mppi"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1f has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def fleet_inputs(cfg, S, N, dev, seed=0):
    """A plan, a tick of S distinct scenarios, incumbents, sigmas and noise."""
    rng = np.random.default_rng(seed)
    plan = sk.make_rs_plan(cfg, N, dev)
    H, P = plan.horizon, plan.num_parameters
    st = np.zeros((S, 12), np.float32)
    st[:, 2] = cfg.sim.ref_z - 0.03 + 0.01 * rng.standard_normal(S)
    st[:, 3] = 0.2 * rng.standard_normal(S)
    feet = np.array([[0.27, 0.2, 0], [0.27, -0.2, 0], [-0.27, 0.2, 0], [-0.27, -0.2, 0]])
    feet = feet + 0.01 * rng.standard_normal((S, 4, 3))
    ref = np.zeros((S, 12), np.float32)
    ref[:, 2], ref[:, 3] = cfg.sim.ref_z, 0.3
    ph = rng.random((S, 1)) + np.array([0.0, 0.5, 0.5, 0.0])
    contact = (np.mod(ph[:, :, None] + 1.4 * 0.02 * np.arange(H), 1.0) < 0.6)
    n = contact.sum(1)
    share = np.broadcast_to((cfg.robot.mass * 9.81 / np.maximum(n, 1))[:, :, None], (S, H, 4))

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    tick = fl.FleetTick(t(st), t(feet), t(ref), t(contact), t(share))
    inc = t(0.5 * rng.standard_normal((S, P)))
    sigma = t(0.5 + rng.random((S, P)))
    noise = t(rng.standard_normal((S, P, N)))
    noise[:, :, 0] = 0.0
    seeds = torch.arange(S, dtype=torch.int64, device=dev) + 11
    offsets = torch.arange(S, dtype=torch.int64, device=dev) * 3
    return plan, tick, inc, sigma, noise, seeds, offsets


def check_against_plain(plan, knobs, tick, inc, sigma, res):
    """K1f's (costs, out, sigma', elites) on ``noise`` against the plain version:
    the costs against the plain rollout, the step against the plain step on the
    kernel's own costs (so that costs a rounding apart cannot swap the argmin)."""
    costs, out, sig, elites, noise = res
    plain = fl.fleet_iteration_reference(plan, knobs, tick, inc, sigma, noise)
    torch.testing.assert_close(costs, plain.costs, rtol=1e-5, atol=1e-2)
    ref = fl.fleet_iteration_reference(plan, knobs, tick, inc, sigma, noise, costs=costs)
    assert torch.equal(out[:, 25], ref.out[:, 25]) and torch.equal(out[:, 0], ref.out[:, 0])
    torch.testing.assert_close(out[:, 1:13], ref.out[:, 1:13], rtol=0.0, atol=1e-3)
    torch.testing.assert_close(out[:, 13:25], ref.out[:, 13:25], rtol=0.0, atol=1e-5)
    torch.testing.assert_close(out[:, 26:], ref.out[:, 26:], rtol=0.0, atol=1e-5)
    if knobs.cem:
        assert torch.equal(elites.long(), ref.elites)
        torch.testing.assert_close(sig, ref.sigma, rtol=0.0, atol=1e-5)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("S,N", [(1, 63), (3, 65), (7, 128)])
def test_k1f_matches_its_plain_version(cuda_device, method, S, N):
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})
    knobs = sm.make_knobs(cfg)
    plan, tick, inc, sigma, noise, seeds, offsets = fleet_inputs(cfg, S, N, cuda_device)
    costs, out, sig, elites = fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets, 0,
                                                 noise)
    torch.cuda.synchronize()
    check_against_plain(plan, knobs, tick, inc, sigma, (costs, out, sig, elites, noise))


@pytest.mark.parametrize("method", METHODS)
def test_k1f_at_one_scenario_is_the_single_kernel(cuda_device, method):
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})
    knobs = sm.make_knobs(cfg)
    plan, tick, inc, sigma, _, _, _ = fleet_inputs(cfg, 1, 10000, cuda_device, seed=1)
    seed, offset = 1234, 77
    costs, out, sig, _ = fl.fleet_iteration(
        plan, knobs, tick, inc, sigma, torch.tensor([seed], device=cuda_device),
        torch.tensor([offset], device=cuda_device), 0)
    one = sk.TickInputs(*(x[0].cpu().numpy() for x in tick))
    if method == "random_sampling":
        costs1, out1 = sk.sampling_rs(plan, one, inc[0].contiguous(), seed, offset)
    else:
        costs1, out1, sig1, _ = sm.softmax_iteration(plan, knobs, one, inc[0].contiguous(),
                                                     sigma[0].contiguous(), seed, offset)
        if knobs.cem:
            assert torch.equal(sig[0], sig1)
    torch.cuda.synchronize()
    assert torch.equal(costs[0], costs1) and torch.equal(out[0], out1)


@pytest.mark.parametrize("method", METHODS)
def test_k1f_reruns_bit_for_bit_and_reuses_a_workspace(cuda_device, method):
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})
    knobs = sm.make_knobs(cfg)
    plan, tick, inc, sigma, _, seeds, offsets = fleet_inputs(cfg, 5, 1000, cuda_device, seed=2)
    ws = fl.fleet_workspace(plan, knobs, 5, cuda_device)
    first = [x.clone() for x in fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets,
                                                   0, ws=ws) if x is not None]
    again = fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets, 0, ws=ws)
    assert all(torch.equal(a, b) for a, b in zip(first, [x for x in again if x is not None]))
    # Each scenario's Philox stream is its own: the noise the pass drew is held
    # against the plain version through the workspace's copy of it (MPPI, CEM).
    if ws.noise is not None:
        assert torch.all(ws.noise[:, :, 0] == 0.0)
        assert not torch.equal(ws.noise[0], ws.noise[1])
        check_against_plain(plan, knobs, tick, inc, sigma, (*again, ws.noise))


def test_fleet_graph_is_its_eager_tick(cuda_device):
    cfg = make_config("aliengo", mpc_type="sampling")
    step, P = make_scenario_step(cfg, 128, terrain="perlin", reflexes=True)
    st = init_scenario_state(cfg, P, 8, torch.Generator().manual_seed(0),
                             make_terrain_generator("perlin"))
    cmd = torch.tensor([0.25, 0.0, 0.0], device=cuda_device)
    for _ in range(3):
        copy = ScenarioState.from_tensors([x.clone() for x in st.tensors()])
        m = step(st, cmd)
        m_eager = step.tick(*copy.tensors(), cmd)
        assert torch.equal(m, m_eager)
        assert all(torch.equal(a, b) for a, b in zip(st.tensors(), copy.tensors()))
    assert step.graph.captures == 1 and step.graph.replays == 3
    assert torch.equal(st.mpc.offset, torch.full((8,), 3, device=cuda_device))


def test_fleet_graph_counts_the_launches_it_captured(cuda_device):
    """Each replay adds the K1f launches its capture recorded: the warm-up's eager
    launches once, then two iterations a tick, and no other method's count."""
    from quadruped_pympc_tamols_torch import replace_config
    from quadruped_pympc_tamols_torch.utils.graphs import WARMUP

    cfg = replace_config(make_config("aliengo", mpc_type="sampling"),
                         **{"mpc.sampling.method": "mppi", "mpc.sampling.num_iterations": 2})
    step, P = make_scenario_step(cfg, 64)
    st = init_scenario_state(cfg, P, 4, torch.Generator().manual_seed(0))
    cmd = torch.tensor([0.25, 0.0, 0.0], device=cuda_device)
    fl.fleet_iteration.launches.update(dict.fromkeys(METHODS, 0))
    for _ in range(5):
        step(st, cmd)
    torch.cuda.synchronize()
    assert step.graph.captures == 1 and step.graph.replays == 5
    assert fl.fleet_iteration.launches == {"random_sampling": 0, "mppi": 2 * (WARMUP + 5),
                                           "cem_mppi": 0}
