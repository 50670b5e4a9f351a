"""Kernel K1f (``ops/csrc/sampling_fleet.cu``: the rollout pass and the extraction
or update pass with a scenario axis) against its plain version
``fleet_iteration_reference`` on the card, and the fleet's tick as a CUDA graph.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest --noconftest -q tests/test_torch_cuda_fleet.py``. The cases
cover ragged sample counts (63, 65: the last rollout and update blocks cut short)
and scenario counts (1, 3, 7), every method, S = 1 bit-equal to K1a, K1b and K1c
on the same seed and offset in both layouts, a rerun on Philox noise bit for bit,
launches that reuse one workspace, the fleet's graph bit-equal to its eager tick,
and its replays counting the K1f launches its capture recorded. The two layouts
(``sampling_fleet.FOUR_LANE`` and ``LARGE_BATCH``) are held against the plain
version and against each other bit for bit on each side of the crossover,
64 x 10 000 included; the update pass that draws the noise again (``REGEN``)
against the one that reads it back, bit for bit; the dispatch against
``CROSSOVER``; and the fleet's captured tick above the crossover against any
(S, P, N) allocation.
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


@pytest.mark.parametrize("layout", [fl.FOUR_LANE, fl.LARGE_BATCH])
@pytest.mark.parametrize("method", METHODS)
def test_k1f_at_one_scenario_is_the_single_kernel(cuda_device, method, layout):
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})
    knobs = sm.make_knobs(cfg)
    plan, tick, inc, sigma, _, _, _ = fleet_inputs(cfg, 1, 10000, cuda_device, seed=1)
    seed, offset = 1234, 77
    costs, out, sig, _ = fl.fleet_iteration(
        plan, knobs, tick, inc, sigma, torch.tensor([seed], device=cuda_device),
        torch.tensor([offset], device=cuda_device), 0, layout=layout)
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


def same_outputs(a, b) -> bool:
    """Bit-equality of two fleet_iteration results (None where a method has none)."""
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def run_layout(plan, knobs, tick, inc, sigma, seeds, offsets, layout, noise_in=None,
               keep_noise=False):
    """One iteration in ``layout`` on its own workspace: (costs, out, sigma', elites,
    argmin keys (S,), the kept noise or None), cloned."""
    ws = fl.fleet_workspace(plan, knobs, inc.shape[0], inc.device, layout, keep_noise)
    res = fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets, 0, noise_in, ws=ws,
                             layout=layout)
    torch.cuda.synchronize()
    return tuple(None if x is None else x.clone()
                 for x in (*res, ws.argmin[0::2], ws.noise))


@pytest.mark.parametrize("S,N", [(3, 65), (7, 128), (300, 128), (64, 10000)])
@pytest.mark.parametrize("method", METHODS)
def test_k1f_layouts_match_plain_and_each_other(cuda_device, method, S, N):
    """On injected noise, on each side of the crossover: both layouts against the
    plain version, and their costs, argmin keys and outputs equal bit for bit."""
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})
    knobs = sm.make_knobs(cfg)
    plan, tick, inc, sigma, noise, seeds, offsets = fleet_inputs(cfg, S, N, cuda_device, seed=3)
    four = run_layout(plan, knobs, tick, inc, sigma, seeds, offsets, fl.FOUR_LANE, noise)
    wide = run_layout(plan, knobs, tick, inc, sigma, seeds, offsets, fl.LARGE_BATCH, noise)
    check_against_plain(plan, knobs, tick, inc, sigma, (*four[:4], noise))
    check_against_plain(plan, knobs, tick, inc, sigma, (*wide[:4], noise))
    assert same_outputs(four[:5], wide[:5])


@pytest.mark.parametrize("S,N", [(5, 1000), (64, 10000)])
@pytest.mark.parametrize("method", ["mppi", "cem_mppi"])
def test_k1f_regenerated_update_is_the_read_back_one(cuda_device, method, S, N):
    """On Philox noise: the update pass that draws each sample's noise again equals
    the one that reads back the noise the rollout wrote, bit for bit, after either
    rollout layout, and the two rollouts give the same bits; the noise they drew
    holds against the plain version."""
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})
    knobs = sm.make_knobs(cfg)
    plan, tick, inc, sigma, _, seeds, offsets = fleet_inputs(cfg, S, N, cuda_device, seed=4)
    runs = {layout: run_layout(plan, knobs, tick, inc, sigma, seeds, offsets, layout,
                               keep_noise=True)
            for layout in (fl.FOUR_LANE, fl.REGEN, fl.WIDE, fl.LARGE_BATCH)}
    first = runs[fl.FOUR_LANE]
    for layout, res in runs.items():
        assert same_outputs(first[:5], res[:5]), layout
        assert torch.equal(first[5], res[5]), layout
    check_against_plain(plan, knobs, tick, inc, sigma, (*first[:4], first[5]))


def test_k1f_dispatch_follows_the_crossover(cuda_device):
    """fleet_layout's choice on each side of CROSSOVER, the launch count of the
    rollout that ran, and the workspace's noise buffer only where the update reads
    it back."""
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": "mppi"})
    knobs = sm.make_knobs(cfg)
    above = -(-fl.CROSSOVER // 128)  # the fewest scenarios of 128 samples at the crossover
    assert fl.fleet_layout(above - 1, 128) == fl.FOUR_LANE
    assert fl.fleet_layout(above, 128) == fl.LARGE_BATCH
    assert fl.fleet_layout(1, 10000) == fl.FOUR_LANE
    assert fl.fleet_layout(64, 10000) == fl.LARGE_BATCH
    for S, want in ((above - 1, fl.FOUR_LANE), (above, fl.LARGE_BATCH)):
        plan, tick, inc, sigma, _, seeds, offsets = fleet_inputs(cfg, S, 128, cuda_device)
        ws = fl.fleet_workspace(plan, knobs, S, cuda_device)
        assert (ws.noise is None) == bool(want & fl.REGEN)
        fl.fleet_iteration.launches.update(dict.fromkeys(METHODS, 0))
        fl.fleet_iteration.launches_wide.update(dict.fromkeys(METHODS, 0))
        fl.fleet_iteration(plan, knobs, tick, inc, sigma, seeds, offsets, 0, ws=ws)
        torch.cuda.synchronize()
        wide = fl.fleet_iteration.launches_wide["mppi"]
        assert (wide, fl.fleet_iteration.launches["mppi"]) == ((1, 0) if want & fl.WIDE
                                                               else (0, 1))


def test_fleet_tick_allocates_no_noise_buffer(cuda_device):
    """The fleet's MPPI tick at 64 x 10 000 (above the crossover): its warm-up runs
    and its capture together allocate less than one (S, P, N) noise buffer."""
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": "mppi"})
    S, N = 64, 10000
    assert fl.fleet_layout(S, N) == fl.LARGE_BATCH
    step, P = make_scenario_step(cfg, N)
    st = init_scenario_state(cfg, P, S, torch.Generator().manual_seed(0))
    cmd = torch.tensor([0.25, 0.0, 0.0], device=cuda_device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step(st, cmd)
    step(st, cmd)
    torch.cuda.synchronize()
    assert step.graph.captures == 1 and step.graph.replays == 2
    grown = torch.cuda.max_memory_allocated() - base
    assert grown < 4 * S * P * N, (grown, 4 * S * P * N)
