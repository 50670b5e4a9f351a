"""The sharded tier's kernel knobs, the sharded solver and the control node on the card.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest --noconftest -q tests/test_torch_cuda_parallel.py``. The cases:

* the drawn column 0 (``sampling_kernel.with_drawn_column0``) on K1a, K1b, K1c and
  K1f in both layouts, at N = 1, 63, 65 and 10 001: on Philox noise it changes
  column 0 alone (every other column and its bits stay), random sampling's column
  0 has the spread of its sigma2 band, and the result holds against the plain
  version on the noise the kernel drew; on injected noise the knob changes no bit;
* the caller's beta and the unnormalized sums on K1b and K1c:
  with the iteration's own beta handed back the outputs are the plain launch's bit
  for bit; with a shifted beta the sums hold against ``softmax_sums`` on the
  kernel's own costs and noise, and the new parameters are incumbent + S / Z;
* the sharded solver at world size 1 (NCCL) against the iteration ``SamplingMPC``
  runs (``sampling_chain`` with one iteration) on the same injected noise: best
  cost and parameters bit for bit (random sampling and MPPI; CEM's parameters too,
  its sigma refit on the elite columns within 1e-5), one K1a/K1b/K1c launch a call
  and no K1d;
* ``ControllerNode`` in thread mode on the card for 300 ticks of the recorded
  MuJoCo trace: finite torques and solves completed by the MPC thread.

Tolerances as chip_smoke.py's: costs rtol 1e-5 with a 1e-2 floor, parameters and
sums atol 1e-5 relative to their scale, GRFs atol 1e-3 N."""
import dataclasses

import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.controllers.sampling.rollout import gravity_share
from quadruped_pympc_tamols_torch.ops import sampling_fleet as fl
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
from quadruped_pympc_tamols_torch.ops import sampling_softmax as sm

pytestmark = pytest.mark.cuda

METHODS = ["random_sampling", "mppi", "cem_mppi"]
SIZES = [1, 63, 65, 10001]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def tick_of(cfg, H):
    state12 = np.zeros(12, np.float32)
    state12[2], state12[3] = cfg.sim.ref_z - 0.03, 0.1
    ref12 = np.zeros(12, np.float32)
    ref12[2], ref12[3] = cfg.sim.ref_z, 0.2
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]],
                    np.float32)
    seq = np.ones((4, H), np.float32)
    seq[1, 6:] = seq[2, 6:] = 0.0
    share = gravity_share(torch.from_numpy(seq), cfg.robot.mass)[:, None].expand(H, 4).numpy()
    return sk.TickInputs(state12, feet, ref12, seq, np.ascontiguousarray(share))


def single(plan, knobs, tick, inc, sigma, seed, offset, **kw):
    """K1a or K1b/K1c through its wrapper (their plain version on CPU tensors), the
    noise drawn into a returned buffer unless injected: (costs, out, sigma', elites,
    noise)."""
    noise = kw.pop("noise_in", None)
    out_noise = None if noise is not None else torch.empty(plan.num_parameters,
                                                           plan.num_samples, device=inc.device)
    if knobs.method == "random_sampling":
        costs, out = sk.sampling_rs(plan, tick, inc, seed, offset, noise_in=noise,
                                    noise_out=out_noise)
        res = (costs, out, None, None)
    else:
        res = sm.softmax_iteration(plan, knobs, tick, inc, sigma, seed, offset, noise_in=noise,
                                   noise_out=out_noise, **kw)
    if inc.is_cuda:
        torch.cuda.synchronize()
    return tuple(None if x is None else x.clone() for x in res) + (
        noise if noise is not None else out_noise,)


def same(a, b) -> bool:
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("method", METHODS)
def test_drawn_column0_on_the_single_kernels(cuda_device, method, N):
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})
    knobs = sm.make_knobs(cfg)
    if knobs.cem:  # K1c takes 2 to min(32, N) elites; at N = 1, one sample is no set
        knobs = dataclasses.replace(knobs, n_elite=max(2, min(knobs.n_elite, N)))
        if N < 2:
            knobs = sm.make_knobs(cfg, "mppi")
    plan = sk.make_rs_plan(cfg, N, cuda_device)
    col0 = sk.with_drawn_column0(plan)
    tick = tick_of(cfg, plan.horizon)
    P = plan.num_parameters
    inc = torch.linspace(-0.5, 0.5, P, device=cuda_device)
    sigma = torch.full((P,), 0.8, device=cuda_device)
    base = single(plan, knobs, tick, inc, sigma, 5, 9)
    drawn = single(col0, knobs, tick, inc, sigma, 5, 9)
    assert torch.equal(base[4][:, 1:], drawn[4][:, 1:]) and not base[4][:, 0].any()
    assert drawn[4][:, 0].abs().max() > 0
    if method == "random_sampling" and N >= 3:
        spread = float(drawn[4][:, 0].std())
        assert 0.3 * plan.sigma_random[1] < spread < 3.0 * plan.sigma_random[1]
    # The knob's result against the plain version on the noise the kernel drew.
    cpu_plan = sk.with_drawn_column0(sk.make_rs_plan(cfg, N, "cpu"))
    plain = single(cpu_plan, knobs, tick, inc.cpu(), sigma.cpu(), 5, 9, noise_in=drawn[4].cpu())
    torch.testing.assert_close(drawn[0].cpu(), plain[0], rtol=1e-5, atol=1e-2)
    if int(drawn[1][25]) == int(plain[1][25]):
        torch.testing.assert_close(drawn[1][26:].cpu(), plain[1][26:], rtol=0, atol=1e-4)
    # Injected noise: the knob changes no bit.
    noise = torch.randn(P, N, device=cuda_device)
    assert same(single(plan, knobs, tick, inc, sigma, 5, 9, noise_in=noise),
                single(col0, knobs, tick, inc, sigma, 5, 9, noise_in=noise))


@pytest.mark.parametrize("N", SIZES[1:])
@pytest.mark.parametrize("method", ["mppi", "cem_mppi"])
def test_caller_beta_and_sums_on_the_single_kernels(cuda_device, method, N):
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})
    knobs = sm.make_knobs(cfg)
    plan = sk.make_rs_plan(cfg, N, cuda_device)
    tick = tick_of(cfg, plan.horizon)
    P = plan.num_parameters
    inc = torch.linspace(-0.5, 0.5, P, device=cuda_device)
    sigma = torch.full((P,), 0.8, device=cuda_device)
    base = single(plan, knobs, tick, inc, sigma, 5, 9)
    sums = torch.empty(P + 1, device=cuda_device)
    own = single(plan, knobs, tick, inc, sigma, 5, 9, merge_beta=lambda lo: lo.clone(),
                 sums=sums)
    assert same(base, own)
    torch.testing.assert_close(inc + sums[:P] / sums[P], own[1][26:], rtol=0, atol=0)
    shifted = single(plan, knobs, tick, inc, sigma, 5, 9, merge_beta=lambda lo: lo - 3.0,
                     sums=sums)
    S, Z = sm.softmax_sums(shifted[0], shifted[4], shifted[1][0] - 3.0, knobs.temperature)
    torch.testing.assert_close(sums[P], Z, rtol=1e-5, atol=0)
    torch.testing.assert_close(sums[:P] / Z, S / Z, rtol=0, atol=1e-5)
    torch.testing.assert_close(shifted[1][26:], inc + sums[:P] / sums[P], rtol=0, atol=0)
    if knobs.cem:
        assert torch.equal(shifted[3], base[3]) and torch.equal(shifted[2], base[2])


@pytest.mark.parametrize("layout", [fl.FOUR_LANE, fl.LARGE_BATCH])
@pytest.mark.parametrize("method", METHODS)
def test_k1f_knobs(cuda_device, method, layout):
    """K1f at N = 1, 63, 65 and 10 001 samples (2, 3, 2 and 64 scenarios): on Philox
    noise the drawn column 0 changes column 0 alone and holds against the plain
    version; on injected noise it changes no bit. CEM takes at least two samples."""
    cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})
    for S, N in ((2, 1), (3, 63), (2, 65), (64, 10001)):
        knobs = sm.make_knobs(cfg)
        if knobs.cem:
            if N < 2:
                continue
            knobs = dataclasses.replace(knobs, n_elite=min(knobs.n_elite, N))
        plan = sk.make_rs_plan(cfg, N, cuda_device)
        one = tick_of(cfg, plan.horizon)
        tick = fl.FleetTick(*(torch.as_tensor(np.stack([x] * S), device=cuda_device)
                              for x in one))
        P = plan.num_parameters
        inc = torch.linspace(-0.5, 0.5, P, device=cuda_device).expand(S, P).contiguous()
        sigma = torch.full((S, P), 0.8, device=cuda_device)
        seeds = torch.arange(S, device=cuda_device) + 3
        offsets = torch.zeros(S, dtype=torch.int64, device=cuda_device)

        def run(p, **kw):
            ws = fl.fleet_workspace(p, knobs, S, cuda_device, layout, keep_noise=True)
            res = fl.fleet_iteration(p, knobs, tick, inc, sigma, seeds, offsets, ws=ws,
                                     layout=layout, **kw)
            torch.cuda.synchronize()
            return tuple(None if x is None else x.clone() for x in (*res, ws.noise))

        base = run(plan)
        drawn = run(sk.with_drawn_column0(plan))
        if base[4] is not None:
            assert torch.equal(base[4][:, :, 1:], drawn[4][:, :, 1:])
            assert not base[4][:, :, 0].any() and drawn[4][:, :, 0].abs().max() > 0
            ref = fl.fleet_iteration_reference(plan, knobs, tick, inc, sigma, drawn[4])
            torch.testing.assert_close(drawn[0], ref.costs, rtol=1e-5, atol=1e-2)
            ref = fl.fleet_iteration_reference(plan, knobs, tick, inc, sigma, drawn[4],
                                               costs=drawn[0])
            torch.testing.assert_close(drawn[1][:, 26:], ref.out[:, 26:], rtol=0, atol=1e-5)
        else:
            assert not torch.equal(base[0][:, 0], drawn[0][:, 0])
            assert torch.equal(base[0][:, 1:], drawn[0][:, 1:])
        # Injected noise: the knob changes no bit.
        noise = torch.randn(S, P, N, device=cuda_device)
        assert same(run(plan, noise_in=noise)[:4],
                    run(sk.with_drawn_column0(plan), noise_in=noise)[:4])


def test_sharded_solver_at_world_size_one_is_the_single_iteration(cuda_device):
    import torch.distributed as dist

    from quadruped_pympc_tamols_torch.controllers.sampling import SamplingState
    from quadruped_pympc_tamols_torch.parallel import (find_free_port, init_multihost,
                                                       make_sharded_sampling_solver,
                                                       scenario_mesh)

    init_multihost(f"127.0.0.1:{find_free_port()}", 1, 0, device="cuda")
    try:
        mesh = scenario_mesh(1, 1)
        for method in METHODS:
            cfg = make_config("aliengo", mpc_type="sampling", **{"mpc.sampling.method": method})
            knobs = sm.make_knobs(cfg)
            solve, P = make_sharded_sampling_solver(cfg, mesh, 10000, method)
            plan = solve.plan
            tick = tick_of(cfg, plan.horizon)
            inc = torch.linspace(-0.5, 0.5, P, device=cuda_device)
            sigma = torch.full((P,), 0.8, device=cuda_device)
            noise = torch.randn(P, 10000, device=cuda_device)
            noise[:, 0] = 0.0
            before = (sk.sampling_rs.launches, dict(sm.softmax_iteration.launches),
                      dict(sm.sampling_chain.launches))
            grfs, st, best = solve(tick.state12, tick.feet, tick.ref12, tick.contact_seq,
                                   SamplingState(inc, 5, 9, sigma), noise=noise)
            torch.cuda.synchronize()
            rs_n = sk.sampling_rs.launches - before[0]
            sm_n = {k: sm.softmax_iteration.launches[k] - before[1][k] for k in before[1]}
            assert sm.sampling_chain.launches == before[2]
            assert (rs_n, sm_n) == ((1, {"mppi": 0, "cem_mppi": 0}) if method == "random_sampling"
                                    else (0, {k: int(k == method) for k in sm_n}))
            # SamplingMPC's one iteration (sampling_chain) is this wrapper's launch;
            # the wrapper takes the same injected noise.
            ref_out = single(plan, knobs, tick, inc, sigma, 5, 9, noise_in=noise)
            assert torch.equal(best, ref_out[1][0:1])
            assert torch.equal(st.best_parameters, ref_out[1][26:])
            torch.testing.assert_close(grfs.reshape(12), ref_out[1][1:13], rtol=0, atol=1e-3)
            assert st.offset == 10 and st.seed == 5
            if knobs.cem:
                torch.testing.assert_close(st.sigma, ref_out[2], rtol=0, atol=1e-5)
    finally:
        dist.destroy_process_group()


def test_controller_node_thread_mode_on_the_card(cuda_device):
    import time

    from quadruped_pympc_tamols_torch.runtime import ControllerNode
    from quadruped_pympc_tamols_torch.sim.trace import ControlTrace
    from quadruped_pympc_tamols_torch.utils.legs import Legs

    trace = ControlTrace()
    cfg = make_config("aliengo", mpc_type="sampling",
                      **{"sim.visual_foothold_adaptation": "height"})
    node = ControllerNode(cfg, Legs(trace.inputs(0)["feet_pos"].data.copy()), "thread")
    try:
        for i in range(300):
            kw = trace.inputs(i, device="cuda")
            s = dict(kw, joints_vel=kw["qvel_js"])
            tau, dq, dqd = node.control_tick(lambda: s, kw["ref_base_lin_vel"],
                                             kw["ref_base_ang_vel"], kw["simulation_dt"])
            assert np.all(np.isfinite(np.asarray(tau.data)))
            time.sleep(0.001)
        assert node.solves > 10
    finally:
        node.shutdown()
