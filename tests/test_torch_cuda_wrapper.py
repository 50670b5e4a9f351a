"""The torque path and the wrapper on the card: the recorded MuJoCo trace
(``tests/fixtures/torch_mujoco_trace.npz``) replayed through
``QuadrupedPyMPCWrapper(..., device="cuda").compute_actions`` with the card's own
solve (kernel K1a), and through ``WBInterface`` with the recorded solve.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest --noconftest tests/test_torch_cuda_wrapper.py -m cuda``. It
needs no MuJoCo. A replay is open loop: the observations are the JAX package's
recorded ones, whatever the card's solve returns."""
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch.interfaces import QuadrupedPyMPCWrapper, WBInterface
from quadruped_pympc_tamols_torch.interop import config_from_dict
from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk
from quadruped_pympc_tamols_torch.sim.trace import ControlTrace
from quadruped_pympc_tamols_torch.utils.legs import Legs

pytestmark = pytest.mark.cuda

TRACE_ATOL = 1e-6  # tau (N m), des_q (rad), des_qd (rad/s) against the JAX package
STANCE_ATOL = 1e-9


@pytest.fixture(scope="module")
def trace():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel K1a has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return ControlTrace()


def _never():
    raise AssertionError("the sampling path evaluated the inertia callable")


def _replay(trace, num_samples, seed=0, steps=None):
    """Replay through the wrapper on the card; checks every step and returns the
    torques (T, 4, 3), the GRFs (T, 4, 3) and K1a's launches."""
    cfg = config_from_dict({**trace.config, "mpc": {**trace.config["mpc"], "sampling": {
        **trace.config["mpc"]["sampling"], "num_samples": num_samples}}})
    w = QuadrupedPyMPCWrapper(cfg, Legs(trace.arrays["feet_pos"][0].copy()), seed=seed,
                              device="cuda")
    steps = trace.steps if steps is None else steps
    taus, grfs = np.zeros((steps, 4, 3)), np.zeros((steps, 4, 3))
    sk.sampling_rs.launches = 0
    for i in range(steps):
        kw = trace.inputs(i)
        tau = np.asarray(w.compute_actions(**kw, inertia=_never).data)
        assert np.all(np.isfinite(tau)), f"step {i}"
        stance = w.wb_interface.current_contact == 1
        jac, f = kw["feet_jac"].data, np.asarray(w.nmpc_GRFs.data)
        want = -np.einsum("lji,lj->li", jac, f) - kw["legs_qfrc_passive"].data
        np.testing.assert_allclose(tau[stance], want[stance], rtol=0, atol=STANCE_ATOL)
        if i % w._mpc_every == 0:
            assert np.all(f[~stance] == 0.0), f"step {i}: swing-leg GRFs {f[~stance]}"
        taus[i], grfs[i] = tau, f
    torch.cuda.synchronize()
    return taus, grfs, sk.sampling_rs.launches


def test_torque_path_on_recorded_solve_matches_jax(trace):
    """WBInterface with its planner on the card, fed the recorded GRFs and
    footholds: the JAX package's tau, des_q and des_qd to 1e-6 on every step."""
    cfg = config_from_dict(trace.config)
    wb = WBInterface(cfg, Legs(trace.arrays["feet_pos"][0].copy()), device="cuda")
    for i in range(trace.steps):
        wb.update_state_and_reference(**trace.update_args(i, device="cuda"))
        out = wb.compute_stance_and_swing_torque(**trace.torque_args(i))
        for name, x in zip(("tau", "des_q", "des_qd"), out):
            np.testing.assert_allclose(x.data, trace.arrays[name][i], rtol=0, atol=TRACE_ATOL,
                                       err_msg=f"{name} at step {i}")


@pytest.mark.parametrize("num_samples", [10_001, 63])
def test_wrapper_replay_on_the_card(trace, num_samples):
    """The card's own solve at N = 10 001 and 63 (ragged tiles): finite torques,
    stance tau = -J^T f minus the passive forces, swing-leg GRFs exactly zero on
    MPC ticks, K1a once an MPC tick (100 over 500 steps), and every solved GRF
    within the friction cone of the configuration."""
    taus, grfs, launches = _replay(trace, num_samples)
    assert launches == trace.steps // 5 == 100
    mu = config_from_dict(trace.config).mpc.mu
    fz = grfs[..., 2]
    assert np.all(fz >= -1e-6)
    assert np.all(np.abs(grfs[..., :2]) <= mu * fz[..., None] + 1e-3)


def test_wrapper_replay_repeats_its_bits(trace):
    """Two replays from the same seed give the same torques bit for bit."""
    a, _, _ = _replay(trace, 10_000, seed=3, steps=150)
    b, _, _ = _replay(trace, 10_000, seed=3, steps=150)
    np.testing.assert_array_equal(a, b)
