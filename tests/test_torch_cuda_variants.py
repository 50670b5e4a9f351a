"""The gradient variant core and the DDP solver on the card: each solve a replay
of a captured CUDA graph, bit-equal to the eager function on the card and to a
rerun, the assembled QPs held against the CPU port, a NaN factor reaching the
fallback, and a capture that fails raising.

Runs only where CUDA is present (it skips elsewhere): on the H100, run
``python -m pytest --noconftest tests/test_torch_cuda_variants.py -m cuda``. It
imports only the port."""
import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch import make_config, replace_config
from quadruped_pympc_tamols_torch.controllers.gradient import (BatchedGradientMPC, GradientMPC,
                                                               VariantGradientMPC, variants)
from quadruped_pympc_tamols_torch.dynamics.srbd import make_params
from quadruped_pympc_tamols_torch.gait.periodic import contact_sequence, make_timer_dts
from quadruped_pympc_tamols_torch.kinematics.leg_ik import LegKinematics
from quadruped_pympc_tamols_torch.utils.frames import euler_xyz_to_rot_np
from quadruped_pympc_tamols_torch.utils.graphs import GraphedFunction
from quadruped_pympc_tamols_torch.utils.verification import golden_nominal_scenarios

pytestmark = pytest.mark.cuda
QP_RTOL = 1e-4  # the assembled QP against the CPU port, of the largest entry
LEGS = ("FL", "FR", "RL", "RR")
# Every variant configuration: (mpc_type, gait, overrides, variant).
CONFIGS = {
    "input_rates": ("input_rates", "trot", {}, "input_rates"),
    "lyapunov": ("lyapunov", "trot", {}, "lyapunov"),
    "collaborative": ("collaborative", "trot", {}, "collaborative"),
    "kinodynamic": ("kinodynamic", "trot", {}, "kinodynamic"),
    "zmp": ("nominal", "trot", {"mpc.gradient.use_zmp_stability": True}, "nominal"),
    "foothold": ("nominal", "trot", {"mpc.gradient.use_foothold_optimization": True,
                                     "mpc.gradient.use_foothold_constraints": True}, "nominal"),
    "static_crawl": ("nominal", "crawl", {"mpc.gradient.use_static_stability": True},
                     "nominal"),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the solves run as captured CUDA graphs)")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _cfg(key):
    mpc_type, gait, over, variant = CONFIGS[key]
    return make_config("aliengo", mpc_type=mpc_type, gait=gait, **over), variant


def _tick(cfg):
    """The golden trot tick (the crawl's: the three-stance one, where its rows are
    active), the state with joint angles from the IK of its feet."""
    name = "three_stance_nominal" if cfg.sim.gait == "crawl" else "trot_nominal"
    state, ref, seq = golden_nominal_scenarios(cfg)[name]
    state = dict(state)
    kin = LegKinematics(cfg.robot)
    feet = np.stack([state[f"foot_{leg}"] for leg in LEGS])
    q0 = kin.ik_world(feet, state["position"], euler_xyz_to_rot_np(state["orientation"]))
    for i, leg in enumerate(LEGS):
        state[f"joint_{leg}"] = q0[i]
    return state, ref, seq


def _recorded(mpc):
    fn, records = mpc.solve, []

    def solve(*a):
        out = fn(*a)
        records.append([np.array(x, np.float32) for x in a])
        return out

    mpc.solve = solve
    return records


@pytest.mark.parametrize("key", list(CONFIGS))
def test_variant_graph_equals_eager_and_reruns(card, key):
    """Two ticks through the graphed controller and through one whose solve runs
    eagerly on the card: the same results bit for bit, a rerun of the first
    tick's inputs bit-equal, one capture, and the card's assembled QP within
    QP_RTOL of the CPU port's on the same inputs."""
    cfg, variant = _cfg(key)
    graphed = VariantGradientMPC(cfg, variant)
    plain = VariantGradientMPC(cfg, variant)
    plain._solve_dev = plain._solve_dev.fn
    rec = _recorded(graphed)
    state, ref, seq = _tick(cfg)
    for _ in range(2):
        a = graphed.compute_control(state, ref, seq)
        b = plain.compute_control(state, ref, seq)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    again = graphed.solve(*rec[0])
    first = plain.solve(*rec[0])
    for x, y in zip(again, first):
        np.testing.assert_array_equal(x, y)
    assert graphed._solve_dev.captures == 1 and graphed._solve_dev.replays == 3
    spec_cpu = variants.make_spec(cfg, variant, make_params(cfg))
    _, _, asm_cpu, _ = variants.make_variant_solver(cfg, spec_cpu, return_assembler=True,
                                                    device="cpu")
    _, _, asm_card, _ = variants.make_variant_solver(cfg, graphed.spec, return_assembler=True,
                                                     device=card)
    q_cpu = asm_cpu(*(torch.from_numpy(x) for x in rec[0]))
    q_card = asm_card(*(torch.from_numpy(x).to(card) for x in rec[0]))
    for part, x, y in zip(("Hm", "g", "Cb", "d"), q_card, q_cpu):
        err = (x.cpu() - y).abs().max() / y.abs().max().clamp_min(1e-12)
        assert err <= QP_RTOL, (key, part, float(err))


def test_nan_factor_reaches_the_fallback_on_the_card(card):
    """A Newton matrix that is not positive definite (a negative
    Levenberg-Marquardt term) inside the variant graph: the previous GRFs, status
    1, the warm start zeroed; and a NaN state the same."""
    cfg, variant = _cfg("lyapunov")
    state, ref, seq = _tick(cfg)
    good = VariantGradientMPC(cfg, variant)
    g0 = good.compute_control(state, ref, seq)[0]
    bad = VariantGradientMPC(replace_config(cfg, **{"mpc.gradient.levenberg_marquardt": -1e4}),
                             variant)
    bad.previous_grfs = g0.copy()
    grfs, _, _, status, _ = bad.compute_control(state, ref, seq)
    assert status == 1 and not np.any(bad.U_warm)
    np.testing.assert_array_equal(grfs, g0)
    nan = dict(state, position=np.array([np.nan, 0.0, 0.32]))
    grfs, _, _, status, _ = good.compute_control(nan, ref, seq)
    assert status == 1
    np.testing.assert_array_equal(grfs, g0)


@pytest.mark.parametrize("backward", ["sequential", "associative"])
def test_ddp_graph_equals_eager_and_reruns(card, backward):
    """GradientMPC with use_DDP on the golden nominal ticks: the graph replay
    bit-equal to the eager solve on the card and to a rerun; no preparation
    graph; the K = 3 batched DDP solve as one captured graph."""
    cfg = make_config("aliengo", mpc_type="nominal", **{
        "mpc.gradient.use_DDP": True, "mpc.gradient.riccati_backward": backward})
    graphed, plain = GradientMPC(cfg), GradientMPC(cfg)
    plain._solve_dev = plain._solve_dev.fn
    assert graphed._prepare_dev is None and graphed.compute_rti_prepare() is None
    for name, (state, ref, seq) in golden_nominal_scenarios(cfg).items():
        seq = np.asarray(seq, np.float32)
        x0, feet = graphed._build_inputs(state, ref, seq)
        Xref, Uref = graphed._build_refs(state, ref, seq)
        a = graphed.solve(x0, feet, seq, Xref, Uref, Uref)
        b = plain.solve(x0, feet, seq, Xref, Uref, Uref)
        c = graphed.solve(x0, feet, seq, Xref, Uref, Uref)
        for x, y, z in zip(a, b, c):
            np.testing.assert_array_equal(x, y, err_msg=name)
            np.testing.assert_array_equal(x, z, err_msg=name)
    assert graphed._solve_dev.captures == 1
    gcfg = replace_config(cfg, **{"mpc.optimize_step_freq": True})
    freqs = np.asarray(gcfg.mpc.step_freq_available, np.float32)
    seqs = contact_sequence(np.tile(np.float32([0.1, 0.6, 0.6, 0.1]), (len(freqs), 1)), freqs,
                            0.65, make_timer_dts(gcfg.mpc))
    state, ref, _ = golden_nominal_scenarios(gcfg)["trot_nominal"]
    batched = BatchedGradientMPC(gcfg)
    costs, _ = batched.optimize_gait(state, ref, seqs)
    assert np.all(np.isfinite(costs)) and batched.inner._solve_dev.captures == 1


def test_failed_variant_capture_raises_and_never_runs_eagerly(card):
    """A variant solve with a host read in it cannot be captured: the call raises
    each time, nothing is replayed and nothing runs in its place."""
    cfg, variant = _cfg("zmp")
    mpc = VariantGradientMPC(cfg, variant)
    inner = mpc._solve_dev.fn

    def syncs(flat):
        out = inner(flat)
        return out * float(out.sum().item())

    mpc._solve_dev = GraphedFunction(syncs, card)
    state, ref, seq = _tick(cfg)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            mpc.compute_control(state, ref, seq)
    assert mpc._solve_dev.captures == 0 and mpc._solve_dev.replays == 0
