"""The port's gradient variant core against the JAX package on the CPU: every
spec's dynamics and stage inequalities with their forward-mode Jacobians, the
condensed QPs the variant solver assembles, the controller against the golden
traces, and the soft-constrained QP ladder against float64. Inputs are seeded
numpy arrays or the golden scenarios of tests/test_golden_traces.py; the JAX
side runs on the CPU as its own tests do.

Tolerances: spec values and Jacobians 1e-5 of the largest entry (float32
rounding in two libraries); assembled QPs 1e-4 (float32 matmuls summed in other
orders, tests/test_torch_gradient.py's QP_RTOL); golden traces at the golden
test's rtol 1e-3, atol 1e-3 x scale, or, where the float32 interior point is
chaotic, the first-stage GRFs within max(2 x the JAX package's gap, 0.01 N) of
float64 (``F64_FLOOR``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.controllers.gradient import variants as jv
from quadruped_pympc_tamols_tpu.controllers.gradient.qp import pdip_solve_mehrotra as jax_meh
from quadruped_pympc_tamols_tpu.dynamics.srbd import make_params as jax_params
from quadruped_pympc_tamols_tpu.kinematics import LegKinematics as JaxKin
from quadruped_pympc_tamols_tpu.utils.frames import euler_xyz_to_rot as jax_rot
from quadruped_pympc_tamols_tpu.utils.verification import soft_qp_ladder_report as jax_ladder
from quadruped_pympc_tamols_torch.controllers.gradient import variants as tv
from quadruped_pympc_tamols_torch.controllers.gradient.qp import pdip_solve_mehrotra
from quadruped_pympc_tamols_torch.dynamics.srbd import make_params
from quadruped_pympc_tamols_torch.interop import config_from_dict
from quadruped_pympc_tamols_torch.utils.verification import (pdip_solve_np_f64,
                                                             soft_qp_ladder_report)
from jax_references import check_inputs, digest
from jax_references import load as load_jax
from test_golden_traces import FIXTURE, _scenarios

torch.set_num_threads(1)
# One BLAS thread for the float64 references: the suite runs files side by side.
threadpool_limits(1)
SPEC_RTOL = 1e-5  # of the largest entry
QP_RTOL = 1e-4
GOLDEN_RTOL = 1e-3  # tests/test_golden_traces.py
F64_FLOOR = 0.01  # N
LEGS = ("FL", "FR", "RL", "RR")
BLIND = {"sim.visual_foothold_adaptation": "blind"}
CRAWL = {"gait": "crawl"}

# Spec groups: (label, mpc_type, config overrides, variant).
SPECS = {
    "nominal_bands": [
        ("trot static", "nominal", {"mpc.gradient.use_static_stability": True}, "nominal"),
        ("trot zmp", "nominal", {"mpc.gradient.use_zmp_stability": True}, "nominal"),
        ("crawl zmp", "nominal", {**CRAWL, "mpc.gradient.use_zmp_stability": True}, "nominal"),
        ("crawl static", "nominal", {**CRAWL, "mpc.gradient.use_static_stability": True},
         "nominal"),
    ],
    "foothold": [
        ("no boxes", "nominal", {"mpc.gradient.use_foothold_optimization": True}, "nominal"),
        ("boxes zmp", "nominal", {"mpc.gradient.use_foothold_optimization": True,
                                  "mpc.gradient.use_foothold_constraints": True,
                                  "mpc.gradient.use_zmp_stability": True}, "nominal"),
        ("crawl boxes static", "nominal", {**CRAWL, "mpc.gradient.use_foothold_optimization": True,
                                           "mpc.gradient.use_foothold_constraints": True,
                                           "mpc.gradient.use_static_stability": True},
         "nominal"),
    ],
    "state_augmented": [
        ("input_rates", "input_rates", {}, "input_rates"),
        ("collaborative passive", "collaborative", {}, "collaborative"),
        ("collaborative static", "collaborative",
         {"mpc.gradient.passive_arm_compensation": False}, "collaborative"),
    ],
    "lyapunov_kinodynamic": [
        ("lyapunov", "lyapunov", {}, "lyapunov"),
        ("lyapunov decay", "lyapunov", {"mpc.gradient.use_residual_dynamics_decay": True},
         "lyapunov"),
        ("kinodynamic", "kinodynamic", {}, "kinodynamic"),
    ],
}


def _cfgs(mpc_type="nominal", **over):
    jc = jax_make_config("aliengo", mpc_type=mpc_type, **over)
    return jc, config_from_dict(dataclasses.asdict(jc))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)


def _specs(mpc_type, over, variant):
    """The JAX package's and the port's spec of one configuration."""
    jc, tc = _cfgs(mpc_type, **over)
    jp = jax_params(jc)
    if variant == "nominal":
        jspec = (jv.make_foothold_spec if jc.mpc.gradient.use_foothold_optimization
                 else jv.make_nominal_spec)(jc, jp)
    else:
        jspec = {"input_rates": jv.make_input_rates_spec, "collaborative":
                 jv.make_collaborative_spec, "lyapunov": jv.make_lyapunov_spec,
                 "kinodynamic": jv.make_kinodynamic_spec}[variant](jc, jp)
    return jc, tc, jspec, tv.make_spec(tc, variant, make_params(tc))


def _stage_inputs(spec, rng, contact):
    """One stage's seeded inputs around a standing trot: (x, u, feet, dt, wrench)."""
    nominal_feet = np.array([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0], [-0.25, 0.15, 0.0],
                             [-0.25, -0.15, 0.0]])
    base = np.concatenate([[0.01, -0.02, 0.33], rng.normal(0, 0.2, 3), rng.normal(0, 0.1, 3),
                           rng.normal(0, 0.3, 3)])
    feet = nominal_feet + rng.normal(0, 0.03, (4, 3))
    grf = np.tile([0.0, 0.0, 60.0], 4) + rng.normal(0, 10, 12)
    extra = {"nominal": [], "input_rates": grf,
             "collaborative": rng.normal(0, 5, 6),
             "lyapunov": rng.normal(0, 0.1, 9),
             "kinodynamic": np.tile([0.0, 0.8, -1.5], 4) + rng.normal(0, 0.1, 12),
             "foothold": (feet + rng.normal(0, 0.02, (4, 3))).reshape(12)}[spec.name]
    x = np.concatenate([base, extra]).astype(np.float32)
    u = {"nominal": grf, "input_rates": rng.normal(0, 200, 12), "collaborative": grf,
         "lyapunov": rng.normal(0, 10, 12),
         "kinodynamic": np.concatenate([rng.normal(0, 0.5, 12), grf]),
         "foothold": np.concatenate([rng.normal(0, 0.3, 12), grf])}[spec.name]
    if spec.name == "foothold":
        prox = (rng.uniform(size=4) < 0.3).astype(np.float64)
        feet = np.concatenate([feet, prox[:, None]], axis=1)
    wk = rng.normal(0, [20, 20, 30, 3, 3, 2])
    return (x, np.asarray(u, np.float32), feet.astype(np.float32), np.float32(0.02),
            wk.astype(np.float32))


@pytest.mark.parametrize("group", list(SPECS))
def test_spec_functions_and_jacobians_match_jax(group):
    """dynamics and stage_ineq, and their Jacobians in x and u (jax.jacfwd and
    torch.func.jacfwd), on seeded stages with every contact pattern the knobs
    branch on (2-stance diagonals and laterals, 3-stance, 4-stance, all swing)."""
    contacts = ([1, 0, 0, 1], [0, 1, 1, 0], [1, 1, 0, 0], [1, 0, 1, 0], [1, 1, 1, 0],
                [0, 1, 1, 1], [1, 1, 1, 1], [0, 0, 0, 0])
    rng = np.random.default_rng(11)
    for label, mpc_type, over, variant in SPECS[group]:
        _, tc, jspec, tspec = _specs(mpc_type, over, variant)
        assert (tspec.name, tspec.nx, tspec.nu, tspec.n_ineq) == \
            (jspec.name, jspec.nx, jspec.nu, jspec.n_ineq), label
        np.testing.assert_array_equal(tspec.q_diag, jspec.q_diag)
        np.testing.assert_array_equal(tspec.r_diag, jspec.r_diag)
        assert tspec.lm_scale == jspec.lm_scale
        if jspec.soft_mask is None:
            assert tspec.soft_mask is None
        else:
            np.testing.assert_array_equal(tspec.soft_mask, jspec.soft_mask)
        jfun = jax.jit(lambda *a: _spec_outputs(jspec, jax.jacfwd, *a))
        for k, contact in enumerate(contacts):
            x, u, feet, dt, wk = _stage_inputs(tspec, rng, contact)
            c = np.asarray(contact, np.float32)
            fz_max = (tc.mpc.grf_max * c + 1e-3).astype(np.float32)
            args = (x, u, feet, c, dt, wk, fz_max, np.float32(k))
            want = jfun(*(jnp.asarray(a) for a in args))
            got = _spec_outputs(tspec, torch.func.jacfwd, *(torch.from_numpy(np.asarray(a))
                                                             for a in args))
            for part, a, b in zip(PARTS, got, want):
                assert a.shape == b.shape, (label, part)
                assert _rel(a.numpy(), b) <= SPEC_RTOL, (label, contact, part,
                                                         _rel(a.numpy(), b))


PARTS = ("dynamics", "dynamics d/dx", "dynamics d/du", "stage_ineq", "stage_ineq d/dx",
         "stage_ineq d/du")


def _spec_outputs(spec, jacfwd, x, u, feet, c, dt, wk, fz_max, k):
    """A spec's dynamics and stage_ineq at one stage with their Jacobians in x and
    u (``jacfwd``: jax.jacfwd or torch.func.jacfwd)."""
    def dyn(xx, uu):
        return spec.dynamics(xx, uu, feet, c, dt, wk)

    def con(xx, uu):
        return spec.stage_ineq(xx, uu, c, fz_max, feet, k)

    return (dyn(x, u), jacfwd(dyn, 0)(x, u), jacfwd(dyn, 1)(x, u),
            con(x, u), jacfwd(con, 0)(x, u), jacfwd(con, 1)(x, u))


def _golden_state(name):
    """A golden scenario's (state, reference, seq), the kinodynamic state with the
    joints the JAX package's golden case gives it (float32 IK of its feet)."""
    _, state, ref, seq = _scenarios()[name]
    state = dict(state)
    if name == "trot_kinodynamic":
        jc = jax_make_config("aliengo", mpc_type="nominal")
        feet = np.stack([state[f"foot_{leg}"] for leg in LEGS])
        q0 = np.asarray(JaxKin(jc.robot).ik_world(
            jnp.asarray(feet, jnp.float32), jnp.asarray(state["position"], jnp.float32),
            jax_rot(jnp.asarray(state["orientation"], jnp.float32))))
        for i, leg in enumerate(LEGS):
            state[f"joint_{leg}"] = q0[i]
    return state, ref, seq


def _recorded(mpc):
    """Wrap mpc.solve to record its host inputs and output (numpy copies)."""
    fn, records = mpc.solve, []

    def solve(*a):
        out = fn(*a)
        records.append(([np.array(x, np.float32) for x in a], [np.array(x) for x in out]))
        return out

    mpc.solve = solve
    return records


# Variants of the QP assembly check: (mpc_type, overrides, variant). The state
# and input sizes 24/12 (input_rates), 21/12 (lyapunov; collaborative's 18/12
# takes the same path), the nested Jacobians (kinodynamic) and the soft rows
# over the foot states (foothold with boxes and the ZMP band; the nominal ZMP
# band's rows are the same function of fixed feet).
ASSEMBLED = {"input_rates": ("input_rates", {}, "input_rates"),
             "lyapunov": ("lyapunov", {}, "lyapunov"),
             "kinodynamic": ("kinodynamic", {}, "kinodynamic"),
             "foothold_boxes_zmp": ("nominal", {"mpc.gradient.use_foothold_optimization": True,
                                                "mpc.gradient.use_foothold_constraints": True,
                                                "mpc.gradient.use_zmp_stability": True},
                                    "nominal")}


def test_assembled_qps_match_jax():
    """(Hm, g, Cb, d) and S_big of the first Gauss-Newton step on the golden trot
    tick, from the inputs the port's controller hands its solve (the golden
    traces hold those ticks' results against the JAX package's)."""
    state, ref, seq = _golden_state("trot_kinodynamic")
    for label, (mpc_type, over, variant) in ASSEMBLED.items():
        jc, tc = _cfgs(mpc_type, **over)
        port = tv.VariantGradientMPC(tc, variant, device="cpu")
        rec = _recorded(port)
        port.compute_control(state, ref, seq)
        ins = rec[0][0]
        _, _, jasm, jS = jv.make_variant_solver(jc, _specs(mpc_type, over, variant)[2],
                                                return_assembler=True)
        _, _, tasm, tS = tv.make_variant_solver(tc, port.spec, return_assembler=True,
                                                   device="cpu")
        jq = [np.asarray(a) for a in jasm(*ins)]
        tq = [a.numpy() for a in tasm(*(torch.from_numpy(a) for a in ins))]
        for part, a, b in zip(("Hm", "g", "Cb", "d"), tq, jq):
            assert a.shape == b.shape, (label, part)
            assert _rel(a, b) <= QP_RTOL, (label, part, _rel(a, b))
        if jS is None:
            assert tS is None, label
        else:
            np.testing.assert_array_equal(tS, jS)


GOLDEN = ("trot_input_rates", "trot_lyapunov", "trot_collaborative", "trot_kinodynamic")
# Golden traces held through float64, with the keys that leave the golden
# tolerance. kinodynamic: on QPs of this tick the JAX package's first-stage
# joint velocities lie up to 0.52 rad/s off float64 (the port's up to 0.12;
# `python tests/test_torch_variants_loop.py f64`), which moves the cost 1 %.
F64_ROUTE = {"trot_kinodynamic": ("cost",)}
ENSEMBLE = 4  # seeded perturbations of the QP's Hessian for the float64 route
PERTURB = 3e-7  # relative: the two packages' assembly difference


_JAX_MEHROTRA = jax.jit(lambda *a: jax_meh(*a, iters=14).z)


def solver_gaps_to_f64(qps, cols):
    """(n, 2) gaps of the port's (as the variant core runs it, cascade-summed) and
    the JAX package's 14-iteration Mehrotra solves (the CPU budget) to the float64
    solution, on columns ``cols`` of z, for each
    hard QP (Hm, g, C, d) of ``qps``: the float64 route on the same matrices."""
    gaps = []
    for q in qps:
        z64 = pdip_solve_np_f64(*q)[0][cols]
        tz = pdip_solve_mehrotra(*(torch.from_numpy(np.array(a))[None] for a in q),
                                 iters=14, cascade=True).z[0].numpy()
        jz = np.asarray(_JAX_MEHROTRA(*q))
        gaps.append((float(np.abs(tz[cols] - z64).max()), float(np.abs(jz[cols] - z64).max())))
    return np.asarray(gaps)


def perturbed(q, n, seed=5):
    """q and n seeded copies with the Hessian perturbed by PERTURB relative
    (symmetrically): the spread of a chaotic float32 iterate around one QP."""
    rng = np.random.default_rng(seed)
    out = [q]
    for _ in range(n):
        E = rng.normal(0, PERTURB, q[0].shape)
        out.append([(q[0] * (1 + (E + E.T) / 2)).astype(np.float32)] + list(q[1:]))
    return out


def assert_no_less_accurate(gaps, label):
    """The float64 route: the port's largest and mean gaps at most max(2 x the
    JAX package's, F64_FLOOR)."""
    for stat in (np.max, np.mean):
        assert stat(gaps[:, 0]) <= max(2 * stat(gaps[:, 1]), F64_FLOOR), (label, stat.__name__,
                                                                          gaps)


@pytest.mark.parametrize("name", GOLDEN)
def test_compute_control_matches_golden_traces(name):
    """VariantGradientMPC.compute_control on the golden variant scenarios: grfs,
    footholds, predicted state and cost at the golden test's tolerance, but for
    the F64_ROUTE keys. There: the JAX package's live solve reproduces the
    fixture, and on the JAX package's QP, the port's, and ENSEMBLE seeded
    perturbations of the former (PERTURB relative on Hm) both packages'
    14-iteration solves go against float64: the port's largest and mean gap on
    the first-stage inputs within max(2 x the JAX package's, F64_FLOOR)."""
    golden = dict(np.load(FIXTURE))
    variant = name[len("trot_"):]
    jc, tc = _cfgs()
    state, ref, seq = _golden_state(name)
    port = tv.VariantGradientMPC(tc, variant, device="cpu")
    trec = _recorded(port)
    grfs, fh, pred, status, cost = port.compute_control(state, ref, seq)
    assert status == 0
    got = {"grfs": grfs, "footholds": fh, "predicted": pred, "cost": np.float32(cost)}

    def close(values, key):
        want = golden[f"{name}/{key}"]
        scale = max(1.0, float(np.max(np.abs(want))))
        return np.allclose(values[key], want, rtol=GOLDEN_RTOL, atol=GOLDEN_RTOL * scale)

    routed = F64_ROUTE.get(name, ())
    for key in got:
        assert key in routed or close(got, key), (name, key, got[key], golden[f"{name}/{key}"])
    if not routed:
        return
    _, _, jasm, _ = jv.make_variant_solver(jc, _specs("nominal", {}, variant)[2],
                                           return_assembler=True)
    _, _, tasm, _ = tv.make_variant_solver(tc, port.spec, return_assembler=True, device="cpu")
    ins = trec[0][0]
    jq = [np.asarray(a) for a in jasm(*ins)]
    tq = [a.numpy() for a in tasm(*(torch.from_numpy(a) for a in ins))]
    assert_no_less_accurate(solver_gaps_to_f64([tq] + perturbed(jq, ENSEMBLE),
                                               slice(0, port.spec.nu)), name)


LADDER_TICKS = 5  # the JAX test runs 10; the first 5 of them
LADDERS = {
    # tests/test_f64_ladder.py:59-83: static-stability rows with a negative margin,
    # every tick's slack active; the JAX test's bound 8 N.
    "forced_infeasible": ({**BLIND, "mpc.gradient.use_static_stability": True,
                           "mpc.gradient.trot_stability_margin": -0.03}, 8.0),
    # :84-89: the ZMP band as shipped; bound 0.6 N.
    "zmp_band": ({**BLIND, "mpc.gradient.use_zmp_stability": True}, 0.6),
}


LADDER_KEYS = ("n_active_slack_ticks", "soft_qp_gap_vs_f64_max_N")


def jax_ladders() -> dict:
    """The JAX package's side of test_soft_qp_ladder_beside_jax
    (tests/jax_references.py): its report's LADDER_KEYS for each ladder."""
    out = {}
    for ladder, (over, _) in LADDERS.items():
        jc = _cfgs(**over)[0]
        rep = jax_ladder(jc, n_ticks=LADDER_TICKS)
        out.update({f"{ladder}/{k}": np.asarray(rep[k]) for k in LADDER_KEYS})
        out[f"digest/{ladder}"] = digest(jc, LADDER_TICKS)
    return out


@pytest.mark.parametrize("ladder", list(LADDERS))
def test_soft_qp_ladder_beside_jax(ladder):
    """soft_qp_ladder_report on the port's own captured ticks (its SRB harness on
    the CPU, LADDER_TICKS ticks), beside the JAX package's report on its ticks
    (recorded): the same bound as the JAX test, float64 converged, the same count
    of active-slack ticks, and the port's worst gap within max(2 x JAX's,
    F64_FLOOR)."""
    over, bound = LADDERS[ladder]
    jc, tc = _cfgs(**over)
    rec = load_jax("ladders")
    check_inputs(rec, ladder, jc, LADDER_TICKS)
    jrep = {k: rec[f"{ladder}/{k}"].item() for k in LADDER_KEYS}
    rep = soft_qp_ladder_report(tc, n_ticks=LADDER_TICKS, device="cpu")
    assert rep["n_ticks"] == LADDER_TICKS and rep["f64_mu_max"] < 1e-10, rep
    assert rep["n_active_slack_ticks"] == jrep["n_active_slack_ticks"], (rep, jrep)
    if ladder == "forced_infeasible":
        assert rep["n_active_slack_ticks"] == LADDER_TICKS, rep
    assert rep["soft_qp_gap_vs_f64_max_N"] < bound, rep
    assert rep["soft_qp_gap_vs_f64_max_N"] <= max(2 * jrep["soft_qp_gap_vs_f64_max_N"],
                                                  F64_FLOOR), (rep, jrep)


# Every gradient configuration the JAX interface accepts: (mpc_type, overrides,
# the controller class and spec it builds).
INTERFACE = (("nominal", {}, "GradientMPC", None),
             ("nominal", {"mpc.gradient.use_DDP": True}, "GradientMPC", None),
             ("nominal", {"mpc.gradient.use_static_stability": True}, "VariantGradientMPC",
              "nominal"),
             ("nominal", {"mpc.gradient.use_zmp_stability": True}, "VariantGradientMPC",
              "nominal"),
             ("nominal", {"mpc.gradient.use_foothold_optimization": True},
              "VariantGradientMPC", "foothold"),
             ("input_rates", {}, "VariantGradientMPC", "input_rates"),
             ("lyapunov", {}, "VariantGradientMPC", "lyapunov"),
             ("collaborative", {}, "VariantGradientMPC", "collaborative"),
             ("kinodynamic", {}, "VariantGradientMPC", "kinodynamic"))


def test_interface_builds_and_solves_every_gradient_configuration():
    """SRBDControllerInterface(cfg, device="cpu") builds the controller the JAX
    interface builds for every mpc.type and gradient knob, solves one golden trot
    tick to finite GRFs masked by the current contact, and consumes runtime
    inertia only with the nominal GradientMPC."""
    from quadruped_pympc_tamols_tpu.interfaces import SRBDControllerInterface as JaxIface
    from quadruped_pympc_tamols_torch.interfaces import SRBDControllerInterface

    state, ref, seq = _golden_state("trot_kinodynamic")
    for mpc_type, over, cls, spec in INTERFACE:
        jc, tc = _cfgs(mpc_type, **{**BLIND, **over})
        iface = SRBDControllerInterface(tc, device="cpu")
        jiface = JaxIface(jc)
        assert type(iface.controller).__name__ == type(jiface.controller).__name__ == cls
        assert iface.consumes_inertia == jiface.consumes_inertia == (cls == "GradientMPC")
        if spec is not None:
            assert iface.controller.spec.name == jiface.controller.spec.name == spec
        grfs, _, _, pred = iface.compute_control(state, ref, seq)
        assert np.all(np.isfinite(grfs.data)) and np.all(np.isfinite(pred)), (mpc_type, over)
        assert not np.any(grfs.data[seq[:, 0] == 0]), (mpc_type, over)
        if mpc_type == "kinodynamic":
            assert iface.nmpc_joints_pos.shape == (tc.mpc.horizon, 12)


def test_rollout_ladder_and_its_float64_twin():
    """The sampling half of the ladder module: srb_rollout_cost_np_f64 equals the
    JAX package's bit for bit on seeded ticks, and rollout_ladder_report on 12
    real ticks of the port's sampling harness (the CPU, N = 512) finds the float32
    rollout within 1e-5 of float64, the JAX test's bound
    (tests/test_f64_ladder.py:92-103)."""
    from quadruped_pympc_tamols_tpu.utils.verification import srb_rollout_cost_np_f64 as jax_f64
    from quadruped_pympc_tamols_torch.controllers.sampling.rollout import ForceModelParams
    from quadruped_pympc_tamols_torch.utils.verification import (rollout_ladder_report,
                                                                 srb_rollout_cost_np_f64)

    _, tc = _cfgs("sampling")
    rng = np.random.default_rng(4)
    H = tc.mpc.horizon
    fm = ForceModelParams(0.3, 0.3, 0.0, 400.0, 0.5)
    for _ in range(3):
        state = np.concatenate([[0, 0, 0.33], rng.normal(0, 0.2, 9)])
        feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]])
        seq = (rng.uniform(size=(4, H)) < 0.7).astype(np.float64)
        args = (state, feet, np.zeros(12), rng.normal(0, 20, (H, 12)), seq,
                np.full(H, 60.0), tc.mpc.dts(), np.asarray(tc.mpc.cost.as_vector()), 24.0, 9.81,
                np.diag([0.1, 0.3, 0.3]), fm)
        assert srb_rollout_cost_np_f64(*args) == jax_f64(*args)
    rep = rollout_ladder_report(n_ticks=12, device="cpu")
    assert rep["rollout_ladder_n_ticks"] == 12
    assert rep["rollout_gap_vs_f64_rel"] < 1e-5, rep


def test_zmp_analysis_matches_jax_and_holds_the_band():
    """utils/analysis.py against the JAX package's on seeded recorded-like data
    (exact: the same numpy), and the port's ZMP variant keeping the ZMP within
    the trot margin of its diagonal support segment (tests/test_gradient_variants.py:
    139-162)."""
    from quadruped_pympc_tamols_tpu.utils import analysis as janalysis
    from quadruped_pympc_tamols_torch.utils import analysis

    rng = np.random.default_rng(8)
    T = 40
    base = rng.normal(0, 0.05, (T, 3))
    grfs = rng.normal([0, 0, 60], [10, 10, 20], (T, 4, 3))
    feet = np.array([[0.25, 0.15, 0], [0.25, -0.15, 0], [-0.25, 0.15, 0], [-0.25, -0.15, 0]]) \
        + rng.normal(0, 0.02, (T, 4, 3))
    contact = (rng.uniform(size=(T, 4)) < 0.7).astype(np.float64)
    for margin in (0.0, 0.02):
        for a, b in zip(analysis.check_zmp_violations(base, grfs, feet, contact, margin),
                        janalysis.check_zmp_violations(base, grfs, feet, contact, margin)):
            np.testing.assert_array_equal(a, b)
    _, tc = _cfgs(**{"mpc.gradient.use_zmp_stability": True})
    state, ref = _golden_state("trot_nominal")[:2]
    state["position"] = np.array([0.0, 0.0, tc.sim.ref_z - 0.02])
    state["linear_velocity"] = np.array([0.2, 0.05, 0.0])
    seq = np.ones((4, tc.mpc.horizon))
    seq[1, :] = seq[2, :] = 0.0  # FL/RR diagonal stance
    grfs, _, _, status, _ = tv.VariantGradientMPC(tc, "nominal", device="cpu").compute_control(
        state, ref, seq)
    assert status == 0
    feet = np.stack([state[f"foot_{leg}"] for leg in LEGS])
    a_xy = (grfs[:, :2] * seq[:, 0:1]).sum(axis=0) / tc.robot.mass
    zmp = state["position"][:2] - (state["position"][2] / 9.81) * a_xy
    assert -analysis.support_polygon_margin(zmp, feet, seq[:, 0]) <= \
        tc.mpc.gradient.trot_stability_margin + 0.05
