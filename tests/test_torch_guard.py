"""Boundaries of the PyTorch/CUDA port: it imports neither JAX nor the JAX package,
and its entry points refuse to fall back to the CPU silently."""
import importlib.util
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from quadruped_pympc_tamols_torch import Legs, make_config

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "quadruped_pympc_tamols_torch"


def _port_modules():
    mods = []
    for path in sorted((ROOT / PKG).rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


# The torque path, the facade and the MuJoCo tier, with their helpers.
TORQUE_AND_MUJOCO = ("interfaces.wrapper", "kinematics.ik_solvers", "sim.mjcf", "sim.mujoco_env",
                     "sim.simulation", "sim.trace", "observability.logger", "utils.float32")
# The gradient family's nominal RTI-SQP, its CUDA-graph runner and its float64 ladder.
GRADIENT = ("controllers.gradient", "controllers.gradient.ocp", "controllers.gradient.qp",
            "controllers.gradient.sqp", "utils.graphs", "utils.verification")
# The gradient family's variant core, its DDP solver and the ZMP analysis.
VARIANTS = ("controllers.gradient.variants", "controllers.gradient.ddp",
            "controllers.gradient.parallel_riccati", "utils.analysis")
# The on-device scenario fleet and its scenario-axis kernel K1f.
FLEET = ("parallel", "parallel.scenario_engine", "ops.sampling_fleet")


def test_port_imports_no_jax():
    mods = _port_modules()
    assert len(mods) > 20
    assert {f"{PKG}.{m}" for m in TORQUE_AND_MUJOCO + GRADIENT + VARIANTS + FLEET} <= set(mods)
    # Only modules the imports load count: the interpreter's startup may load others.
    code = textwrap.dedent(f"""
        import importlib, sys
        before = set(sys.modules)
        for m in {mods!r}:
            importlib.import_module(m)
        import chip_smoke
        bad = sorted(m for m in set(sys.modules) - before
                     if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                     or m.startswith("jaxlib.") or m.startswith("quadruped_pympc_tamols_tpu"))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_never_import_jax():
    for path in (ROOT / PKG).rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "quadruped_pympc_tamols_tpu import" not in text, path
        assert "from quadruped_pympc_tamols_tpu" not in text, path


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from quadruped_pympc_tamols_torch.controllers.sampling import SamplingMPC
    from quadruped_pympc_tamols_torch.interfaces import SRBDControllerInterface
    from quadruped_pympc_tamols_torch.sim import SRBClosedLoopHarness

    cfg = make_config("aliengo", **{"sim.visual_foothold_adaptation": "blind",
                                    "mpc.sampling.num_samples": 32})
    for entry in (SamplingMPC, SRBDControllerInterface, SRBClosedLoopHarness):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(cfg)
        assert entry(cfg, device="cpu") is not None
    from quadruped_pympc_tamols_torch.interfaces import QuadrupedPyMPCWrapper
    from quadruped_pympc_tamols_torch.utils.legs import Legs
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QuadrupedPyMPCWrapper(cfg, Legs.zeros((3,)))
    assert QuadrupedPyMPCWrapper(cfg, Legs.zeros((3,)), device="cpu") is not None


def test_gradient_entry_points_need_cuda_unless_cpu_is_asked():
    """The nominal gradient MPC (with the RTI solve and with DDP), the variant
    controllers, the controller interface and the wrapper built for it, and the
    batched gait interface refuse to run on the CPU unless asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from quadruped_pympc_tamols_torch.controllers.gradient import BatchedGradientMPC, GradientMPC
    from quadruped_pympc_tamols_torch.interfaces import QuadrupedPyMPCWrapper
    from quadruped_pympc_tamols_torch.interfaces.controller_interface import (
        SRBDBatchedControllerInterface, SRBDControllerInterface)
    from quadruped_pympc_tamols_torch.utils.legs import Legs

    cfg = make_config("aliengo", mpc_type="nominal",
                      **{"sim.visual_foothold_adaptation": "blind"})
    for entry in (GradientMPC, BatchedGradientMPC, SRBDControllerInterface,
                  SRBDBatchedControllerInterface):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry(cfg)
        assert entry(cfg, device="cpu") is not None
    from quadruped_pympc_tamols_torch import replace_config
    from quadruped_pympc_tamols_torch.controllers.gradient import VariantGradientMPC
    for over in ({"mpc.gradient.use_DDP": True}, {"mpc.type": "kinodynamic"},
                 {"mpc.gradient.use_zmp_stability": True}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            SRBDControllerInterface(replace_config(cfg, **over))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VariantGradientMPC(cfg, "lyapunov")
    assert VariantGradientMPC(cfg, "lyapunov", device="cpu") is not None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QuadrupedPyMPCWrapper(cfg, Legs.zeros((3,)))
    assert QuadrupedPyMPCWrapper(cfg, Legs.zeros((3,)), device="cpu") is not None


def test_fleet_entry_points_need_cuda_unless_cpu_is_asked():
    """The scenario fleet's, the sharded solver's, the multi-chip fleet's and the
    runtime's entry points refuse to run on the CPU unless asked, and build when
    asked; the mesh refuses a world smaller than itself, as the JAX package's
    refuses too few devices. The mesh and the sharded entry points run on a
    one-rank gloo group made here."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import torch.distributed as dist

    from quadruped_pympc_tamols_torch import parallel, runtime
    from quadruped_pympc_tamols_torch.controllers.sampling import make_fleet_sampling_solver

    cfg = make_config("aliengo", **{"mpc.sampling.num_samples": 32})
    gen = torch.Generator().manual_seed(0)
    for entry in (lambda **d: parallel.make_scenario_step(cfg, 32, terrain="perlin", **d),
                  lambda **d: parallel.make_terrain_generator("boxes", **d),
                  lambda **d: parallel.make_terrain_adapter(cfg, **d),
                  lambda **d: parallel.init_scenario_state(cfg, 96, 2, gen, **d),
                  lambda **d: make_fleet_sampling_solver(cfg, 32, **d)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
        assert entry(device="cpu") is not None
    parallel.init_multihost(f"127.0.0.1:{parallel.find_free_port()}", 1, 0, device="cpu")
    try:
        with pytest.raises(ValueError, match="need 2 ranks"):
            parallel.scenario_mesh(1, 2)
        mesh = parallel.scenario_mesh(1, 1)
        assert mesh.member and mesh.shape == {"scenario": 1, "sample": 1}
        for entry in (lambda **d: parallel.make_sharded_sampling_solver(cfg, mesh, 32, **d),
                      lambda **d: parallel.make_multichip_step(cfg, mesh, 2, 32, **d)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                entry()
            assert entry(device="cpu") is not None
    finally:
        dist.destroy_process_group()
    feet = Legs(np.asarray([[0.25, 0.15, 0.0], [0.25, -0.15, 0.0], [-0.25, 0.15, 0.0],
                            [-0.25, -0.15, 0.0]]))
    for entry in (lambda **d: runtime.ControllerNode(cfg, feet, **d),
                  lambda **d: runtime.ControllerBridge(cfg, runtime.LocalTransport(), **d)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
        node = entry(device="cpu")
        node.shutdown()


def test_importing_the_port_needs_no_mujoco():
    """The MuJoCo tier loads lazily: the package, its sim package and the wrapper
    import without loading mujoco."""
    code = textwrap.dedent(f"""
        import sys
        import {PKG}, {PKG}.sim, {PKG}.interfaces, {PKG}.sim.trace
        from {PKG}.interfaces import QuadrupedPyMPCWrapper
        sys.exit(1 if "mujoco" in sys.modules else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_cuda(capsys):
    """Without a card the smoke script exits non-zero and prints no result. Run
    in this process (torch is already loaded); the guard above covers its imports."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_cpu_wrapper_takes_the_plain_version_only_for_cpu_tensors():
    from quadruped_pympc_tamols_torch.ops import sampling_kernel as sk

    plan = sk.make_rs_plan(make_config("aliengo"), 64, "cpu")
    tick = sk.TickInputs(np.zeros(12, np.float32), np.zeros((4, 3), np.float32),
                         np.zeros(12, np.float32), np.ones((4, 12), np.float32),
                         np.full((12, 4), 60.0, np.float32))
    before = sk.sampling_rs.launches
    costs, out = sk.sampling_rs(plan, tick, torch.zeros(96), 0, 0)
    assert costs.shape == (64,) and out.shape == (sk.OUT_WINNER + 96,)
    assert sk.sampling_rs.launches == before  # the plain version is not a launch
    with pytest.raises(ValueError):
        sk.sampling_rs(plan, tick, torch.zeros(96, device="meta"), 0, 0)
