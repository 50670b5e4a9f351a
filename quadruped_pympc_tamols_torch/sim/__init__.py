from .srb_harness import SRBClosedLoopHarness

__all__ = ["SRBClosedLoopHarness"]


def __getattr__(name):
    # Lazy imports: the MuJoCo pieces load on demand, so importing the port never
    # needs MuJoCo.
    if name == "QuadrupedEnv":
        from .mujoco_env import QuadrupedEnv
        return QuadrupedEnv
    if name in ("run_simulation", "EpisodeResult"):
        from . import simulation
        return getattr(simulation, name)
    raise AttributeError(name)
