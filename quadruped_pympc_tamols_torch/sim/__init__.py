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
    if name in ("run_batched_simulations", "FleetStats"):
        from . import batched
        return getattr(batched, name)
    if name == "generate_dataset":
        from .generate_dataset import generate_dataset
        return generate_dataset
    if name in ("VideoRecorder", "draw_overlays", "rendering_available"):
        from . import video
        return getattr(video, name)
    raise AttributeError(name)
