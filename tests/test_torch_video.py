"""The MuJoCo tier's last pieces in the port, against the JAX package on the CPU:
``sim/video.py`` (the debug overlays and the offscreen recorder) and
``sim/batched.py`` (randomized episodes fanned out over spawned processes).

There is no GL backend here (``rendering_available()`` is False on both sides),
so the overlays are drawn into a CPU-side ``mujoco.MjvScene`` and the recorder
runs on a stub renderer that returns fixed frames: its frame schedule, the frames
it encodes and the files it writes are compared, not pixels. The overlays'
geoms are MuJoCo's own float64 arithmetic on the same inputs: equal bit for bit.
``run_batched_simulations`` passes ``device`` through to its workers; with
``device="cpu"`` and two processes of one 0.2 s episode each, its statistics
equal those of the port's serial ``run_simulation`` with the same seeds to rtol
1e-6 (the workers' torch may take other thread counts, which reorders float32
sums)."""
import types

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from quadruped_pympc_tamols_tpu import make_config as jax_make_config
from quadruped_pympc_tamols_tpu.sim import mujoco_env as jax_env
from quadruped_pympc_tamols_tpu.sim import video as jax_video
from quadruped_pympc_tamols_tpu.utils.legs import Legs as JaxLegs
from quadruped_pympc_tamols_torch import make_config
from quadruped_pympc_tamols_torch.sim import batched, mujoco_env, simulation, video
from quadruped_pympc_tamols_torch.utils.legs import Legs

mujoco = pytest.importorskip("mujoco")
threadpool_limits(1)
torch.set_num_threads(1)

GRFS = np.array([[10.0, 2.0, 120.0], [0.5, 0.2, 0.4], [-8.0, 1.0, 95.0], [0.0, 0.0, 0.0]])
FOOTHOLDS = np.array([[0.3, 0.2, 0.0], [0.3, -0.2, 0.01], [-0.2, 0.2, 0.0], [-0.2, -0.2, 0.02]])
DES = FOOTHOLDS + [0.05, 0.0, 0.08]
CONTACT = np.array([1.0, 0.0, 1.0, 0.0])


def stand_in(legs):
    """A wrapper's overlay state: its GRFs, footholds, swing targets and contact."""
    return types.SimpleNamespace(
        nmpc_GRFs=legs(GRFS), nmpc_footholds=legs(FOOTHOLDS),
        wb_interface=types.SimpleNamespace(last_des_foot_pos=legs(DES), current_contact=CONTACT))


def geoms(scene):
    return [(int(g.type), g.pos.copy(), g.size.copy(), g.rgba.copy(), g.mat.copy())
            for g in scene.geoms[:scene.ngeom]]


@pytest.mark.parametrize("maxgeom", [64, 5])
def test_draw_overlays_matches_jax(maxgeom):
    """GRF arrows (only where |f| > 1 N), foothold markers and swing-target markers
    (swing legs only) in a scene of ``maxgeom`` geoms: the same count, types,
    positions, sizes, colours and frames as the JAX package's; at 5 it stops at the
    scene's capacity as JAX's does."""
    env = mujoco_env.QuadrupedEnv(make_config("aliengo"))
    jenv = jax_env.QuadrupedEnv(jax_make_config("aliengo"))
    scene = mujoco.MjvScene(env.model, maxgeom=maxgeom)
    jscene = mujoco.MjvScene(jenv.model, maxgeom=maxgeom)
    video.draw_overlays(scene, env, stand_in(Legs))
    jax_video.draw_overlays(jscene, jenv, stand_in(JaxLegs))
    got, want = geoms(scene), geoms(jscene)
    assert scene.ngeom == jscene.ngeom == min(maxgeom, 2 + 4 + 2)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, b)
    video.draw_overlays(scene, env, None)  # no wrapper: nothing drawn
    assert scene.ngeom == jscene.ngeom


class StubRenderer:
    """A renderer without GL: a scene for the overlays, frames that count up."""

    def __init__(self, model, height=480, width=640):
        self.scene = mujoco.MjvScene(model, maxgeom=64)
        self.shape = (height // 60, width // 60, 3)
        self.calls, self.closed = [], False

    def update_scene(self, data, camera=None):
        self.calls.append(camera)
        self.scene.ngeom = 0

    def render(self):
        return np.full(self.shape, 20 * len(self.calls) + self.scene.ngeom, np.uint8)

    def close(self):
        self.closed = True


def test_video_recorder_schedule_and_writer(tmp_path, monkeypatch):
    """VideoRecorder at 30 fps over 0.2 s of 2 ms steps, with the overlays, on the
    stub renderer (mujoco.Renderer replaced by it for both packages' recorders):
    the same capture schedule, frames and written GIF, the episode index filled
    into the path; a recorder that captured nothing writes nothing."""
    env = mujoco_env.QuadrupedEnv(make_config("aliengo"))
    jenv = jax_env.QuadrupedEnv(jax_make_config("aliengo"))
    monkeypatch.setattr(mujoco, "Renderer", StubRenderer)
    rec = video.VideoRecorder(env, str(tmp_path / "port_%d.gif"), fps=30.0)
    jrec = jax_video.VideoRecorder(jenv, str(tmp_path / "jax_%d.gif"), fps=30.0)
    taken = [rec.maybe_capture(0.002 * k, stand_in(Legs)) for k in range(100)]
    jtaken = [jrec.maybe_capture(0.002 * k, stand_in(JaxLegs)) for k in range(100)]
    assert taken == jtaken and sum(taken) == 6  # t = 0, 1/30, ..., 5/30
    assert len(rec.frames) == len(jrec.frames) == 6
    for f, jf in zip(rec.frames, jrec.frames):
        np.testing.assert_array_equal(f, jf)
    assert int(rec.frames[0][0, 0, 0]) == 20 + 8  # the overlays' eight geoms
    renderer = rec.renderer
    path, jpath = rec.close(episode=2), jrec.close(episode=2)
    assert path == str(tmp_path / "port_2.gif") and jpath == str(tmp_path / "jax_2.gif")
    import imageio
    got, want = imageio.mimread(path), imageio.mimread(jpath)
    assert len(got) == len(want) == 6
    for f, jf in zip(got, want):
        np.testing.assert_array_equal(f, jf)
    assert renderer.closed and rec.frames == []
    empty = video.VideoRecorder(env, str(tmp_path / "none.gif"))
    assert empty.close() is None and not (tmp_path / "none.gif").exists()
    assert video.rendering_available() == jax_video.rendering_available()


def test_batched_simulations_match_serial_runs():
    """Two spawned workers of one 0.2 s randomized episode each on the CPU
    (device passed through) against the same episodes run here one after the
    other: the same success rate, tracking error and distance; without a card the
    default device raises."""
    cfg = make_config("aliengo", mpc_type="sampling",
                      **{"sim.visual_foothold_adaptation": "blind",
                         "mpc.sampling.num_samples": 32})
    stats = batched.run_batched_simulations(cfg, num_processes=2, episodes_per_process=1,
                                            episode_duration_s=0.2, seed=3, device="cpu")
    serial = [simulation.run_simulation(cfg, num_episodes=1, episode_duration_s=0.2,
                                        ref_base_lin_vel=("random", 0.1, 0.4),
                                        friction_range=(0.6, 1.0), seed=3 + i,
                                        device="cpu")[0] for i in range(2)]
    err = np.array([r.mean_vel_error for r in serial])
    assert stats.episodes == 2
    assert stats.success_rate == np.mean([not r.fell for r in serial])
    np.testing.assert_allclose(
        [stats.mean_tracking_error, stats.std_tracking_error, stats.mean_distance],
        [err.mean(), err.std(), np.mean([r.distance for r in serial])], rtol=1e-6, atol=1e-9)
    if not torch.cuda.is_available():  # the default device is the card, never the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            batched.run_batched_simulations(cfg, num_processes=1, episodes_per_process=1,
                                            episode_duration_s=0.01)
