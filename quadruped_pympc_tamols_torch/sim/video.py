"""Offscreen video recording of simulation episodes (host MuJoCo).

Counterpart of ``quadruped_pympc_tamols_tpu/sim/video.py`` (reference
simulation/video_recorder.py:17-207 and its debug overlays,
quadruped_utils.py:25-98): an offscreen ``mujoco.Renderer`` captures frames at a
fixed fps from the episode loop, with GRF arrows and foothold and swing-target
markers injected into the scene, and the frames are encoded to MP4
(imageio/ffmpeg) or, failing that, GIF. Nothing here touches the card.

Needs a GL backend (``MUJOCO_GL=egl`` or ``osmesa`` on a headless machine);
``rendering_available`` probes for one so that callers and tests can gate on it.
"""
from __future__ import annotations

import time

import numpy as np


def rendering_available() -> bool:
    """True if an offscreen MuJoCo renderer can be created in this process."""
    try:
        import mujoco

        xml = "<mujoco><worldbody><light pos='0 0 3'/></worldbody></mujoco>"
        m = mujoco.MjModel.from_xml_string(xml)
        r = mujoco.Renderer(m, 64, 64)
        r.close()
        return True
    except Exception:
        return False


def draw_overlays(scene, env, wrapper):
    """Add the debug overlays to a MuJoCo scene: GRF arrows at the feet (N / 500 m
    long, where |f| > 1 N), blue foothold markers and green swing-target markers
    for swing legs (reference quadruped_utils.py:25-98, simulation.py:713-764).
    Works on an offscreen Renderer's scene and on a live viewer's ``user_scn``
    (whose ``ngeom`` callers reset before each sync); stops at ``maxgeom``."""
    import mujoco

    if wrapper is None:
        return

    def add_marker(kind, pos, size, rgba):
        if scene.ngeom >= scene.maxgeom:
            return
        g = scene.geoms[scene.ngeom]
        mujoco.mjv_initGeom(g, kind, np.asarray(size, np.float64), np.asarray(pos, np.float64),
                            np.eye(3).flatten(), np.asarray(rgba, np.float32))
        scene.ngeom += 1

    grfs = getattr(wrapper, "nmpc_GRFs", None)
    feet = env.feet_pos()
    if grfs is not None:
        for leg in range(4):
            f = np.asarray(grfs.data)[leg]
            p0 = np.asarray(feet.data)[leg]
            p1 = p0 + f / 500.0  # N -> m of arrow
            if np.linalg.norm(f) > 1.0 and scene.ngeom < scene.maxgeom:
                g = scene.geoms[scene.ngeom]
                mujoco.mjv_initGeom(g, mujoco.mjtGeom.mjGEOM_ARROW, np.zeros(3), np.zeros(3),
                                    np.eye(3).flatten(), np.array([1, 0.2, 0.2, 0.8], np.float32))
                mujoco.mjv_connector(g, mujoco.mjtGeom.mjGEOM_ARROW, 0.005, p0, p1)
                scene.ngeom += 1
    fh = getattr(wrapper, "nmpc_footholds", None)
    if fh is not None:
        for leg in range(4):
            add_marker(mujoco.mjtGeom.mjGEOM_SPHERE, np.asarray(fh.data)[leg], [0.02, 0, 0],
                       [0.2, 0.4, 1.0, 0.7])
    wb = getattr(wrapper, "wb_interface", None)
    if wb is not None:
        des = np.asarray(wb.last_des_foot_pos.data)
        for leg in range(4):
            if wb.current_contact[leg] == 0:
                add_marker(mujoco.mjtGeom.mjGEOM_SPHERE, des[leg], [0.012, 0, 0],
                           [0.2, 1.0, 0.3, 0.8])


class VideoRecorder:
    """Fixed-fps offscreen episode recorder with the debug overlays.

    env: a ``QuadrupedEnv`` (its model and data). path: the output file, '.mp4'
    (needs imageio's ffmpeg plugin; else a '.gif' beside it) or '.gif'; a
    '%d'-style placeholder takes the episode index. fps: the capture rate (the
    reference records at 30 fps). width, height: the frame size. camera: a camera
    name or index, -1 for the free camera.
    """

    def __init__(self, env, path: str, fps: float = 30.0, width: int = 640,
                 height: int = 480, camera: str | int = -1):
        import mujoco

        self.env = env
        self.path = path
        self.fps = fps
        self.renderer = mujoco.Renderer(env.model, height, width)
        self.camera = camera
        self.frames: list[np.ndarray] = []
        self._next_t = 0.0
        self._t0 = None

    def maybe_capture(self, sim_time: float, wrapper=None) -> bool:
        """Capture a frame if the fps clock has come round; True if one was taken."""
        if sim_time + 1e-9 < self._next_t:
            return False
        self._next_t = sim_time + 1.0 / self.fps
        if self._t0 is None:
            self._t0 = time.time()
        if isinstance(self.camera, str) or self.camera >= 0:
            self.renderer.update_scene(self.env.data, camera=self.camera)
        else:
            self.renderer.update_scene(self.env.data)
        draw_overlays(self.renderer.scene, self.env, wrapper)
        self.frames.append(self.renderer.render().copy())
        return True

    def close(self, episode: int = 0) -> str | None:
        """Encode and write the captured frames; returns the written path."""
        if not self.frames:
            self.renderer.close()
            return None
        path = self.path % episode if "%" in self.path else self.path
        import imageio

        try:
            imageio.mimwrite(path, self.frames, fps=self.fps)
        except Exception:
            # No ffmpeg plugin: a GIF beside the requested path.
            path = path.rsplit(".", 1)[0] + ".gif"
            imageio.mimwrite(path, self.frames, fps=self.fps)
        self.renderer.close()
        self.frames = []
        return path
