"""Regular-grid terrain heightmaps (torch).

Counterpart of ``quadruped_pympc_tamols_tpu/planner/heightmap.py``. The reference
wraps gym_quadruped HeightMap sensors (13 x 7 cells at 4 cm around each reference
foothold, yaw-aligned; simulation/simulation.py:489-509) in a cKDTree for
nearest-neighbour lookups (helpers/visual_foothold_adaptation.py:21-35). On a
regular grid the nearest cell is an inverse affine map, a round and a clamp, so
no tree is needed and every lookup of every leg is one batched gather.

A ``GridHeightMap`` holds tensors; the four legs' grids stack on a leading axis
(``stack_legs``). The arithmetic stays in float32 and in the JAX package's order,
so points near a cell border land in the same cell.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.device import resolve_device


@dataclasses.dataclass
class GridHeightMap:
    """Yaw-aligned regular grid of terrain heights.

    World position of cell (i, j):
        center + R(yaw) @ [(i - (R-1)/2) * res, (j - (C-1)/2) * res]
    ``heights`` carries z values, shape (..., R, C); ``center`` is (..., 2),
    ``yaw`` (...,) or a scalar, ``resolution`` a scalar or (...,).
    """

    center: torch.Tensor
    yaw: torch.Tensor
    resolution: torch.Tensor
    heights: torch.Tensor

    @property
    def shape(self):
        return tuple(self.heights.shape[-2:])

    def cell_world_xy(self) -> torch.Tensor:
        """World xy of every cell: (..., R, C, 2)."""
        R, C = self.shape
        dev = self.heights.device
        i = torch.arange(R, dtype=torch.float32, device=dev) - (R - 1) / 2.0
        j = torch.arange(C, dtype=torch.float32, device=dev) - (C - 1) / 2.0
        res = self.resolution[..., None, None]
        gx = i[:, None] * res  # grid-frame x
        gy = j[None, :] * res
        c, s = torch.cos(self.yaw)[..., None, None], torch.sin(self.yaw)[..., None, None]
        wx = self.center[..., None, None, 0] + c * gx - s * gy
        wy = self.center[..., None, None, 1] + s * gx + c * gy
        return torch.stack([wx, wy], dim=-1)


def _per_point(x: torch.Tensor, nb: int, extra: int) -> torch.Tensor:
    """A per-grid leaf (batch dims, or a scalar) shaped to broadcast against
    points of shape (batch..., extra..., 2)."""
    if x.dim() == 0:
        return x
    return x.reshape(*x.shape[:nb], *([1] * extra))


def lookup_nearest(hm: GridHeightMap, points_xy: torch.Tensor) -> torch.Tensor:
    """Nearest-cell height at world points (batch..., K..., 2) -> (batch..., K...),
    where batch is the grid's own leading shape (empty for one grid).

    Equivalent to the reference's cKDTree query on a regular grid: points outside
    the grid clamp to its border. No sensor offset is added here; callers add it,
    as the reference's FastHeightMap.get_height adds +0.02
    (visual_foothold_adaptation.py:31-35)."""
    R, C = hm.shape
    batch = hm.heights.shape[:-2]
    nb = len(batch)
    extra = points_xy.dim() - 1 - nb
    d = points_xy - hm.center.reshape(*batch, *([1] * extra), 2)
    yaw = _per_point(hm.yaw, nb, extra)
    c, s = torch.cos(yaw), torch.sin(yaw)
    # World -> grid frame (inverse rotation).
    gx = c * d[..., 0] + s * d[..., 1]
    gy = -s * d[..., 0] + c * d[..., 1]
    res = _per_point(hm.resolution, nb, extra)
    i = torch.clamp(torch.round(gx / res + (R - 1) / 2.0).to(torch.int64), 0, R - 1)
    j = torch.clamp(torch.round(gy / res + (C - 1) / 2.0).to(torch.int64), 0, C - 1)
    flat = hm.heights.reshape(*batch, R * C)
    idx = (i * C + j).reshape(*batch, -1)
    return torch.gather(flat, -1, idx).reshape(i.shape)


def heightmap_from_fn(terrain_fn, center_xy, yaw, resolution=0.04, rows=13, cols=7,
                      device="cuda") -> GridHeightMap:
    """Sample a GridHeightMap from a terrain height function z = terrain_fn(x, y)
    that takes float32 tensors, around ``center_xy`` (2,) with grid orientation
    ``yaw``; a batch of centers (B, 2) with yaws (B,) gives B stacked grids.
    Mirrors HeightMap.update_height_map placing the grid around a reference
    foothold with the base yaw (reference wb_interface.py:233-234)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    center = f32(center_xy)
    hm = GridHeightMap(center=center, yaw=f32(yaw), resolution=f32(resolution),
                       heights=torch.zeros((*center.shape[:-1], rows, cols), device=dev))
    pts = hm.cell_world_xy()
    hm.heights = torch.as_tensor(terrain_fn(pts[..., 0], pts[..., 1]), dtype=torch.float32,
                                 device=dev)
    return hm


def stack_legs(hms) -> GridHeightMap:
    """Stack per-leg grids on a leading axis (the JAX package's
    ``jax.tree.map(jnp.stack)``)."""
    return GridHeightMap(*(torch.stack([getattr(h, f.name) for h in hms])
                           for f in dataclasses.fields(GridHeightMap)))
