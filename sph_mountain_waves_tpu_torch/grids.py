"""Particle lattices (host side, NumPy).

Port of ``sph_mountain_waves_tpu/grids.py``, cut to the lattices the ported
schemes use: square and hexagonal (2-D) and simple cubic (3-D).
``covering(grid, shape)`` returns all lattice points inside the shape as an
``[N, 3]`` array.
"""
from __future__ import annotations

import numpy as np

from .geometry import Shape, boundarybox

__all__ = ["Grid", "Squaregrid", "Hexagrid", "CubicGrid", "dimension",
           "covering"]


class GridBase:
    dim = 2

    def covering(self, s: Shape) -> np.ndarray:
        raise NotImplementedError


def Grid(dr: float, symm: str) -> GridBase:
    """Grid factory. ``symm`` is the symmetry name, with or without the
    Julia ``:`` sigil; the square, hexagonal and cubic lattices are
    ported."""
    symm = str(symm).lstrip(":")
    if symm == "square":
        return Squaregrid(dr)
    if symm == "hexagonal":
        return Hexagrid(dr)
    if symm == "cubic":
        return CubicGrid(dr)
    raise NotImplementedError(f"grid type {symm!r} is not ported yet")


def dimension(grid: GridBase) -> int:
    """2 for planar grids, 3 for spatial."""
    return grid.dim


def covering(grid: GridBase, s: Shape) -> np.ndarray:
    """All lattice points of ``grid`` inside shape ``s``, as [N, 3]."""
    return grid.covering(s)


def _mask_points(pts: np.ndarray, s: Shape) -> np.ndarray:
    if len(pts) == 0:
        return pts.reshape(0, 3)
    return pts[s.is_inside(pts)]


def _irange(lo, hi):
    return np.arange(int(np.floor(lo)), int(np.ceil(hi)) + 1)


class Squaregrid(GridBase):
    """Square lattice, spacing dr."""
    dim = 2

    def __init__(self, dr):
        self.dr = float(dr)

    def covering(self, s):
        rect = boundarybox(s)
        ii = _irange(rect.x1_min / self.dr, rect.x1_max / self.dr)
        jj = _irange(rect.x2_min / self.dr, rect.x2_max / self.dr)
        I, J = np.meshgrid(ii, jj, indexing="ij")
        pts = np.stack([I * self.dr, J * self.dr,
                        np.zeros_like(I, dtype=np.float64)], axis=-1)
        return _mask_points(pts.reshape(-1, 3), s)


class Hexagrid(GridBase):
    """Hexagonal lattice: a=(4/3)^(1/4) dr, b=(3/4)^(1/4) dr, odd rows shifted
    a/2."""
    dim = 2

    def __init__(self, dr):
        self.dr = float(dr)
        self.a = (4.0 / 3.0) ** 0.25 * self.dr
        self.b = (3.0 / 4.0) ** 0.25 * self.dr

    def covering(self, s):
        rect = boundarybox(s)
        ii = np.arange(int(np.floor(rect.x1_min / self.a)) - 1,
                       int(np.ceil(rect.x1_max / self.a)) + 1)
        jj = _irange(rect.x2_min / self.b, rect.x2_max / self.b)
        I, J = np.meshgrid(ii, jj, indexing="ij")
        x1 = (I + (J % 2) / 2.0) * self.a
        x2 = J * self.b
        pts = np.stack([x1, x2, np.zeros_like(x1)], axis=-1)
        return _mask_points(pts.reshape(-1, 3), s)


class CubicGrid(GridBase):
    """Simple cubic lattice, spacing dr; covered plane by plane (z = k·dr)
    to bound memory."""
    dim = 3

    def __init__(self, dr):
        self.dr = float(dr)

    def covering(self, s):
        box, a = boundarybox(s), self.dr
        ii = _irange(box.x1_min / a, box.x1_max / a)
        jj = _irange(box.x2_min / a, box.x2_max / a)
        kk = _irange(box.x3_min / a, box.x3_max / a)
        I, J = np.meshgrid(ii, jj, indexing="ij")
        xs = I.astype(np.float64).ravel() * a
        ys = J.astype(np.float64).ravel() * a
        chunks = [np.zeros((0, 3))]
        for k in kk:
            pts = np.stack([xs, ys, np.full_like(xs, k * a)], axis=-1)
            chunks.append(_mask_points(pts, s))
        return np.concatenate(chunks)
