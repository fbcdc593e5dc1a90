"""Particle lattices (host side, NumPy).

Port of ``sph_mountain_waves_tpu/grids.py``, every lattice of it: square,
hexagonal, Vogel spiral and exponential stratification (2-D); simple cubic,
body-centered, face-centered and diamond (3-D). ``covering(grid, shape)``
returns all lattice points inside the shape as an ``[N, 3]`` array, in the
reference's order; the 3-D lattices are covered plane by plane (z = k·a) to
bound memory. ``Grid(dr, symm)`` takes ``K`` only for ``"exp"``;
``Expgrid`` is an alias of ``ExpGrid``.
"""
from __future__ import annotations

import numpy as np

from .geometry import Shape, boundarybox

__all__ = [
    "Grid", "Squaregrid", "Hexagrid", "VogelGrid", "ExpGrid", "Expgrid",
    "CubicGrid", "FacecenteredGrid", "BodycenteredGrid", "DiamondGrid",
    "dimension", "covering",
]

GOLDEN_ANGLE = 2.39996322972865332


class GridBase:
    dim = 2

    def covering(self, s: Shape) -> np.ndarray:
        raise NotImplementedError


def Grid(dr: float, symm: str, K: float | None = None) -> GridBase:
    """Grid factory. ``symm`` is the symmetry name, with or without the
    Julia ``:`` sigil; ``K`` is the stratification rate of ``"exp"`` (the
    only symmetry that reads it). An unknown name raises ``ValueError``."""
    symm = str(symm).lstrip(":")
    if symm == "square":
        return Squaregrid(dr)
    if symm == "hexagonal":
        return Hexagrid(dr)
    if symm == "vogel":
        return VogelGrid(dr)
    if symm == "exp":
        if K is None:
            raise ValueError("ExpGrid requires K")
        return ExpGrid(dr, K)
    if symm == "cubic":
        return CubicGrid(dr)
    if symm == "facecentered":
        return FacecenteredGrid(dr)
    if symm == "bodycentered":
        return BodycenteredGrid(dr)
    if symm == "diamond":
        return DiamondGrid(dr)
    raise ValueError(f"Unsupported grid type: {symm}")


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
        pts = np.stack([I * self.dr, J * self.dr, np.zeros_like(I, dtype=np.float64)], axis=-1)
        return _mask_points(pts.reshape(-1, 3), s)


class Hexagrid(GridBase):
    """Hexagonal lattice: a=(4/3)^¼ dr, b=(3/4)^¼ dr, odd rows shifted
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


class VogelGrid(GridBase):
    """Fermat-spiral (Vogel) grid at the golden angle."""
    dim = 2

    def __init__(self, dr):
        self.dr = float(dr)
        self.k = self.dr / np.sqrt(np.pi)
        self.center = np.zeros(3)

    def covering(self, s):
        bb = boundarybox(s)
        corners = np.array([[bb.x1_min, bb.x2_min, 0.0], [bb.x1_max, bb.x2_min, 0.0],
                            [bb.x1_max, bb.x2_max, 0.0], [bb.x1_min, bb.x2_max, 0.0]])
        R = np.max(np.linalg.norm(corners - self.center, axis=1))
        N = int((R / self.k) ** 2)
        n = np.arange(1, N + 1, dtype=np.float64)
        rad = self.k * np.sqrt(n)
        ang = n * GOLDEN_ANGLE
        pts = self.center + np.stack([rad * np.cos(ang), rad * np.sin(ang),
                                      np.zeros_like(n)], axis=-1)
        return _mask_points(pts, s)


class ExpGrid(GridBase):
    """Exponentially stratified layers: vertical positions by inverting the
    truncated exponential CDF with rate K, uniform horizontal spacing dr.
    Built for hydrostatic atmospheres."""
    dim = 2

    def __init__(self, dr, K):
        self.dr = float(dr)
        self.K = float(K)

    def covering(self, s):
        rect = boundarybox(s)
        dr, K = self.dr, self.K
        H = rect.x2_max - rect.x2_min
        Nz = max(1, int(round(H / dr)))
        ii = _irange(rect.x1_min / dr, rect.x1_max / dr)
        e_min = np.exp(-K * rect.x2_min)
        e_max = np.exp(-K * rect.x2_max)
        j = np.arange(Nz)
        s_frac = (j + 0.5) / Nz
        e_y = e_min - s_frac * (e_min - e_max)
        ys = -np.log(e_y) / K
        X, Y = np.meshgrid(ii * dr, ys, indexing="ij")
        pts = np.stack([X, Y, np.zeros_like(X)], axis=-1)
        return _mask_points(pts.reshape(-1, 3), s)


Expgrid = ExpGrid  # the exported alias of ExpGrid


def _cover3(box, a, s, offsets=((0.0, 0.0, 0.0),), select=None):
    """Cover a 3-D box with lattice planes z = k·a, processed in slabs to
    bound memory. ``offsets`` are fractional-cell shifts (in units of a);
    ``select(I, J, k)`` optionally masks integer sites (diamond lattice)."""
    ii = _irange(box.x1_min / a, box.x1_max / a)
    jj = _irange(box.x2_min / a, box.x2_max / a)
    kk = _irange(box.x3_min / a, box.x3_max / a)
    I, J = np.meshgrid(ii, jj, indexing="ij")
    If, Jf = I.astype(np.float64).ravel(), J.astype(np.float64).ravel()
    chunks = [np.zeros((0, 3))]
    for ox, oy, oz in offsets:
        for k in kk:
            if select is not None:
                m = select(I.ravel(), J.ravel(), k)
                if not m.any():
                    continue
                xs, ys = If[m], Jf[m]
            else:
                xs, ys = If, Jf
            pts = np.stack([(xs + ox) * a, (ys + oy) * a,
                            np.full_like(xs, (k + oz) * a)], axis=-1)
            chunks.append(_mask_points(pts, s))
    return np.concatenate(chunks)


class CubicGrid(GridBase):
    """Simple cubic lattice, spacing dr."""
    dim = 3

    def __init__(self, dr):
        self.dr = float(dr)

    def covering(self, s):
        return _cover3(boundarybox(s), self.dr, s)


class BodycenteredGrid(GridBase):
    """BCC lattice, cube edge a = 2^(1/3) dr."""
    dim = 3

    def __init__(self, dr):
        self.dr = float(dr)
        self.a = 2.0 ** (1.0 / 3.0) * self.dr

    def covering(self, s):
        return _cover3(boundarybox(s), self.a, s,
                       offsets=[(0.0, 0.0, 0.0), (0.5, 0.5, 0.5)])


class FacecenteredGrid(GridBase):
    """FCC lattice, cube edge a = 4^(1/3) dr."""
    dim = 3

    def __init__(self, dr):
        self.dr = float(dr)
        self.a = 4.0 ** (1.0 / 3.0) * self.dr

    def covering(self, s):
        return _cover3(boundarybox(s), self.a, s,
                       offsets=[(0.0, 0.0, 0.0), (0.5, 0.5, 0.0),
                                (0.5, 0.0, 0.5), (0.0, 0.5, 0.5)])


class DiamondGrid(GridBase):
    """Diamond cubic lattice with half-spacing a = dr/2 and the reference's
    parity/mod-4 site selection."""
    dim = 3

    def __init__(self, dr):
        self.dr = float(dr)
        self.a = 0.5 * self.dr

    def covering(self, s):
        def select(I, J, k):
            odd_i, odd_j, odd_k = I % 2 != 0, J % 2 != 0, k % 2 != 0
            same = (odd_i == odd_j) & (odd_j == odd_k)
            m4 = ((I + J + k) % 4 + 4) % 4
            return same & ((m4 == 0) | (m4 == 1))
        return _cover3(boundarybox(s), self.a, s, select=select)
