"""Implicit-CSG geometry (host side, NumPy).

Port of ``sph_mountain_waves_tpu/geometry.py``, cut to the shapes the ported
schemes build, in 2-D and 3-D: ``Box``/``Rectangle``, ``Ball`` (the probe
disc or ball of ``BoundaryLayer``), the ``+``/``-`` CSG operators (union and
difference), ``Specification`` and ``BoundaryLayer``. Geometry runs once at set-up on the host, so it stays
NumPy; it is a separate copy because importing the JAX package's module
would import ``jax`` through that package's ``__init__``.

Semantics are the reference's: every shape answers ``is_inside`` on an
``[N, 3]`` point array and ``boundarybox``.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "Shape", "Box", "Rectangle", "Ball", "BooleanUnion", "BooleanDifference",
    "Specification",
    "BoundaryLayer", "is_inside", "boundarybox",
]


def _pts(x) -> np.ndarray:
    """Normalize input to an [N, 3] float array."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        if x.shape[0] == 2:
            x = np.concatenate([x, [0.0]])
        return x[None, :]
    if x.shape[-1] == 2:
        x = np.concatenate([x, np.zeros(x.shape[:-1] + (1,))], axis=-1)
    return x


class Shape:
    """Supertype for geometrical shapes."""

    def is_inside(self, x: np.ndarray) -> np.ndarray:  # [N,3] -> [N] bool
        raise NotImplementedError

    def boundarybox(self) -> "Box":
        raise NotImplementedError

    # +,- = union/difference
    def __add__(self, other: "Shape") -> "Shape":
        return BooleanUnion(self, other)

    def __sub__(self, other: "Shape") -> "Shape":
        return BooleanDifference(self, other)


def is_inside(x, s: Shape):
    """Vectorized membership test. Scalar in -> scalar out, [N,.] in -> [N] out."""
    out = s.is_inside(_pts(x))
    if np.asarray(x).ndim == 1:
        return bool(out[0])
    return out


def boundarybox(s: Shape) -> "Box":
    return s.boundarybox()


class Box(Shape):
    """Axis-aligned box from two corners."""

    def __init__(self, x1_min, x2_min, x3_min, x1_max, x2_max, x3_max):
        self.x1_min, self.x2_min, self.x3_min = float(x1_min), float(x2_min), float(x3_min)
        self.x1_max, self.x2_max, self.x3_max = float(x1_max), float(x2_max), float(x3_max)

    @property
    def mins(self):
        return np.array([self.x1_min, self.x2_min, self.x3_min])

    @property
    def maxs(self):
        return np.array([self.x1_max, self.x2_max, self.x3_max])

    def is_inside(self, x):
        return np.all((x >= self.mins) & (x <= self.maxs), axis=-1)

    def boundarybox(self):
        return self

    def __repr__(self):
        return f"Box({self.mins} .. {self.maxs})"


def Rectangle(x1_min, x2_min, x1_max, x2_max) -> Box:
    """2-D rectangle = flat Box."""
    return Box(x1_min, x2_min, 0.0, x1_max, x2_max, 0.0)


class Ball(Shape):
    """Ball by center and radius."""

    def __init__(self, x1, x2, x3, r):
        self.x1, self.x2, self.x3, self.r = float(x1), float(x2), float(x3), float(r)

    def is_inside(self, x):
        return ((x[..., 0] - self.x1) ** 2 + (x[..., 1] - self.x2) ** 2
                + (x[..., 2] - self.x3) ** 2) <= self.r**2

    def boundarybox(self):
        return Box(self.x1 - self.r, self.x2 - self.r, self.x3 - self.r,
                   self.x1 + self.r, self.x2 + self.r, self.x3 + self.r)


class BooleanUnion(Shape):
    """s1 | s2."""

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def is_inside(self, x):
        return self.s1.is_inside(x) | self.s2.is_inside(x)

    def boundarybox(self):
        r1, r2 = self.s1.boundarybox(), self.s2.boundarybox()
        return Box(*np.minimum(r1.mins, r2.mins), *np.maximum(r1.maxs, r2.maxs))


class BooleanDifference(Shape):
    """s1 minus s2."""

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def is_inside(self, x):
        return self.s1.is_inside(x) & ~self.s2.is_inside(x)

    def boundarybox(self):
        return self.s1.boundarybox()


class Specification(Shape):
    """All x in s with f(x) true.

    ``f`` receives points of shape [N, 3] (use NumPy ufuncs for speed); a
    scalar predicate written for a single 3-vector also works: a result that
    is not per-point falls back to a per-point loop.
    """

    def __init__(self, s, f):
        self.s, self.f = s, f

    def _eval(self, x):
        try:
            out = np.asarray(self.f(x))
            if out.shape == x.shape[:-1]:
                return out.astype(bool)
        except Exception:  # a scalar-only predicate; evaluate point by point
            pass
        return np.array([bool(self.f(p)) for p in x])

    def is_inside(self, x):
        return self._eval(x) & self.s.is_inside(x)

    def boundarybox(self):
        return self.s.boundarybox()


class BoundaryLayer(Shape):
    """Layer of given width around shape s: a point is inside iff it is NOT in
    s but some probe offset dx (grid covering of a width-ball) lands in s.
    This is how walls are built."""

    def __init__(self, s, grid, width):
        from .grids import covering, dimension  # local import, avoids cycle
        self.s = s
        self.dim = dimension(grid)
        self.dxs = covering(grid, Ball(0.0, 0.0, 0.0, float(width)))
        self.width = float(width)

    def is_inside(self, x):
        inside_s = self.s.is_inside(x)
        out = np.zeros(x.shape[:-1], dtype=bool)
        todo = ~inside_s
        for dx in self.dxs:
            if not todo.any():
                break
            hit = self.s.is_inside(x[todo] + dx)
            sub = np.where(todo)[0]
            out[sub[hit]] = True
            todo[sub[hit]] = False
        return out & ~inside_s

    def boundarybox(self):
        r = self.s.boundarybox()
        lo, hi = r.mins - self.width, r.maxs + self.width
        if self.dim == 2:
            return Rectangle(lo[0], lo[1], hi[0], hi[1])
        return Box(*lo, *hi)
