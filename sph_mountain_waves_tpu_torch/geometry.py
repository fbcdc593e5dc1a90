"""Implicit-CSG geometry (host side, NumPy).

Port of ``sph_mountain_waves_tpu/geometry.py``, every shape of it: ``Box``/
``Rectangle``, ``Circle``, ``Ellipse``, ``Ball``, ``Ellipsoid``, ``Cone``,
the ``+``/``-``/``*`` CSG operators (union, difference, intersection),
``Specification``, ``BoundaryLayer``, ``Transform`` (affine map),
``Polygon`` (winding number), ``ClosedSpline`` (a natural cubic spline
resampled into a polygon), ``RevolutionBody`` and ``Witch`` (the
Witch-of-Agnesi mountain). Geometry runs once at set-up on the host, so it
stays NumPy; it is a separate copy because importing the JAX package's
module would import ``jax`` through that package's ``__init__``.

Semantics are the reference's: every shape answers ``is_inside`` on an
``[N, 3]`` point array and ``boundarybox``.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "Shape", "Box", "Rectangle", "Circle", "Ellipse", "Ball", "Ellipsoid",
    "Cone", "BooleanUnion", "BooleanIntersection", "BooleanDifference",
    "Specification", "BoundaryLayer", "Transform", "Polygon", "ClosedSpline",
    "RevolutionBody", "Witch", "is_inside", "boundarybox",
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

    # +,-,* = union/difference/intersection
    def __add__(self, other: "Shape") -> "Shape":
        return BooleanUnion(self, other)

    def __sub__(self, other: "Shape") -> "Shape":
        return BooleanDifference(self, other)

    def __mul__(self, other: "Shape") -> "Shape":
        return BooleanIntersection(self, other)


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


class Circle(Shape):
    """Circle by center and radius."""

    def __init__(self, x1, x2, r):
        if r <= 0.0:
            raise ValueError("Degenerate circle definition (r <= 0)!")
        self.x1, self.x2, self.r = float(x1), float(x2), float(r)

    def is_inside(self, x):
        return (x[..., 0] - self.x1) ** 2 + (x[..., 1] - self.x2) ** 2 <= self.r**2

    def boundarybox(self):
        return Rectangle(self.x1 - self.r, self.x2 - self.r, self.x1 + self.r, self.x2 + self.r)


class Ellipse(Shape):
    """Ellipse by center and semi-axes."""

    def __init__(self, x1, x2, r1, r2):
        if r1 <= 0.0 or r2 <= 0.0:
            raise ValueError("Degenerate ellipse definition!")
        self.x1, self.x2, self.r1, self.r2 = float(x1), float(x2), float(r1), float(r2)

    def is_inside(self, x):
        return ((x[..., 0] - self.x1) / self.r1) ** 2 + ((x[..., 1] - self.x2) / self.r2) ** 2 <= 1.0

    def boundarybox(self):
        return Rectangle(self.x1 - self.r1, self.x2 - self.r2, self.x1 + self.r1, self.x2 + self.r2)


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


class Ellipsoid(Shape):
    """Ellipsoid by center and three radii."""

    def __init__(self, x1, x2, x3, r1, r2, r3):
        self.c = np.array([x1, x2, x3], dtype=np.float64)
        self.r = np.array([r1, r2, r3], dtype=np.float64)

    def is_inside(self, x):
        return np.sum(((x - self.c) / self.r) ** 2, axis=-1) <= 1.0

    def boundarybox(self):
        lo, hi = self.c - self.r, self.c + self.r
        return Box(*lo, *hi)


class Cone(Shape):
    """Truncated cone from basis center a (radius ar) to tip center b
    (radius br), with the reference's parametrization, including its
    (unnormalized) axial coordinate s = (x-a)·(b-a)."""

    def __init__(self, a1, a2, a3, b1, b2, b3, ar, br):
        self.a = np.array([a1, a2, a3], dtype=np.float64)
        self.b = np.array([b1, b2, b3], dtype=np.float64)
        self.ar, self.br = float(ar), float(br)
        self.len = float(np.linalg.norm(self.a - self.b))

    def is_inside(self, x):
        s = np.sum((x - self.a) * (self.b - self.a), axis=-1)
        ok = (0.0 <= s) & (s <= self.len)
        t = np.linalg.norm(x - s[..., None] * self.b - (1.0 - s[..., None]) * self.a, axis=-1)
        return ok & (s / self.len * self.br + (1.0 - s / self.len) * self.ar >= t)

    def boundarybox(self):
        R = max(self.ar, self.br)
        lo = np.minimum(self.a, self.b) - R
        hi = np.maximum(self.a, self.b) + R
        return Box(*lo, *hi)


class BooleanUnion(Shape):
    """s1 | s2."""

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def is_inside(self, x):
        return self.s1.is_inside(x) | self.s2.is_inside(x)

    def boundarybox(self):
        r1, r2 = self.s1.boundarybox(), self.s2.boundarybox()
        return Box(*np.minimum(r1.mins, r2.mins), *np.maximum(r1.maxs, r2.maxs))


class BooleanIntersection(Shape):
    """s1 ∩ s2."""

    def __init__(self, s1, s2):
        self.s1, self.s2 = s1, s2

    def is_inside(self, x):
        return self.s1.is_inside(x) & self.s2.is_inside(x)

    def boundarybox(self):
        r1, r2 = self.s1.boundarybox(), self.s2.boundarybox()
        return Box(*np.maximum(r1.mins, r2.mins), *np.minimum(r1.maxs, r2.maxs))


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


class Transform(Shape):
    """Affine map x → Ax + b applied to s."""

    def __init__(self, s, A=None, b=None):
        self.s = s
        self.A = np.eye(3) if A is None else np.asarray(A, dtype=np.float64)
        self.b = np.zeros(3) if b is None else np.asarray(b, dtype=np.float64)
        self.A_inv = np.linalg.inv(self.A)

    def is_inside(self, x):
        return self.s.is_inside((x - self.b) @ self.A_inv.T)

    def boundarybox(self):
        box = self.s.boundarybox()
        corners = np.array([[x1, x2, x3]
                            for x1 in (box.x1_min, box.x1_max)
                            for x2 in (box.x2_min, box.x2_max)
                            for x3 in (box.x3_min, box.x3_max)])
        mapped = corners @ self.A.T + self.b
        return Box(*mapped.min(axis=0), *mapped.max(axis=0))


class Polygon(Shape):
    """2-D polygon via winding number."""

    def __init__(self, *pts):
        self.xs = np.array([p[0] for p in pts], dtype=np.float64)
        self.ys = np.array([p[1] for p in pts], dtype=np.float64)
        self.deg = len(pts)

    def is_inside(self, x):
        px, py = x[..., 0], x[..., 1]
        wn = np.zeros(px.shape, dtype=np.int64)
        for i in range(self.deg):
            nxt = (i + 1) % self.deg
            isleft = ((self.xs[nxt] - self.xs[i]) * (py - self.ys[i])
                      - (px - self.xs[i]) * (self.ys[nxt] - self.ys[i]))
            wn += ((self.ys[i] <= py) & (py < self.ys[nxt]) & (isleft > 0.0)).astype(np.int64)
            wn -= ((self.ys[i] > py) & (py >= self.ys[nxt]) & (isleft < 0.0)).astype(np.int64)
        return wn != 0

    def boundarybox(self):
        return Rectangle(self.xs.min(), self.ys.min(), self.xs.max(), self.ys.max())


def _natural_cubic_coeffs(y: np.ndarray):
    """Natural cubic spline second derivatives on a uniform grid (tridiagonal)."""
    n = len(y)
    m = np.zeros(n)
    if n < 3:
        return m
    # solve tridiagonal system for interior second derivatives
    a = np.full(n - 2, 1.0)
    b = np.full(n - 2, 4.0)
    # RHS in units of y''·h²: m here is (true second derivative)·h², so the
    # evaluation below needs no h² factor
    d = 6.0 * (y[2:] - 2.0 * y[1:-1] + y[:-2])
    # Thomas algorithm
    for i in range(1, n - 2):
        w = a[i] / b[i - 1]
        b[i] -= w * a[i - 1]
        d[i] -= w * d[i - 1]
    sol = np.zeros(n - 2)
    sol[-1] = d[-1] / b[-1]
    for i in range(n - 4, -1, -1):
        sol[i] = (d[i] - a[i] * sol[i + 1]) / b[i]
    m[1:-1] = sol
    return m


def ClosedSpline(*pts, n: int = 32) -> Polygon:
    """Closed natural-cubic spline through points (knots at uniform
    parameters), resampled into an n-gon."""
    xs = np.array([p[0] for p in pts], dtype=np.float64)
    ys = np.array([p[1] for p in pts], dtype=np.float64)
    xs = np.append(xs, xs[0])
    ys = np.append(ys, ys[0])
    k = len(pts)
    ts_knots = np.arange(k + 1) / k  # knots at 0, 1/k, ..., 1
    ts_fine = np.array([i / (n - 1) for i in range(n)])

    def interp(vals, t):
        m = _natural_cubic_coeffs(vals)
        hseg = 1.0 / k
        j = np.clip(np.floor(t / hseg).astype(int), 0, k - 1)
        u = (t - ts_knots[j]) / hseg
        return (vals[j] * (1 - u) + vals[j + 1] * u
                + ((1 - u) ** 3 - (1 - u)) * m[j] / 6.0
                + (u ** 3 - u) * m[j + 1] / 6.0)

    fine = [(float(interp(xs, t)), float(interp(ys, t))) for t in ts_fine]
    return Polygon(*fine)


class RevolutionBody(Shape):
    """3-D body from revolving a 2-D shape around the z axis."""

    def __init__(self, s):
        self.s = s

    def is_inside(self, x):
        r = np.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
        flat = np.stack([r, x[..., 2], np.zeros_like(r)], axis=-1)
        return self.s.is_inside(flat)

    def boundarybox(self):
        rect = self.s.boundarybox()
        R = rect.x1_max
        return Box(-R, -R, rect.x2_min, R, R, rect.x2_max)


class Witch(Shape):
    """Witch-of-Agnesi mountain: the region below h(x) = hₘ a² / (x² + a²)
    within a bounding rectangle (the mountain-wave schemes build the same
    region with ``Specification`` on that profile)."""

    def __init__(self, h_m, a, x_min, x_max, y_min=0.0):
        self.h_m, self.a = float(h_m), float(a)
        self.x_min, self.x_max, self.y_min = float(x_min), float(x_max), float(y_min)

    def profile(self, x):
        if self.a == 0.0:
            return np.zeros_like(np.asarray(x, dtype=np.float64))
        return self.h_m * self.a**2 / (np.asarray(x) ** 2 + self.a**2)

    def is_inside(self, x):
        return ((x[..., 0] >= self.x_min) & (x[..., 0] <= self.x_max)
                & (x[..., 1] >= self.y_min) & (x[..., 1] <= self.profile(x[..., 0])))

    def boundarybox(self):
        return Rectangle(self.x_min, self.y_min, self.x_max, self.y_min + max(self.h_m, 0.0))
