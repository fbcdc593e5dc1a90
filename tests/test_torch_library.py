"""The port's library surface against the JAX package on the CPU: the
kernel functions, the shapes and lattices, ``algebra``, ``utils.fixpa``,
``utils.entropy``, ``ops.apply.point_sum``, ``utils.icr`` and
``utils.metrics``.

What is compared, and at which tolerance (inputs from seeded NumPy
generators, float64 unless stated):

* every kernel function, on r in [0, 1.2 h] with a scalar h and with a
  per-pair h: rtol 1e-14 (the same operations in the same order; a power
  may differ in its last bit between ``torch.pow`` and XLA);
* ``covering`` of every shape and lattice, the reference's
  ``tests/test_geometry.py`` shapes among them (Vogel, diamond, the
  exponential grid with K = 2, ``Witch(1000, 2000, -10e3, 10e3)``) at
  coarser spacings: ``assert_array_equal`` (the same NumPy); the grid
  factory's refusals;
* ``algebra`` on batched 2×2 / 3×3 matrices and 3-vectors: rtol 1e-14,
  but ``det``, ``inv`` and ``cof`` at rtol 1e-12: they factorise (LAPACK's
  LU in PyTorch, XLA's in JAX), and the two round differently (measured:
  det 1.6e-14, inv and cof 1.3e-13 of an entry);
* ``rev_add``: bit for bit against the reference and its own inverse;
* ``entropy``: the histogram, the entropy and the MB fit on the same
  arrays, and the histogram of the same state as a port state and as a JAX
  state: bit for bit (the same NumPy);
* ``point_sum`` on a flat float64 state (and a float32 bucket state), with
  probes inside, on the domain's edge and outside the grid: rtol 1e-12
  (measured: at most 4.3e-16; the float32 bucket state at rtol 1e-5);
* ``icr.renormalize`` on a 121-particle state: positions within 1e-10 of
  the reference's (measured: at most 2.0e-14), the same residual history within rtol 1e-8 (atol
  1e-12 × the target 1/dr²: the last residual, 1.1e-10, is the roundoff
  of a sum of ~100);
* the ``metrics`` timer and profiler session on the CPU.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_mountain_waves_tpu as J
import sph_mountain_waves_tpu.algebra as jalg
import sph_mountain_waves_tpu.kernels as jk
from sph_mountain_waves_tpu.ops.apply import point_sum as jpoint_sum
from sph_mountain_waves_tpu.utils import entropy as jent
from sph_mountain_waves_tpu.utils import fixpa as jfix
from sph_mountain_waves_tpu.utils.icr import renormalize as jrenormalize

import sph_mountain_waves_tpu_torch as T
import sph_mountain_waves_tpu_torch.algebra as talg
import sph_mountain_waves_tpu_torch.kernels as tk
from sph_mountain_waves_tpu_torch.interop import state_from_numpy
from sph_mountain_waves_tpu_torch.ops.apply import point_sum as tpoint_sum
from sph_mountain_waves_tpu_torch.utils import entropy as tent
from sph_mountain_waves_tpu_torch.utils import fixpa as tfix
from sph_mountain_waves_tpu_torch.utils import metrics as tmetrics
from sph_mountain_waves_tpu_torch.utils.icr import renormalize as trenormalize
from torch_reference_harness import QUICK_COMPILE

torch.set_num_threads(1)

KERNELS = ["wendland1", "Dwendland1", "rDwendland1",
           "wendland2", "Dwendland2", "rDwendland2",
           "wendland3", "Dwendland3", "rDwendland3", "DDwendland3",
           "spline23", "Dspline23", "rDspline23",
           "spline24", "Dspline24", "rDspline24"]


@pytest.mark.parametrize("name", KERNELS)
def test_kernel_function_matches_jax(name):
    rng = np.random.default_rng(KERNELS.index(name))
    h = 0.37
    r = np.concatenate([[0.0, 0.2 * h, 0.5 * h, 0.6 * h, h, 1.1 * h],
                        rng.uniform(0.0, 1.2 * h, 2000)])
    hs = rng.uniform(0.3, 0.45, r.shape)
    for hh in (h, hs):
        want = np.asarray(getattr(jk, name)(jnp.asarray(hh), jnp.asarray(r)))
        h_t = torch.as_tensor(hh) if isinstance(hh, np.ndarray) else hh
        got = getattr(tk, name)(h_t, torch.as_tensor(r)).numpy()
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0.0)


def _rot(t):
    return np.array([[np.cos(t), -np.sin(t), 0.0],
                     [np.sin(t), np.cos(t), 0.0],
                     [0.0, 0.0, 1.0]])


def _shapes(P):
    """name -> (grid, shape) built from package P (the port or the JAX
    package)."""
    n2, n3 = 1 / 50, 1 / 25
    ellipse = P.Ellipse(0.0, 0.0, 4.0, 1.0)
    tool = P.Rectangle(0.0, -1.0, 4.0, 1.0)
    spline = [(np.cos(t), np.sin(t))
              for t in np.linspace(0, 2 * np.pi, 8, endpoint=False)]
    return {
        "circle_square": (P.Grid(n2, "square"), P.Circle(0.0, 0.0, 1.0)),
        "rectangle_hexagonal": (P.Grid(n2, "hexagonal"),
                                P.Rectangle(0.0, -1.0, 2.0, 5.0)),
        "ellipse_vogel": (P.Grid(n2, "vogel"), ellipse),
        "difference_square": (P.Grid(n2, "square"), ellipse - tool),
        "intersection_hexagonal": (P.Grid(n2, "hexagonal"), ellipse * tool),
        "union_vogel": (P.Grid(n2, "vogel"),
                        (ellipse - tool) + ellipse * tool),
        "specification_square": (P.Grid(n2, "square"), P.Specification(
            P.Rectangle(-4.0, -1.0, 4.0, 1.0),
            lambda x: x[..., 1] < np.cos(np.pi * x[..., 0]))),
        "transform_hexagonal": (P.Grid(n2, "hexagonal"), P.Transform(
            P.Rectangle(0.0, -1.0, 2.0, 5.0), A=_rot(np.pi / 7),
            b=np.array([-2.0, 0.0, 0.0]))),
        "polygon_vogel": (P.Grid(n2, "vogel"),
                          P.Polygon((-1.0, 0.0), (2.0, 0.0), (0.0, 3.0))),
        "closed_spline_square": (P.Grid(n2, "square"),
                                 P.ClosedSpline(*spline, n=128)),
        "exp_K2": (P.Grid(0.01, "exp", K=2.0), P.Rectangle(0.0, 0.0, 1.0, 1.0)),
        "witch": (P.Grid(100.0, "square"), P.Witch(1000.0, 2000.0, -10e3, 10e3)),
        "boundary_layer_hexagonal": (P.Grid(n2, "hexagonal"), P.BoundaryLayer(
            P.Circle(0.0, 0.0, 0.5), P.Grid(n2, "hexagonal"), 0.1)),
        "box_cubic": (P.Grid(n3, "cubic"),
                      P.Box(-0.7, -0.6, -0.5, 0.7, 0.6, 0.5)),
        "ball_facecentered": (P.Grid(n3, "facecentered"),
                              P.Ball(0.0, 0.0, 0.0, 0.8)),
        "ellipsoid_bodycentered": (P.Grid(n3, "bodycentered"),
                                   P.Ellipsoid(0.0, 0.0, 0.0, 0.8, 0.5, 0.3)),
        "cone_diamond": (P.Grid(n3, "diamond"),
                         P.Cone(0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.6, 0.3)),
        "revolution_cubic": (P.Grid(n3, "cubic"), P.RevolutionBody(
            P.Polygon((0.0, 0.0), (0.6, 0.0), (0.0, 0.7)))),
        "expgrid_alias": (P.Expgrid(0.05, 1.5), P.Circle(0.5, 0.5, 0.4)),
    }


SHAPES = list(_shapes(J))


@pytest.mark.parametrize("case", SHAPES)
def test_covering_matches_jax(case):
    jgrid, jshape = _shapes(J)[case]
    tgrid, tshape = _shapes(T)[case]
    want = J.covering(jgrid, jshape)
    got = T.covering(tgrid, tshape)
    assert len(want) > 0
    np.testing.assert_array_equal(got, want)
    assert T.dimension(tgrid) == J.dimension(jgrid)
    jb, tb = J.boundarybox(jshape), T.boundarybox(tshape)
    np.testing.assert_array_equal(tb.mins, jb.mins)
    np.testing.assert_array_equal(tb.maxs, jb.maxs)
    pts = np.random.default_rng(1).uniform(-1.5, 1.5, (500, 3))
    if case == "witch":
        pts = pts * np.array([8e3, 1e3, 0.0])
    np.testing.assert_array_equal(T.is_inside(pts, tshape),
                                  J.is_inside(pts, jshape))


def test_grid_factory_refusals_and_witch_points():
    for bad in (lambda P: P.Grid(0.1, "triangular"),
                lambda P: P.Grid(0.1, "exp")):
        with pytest.raises(ValueError):
            bad(J)
        with pytest.raises(ValueError):
            bad(T)
    with pytest.raises(ValueError):
        T.Circle(0.0, 0.0, 0.0)
    w = T.Witch(1000.0, 2000.0, -10e3, 10e3)
    assert T.is_inside([0.0, 500.0], w) and not T.is_inside([0.0, 1500.0], w)
    assert T.is_inside([2000.0, 499.0], w)


ALGEBRA = ["dot_vec", "dot_mat", "norm_vec", "norm_mat", "outer", "trace",
           "dev", "det", "trans", "cof", "inv", "constructors"]


@pytest.mark.parametrize("op", ALGEBRA)
def test_algebra_matches_jax(op):
    rng = np.random.default_rng(ALGEBRA.index(op))
    a3, b3 = rng.normal(size=(2, 50, 3))
    m3 = rng.normal(size=(50, 3, 3)) + 3 * np.eye(3)
    n3 = rng.normal(size=(50, 3, 3))
    m2 = rng.normal(size=(50, 2, 2)) + 2 * np.eye(2)

    def both(fn, *args):
        want = np.asarray(getattr(jalg, fn)(*[jnp.asarray(a) for a in args]))
        got = getattr(talg, fn)(*[torch.as_tensor(a) for a in args]).numpy()
        assert got.dtype == np.float64
        rtol = 1e-12 if fn in ("det", "inv", "cof") else 1e-14
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-14)

    if op == "dot_vec":
        both("dot", a3, b3)
        both("dot", a3, talg.VECX)
    elif op == "dot_mat":
        both("dot", m3, n3)
    elif op == "norm_vec":
        both("norm", a3)
    elif op == "norm_mat":
        both("norm", m3)
        both("norm", m2)
    elif op == "outer":
        both("outer", a3, b3)
    elif op in ("trace", "dev", "det", "trans", "cof", "inv"):
        both(op, m3)
        both(op, m2)
    else:
        for fn, args in (("RealVector", (1.5, -2.0)),
                         ("RealVector", (1.5, -2.0, 0.25)),
                         ("RealMatrix", tuple(range(9))),
                         ("FlatMatrix", (1.0, 2.0, 3.0, 4.0))):
            want = np.asarray(getattr(jalg, fn)(*args))
            got = getattr(talg, fn)(*args)
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got.numpy(), want)
        # batched components take the tensor's dtype
        xs = torch.as_tensor(a3[:, 0], dtype=torch.float32)
        assert talg.RealVector(xs, 0.5).dtype == torch.float32
        assert talg.dot(xs[:, None] * torch.ones(3), talg.VECY).dtype == torch.float32
        for c in ("VECX", "VECY", "VECZ", "VEC0", "MAT0", "MAT1", "FMAT0",
                  "FMAT1"):
            np.testing.assert_array_equal(getattr(talg, c), getattr(jalg, c))


def test_rev_add_is_bitwise_and_invertible():
    rng = np.random.default_rng(3)
    x = np.concatenate([[0.123456, -2.5, 7.0, 0.5 * jfix.FIXPA_EPS,
                         1.5 * jfix.FIXPA_EPS, -0.5 * jfix.FIXPA_EPS],
                        rng.normal(0, 10, 2000)])
    y = rng.normal(0, 1e-3, x.shape)
    assert tfix.FIXPA_EPS == jfix.FIXPA_EPS == 2.0**-30
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    np.testing.assert_array_equal(tfix.nom(xt).numpy(),
                                  np.asarray(jfix.nom(jnp.asarray(x))))
    s = tfix.rev_add(xt, yt)
    np.testing.assert_array_equal(
        s.numpy(), np.asarray(jfix.rev_add(jnp.asarray(x), jnp.asarray(y))))
    z = tfix.rev_add(s, -yt)
    np.testing.assert_array_equal(
        z.numpy(), jfix.FIXPA_EPS * np.round(x / jfix.FIXPA_EPS))


def test_entropy_matches_jax():
    rng = np.random.default_rng(0)
    m, beta_true = 1.0e-3, 2.0
    v = rng.normal(0, 1.0 / np.sqrt(m * beta_true), size=(20000, 2))
    for vm in (0.0, 150.0):
        jh = jent.velocity_histogram(v, v_max=vm, N=100)
        th = tent.velocity_histogram(torch.as_tensor(v), v_max=vm, N=100)
        np.testing.assert_array_equal(th.xs, jh.xs)
        np.testing.assert_array_equal(th.ys, jh.ys)
        assert th.dx == jh.dx and th.N == jh.N
        assert tent.entropy_2D_MB(th) == jent.entropy_2D_MB(jh)
        assert (tent.fit_maxwell_boltzmann(th, m)
                == jent.fit_maxwell_boltzmann(jh, m))
    beta, _ = tent.fit_maxwell_boltzmann(tent.velocity_histogram(v), m)
    assert beta == pytest.approx(beta_true, rel=0.1)

    # the same state as a port state and as a JAX state
    active = rng.random(3000) < 0.8
    fields = {"x": rng.normal(size=(3000, 2)),
              "v": np.where(active[:, None], rng.normal(size=(3000, 2)), 0.0)}
    jstate = J.ParticleState(fields={k: jnp.asarray(a) for k, a in fields.items()},
                             active=jnp.asarray(active))
    tstate = state_from_numpy(fields, active, "cpu")
    jh = jent.velocity_histogram(jstate, N=100)
    th = tent.velocity_histogram(tstate, N=100)
    np.testing.assert_array_equal(th.ys, jh.ys)
    assert tent.entropy_2D_MB(th) == jent.entropy_2D_MB(jh)


def _cloud(P, dtype):
    """A seeded cloud of 400 particles with masses in the unit square (the
    two packages' systems from the same NumPy)."""
    rng = np.random.default_rng(5)
    xs = rng.uniform(0.0, 1.0, (400, 2))
    sys = P.ParticleSystem(fields={"x": 2, "m": 0}, domain=P.Rectangle(
        0.0, 0.0, 1.0, 1.0), h=0.2, dim=2, dtype=dtype)
    sys.add_particles(xs, {"m": rng.uniform(0.5, 1.5, 400)})
    return sys


@pytest.mark.parametrize("layout", ["flat-f64", "bucket-f32"])
def test_point_sum_matches_jax(layout):
    lay, dt = layout.split("-")
    js = _cloud(J, jnp.float64 if dt == "f64" else jnp.float32)
    ts = _cloud(T, torch.float64 if dt == "f64" else torch.float32)
    opts = {"layout": lay, "skin": 0.25}
    jstate = js.freeze(**opts)
    tstate = ts.freeze(device="cpu", **opts)
    tstate, tnbrs = ts.engine.rebuild(tstate)
    assert ts.engine.cell_size == js.engine.cell_size
    assert ts.engine.lims == js.engine.lims
    # inside, on the domain's edges and corners, outside the grid
    probes = np.array([[0.5, 0.5], [0.1, 0.9], [0.33, 0.66], [0.95, 0.05],
                       [0.0, 0.0], [1.0, 1.0], [0.0, 0.5], [1.0, 0.25],
                       [-0.05, 0.5], [1.1, 1.1], [0.5, -0.19], [-3.0, 7.0]])

    def fn(q, r, s):
        return q.m * (0.2 - r) * s

    # the reference's rebuild and point_sum in one function, compiled
    # (eagerly its first-use compiles cost seconds)
    want = np.asarray(jax.jit(lambda st: jpoint_sum(
        js.engine, *js.engine.rebuild(st), fn, probes, s=2.0)).lower(
            jstate).compile(compiler_options=QUICK_COMPILE)(jstate))
    got = tpoint_sum(ts.engine, tstate, tnbrs, fn, probes, s=2.0)
    assert got.dtype == tstate.fields["x"].dtype
    rtol = 1e-12 if dt == "f64" else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0.0)
    assert want[-1] == 0.0 and np.all(want[:8] > 0.0)
    # one point, not a batch
    one = tpoint_sum(ts.engine, tstate, tnbrs, fn, probes[0], s=2.0)
    np.testing.assert_allclose(one.numpy(), want[:1], rtol=rtol)


def test_icr_renormalize_matches_jax():
    dr = 0.1
    h = 2.4 * dr
    states = []
    for P, dt, dev in ((J, jnp.float64, None), (T, torch.float64, "cpu")):
        dom = P.Rectangle(0.0, 0.0, 1.0, 1.0)
        sys = P.ParticleSystem(fields={"x": 2}, domain=dom, h=h, dim=2,
                               dtype=dt)
        sys.freeze_opts = {"layout": "flat"}
        P.generate_particles(sys, P.Grid(dr, "square"), dom, lambda xs: {})
        st = sys.freeze() if dev is None else sys.freeze(device=dev)
        states.append((sys, st))
    (js, jst), (ts, tst) = states
    jout, jinfo = jrenormalize(js.engine, jst, dr, max_steps=6, jitter=0.3,
                               return_info=True)
    tout, tinfo = trenormalize(ts.engine, tst, dr, max_steps=6, jitter=0.3,
                               return_info=True)
    xj = np.asarray(jout.fields["x"])
    xt = tout.fields["x"].numpy()
    assert tout.fields["x"].dtype == torch.float64 and xt.shape == xj.shape
    assert int(tout.active.sum()) == 121
    np.testing.assert_allclose(xt, xj, rtol=0.0, atol=1e-10)
    # the residual |Σw − 1/dr²| falls to ~1e-10 of Σw ≈ 100: its last
    # value is roundoff of that sum
    np.testing.assert_allclose(tinfo["errs"], jinfo["errs"], rtol=1e-8,
                               atol=1e-12 / dr**2)
    assert tinfo["errs"][-1] < 1e-2 * tinfo["errs"][0]


def test_metrics_timer_and_trace(tmp_path):
    timer = tmetrics.StepTimer()
    for n_steps in (3, 5):
        timer.start()
        x = torch.ones(1000, dtype=torch.float64)
        for _ in range(n_steps):
            x = x * 1.0001
        dt = timer.stop(n_steps, 1000, sync_array=x)
        assert dt > 0.0
    series = timer.series
    assert series.shape == (2, 3) and list(series[:, 0]) == [3, 5]
    want = 8 * 1000 / series[:, 2].sum()
    assert timer.particle_steps_per_sec == pytest.approx(want)
    assert tmetrics.StepTimer().particle_steps_per_sec == 0.0

    logdir = str(tmp_path / "trace")
    with tmetrics.trace(logdir):
        torch.ones(10) + 1
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
