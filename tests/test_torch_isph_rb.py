"""The port's ISPH mountain wave and Rayleigh–Bénard convection against the
JAX package on the CPU: the cubic spline, the resident stencil shifts, the
four new sweeps' twins, the multigrid preconditioner, the steps, the runs
and the figures.

Sizes (the reference's own Pallas-vs-XLA gates, tests/test_pallas.py):
``ISPHWitchConfig(n_rows=10, layout="bucket", skin=0.2)`` in float32 (N =
3,514, grid 128 × 16, cap 16), kicked with v = 0.1·N(0, 1) on FLUID rows
from ``default_rng(3)``; ``rayleigh_benard.Config(n_rows=16, layout="bucket",
skin=0.2)`` (N = 773). (Not ``isph_witch.baseline_config(n_rows=12)``: the
reference's mg solve gives NaN on that state.)

What is compared, and at which tolerance:

* the twins of ``isph_div_visc_pass``, ``isph_grad_pass``,
  ``isph_matvec_prepared`` (on a seeded iterate) and ``rb_mass_heat_pass``
  (conducting and adiabatic sidewalls) against the reference's own pair
  bodies summed eagerly in the Pallas harness's order
  (tests/torch_reference_harness.py; the matvec through its
  ``make_pair_kernel_fn`` capture): rtol 1e-5, atol 1e-6 × the output's
  largest |value|;
* ``coarse_stencil_2d`` on the kicked state and the V-cycle on the
  reference's 12 × 20 model stencil (float64) against the reference's at
  rtol 1e-5; the V-cycle's SPD gates as the reference's tests/test_mg.py
  (symmetry < 1e-10, λ_min > 0, cond(M·A) < 12);
* CG iterations of the first kicked step, mg and Jacobi, within ±10 % (or
  ±2) of the reference's, and mg fewer than Jacobi;
* 4 kicked ISPH steps against the reference's XLA bucket path (compiled once
  with ``QUICK_COMPILE``, tests/torch_reference_harness.py): mean and max |v| at rtol 2e-3, mean |P| at
  rel 0.1 (the f32 CG stalls near rel_res 7e-3, so P is path-dependent),
  equal active counts; 6 Rayleigh–Bénard steps against the reference's flat
  XLA path (its bucket path costs three times the compile and agrees with
  it to all printed digits): rtol 1e-4, atol 1e-8 on mean |v|, max |v|, mean
  T and max |ρ − ρ0|, equal active counts;
* ``run(cfg, out_path=..., device="cpu")`` of both: the file set, the
  ``data.csv`` columns, the sparklines of ``live_plot`` and a resumed run bit
  for bit equal to the uninterrupted one (ISPH also on the flat layout in
  float64);
* ``ops/solvers.py`` on a flat float64 state in 2-D (the ISPH state at
  n_rows 8 on an 80 km domain with 3 fence rows, kicked: N = 405, flat grid
  18 × 9, cap 8) and in 3-D
  (witch3d at the reference's TINY: N = 1,603, 12 × 5 × 8, cap 16):
  ``assemble_vector``, ``assemble_matvec`` with and without the diagonal
  (a coefficient of r and of both particles' fields, on a seeded vector),
  ``assemble_matrix``, ``assemble_matrix_bcoo`` (its pattern exactly, its
  values and its dense form) and ``cg_solve`` with the Jacobi
  preconditioner on the state's matrix made SPD (diagonally dominant),
  against the reference's own functions: within 1e-12 of the largest
  |value|;
* the ISPH step on the flat layout from the 2-D solver state above, kicked,
  4 steps against the reference's own flat steps (compiled with
  ``QUICK_COMPILE``), rows matched by position: float64 with the default
  ``precond="mg"``, which both packages announce with the same
  ``RuntimeWarning`` and solve with Jacobi (a step with
  ``precond="jacobi"`` gives the same P bit for bit): cg_it equal every
  step (71, 44, 52, 52), P and v within 1e-9 of their largest |value|
  (measured: 6.7e-12 and 7.0e-12); float32 with Jacobi against the same
  float64 reference run, at the gate of the bucket path above (mean/max
  |v| at rtol 2e-3, mean |P| at rel 0.1, cg_it within ±2), since the f32
  CG's path depends on roundoff (the reference's static and projection
  gates run on the card, ``chip_smoke.py`` phase 42);
* ``utils/rkpm.py`` on a seeded flat float64 Rayleigh–Bénard state
  (n_rows 16, N = 773): the moment matrix, the correction vector, the
  corrected sum and the RB-form corrected Laplacian against the reference's
  (1e-12 of the largest |value|, the Laplacian 1e-9); the partition of
  unity and the quadratic reproduction of tests/test_rkpm.py in float32 and
  float64; 8 flat float64 steps of ``Config(conduction="rkpm")`` against
  the reference's step at the flat steps' gate (rtol 1e-8, fields within
  1e-8 of their largest |value|);
* ``utils/plots.py``: the files ``tests/test_plots.py`` gates.
"""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_mountain_waves_tpu.ops.pallas_pairs as pp
from sph_mountain_waves_tpu import kernels as jk
from sph_mountain_waves_tpu.models import isph_witch as jiw
from sph_mountain_waves_tpu.models import rayleigh_benard as jrb
from sph_mountain_waves_tpu.models import witch3d as jw3
from sph_mountain_waves_tpu.ops import mg as jmg
from sph_mountain_waves_tpu.ops import solvers as jsolvers
from sph_mountain_waves_tpu.ops.solvers import assemble_matvec, pcg as jpcg
from sph_mountain_waves_tpu.structs import ParticleState as JState

from sph_mountain_waves_tpu_torch import kernels as tk
from sph_mountain_waves_tpu_torch.interop import state_from_numpy
from sph_mountain_waves_tpu_torch.io import read_csv, read_vtp
from sph_mountain_waves_tpu_torch.models import isph_witch as tiw
from sph_mountain_waves_tpu_torch.models import rayleigh_benard as trb
from sph_mountain_waves_tpu_torch.models import witch3d as tw3
from sph_mountain_waves_tpu_torch.ops import mg as tmg
from sph_mountain_waves_tpu_torch.ops import pair_sweeps as tps
from sph_mountain_waves_tpu_torch.ops import solvers as tsolvers
from sph_mountain_waves_tpu_torch.utils import plots as tplots
from scipy.spatial import cKDTree
from torch_reference_harness import (
    QUICK_COMPILE, matched_rows, reference_body_sweep,
    reference_prepared_sweep,
)

torch.set_num_threads(1)

ISPH = dict(n_rows=10, dtype="float32", layout="bucket", skin=0.2)
ISPH_SMALL = dict(n_rows=8, dom_length=80e3, bc_rows=3, layout="flat",
                  dtype="float64")
TINY3D = dict(n_rows=6, dom_length=60e3, dom_depth=10e3, bc_rows=3,
              self_density=True, dtype="float64", layout="flat")
RB = dict(n_rows=16, dtype="float32", layout="bucket", skin=0.2)
RTOL, ATOL_REL = 1e-5, 1e-6


def _fields(jstate):
    return ({k: np.asarray(v) for k, v in jstate.fields.items()},
            np.asarray(jstate.active))


def _jstate(fields, active):
    return JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                  active=jnp.asarray(active))


def _check(got, ref, active):
    ref = np.asarray(ref)
    got = got.numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())
    assert np.all(got[~active] == 0.0)
    assert np.abs(ref).max() > 0.0


# ------------------------------------------------------------------ ISPH

@pytest.fixture(scope="module")
def isph():
    """(JAX engine, port engine, kicked fields, active) from one build."""
    jsys = jiw.make_system(jiw.ISPHWitchConfig(**ISPH, use_pallas=False))
    fields, active = _fields(jsys.freeze())
    rng = np.random.default_rng(3)
    fluid = (fields["type"] == 0.0)[:, None]
    fields["v"] = np.where(
        fluid, 0.1 * rng.standard_normal(fields["v"].shape),
        fields["v"]).astype(np.float32)
    tsys = tiw.make_system(tiw.ISPHWitchConfig(**ISPH, use_pallas=True))
    tsys.freeze(device="cpu")
    je, te = jsys.engine, tsys.engine
    assert (te.cap, te.lims, te.phase) == (je.cap, je.lims, je.phase)
    assert (te.cap, te.lims, int(active.sum())) == (16, (128, 16), 3514)
    return je, te, fields, active


@pytest.fixture(scope="module")
def isph_ref(isph):
    """The reference's 4 kicked steps (XLA bucket path, mg): per-step
    cg_it, the state after step 1 and after step 4."""
    je, _, fields, active = isph
    cfg = jiw.ISPHWitchConfig(**ISPH, use_pallas=False)
    js = jiw.make_system(cfg)
    js.freeze()
    state = _jstate(fields, active)
    step = jax.jit(jiw.make_step(cfg, js.engine)).lower(state).compile(
        compiler_options=QUICK_COMPILE)
    its, states = [], []
    for _ in range(4):
        state = step(state)
        its.append(int(state.fields["cg_it"][0]))
        states.append(state)
    return js.engine, its, states


@pytest.fixture(scope="module")
def isph_port(isph):
    """The port's 4 kicked steps on the CPU twins: per-step cg_it and the
    final state."""
    _, _, fields, active = isph
    cfg = tiw.ISPHWitchConfig(**ISPH, use_pallas=True)
    ts = tiw.make_system(cfg)
    ts.freeze(device="cpu")
    state = state_from_numpy(fields, active, "cpu")
    step = tiw.make_step(cfg, ts.engine)
    its = []
    for _ in range(4):
        state = step(state)
        its.append(int(state.fields["cg_it"][0]))
    return its, state


def _isph_live(isph):
    """The kicked state with a seeded pressure and a 1 % jitter of the
    positions, both packages' states."""
    je, te, fields, active = isph
    fields = dict(fields)
    rng = np.random.default_rng(5)
    n = active.shape[0]
    fields["P"] = np.where(active, rng.uniform(-50.0, 50.0, n),
                           0.0).astype(np.float32)
    jit = rng.uniform(-0.01, 0.01, fields["x"].shape) * (te.h / 1.8)
    fields["x"] = np.where(active[:, None], fields["x"] + jit,
                           0.0).astype(np.float32)
    return (je, _jstate(fields, active), te,
            state_from_numpy(fields, active, "cpu"))


@pytest.mark.parametrize("name", ["div_visc", "grad", "matvec"])
def test_isph_twin_matches_reference_body(isph, name, monkeypatch):
    je, jst, te, tst = _isph_live(isph)
    cfg = tiw.ISPHWitchConfig(**ISPH, use_pallas=True)
    jcfg = jiw.ISPHWitchConfig(**ISPH, use_pallas=True)
    active = tst.active.numpy()
    if name == "matvec":
        rng = np.random.default_rng(7)
        v = np.where(active, rng.standard_normal(active.shape),
                     0.0).astype(np.float32)
        mv, captured = reference_prepared_sweep(pp.isph_matvec_prepared, je,
                                                jst, jcfg, monkeypatch)
        assert captured["n_dyn"] == 1 and len(captured["static"]) == 2
        refs = [mv(jnp.asarray(v))]
        before = tps.isph_matvec_pass.launches
        mv_t = tps.isph_matvec_prepared(te, tst, cfg)
        gots = [mv_t(torch.as_tensor(v))]
        # the one-shot form is the prepared one
        assert torch.equal(tps.isph_matvec_pass(te, tst, cfg,
                                                torch.as_tensor(v)), gots[0])
        assert tps.isph_matvec_pass.launches == before
    else:
        jpass, tpass = {"div_visc": (pp.isph_div_visc_pass,
                                     tps.isph_div_visc_pass),
                        "grad": (pp.isph_grad_pass, tps.isph_grad_pass)}[name]
        refs, captured = reference_body_sweep(jpass, je, jst, jcfg,
                                              monkeypatch)
        counter = {"div_visc": tps.isph_div_visc_pass,
                   "grad": tps.isph_grad_pass}[name]
        before = counter.launches
        gots = tpass(te, tst, cfg)
        assert counter.launches == before  # CPU tensors: the twin
    assert captured["self_pair"] is False
    assert len(gots) == len(refs) == {"div_visc": 5, "grad": 2, "matvec": 1}[name]
    for got, ref in zip(gots, refs):
        _check(got, ref, active)


def test_spline23_and_resident_shifts_match_jax(isph):
    """The cubic spline family on both branches and the stencil shifts of
    a resident field, against the reference's."""
    r = np.linspace(0.0, 1.2, 97, dtype=np.float32)
    for name in ("spline23", "Dspline23", "rDspline23"):
        ref = np.asarray(getattr(jk, name)(0.9, jnp.asarray(r)))
        got = getattr(tk, name)(0.9, torch.as_tensor(r)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg=name)
    je, te, fields, active = isph
    for arr in (fields["x"].copy(), active.astype(np.float32)):
        jB, tB = je.resident(jnp.asarray(arr)), te.resident(torch.as_tensor(arr))
        for off in ((-1, 1), (1, 0), (0, 0)):
            np.testing.assert_array_equal(te.shift_resident(tB, off).numpy(),
                                          np.asarray(je.shift_resident(jB, off)))


def test_coarse_stencil_matches_jax(isph):
    """The Galerkin coarse stencil of the ISPH operator on the kicked state
    (f32), with a seeded particle diagonal; and its hierarchy's levels."""
    je, te, fields, active = isph
    cfg = tiw.ISPHWitchConfig(**ISPH)
    h, vol = cfg.h0, cfg.dr**2
    rng = np.random.default_rng(0)
    diag = np.where(active, rng.standard_normal(active.shape),
                    0.0).astype(np.float32)
    jstate = _jstate(fields, active)
    W_ref = np.asarray(jax.jit(lambda st, d: jmg.coarse_stencil_2d(
        je, st, lambda r: 2.0 * h**2 * vol * jk.rDspline23(h, r), d)).lower(
        jstate, jnp.asarray(diag)).compile(compiler_options=QUICK_COMPILE)(
        jstate, jnp.asarray(diag)))
    W = tmg.coarse_stencil_2d(
        te, state_from_numpy(fields, active, "cpu"),
        lambda r: 2.0 * h**2 * vol * tk.rDspline23(h, r),
        torch.as_tensor(diag))
    assert W.shape == (3, 3, 16, 128) and W.dtype == torch.float32
    scale = np.abs(W_ref).max()
    np.testing.assert_allclose(W.numpy(), W_ref, rtol=RTOL,
                               atol=ATOL_REL * scale)
    # 16 × 128 → 8 × 64 → 4 × 32: coarsened while the short side exceeds 4
    vc = tmg.GridVcycle(W)
    assert [tuple(Wt.shape) for Wt in vc.Wts] == [(16, 128, 9), (8, 64, 9),
                                                  (4, 32, 9)]


def test_vcycle_symmetric_positive_definite():
    """The reference's SPD gate on its 12 × 20 model stencil (5-point
    Laplacian + mass term) in float64, and the V-cycle's output on a seeded
    grid against the reference's at rtol 1e-5."""
    ny, nx = 12, 20
    W = np.zeros((3, 3, ny, nx))
    W[1, 1] = 4.4
    W[1, 0] = W[1, 2] = W[0, 1] = W[2, 1] = -1.0
    vc = tmg.GridVcycle(torch.as_tensor(W))
    Wt = tmg._taps_last(torch.as_tensor(W))
    n = ny * nx
    eye = torch.eye(n, dtype=torch.float64).reshape(n, ny, nx)
    M = np.stack([vc.apply(e).numpy().ravel() for e in eye], axis=1)
    A = np.stack([tmg._stencil_apply(Wt, e).numpy().ravel() for e in eye],
                 axis=1)
    assert np.abs(M - M.T).max() < 1e-10
    assert np.linalg.eigvalsh(0.5 * (M + M.T)).min() > 0
    cond = np.linalg.eigvalsh(M @ A)
    assert cond.real.max() / cond.real.min() < 12.0
    rng = np.random.default_rng(2)
    u = rng.standard_normal((ny, nx))
    jW, ju = jnp.asarray(W), jnp.asarray(u)
    ref = jax.jit(lambda W, u: jmg.GridVcycle(W).apply(u)).lower(
        jW, ju).compile(compiler_options=QUICK_COMPILE)(jW, ju)
    np.testing.assert_allclose(vc.apply(torch.as_tensor(u)).numpy(),
                               np.asarray(ref), rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(
        tmg._stencil_apply(Wt, torch.as_tensor(u)).numpy(),
        np.asarray(jmg._stencil_apply(jnp.asarray(W), jnp.asarray(u))),
        rtol=1e-12, atol=1e-12)


def _reference_jacobi_iterations(isph, isph_ref):
    """The reference's first kicked solve with the Jacobi preconditioner:
    its own operator and ``pcg`` on the system of step 1 (x, L, λ and the
    divergence are unchanged after the solve; x0 is the input's P). The
    rebuild runs eagerly (compiling it would compile the rescatter it does
    not take), the solve compiled."""
    _, _, fields, active = isph
    je, _, states = isph_ref
    cfg = jiw.ISPHWitchConfig(**ISPH, use_pallas=False, precond="jacobi")
    step = jiw.make_step(cfg, je)
    offdiag = dict(zip(step.__code__.co_freevars,
                       step.__closure__))["offdiag"].cell_contents
    h, dt = cfg.h0, cfg.dt_isph
    with jax.disable_jit():
        state, nbrs = je.rebuild(states[0])

    def solve(state, nbrs, x0):
        f = state.fields
        diag = h**2 * f["L"] + jnp.where(
            f["type"] == 0.0, cfg.C_free * jnp.maximum(f["lam"], 0.0), 0.0)
        mv_off = assemble_matvec(je, state, nbrs, offdiag, include_self=False)
        diag_safe = jnp.where(jnp.abs(diag) > 1e-30, diag, 1.0)
        b = jnp.where(state.active, -h**2 * f["div"] / dt, 0.0)
        return jpcg(
            lambda v: mv_off(v) + jnp.where(state.active, diag * v, 0.0), b,
            x0=x0, M=lambda v: v / diag_safe, tol=cfg.cg_tol, atol=1e-18,
            maxiter=cfg.cg_maxiter, return_info=True)[1]

    x0 = jnp.asarray(fields["P"])
    return int(jax.jit(solve).lower(state, nbrs, x0).compile(
        compiler_options=QUICK_COMPILE)(state, nbrs, x0))


def test_mg_and_jacobi_iteration_counts_match_jax(isph, isph_ref, isph_port):
    """The first kicked solve: the port's mg and Jacobi iteration counts
    each within ±10 % (or ±2) of the reference's, and mg fewer. The
    symmetrized multiplicative form ("mg_mult") converges too, in no more
    iterations than the additive one, to the Jacobi solve's mean |v| (rtol
    2e-3)."""
    _, _, fields, active = isph
    port_mg, ref_mg = isph_port[0][0], isph_ref[1][0]
    first = {}
    for precond in ("jacobi", "mg_mult"):
        cfg = tiw.ISPHWitchConfig(**ISPH, use_pallas=True, precond=precond)
        ts = tiw.make_system(cfg)
        ts.freeze(device="cpu")
        first[precond] = tiw.make_step(cfg, ts.engine)(
            state_from_numpy(fields, active, "cpu"))
        assert float(first[precond].fields["cg_res"][0]) < 1e-4
    port_jac = int(first["jacobi"].fields["cg_it"][0])
    ref_jac = _reference_jacobi_iterations(isph, isph_ref)
    for got, ref in ((port_mg, ref_mg), (port_jac, ref_jac)):
        assert abs(got - ref) <= max(2, 0.1 * ref), (got, ref)
    assert port_mg < port_jac and ref_mg < ref_jac
    mult = first["mg_mult"]
    assert int(mult.fields["cg_it"][0]) <= port_mg
    v = [np.abs(first[k].fields["v"].numpy()[active]) for k in first]
    np.testing.assert_allclose([x.mean() for x in v[1:]],
                               [x.mean() for x in v[:1]], rtol=2e-3)


def test_four_kicked_steps_match_jax(isph_ref, isph_port):
    """The reference's own Pallas-vs-XLA gate: mean/max |v| at rtol 2e-3,
    mean |P| at rel 0.1, equal active counts; the per-step iteration counts
    within ±2."""
    _, jits, jstates = isph_ref
    tits, tstate = isph_port
    jstate = jstates[-1]
    ja = np.asarray(jstate.active)
    ta = tstate.active.numpy()
    assert int(ta.sum()) == int(ja.sum()) == 3514
    jv = np.abs(np.asarray(jstate.fields["v"])[ja])
    tv = np.abs(tstate.fields["v"].numpy()[ta])
    tP = tstate.fields["P"].numpy()[ta]
    assert np.isfinite(tv).all() and np.isfinite(tP).all()
    np.testing.assert_allclose([tv.mean(), tv.max()], [jv.mean(), jv.max()],
                               rtol=2e-3)
    assert np.abs(tP).mean() == pytest.approx(
        np.abs(np.asarray(jstate.fields["P"])[ja]).mean(), rel=0.1)
    assert all(abs(t - j) <= 2 for t, j in zip(tits, jits)), (tits, jits)


@pytest.mark.parametrize("layout", ["bucket", "flat"],
                         ids=["bucket-f32", "flat-f64"])
def test_isph_run_writes_files_and_resumes_bitwise(tmp_path, capsys, layout):
    """Two frames of one step from rest with a checkpoint every frame, on a
    60 km domain at n_rows=6 (N = 220), on the float32 bucket layout and on
    the float64 flat one; live plots print the sparklines; a run stopped
    after one frame and resumed equals the uninterrupted one bit for bit."""
    kw = (dict(ISPH, use_pallas=True) if layout == "bucket" else
          dict(layout="flat", dtype="float64", precond="jacobi"))
    cfg = tiw.ISPHWitchConfig(**{**kw, "n_rows": 6}, dom_length=60e3,
                              bc_rows=3, n_frames=2,
                              checkpoint_every=1, live_plot=True)
    cfg = dataclasses.replace(cfg, t_end=2 * cfg.dt_isph)
    whole = tiw.run(cfg, out_path=str(tmp_path / "whole"), device="cpu")
    assert "cg_it [" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "whole")) == [
        "checkpoint.npz", "data.csv", "frame0.vtp", "frame1.vtp",
        "frame2.vtp", "result.pvd", "velocities.pdf"]
    csv = read_csv(str(tmp_path / "whole" / "data.csv"))
    assert list(csv) == ["t", "u_avg", "u_max", "cg_it", "cg_res"]
    np.testing.assert_array_equal(csv["cg_it"], whole["cg_it"])
    assert np.all(csv["cg_it"] >= 1) and np.all(np.isfinite(csv["u_max"]))
    pts, data = read_vtp(str(tmp_path / "whole" / "frame2.vtp"))
    assert len(pts) == 220 and sorted(data) == ["P", "theta_p", "type", "v"]
    state = whole["state"]
    assert whole["system"].engine.layout == layout
    assert state.fields["x"].dtype == (torch.float32 if layout == "bucket"
                                       else torch.float64)

    half = dataclasses.replace(cfg, t_end=cfg.t_end / 2, n_frames=1,
                               live_plot=False)
    tiw.run(half, out_path=str(tmp_path / "part"), device="cpu")
    resumed = tiw.run(dataclasses.replace(
        cfg, live_plot=False,
        resume=str(tmp_path / "part" / "checkpoint.npz")),
        out_path=str(tmp_path / "part"), device="cpu")
    for name, ref in whole["state"].fields.items():
        assert torch.equal(resumed["state"].fields[name], ref), name
    assert torch.equal(resumed["state"].active, whole["state"].active)
    merged = read_csv(str(tmp_path / "part" / "data.csv"))
    for name in csv:
        np.testing.assert_array_equal(merged[name], csv[name], err_msg=name)


# ------------------------------------------- the flat layout: the solvers

def _kicked(fields, active, seed=3):
    """v = 0.1·N(0, 1) on FLUID rows, from a seeded generator."""
    fields = dict(fields)
    rng = np.random.default_rng(seed)
    fluid = (fields["type"] == 0.0)[:, None]
    fields["v"] = np.where(fluid, 0.1 * rng.standard_normal(
        fields["v"].shape), fields["v"]).astype(fields["x"].dtype)
    return fields


@pytest.fixture(scope="module", params=["2d", "3d"])
def flat_operands(request):
    """(dim, JAX engine/state/nbrs, port engine/state/nbrs, coefficient
    functions, a seeded vector): the kicked ISPH state in 2-D, witch3d's
    TINY state in 3-D, both flat float64, rebuilt by each package."""
    if request.param == "2d":
        cfgs = (jiw.ISPHWitchConfig(**ISPH_SMALL),
                tiw.ISPHWitchConfig(**ISPH_SMALL))
        mods = (jiw, tiw)
        kers = (jk.rDspline23, tk.rDspline23)
        field = "rho_bg"
    else:
        cfgs = (jw3.Witch3DConfig(**TINY3D), tw3.Witch3DConfig(**TINY3D))
        mods = (jw3, tw3)
        kers = (jk.rDwendland3, tk.rDwendland3)
        field = "m"
    jsys, tsys = mods[0].make_system(cfgs[0]), mods[1].make_system(cfgs[1])
    fields, active = _fields(jsys.freeze())
    tsys.freeze(device="cpu")
    fields = _kicked(fields, active)
    je, te = jsys.engine, tsys.engine
    assert (te.layout, te.lims, te.cap, te.pair_mode) == (
        je.layout, je.lims, je.cap, je.pair_mode)
    jstate = _jstate(fields, active)
    jstate, jn = jax.jit(je.rebuild).lower(jstate).compile(
        compiler_options=QUICK_COMPILE)(jstate)
    tstate, tn = te.rebuild(state_from_numpy(fields, active, "cpu"))
    h = je.h
    # scaled to O(1) at r = h/2, so that the CG system below is not the
    # identity to roundoff
    scale = 1.0 / abs(float(kers[1](h, torch.tensor(0.5 * h))))

    def coeffs(ker):
        return {"r": lambda p, q, r: scale * ker(h, r),
                "fields": lambda p, q, r: q[field] * ker(h, r)
                * (1.0 + p.v[..., 0] ** 2)}

    v = np.where(active, np.random.default_rng(11).standard_normal(
        active.shape), 0.0)
    return (request.param, (je, jstate, jn, coeffs(kers[0])),
            (te, tstate, tn, coeffs(kers[1])), v)


def _close64(got, want):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.abs(want).max() > 0.0
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=1e-12 * np.abs(want).max())


def test_assemble_vector_matches_jax(flat_operands):
    _, (_, jstate, _, _), (_, tstate, _, _), _ = flat_operands

    def func(u, s):
        return s * u.x[:, 0] * u.v[:, -1] + u.x[:, 1]

    want = jsolvers.assemble_vector(jstate, func, s=2.0)
    got = tsolvers.assemble_vector(tstate, func, s=2.0)
    assert got.dtype == torch.float64
    assert np.all(got.numpy()[~tstate.active.numpy()] == 0.0)
    _close64(got, want)


@pytest.mark.parametrize("include_self", [True, False],
                         ids=["with_diagonal", "off_diagonal"])
def test_assemble_matvec_matches_jax(flat_operands, include_self):
    _, (je, jstate, jn, jc), (te, tstate, tn, tc), v = flat_operands
    want = jsolvers.assemble_matvec(je, jstate, jn, jc["fields"],
                                    include_self=include_self)(jnp.asarray(v))
    got = tsolvers.assemble_matvec(te, tstate, tn, tc["fields"],
                                   include_self=include_self)(
        torch.as_tensor(v))
    assert np.all(got.numpy()[~tstate.active.numpy()] == 0.0)
    _close64(got, want)


def test_assemble_matrix_and_bcoo_match_jax(flat_operands):
    """The dense matrix (the diagonal included) against the reference's;
    A·v equals the matvec; the sparse matrix with and without the diagonal
    holds the reference's N·cap·|stencil| entries, the same indices in the
    same order and the same values, and its dense form is A (without the
    diagonal: A with its diagonal zeroed)."""
    _, (je, jstate, jn, jc), (te, tstate, tn, tc), v = flat_operands
    A = tsolvers.assemble_matrix(te, tstate, tn, tc["fields"])
    _close64(A, jsolvers.assemble_matrix(je, jstate, jn, jc["fields"]))
    _close64(A @ torch.as_tensor(v), tsolvers.assemble_matvec(
        te, tstate, tn, tc["fields"])(torch.as_tensor(v)))
    for include_self in (True, False):
        want = jsolvers.assemble_matrix_bcoo(je, jstate, jn, jc["fields"],
                                             include_self=include_self)
        got = tsolvers.assemble_matrix_bcoo(te, tstate, tn, tc["fields"],
                                            include_self=include_self)
        n = tstate.capacity
        assert got.shape == (n, n) and got.layout == torch.sparse_coo
        assert got._nnz() == n * te.cap * len(te.stencil)
        np.testing.assert_array_equal(got._indices().numpy().T,
                                      np.asarray(want.indices))
        _close64(got._values(), want.data)
        dense = A if include_self else A - torch.diag(torch.diagonal(A))
        assert torch.equal(got.to_dense(), dense)


def test_cg_solve_matches_jax(flat_operands):
    """``cg_solve`` with the Jacobi preconditioner from a seeded x0 on the
    state's own operator made SPD: the dense matrix of a coefficient of r
    (symmetric) with its diagonal replaced by 1 + Σ_j |a_ij| (each row's
    |a_ij| sum to O(10)), applied as a dense product on both sides; ``pcg``
    with its info gives the same solution, its iteration count and
    residual."""
    _, (je, jstate, jn, jc), (te, tstate, tn, tc), _ = flat_operands
    A = tsolvers.assemble_matrix(te, tstate, tn, tc["r"])
    A = A - torch.diag(torch.diagonal(A))
    A = A + torch.diag(1.0 + A.abs().sum(dim=1))
    rng = np.random.default_rng(12)
    active = tstate.active.numpy()
    b = np.where(active, rng.standard_normal(active.shape), 0.0)
    x0 = np.where(active, 0.1 * rng.standard_normal(active.shape), 0.0)
    d = torch.diagonal(A)
    kw = dict(x0=torch.as_tensor(x0), M=lambda x: x / d, tol=1e-10,
              maxiter=200)
    got = tsolvers.cg_solve(lambda x: A @ x, torch.as_tensor(b), **kw)
    x, its, res = tsolvers.pcg(lambda x: A @ x, torch.as_tensor(b), **kw,
                               return_info=True)
    assert torch.equal(x, got) and 5 < its < 200 and float(res) <= 1e-10
    jA, jd = jnp.asarray(A.numpy()), jnp.asarray(d.numpy())
    want = jsolvers.cg_solve(lambda x: jA @ x, jnp.asarray(b),
                             x0=jnp.asarray(x0), M=lambda x: x / jd,
                             tol=1e-10, maxiter=200)
    _close64(got, want)


# ---------------------------------------------- the flat layout: ISPH steps

@pytest.fixture(scope="module")
def isph_flat():
    """The kicked flat ISPH state (n_rows 8, 80 km, 3 fence rows): the
    reference's 4 steps in
    float64 with the default precond "mg" (compiled once with
    ``QUICK_COMPILE``), and the port's 4 steps in float64 with "mg" and in
    float32 with "jacobi"; for each run the warnings of ``make_step``, the
    per-step cg_it and the final state."""
    kw = dict(ISPH_SMALL)
    jcfg = jiw.ISPHWitchConfig(**kw)
    js = jiw.make_system(jcfg)
    fields, active = _fields(js.freeze())
    fields = _kicked(fields, active)
    systems, out = {}, {}
    for tag in ("jax", "float64", "float32"):
        if tag == "jax":
            state = _jstate(fields, active)
        else:
            tcfg = tiw.ISPHWitchConfig(**{**kw, "dtype": tag}, precond=(
                "mg" if tag == "float64" else "jacobi"))
            ts = systems[tag] = tiw.make_system(tcfg)
            ts.freeze(device="cpu")
            state = state_from_numpy(
                {k: v.astype(tag) for k, v in fields.items()}, active, "cpu")
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            step = (jiw.make_step(jcfg, js.engine) if tag == "jax" else
                    tiw.make_step(tcfg, ts.engine))
        if tag == "jax":
            step = jax.jit(step).lower(state).compile(
                compiler_options=QUICK_COMPILE)
        its = []
        for _ in range(4):
            state = step(state)
            its.append(int(state.fields["cg_it"][0]))
        out[tag] = ([str(w.message) for w in rec], its, state)
    return systems, fields, active, out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_flat_isph_steps_match_jax(isph_flat, dtype):
    """float64: cg_it equal every step, P and v within 1e-9 of their
    largest |value|, and both packages' warning; float32 (Jacobi, no
    warning) against the same float64 reference run, at the bucket path's
    gate."""
    systems, _, _, out = isph_flat
    ts = systems[dtype]
    (jwarn, jits, jstate), (twarn, tits, tstate) = out["jax"], out[dtype]
    assert ts.engine.layout == "flat"
    assert tstate.fields["x"].dtype == getattr(torch, dtype)
    assert int(tstate.n) == int(jstate.n) == ts.n_built == 405
    if dtype == "float64":
        assert twarn == jwarn == [
            "ISPH precond='mg' requires a bucket engine (got "
            "layout='flat'); falling back to Jacobi"]
        assert tits == jits
        jf, ja = _fields(jstate)
        tf, ta = tstate.fields, tstate.active.numpy()
        tf = {k: v.numpy()[ta] for k, v in tf.items()}
        dist, perm = cKDTree(jf["x"][ja]).query(tf["x"])
        assert dist.max() < 1e-6 and len(np.unique(perm)) == len(perm)
        for name in ("P", "v"):
            want = jf[name][ja][perm]
            np.testing.assert_allclose(tf[name], want, rtol=0.0,
                                       atol=1e-9 * np.abs(want).max(),
                                       err_msg=name)
        return
    assert twarn == []
    ja = np.asarray(jstate.active)
    ta = tstate.active.numpy()
    jv = np.abs(np.asarray(jstate.fields["v"])[ja])
    tv = np.abs(tstate.fields["v"].numpy()[ta])
    tP = tstate.fields["P"].numpy()[ta]
    assert np.isfinite(tv).all() and np.isfinite(tP).all()
    np.testing.assert_allclose([tv.mean(), tv.max()], [jv.mean(), jv.max()],
                               rtol=2e-3)
    assert np.abs(tP).mean() == pytest.approx(
        np.abs(np.asarray(jstate.fields["P"])[ja]).mean(), rel=0.1)
    assert all(abs(t - j) <= 2 for t, j in zip(tits, jits)), (tits, jits)


def test_flat_isph_mg_solves_with_jacobi(isph_flat):
    """On a flat engine "mg" solves with Jacobi: a step with
    ``precond="jacobi"`` from the same state gives the "mg" run's first
    count and pressure bit for bit."""
    systems, fields, active, out = isph_flat
    ts = systems["float64"]
    cfg = tiw.ISPHWitchConfig(**ISPH_SMALL, precond="jacobi")
    mg_cfg = dataclasses.replace(cfg, precond="mg")
    state = state_from_numpy(fields, active, "cpu")
    jac = tiw.make_step(cfg, ts.engine)(state)
    with pytest.warns(RuntimeWarning, match="falling back to Jacobi"):
        mg = tiw.make_step(mg_cfg, ts.engine)(state)
    assert int(jac.fields["cg_it"][0]) == out["float64"][1][0] > 10
    assert torch.equal(jac.fields["P"], mg.fields["P"])


# ------------------------------------------------------ Rayleigh–Bénard

def _rb_live(sidewalls):
    """The frozen cavity with v ±0.01, ρ ±1 % and T ±0.1 from a seeded
    generator, both packages' states."""
    jsys = jrb.make_system(jrb.Config(**RB, sidewalls=sidewalls))
    fields, active = _fields(jsys.freeze())
    tsys = trb.make_system(trb.Config(**RB, sidewalls=sidewalls))
    tsys.freeze(device="cpu")
    rng = np.random.default_rng(1)
    n = active.shape[0]
    fields["v"] = np.where(active[:, None], rng.uniform(-0.01, 0.01, (n, 2)),
                           0.0).astype(np.float32)
    fields["rho"] = np.where(active, fields["rho"] * rng.uniform(0.99, 1.01, n),
                             0.0).astype(np.float32)
    fields["T"] = np.where(active, fields["T"] + rng.uniform(-0.1, 0.1, n),
                           0.0).astype(np.float32)
    return (jsys.engine, _jstate(fields, active), tsys.engine,
            state_from_numpy(fields, active, "cpu"))


@pytest.mark.parametrize("sidewalls", ["conducting", "adiabatic"])
def test_rb_twin_matches_reference_body(sidewalls, monkeypatch):
    je, jst, te, tst = _rb_live(sidewalls)
    jcfg = jrb.Config(**RB, sidewalls=sidewalls, use_pallas=True)
    cfg = trb.Config(**RB, sidewalls=sidewalls, use_pallas=True)
    assert (te.cap, te.lims) == (je.cap, je.lims) == (16, (128, 16))
    refs, captured = reference_body_sweep(pp.rb_mass_heat_pass, je, jst, jcfg,
                                          monkeypatch)
    assert captured["self_pair"] is False and len(captured["fields"]) == 6
    adia = tst.fields["type"].numpy() == trb.WALL_ADIA
    assert adia.any() == (sidewalls == "adiabatic")
    before = tps.rb_mass_heat_pass.launches
    gots = tps.rb_mass_heat_pass(te, tst, cfg)
    assert tps.rb_mass_heat_pass.launches == before
    for got, ref in zip(gots, refs):
        _check(got, ref, tst.active.numpy())


def test_rb_six_steps_match_jax():
    """The reference's gate (tests/test_pallas.py): rtol 1e-4, atol 1e-8 on
    mean |v|, max |v|, mean T and max |ρ − ρ0|, equal active counts."""
    jcfg = jrb.Config(**{**RB, "layout": "flat"})
    js = jrb.make_system(jcfg)
    jstate = js.freeze()
    jstep = jax.jit(jrb.make_step(jcfg, js.engine)).lower(jstate).compile(
        compiler_options=QUICK_COMPILE)
    cfg = trb.Config(**RB, use_pallas=True)
    ts = trb.make_system(cfg)
    tstate = ts.freeze(device="cpu")
    tstep = trb.make_step(cfg, ts.engine)
    for _ in range(6):
        jstate = jstep(jstate)
        tstate = tstep(tstate)
    assert _rb_gate(jcfg, jstate, cfg, tstate) == ts.n_built == 773


def _rb_gate(jcfg, jstate, cfg, tstate):
    """tests/test_pallas.py's gate: mean |v|, max |v|, mean T and
    max |ρ − ρ0| of the active rows, then KE and Nu, at rtol 1e-4 and atol
    1e-8; equal active counts, which it returns."""
    def diag(v, T, rho, active):
        v, T, rho = (np.asarray(a)[np.asarray(active)] for a in (v, T, rho))
        return [np.abs(v).mean(), np.abs(v).max(), T.mean(),
                np.abs(rho - cfg.rho0).max()], int(np.asarray(active).sum())

    jd, jn = diag(*(jstate.fields[k] for k in ("v", "T", "rho")),
                  jstate.active)
    td, tn = diag(*(tstate.fields[k].numpy() for k in ("v", "T", "rho")),
                  tstate.active.numpy())
    assert tn == jn
    assert np.all(np.isfinite(td)) and td[1] > 0.0
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-8)
    ke, nu = trb.diagnostics(cfg, tstate)
    jke, jnu = jrb.diagnostics(jcfg, jstate)
    np.testing.assert_allclose([float(ke), float(nu)], [float(jke), float(jnu)],
                               rtol=1e-4, atol=1e-8)
    return tn


# ------------------------------------------------------------------ RKPM

RB_RKPM = dict(n_rows=16, conduction="rkpm", dtype="float64")


@pytest.fixture(scope="module")
def rkpm_states():
    """A seeded flat float64 Rayleigh–Bénard state (x ± 0.2·dr, ρ ± 1 %,
    T + 0.1·N(0, 1) on the active rows, default_rng(5)) rebuilt by both
    packages, with per-row m and h fields (the RKPM moments read q.m and
    p.h): (JAX engine, state, nbrs, port engine, state, nbrs)."""
    jcfg = jrb.Config(**RB_RKPM)
    js = jrb.make_system(jcfg)
    fields, active = _fields(js.freeze())
    ts = trb.make_system(trb.Config(**RB_RKPM))
    ts.freeze(device="cpu")
    rng = np.random.default_rng(5)
    n = active.shape[0]
    fields = {k: np.array(v) for k, v in fields.items()}
    fields["x"] = np.where(active[:, None], fields["x"] + rng.uniform(
        -0.2, 0.2, (n, 2)) * jcfg.dr, 0.0)
    fields["rho"] = np.where(active, fields["rho"]
                             * rng.uniform(0.99, 1.01, n), 0.0)
    fields["T"] = np.where(active, fields["T"] + 0.1 * rng.normal(size=n),
                           0.0)
    fields["m"] = np.where(active, jcfg.m, 0.0)
    fields["h"] = np.where(active, jcfg.h, 0.0)
    jin = _jstate(fields, active)
    jst, jn = jax.jit(js.engine.rebuild).lower(jin).compile(
        compiler_options=QUICK_COMPILE)(jin)
    tst, tn = ts.engine.rebuild(state_from_numpy(fields, active, "cpu"))
    np.testing.assert_array_equal(tst.fields["x"].numpy(),
                                  np.asarray(jst.fields["x"]))
    assert ts.engine.layout == js.engine.layout == "flat"
    return js.engine, jst, jn, ts.engine, tst, tn


def test_rkpm_functions_match_jax(rkpm_states):
    """``moment_matrix``, ``correction_vector``, ``corrected_sum`` and
    ``corrected_laplacian`` (the RB form: the conducting rows, volume
    m/ρ) against the reference's (compiled once with ``QUICK_COMPILE``),
    on the active rows: within 1e-12 of each output's largest |value| for
    the first three and 1e-9 for the Laplacian (measured: 3.2e-16, 4.5e-14,
    8.6e-16 and 1.4e-11: the Laplacian's h-scaled solve divides by h²)."""
    from sph_mountain_waves_tpu.utils import rkpm as jrk

    from sph_mountain_waves_tpu_torch.utils import rkpm as trk

    je, jst, jn, te, tst, tn = rkpm_states
    m = trb.Config(**RB_RKPM).m

    def reference(st, nb):
        inc = st.active & (st.fields["type"] != jrb.WALL_ADIA)
        return (jrk.moment_matrix(je, st, nb),
                jrk.correction_vector(je, st, nb),
                jrk.corrected_sum(je, st, nb, st.fields["T"]),
                jrk.corrected_laplacian(
                    je, st, nb, st.fields["T"], include_q=inc,
                    vol_of=lambda q: m / jnp.maximum(q.rho, 1e-30)))

    refs = jax.jit(reference).lower(jst, jn).compile(
        compiler_options=QUICK_COMPILE)(jst, jn)
    inc = tst.active & (tst.fields["type"] != trb.WALL_ADIA)
    gots = (trk.moment_matrix(te, tst, tn), trk.correction_vector(te, tst, tn),
            trk.corrected_sum(te, tst, tn, tst.fields["T"]),
            trk.corrected_laplacian(
                te, tst, tn, tst.fields["T"], include_q=inc,
                vol_of=lambda q: m / torch.clamp(q.rho, min=1e-30)))
    act = tst.active.numpy()
    for name, got, ref, rel in zip(("M", "beta", "sum", "laplacian"), gots,
                                   refs, (1e-12, 1e-12, 1e-12, 1e-9)):
        got, ref = got.numpy()[act], np.asarray(ref)[act]
        assert got.dtype == np.float64 and np.abs(ref).max() > 0.0
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=rel * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_rkpm_partition_of_unity(dtype):
    """The reference's gates (tests/test_rkpm.py) on the port: on a 10 × 10
    lattice in the unit box (h = 0.25, flat layout) the plain kernel sum
    of ones falls below 0.8 at the corners, the corrected one is 1 within
    1e-5 everywhere, and a quadratic is reproduced at rtol 1e-4."""
    from sph_mountain_waves_tpu_torch import ParticleSystem, Rectangle
    from sph_mountain_waves_tpu_torch.utils import rkpm as trk

    dr, h = 0.1, 0.25
    sys_ = ParticleSystem(fields={"x": 2, "m": 0, "rho": 0, "h": 0},
                          domain=Rectangle(0.0, 0.0, 1.0, 1.0), h=h, dim=2,
                          defaults={"m": dr * dr, "rho": 1.0, "h": h},
                          dtype=dtype)
    g = np.arange(dr / 2, 1.0, dr)
    sys_.add_particles(np.stack(np.meshgrid(g, g), -1).reshape(-1, 2), {})
    state = sys_.freeze(device="cpu", layout="flat")
    state, nbrs = sys_.engine.rebuild(state)
    eng, act = sys_.engine, state.active.numpy()
    ones = torch.ones(state.capacity, dtype=dtype)
    plain = torch.zeros((state.capacity, 6), dtype=dtype)
    plain[:, 0] = 1.0
    assert trk.corrected_sum(eng, state, nbrs, ones,
                             beta=plain).numpy()[act].min() < 0.8
    s = trk.corrected_sum(eng, state, nbrs, ones)
    assert s.dtype == dtype
    np.testing.assert_allclose(s.numpy()[act], 1.0, atol=1e-5)
    x = state.fields["x"].double().numpy()
    f = (3.0 + 2.0 * x[:, 0] - 1.5 * x[:, 1] + 4.0 * x[:, 0] ** 2
         + 0.5 * x[:, 1] ** 2 - 2.0 * x[:, 0] * x[:, 1])
    got = trk.corrected_sum(eng, state, nbrs, f).double().numpy()
    np.testing.assert_allclose(got[act], f[act], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float64", "float32"],
                         ids=["f64", "f32"])
def test_rb_rkpm_steps_match_jax(dtype):
    """8 flat steps of ``Config(n_rows=16, conduction="rkpm")`` against the
    reference's (compiled with ``QUICK_COMPILE``). float64: equal active
    counts, KE and Nu at rtol 1e-8 and every field within 1e-8 of its
    largest |value|, rows matched by position (measured: 6.3e-16 on Dv).
    float32 (the config's default dtype, whose 6 × 6 solves the h-scaled
    basis keeps accurate): ``test_rb_six_steps_match_jax``'s gate,
    rtol 1e-4 (measured: the four row statistics and Nu equal, KE
    1.0e-7)."""
    kw = {**RB_RKPM, "dtype": dtype}
    jcfg, tcfg = jrb.Config(**kw), trb.Config(**kw)
    js = jrb.make_system(jcfg)
    jstate = js.freeze()
    jstep = jax.jit(jrb.make_step(jcfg, js.engine)).lower(jstate).compile(
        compiler_options=QUICK_COMPILE)
    ts = trb.make_system(tcfg)
    tstate = ts.freeze(device="cpu")
    assert ts.engine.layout == "flat"
    tstep = trb.make_step(tcfg, ts.engine)
    for _ in range(8):
        jstate, tstate = jstep(jstate), tstep(tstate)
    if dtype == "float32":
        assert tstate.fields["T"].dtype == torch.float32
        assert _rb_gate(jcfg, jstate, tcfg, tstate) == ts.n_built
        return
    assert int(tstate.n) == int(jstate.n) == ts.n_built
    got = [float(v) for v in trb.diagnostics(tcfg, tstate)]
    assert np.all(np.isfinite(got)) and got[0] > 0.0
    np.testing.assert_allclose(
        got, [float(v) for v in jrb.diagnostics(jcfg, jstate)], rtol=1e-8)
    jf, tf = matched_rows(jstate, tstate)
    for name, ref in jf.items():
        np.testing.assert_allclose(tf[name], ref, rtol=0,
                                   atol=1e-8 * np.abs(ref).max(),
                                   err_msg=name)


def test_rb_run_writes_files_and_resumes_bitwise(tmp_path, capsys):
    """Adiabatic sidewalls, two frames of three steps with a checkpoint
    every frame; live plots print the sparklines; a resumed run equals the
    uninterrupted one bit for bit."""
    cfg = trb.Config(**RB, sidewalls="adiabatic", use_pallas=True,
                     n_frames=2, checkpoint_every=1, live_plot=True)
    cfg = dataclasses.replace(cfg, t_end=6 * cfg.dt)
    whole = trb.run(cfg, out_path=str(tmp_path / "whole"), device="cpu")
    assert "Nu [" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "whole")) == [
        "checkpoint.npz", "data.csv", "frame0.vtp", "frame1.vtp",
        "kinetic_energy.pdf", "nusselt.pdf", "result.pvd"]
    csv = read_csv(str(tmp_path / "whole" / "data.csv"))
    assert list(csv) == ["t", "KE", "Nu"] and len(csv["t"]) == 2
    np.testing.assert_array_equal(csv["Nu"], whole["Nu"])
    pts, data = read_vtp(str(tmp_path / "whole" / "frame1.vtp"))
    assert len(pts) == 773 and sorted(data) == ["P", "T", "type", "v"]

    half = dataclasses.replace(cfg, t_end=cfg.t_end / 2, n_frames=1,
                               live_plot=False)
    trb.run(half, out_path=str(tmp_path / "part"), device="cpu")
    resumed = trb.run(dataclasses.replace(
        cfg, live_plot=False,
        resume=str(tmp_path / "part" / "checkpoint.npz")),
        out_path=str(tmp_path / "part"), device="cpu")
    for name, ref in whole["state"].fields.items():
        assert torch.equal(resumed["state"].fields[name], ref), name
    merged = read_csv(str(tmp_path / "part" / "data.csv"))
    for name in csv:
        np.testing.assert_array_equal(merged[name], csv[name], err_msg=name)


def test_entry_points_need_a_card_and_refuse_what_is_not_ported(monkeypatch):
    """Without ``device=`` ``run`` asks for CUDA and raises where there is
    none; ISPH's defaults (the flat layout, float32, "mg", which warns and
    solves with Jacobi) and its float64 build and step; a float64 state on
    the bucket layout is refused at its first step (ISPH and
    Rayleigh–Bénard); RKPM conduction on the bucket layout builds and
    ``make_step`` refuses it, as it refuses a sharded engine;
    Rayleigh–Bénard's flat layout builds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for module, cfg in ((tiw, tiw.ISPHWitchConfig(**ISPH, use_pallas=True)),
                        (trb, trb.Config(**RB, use_pallas=True))):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            module.run(cfg)
    # ISPH's defaults at a small width (the card runs them at full width),
    # from rest: finite, every particle kept (its float64 flat default,
    # "mg" included, is stepped by the flat steps' test)
    cfg = dataclasses.replace(tiw.ISPHWitchConfig(), n_rows=6,
                              dom_length=60e3, bc_rows=3)
    assert (cfg.layout, cfg.dtype, cfg.precond) == ("flat", "float32", "mg")
    sys_ = tiw.make_system(cfg)
    state = sys_.freeze(device="cpu")
    with pytest.warns(RuntimeWarning, match="falling back to Jacobi"):
        step = tiw.make_step(cfg, sys_.engine)
    state = step(state)
    assert state.fields["P"].dtype == torch.float32
    assert int(state.n) == sys_.n_built == 220
    assert all(bool(torch.isfinite(v).all()) for v in state.fields.values())
    # a float64 bucket state is built and refused at its first step, as
    # Rayleigh–Bénard's is
    for module, cfg in (
            (tiw, tiw.ISPHWitchConfig(**{**ISPH, "dtype": "float64"})),
            (trb, trb.Config(**{**RB, "dtype": "float64"}))):
        sys64 = module.make_system(cfg)
        state64 = sys64.freeze(device="cpu")
        with pytest.raises(NotImplementedError, match="float32"):
            module.make_step(cfg, sys64.engine)(state64)
    flat = trb.make_system(trb.Config(**{**RB, "layout": "flat",
                                         "dtype": "float64"}))
    assert flat.freeze(device="cpu").fields["T"].dtype == torch.float64
    assert flat.engine.layout == "flat"
    rkpm_bucket = trb.Config(**RB, conduction="rkpm")
    sys_ = trb.make_system(rkpm_bucket)
    sys_.freeze(device="cpu")
    with pytest.raises(NotImplementedError, match="rkpm"):
        trb.make_step(rkpm_bucket, sys_.engine)
    sys_ = tiw.make_system(tiw.ISPHWitchConfig(**ISPH))
    sys_.freeze(device="cpu")
    sharded = type("Sharded", (), {"axis": "x"})()
    with pytest.raises(NotImplementedError, match="distributed CG"):
        tiw.make_step(tiw.ISPHWitchConfig(**ISPH), sharded)
    assert tiw.baseline_config().n_rows == 110
    assert trb.baseline_config().n_rows == 160


# ----------------------------------------------------------------- plots

def test_plot_files_written(tmp_path):
    """The reference's tests/test_plots.py gates, on the port's module."""
    t = np.linspace(0.0, 3.0, 20)
    assert tplots.plot_dambreak(str(tmp_path), t, 1.0 + t, 1.0 - 0.2 * t)
    assert tplots.plot_velocities(str(tmp_path), t, 0.1 * t, 0.3 * t)
    assert tplots.plot_series(str(tmp_path / "e.pdf"), t, {"E": t ** 2},
                              ylabel="energy")
    s = np.linspace(0.0, 1.0, 30)
    assert tplots.plot_cavity(str(tmp_path), s, s - 0.5, 0.2 * np.sin(s),
                              Re=100.0)
    for name in ("dambreak_X.pdf", "dambreak_H.pdf", "velocities.pdf",
                 "e.pdf", "ldc-x2vy.pdf", "ldc-y2vx.pdf"):
        p = tmp_path / name
        assert p.exists() and p.stat().st_size > 500, name
    line = tplots.ascii_series("u", [0.0, 1.0, 2.0])
    assert line == "u [0, 2]: ▁▅█"


def test_plot_dambreak_overlays_reference_points(tmp_path):
    """The packaged digitised CSVs resolve by default (ref_dir=None)."""
    t = np.linspace(0.0, 3.0, 5)
    assert tplots.plot_dambreak(str(tmp_path), t, 1.0 + t, np.ones_like(t))
    assert (tmp_path / "dambreak_X.pdf").stat().st_size > 500
