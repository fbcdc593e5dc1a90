"""The port's flat layout and float64 against the JAX package on the CPU.

Sizes are smoke sizes: the mountain-wave schemes at n_rows=10 (N = 3,514,
grid 94 × 13 flat cells, cap 8, ``pair_mode="cell"``), the flagship's
cross-layout gate at the reference test's n_rows=14, ``collapse_dry`` at
dr=0.08 (N = 587, ``pair_mode="gather"``) and Rayleigh–Bénard at n_rows=16
(N = 773, "cell"). What is compared, and at which tolerance:

* the flat rebuild (``NeighborEngine._rebuild_flat``) in 2-D (float32 and
  float64) and 3-D (float64) on a seeded cloud with a particle outside the
  box, a non-finite one, a cell holding 12 particles at cap 8 and inactive
  spare rows: the sorted rows, ``active``, ``cell``, ``key``, ``counts``,
  ``starts``, ``rank``, ``bucket`` and ``overflow``, exactly;
* ``apply_binary`` with the flagship's own pair functions (the density with
  the self pair and without it, the momentum), taken from each package's
  ``make_step`` closure, in cell and gather modes on a perturbed state.
  float64: rtol 1e-12 and atol 1e-14 × the output's largest |value|
  (measured: at most 2.4e-16 of the largest value; single elements that
  cancel differ by up to 2.3e-12 relative, because PyTorch's ``pow`` and
  XLA's integer power round t⁴ differently). float32: rtol 1e-5, atol 1e-6
  × the largest |value| (``tests/test_pallas.py:36``);
* 8 steps of each flat float64 scheme (the flagship, the three Hopkins
  schemes, Pavelka, ``collapse_dry`` after ``init_forces``,
  Rayleigh–Bénard) against 8 steps of the reference's own ``make_step``,
  compiled once with ``QUICK_COMPILE`` (tests/torch_reference_harness.py;
  measured on one core: 2.5–4.2 s for a mountain-wave scheme's compile and
  8 steps, against 11–14 s for its 8 steps run op by op): an exactly equal
  active count; the observables (u_avg/u_max, X/H/E, KE/Nu) at rtol 1e-8
  and every field within 1e-8 of its largest |value| (measured: at most
  3.1e-9, on v, whose step sum cancels the hydrostatic pressure gradient).
  Rows are matched by position (nearest neighbour, within 1e-6 m): a
  particle that sits on a cell edge (x = 0 on the mountain-wave lattice)
  takes the key on either side of it as its last bit rounds, and the
  stable sort then orders the two states' rows differently;
* the reference's cross-layout gate (``tests/test_trajectory_fidelity.py``)
  applied to the port: ``WitchConfig(n_rows=14, self_density=True)``, the
  float32 bucket step (skin 0.2, the sweeps' CPU twins) against the float64
  flat step (skin 0) over 200 steps, u_avg/u_max every 50 steps at rtol
  1e-3;
* ``collapse_dry.run`` at its flat float64 defaults with a checkpoint every
  frame: the same file set and data.csv columns as the reference's run, its
  X/H/E within rtol 1e-8 of the reference's, a checkpoint that the JAX
  package loads (flat engine, pair mode), and a resumed run bit for bit
  equal to the uninterrupted one.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_mountain_waves_tpu.models import (
    collapse_dry as jcd, full_hopkins_perturbed_witch as jfh,
    hopkins_perturbed_witch as jhp, hopkins_total_witch as jht,
    pavelka_total_witch as jpv, rayleigh_benard as jrb,
    wcsph_perturbed_witch as jw,
)
from sph_mountain_waves_tpu.models.witch_common import (
    WitchConfig as JCfg, velocity_diagnostics as j_diag,
)
from sph_mountain_waves_tpu.ops import apply as japply
from sph_mountain_waves_tpu.ops.neighbors import NeighborEngine as JEngine
from sph_mountain_waves_tpu.structs import ParticleState as JState
from sph_mountain_waves_tpu.utils import checkpoint as jckpt

from sph_mountain_waves_tpu_torch.interop import state_from_numpy, state_to_numpy
from sph_mountain_waves_tpu_torch.io import read_csv
from sph_mountain_waves_tpu_torch.models import (
    collapse_dry as tcd, full_hopkins_perturbed_witch as tfh,
    hopkins_perturbed_witch as thp, hopkins_total_witch as tht,
    pavelka_total_witch as tpv, rayleigh_benard as trb,
    wcsph_perturbed_witch as tw,
)
from sph_mountain_waves_tpu_torch.models.witch_common import (
    WitchConfig as TCfg, velocity_diagnostics as t_diag,
)
from sph_mountain_waves_tpu_torch.ops import apply as tapply
from sph_mountain_waves_tpu_torch.ops.neighbors import NeighborEngine as TEngine
from torch_reference_harness import (
    QUICK_COMPILE, jit_at_level0, matched_rows,
)

torch.set_num_threads(1)

FLAT = dict(n_rows=10, dtype="float64", layout="flat", self_density=True)
TORCH_DTYPE = {np.float32: torch.float32, np.float64: torch.float64}
N_STEPS = 8


def _to_np(jstate):
    return ({k: np.asarray(v) for k, v in jstate.fields.items()},
            np.asarray(jstate.active))


def _close(got, ref, rtol, atol_rel, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=atol_rel * np.abs(ref).max(), err_msg=msg)


# ------------------------------------------------------------ flat rebuild

def _cloud(dim, dtype, rng):
    """A unit box at h = 0.1 (a grid of 11 cells a side), n rows with the
    last 5 inactive; rows 0-11 in one cell (12 > cap 8), row 12 outside the
    box, row 13 NaN."""
    n = 300 if dim == 2 else 600
    x = rng.uniform(0.0, 1.0, (n, dim))
    x[:12] = 0.55 + rng.uniform(0.0, 0.04, (12, dim))
    x[12] = 1.05
    x[13, 0] = np.nan
    active = np.arange(n) < n - 5
    x[~active] = 0.0
    fields = {"x": x.astype(dtype),
              "v": rng.normal(size=(n, dim)).astype(dtype),
              "m": rng.uniform(1.0, 2.0, n).astype(dtype)}
    return fields, active


@pytest.mark.parametrize("dim, dtype", [(2, np.float32), (2, np.float64),
                                        (3, np.float64)],
                         ids=["2d-f32", "2d-f64", "3d-f64"])
def test_flat_rebuild_is_exact(dim, dtype):
    fields, active = _cloud(dim, dtype, np.random.default_rng(dim))
    box = types.SimpleNamespace(mins=(0.0,) * 3, maxs=(1.0,) * 3)
    je = JEngine.create(box, 0.1, dim, positions=fields["x"], cap=8,
                        dtype=jnp.dtype(dtype), layout="flat")
    te = TEngine.create(box, 0.1, dim, positions=fields["x"], cap=8,
                        dtype=TORCH_DTYPE[dtype], layout="flat")
    assert (te.lims, te.phase, te.cap, te.pair_mode) == (
        je.lims, je.phase, je.cap, je.pair_mode)
    jstate, jn = je.rebuild(JState(
        fields={k: jnp.asarray(v) for k, v in fields.items()},
        active=jnp.asarray(active)))
    tstate, tn = te.rebuild(state_from_numpy(fields, active, "cpu"))

    jf, ja = _to_np(jstate)
    tf, ta = state_to_numpy(tstate)
    np.testing.assert_array_equal(ta, ja)
    for name in jf:
        assert tf[name].dtype == jf[name].dtype, name
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    for name in ("cell", "key", "rank", "counts", "starts", "bucket",
                 "overflow"):
        got, want = getattr(tn, name).numpy(), np.asarray(getattr(jn, name))
        assert got.dtype == want.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # the screened rows (outside, NaN, inactive) carry the trash key; the
    # crowded cell overflows, and its rows past cap are in no bucket
    C = te.num_cells
    assert int((tn.key == C).sum()) == 7 and int(ta.sum()) == len(ta) - 7
    assert int(tn.overflow) == int(tn.counts[:C].max()) - te.cap >= 4
    dropped = torch.nonzero(tn.rank >= te.cap).flatten().to(torch.int32)
    assert len(dropped) >= 4
    assert not bool(torch.isin(dropped, tn.bucket).any())
    # the cell-block helpers and the candidates of three offsets, and of
    # every offset at once, against the reference's
    for off in (je.stencil[0], je.stencil[len(je.stencil) // 2],
                je.stencil[-1]):
        np.testing.assert_array_equal(
            te.shift_cells(te.bucketize(tn, tstate.fields["v"]), off).numpy(),
            np.asarray(je.shift_cells(je.bucketize(jn, jstate.fields["v"]),
                                      off)))
        np.testing.assert_array_equal(
            te.shift_cells(te.occupancy(tn), off).numpy(),
            np.asarray(je.shift_cells(je.occupancy(jn), off)))
        for got, want in zip(te.stencil_candidates(tn, off),
                             je.stencil_candidates(jn, off)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    every = te.stencil_candidates(tn, te.stencil)
    for a, off in enumerate(te.stencil):
        for got, want in zip(every, te.stencil_candidates(tn, off)):
            assert torch.equal(got[:, a], want)


# ------------------------------------------------------------ apply_binary

def _pair_fns(step):
    """The pair functions a step closes over, by name (a name the step
    never bound, such as the reference's Pallas passes off its Pallas path,
    is left out)."""
    return {name: cell.cell_contents
            for name, cell in zip(step.__code__.co_freevars, step.__closure__)
            if _bound(cell)}


def _bound(cell):
    try:
        cell.cell_contents
    except ValueError:
        return False
    return True


@pytest.fixture(scope="module", params=["float64", "float32"])
def flat_pair(request):
    """(dtype, JAX engine/state/nbrs/pair functions, port likewise): the
    flagship's flat state with v, h, ρ, P and P′ drawn from a seeded
    generator, rebuilt by each package."""
    kw = {**FLAT, "dtype": request.param}
    js = jw.make_system(JCfg(**kw))
    fields, active = _to_np(js.freeze())
    ts = tw.make_system(TCfg(**kw))
    ts.freeze(device="cpu")
    rng = np.random.default_rng(1)
    n = active.shape[0]
    dt = fields["x"].dtype

    def draw(base, lo, hi):
        return np.where(active, base * rng.uniform(lo, hi, n), 0.0).astype(dt)

    fields["v"] = np.where(active[:, None], rng.normal(0.0, 1.0, (n, 2)),
                           0.0).astype(dt)
    fields["h"] = draw(fields["h"], 0.95, 1.05)
    fields["rho"] = draw(fields["rho"], 0.99, 1.01)
    fields["P"] = draw(fields["P"], 0.99, 1.01)
    fields["P_p"] = np.where(active, rng.normal(0.0, 100.0, n), 0.0).astype(dt)
    jstate, jn = js.engine.rebuild(JState(
        fields={k: jnp.asarray(v) for k, v in fields.items()},
        active=jnp.asarray(active)))
    tstate, tn = ts.engine.rebuild(state_from_numpy(fields, active, "cpu"))
    jfns = _pair_fns(jw.make_step(JCfg(**kw), js.engine))
    tfns = _pair_fns(tw.make_step(TCfg(**kw), ts.engine))
    return (request.param, (js.engine, jstate, jn, jfns),
            (ts.engine, tstate, tn, tfns))


@pytest.mark.parametrize("mode", ["cell", "gather"])
@pytest.mark.parametrize("fn, field, self_pair", [
    ("compute_density", "rho", True), ("compute_density", "rho", False),
    ("balance_of_momentum", "Dv", False)],
    ids=["density-self", "density", "momentum"])
def test_apply_binary_matches_jax(flat_pair, mode, fn, field, self_pair):
    dtype, (je, jstate, jn, jfns), (te, tstate, tn, tfns) = flat_pair
    je = dataclasses.replace(je, pair_mode=mode)
    te = dataclasses.replace(te, pair_mode=mode)
    want = japply.apply_binary(je, jstate, jn, jfns[fn], add=False,
                               self_interaction=self_pair).fields[field]
    got = tapply.apply_binary(te, tstate, tn, tfns[fn], add=False,
                              self_interaction=self_pair).fields[field]
    assert got.dtype == TORCH_DTYPE[np.dtype(dtype).type]
    assert float(got.abs().max()) > 0.0
    if fn == "compute_density":  # the same sum through pair_sum
        assert torch.equal(tapply.pair_sum(
            te, tstate, tn, lambda p, q, r: tfns[fn](p, q, r)[field],
            self_interaction=self_pair), got)
    if dtype == "float64":
        _close(got.numpy(), want, 1e-12, 1e-14)
    else:
        _close(got.numpy(), want, 1e-5, 1e-6)


def test_apply_unary_where_matches_jax():
    """``apply_unary`` with a ``where`` mask (a tensor, or a function of the
    view) and a parameter: updates only where it holds, zero on inactive
    rows, as the reference's."""
    rng = np.random.default_rng(5)
    n = 40
    fields = {"x": rng.normal(size=(n, 2)), "v": rng.normal(size=(n, 2)),
              "m": rng.uniform(1.0, 2.0, n)}
    active = rng.uniform(size=n) < 0.8
    where = rng.uniform(size=n) < 0.5
    jstate = JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                    active=jnp.asarray(active))
    tstate = state_from_numpy(fields, active, "cpu")

    def action(u, s):
        return {"m": u.m * s, "v": u.v + s}

    want = japply.apply_unary(jstate, action, where=jnp.asarray(where), s=2.0)
    for mask in (torch.as_tensor(where), lambda u: torch.as_tensor(where)):
        got = tapply.apply_unary(tstate, action, where=mask, s=2.0)
        for name in fields:
            np.testing.assert_array_equal(got.fields[name].numpy(),
                                          np.asarray(want.fields[name]))


# ------------------------------------------------------- steps vs the JAX

SCHEMES = {
    "flagship": (jw, tw, lambda m: (JCfg if m is jw else TCfg)(**FLAT)),
    "hopkins_perturbed": (jhp, thp,
                          lambda m: (JCfg if m is jhp else TCfg)(**FLAT)),
    "full_hopkins": (jfh, tfh, lambda m: (JCfg if m is jfh else TCfg)(**FLAT)),
    "hopkins_total": (jht, tht, lambda m: (JCfg if m is jht else TCfg)(**FLAT)),
    "pavelka": (jpv, tpv, lambda m: m.PavelkaConfig(**FLAT)),
    "collapse_dry": (jcd, tcd, lambda m: m.Config(dr=0.08)),
    "rayleigh_benard": (jrb, trb,
                        lambda m: m.Config(n_rows=16, dtype="float64")),
}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=QUICK_COMPILE)


def _observables(name, module, cfg, state):
    if name == "collapse_dry":
        return module.get_globals(cfg, state)
    if name == "rayleigh_benard":
        return module.diagnostics(cfg, state)
    return (j_diag if module.__name__.startswith("sph_mountain_waves_tpu.")
            else t_diag)(state)


@pytest.mark.parametrize("name", list(SCHEMES))
def test_flat_float64_steps_match_jax(name):
    jm, tm, make_cfg = SCHEMES[name]
    jcfg, tcfg = make_cfg(jm), make_cfg(tm)
    js = jm.make_system(jcfg)
    jstate = js.freeze()
    ts = tm.make_system(tcfg)
    tstate = ts.freeze(device="cpu")
    assert ts.engine.layout == js.engine.layout == "flat"
    assert ts.engine.pair_mode == js.engine.pair_mode
    assert tstate.fields["x"].dtype == torch.float64
    jstep, tstep = jm.make_step(jcfg, js.engine), tm.make_step(tcfg, ts.engine)
    if name == "collapse_dry":
        (jstep, jinit), (tstep, tinit) = jstep, tstep
        jstate, tstate = _compiled(jinit, jstate)(jstate), tinit(tstate)
    jstep = _compiled(jstep, jstate)
    for _ in range(N_STEPS):
        jstate, tstate = jstep(jstate), tstep(tstate)

    assert int(tstate.n) == int(jstate.n) == ts.n_built
    jo = [float(v) for v in _observables(name, jm, jcfg, jstate)]
    to = [float(v) for v in _observables(name, tm, tcfg, tstate)]
    assert np.all(np.isfinite(to))
    np.testing.assert_allclose(to, jo, rtol=1e-8)
    jf, tf = matched_rows(jstate, tstate)
    assert sorted(jf) == sorted(tf)
    for field in jf:
        _close(tf[field], jf[field], 0.0, 1e-8, field)


# ------------------------------------------------- the cross-layout gate

def test_cross_layout_gate_on_the_port():
    """The reference's 200-step gate (tests/test_trajectory_fidelity.py)
    with both sides the port's: float32 bucket against float64 flat."""
    series = {}
    for tag, kw in [("flat", dict(dtype="float64", layout="flat", skin=0.0)),
                    ("bucket", dict(dtype="float32", layout="bucket",
                                    skin=0.2, use_pallas=True))]:
        cfg = TCfg(n_rows=14, self_density=True, **kw)
        sys_ = tw.make_system(cfg)
        state = sys_.freeze(device="cpu")
        assert sys_.engine.layout == kw["layout"]
        step = tw.make_step(cfg, sys_.engine)
        out = []
        for k in range(200):
            state = step(state)
            if (k + 1) % 50 == 0:
                out.append([float(v) for v in t_diag(state)])
        assert int(state.n) == sys_.n_built
        series[tag] = np.asarray(out)
    np.testing.assert_allclose(series["bucket"], series["flat"], rtol=1e-3)


# ------------------------------------------------ run, files and resume

def test_flat_collapse_dry_run_matches_jax_and_resumes_bitwise(
        tmp_path, monkeypatch):
    jit_at_level0(monkeypatch)  # the reference run's own jax.jit
    kw = dict(dr=0.08, t_end=1.92e-3, n_frames=2, checkpoint_every=1)
    assert tcd.Config(**kw).dtype == "float64"
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    whole = tcd.run(tcd.Config(**kw), out_path=tdir, device="cpu")
    ref = jcd.run(jcd.Config(**kw), out_path=jdir)
    files = sorted(os.listdir(tdir))
    assert files == sorted(os.listdir(jdir))
    assert {"checkpoint.npz", "data.csv", "frame2.vtp", "result.pvd"} <= set(
        files)
    assert list(read_csv(os.path.join(tdir, "data.csv"))) == ["t", "X", "H",
                                                              "E"]
    for obs in ("t", "X", "H", "E"):
        np.testing.assert_allclose(whole[obs], ref[obs], rtol=1e-8,
                                   err_msg=obs)

    # the port's flat checkpoint loads in the JAX package
    jback, jmeta = jckpt.load_checkpoint(os.path.join(tdir, "checkpoint.npz"))
    jeng = jckpt.engine_from_meta(jmeta)
    assert (jeng.layout, jeng.pair_mode, jeng.lims) == (
        "flat", whole["system"].engine.pair_mode,
        whole["system"].engine.lims)
    np.testing.assert_array_equal(
        np.asarray(jback.fields["x"]),
        whole["state"].fields["x"].numpy())

    # stop after the first frame, then resume from its checkpoint
    part = str(tmp_path / "part")
    tcd.run(tcd.Config(**{**kw, "t_end": kw["t_end"] / 2, "n_frames": 1}),
            out_path=part, device="cpu")
    resumed = tcd.run(
        tcd.Config(**kw, resume=os.path.join(part, "checkpoint.npz")),
        out_path=part, device="cpu")
    for name, val in whole["state"].fields.items():
        assert torch.equal(resumed["state"].fields[name], val), name
    assert torch.equal(resumed["state"].active, whole["state"].active)
    np.testing.assert_array_equal(
        read_csv(os.path.join(part, "data.csv"))["E"], whole["E"])
