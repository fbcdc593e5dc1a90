"""The port's terrain family (``legacy_witch``: isothermal and adiabatic, flow
and static) against the JAX package on the CPU.

Sizes: n_rows=14, dom_length=40 km, h_m=2 km, a=6 km (the reference's own
Pallas-vs-XLA gates, tests/test_pallas.py). On the float32 bucket layout,
skin 0.15, the flow variants have N = 745 on a square lattice (grid 128 ×
16, cap 16), the static ones N = 848 on the hexagonal lattice (cap 8); on
the flat layout (skin 0, as the reference sets it) the grid is 20 × 16,
cap 8, cell mode.

What is compared, and at which tolerance:

* the frozen flow and static states and the flow on the analytic floor
  (``lj_floor``: no terrain particles), slot for slot and bit for bit;
* the sort rescatter: the port's ``sorted_slot_scatter`` against the
  reference's, evaluated eagerly on the same keys (a cap tight enough to
  drop rows), exactly, dropped count included; the port's sort and stencil
  rescatters of a perturbed flow state give the same slot layout; a cap past
  the stencil-cost limit (9·232 > 2048) takes the sort rescatter, and its
  rebuild equals the reference's slot for slot;
* inflow recycling: one ``add_new_particles`` from a state whose INFLOW
  column crossed the edge, against the reference's closure called eagerly,
  for the slot-targeted (stencil) and the free-pool (sort) placements and
  home cells with no free rank (dropped spawns): positions, velocities, types,
  ``_xref``, ``_spawn_drops`` and the active mask exactly; ρ, m and P
  (from ρ_bg(y) = ρ0·exp(−gy/RT0)) within rel 1e-6: PyTorch's and XLA's f32
  ``exp`` differ in the last bits on a few rows (measured 4.6e-7 on P);
* the five new twins and the adiabatic density against the reference's own
  pair bodies summed eagerly (tests/torch_reference_harness.py), with
  ``av_alpha`` 0 and 0.05 and ``fast_math`` off and on. Gate: rtol 1e-5,
  atol = 1e-6 × the output's largest |value|;
* 8 steps of each variant, the port's float32 bucket step (the twins) and
  its float32 flat step (``apply_binary``), against the reference's jitted
  float32 flat step at its own gate (rtol 2e-4, exactly equal active
  counts; measured on the flat step: 9.3e-8–1.5e-6): u_avg, u_max and, per
  variant, the drag and lift (isothermal flow), Σh and max |h − h0|
  (isothermal static) or ΣS and max |S| (adiabatic); the adiabatic flow runs
  the corrected bundle. Each reference step is compiled once with
  ``QUICK_COMPILE`` (tests/torch_reference_harness.py);
* 8 flat float64 steps of each variant against the reference's: equal
  active counts, the observables at rtol 1e-8 (measured ≤ 1.9e-15) and
  every field within 1e-8 of its largest |value| with rows matched by
  position (measured ≤ 1.7e-14): a particle on a cell edge takes the key on
  either side as its last bit rounds, and the two stable sorts then order
  the rows differently;
* the reference's zero-headroom invariant (tests/test_legacy.py): frozen
  flat at capacity == N, 120 steps, drops > 0 and the INFLOW count falls
  by exactly the drops;
* the faithful sponge's kick (``accelerate``, a constant body force above
  z_t − z_b) on the frozen static state against the reference's closure,
  bit for bit in float64 and float32 (a float32 sponge left 6.8e-11 in a
  float64 v);
* the observables on one identical state (rtol 1e-5), the analytic-floor
  helpers of ``lj_floor`` on the same rows (rel 1e-6), and ``run(cfg,
  out_path=..., device="cpu")`` of a tiny flow config through a spawn
  event, float32 bucket and float64 flat: the file set, the ``data.csv``
  columns, no dropped spawn, a checkpoint the reference reads (its layout
  included), and a resumed run bit for bit equal to the uninterrupted one;
  the flat float64 run (the inflow column 50 m upstream of the edge, 24
  steps, spawns into the spare flat rows) also against the reference's 24
  steps: the active count, ``n_inflow`` and ``spawn_drops`` exactly, every
  field within 1e-8 of its largest |value| (measured 5.9e-15).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_mountain_waves_tpu.ops.pallas_pairs as pp
from sph_mountain_waves_tpu.models import legacy_witch as jlw
from sph_mountain_waves_tpu.models.witch_common import (
    velocity_diagnostics as j_diag,
)
from sph_mountain_waves_tpu.ops import apply as japply
from sph_mountain_waves_tpu.ops import neighbors as jnb
from sph_mountain_waves_tpu.structs import ParticleState as JState
from sph_mountain_waves_tpu.utils.checkpoint import (
    engine_from_meta as j_engine_from_meta,
    load_checkpoint as j_load_checkpoint,
)

from sph_mountain_waves_tpu_torch.interop import state_from_numpy, state_to_numpy
from sph_mountain_waves_tpu_torch.io import read_csv
from sph_mountain_waves_tpu_torch.models import legacy_witch as tlw
from sph_mountain_waves_tpu_torch.models.witch_common import (
    velocity_diagnostics as t_diag,
)
from sph_mountain_waves_tpu_torch.ops import apply as tapply
from sph_mountain_waves_tpu_torch.ops import neighbors as tnb
from sph_mountain_waves_tpu_torch.ops import pair_sweeps as tps
from torch_reference_harness import (
    QUICK_COMPILE, matched_rows, reference_body_sweep,
)

torch.set_num_threads(1)

GEO = dict(n_rows=14, dom_length=40e3, h_m=2000.0, a=6e3, dtype="float32",
           layout="bucket", skin=0.15)
FACTORY = {"iso_flow": "isothermal_flow_config",
           "iso_static": "isothermal_static_config",
           "adia_static": "adiabatic_static_config",
           "adia_flow": "adiabatic_flow_config"}
RTOL, ATOL_REL = 1e-5, 1e-6


def _configs(variant, **kw):
    """(JAX config, port config) of one variant at the test size."""
    kw = {**GEO, **kw}
    return (getattr(jlw, FACTORY[variant])(**kw),
            getattr(tlw, FACTORY[variant])(**kw, use_pallas=True))


def _to_np(jstate):
    """Writable NumPy copies of a JAX state's fields and active mask."""
    return ({k: np.array(v) for k, v in jstate.fields.items()},
            np.array(jstate.active))


def _to_jax(fields, active):
    return JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                  active=jnp.asarray(active))


def _assert_states_equal(tstate, fields, active, exact=None, close=()):
    """Port state against NumPy reference arrays: ``close`` fields within
    rel 1e-6 (a few f32 ulp), every other field (or those in ``exact``)
    bitwise."""
    tf, ta = state_to_numpy(tstate)
    np.testing.assert_array_equal(ta, active)
    for name in exact or fields:
        if name in close:
            np.testing.assert_allclose(tf[name], fields[name], rtol=1e-6,
                                       atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(tf[name], fields[name], err_msg=name)


@pytest.fixture(scope="module", params=["iso_flow", "iso_static",
                                        "lj_floor"])
def built(request):
    """(variant, JAX system, its frozen state, port system, its frozen
    state); "lj_floor" is the isothermal flow on the analytic floor."""
    variant = request.param
    if variant == "lj_floor":
        jcfg, tcfg = _configs("iso_flow", lj_floor=True)
    else:
        jcfg, tcfg = _configs(variant)
    js = jlw.make_system(jcfg)
    ts = tlw.make_system(tcfg)
    return variant, js, js.freeze(), ts, ts.freeze(device="cpu")


def test_frozen_state_matches_jax(built):
    variant, js, jstate, ts, tstate = built
    je, te = js.engine, ts.engine
    assert (te.cap, te.lims, te.phase, te.cells) == (je.cap, je.lims, je.phase,
                                                     je.cells)
    assert te.rescatter_mode == je.rescatter_mode
    expect = {"iso_flow": (16, (128, 16), 745, "sort"),
              "iso_static": (8, (128, 16), 848, "stencil"),
              "lj_floor": (8, (128, 16), 537, "sort")}[variant]
    assert (te.cap, te.lims, int(tstate.n), te.rescatter_mode) == expect
    fields, active = _to_np(jstate)
    assert sorted(fields) == sorted(tstate.fields)
    _assert_states_equal(tstate, fields, active)
    types = {float(t) for t in np.unique(fields["type"][active])}
    assert types == {"iso_flow": {tlw.FLUID, tlw.INFLOW, tlw.WALL,
                                  tlw.MOUNTAIN},
                     "iso_static": {tlw.FLUID, tlw.WALL, tlw.MOUNTAIN},
                     "lj_floor": {tlw.FLUID, tlw.INFLOW, tlw.WALL}}[variant]


def _flow_state(**freeze):
    """The frozen flow systems of both packages with the same engine
    options: (JAX engine, JAX state, port engine, port state)."""
    jcfg, tcfg = _configs("iso_flow")
    js, ts = jlw.make_system(jcfg), tlw.make_system(tcfg)
    jstate = js.freeze(**freeze)
    tstate = ts.freeze(device="cpu", **freeze)
    return js.engine, jstate, ts.engine, tstate


def test_sorted_slot_scatter_matches_jax():
    """The same keys (every active row jittered within its cell's
    neighbourhood, the cap cut to 4 so that rows overflow) through both
    packages' sort move, evaluated eagerly."""
    je, jstate, te, tstate = _flow_state()
    rng = np.random.default_rng(1)
    fields, active = _to_np(jstate)
    x = fields["x"] + np.where(active[:, None],
                               rng.uniform(-900, 900, fields["x"].shape), 0.0)
    fields["x"] = x.astype(np.float32)
    jkey = je._screen_and_key(_to_jax(fields, active))[2]
    tkey = te._screen_and_key(state_from_numpy(fields, active, "cpu"))[2]
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(jkey))
    move = {k: fields[k] for k in ("x", "v", "m", "type")}
    cap = 4
    slots = cap * (je.num_cells + 1)
    jm, ja, jo = jnb.sorted_slot_scatter(
        jkey, {k: jnp.asarray(v) for k, v in move.items()}, je.num_cells, cap,
        slots)
    tm, ta, to = tnb.sorted_slot_scatter(
        tkey, {k: torch.tensor(v) for k, v in move.items()}, te.num_cells,
        cap, slots)
    assert int(to) == int(jo) > 0
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    for k in move:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]),
                                      err_msg=k)


def test_sort_and_stencil_rescatters_agree():
    """Positions moved by less than the skin allows (every particle stays
    within a cell of its slot's cell): the sort and the stencil rescatter
    fill the same slots with the same particles, cell by cell, and drop
    nothing. Within a cell the two order the particles differently (source
    slot order against stencil-offset order), as the reference's do."""
    _, _, te, tstate = _flow_state()
    gen = torch.Generator().manual_seed(2)
    act = tstate.active
    dx = (torch.rand(tstate.fields["x"].shape, generator=gen) * 2 - 1) * 1500
    moved = tstate.replace(x=torch.where(act[:, None],
                                         tstate.fields["x"] + dx, 0.0))
    a, da = te._full_rescatter(moved)
    b, db = te._stencil_rescatter(moved)
    assert int(da) == int(db) == 0
    # rows pushed out of the domain box are screened out, not dropped
    x = moved.fields["x"]
    inside = act & ((x >= torch.tensor(te.mins, dtype=x.dtype))
                    & (x <= torch.tensor(te.maxs, dtype=x.dtype))).all(dim=-1)
    assert torch.equal(a.active, b.active) and int(a.n) == int(inside.sum())
    assert not torch.equal(a.active, tstate.active)  # rows changed slots

    def by_cell(out):
        f, act = state_to_numpy(out)
        col = np.nonzero(act)[0] % (te.num_cells + 1)
        x = f["x"][act]
        order = np.lexsort((x[:, 1], x[:, 0], col))
        return col[order], {k: v[act][order] for k, v in f.items()}

    (ca, fa), (cb, fb) = by_cell(a), by_cell(b)
    np.testing.assert_array_equal(ca, cb)
    for name in fa:
        np.testing.assert_array_equal(fa[name], fb[name], err_msg=name)


def test_cap_past_the_stencil_cost_limit_takes_the_sort_rescatter():
    """9·232 = 2088 > 2048 offsets × cap: the stencil rescatter degrades to
    the sort one (it raised before the sort rescatter was ported); a rebuild
    after a drift past the skin equals the reference's, eagerly."""
    je, jstate, te, tstate = _flow_state(cap=232, rescatter_mode="stencil")
    assert te.cap == je.cap == 232
    assert te.effective_rescatter_mode == je.effective_rescatter_mode == "sort"
    fields, active = _to_np(jstate)
    fields["x"] = np.where(active[:, None], fields["x"] + [700.0, -300.0],
                           0.0).astype(np.float32)
    jout, jn = je.rebuild(_to_jax(fields, active))
    tout, tn = te.rebuild(state_from_numpy(fields, active, "cpu"))
    assert int(tn.overflow) == int(jn.overflow) == 0
    jf, ja = _to_np(jout)
    assert not np.array_equal(ja, active)
    _assert_states_equal(tout, jf, ja)
    np.testing.assert_array_equal(tn.counts.numpy(), np.asarray(jn.counts))


def _closure(fn, name):
    """A free variable of a closure (the reference's ``add_new_particles``
    and both packages' ``accelerate`` live inside their ``make_step``)."""
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells[name].cell_contents


@pytest.mark.parametrize("mode,full", [("stencil", False), ("sort", False),
                                       ("stencil", True)],
                         ids=["slot_targeted", "free_pool", "no_free_rank"])
def test_spawn_matches_jax(mode, full):
    """INFLOW rows moved 0.6·dr downstream: the column nearest the edge
    crosses it and converts, and its spawns go one bc_width upstream. With
    ``full`` every slot of the cells that hold INFLOW rows is marked
    occupied, so the spawns find no free rank in their home cells and are
    dropped and counted."""
    je, jstate, te, tstate = _flow_state(rescatter_mode=mode)
    jcfg, tcfg = _configs("iso_flow")
    fields, active = _to_np(jstate)
    inflow = active & (fields["type"] == jlw.INFLOW)
    fields["x"] = np.where(inflow[:, None], fields["x"] + [0.6 * jcfg.dr, 0.0],
                           fields["x"]).astype(np.float32)
    fields["_xref"] = fields["x"].copy()
    if full:
        col = np.arange(active.shape[0]) % (je.num_cells + 1)
        active = active | np.isin(col, col[inflow])
    jadd = _closure(jlw.make_step(jcfg, je), "add_new_particles")
    jout = jadd(_to_jax(fields, active))
    tin = state_from_numpy(fields, active, "cpu")
    conv = tlw.spawn_sources(tcfg, tin)
    tout = tlw.add_new_particles(tcfg, te, tin)
    jf, ja = _to_np(jout)
    n_conv = int(conv.sum())
    drops = int(jf["_spawn_drops"].sum())
    assert n_conv > 0 and int(ja.sum()) == int(active.sum()) + n_conv - drops
    assert (drops == n_conv) if full else (drops == 0)
    _assert_states_equal(tout, jf, ja, close=("rho", "m", "P"))
    stamped = (jf["_xref"] != fields["_xref"]).any(axis=1).sum()
    assert stamped == (n_conv - drops if mode == "stencil" else 0)


@pytest.fixture(scope="module")
def live():
    """Per variant, (JAX engine, JAX state, port engine, port state): the
    frozen state with v ± 1 m/s, ρ, h and T ± 1 % from a seeded generator."""
    out = {}
    for variant in ("iso_flow", "iso_static"):
        jcfg, tcfg = _configs(variant)
        js, ts = jlw.make_system(jcfg), tlw.make_system(tcfg)
        fields, active = _to_np(js.freeze())
        ts.freeze(device="cpu")
        rng = np.random.default_rng(3)
        n = active.shape[0]
        fields["v"] = np.where(active[:, None], fields["v"]
                               + rng.uniform(-1, 1, (n, 2)), 0.0)
        for name in ("rho", "h", "T"):
            fields[name] = np.where(active, fields[name]
                                    * rng.uniform(0.99, 1.01, n), 0.0)
        fields = {k: v.astype(np.float32) for k, v in fields.items()}
        out[variant] = (js.engine, _to_jax(fields, active), ts.engine,
                        state_from_numpy(fields, active, "cpu"))
    return out


def _check(got, ref, active):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())
    assert np.all(got.numpy()[~active] == 0.0)
    assert np.abs(ref).max() > 0.0


SWEEPS = {  # name: (reference pass, port wrapper, variant, adiabatic)
    "legacy_mass": (pp.legacy_mass_pass, tps.legacy_mass_pass, "iso_flow",
                    False),
    "legacy_force": (pp.legacy_force_pass, tps.legacy_force_pass, "iso_flow",
                     False),
    "iso_static_mass": (pp.iso_static_mass_pass, tps.iso_static_mass_pass,
                        "iso_static", False),
    "iso_static_force": (pp.iso_static_force_pass, tps.iso_static_force_pass,
                         "iso_static", False),
    "adia_density": (pp.adia_density_pass, tps.adia_density_pass,
                     "iso_static", True),
    "adia_entropy_force": (pp.adia_entropy_force_pass,
                           tps.adia_entropy_force_pass, "iso_flow", True),
}


@pytest.mark.parametrize("av,fast_math", [(0.0, False), (0.05, False),
                                          (0.05, True)],
                         ids=["exact", "av", "av_fast_math"])
@pytest.mark.parametrize("sweep", list(SWEEPS))
def test_twin_matches_reference_body(live, sweep, av, fast_math, monkeypatch):
    ref_pass, wrapper, variant, adiabatic = SWEEPS[sweep]
    je, jlive, te, tlive = live[variant]
    flow = variant == "iso_flow"
    factory = ("adiabatic" if adiabatic else "isothermal") + (
        "_flow_config" if flow else "_static_config")
    kw = {**GEO, "av_alpha": av, "fast_math": fast_math}
    jcfg, tcfg = getattr(jlw, factory)(**kw), getattr(tlw, factory)(**kw)
    refs, captured = reference_body_sweep(ref_pass, je, jlive, jcfg,
                                          monkeypatch)
    assert captured["self_pair"] is (sweep == "adia_density")
    before = wrapper.launches
    gots = wrapper(te, tlive, tcfg)
    assert wrapper.launches == before  # CPU tensors: the twin
    gots = gots if isinstance(gots, list) else [gots]
    assert len(gots) == len(refs)
    for got, ref in zip(gots, refs):
        _check(got, ref, tlive.active.numpy())


STEP_VARIANTS = {
    "iso_flow": {},
    "iso_static": {},
    "adia_static": {},
    "adia_flow_corrected": dict(true_rayleigh=True, consistent_entropy=True,
                                outflow_buffer=2 * 1.8 * (26e3 / 14),
                                av_alpha=0.05),
}


def _observed(cfg, diag, mountain, state):
    """u_avg, u_max and, per variant, ΣS and max |S| (adiabatic), Σh and
    max |h − h0| (isothermal static) or the drag and lift (isothermal
    flow)."""
    fields = {k: np.asarray(v) for k, v in state.fields.items()}
    active = np.asarray(state.active)
    out = [float(v) for v in diag(state)]
    if cfg.adiabatic:
        S = fields["S"][active]
        return out + [float(S.sum()), float(np.abs(S).max())]
    if not cfg.flow:
        h = fields["h"][active]
        return out + [float(h.sum()), float(np.abs(h - cfg.h0).max())]
    F = mountain(state)
    return out + [float(F["drag"]), float(F["lift"])]


def _variant_configs(variant, **kw):
    extra = STEP_VARIANTS[variant]
    base = "adia_flow" if variant.startswith("adia_flow") else variant
    return _configs(base, **extra, **kw)


def _compiled_step(jcfg):
    """The reference's flat system, its frozen state and its step compiled
    once with ``QUICK_COMPILE``."""
    js = jlw.make_system(jcfg)
    jstate = js.freeze()
    assert js.engine.layout == "flat"
    jstep = jax.jit(jlw.make_step(jcfg, js.engine)).lower(jstate).compile(
        compiler_options=QUICK_COMPILE)
    return js, jstate, jstep


def _port_run(tcfg, n_steps, **freeze):
    ts = tlw.make_system(tcfg)
    tstate = ts.freeze(device="cpu", **freeze)
    tstep = tlw.make_step(tcfg, ts.engine)
    for _ in range(n_steps):
        tstate = tstep(tstate)
    return ts, tstate


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_steps_match_jax(variant):
    """The port's float32 bucket step (the sweeps' twins) and its float32
    flat step (``apply_binary``) against 8 steps of the reference's float32
    flat step."""
    jcfg, tcfg = _variant_configs(variant)
    jcfg = dataclasses.replace(jcfg, layout="flat")
    js, jstate, jstep = _compiled_step(jcfg)
    for _ in range(8):
        jstate = jstep(jstate)
    ref = _observed(jcfg, j_diag, jlw.mountain_force, jstate)
    flat_cfg = dataclasses.replace(tcfg, layout="flat", use_pallas=False)
    for cfg, layout in ((tcfg, "bucket"), (flat_cfg, "flat")):
        ts, tstate = _port_run(cfg, 8)
        assert ts.engine.layout == layout
        assert tstate.fields["x"].dtype == torch.float32
        assert int(tstate.n) == int(jstate.n) == ts.n_built
        got = _observed(cfg, t_diag, tlw.mountain_force, tstate)
        assert np.all(np.isfinite(got)) and got[1] > 0.0
        np.testing.assert_allclose(got, ref, rtol=2e-4, err_msg=layout)


def _fields_close(jstate, tstate, rel=1e-8):
    """Every field of the port within ``rel`` of the field's largest
    |value| in the reference, rows matched by position."""
    jf, tf = matched_rows(jstate, tstate)
    assert sorted(jf) == sorted(tf)
    for name in jf:
        np.testing.assert_allclose(tf[name], jf[name], rtol=0,
                                   atol=rel * np.abs(jf[name]).max(),
                                   err_msg=name)


@pytest.mark.parametrize("variant", list(STEP_VARIANTS))
def test_flat_float64_steps_match_jax(variant):
    """8 flat float64 steps of each variant (the configs' own layout)
    against the reference's."""
    jcfg, tcfg = _variant_configs(variant, dtype="float64", layout="flat")
    tcfg = dataclasses.replace(tcfg, use_pallas=False)
    js, jstate, jstep = _compiled_step(jcfg)
    for _ in range(8):
        jstate = jstep(jstate)
    ts, tstate = _port_run(tcfg, 8)
    assert (ts.engine.layout, ts.engine.pair_mode, ts.engine.lims) == (
        "flat", js.engine.pair_mode, js.engine.lims)
    assert tstate.fields["x"].dtype == torch.float64
    assert int(tstate.n) == int(jstate.n) == ts.n_built
    got = _observed(tcfg, t_diag, tlw.mountain_force, tstate)
    assert np.all(np.isfinite(got)) and got[1] > 0.0
    np.testing.assert_allclose(
        got, _observed(jcfg, j_diag, jlw.mountain_force, jstate), rtol=1e-8)
    _fields_close(jstate, tstate)


def _spawn_flow(**kw):
    """The isothermal flow whose inflow column sits 50 m upstream of the
    edge: it converts and respawns within 24 steps."""
    return tlw.isothermal_flow_config(n_rows=12, dom_length=51.9e3,
                                      h_m=2000.0, a=6e3, **kw)


def test_spawn_drops_are_counted_at_zero_headroom():
    """The reference's invariant (tests/test_legacy.py): frozen flat at
    capacity == n_built, no spawn finds a free row, and the INFLOW
    reservoir drains by exactly the counted drops."""
    cfg = tlw.isothermal_flow_config(n_rows=12, dom_length=60e3,
                                     dtype="float64")
    ts = tlw.make_system(cfg)
    state = ts.freeze(device="cpu", capacity=ts.n_built)
    assert ts.engine.layout == "flat"
    n_inflow0 = int(tlw.inflow_reservoir(state)["n_inflow"])
    step = tlw.make_step(cfg, ts.engine)
    for _ in range(120):
        state = step(state)
    res = tlw.inflow_reservoir(state)
    drops = int(res["spawn_drops"])
    assert drops > 0
    assert n_inflow0 - int(res["n_inflow"]) == drops


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_faithful_sponge_kick_matches_jax(dtype):
    """One kick (``accelerate``) with the faithful sponge, a constant body
    force above z_t − z_b, on the frozen static state, against the
    reference's closure: v bit for bit in float64 (the sponge built in the
    state's dtype; a float32 sponge left 1.04e-9 m/s² in it) and in
    float32."""
    kw = dict(GEO, dtype=dtype, layout="flat")
    jcfg = jlw.isothermal_static_config(**kw)
    tcfg = tlw.isothermal_static_config(**kw)
    js = jlw.make_system(jcfg)
    fields, active = _to_np(js.freeze())
    y = fields["x"][:, 1]
    assert (active & (fields["type"] == jlw.FLUID)
            & (y >= jcfg.z_t - jcfg.z_b)).sum() > 0
    # any port engine (a float32 bucket one here): the kick reads none
    ts = tlw.make_system(tlw.isothermal_static_config(**GEO, use_pallas=True))
    ts.freeze(device="cpu")
    te = ts.engine
    jkick = _closure(jlw.make_step(jcfg, js.engine), "accelerate")
    tkick = _closure(tlw.make_step(tcfg, te), "accelerate")
    jv = np.asarray(japply.apply_unary(_to_jax(fields, active), jkick)
                    .fields["v"])
    tv = tapply.apply_unary(state_from_numpy(fields, active, "cpu"),
                            tkick).fields["v"].numpy()
    assert tv.dtype == jv.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(tv, jv)


def test_observables_match_jax(live):
    """Every per-frame observable of the module on one identical flow
    state (a few INFLOW rows and spawn drops set by hand)."""
    je, jlive, te, tlive = live["iso_flow"]
    jcfg, tcfg = _configs("iso_flow", lj_floor=False)
    fields, active = _to_np(jlive)
    fields["Dv"] = np.where(active[:, None], np.random.default_rng(4).uniform(
        -1, 1, fields["Dv"].shape), 0.0).astype(np.float32)
    fields["_spawn_drops"][0] = 3.0
    jst, tst = _to_jax(fields, active), state_from_numpy(fields, active, "cpu")
    levels = [3700.0, 5600.0]  # bands holding lattice rows (dr = 1857 m)
    pairs = [
        (jlw.mountain_force, tlw.mountain_force),
        (jlw.inflow_reservoir, tlw.inflow_reservoir),
        (jlw.lj_floor_drag(jcfg), tlw.lj_floor_drag(tcfg)),
        (jlw.wave_momentum_flux(jcfg, 4000.0, 2000.0),
         tlw.wave_momentum_flux(tcfg, 4000.0, 2000.0)),
        (jlw.wave_momentum_flux(jcfg, 4000.0, 2000.0, tag="w", x_window=9e3),
         tlw.wave_momentum_flux(tcfg, 4000.0, 2000.0, tag="w", x_window=9e3)),
        (jlw.wave_momentum_flux_binned(jcfg, 4000.0, 2000.0),
         tlw.wave_momentum_flux_binned(tcfg, 4000.0, 2000.0)),
        (jlw.wave_momentum_flux_profile(jcfg, levels),
         tlw.wave_momentum_flux_profile(tcfg, levels)),
        (jlw.wave_amplitude_profile(jcfg, levels),
         tlw.wave_amplitude_profile(tcfg, levels)),
        (jlw.stationary_wave_bins(jcfg, 3700.0),
         tlw.stationary_wave_bins(tcfg, 3700.0)),
    ]
    for jfn, tfn in pairs:
        jd, td = jfn(jst), tfn(tst)
        assert list(td) == list(jd)
        got = np.array([float(v) for v in td.values()])
        ref = np.array([float(v) for v in jd.values()])
        assert np.abs(ref).max() > 0.0, list(jd)
        np.testing.assert_allclose(got, ref, rtol=RTOL,
                                   atol=ATOL_REL * np.abs(ref).max())
    assert float(tlw.inflow_reservoir(tst)["spawn_drops"]) == 3.0


def test_lj_floor_helpers_match_jax(live):
    """The analytic-floor helpers on the rows of one flow state: the normal
    gap and surface normal, the Lennard-Jones acceleration with and without
    the contact damping, and the wall-truncation fraction of the summed
    density (elementwise: within rel 1e-6 of each quantity's largest
    |value|)."""
    _, jlive, _, tlive = live["iso_flow"]
    jcfg, tcfg = _configs("iso_flow", lj_floor=True)
    act = tlive.active.numpy()
    x, v = tlive.fields["x"], tlive.fields["v"]
    jx, jv = jlive.fields["x"], jlive.fields["v"]
    pairs = [(jlw._floor_gap(jcfg, jx)[0], tlw._floor_gap(tcfg, x)[0]),
             (jlw._floor_gap(jcfg, jx)[1], tlw._floor_gap(tcfg, x)[1]),
             (jlw._lj_floor_acc(jcfg, jx), tlw._lj_floor_acc(tcfg, x)),
             (jlw._lj_floor_acc(jcfg, jx, jv), tlw._lj_floor_acc(tcfg, x, v)),
             (jlw._wall_fraction(jcfg, jx), tlw._wall_fraction(tcfg, x))]
    for ref, got in pairs:
        ref, got = np.asarray(ref)[act], got.numpy()[act]
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max())
        assert np.abs(ref).max() > 0.0
    acc = tlw._lj_floor_acc(tcfg, x).numpy()[act]
    assert np.abs(acc).max() > 0.0  # some rows sit within r0 of the floor


@pytest.mark.parametrize("layout", ["bucket", "flat"],
                         ids=["bucket-f32", "flat-f64"])
def test_flow_run_writes_files_and_resumes_bitwise(tmp_path, capsys, layout):
    """A flow config whose inflow column sits 50 m upstream of the edge, so
    that it converts and respawns within the run's 24 steps: the float32
    bucket layout (slot-targeted spawns under the stencil rescatter) and
    the config's flat layout in float64 (spawns in the spare flat rows).
    The flat float64 run's state is held against the reference's 24
    compiled steps: active count, ``n_inflow`` and ``spawn_drops``
    exactly, every field within 1e-8 of its max with rows matched by
    position (measured: active 741 -> 754, fields 5.9e-15)."""
    kw = (dict(use_pallas=True) if layout == "bucket"
          else dict(dtype="float64"))
    cfg = _spawn_flow(checkpoint_every=1, n_frames=2, **kw)
    cfg = dataclasses.replace(cfg, t_end=24 * cfg.dt)
    whole = tlw.run(dataclasses.replace(cfg, live_plot=True),
                    out_path=str(tmp_path / "whole"), device="cpu")
    # live plots: the sparklines of u_max and the extra observables
    assert capsys.readouterr().out.count("drag [") == 2
    assert sorted(os.listdir(tmp_path / "whole")) == [
        "checkpoint.npz", "data.csv", "frame0.vtp", "frame1.vtp",
        "frame2.vtp", "result.pvd", "velocities.pdf"]
    csv = read_csv(str(tmp_path / "whole" / "data.csv"))
    assert list(csv) == ["t", "u_avg", "u_max", "drag", "lift", "n_inflow",
                         "spawn_drops"]
    system = whole["system"]
    assert system.engine.layout == layout
    assert system.engine.rescatter_mode == (
        "stencil" if layout == "bucket" else "sort")
    assert whole["state"].fields["x"].dtype == cfg.torch_dtype
    assert int(whole["state"].n) > system.n_built  # the spawn event fired
    assert np.all(csv["spawn_drops"] == 0.0)
    assert csv["n_inflow"][-1] == csv["n_inflow"][0]
    np.testing.assert_array_equal(csv["drag"], whole["drag"])
    if layout == "flat":
        jcfg = jlw.isothermal_flow_config(**{
            f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name not in ("flow", "adiabatic")})
        _, jstate, jstep = _compiled_step(jcfg)
        for _ in range(24):
            jstate = jstep(jstate)
        tstate = whole["state"]
        assert tstate.capacity == jstate.capacity
        assert int(tstate.n) == int(jstate.n)
        jres, tres = jlw.inflow_reservoir(jstate), tlw.inflow_reservoir(tstate)
        assert int(tres["n_inflow"]) == int(jres["n_inflow"])
        assert int(tres["spawn_drops"]) == int(jres["spawn_drops"]) == 0
        _fields_close(jstate, tstate)
    # the reference reads the port's checkpoint, the bookkeeping included
    jstate, meta = j_load_checkpoint(
        str(tmp_path / "whole" / "checkpoint.npz"))
    assert meta["extra"]["step"] == 24
    assert j_engine_from_meta(meta).layout == layout
    np.testing.assert_array_equal(
        np.asarray(jstate.fields["_spawn_drops"]),
        whole["state"].fields["_spawn_drops"].numpy())
    np.testing.assert_array_equal(np.asarray(jstate.fields["x"]),
                                  whole["state"].fields["x"].numpy())

    half = dataclasses.replace(cfg, t_end=cfg.t_end / 2, n_frames=1)
    tlw.run(half, out_path=str(tmp_path / "part"), device="cpu")
    resumed = tlw.run(dataclasses.replace(
        cfg, resume=str(tmp_path / "part" / "checkpoint.npz")),
        out_path=str(tmp_path / "part"), device="cpu")
    for name, ref in whole["state"].fields.items():
        assert torch.equal(resumed["state"].fields[name], ref), name
    assert torch.equal(resumed["state"].active, whole["state"].active)
    merged = read_csv(str(tmp_path / "part" / "data.csv"))
    for name in csv:
        np.testing.assert_array_equal(merged[name], csv[name], err_msg=name)


def test_entry_points_need_a_card_and_refuse_what_is_not_ported(monkeypatch):
    """Without ``device=`` ``run`` asks for CUDA and raises where there is
    none; a float64 terrain config builds and freezes on its flat layout,
    and a float64 state on the bucket layout is refused at its first
    step."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs("iso_flow")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tlw.run(cfg)
    cfg64 = tlw.isothermal_static_config(n_rows=14, dtype="float64")
    ts = tlw.make_system(cfg64)
    state = ts.freeze(device="cpu")
    assert ts.engine.layout == "flat"
    assert state.fields["x"].dtype == torch.float64
    assert int(state.n) == ts.n_built
    bucket = dataclasses.replace(cfg64, layout="bucket")
    tb = tlw.make_system(bucket)
    state = tb.freeze(device="cpu")
    assert tb.engine.layout == "bucket"
    with pytest.raises(NotImplementedError, match="float32"):
        tlw.make_step(bucket, tb.engine)(state)
