"""The port's dam-break family against the JAX package on the CPU: the
dam-break continuity and force sweeps in 2-D and 3-D, ``collapse_dry`` and
``collapse3d``.

Sizes (the reference's own Pallas-vs-XLA gates, tests/test_pallas.py):
``collapse_dry`` at dr=0.08 (N = 587, grid 128 × 16, cap 24) and
``collapse3d`` at dr=2e-2 (N = 4,636, grid 128 × 16 × 8, cap 40: 27·40 =
1,080 candidate slots per particle), float32, bucket layout, skin 0.2.

What is compared, and at which tolerance:

* both frozen states slot for slot and bit for bit;
* the continuity and force twins, 2-D and 3-D, against the reference's own
  pair bodies summed eagerly in the Pallas harness's order
  (tests/torch_reference_harness.py, which the flagship, Hopkins and Pavelka
  files tie to real interpret-mode ``pallas_call``s; a dam-break pass of its
  own would add 15 s of tracing). Inputs: the frozen state with v ±1 m/s,
  ρ ±1 % and P in 0–5 kPa from a seeded NumPy generator. Gate: rtol 1e-5,
  atol = 1e-6 × the output's largest |value| (the continuity sum cancels
  like the Pavelka one); WALL p slots of the force are exactly zero;
* ``init_forces`` + 6 steps of ``collapse_dry`` and 2 steps of ``collapse3d``
  against the reference's XLA path: mean and max |v| and (2-D) X, H, E of
  ``get_globals`` at rel 1e-5, equal active counts. The reference runs in
  its default flat layout: its XLA bucket path evaluates every slot against
  all 27·cap candidates (655,400 slots × 1,080 in 3-D: 14 s a step on one
  core), the flat one only the particles, and at skin 0, its default (cap
  16 against the bucket config's 40 at skin 0.2). Two 3-D steps because the
  port's CPU twins take 1.7 s a step at cap 40;
* ``tile_kmax``, the trip bound of the tiled 3-D sweep (one per x-tile of
  6 cells at cap 40), against a brute-force NumPy loop over each tile's
  (6+2)×3×3 cells, exactly, on the tiny ``collapse3d`` state, on a
  hand-made occupancy (a 27-particle wall cell beside 8-particle cells, a
  ragged last tile) and on an empty grid; never above ``row_kmax``'s band;
  the same in 2-D (the tiled Pavelka sweeps, the flagship momentum and the
  Hopkins momentum: (TX+2)×3 cells a tile) on the
  tiny Pavelka state, a hand-made occupancy at cap 24 with full cells beside
  empty ones and a ragged last tile, and an empty grid;
* ``run(cfg, out_path=..., device="cpu")`` of ``collapse_dry``: the file set,
  the columns of ``data.csv``, and a resumed run bit for bit equal to the
  uninterrupted one;
* ``collapse3d`` on the flat layout, 4 steps against the reference's own
  flat steps (compiled with ``QUICK_COMPILE``), rows matched by position:
  its defaults (float64) at dr=0.04 (N = 1,170, flat grid 11 × 8 × 6, cap
  16, "gather") with every field within 1e-10 of its largest |value|; float32 on the reference run that the bucket
  steps above are held against (dr=2e-2, skin 0), every field at rtol 1e-5
  and atol 1e-6 × its largest |value|;
* the implicit (ISPH) dam break ``collapse_dry_implicit.run`` at dr=0.1
  (N = 533), 3 frames of 2 steps, against the reference's own step through
  the same frames: the files the reference's ``run`` writes (frame0-2.vtp,
  result.pvd), and X, H, E at rtol 1e-9 (measured: at most 2.2e-16); its
  defaults (float64 flat) at dr=0.05 build and step (the card runs them at
  their dr 0.01);
* every entry point refuses to start without a card unless the caller
  asks for the CPU; ``collapse_dry`` and ``collapse3d`` build their
  reference default configs (flat, float64) and step them, and refuse a
  float64 bucket state at its first step.
"""
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_mountain_waves_tpu.ops.pallas_pairs as pp
from sph_mountain_waves_tpu.models import (
    collapse3d as jc3, collapse_dry as jcd, collapse_dry_implicit as jci,
)
from sph_mountain_waves_tpu.structs import ParticleState as JState

from sph_mountain_waves_tpu_torch.geometry import Box
from sph_mountain_waves_tpu_torch.interop import state_from_numpy, state_to_numpy
from sph_mountain_waves_tpu_torch.io import read_csv, read_vtp
from sph_mountain_waves_tpu_torch.models import (
    collapse3d as tc3, collapse_dry as tcd, collapse_dry_implicit as tci,
    pavelka_total_witch as tpv, witch3d as tw,
)
from sph_mountain_waves_tpu_torch.models.common import frame_runner
from sph_mountain_waves_tpu_torch.ops import pair_sweeps as tps
from sph_mountain_waves_tpu_torch.ops.neighbors import NeighborEngine
from scipy.spatial import cKDTree
from torch_reference_harness import QUICK_COMPILE, reference_body_sweep

torch.set_num_threads(1)

DRY = dict(dr=0.08, dtype="float32", layout="bucket", skin=0.2,
           use_pallas=True, t_end=0.1)
C3D = dict(dr=2.0e-2, dtype="float32", layout="bucket", skin=0.2,
           use_pallas=True, t_end=0.05)
MODELS = {"collapse_dry": (jcd, tcd, DRY), "collapse3d": (jc3, tc3, C3D)}
RTOL, ATOL_REL = 1e-5, 1e-6


def _to_np(jstate):
    return ({k: np.asarray(v) for k, v in jstate.fields.items()},
            np.asarray(jstate.active))


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=QUICK_COMPILE)


def _all_finite(state):
    return all(bool(torch.isfinite(v).all()) for v in state.fields.values())


@pytest.fixture(scope="module", params=list(MODELS))
def built(request):
    """(name, JAX system, its frozen state, port system, its frozen state)."""
    jm, tm, kw = MODELS[request.param]
    js = jm.make_system(jm.Config(**kw))
    jstate = js.freeze()
    ts = tm.make_system(tm.Config(**kw))
    tstate = ts.freeze(device="cpu")
    return request.param, js, jstate, ts, tstate


@pytest.fixture(scope="module")
def live(built):
    """(name, JAX engine, JAX state, port engine, port state), perturbed."""
    name, js, jstate, ts, _ = built
    fields, active = _to_np(jstate)
    rng = np.random.default_rng(0)
    n, d = active.shape[0], ts.engine.dim
    fields["v"] = np.where(active[:, None], rng.uniform(-1, 1, (n, d)),
                           0.0).astype(np.float32)
    fields["rho"] = np.where(active, fields["rho"] * rng.uniform(0.99, 1.01, n),
                             0.0).astype(np.float32)
    fields["P"] = np.where(active, rng.uniform(0.0, 5e3, n),
                           0.0).astype(np.float32)
    jlive = JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                   active=jnp.asarray(active))
    return (name, js.engine, jlive, ts.engine,
            state_from_numpy(fields, active, "cpu"))


def _check(got, ref, active):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())
    assert np.all(got.numpy()[~active] == 0.0)
    assert np.abs(ref).max() > 1.0


def test_frozen_state_matches_jax(built):
    name, js, jstate, ts, tstate = built
    je, te = js.engine, ts.engine
    assert (te.cap, te.lims, te.phase, te.cells) == (je.cap, je.lims, je.phase,
                                                     je.cells)
    expect = {"collapse_dry": (2, 24, (128, 16), 587),
              "collapse3d": (3, 40, (128, 16, 8), 4636)}[name]
    assert (te.dim, te.cap, te.lims, int(tstate.n)) == expect
    jf, ja = _to_np(jstate)
    tf, ta = state_to_numpy(tstate)
    assert sorted(jf) == sorted(tf)
    np.testing.assert_array_equal(ta, ja)
    for field in jf:
        assert tf[field].dtype == jf[field].dtype, field
        np.testing.assert_array_equal(tf[field], jf[field], err_msg=field)
    if name == "collapse3d":  # the ParticleSystem default reaches every row
        assert np.all(tf["rho"][ta] == 1000.0)


def test_mass_twin_matches_reference(live, monkeypatch):
    name, je, jlive, te, tlive = live
    jm, tm, kw = MODELS[name]
    jcfg, tcfg = jm.Config(**kw), tm.Config(**kw)
    (ref,), captured = reference_body_sweep(pp.dambreak_mass_pass, je, jlive,
                                            jcfg, monkeypatch)
    assert captured["self_pair"] is False
    assert len(captured["fields"]) == 1 + 2 * te.dim
    before = tps.dambreak_mass_pass.launches
    got = tps.dambreak_mass_pass(te, tlive, tcfg)
    assert tps.dambreak_mass_pass.launches == before  # CPU tensors: the twin
    _check(got, ref, tlive.active.numpy())


def test_force_twin_matches_reference(live, monkeypatch):
    name, je, jlive, te, tlive = live
    jm, tm, kw = MODELS[name]
    jcfg, tcfg = jm.Config(**kw), tm.Config(**kw)
    refs, captured = reference_body_sweep(pp.dambreak_force_pass, je, jlive,
                                          jcfg, monkeypatch)
    assert len(captured["fields"]) == 2 + 2 * te.dim
    before = tps.dambreak_force_pass.launches
    gots = tps.dambreak_force_pass(te, tlive, tcfg)
    assert tps.dambreak_force_pass.launches == before
    assert len(gots) == len(refs) == te.dim
    active = tlive.active.numpy()
    wall = active & (tlive.fields["type"].numpy() == 1.0)
    assert wall.sum() > 0
    for got, ref in zip(gots, refs):
        _check(got, ref, active)
        assert np.all(got.numpy()[wall] == 0.0)  # the p-side FLUID gate


def _tile_kmax_brute(counts: np.ndarray, tx: int) -> np.ndarray:
    """Per x-tile of ``tx`` cells of each grid row of the cell counts
    [nz, ny, nx], the largest count among the tile's cells and their
    neighbours inside the grid, in (z, y, tile) order."""
    nz, ny, nx = counts.shape
    out = []
    for z in range(nz):
        for y in range(ny):
            for x0 in range(0, nx, tx):
                block = counts[max(z - 1, 0):z + 2, max(y - 1, 0):y + 2,
                               max(x0 - 1, 0):x0 + tx + 1]
                out.append(block.max())
    return np.array(out)


def _hand_made_occupancy(engine):
    """A block of 8-particle cells with a 27-particle wall cell beside it at
    a tile's edge, and a 12-particle cell in the ragged last tile; ranks
    packed from 0."""
    counts = np.zeros(tuple(reversed(engine.lims)), dtype=np.int64)
    counts[2:6, 3:9, 10:40] = 8
    counts[4, 5, 11] = 27   # last cell of tile x 6..11, staged by x 12..17
    counts[7, 0, 127] = 12  # in the ragged last tile, x 126..127
    return counts


def _active_of(engine, counts):
    ranks = np.arange(engine.cap)[:, None]
    occ = ranks < counts.reshape(1, -1)                 # [cap, C]
    occ = np.pad(occ, ((0, 0), (0, 1)))                 # the trash column
    return torch.from_numpy(occ.reshape(-1))


@pytest.mark.parametrize("case", ["collapse3d", "hand-made", "empty",
                                  "density-3d", "dambreak-3d",
                                  "dambreak-force-3d"])
def test_tile_kmax_matches_a_brute_force_count(case):
    """The per-tile trip bound of the tiled 3-D sweep at cap 40 (TX = 6:
    128 x-cells leave a ragged last tile of 2) equals the largest count
    among each tile's (6+2)×3×3 cells, exactly, and is never above the row
    band of its row. "density-3d", "dambreak-3d" and "dambreak-force-3d":
    the hand-made occupancy through ``_trip_bound("density_sweep", …)``,
    ``_trip_bound("dambreak_mass_sweep", …)`` and
    ``_trip_bound("dambreak_force_sweep", …)``, which name tiled 2-D exports
    too: a 3-D engine still takes ``density_sweep_3d``,
    ``dambreak_mass_sweep_3d`` and ``dambreak_force_sweep_3d`` (8 staged
    planes each) and the 3-D bound."""
    if case == "collapse3d":
        system = tc3.make_system(tc3.Config(**C3D))
        state = system.freeze(device="cpu")
        engine = system.engine
    else:
        engine = NeighborEngine.create(Box(0.0, 0.0, 0.0, 1.0, 1.0, 1.0),
                                       0.1, 3, cap=40)
        counts = (np.zeros(tuple(reversed(engine.lims)), np.int64)
                  if case == "empty" else _hand_made_occupancy(engine))
        state = types.SimpleNamespace(active=_active_of(engine, counts))
    counts = engine.grid_view(state.active).sum(dim=0).numpy()
    tx = tps._tile_plan(engine, tps._TILED_STAGED["dambreak_mass_sweep_3d"]).tx
    assert engine.cap == 40 and tx == 6 and engine.lims[0] % tx == 2
    got = tps.tile_kmax(engine, state, tx)
    named = {"density-3d": ("density_sweep", 5),
             "dambreak-3d": ("dambreak_mass_sweep", 8),
             "dambreak-force-3d": ("dambreak_force_sweep", 8)}
    if case in named:
        name, staged = named[case]
        assert tps._export(name, engine) == name + "_3d"
        assert tps._staged(name + "_3d") == staged
        assert torch.equal(tps._trip_bound(name, engine, state), got)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _tile_kmax_brute(counts, tx))
    band, _ = tps.row_kmax(engine, state)
    ntiles = -(-engine.lims[0] // tx)
    assert bool((got.reshape(-1, ntiles) <= band[:, None]).all())
    assert int(got.max()) == int(counts.max())
    if case != "empty" and case != "collapse3d":
        # the wall cell bounds its tile and the next
        assert int((got == 27).sum()) == 3 * 3 * 2


@pytest.mark.parametrize("case", ["pavelka", "hand-made", "empty"])
def test_tile_kmax_matches_a_brute_force_count_in_2d(case):
    """The per-tile trip bound of the tiled 2-D sweeps (the Pavelka pair,
    the flagship density and momentum, the Hopkins pressure root and
    momentum, the packing's ∇Γ sum, the terrain continuity and force, the
    per-particle-h continuity and force, the fused adiabatic sweep, the
    ISPH matvec, divergence/viscous sweep and
    pressure gradient, the dam-break continuity and force and the
    Rayleigh–Bénard sweep: each export's ``_trip_bound``)
    equals the largest count
    among each tile's (TX+2)×3 cells, exactly, and is never above the row
    band of its row: on the tiny Pavelka state (cap 8, TX 32), on a
    hand-made occupancy at cap 24 (TX 10: 128 x-cells leave
    a ragged last tile of 8) with full cells beside empty ones, and on an
    empty grid."""
    if case == "pavelka":
        system = tpv.make_system(tpv.PavelkaConfig(
            n_rows=10, dtype="float32", layout="bucket", skin=0.15,
            use_pallas=True, lattice_cells=True))
        state = system.freeze(device="cpu")
        engine = system.engine
    else:
        engine = NeighborEngine.create(Box(0.0, 0.0, 0.0, 1.0, 1.0, 1.0),
                                       0.1, 2, cap=24)
        counts = np.zeros(tuple(reversed(engine.lims)), dtype=np.int64)
        if case == "hand-made":
            counts[3:9, 10:40] = 4
            counts[5, 19] = 24   # last cell of tile x 10..19, staged by 20..29
            counts[12, 60] = 24  # a full cell with no neighbour
            counts[0, 127] = 7   # in the ragged last tile, x 120..127
        state = types.SimpleNamespace(active=_active_of(engine, counts))
    counts = engine.grid_view(state.active).sum(dim=0).numpy()
    kernel = "pavelka_momentum_entropy_sweep"
    tx = tps._tile_plan(engine, tps._TILED_STAGED[kernel]).tx
    assert tx == {8: 32, 24: 10}[engine.cap]
    assert case == "pavelka" or engine.lims[0] % tx == 8
    got = tps.tile_kmax(engine, state, tx)
    assert got.dtype == torch.int32
    for name in ("pavelka_mass_sweep", kernel, "momentum_sweep",
                 "pressure_sweep", "hopkins_momentum_sweep",
                 "legacy_mass_sweep", "legacy_force_sweep",
                 "isph_matvec_sweep", "density_sweep", "gamma_grad_sweep",
                 "dambreak_mass_sweep", "rb_mass_heat_sweep",
                 "dambreak_force_sweep", "isph_div_visc_sweep",
                 "isph_grad_sweep", "iso_static_force_sweep",
                 "iso_static_mass_sweep", "adia_entropy_force_sweep"):
        assert torch.equal(got, tps._trip_bound(name, engine, state)), name
    np.testing.assert_array_equal(got.numpy(),
                                  _tile_kmax_brute(counts[None], tx))
    band, _ = tps.row_kmax(engine, state)
    ntiles = -(-engine.lims[0] // tx)
    assert bool((got.reshape(-1, ntiles) <= band[:, None]).all())
    assert int(got.max()) == int(counts.max())
    if case == "hand-made":  # each full cell bounds its tile and the next
        assert int((got == 24).sum()) == 2 * 3 * 2


def _reference_flat_steps(jm, jcfg, n_steps, init=False):
    """The reference's own flat steps (``init_forces`` first with ``init``),
    compiled once with ``QUICK_COMPILE``: (system, state after every
    step)."""
    js = jm.make_system(jcfg)
    jstate = js.freeze()
    jstep = jm.make_step(jcfg, js.engine)
    if init:
        jstep, jinit = jstep
        jstate = _compiled(jinit, jstate)(jstate)
    jstep = _compiled(jstep, jstate)
    states = []
    for _ in range(n_steps):
        jstate = jstep(jstate)
        states.append(jstate)
    return js, states


# the reference's default flat layout (skin 0) at the bucket configs' sizes
FLAT = dict(layout="flat", use_pallas=False, skin=0.0)


@pytest.fixture(scope="module")
def c3d_ref_flat32():
    """The reference's collapse3d on its default flat layout in float32 at
    the bucket config's size: the states after each of 4 steps."""
    return _reference_flat_steps(jc3, jc3.Config(**{**C3D, **FLAT}), 4)[1]


def test_steps_match_jax(built, request):
    name, _, _, ts, tstate = built
    jm, tm, kw = MODELS[name]
    n_steps = 6 if name == "collapse_dry" else 2
    jcfg = jm.Config(**{**kw, **FLAT})
    tcfg = tm.Config(**kw)
    if name == "collapse_dry":
        jstate = _reference_flat_steps(jm, jcfg, n_steps, init=True)[1][-1]
        tstep, tinit = tm.make_step(tcfg, ts.engine)
        tstate = tinit(tstate)
        assert float(tstate.fields["Dv"].abs().max()) > 0.0
    else:
        jstate = request.getfixturevalue("c3d_ref_flat32")[n_steps - 1]
        tstep = tm.make_step(tcfg, ts.engine)
    for _ in range(n_steps):
        tstate = tstep(tstate)
    assert int(tstate.n) == int(jstate.n) == ts.n_built

    def speeds(v, active):
        v = np.abs(np.asarray(v)[np.asarray(active)])
        return [float(v.mean()), float(v.max())]

    jd = speeds(jstate.fields["v"], jstate.active)
    td = speeds(tstate.fields["v"].numpy(), tstate.active.numpy())
    assert np.all(np.isfinite(td)) and td[1] > 0.0
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    if name == "collapse_dry":
        jg = [float(v) for v in jm.get_globals(jcfg, jstate)]
        tg = [float(v) for v in tm.get_globals(tcfg, tstate)]
        np.testing.assert_allclose(tg, jg, rtol=1e-5)
    else:
        jf = jstate.fields
        jE = float(jnp.sum(jnp.where(
            jstate.active, 0.5 * jcfg.m * jnp.sum(jf["v"] ** 2, axis=-1)
            - jcfg.m * jcfg.g * jf["x"][:, 2], 0.0)))
        assert float(tm.energy(tcfg, tstate)) == pytest.approx(jE, rel=1e-5)


def _matched(jstate, tstate):
    """(JAX fields, port fields) on the active rows, the JAX rows in the
    port's order (nearest position, within 1e-6 m): the two stable sorts of
    the flat rebuild order a particle on a cell edge differently when its
    key flips with its last bit."""
    jf, ja = _to_np(jstate)
    tf, ta = state_to_numpy(tstate)
    dist, perm = cKDTree(jf["x"][ja]).query(tf["x"][ta])
    assert dist.max() < 1e-6 and len(np.unique(perm)) == len(perm)
    return ({k: v[ja][perm] for k, v in jf.items()},
            {k: v[ta] for k, v in tf.items()})


@pytest.fixture(scope="module")
def c3d_flat64():
    """collapse3d at its defaults (flat, float64) but dr=0.04: the port's
    system and its state after 4 steps."""
    cfg = tc3.Config(dr=0.04)
    ts = tc3.make_system(cfg)
    tstate = ts.freeze(device="cpu")
    return ts, frame_runner(tc3.make_step(cfg, ts.engine), 4)(tstate)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_flat_collapse3d_steps_match_jax(dtype, request):
    if dtype == "float64":
        jstate = _reference_flat_steps(jc3, jc3.Config(dr=0.04), 4)[1][-1]
        ts, tstate = request.getfixturevalue("c3d_flat64")
        rtol, atol_rel = 0.0, 1e-10
    else:
        jstate = request.getfixturevalue("c3d_ref_flat32")[-1]
        tcfg = tc3.Config(**{**C3D, **FLAT})
        ts = tc3.make_system(tcfg)
        tstate = ts.freeze(device="cpu")
        tstate = frame_runner(tc3.make_step(tcfg, ts.engine), 4)(tstate)
        rtol, atol_rel = RTOL, ATOL_REL
    assert ts.engine.layout == "flat"
    assert tstate.fields["x"].dtype == getattr(torch, dtype)
    assert int(tstate.n) == int(jstate.n) == ts.n_built
    jf, tf = _matched(jstate, tstate)
    assert sorted(jf) == sorted(tf) and np.abs(tf["a"]).max() > 0.0
    for field in jf:
        ref = jf[field]
        np.testing.assert_allclose(tf[field], ref, rtol=rtol,
                                   atol=atol_rel * np.abs(ref).max(),
                                   err_msg=field)


def test_implicit_dam_break_run_matches_jax(tmp_path):
    """``collapse_dry_implicit.run`` against the reference's own step
    (compiled once with ``QUICK_COMPILE``) taken through the same frames,
    the files the reference's ``run`` writes, and its default
    configuration built and stepped."""
    kw = dict(dr=0.1, t_end=0.034, n_frames=3)
    tdir = str(tmp_path / "port")
    got = tci.run(tci.Config(**kw), out_path=tdir, device="cpu")
    jcfg = jci.Config(**kw)
    steps_per_frame = int(round(jcfg.t_end / jcfg.n_frames / jcfg.dt))
    states = _reference_flat_steps(jci, jcfg, 3 * steps_per_frame)[1]
    ref = np.asarray([[float(v) for v in jci.get_globals(jcfg, st)]
                      for st in states[steps_per_frame - 1::steps_per_frame]])
    assert sorted(os.listdir(tdir)) == [
        "frame0.vtp", "frame1.vtp", "frame2.vtp", "result.pvd"]
    assert got["system"].engine.layout == "flat"
    assert int(got["state"].n) == got["system"].n_built == 533
    t = np.arange(1, 4) * steps_per_frame * jcfg.dt * np.sqrt(-2.0 * jcfg.g)
    np.testing.assert_allclose(got["t"], t, rtol=1e-12)
    for col, obs in enumerate(("X", "H", "E")):
        assert len(got[obs]) == 3
        np.testing.assert_allclose(got[obs], ref[:, col], rtol=1e-9,
                                   err_msg=obs)
    pts, data = read_vtp(os.path.join(tdir, "frame2.vtp"))
    assert len(pts) == 533 and sorted(data) == ["P", "type", "v"]
    assert np.abs(data["P"]).max() > 0.0

    # the defaults at dr 0.05 (the card runs them at their dr 0.01), one
    # step from rest
    cfg = tci.Config(dr=0.05)
    sys_ = tci.make_system(cfg)
    state = sys_.freeze(device="cpu")
    state = tci.make_step(cfg, sys_.engine)(state)
    assert state.fields["x"].dtype == torch.float64
    assert sys_.engine.layout == "flat" and int(state.n) == sys_.n_built
    P = state.fields["P"][state.active]
    assert torch.isfinite(P).all() and float(P.abs().max()) > 0.0


def test_collapse_dry_run_writes_files_and_resumes_bitwise(tmp_path):
    kw = dict(DRY, t_end=1.92e-3, n_frames=2, checkpoint_every=1)
    cfg = tcd.Config(**kw)
    steps_per_frame = int(round(cfg.t_end / cfg.n_frames / cfg.dt))
    assert steps_per_frame == 2
    whole = tcd.run(cfg, out_path=str(tmp_path / "whole"), device="cpu")
    assert sorted(os.listdir(tmp_path / "whole")) == [
        "checkpoint.npz", "dambreak_H.pdf", "dambreak_X.pdf", "data.csv",
        "frame0.vtp", "frame1.vtp", "frame2.vtp", "result.pvd"]
    csv = read_csv(str(tmp_path / "whole" / "data.csv"))
    assert list(csv) == ["t", "X", "H", "E"] and len(csv["t"]) == 3
    np.testing.assert_array_equal(csv["X"], whole["X"])
    assert csv["t"][0] == 0.0 and np.all(np.isfinite(csv["E"]))
    pts, data = read_vtp(str(tmp_path / "whole" / "frame2.vtp"))
    assert len(pts) == 587 and sorted(data) == ["P", "type", "v"]

    # stop after the first frame, then resume from its checkpoint
    first = tcd.run(tcd.Config(**{**kw, "t_end": cfg.t_end / 2, "n_frames": 1}),
                    out_path=str(tmp_path / "part"), device="cpu")
    assert len(first["t"]) == 2
    resumed = tcd.run(
        tcd.Config(**kw, resume=str(tmp_path / "part" / "checkpoint.npz")),
        out_path=str(tmp_path / "part"), device="cpu")
    for name, ref in whole["state"].fields.items():
        assert torch.equal(resumed["state"].fields[name], ref), name
    assert torch.equal(resumed["state"].active, whole["state"].active)
    assert resumed["E"][-1] == whole["E"][-1]
    merged = read_csv(str(tmp_path / "part" / "data.csv"))
    np.testing.assert_array_equal(merged["E"], whole["E"])


@pytest.mark.parametrize("module", [tw, tcd, tc3, tci],
                         ids=["witch3d", "collapse_dry", "collapse3d",
                              "collapse_dry_implicit"])
def test_run_needs_a_card_unless_asked_for_the_cpu(module, monkeypatch,
                                                  request):
    """Without ``device=`` the entry points ask for CUDA; where there is
    none they raise, and never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = {tw: lambda: tw.Witch3DConfig(
               n_rows=6, dom_length=60e3, dom_depth=10e3, bc_rows=3,
               dtype="float32", layout="bucket", use_pallas=True),
           tcd: lambda: tcd.Config(**DRY),
           tc3: lambda: tc3.Config(**C3D),
           tci: lambda: tci.Config(dr=0.1)}[module]()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        module.run(cfg)
    if module in (tcd, tc3):
        # the dam breaks' defaults (flat layout, float64; a small dr here)
        # build and step, and a float64 state on the bucket layout is
        # refused at its first step
        kw = DRY if module is tcd else C3D
        if module is tcd:
            cfg = module.Config(dr=kw["dr"])
            flat = module.make_system(cfg)
            state = flat.freeze(device="cpu")
            state = module.make_step(cfg, flat.engine)[0](state)
        else:
            flat, state = request.getfixturevalue("c3d_flat64")
        assert flat.engine.layout == "flat"
        assert state.fields["x"].dtype == torch.float64
        assert int(state.n) == flat.n_built and _all_finite(state)
        cfg64 = module.Config(**{**kw, "dtype": "float64"})
        bucket = module.make_system(cfg64)
        state = bucket.freeze(device="cpu")
        step = module.make_step(cfg64, bucket.engine)
        step = step[0] if module is tcd else step
        with pytest.raises(NotImplementedError, match="float32"):
            step(state)
