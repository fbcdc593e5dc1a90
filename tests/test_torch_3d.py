"""The port's 3-D path against the JAX package on the CPU: the 27-offset
engine, the 3-D density and momentum sweeps and ``witch3d``.

Size: the reference's own tiny 3-D system (tests/test_witch3d.py ``TINY``:
n_rows=6, 60 km × 10 km × 26 km, 3 fence rows) with eta=1.2, float32, bucket
layout, ``lattice_cells``, skin 0.15: N = 1,603, grid 128 × 8 × 8, cap 16.

What is compared, and at which tolerance:

* the frozen state slot for slot and bit for bit, also at n_rows=12 with
  ``bucket_cap=8`` and one fence row (dr = 26000/12 is not exactly
  representable: without the 1e-6 downward nudge of the cell width a fifth
  of the rows would overflow);
* a forced rescatter after a seeded drift of up to 0.6 cell widths, exact
  against the reference's ``_stencil_rescatter`` over 27 offsets, dropped
  count included, at cap 8 (full cells, so rows are really dropped);
* ``row_kmax`` in 3-D, exact;
* the 3-D density and momentum twins (exact divides and ``fast_math``)
  against the reference's own pair bodies summed eagerly in the Pallas
  harness's order (tests/torch_reference_harness.py; an interpret-mode 3-D
  pass unrolls cap × 27 bodies and takes minutes). Gate: rtol 1e-5, atol =
  1e-6 × the output's largest |value|;
* ``renormalize_mass`` (2 iterations) and then 4 steps against the
  reference's XLA path: m, h, ρ at rtol 1e-5, u_avg and u_max at rel 1e-5,
  equal active counts. The reference runs in its default flat layout here:
  its XLA bucket path evaluates every slot against 27·cap candidates
  (131,088 slots × 432) and takes over a minute on one core, compile
  included, the flat one seconds. Rows are then in cell order, not slot
  order, so per-particle fields are matched by position (the set-up moves
  nothing);
* a 3-D state through the checkpoint (bit for bit, engine included) and a
  ``.vtp`` frame (3-D positions and vectors);
* the flat layout in 3-D, at the reference's own ``TINY`` in float64 (N =
  1,603, flat grid 12 × 5 × 8, cap 16, ``pair_mode="gather"`` by the
  reference's auto rule: 480 cells × 16 > 4 × 1,603): ``setup`` and 4 steps
  against the reference's flat float64 path (set-up and step compiled with
  ``QUICK_COMPILE``): m, h and ρ after the set-up and every field after the
  steps within 1e-10 of its largest |value| (measured: at most 5.4e-14, on
  v), rows matched by position; the reference's own gates
  (tests/test_witch3d.py): u_max < 1 m/s after 12 steps with every
  particle kept, and the median of ρ/ρ_bg within 1e-3 of 1 after one step;
  the flat state through the checkpoint and one step on, bit for bit;
  witch3d's density (with the self pair) and momentum through
  ``apply_binary`` on a perturbed TINY state: the cell-dense [C, k, 27k]
  blocks and the per-row [N, 27k] gathers, each cut to the largest cell
  count k (8 of cap 16), give the same sums bit for bit; the auto rule
  against the reference's on two cubic lattices ("cell" and "gather");
  and the float32 flat path (the ``SMALL`` config on the flat layout)
  against the same reference run as the bucket path: m, h and ρ after the
  set-up at rtol 1e-5, u_avg and u_max after 4 steps at rel 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_mountain_waves_tpu.ops.pallas_pairs as pp
from sph_mountain_waves_tpu.models import witch3d as jw
from sph_mountain_waves_tpu.models.witch_common import (
    background_density as j_rho_bg, velocity_diagnostics as j_diag,
)
from sph_mountain_waves_tpu.ops.neighbors import NeighborEngine as JEngine
from sph_mountain_waves_tpu.structs import ParticleState as JState

from sph_mountain_waves_tpu_torch.geometry import Box
from sph_mountain_waves_tpu_torch.interop import state_from_numpy, state_to_numpy
from sph_mountain_waves_tpu_torch.io import new_pvd_file, read_vtp, save_frame
from sph_mountain_waves_tpu_torch.models import witch3d as tw
from sph_mountain_waves_tpu_torch.models.common import frame_runner
from sph_mountain_waves_tpu_torch.models.witch_common import (
    velocity_diagnostics as t_diag,
)
from sph_mountain_waves_tpu_torch.ops import apply as tapply
from sph_mountain_waves_tpu_torch.ops import pair_sweeps as tps
from sph_mountain_waves_tpu_torch.ops.neighbors import NeighborEngine
from sph_mountain_waves_tpu_torch.utils.checkpoint import (
    engine_from_meta, load_checkpoint, save_checkpoint,
)
from scipy.spatial import cKDTree
from torch_reference_harness import (
    QUICK_COMPILE, jit_at_level0, reference_body_sweep,
)

torch.set_num_threads(1)

TINY = dict(n_rows=6, dom_length=60e3, dom_depth=10e3, bc_rows=3,
            self_density=True)
SMALL = dict(TINY, eta=1.2, dtype="float32", layout="bucket",
             lattice_cells=True, skin=0.15, use_pallas=True)
FLAT64 = dict(TINY, dtype="float64", layout="flat")
RTOL, ATOL_REL = 1e-5, 1e-6
N_STEPS = 4


def _to_np(jstate):
    return ({k: np.asarray(v) for k, v in jstate.fields.items()},
            np.asarray(jstate.active))


def _assert_states_equal(tstate, jstate):
    jf, ja = _to_np(jstate)
    tf, ta = state_to_numpy(tstate)
    assert sorted(jf) == sorted(tf)
    np.testing.assert_array_equal(ta, ja)
    for name in jf:
        assert tf[name].dtype == jf[name].dtype, name
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)


def _build(**over):
    js = jw.make_system(jw.Witch3DConfig(**{**SMALL, **over}))
    jstate = js.freeze()
    ts = tw.make_system(tw.Witch3DConfig(**{**SMALL, **over}))
    tstate = ts.freeze(device="cpu")
    je, te = js.engine, ts.engine
    assert (te.cap, te.lims, te.phase, te.cells) == (je.cap, je.lims, je.phase,
                                                     je.cells)
    return js, jstate, ts, tstate


@pytest.fixture(scope="module")
def built():
    return _build()


@pytest.fixture(scope="module")
def built_cap8():
    """n_rows=12 with ``bucket_cap=8`` and one fence row (grid 128 × 8 × 8):
    every cell of the nudged 2·dr grid holds at most 8."""
    return _build(n_rows=12, bucket_cap=8, bc_rows=1)


@pytest.fixture(scope="module")
def live(built):
    """(JAX engine, JAX state, port engine, port state): the frozen state
    with v ±1 m/s, h ±1 % and P′ ±50 Pa from a seeded NumPy generator."""
    js, jstate, ts, _ = built
    fields, active = _to_np(jstate)
    rng = np.random.default_rng(0)
    n = active.shape[0]
    fields["v"] = np.where(active[:, None], rng.uniform(-1, 1, (n, 3)),
                           0.0).astype(np.float32)
    fields["h"] = np.where(active, fields["h"] * rng.uniform(0.99, 1.01, n),
                           0.0).astype(np.float32)
    fields["P_p"] = np.where(active, rng.uniform(-50.0, 50.0, n),
                             0.0).astype(np.float32)
    jlive = JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                   active=jnp.asarray(active))
    return js.engine, jlive, ts.engine, state_from_numpy(fields, active, "cpu")


def _check(got, ref, active):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())
    assert np.all(got.numpy()[~active] == 0.0)
    assert np.abs(ref).max() > 0.0


def test_frozen_state_matches_jax(built):
    js, jstate, ts, tstate = built
    assert ts.engine.dim == 3 and ts.engine.lims == (128, 8, 8)
    assert ts.engine.cap == 16 and len(ts.engine.stencil) == 27
    assert ts.engine.stencil == js.engine.stencil
    assert int(tstate.n) == 1603
    _assert_states_equal(tstate, jstate)


def test_frozen_state_matches_jax_at_cap_8(built_cap8):
    _, jstate, ts, tstate = built_cap8
    assert ts.engine.cap == 8
    _assert_states_equal(tstate, jstate)
    counts = ts.engine.resident(tstate.active)[:, :-1].sum(dim=0)
    assert int(counts.max()) == 8
    assert int(tstate.n) == ts.n_built


def test_forced_rescatter_matches_jax_in_3d(built_cap8):
    """A seeded drift past the budget on the full cap-8 cells: the port's
    27-offset compaction against the reference's, slot for slot, and the
    same rows dropped."""
    js, jstate, ts, _ = built_cap8
    fields, active = _to_np(jstate)
    rng = np.random.default_rng(1)
    L = np.asarray(js.engine.cell_size, dtype=np.float32)
    drift = rng.uniform(-0.6, 0.6, fields["x"].shape).astype(np.float32) * L
    fields["x"] = np.where(active[:, None], fields["x"] + drift,
                           0.0).astype(np.float32)
    fields["v"] = np.where(active[:, None],
                           rng.uniform(-1, 1, fields["v"].shape),
                           0.0).astype(np.float32)
    jmoved = JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                    active=jnp.asarray(active))
    tmoved = state_from_numpy(fields, active, "cpu")
    jnew, jdrop = js.engine._stencil_rescatter(jmoved)
    tnew, tdrop = ts.engine._stencil_rescatter(tmoved)
    assert int(tdrop) == int(jdrop) > 0
    _assert_states_equal(tnew, jnew)
    # and through rebuild: the drift is past the budget, so it rescatters
    rebuilt, nbrs = ts.engine.rebuild(tmoved)
    assert int(nbrs.overflow) == int(jdrop)
    assert torch.equal(rebuilt.active, tnew.active)


def test_row_kmax_matches_jax_in_3d(live):
    je, jlive, te, tlive = live
    band, row = tps.row_kmax(te, tlive)
    jband, jrow = pp.row_kmax(je, jlive)
    assert band.dtype == torch.int32 and band.shape == (8 * 8,)
    np.testing.assert_array_equal(band.numpy(), np.asarray(jband))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    assert int(band.max()) == 8 and int(row.min()) == 0


def test_density_twin_matches_reference_body_in_3d(live, monkeypatch):
    je, jlive, te, tlive = live
    (ref,), captured = reference_body_sweep(
        pp.density_pass, je, jlive, jw.Witch3DConfig(**SMALL), monkeypatch)
    assert captured["self_pair"] is True and len(captured["fields"]) == 5
    before = tps.density_pass.launches
    got = tps.density_pass(te, tlive, tw.Witch3DConfig(**SMALL))
    assert tps.density_pass.launches == before  # CPU tensors: the twin
    _check(got, ref, tlive.active.numpy())


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
def test_momentum_twin_matches_reference_body_in_3d(live, fast_math,
                                                    monkeypatch):
    je, jlive, te, tlive = live
    refs, captured = reference_body_sweep(
        pp.momentum_pass, je, jlive,
        jw.Witch3DConfig(**SMALL, fast_math=fast_math), monkeypatch)
    assert captured["self_pair"] is False and len(captured["fields"]) == 11
    before = tps.momentum_pass.launches
    gots = tps.momentum_pass(te, tlive,
                             tw.Witch3DConfig(**SMALL, fast_math=fast_math))
    assert tps.momentum_pass.launches == before
    assert len(gots) == len(refs) == 3
    for got, ref in zip(gots, refs):
        _check(got, ref, tlive.active.numpy())


@pytest.fixture(scope="module")
def ref_flat32():
    """The reference's ``setup`` (2 iterations) and 4 steps of the SMALL
    config on its flat layout in float32: (config, state after the set-up,
    state after the steps)."""
    with pytest.MonkeyPatch.context() as mp:
        jit_at_level0(mp)  # the reference set-up's own jax.jit
        jcfg = jw.Witch3DConfig(**{**SMALL, "renorm_iters": 2,
                                   "layout": "flat", "use_pallas": False})
        js = jw.make_system(jcfg)
        jfrozen = js.freeze()
        jset = jw.setup(jcfg, js.engine, jfrozen)
    jstep = jax.jit(jw.make_step(jcfg, js.engine)).lower(jset).compile(
        compiler_options=QUICK_COMPILE)
    jstate = jset
    for _ in range(N_STEPS):
        jstate = jstep(jstate)
    return jcfg, jset, jstate


def _check_against_ref_flat32(tcfg, engine, tstate, ref_flat32):
    """``setup`` and 4 steps of the port from ``tstate`` against the
    reference's flat float32 run: m, h, ρ at rtol 1e-5 (rows matched by
    position: the set-up moves nothing), u_avg and u_max at rel 1e-5, equal
    active counts."""
    _, jset, jstate = ref_flat32
    tstate = tw.setup(tcfg, engine, tstate)
    jf, ja = _to_np(jset)
    tf, ta = state_to_numpy(tstate)
    assert int(ta.sum()) == int(ja.sum()) == 1603
    jorder = np.lexsort(jf["x"][ja].T)
    torder = np.lexsort(tf["x"][ta].T)
    np.testing.assert_array_equal(tf["x"][ta][torder], jf["x"][ja][jorder])
    assert np.abs(tf["m"][ta] / (tf["rho"][ta] * tcfg.dr**3) - 1).max() > 0.01
    for name in ("m", "h", "rho"):
        np.testing.assert_allclose(tf[name][ta][torder], jf[name][ja][jorder],
                                   rtol=1e-5, err_msg=name)

    tstate = frame_runner(tw.make_step(tcfg, engine), N_STEPS)(tstate)
    jd = [float(v) for v in j_diag(jstate)]
    td = [float(v) for v in t_diag(tstate)]
    assert np.all(np.isfinite(td)) and td[1] > 0.0
    assert td[0] == pytest.approx(jd[0], rel=1e-5)
    assert td[1] == pytest.approx(jd[1], rel=1e-5)
    assert int(tstate.n) == int(jstate.n) == 1603


def test_setup_and_steps_match_jax(built, ref_flat32):
    _, _, ts, tstate = built
    tcfg = tw.Witch3DConfig(**SMALL, renorm_iters=2)
    _check_against_ref_flat32(tcfg, ts.engine, tstate, ref_flat32)


def test_flat_float32_setup_and_steps_match_jax(ref_flat32):
    """The port's own flat float32 path, on the reference run's config."""
    tcfg = tw.Witch3DConfig(**{**SMALL, "renorm_iters": 2, "layout": "flat",
                               "use_pallas": False})
    ts = tw.make_system(tcfg)
    tstate = ts.freeze(device="cpu")
    assert ts.engine.layout == "flat"
    assert tstate.fields["x"].dtype == torch.float32
    _check_against_ref_flat32(tcfg, ts.engine, tstate, ref_flat32)


def test_checkpoint_and_frame_round_trip_in_3d(built, tmp_path):
    """A 3-D state through ``save_checkpoint``/``load_checkpoint`` bit for
    bit, its engine back from the checkpoint's meta, and a ``.vtp`` frame
    with 3-D positions and vectors read back exactly."""
    _, _, ts, tstate = built
    path = str(tmp_path / "checkpoint.npz")
    save_checkpoint(path, tstate, engine=ts.engine, extra={"step": 3})
    loaded, meta = load_checkpoint(path, device="cpu")
    assert meta["extra"]["step"] == 3
    assert torch.equal(loaded.active, tstate.active)
    for name, ref in tstate.fields.items():
        assert torch.equal(loaded.fields[name], ref), name
    engine = engine_from_meta(meta, cells=ts.engine.cells,
                              persistent=ts.engine.persistent)
    assert engine == ts.engine and len(engine.stencil) == 27

    out = new_pvd_file(str(tmp_path / "frames"))
    save_frame(out, tstate, "v", "rho", time=0.0)
    points, data = read_vtp(str(tmp_path / "frames" / "frame0.vtp"))
    act = tstate.active.numpy()
    x = tstate.fields["x"].numpy()[act].astype(np.float64)
    assert points.shape == (1603, 3) and np.ptp(points[:, 2]) > 0.0
    np.testing.assert_array_equal(points, x)
    np.testing.assert_array_equal(
        data["v"], tstate.fields["v"].numpy()[act].astype(np.float64))
    np.testing.assert_array_equal(
        data["rho"], tstate.fields["rho"].numpy()[act].astype(np.float64))


@pytest.mark.parametrize("cap,accepted", [(40, True), (76, False)],
                         ids=["cap40", "cap76"])
def test_stencil_cost_rule_counts_27_offsets(cap, accepted):
    """The reference keeps its stencil compaction while len(stencil)·cap ≤
    2048: 27·40 = 1080 stays, 27·76 = 2052 takes the sort rescatter (in 2-D
    the same rule counts 9 offsets: 9·76 = 684 stays)."""
    box = Box(0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    engine = NeighborEngine.create(box, 0.1, 3, cap=cap)
    assert engine.cap == cap and engine.rescatter_mode == "stencil"
    assert engine.effective_rescatter_mode == (
        "stencil" if accepted else "sort")
    if accepted:
        assert len(engine.stencil) * cap == 1080
    in_2d = NeighborEngine.create(box, 0.1, 2, cap=cap)
    assert in_2d.effective_rescatter_mode == "stencil"


@pytest.mark.parametrize("cap,staged,want", [
    (8, 5, (32, 256, 12256)), (8, 12, (32, 256, 29376)),
    (16, 5, (16, 256, 6496)), (16, 12, (16, 256, 15552)),
    (24, 12, (10, 240, 10368)), (40, 8, (6, 240, 4608))],
    ids=["stretch-density", "stretch-momentum", "tiny-density",
         "tiny-momentum", "cap24-momentum", "collapse3d-dambreak"])
def test_tile_plan_of_the_tiled_3d_sweeps(cap, staged, want):
    """The tiled 3-D sweep's launch plan (TX, threads, dynamic shared
    bytes): witch3d's stretch size has cap 8, this file's tiny system cap
    16, collapse3d cap 40; the density stages 5 q planes, the momentum 12,
    the dam-break continuity and force 8 each. TX = min(32, 256 // cap); two
    stages of (TX+2)·9 cells, each rounded up to 16 B."""
    engine = NeighborEngine.create(Box(0.0, 0.0, 0.0, 1.0, 1.0, 1.0), 0.1, 3,
                                   cap=cap)
    plan = tps._tile_plan(engine, staged)
    assert (plan.tx, plan.tx * cap, plan.smem_bytes) == want
    assert plan.block == (plan.tx, cap)
    assert plan.tx * cap <= 1024 and plan.smem_bytes <= 227 * 1024


def test_tile_plan_refuses_what_the_tiled_3d_sweep_cannot_take():
    box = Box(0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="ranks per cell"):
        tps._tile_plan(NeighborEngine.create(box, 0.1, 3, cap=257), 12)
    with pytest.raises(ValueError, match="shared memory"):
        tps._tile_plan(NeighborEngine.create(box, 0.1, 3, cap=8), 100)


@pytest.mark.parametrize("cap,kernel,every_rank,want", [
    (8, "pavelka_mass_sweep", True, (32, 256, 29440, 8)),
    (8, "pavelka_mass_sweep", False, (32, 256, 7360, 2)),
    (8, "pavelka_momentum_entropy_sweep", True, (32, 256, 35968, 8)),
    (8, "pavelka_momentum_entropy_sweep", False, (32, 256, 8992, 2)),
    (24, "pavelka_mass_sweep", True, (10, 240, 31104, 24)),
    (24, "pavelka_momentum_entropy_sweep", False, (10, 240, 3168, 2)),
    (8, "momentum_sweep", True, (32, 256, 32640, 8)),
    (8, "momentum_sweep", False, (32, 256, 8160, 2)),
    (8, "hopkins_momentum_sweep total", True, (32, 256, 35968, 8)),
    (8, "hopkins_momentum_sweep total", False, (32, 256, 8992, 2)),
    (8, "hopkins_momentum_sweep split", True, (32, 256, 42496, 8)),
    (8, "hopkins_momentum_sweep split", False, (32, 256, 10624, 2)),
    (24, "momentum_sweep", True, (10, 240, 34560, 24)),
    (24, "hopkins_momentum_sweep total", True, (10, 240, 38016, 24)),
    (24, "hopkins_momentum_sweep split", True, (10, 240, 44928, 24)),
    (24, "hopkins_momentum_sweep split", False, (10, 240, 3744, 2)),
    (8, "legacy_force_sweep no_av", True, (32, 256, 26112, 8)),
    (8, "legacy_force_sweep av", True, (32, 256, 29440, 8)),
    (24, "legacy_force_sweep no_av", True, (10, 240, 27648, 24)),
    (24, "legacy_force_sweep no_av", False, (10, 240, 2304, 2)),
    (24, "legacy_force_sweep av", True, (10, 240, 31104, 24)),
    (24, "legacy_force_sweep av", False, (10, 240, 2592, 2)),
    (8, "isph_matvec_sweep", True, (32, 256, 13056, 8)),
    (8, "isph_matvec_sweep", False, (32, 256, 3264, 2)),
    (8, "pressure_sweep", True, (32, 256, 16384, 8)),
    (8, "pressure_sweep", False, (32, 256, 4096, 2)),
    (24, "legacy_mass_sweep", True, (10, 240, 20736, 24)),
    (24, "legacy_mass_sweep", False, (10, 240, 1728, 2)),
    (8, "legacy_mass_sweep", True, (32, 256, 19584, 8)),
    (8, "density_sweep", True, (32, 256, 16384, 8)),
    (8, "density_sweep", False, (32, 256, 4096, 2)),
    (16, "density_sweep", True, (16, 256, 17408, 16)),
    (8, "gamma_grad_sweep", True, (32, 256, 13056, 8)),
    (8, "gamma_grad_sweep", False, (32, 256, 3264, 2)),
    (24, "dambreak_mass_sweep", True, (10, 240, 20736, 24)),
    (24, "dambreak_mass_sweep", False, (10, 240, 1728, 2)),
    (16, "rb_mass_heat_sweep", True, (16, 256, 24320, 16)),
    (16, "rb_mass_heat_sweep", False, (16, 256, 3040, 2)),
    (24, "dambreak_force_sweep", True, (10, 240, 20736, 24)),
    (24, "dambreak_force_sweep", False, (10, 240, 1728, 2)),
    (16, "dambreak_force_sweep", True, (16, 256, 20736, 16)),
    (8, "isph_div_visc_sweep", True, (32, 256, 16384, 8)),
    (8, "isph_div_visc_sweep", False, (32, 256, 4096, 2)),
    (8, "isph_grad_sweep", True, (32, 256, 13056, 8)),
    (8, "isph_grad_sweep", False, (32, 256, 3264, 2)),
    (8, "iso_static_force_sweep no_av", True, (32, 256, 29440, 8)),
    (8, "iso_static_force_sweep no_av", False, (32, 256, 7360, 2)),
    (8, "iso_static_force_sweep av", True, (32, 256, 32640, 8)),
    (24, "iso_static_force_sweep no_av", True, (10, 240, 31104, 24)),
    (8, "iso_static_mass_sweep", True, (32, 256, 22912, 8)),
    (8, "iso_static_mass_sweep", False, (32, 256, 5728, 2)),
    (8, "adia_entropy_force_sweep", True, (32, 256, 29440, 8)),
    (8, "adia_entropy_force_sweep", False, (32, 256, 7360, 2))],
    ids=["cap8-mass-every", "cap8-mass-two", "cap8-fused-every",
         "cap8-fused-two", "cap24-mass-every", "cap24-fused-two",
         "cap8-momentum-every", "cap8-momentum-two", "cap8-total-every",
         "cap8-total-two", "cap8-split-every", "cap8-split-two",
         "cap24-momentum-every", "cap24-total-every", "cap24-split-every",
         "cap24-split-two", "cap8-terrain-every", "cap8-terrain-av-every",
         "cap24-terrain-every", "cap24-terrain-two", "cap24-terrain-av-every",
         "cap24-terrain-av-two", "cap8-matvec-every", "cap8-matvec-two",
         "cap8-pressure-every", "cap8-pressure-two",
         "cap24-terrain-mass-every", "cap24-terrain-mass-two",
         "cap8-terrain-mass-every", "cap8-density-every", "cap8-density-two",
         "cap16-adia-density-every", "cap8-gamma-every", "cap8-gamma-two",
         "cap24-dam-mass-every", "cap24-dam-mass-two", "cap16-rb-every",
         "cap16-rb-two", "cap24-dam-force-every", "cap24-dam-force-two",
         "cap16-dam-force-every", "cap8-div-visc-every", "cap8-div-visc-two",
         "cap8-isph-grad-every", "cap8-isph-grad-two", "cap8-iso-force-every",
         "cap8-iso-force-two", "cap8-iso-force-av-every",
         "cap24-iso-force-every", "cap8-iso-mass-every", "cap8-iso-mass-two",
         "cap8-adia-force-every", "cap8-adia-force-two"])
def test_tile_plan_of_the_tiled_2d_sweeps(cap, kernel, every_rank, want):
    """The tiled 2-D sweep's launch plan (TX, threads, dynamic shared bytes,
    stages) for the Pavelka pair, which stages 9 (continuity: the float4 of
    occupancy, x and h, then v, ρ_f, wq and the FLUID gate) and 11 (fused
    sweep: the float4, m, v, ρ_f, wq, P/ρ_f² and the gate) q planes a cell,
    the flagship momentum, which stages 10 (the float4, m, v, ρ_f, P′/ρ_f²,
    c), the Hopkins momentum, which stages 11 in its total form (the
    float4, m, v, ρ_f, c, A^{1/γ}, P_e) and 13 with the background split
    (A_bg^{1/γ}, P_bg,e besides), the terrain force, which stages 8 without
    AV (the float4 of occupancy, x and v0, then v1, m, P/ρ_f², 1/ρ_f) and 9
    with it (the FLUID gate besides), the ISPH matvec, which stages the
    float4 of occupancy, x and the iterate alone (4), the Hopkins pressure
    root, which stages the float4 of occupancy, x and h, then w (5, with
    the self pair or without it), the terrain continuity, which stages the
    float4 of occupancy, x and v0, then v1 and m (6), the 2-D density,
    which stages the float4 of occupancy, x and 1/h, then w (5, with the
    self pair or without it, and the adiabatic density on it), the
    packing's ∇Γ sum, which stages the float4 of occupancy, x and h alone
    (4), the 2-D dam-break continuity, which stages the float4 of
    occupancy, x and v0, then v1 and ρ (6), the Rayleigh–Bénard continuity
    + conduction, which stages the float4 of occupancy, x and v0, then v1,
    T and 1/ρ (7), the 2-D dam-break force, which stages the float4 of
    occupancy, x and v0, then v1 and P/ρ² (6; the FLUID gate is read on the
    p side only), the ISPH divergence/viscous sweep, which stages the
    float4 of occupancy, x and v0, then v1 (5), the ISPH pressure gradient,
    which stages the float4 of occupancy, x and P alone (4), the
    per-particle-h (isothermal static) force, which stages 9 without AV
    (the float4 of occupancy, x and h, then v0, v1, m, P/ρ_f², 1/ρ_f) and 10
    with it (the FLUID gate besides), the per-particle-h continuity, which
    stages the float4 of occupancy, x and 1/h, then v0, v1 and m/ρ (7), and
    the fused adiabatic entropy + force sweep, which stages the float4 of
    occupancy, x and v0, then v1, m, P/ρ_f², 1/ρ_f and the FLUID gate (9 in
    both AV forms; m/T is read on the p side only): the flagship, Pavelka,
    ISPH and the two static sizes have cap 8 (TX 32), the corrected adiabatic
    flow's and the Rayleigh–Bénard baseline's cap 16 gives TX 16, the
    terrain baseline's and collapse_dry's cap 24 TX 10; a stage is (TX+2)·3
    cells rounded up to 16 B, two of them or one per rank. The wrapper's
    default is ``_EVERY_RANK``; a 3-D engine refuses the every-rank scheme;
    the Hopkins and both terrain-force counts need their form, and no other
    count takes one (a form key given to the pressure root, the terrain
    continuity, the density, the ∇Γ sum, the dam-break continuity or force,
    the Rayleigh–Bénard sweep, the ISPH divergence, the ISPH gradient, the
    per-particle-h continuity or the fused adiabatic sweep is refused)."""
    box = Box(0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    engine = NeighborEngine.create(box, 0.1, 2, cap=cap)
    name, _, label = kernel.partition(" ")
    form = {"": None, "total": False, "split": True, "no_av": False,
            "av": True}[label]
    staged = tps._staged(name, form)
    assert staged == {"pavelka_mass_sweep": 9,
                      "pavelka_momentum_entropy_sweep": 11,
                      "momentum_sweep": 10,
                      "hopkins_momentum_sweep total": 11,
                      "hopkins_momentum_sweep split": 13,
                      "legacy_force_sweep no_av": 8,
                      "legacy_force_sweep av": 9,
                      "isph_matvec_sweep": 4,
                      "pressure_sweep": 5,
                      "legacy_mass_sweep": 6,
                      "density_sweep": 5,
                      "gamma_grad_sweep": 4,
                      "dambreak_mass_sweep": 6,
                      "rb_mass_heat_sweep": 7,
                      "dambreak_force_sweep": 6,
                      "isph_div_visc_sweep": 5,
                      "isph_grad_sweep": 4,
                      "iso_static_force_sweep no_av": 9,
                      "iso_static_force_sweep av": 10,
                      "iso_static_mass_sweep": 7,
                      "adia_entropy_force_sweep": 9}[kernel]
    plan = tps._tile_plan(engine, staged, every_rank=every_rank)
    assert (plan.tx, plan.tx * cap, plan.smem_bytes, plan.stages) == want
    assert plan.block == (plan.tx, cap) and plan.smem_bytes <= 48 * 1024
    assert plan.tx == tps._tile_tx(engine)
    assert tps._tile_plan(engine, staged) == tps._tile_plan(
        engine, staged, every_rank=tps._EVERY_RANK)
    with pytest.raises(ValueError, match="two ranks"):
        tps._tile_plan(NeighborEngine.create(box, 0.1, 3, cap=cap), staged,
                       every_rank=True)
    # a form asked for without its key, or a key given to a one-form sweep
    with pytest.raises(ValueError, match={
            "hopkins_momentum_sweep": r"\(background_split\) is needed",
            "legacy_force_sweep": r"\(av\) is needed",
            "iso_static_force_sweep": r"\(av\) is needed"}.get(name,
                                                             "one form")):
        tps._staged(name, None if form is not None else False)


# --------------------------------------------------- the flat layout in 3-D

def _matched(jstate, tstate):
    """(JAX fields, port fields) on the active rows, the JAX rows in the
    port's order (nearest position, within 1e-6 m): the two stable sorts
    order a particle on a cell edge differently when its key flips with its
    last bit."""
    jf, ja = _to_np(jstate)
    tf, ta = state_to_numpy(tstate)
    dist, perm = cKDTree(jf["x"][ja]).query(tf["x"][ta])
    assert dist.max() < 1e-6 and len(np.unique(perm)) == len(perm)
    return ({k: v[ja][perm] for k, v in jf.items()},
            {k: v[ta] for k, v in tf.items()})


def _within(tf, jf, names, atol_rel):
    for name in names:
        ref = jf[name]
        np.testing.assert_allclose(tf[name], ref, rtol=0.0,
                                   atol=atol_rel * np.abs(ref).max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def flat64():
    """witch3d at the reference's TINY in float64 on the flat layout: the
    reference's set-up and 4 steps (compiled once with ``QUICK_COMPILE``)
    and the port's set-up and 12 steps, keeping the port's states after the
    set-up and after steps 1, 4 and 12."""
    jcfg, tcfg = jw.Witch3DConfig(**FLAT64), tw.Witch3DConfig(**FLAT64)
    with pytest.MonkeyPatch.context() as mp:
        jit_at_level0(mp)  # the reference set-up's own jax.jit
        js = jw.make_system(jcfg)
        jfrozen = js.freeze()
        jset = jw.setup(jcfg, js.engine, jfrozen)
    jstep = jax.jit(jw.make_step(jcfg, js.engine)).lower(jset).compile(
        compiler_options=QUICK_COMPILE)
    jstate = jset
    for _ in range(N_STEPS):
        jstate = jstep(jstate)

    ts = tw.make_system(tcfg)
    tfrozen = ts.freeze(device="cpu")
    tstate = tw.setup(tcfg, ts.engine, tfrozen)
    kept = {0: tstate}
    step = tw.make_step(tcfg, ts.engine)
    for k in range(1, 13):
        tstate = step(tstate)
        if k in (1, N_STEPS, 12):
            kept[k] = tstate
    return (js, jset, jstate), (ts, tcfg, kept)


def test_flat_float64_setup_and_steps_match_jax(flat64):
    (js, jset, jstate), (ts, tcfg, kept) = flat64
    assert ts.engine.layout == js.engine.layout == "flat"
    assert (ts.engine.lims, ts.engine.cap, ts.engine.pair_mode) == (
        js.engine.lims, js.engine.cap, js.engine.pair_mode) == (
        (12, 5, 8), 16, "gather")
    assert kept[0].fields["x"].dtype == torch.float64
    jf, tf = _matched(jset, kept[0])
    _within(tf, jf, ("m", "h", "rho"), 1e-10)
    m0 = j_rho_bg(tcfg, tf["x"][:, 2]) * tcfg.dr**3
    assert np.abs(tf["m"] / m0 - 1).max() > 0.01  # the set-up moved m
    jf, tf = _matched(jstate, kept[N_STEPS])
    assert int(kept[N_STEPS].n) == int(jstate.n) == ts.n_built == 1603
    assert np.abs(tf["v"]).max() > 0.0
    assert sorted(jf) == sorted(tf)
    _within(tf, jf, sorted(jf), 1e-10)


def test_flat_checkpoint_round_trip_in_3d(flat64, tmp_path):
    """A flat float64 3-D state (after the set-up and 4 steps) through the
    checkpoint bit for bit, its flat engine back from the meta, and one
    more step from the loaded state equal to one from the original."""
    _, (ts, tcfg, kept) = flat64
    path = str(tmp_path / "checkpoint.npz")
    save_checkpoint(path, kept[N_STEPS], engine=ts.engine, extra={"step": 4})
    loaded, meta = load_checkpoint(path, device="cpu")
    for name, ref in kept[N_STEPS].fields.items():
        assert torch.equal(loaded.fields[name], ref), name
    engine = engine_from_meta(meta, cells=ts.engine.cells,
                              persistent=ts.engine.persistent,
                              dtype=torch.float64)
    assert engine == ts.engine and engine.layout == "flat"
    step = tw.make_step(tcfg, engine)
    a, b = step(loaded), step(kept[N_STEPS])
    for name, ref in b.fields.items():
        assert torch.equal(a.fields[name], ref), name


def test_flat_static_atmosphere_on_the_port(flat64):
    """The reference's gate (tests/test_witch3d.py
    ``test_witch3d_static_atmosphere``): after the set-up and 12 steps every
    velocity is finite, below 1 m/s, and every particle is kept."""
    _, (ts, _, kept) = flat64
    state = kept[12]
    v = state.fields["v"][state.active].numpy()
    assert np.isfinite(v).all() and np.abs(v).max() > 0.0
    assert int(state.n) == ts.n_built
    assert float(np.max(np.linalg.norm(v, axis=1))) < 1.0


def test_flat_mass_renormalization_on_the_port(flat64):
    """The reference's gate (``test_witch3d_mass_renormalization_converges``):
    one step after the set-up, the median of the summed density over the
    hydrostatic background is within 1e-3 of 1."""
    _, (_, tcfg, kept) = flat64
    state = kept[1]
    act = state.active.numpy()
    x = state.fields["x"].numpy()[act]
    ratio = state.fields["rho"].numpy()[act] / j_rho_bg(tcfg, x[:, 2])
    assert abs(np.median(ratio) - 1.0) < 1e-3


@pytest.mark.parametrize("fn, field, self_pair", [
    ("compute_density", "rho", True), ("balance_of_momentum", "Dv", False)],
    ids=["density-self", "momentum"])
def test_flat_cell_and_gather_sums_are_equal_in_3d(fn, field, self_pair):
    """witch3d's own pair functions through ``apply_binary`` on the flat
    TINY float64 state (v and P′ drawn from a seeded generator): the
    cell-dense [C, k, 27k] blocks give the per-row [N, 27k] gathers' sums
    bit for bit (the same order; k, the largest cell count, 8 of cap 16).
    The gather mode, this state's own by the auto rule, is held against
    the reference through the set-up and steps above."""
    tcfg = tw.Witch3DConfig(**FLAT64)
    ts = tw.make_system(tcfg)
    fields, active = state_to_numpy(ts.freeze(device="cpu"))
    rng = np.random.default_rng(2)
    n = active.shape[0]
    fields["v"] = np.where(active[:, None], rng.normal(0.0, 1.0, (n, 3)), 0.0)
    fields["P_p"] = np.where(active, rng.normal(0.0, 100.0, n), 0.0)
    pair_fn = (tw.compute_density if fn == "compute_density" else
               _closure(_closure(tw.make_step(tcfg, ts.engine))["momentum"])[fn])
    sums = {}
    for mode in ("cell", "gather"):
        te = dataclasses.replace(ts.engine, pair_mode=mode)
        tstate, tn = te.rebuild(state_from_numpy(fields, active, "cpu"))
        assert tapply._largest_count(te, tn) == 8 and te.cap == 16
        sums[mode] = tapply.apply_binary(te, tstate, tn, pair_fn, add=False,
                                         self_interaction=self_pair
                                         ).fields[field]
    assert sums["cell"].dtype == torch.float64
    assert float(sums["cell"].abs().max()) > 0.0
    assert torch.equal(sums["cell"], sums["gather"])


@pytest.mark.parametrize("spacing, mode", [(0.05, "cell"), (0.2, "gather")])
def test_flat_pair_mode_rule_in_3d(spacing, mode):
    """The reference's auto rule in 3-D: "cell" when num_cells·cap ≤ 4·n,
    else "gather"; a cubic lattice of the given spacing in a unit box at
    h = 0.1 (8 or 1 lattice points a cell)."""
    g = np.arange(0.0, 1.0, spacing) + 0.01
    pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    box = Box(0.0, 0.0, 0.0, 1.0, 1.0, 1.0)
    te = NeighborEngine.create(box, 0.1, 3, positions=pos, layout="flat")
    je = JEngine.create(box, 0.1, 3, positions=pos, dtype=jnp.float64,
                        layout="flat")
    assert (te.pair_mode, te.lims, te.cap) == (je.pair_mode, je.lims, je.cap)
    assert te.pair_mode == mode


def _closure(step):
    """The functions a step closes over, by name (a name the step never
    bound is left out)."""
    out = {}
    for name, cell in zip(step.__code__.co_freevars, step.__closure__):
        try:
            out[name] = cell.cell_contents
        except ValueError:
            pass
    return out
