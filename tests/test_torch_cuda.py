"""CUDA kernels of the port against their plain twins, on the card, and the
published Nusselt gates of Rayleigh–Bénard convection (``slow``).

Marked ``cuda``: they skip without a CUDA device. This file imports neither
JAX nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest`` skips tests/conftest.py, which configures JAX.)
``chip_smoke.py`` runs the same comparisons at the flagship's full size.
"""
import dataclasses

import pytest
import torch

from sph_mountain_waves_tpu_torch.models import full_hopkins_perturbed_witch as fh
from sph_mountain_waves_tpu_torch.models import pavelka_total_witch as pv
from sph_mountain_waves_tpu_torch.models import wcsph_perturbed_witch as w
from sph_mountain_waves_tpu_torch.models.common import frame_runner
from sph_mountain_waves_tpu_torch.models.witch_common import (
    WitchConfig, velocity_diagnostics,
)
from sph_mountain_waves_tpu_torch.ops import pair_sweeps as ps

torch.set_num_threads(1)

BENCH = WitchConfig(n_rows=10, dtype="float32", self_density=True,
                    layout="bucket", skin=0.15, use_pallas=True,
                    lazy_diagnostics=True, lattice_cells=True, fast_math=True)
PV_BENCH = pv.PavelkaConfig(**dataclasses.asdict(BENCH))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _live_state(device, module=w, cfg=BENCH):
    """The flagship (or another scheme) at n_rows=10 after one step, with v
    perturbed by a seeded ±1 m/s so that the viscosity term is live."""
    sys_ = module.make_system(cfg)
    state = sys_.freeze(device=device)
    state = module.make_step(cfg, sys_.engine)(state)
    gen = torch.Generator(device=device).manual_seed(0)
    dv = torch.rand(state.fields["v"].shape, generator=gen, device=device) * 2 - 1
    return sys_.engine, state.replace(
        v=torch.where(state.active[:, None], state.fields["v"] + dv, 0.0))


@pytest.mark.cuda
def test_density_kernel_matches_twin(card):
    """The tiled 2-D density with the self pair (the flagship's
    ``self_density``): one launch counted, bit for bit against the direct
    design, the row band and the other staging scheme, reruns bitwise
    equal, and the twin's gate rtol 1e-5 / atol 1e-6."""
    eng, st = _live_state(card)
    before = ps.density_pass.launches
    got = ps.density_pass(eng, st, BENCH)
    assert ps.density_pass.launches == before + 1
    _held_to_designs("density_sweep", eng, st, BENCH, [got])
    assert torch.equal(got, ps.density_pass(eng, st, BENCH))
    torch.testing.assert_close(got, ps.density_pass_plain(eng, st, BENCH),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
def test_momentum_kernel_matches_twin(card, fast_math):
    """The tiled 2-D momentum, bit for bit against the direct design, the
    row band and the other staging scheme. Exact divides: the gate rtol
    1e-5 / atol 1e-6. fast_math: the hardware's approximate reciprocal, held
    within 1e-3 of max |Dv|."""
    eng, st = _live_state(card)
    cfg = dataclasses.replace(BENCH, fast_math=fast_math)
    before = ps.momentum_pass.launches
    got = ps.momentum_pass(eng, st, cfg)
    assert ps.momentum_pass.launches == before + 1
    _held_to_designs("momentum_sweep", eng, st, cfg, got)
    ref = ps.momentum_pass_plain(eng, st, cfg)
    for g, r in zip(got, ref):
        if fast_math:
            assert (g - r).abs().max() <= 1e-3 * r.abs().max()
        else:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_kernel_steps_match_cpu_twins(card):
    """8 steps with the kernels on the card against 8 steps of the plain
    twins on the CPU: u_avg/u_max within rel 1e-5, equal active counts."""
    out = {}
    for device, kernels in ((card, True), (torch.device("cpu"), False)):
        cfg = dataclasses.replace(BENCH, use_pallas=kernels, fast_math=False)
        sys_ = w.make_system(cfg)
        state = sys_.freeze(device=device)
        state = frame_runner(w.make_step(cfg, sys_.engine), 8)(state)
        out[device.type] = ([float(v) for v in velocity_diagnostics(state)],
                            int(state.n))
    assert out["cuda"][1] == out["cpu"][1]
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert a == pytest.approx(b, rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("self_pair", [True, False], ids=["self", "no_self"])
def test_pressure_kernel_matches_twin(card, self_pair):
    """The tiled pressure root with the self pair (the Hopkins paths'
    ``self_density``) and without it: one launch counted, bit for bit
    against the direct design, the row band and the other staging scheme,
    reruns bitwise equal, and the twin's gate rtol 1e-5 / atol 1e-6."""
    cfg = dataclasses.replace(BENCH, self_density=self_pair)
    eng, st = _live_state(card, fh)
    before = ps.pressure_pass.launches
    got = ps.pressure_pass(eng, st, cfg)
    assert ps.pressure_pass.launches == before + 1
    _held_to_designs("pressure_sweep", eng, st, cfg, [got])
    assert torch.equal(got, ps.pressure_pass(eng, st, cfg))
    torch.testing.assert_close(got, ps.pressure_pass_plain(eng, st, cfg),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
@pytest.mark.parametrize("split", [False, True], ids=["total", "split"])
def test_hopkins_momentum_kernel_matches_twin(card, split, fast_math):
    """Both forms of the tiled Hopkins momentum, each on its own plan, bit
    for bit against the direct design, the row band and the other staging
    scheme, with the gates of the momentum kernel; reruns bitwise equal."""
    eng, st = _live_state(card, fh)
    cfg = dataclasses.replace(BENCH, fast_math=fast_math)
    before = ps.hopkins_momentum_pass.launches
    got = ps.hopkins_momentum_pass(eng, st, cfg, split)
    assert ps.hopkins_momentum_pass.launches == before + 1
    _held_to_designs("hopkins_momentum_sweep", eng, st, cfg, got,
                     background_split=split)
    rerun = ps.hopkins_momentum_pass(eng, st, cfg, split)
    ref = ps.hopkins_momentum_pass_plain(eng, st, cfg, split)
    for g, g2, r in zip(got, rerun, ref):
        assert torch.equal(g, g2)
        if fast_math:
            assert (g - r).abs().max() <= 1e-3 * r.abs().max()
        else:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_full_hopkins_kernel_steps_match_cpu_twins(card):
    """8 full Hopkins steps with the kernels on the card against 8 steps of
    the plain twins on the CPU: u_avg/u_max within rel 1e-5, equal active
    counts."""
    out = {}
    cfg = dataclasses.replace(BENCH, fast_math=False)
    for label, device in (("card", card), ("cpu", torch.device("cpu"))):
        sys_ = fh.make_system(cfg)
        state = sys_.freeze(device=device)
        state = frame_runner(fh.make_step(cfg, sys_.engine), 8)(state)
        out[label] = ([float(v) for v in velocity_diagnostics(state)],
                      int(state.n))
    assert out["card"][1] == out["cpu"][1]
    for a, b in zip(out["card"][0], out["cpu"][0]):
        assert a == pytest.approx(b, rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("module", [w, fh, pv],
                         ids=["wcsph", "full_hopkins", "pavelka"])
def test_use_pallas_off_is_refused_on_the_card(card, module):
    """A CUDA state with use_pallas=False raises instead of running the
    plain twins on the card, and launches nothing."""
    cfg = dataclasses.replace(PV_BENCH if module is pv else BENCH,
                              use_pallas=False)
    sys_ = module.make_system(cfg)
    state = sys_.freeze(device=card)
    wrappers = (ps.density_pass, ps.pressure_pass, ps.pavelka_mass_pass)
    before = [wr.launches for wr in wrappers]
    with pytest.raises(ValueError, match="use_pallas=False on a CUDA state"):
        module.make_step(cfg, sys_.engine)(state)
    assert [wr.launches for wr in wrappers] == before


def _held_to_twin(got, rerun, ref, fast_math):
    """Reruns bitwise equal; exact divides at the gate rtol 1e-5 / atol 1e-6
    × the output's largest |value| (the sums cancel), fast_math within 1e-3
    of it."""
    for g, g2, r in zip(got, rerun, ref):
        assert torch.equal(g, g2)
        assert torch.isfinite(g).all()
        scale = float(r.abs().max())
        if fast_math:
            assert (g - r).abs().max() <= 1e-3 * scale
        else:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
@pytest.mark.parametrize("fixed", [True, False], ids=["fixed", "faithful"])
def test_pavelka_mass_kernel_matches_twin(card, fixed, fast_math):
    eng, st = _live_state(card, pv, PV_BENCH)
    cfg = dataclasses.replace(PV_BENCH, fixed_diffusion=fixed,
                              fast_math=fast_math)
    before = ps.pavelka_mass_pass.launches
    got = ps.pavelka_mass_pass(eng, st, cfg)
    assert ps.pavelka_mass_pass.launches == before + 1
    _held_to_designs("pavelka_mass_sweep", eng, st, cfg, [got])
    _held_to_twin([got], [ps.pavelka_mass_pass(eng, st, cfg)],
                  [ps.pavelka_mass_pass_plain(eng, st, cfg)], fast_math)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
def test_pavelka_momentum_entropy_kernel_matches_twin(card, fast_math):
    eng, st = _live_state(card, pv, PV_BENCH)
    cfg = dataclasses.replace(PV_BENCH, fast_math=fast_math)
    before = ps.pavelka_momentum_entropy_pass.launches
    got = ps.pavelka_momentum_entropy_pass(eng, st, cfg)
    assert ps.pavelka_momentum_entropy_pass.launches == before + 1
    assert len(got) == 3 and float(got[2].abs().max()) > 0.0
    _held_to_designs("pavelka_momentum_entropy_sweep", eng, st, cfg, got)
    _held_to_twin(got, ps.pavelka_momentum_entropy_pass(eng, st, cfg),
                  ps.pavelka_momentum_entropy_pass_plain(eng, st, cfg),
                  fast_math)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
def test_tiled_pavelka_reaches_every_edge(card, fast_math):
    """At cap 24 a tile is 10 x-cells: the tiny grid's 128 cells leave a
    ragged last tile of 8; the grid has tiles with a trip bound of 0 (its
    empty rows and columns) and occupied p ranks above a neighbour cell's
    count. Both Pavelka kernels (the continuity with both diffusion forms)
    bit for bit against the direct design, the row band and the other
    staging scheme, and within their twins' gate."""
    cfg = dataclasses.replace(PV_BENCH, bucket_cap=24, fast_math=fast_math)
    eng, st = _live_state(card, pv, cfg)
    _reaches_every_edge(eng, st, "pavelka_mass_sweep")
    for fixed in (True, False):
        c = dataclasses.replace(cfg, fixed_diffusion=fixed)
        got = ps.pavelka_mass_pass(eng, st, c)
        _held_to_designs("pavelka_mass_sweep", eng, st, c, [got])
        _held_to_twin([got], [ps.pavelka_mass_pass(eng, st, c)],
                      [ps.pavelka_mass_pass_plain(eng, st, c)], fast_math)
    got = ps.pavelka_momentum_entropy_pass(eng, st, cfg)
    _held_to_designs("pavelka_momentum_entropy_sweep", eng, st, cfg, got)
    _held_to_twin(got, ps.pavelka_momentum_entropy_pass(eng, st, cfg),
                  ps.pavelka_momentum_entropy_pass_plain(eng, st, cfg),
                  fast_math)


def _reaches_every_edge(eng, st, kernel):
    """At cap 24 a tile is 10 x-cells: the tiny grid's 128 cells leave a
    ragged last tile of 8; the grid has tiles with a trip bound of 0 (its
    empty rows and columns) and occupied p ranks above a neighbour cell's
    count (empty q slots beside full ones)."""
    ragged, idle_tiles, _ = _tiled_edges(eng, st, kernel)
    assert eng.cap == 24 and ragged and idle_tiles > 0
    counts = eng.grid_view(st.active).sum(dim=0).to(torch.float32)
    fewest = -torch.nn.functional.max_pool2d(
        torch.nn.functional.pad(-counts, (1, 1, 1, 1), value=-1e9)[None, None],
        3, stride=1)[0, 0]  # the fewest ranks among each cell's neighbours
    assert bool(((counts > 0) & (counts - 1 >= fewest)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
def test_tiled_momentum_reaches_every_edge(card, fast_math):
    """The tiled flagship momentum at cap 24 (``_reaches_every_edge``), bit
    for bit against the direct design, the row band and the other staging
    scheme, and within its twin's gate."""
    cfg = dataclasses.replace(BENCH, bucket_cap=24, fast_math=fast_math)
    eng, st = _live_state(card, w, cfg)
    _reaches_every_edge(eng, st, "momentum_sweep")
    got = ps.momentum_pass(eng, st, cfg)
    _held_to_designs("momentum_sweep", eng, st, cfg, got)
    _held_to_twin(got, ps.momentum_pass(eng, st, cfg),
                  ps.momentum_pass_plain(eng, st, cfg), fast_math)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
@pytest.mark.parametrize("split", [False, True], ids=["total", "split"])
def test_tiled_hopkins_reaches_every_edge(card, split, fast_math):
    """The tiled Hopkins momentum at cap 24 (``_reaches_every_edge``), the
    total form with null A_bg and P_bg,e planes, bit for bit against the
    direct design, the row band and the other staging scheme, and within
    its twin's gate."""
    cfg = dataclasses.replace(BENCH, bucket_cap=24, fast_math=fast_math)
    eng, st = _live_state(card, fh, cfg)
    _reaches_every_edge(eng, st, "hopkins_momentum_sweep")
    got = ps.hopkins_momentum_pass(eng, st, cfg, split)
    _held_to_designs("hopkins_momentum_sweep", eng, st, cfg, got,
                     background_split=split)
    _held_to_twin(got, ps.hopkins_momentum_pass(eng, st, cfg, split),
                  ps.hopkins_momentum_pass_plain(eng, st, cfg, split),
                  fast_math)


@pytest.mark.cuda
@pytest.mark.parametrize("self_pair", [True, False], ids=["self", "no_self"])
def test_tiled_pressure_reaches_every_edge(card, self_pair):
    """The tiled pressure root at cap 24 (``_reaches_every_edge`` on the
    full-Hopkins state) with the self pair and without it: bit for bit
    against the direct design, the row band and the other staging scheme,
    and within its twin's gate."""
    cfg = dataclasses.replace(BENCH, bucket_cap=24, self_density=self_pair)
    eng, st = _live_state(card, fh, cfg)
    _reaches_every_edge(eng, st, "pressure_sweep")
    got = ps.pressure_pass(eng, st, cfg)
    _held_to_designs("pressure_sweep", eng, st, cfg, [got])
    assert torch.equal(got, ps.pressure_pass(eng, st, cfg))
    torch.testing.assert_close(got, ps.pressure_pass_plain(eng, st, cfg),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_gamma_grad_kernel_matches_twin(card):
    """The tiled Colagrossi packing's ∇Γ sweep (the self pair, an exact
    divide), on a state whose h varies: bit for bit against the direct
    design, the row band and the other staging scheme, and within its
    twin's gate."""
    eng, st = _live_state(card, pv, PV_BENCH)
    V0 = 6.0e6
    before = ps.gamma_grad_pass.launches
    got = ps.gamma_grad_pass(eng, st, V0)
    assert ps.gamma_grad_pass.launches == before + 1
    _held_to_designs("gamma_grad_sweep", eng, st, None, got, V0=V0)
    _held_to_twin(got, ps.gamma_grad_pass(eng, st, V0),
                  ps.gamma_grad_pass_plain(eng, st, V0), False)


@pytest.mark.cuda
def test_tiled_gamma_grad_reaches_every_edge(card):
    """The tiled ∇Γ sweep at cap 24 (``_reaches_every_edge`` on the Pavelka
    state): bit for bit against the direct design, the row band and the
    other staging scheme, and within its twin's gate."""
    cfg = dataclasses.replace(PV_BENCH, bucket_cap=24)
    eng, st = _live_state(card, pv, cfg)
    _reaches_every_edge(eng, st, "gamma_grad_sweep")
    V0 = 6.0e6
    got = ps.gamma_grad_pass(eng, st, V0)
    _held_to_designs("gamma_grad_sweep", eng, st, None, got, V0=V0)
    _held_to_twin(got, ps.gamma_grad_pass(eng, st, V0),
                  ps.gamma_grad_pass_plain(eng, st, V0), False)


@pytest.mark.cuda
@pytest.mark.parametrize("self_pair", [True, False], ids=["self", "no_self"])
def test_tiled_density_reaches_every_edge(card, self_pair):
    """The tiled 2-D density at cap 24 (``_reaches_every_edge`` on the
    flagship state) with the self pair and without it: bit for bit against
    the direct design, the row band and the other staging scheme, and
    within its twin's gate."""
    cfg = dataclasses.replace(BENCH, bucket_cap=24, self_density=self_pair)
    eng, st = _live_state(card, w, cfg)
    _reaches_every_edge(eng, st, "density_sweep")
    got = ps.density_pass(eng, st, cfg)
    _held_to_designs("density_sweep", eng, st, cfg, [got])
    assert torch.equal(got, ps.density_pass(eng, st, cfg))
    torch.testing.assert_close(got, ps.density_pass_plain(eng, st, cfg),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_pavelka_kernel_steps_match_cpu_twins(card):
    """The Colagrossi packing (10 steps) and 8 Pavelka steps with the
    kernels on the card against the plain twins on the CPU: u_avg/u_max
    within rel 1e-5, equal active counts."""
    from sph_mountain_waves_tpu_torch.utils.packing import colagrossi_packing
    out = {}
    cfg = dataclasses.replace(PV_BENCH, fast_math=False)
    for label, device in (("card", card), ("cpu", torch.device("cpu"))):
        sys_ = pv.make_system(cfg)
        state = sys_.freeze(device=device)
        state = colagrossi_packing(cfg, sys_.engine, state, max_steps=10)
        state = frame_runner(pv.make_step(cfg, sys_.engine), 8)(state)
        out[label] = ([float(v) for v in velocity_diagnostics(state)],
                      int(state.n))
    assert out["card"][1] == out["cpu"][1]
    for a, b in zip(out["card"][0], out["cpu"][0]):
        assert a == pytest.approx(b, rel=1e-5)


# ------------------------------------------------ 3-D and dam-break kernels

W3D = dict(n_rows=6, dom_length=60e3, dom_depth=10e3, bc_rows=3,
           self_density=True, eta=1.2, dtype="float32", layout="bucket",
           lattice_cells=True, skin=0.15, use_pallas=True, renorm_iters=2)
DRY = dict(dr=0.08, dtype="float32", layout="bucket", skin=0.2,
           use_pallas=True)
C3D = dict(dr=2.0e-2, dtype="float32", layout="bucket", skin=0.2,
           use_pallas=True)


def _dam(name):
    from sph_mountain_waves_tpu_torch.models import collapse3d, collapse_dry
    return {"2d": (collapse_dry, DRY), "3d": (collapse3d, C3D)}[name]


def _live_3d(device, **over):
    """witch3d at the tiny size (``over`` replaces config fields) with v
    ±1 m/s, h ±1 % and P′ ±50 Pa."""
    from sph_mountain_waves_tpu_torch.models import witch3d as w3
    cfg = w3.Witch3DConfig(**{**W3D, **over})
    sys_ = w3.make_system(cfg)
    st = sys_.freeze(device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=device)

    act = st.active
    f = st.fields
    return sys_.engine, cfg, st.replace(
        v=torch.where(act[:, None], rand(f["v"].shape) * 2 - 1, 0.0),
        h=torch.where(act, f["h"] * (0.99 + 0.02 * rand(act.shape)), 0.0),
        P_p=torch.where(act, rand(act.shape) * 100 - 50, 0.0))


def _live_dam(device, name, **over):
    """A dam-break system (``over`` replaces config fields) with v ±1 m/s,
    ρ ±1 % and P in 0–5 kPa."""
    module, kw = _dam(name)
    cfg = module.Config(**{**kw, **over})
    sys_ = module.make_system(cfg)
    st = sys_.freeze(device=device)
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=device)

    act = st.active
    f = st.fields
    return sys_.engine, cfg, st.replace(
        v=torch.where(act[:, None], rand(f["v"].shape) * 2 - 1, 0.0),
        rho=torch.where(act, f["rho"] * (0.99 + 0.02 * rand(act.shape)), 0.0),
        P=torch.where(act, rand(act.shape) * 5e3, 0.0))


def _tiled_edges(eng, st, kernel="momentum_sweep_3d"):
    """The edges of a tiled sweep (2-D or 3-D) a state reaches: (a ragged
    last x-tile, tiles whose trip bound is 0, tiles with a bound > 0 but no
    occupied p slot)."""
    tx = ps._tile_tx(eng)
    bound = ps._trip_bound(kernel, eng, st)
    occ = eng.grid_view(st.active).sum(dim=0)            # [(nz,) ny, nx]
    nx = eng.lims[0]
    p_slots = torch.nn.functional.pad(occ, (0, -nx % tx)).reshape(
        -1, tx).sum(dim=-1)
    return (nx % tx != 0, int((bound == 0).sum()),
            int(((p_slots == 0) & (bound > 0)).sum()))


# the wrapper that launches each tiled export
_TILED_WRAPPER = {"density_sweep": ps.density_pass,
                  "density_sweep_3d": ps.density_pass,
                  "gamma_grad_sweep": ps.gamma_grad_pass,
                  "momentum_sweep_3d": ps.momentum_pass,
                  "dambreak_mass_sweep_3d": ps.dambreak_mass_pass,
                  "dambreak_force_sweep_3d": ps.dambreak_force_pass,
                  "pavelka_mass_sweep": ps.pavelka_mass_pass,
                  "pavelka_momentum_entropy_sweep":
                      ps.pavelka_momentum_entropy_pass,
                  "momentum_sweep": ps.momentum_pass,
                  "pressure_sweep": ps.pressure_pass,
                  "hopkins_momentum_sweep": ps.hopkins_momentum_pass,
                  "legacy_mass_sweep": ps.legacy_mass_pass,
                  "legacy_force_sweep": ps.legacy_force_pass,
                  "isph_matvec_sweep": ps.isph_matvec_pass,
                  "dambreak_mass_sweep": ps.dambreak_mass_pass,
                  "rb_mass_heat_sweep": ps.rb_mass_heat_pass,
                  "dambreak_force_sweep": ps.dambreak_force_pass,
                  "isph_div_visc_sweep": ps.isph_div_visc_pass,
                  "isph_grad_sweep": ps.isph_grad_pass,
                  "iso_static_force_sweep": ps.iso_static_force_pass,
                  "iso_static_mass_sweep": ps.iso_static_mass_pass,
                  "adia_entropy_force_sweep": ps.adia_entropy_force_pass}


def _held_to_designs(kernel, eng, st, cfg, got, **kw):
    """The wrapper's outputs bit for bit equal to each design's: the tiled
    one it launches (with the per-tile trip bound, and on the row band), the
    one-thread-per-slot sweep it replaced (with the row band) and, in 2-D,
    the tiled sweep's other staging scheme. The yardsticks count no
    launch. ``kw``: the Hopkins momentum's ``background_split``, the
    density's ``adiabatic``, the ∇Γ sweep's ``V0`` (the two terrain forces
    and the fused adiabatic sweep take their form from ``cfg``)."""
    wrapper = _TILED_WRAPPER[kernel]
    before = wrapper.launches
    for name, run in ps.tiled_yardsticks(kernel, eng, st, cfg, **kw).items():
        out = run()
        assert all(torch.equal(a, b) for a, b in zip(got, out)), name
    assert wrapper.launches == before


@pytest.mark.cuda
def test_density_kernel_matches_twin_in_3d(card):
    """The tiled density bit for bit against the direct design and the
    twin; reruns bitwise equal."""
    eng, cfg, st = _live_3d(card)
    before = ps.density_pass.launches
    got = ps.density_pass(eng, st, cfg)
    assert ps.density_pass.launches == before + 1
    _held_to_designs("density_sweep_3d", eng, st, cfg, [got])
    ref = ps.density_pass_plain(eng, st, cfg)
    _held_to_twin([got], [ps.density_pass(eng, st, cfg)], [ref], False)
    assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
def test_momentum_kernel_matches_twin_in_3d(card, fast_math):
    """The tiled momentum bit for bit against the direct design; against
    the twin bit for bit with exact divides,
    within 1e-3 of max |Dv| with fast_math; reruns bitwise equal."""
    eng, cfg, st = _live_3d(card)
    cfg = dataclasses.replace(cfg, fast_math=fast_math)
    before = ps.momentum_pass.launches
    got = ps.momentum_pass(eng, st, cfg)
    assert ps.momentum_pass.launches == before + 1 and len(got) == 3
    _held_to_designs("momentum_sweep_3d", eng, st, cfg, got)
    ref = ps.momentum_pass_plain(eng, st, cfg)
    _held_to_twin(got, ps.momentum_pass(eng, st, cfg), ref, fast_math)
    if not fast_math:
        assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("self_pair", [True, False], ids=["self", "no_self"])
def test_tiled_density_reaches_every_edge_in_3d(card, self_pair):
    """At cap 24 a tile is 10 x-cells: 128 cells leave a ragged last tile of
    8, and the tiny grid has tiles with a trip bound of 0 and tiles with a
    bound > 0 but no occupied p slot. Bit for bit against the direct design
    and the twin, with the self pair on and off."""
    eng, cfg, st = _live_3d(card, bucket_cap=24, self_density=self_pair)
    ragged, idle_tiles, empty_tiles = _tiled_edges(eng, st, "density_sweep_3d")
    assert ragged and idle_tiles > 0 and empty_tiles > 0
    got = ps.density_pass(eng, st, cfg)
    _held_to_designs("density_sweep_3d", eng, st, cfg, [got])
    assert torch.equal(got, ps.density_pass(eng, st, cfg))
    assert torch.equal(got, ps.density_pass_plain(eng, st, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
def test_tiled_momentum_reaches_every_edge_in_3d(card, fast_math):
    """The momentum on the cap-24 state of the density test above, held as
    in ``test_momentum_kernel_matches_twin_in_3d``; with non-finite values
    in every empty slot (skipped before any arithmetic) the tiled and the
    direct design still give the same finite outputs."""
    eng, cfg, st = _live_3d(card, bucket_cap=24, fast_math=fast_math)
    assert all(_tiled_edges(eng, st))
    got = ps.momentum_pass(eng, st, cfg)
    _held_to_designs("momentum_sweep_3d", eng, st, cfg, got)
    ref = ps.momentum_pass_plain(eng, st, cfg)
    _held_to_twin(got, ps.momentum_pass(eng, st, cfg), ref, fast_math)
    if not fast_math:
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    planes = [pl.clone() for pl in ps._momentum_inputs(eng, st, cfg)[0]]
    empty = planes[0] < 0.5
    for pl in planes[1:]:
        pl[empty] = float("nan")
    args = ps._momentum_scalars(cfg, 3) + [int(fast_math)]
    for name in ("momentum_sweep_3d", "momentum_sweep_3d_direct"):
        band = ps._trip_bound(name, eng, st)
        out = ps._launch(name, eng, planes, band, 3, args)
        assert all(torch.equal(a, b) for a, b in zip(out, got)), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["2d", "3d"])
def test_dambreak_mass_kernel_matches_twin(card, name):
    """The tiled design in 2-D (cap 24, a tile of 10 x-cells, a ragged last
    tile of 8) and 3-D (cap 40, a tile of 6 x-cells, a ragged last tile of
    2): bit for bit against its other designs (the direct one, the row band
    and, in 2-D, the other staging scheme) and the twin. Reruns bitwise
    equal."""
    eng, cfg, st = _live_dam(card, name)
    before = ps.dambreak_mass_pass.launches
    got = ps.dambreak_mass_pass(eng, st, cfg)
    assert ps.dambreak_mass_pass.launches == before + 1
    assert float(got.abs().max()) > 1.0
    ref = ps.dambreak_mass_pass_plain(eng, st, cfg)
    _held_to_twin([got], [ps.dambreak_mass_pass(eng, st, cfg)], [ref], False)
    kernel = {"2d": "dambreak_mass_sweep", "3d": "dambreak_mass_sweep_3d"}[name]
    assert all(_tiled_edges(eng, st, kernel))
    _held_to_designs(kernel, eng, st, cfg, [got])
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_tiled_dambreak_mass_reaches_every_edge(card):
    """The tiled 2-D dam-break continuity at cap 24 (``_reaches_every_edge``
    on the tiny collapse_dry: a ragged last tile of 8, tiles with a bound of
    0 and tiles with a bound but no occupied p slot): bit for bit against
    its other designs and the twin."""
    eng, cfg, st = _live_dam(card, "2d")
    _reaches_every_edge(eng, st, "dambreak_mass_sweep")
    assert _tiled_edges(eng, st, "dambreak_mass_sweep")[2] > 0
    got = ps.dambreak_mass_pass(eng, st, cfg)
    _held_to_designs("dambreak_mass_sweep", eng, st, cfg, [got])
    assert torch.equal(got, ps.dambreak_mass_pass_plain(eng, st, cfg))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["2d", "3d"])
def test_dambreak_force_kernel_matches_twin(card, name):
    """As the continuity above; WALL p slots exactly 0."""
    eng, cfg, st = _live_dam(card, name)
    before = ps.dambreak_force_pass.launches
    got = ps.dambreak_force_pass(eng, st, cfg)
    assert ps.dambreak_force_pass.launches == before + 1
    assert len(got) == eng.dim
    ref = ps.dambreak_force_pass_plain(eng, st, cfg)
    _held_to_twin(got, ps.dambreak_force_pass(eng, st, cfg), ref, False)
    wall = st.active & (st.fields["type"] == 1.0)
    assert all(bool((g[wall] == 0.0).all()) for g in got)
    kernel = {"2d": "dambreak_force_sweep",
              "3d": "dambreak_force_sweep_3d"}[name]
    assert all(_tiled_edges(eng, st, kernel))
    _held_to_designs(kernel, eng, st, cfg, got)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["collapse_dry", "rayleigh_benard"])
def test_tiled_dambreak_force_reaches_every_edge(card, path):
    """The tiled 2-D dam-break force at cap 24 (``_reaches_every_edge``: a
    ragged last tile of 8, tiles with a bound of 0 and tiles with a bound
    but no occupied p slot) on the tiny collapse_dry and on Rayleigh–Bénard
    at n_rows 16 (its engine forced to cap 24), whose force it is: bit for
    bit against its other designs and the twin, WALL p slots exactly 0."""
    if path == "collapse_dry":
        eng, cfg, st = _live_dam(card, "2d")
    else:
        cfg, eng, st = _live_rb(card, "conducting", cap=24)
    _reaches_every_edge(eng, st, "dambreak_force_sweep")
    assert _tiled_edges(eng, st, "dambreak_force_sweep")[2] > 0
    got = ps.dambreak_force_pass(eng, st, cfg)
    _held_to_designs("dambreak_force_sweep", eng, st, cfg, got)
    ref = ps.dambreak_force_pass_plain(eng, st, cfg)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    fluid = st.fields["type"] == 0.0
    assert all(bool((g[st.active & ~fluid] == 0.0).all()) for g in got)
    assert all(float(g.abs().max()) > 0 for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["dambreak_mass_sweep_3d",
                                    "dambreak_force_sweep_3d"])
def test_tiled_dambreak_matches_direct_at_full_width(card, kernel):
    """collapse3d at its full width (dr 5e-3: N = 103,479, grid 128 × 40 ×
    24, cap 40): the wrapper's tiled launch bit for bit against the direct
    design, reruns bitwise equal."""
    eng, cfg, st = _live_dam(card, "3d", dr=5e-3, skin=0.15)
    assert int(st.n) == 103_479 and eng.cap == 40
    wrapper = _TILED_WRAPPER[kernel]
    got, rerun = wrapper(eng, st, cfg), wrapper(eng, st, cfg)
    got, rerun = ([got], [rerun]) if torch.is_tensor(got) else (got, rerun)
    assert all(torch.equal(a, b) for a, b in zip(got, rerun))
    _held_to_designs(kernel, eng, st, cfg, got)


def _new_path(name, device):
    """(diagnostics, active count) of one new path after a few steps."""
    from sph_mountain_waves_tpu_torch.models import witch3d as w3
    if name == "witch3d":
        cfg = w3.Witch3DConfig(**W3D)
        sys_ = w3.make_system(cfg)
        st = sys_.freeze(device=device)
        st = w3.setup(cfg, sys_.engine, st)
        st = frame_runner(w3.make_step(cfg, sys_.engine), 6)(st)
        return [float(v) for v in velocity_diagnostics(st)], int(st.n)
    module, kw = _dam("2d" if name == "collapse_dry" else "3d")
    cfg = module.Config(**kw)
    sys_ = module.make_system(cfg)
    st = sys_.freeze(device=device)
    step = module.make_step(cfg, sys_.engine)
    if name == "collapse_dry":
        step, init_forces = step
        st = init_forces(st)
    st = frame_runner(step, 6)(st)
    speed = st.fields["v"][st.active].abs()
    return [float(speed.mean()), float(speed.max())], int(st.n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["witch3d", "collapse_dry", "collapse3d"])
def test_new_paths_kernel_steps_match_cpu_twins(card, name):
    """Six steps of each new path (witch3d after its set-up, collapse_dry
    after init_forces) with the kernels on the card against the plain twins
    on the CPU: the velocity diagnostics within rel 1e-5, equal counts."""
    got, n_card = _new_path(name, card)
    ref, n_cpu = _new_path(name, torch.device("cpu"))
    assert n_card == n_cpu
    for a, b in zip(got, ref):
        assert a == pytest.approx(b, rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["witch3d", "collapse_dry", "collapse3d"])
def test_use_pallas_off_is_refused_on_the_card_by_the_new_paths(card, name):
    from sph_mountain_waves_tpu_torch.models import witch3d as w3
    if name == "witch3d":
        module, cfg = w3, w3.Witch3DConfig(**{**W3D, "use_pallas": False})
    else:
        module, kw = _dam("2d" if name == "collapse_dry" else "3d")
        cfg = module.Config(**{**kw, "use_pallas": False})
    sys_ = module.make_system(cfg)
    state = sys_.freeze(device=card)
    step = module.make_step(cfg, sys_.engine)
    calls = list(step) if isinstance(step, tuple) else [step]
    if name == "witch3d":
        calls.append(lambda s: w3.setup(cfg, sys_.engine, s))
    wrappers = (ps.density_pass, ps.dambreak_mass_pass, ps.dambreak_force_pass)
    before = [wr.launches for wr in wrappers]
    for call in calls:
        with pytest.raises(ValueError, match="use_pallas=False on a CUDA state"):
            call(state)
    assert [wr.launches for wr in wrappers] == before


TERRAIN = dict(n_rows=14, dom_length=40e3, h_m=2000.0, a=6e3,
               dtype="float32", layout="bucket", skin=0.15, use_pallas=True)
LEGACY = {  # wrapper: (config factory, twin)
    "legacy_mass": ("isothermal_flow_config", ps.legacy_mass_pass_plain),
    "legacy_force": ("isothermal_flow_config", ps.legacy_force_pass_plain),
    "iso_static_mass": ("isothermal_static_config",
                        ps.iso_static_mass_pass_plain),
    "iso_static_force": ("isothermal_static_config",
                         ps.iso_static_force_pass_plain),
    "adia_density": ("adiabatic_static_config", ps.adia_density_pass_plain),
    "adia_entropy_force": ("adiabatic_flow_config",
                           ps.adia_entropy_force_pass_plain),
}


def _terrain_live(factory, device, **kw):
    """A terrain variant at n_rows=14 after one step, v ±1 m/s and ρ, h, T
    ±1 % from a seeded generator: (engine, state, config)."""
    from sph_mountain_waves_tpu_torch.models import legacy_witch as lw
    cfg = getattr(lw, factory)(**{**TERRAIN, **kw})
    sys_ = lw.make_system(cfg)
    st = sys_.freeze(device=device)
    st = lw.make_step(cfg, sys_.engine)(st)
    gen = torch.Generator(device=device).manual_seed(0)
    act = st.active

    def jitter(name, amp):
        r = torch.rand(st.fields[name].shape, generator=gen, device=device)
        return torch.where(act, st.fields[name] * (1 + amp * (2 * r - 1)), 0.0)

    dv = torch.rand(st.fields["v"].shape, generator=gen, device=device) * 2 - 1
    return sys_.engine, st.replace(
        v=torch.where(act[:, None], st.fields["v"] + dv, 0.0),
        rho=jitter("rho", 0.01), h=jitter("h", 0.01), T=jitter("T", 0.01)), cfg


@pytest.mark.cuda
@pytest.mark.parametrize("av,fast_math", [(0.0, False), (0.05, False),
                                          (0.05, True)],
                         ids=["exact", "av", "av_fast_math"])
@pytest.mark.parametrize("name", list(LEGACY))
def test_terrain_kernel_matches_twin(card, name, av, fast_math):
    """The five terrain kernels and the adiabatic density (the density
    kernel with the FLUID-gated weight): exact divides within rtol 1e-5 /
    atol 1e-6 × max of the twin, fast_math within 1e-3 of max; reruns
    bitwise; each launch counted by its own wrapper. The five tiled terrain
    kernels (the fused adiabatic sweep on the adiabatic flow, cap 16) also
    bit for bit against their other designs."""
    factory, twin = LEGACY[name]
    eng, st, cfg = _terrain_live(factory, card, av_alpha=av,
                                 fast_math=fast_math)
    wrapper = getattr(ps, f"{name}_pass")
    before = wrapper.launches
    got = wrapper(eng, st, cfg)
    assert wrapper.launches == before + 1
    got = got if isinstance(got, list) else [got]
    rerun = wrapper(eng, st, cfg)
    rerun = rerun if isinstance(rerun, list) else [rerun]
    ref = twin(eng, st, cfg)
    ref = ref if isinstance(ref, list) else [ref]
    assert len(got) == len(ref)
    _held_to_twin(got, rerun, ref, fast_math)
    if f"{name}_sweep" in _TILED_WRAPPER:
        _held_to_designs(f"{name}_sweep", eng, st, cfg, got)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {}, dict(true_rayleigh=True, consistent_entropy=True,
             outflow_buffer=2 * 1.8 * (26e3 / 14), av_alpha=0.05)],
    ids=["gated", "corrected"])
def test_tiled_adia_density_at_cap_16(card, extra):
    """The adiabatic density (the density kernel with the self pair and the
    FLUID-gated weight; m on every row under the corrected bundle's OUTFLOW
    buffer) on the n_rows=14 adiabatic flow, cap 16 (TX 16, 17,408 B every
    rank at once): one launch counted by its own wrapper, bit for bit
    against the direct design, the row band and the other staging scheme,
    and within its twin's gate."""
    eng, st, cfg = _terrain_live("adiabatic_flow_config", card, **extra)
    assert eng.cap == 16 and ps._tile_tx(eng) == 16
    before = ps.adia_density_pass.launches
    got = ps.adia_density_pass(eng, st, cfg)
    assert ps.adia_density_pass.launches == before + 1
    _held_to_designs("density_sweep", eng, st, cfg, [got], adiabatic=True)
    _held_to_twin([got], [ps.adia_density_pass(eng, st, cfg)],
                  [ps.adia_density_pass_plain(eng, st, cfg)], False)


@pytest.mark.cuda
@pytest.mark.parametrize("factory,extra", [
    ("isothermal_flow_config", {}), ("isothermal_static_config", {}),
    ("adiabatic_static_config", {}),
    ("adiabatic_flow_config", dict(true_rayleigh=True, consistent_entropy=True,
                                   outflow_buffer=2 * 1.8 * (26e3 / 14),
                                   av_alpha=0.05))],
    ids=["iso_flow", "iso_static", "adia_static", "adia_flow_corrected"])
def test_terrain_kernel_steps_match_cpu_twins(card, factory, extra):
    """8 steps of each terrain variant, kernels on the card against the
    twins on the CPU: u_avg/u_max within rel 1e-5, equal active counts; and
    ``use_pallas=False`` refused on the card."""
    from sph_mountain_waves_tpu_torch.models import legacy_witch as lw
    out = {}
    for device in (card, torch.device("cpu")):
        cfg = getattr(lw, factory)(**{**TERRAIN, **extra})
        sys_ = lw.make_system(cfg)
        state = sys_.freeze(device=device)
        state = frame_runner(lw.make_step(cfg, sys_.engine), 8)(state)
        out[device.type] = ([float(v) for v in velocity_diagnostics(state)],
                            int(state.n))
    assert out["cuda"][1] == out["cpu"][1]
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert a == pytest.approx(b, rel=1e-5)
    cfg = getattr(lw, factory)(**{**TERRAIN, **extra, "use_pallas": False})
    sys_ = lw.make_system(cfg)
    state = sys_.freeze(device=card)
    with pytest.raises(ValueError, match="use_pallas=False on a CUDA state"):
        lw.make_step(cfg, sys_.engine)(state)


@pytest.mark.cuda
@pytest.mark.parametrize("av,fast_math", [(0.0, False), (0.0, True),
                                          (0.05, False), (0.05, True)],
                         ids=["no_av-exact", "no_av-fast_math", "av-exact",
                              "av-fast_math"])
def test_tiled_iso_static_force_reaches_every_edge(card, av, fast_math):
    """The tiled per-particle-h force at cap 24 (``_reaches_every_edge`` on
    the n_rows=14 isothermal static state, its engine forced to cap 24: a
    ragged last tile of 8, idle tiles, empty q slots beside full ones)
    without AV (a null FLUID plane, 9 staged planes) and with it (10), each
    form on its own plan: one launch counted, bit for bit against the
    direct design, the row band and the other staging scheme, and within
    its twin's gate."""
    eng, st, cfg = _terrain_live("isothermal_static_config", card,
                                 bucket_cap=24, av_alpha=av,
                                 fast_math=fast_math)
    _reaches_every_edge(eng, st, "iso_static_force_sweep")
    assert _tiled_edges(eng, st, "iso_static_force_sweep")[2] > 0
    before = ps.iso_static_force_pass.launches
    got = ps.iso_static_force_pass(eng, st, cfg)
    assert ps.iso_static_force_pass.launches == before + 1
    _held_to_designs("iso_static_force_sweep", eng, st, cfg, got)
    _held_to_twin(got, ps.iso_static_force_pass(eng, st, cfg),
                  ps.iso_static_force_pass_plain(eng, st, cfg), fast_math)
    assert all(float(g.abs().max()) > 0 for g in got)


@pytest.mark.cuda
def test_tiled_iso_static_mass_reaches_every_edge(card):
    """The tiled per-particle-h continuity at cap 24
    (``_reaches_every_edge`` on the n_rows=14 isothermal static state, its
    engine forced to cap 24; 7 staged planes, no divide, one form): one
    launch counted, bit for bit against the direct design, the row band,
    the other staging scheme and its twin."""
    eng, st, cfg = _terrain_live("isothermal_static_config", card,
                                 bucket_cap=24)
    _reaches_every_edge(eng, st, "iso_static_mass_sweep")
    assert _tiled_edges(eng, st, "iso_static_mass_sweep")[2] > 0
    before = ps.iso_static_mass_pass.launches
    got = ps.iso_static_mass_pass(eng, st, cfg)
    assert ps.iso_static_mass_pass.launches == before + 1
    _held_to_designs("iso_static_mass_sweep", eng, st, cfg, [got])
    ref = ps.iso_static_mass_pass_plain(eng, st, cfg)
    _held_to_twin([got], [ps.iso_static_mass_pass(eng, st, cfg)], [ref],
                  False)
    assert torch.equal(got, ref) and float(got.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("av,fast_math", [(0.0, False), (0.0, True),
                                          (0.05, False), (0.05, True)],
                         ids=["no_av-exact", "no_av-fast_math", "av-exact",
                              "av-fast_math"])
def test_tiled_adia_entropy_force_reaches_every_edge(card, av, fast_math):
    """The tiled fused adiabatic entropy + force sweep at cap 24
    (``_reaches_every_edge`` on the n_rows=14 adiabatic static state, its
    engine forced to cap 24) in its four forms (AV × fast_math), all on one
    plan (9 staged planes: the FLUID gate enters the entropy term in both
    AV forms): one launch counted, bit for bit against the direct design,
    the row band and the other staging scheme; against the twin bit for bit
    with exact divides, within its gate with fast_math."""
    eng, st, cfg = _terrain_live("adiabatic_static_config", card,
                                 bucket_cap=24, av_alpha=av,
                                 fast_math=fast_math)
    _reaches_every_edge(eng, st, "adia_entropy_force_sweep")
    assert _tiled_edges(eng, st, "adia_entropy_force_sweep")[2] > 0
    before = ps.adia_entropy_force_pass.launches
    got = ps.adia_entropy_force_pass(eng, st, cfg)
    assert ps.adia_entropy_force_pass.launches == before + 1
    _held_to_designs("adia_entropy_force_sweep", eng, st, cfg, got)
    ref = ps.adia_entropy_force_pass_plain(eng, st, cfg)
    _held_to_twin(got, ps.adia_entropy_force_pass(eng, st, cfg), ref,
                  fast_math)
    if not fast_math:
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert all(float(g.abs().max()) > 0 for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,av,fast_math", [
    ("legacy_force_sweep", 0.0, False), ("legacy_force_sweep", 0.0, True),
    ("legacy_force_sweep", 0.05, False), ("legacy_force_sweep", 0.05, True),
    ("legacy_mass_sweep", 0.0, False)],
    ids=["no_av-exact", "no_av-fast_math", "av-exact", "av-fast_math",
         "mass"])
def test_tiled_legacy_force_reaches_every_edge(card, kernel, av, fast_math):
    """The tiled terrain force and continuity at cap 24
    (``_reaches_every_edge`` on the n_rows=14 terrain state: a ragged last
    tile, idle tiles, empty q slots beside full ones): the force without AV
    (a null FLUID plane, 8 staged planes) and with it (9), each form on its
    own plan, and the continuity (6 planes; it has neither AV nor a divide):
    one launch counted, bit for bit against the direct design, the row band
    and the other staging scheme, and within its twin's gate."""
    eng, st, cfg = _terrain_live("isothermal_flow_config", card, bucket_cap=24,
                                 av_alpha=av, fast_math=fast_math)
    _reaches_every_edge(eng, st, kernel)
    wrapper = _TILED_WRAPPER[kernel]
    twin = getattr(ps, wrapper.__name__ + "_plain")

    def as_list(out):
        return out if isinstance(out, list) else [out]
    before = wrapper.launches
    got = as_list(wrapper(eng, st, cfg))
    assert wrapper.launches == before + 1
    _held_to_designs(kernel, eng, st, cfg, got)
    _held_to_twin(got, as_list(wrapper(eng, st, cfg)),
                  as_list(twin(eng, st, cfg)), fast_math)


ISPH = dict(n_rows=10, dtype="float32", layout="bucket", skin=0.2,
            use_pallas=True)
RB = dict(n_rows=16, dtype="float32", layout="bucket", skin=0.2,
          use_pallas=True)


def _kicked(state, device):
    """v = 0.1·N(0, 1) on FLUID rows from a seeded generator: every ISPH
    step then solves a real pressure system."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    v = 0.1 * torch.randn(state.fields["v"].shape, generator=gen)
    return state.replace(v=torch.where(
        (state.fields["type"] == 0.0)[:, None], v.to(device), state.fields["v"]))


def _isph_live(device, cap=None):
    """The kicked ISPH state at n_rows=10 (at ``cap`` ranks a cell, or the
    engine's own) after one step (P is the first solve's solution)."""
    from sph_mountain_waves_tpu_torch.models import isph_witch as iw
    cfg = iw.ISPHWitchConfig(**ISPH, bucket_cap=cap)
    sys_ = iw.make_system(cfg)
    state = _kicked(sys_.freeze(device=device), device)
    return cfg, sys_.engine, iw.make_step(cfg, sys_.engine)(state)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["div_visc", "grad", "matvec"])
def test_isph_kernel_matches_twin_bitwise(card, name):
    """Each ISPH kernel equals its twin bit for bit and counts one launch a
    call; the prepared matvec one launch per call on the iterate. The tiled
    divergence/viscous sweep and gradient also bit for bit against their
    other designs."""
    cfg, eng, st = _isph_live(card)
    if name == "matvec":
        mv = ps.isph_matvec_prepared(eng, st, cfg)
        P = st.fields["P"]
        before = ps.isph_matvec_pass.launches
        got = [mv(P).clone()]
        assert ps.isph_matvec_pass.launches == before + 1
        rerun = [mv(P).clone()]
        ref = [ps.isph_matvec_pass_plain(eng, st, cfg, P)]
    else:
        wrapper, twin = {"div_visc": (ps.isph_div_visc_pass,
                                      ps.isph_div_visc_pass_plain),
                         "grad": (ps.isph_grad_pass,
                                  ps.isph_grad_pass_plain)}[name]
        before = wrapper.launches
        got = wrapper(eng, st, cfg)
        assert wrapper.launches == before + 1
        rerun, ref = wrapper(eng, st, cfg), twin(eng, st, cfg)
        _held_to_designs(f"isph_{name}_sweep", eng, st, cfg, got)
    for g, g2, r in zip(got, rerun, ref):
        assert torch.equal(g, g2) and torch.equal(g, r)
        assert r.abs().max() > 0


@pytest.mark.cuda
def test_tiled_isph_div_visc_reaches_every_edge(card):
    """The tiled ISPH divergence/viscous sweep at cap 24
    (``_reaches_every_edge`` on the kicked tiny ISPH state: a ragged last
    tile of 8, tiles with a bound of 0 and tiles with a bound but no
    occupied p slot): bit for bit against its other designs and the
    twin."""
    cfg, eng, st = _isph_live(card, cap=24)
    _reaches_every_edge(eng, st, "isph_div_visc_sweep")
    assert _tiled_edges(eng, st, "isph_div_visc_sweep")[2] > 0
    got = ps.isph_div_visc_pass(eng, st, cfg)
    _held_to_designs("isph_div_visc_sweep", eng, st, cfg, got)
    ref = ps.isph_div_visc_pass_plain(eng, st, cfg)
    assert all(torch.equal(g, r) and r.abs().max() > 0
               for g, r in zip(got, ref))


@pytest.mark.cuda
def test_tiled_isph_grad_reaches_every_edge(card):
    """The tiled ISPH pressure gradient at cap 24 (``_reaches_every_edge``
    on the kicked tiny ISPH state, P the first solve's solution: a ragged
    last tile of 8, tiles with a bound of 0 and tiles with a bound but no
    occupied p slot): one launch counted, bit for bit against its other
    designs and the twin."""
    cfg, eng, st = _isph_live(card, cap=24)
    _reaches_every_edge(eng, st, "isph_grad_sweep")
    assert _tiled_edges(eng, st, "isph_grad_sweep")[2] > 0
    before = ps.isph_grad_pass.launches
    got = ps.isph_grad_pass(eng, st, cfg)
    assert ps.isph_grad_pass.launches == before + 1
    _held_to_designs("isph_grad_sweep", eng, st, cfg, got)
    ref = ps.isph_grad_pass_plain(eng, st, cfg)
    assert all(torch.equal(g, r) and r.abs().max() > 0
               for g, r in zip(got, ref))


@pytest.mark.cuda
def test_prepared_tiled_matvec_takes_every_iterate(card):
    """The CG matvec prepared once (``isph_matvec_prepared``: the tiled
    kernel, its per-tile bound held in ``mv.prepared`` with the planes) and
    three different iterates through it: each call one launch counted, its
    output bit for bit that of every other design prepared once
    (``tiled_yardsticks``: ``_direct``, the row band, the other staging
    scheme; no launch counted) and of the twin."""
    cfg, eng, st = _isph_live(card)
    mv = ps.isph_matvec_prepared(eng, st, cfg)
    planes, band = mv.prepared
    assert len(planes) == 3 and band.dtype == torch.int32
    assert torch.equal(band, ps.tile_kmax(eng, st, ps._tile_tx(eng)))
    runs = ps.tiled_yardsticks("isph_matvec_sweep", eng, st, cfg)
    assert set(runs) == {"tiled", "tiled_row_band", "direct",
                         "tiled_two_stages"}
    gen = torch.Generator(device="cpu").manual_seed(7)
    noise = torch.randn(st.active.shape, generator=gen).to(card)
    for v in (st.fields["P"], torch.where(st.active, noise, 0.0),
              torch.where(st.active, 1e3 * noise.abs(), 0.0)):
        v = v.contiguous()
        before = ps.isph_matvec_pass.launches
        got = mv(v).clone()
        assert ps.isph_matvec_pass.launches == before + 1
        for name, run in runs.items():
            assert torch.equal(got, run(v)[0]), name
        assert ps.isph_matvec_pass.launches == before + 1
        ref = ps.isph_matvec_pass_plain(eng, st, cfg, v)
        assert torch.equal(got, ref) and ref.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("sidewalls", ["conducting", "adiabatic"])
def test_rb_kernel_matches_twin_bitwise(card, sidewalls):
    """The tiled Rayleigh–Bénard continuity + conduction (cap 16, TX 16):
    one launch counted, bit for bit against its other designs and the
    twin."""
    cfg, eng, st = _live_rb(card, sidewalls)
    before = ps.rb_mass_heat_pass.launches
    got = ps.rb_mass_heat_pass(eng, st, cfg)
    assert ps.rb_mass_heat_pass.launches == before + 1
    _held_to_designs("rb_mass_heat_sweep", eng, st, cfg, got)
    ref = ps.rb_mass_heat_pass_plain(eng, st, cfg)
    for g, r in zip(got, ref):
        assert torch.equal(g, r) and r.abs().max() > 0


def _live_rb(device, sidewalls, cap=None):
    """Rayleigh–Bénard at n_rows 16 (at ``cap`` ranks a cell, or the
    engine's own 16) after one step, with v ±0.01 m/s seeded."""
    from sph_mountain_waves_tpu_torch.models import rayleigh_benard as rb
    cfg = rb.Config(**RB, sidewalls=sidewalls)
    sys_ = rb.make_system(cfg)
    if cap:
        sys_.freeze_opts["cap"] = cap
    st = sys_.freeze(device=device)
    st = rb.make_step(cfg, sys_.engine)(st)
    gen = torch.Generator(device=device).manual_seed(0)
    dv = (torch.rand(st.fields["v"].shape, generator=gen, device=device) - 0.5)
    return cfg, sys_.engine, st.replace(
        v=torch.where(st.active[:, None], 0.02 * dv, 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("sidewalls", ["conducting", "adiabatic"])
def test_tiled_rb_mass_heat_reaches_every_edge(card, sidewalls):
    """The tiled Rayleigh–Bénard sweep at cap 24 (its grid is 128 x-cells
    wide, so only a cap whose tile does not divide 128 leaves a ragged last
    tile: TX 10, a last tile of 8), with tiles of bound 0 and tiles with a
    bound but no occupied p slot (``_reaches_every_edge``): bit for bit
    against its other designs and the twin, with both sidewalls."""
    cfg, eng, st = _live_rb(card, sidewalls, cap=24)
    _reaches_every_edge(eng, st, "rb_mass_heat_sweep")
    assert _tiled_edges(eng, st, "rb_mass_heat_sweep")[2] > 0
    got = ps.rb_mass_heat_pass(eng, st, cfg)
    _held_to_designs("rb_mass_heat_sweep", eng, st, cfg, got)
    ref = ps.rb_mass_heat_pass_plain(eng, st, cfg)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["isph_witch", "rayleigh_benard"])
def test_isph_rb_kernel_steps_match_cpu_twins(card, name):
    """Kernel steps on the card against the twins on the CPU: 2 kicked ISPH
    steps (mean/max |v| at rtol 2e-3, the reference's own gate: the f32 CG's
    iterates depend on the reductions' order) and 6 Rayleigh–Bénard steps
    (rel 1e-5); equal active counts."""
    from sph_mountain_waves_tpu_torch.models import isph_witch as iw
    from sph_mountain_waves_tpu_torch.models import rayleigh_benard as rb
    module, cfg, n_steps, rtol = {
        "isph_witch": (iw, iw.ISPHWitchConfig(**ISPH), 2, 2e-3),
        "rayleigh_benard": (rb, rb.Config(**RB), 6, 1e-5)}[name]
    out = {}
    for device in (card, torch.device("cpu")):
        sys_ = module.make_system(cfg)
        state = sys_.freeze(device=device)
        if module is iw:
            state = _kicked(state, device)
        state = frame_runner(module.make_step(cfg, sys_.engine), n_steps)(state)
        speed = state.fields["v"][state.active].abs()
        out[device.type] = ([float(speed.mean()), float(speed.max())],
                            int(state.n))
    assert out["cuda"][1] == out["cpu"][1]
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        assert a == pytest.approx(b, rel=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["isph_witch", "rayleigh_benard"])
def test_use_pallas_off_is_refused_on_the_card_by_isph_and_rb(card, name):
    from sph_mountain_waves_tpu_torch.models import isph_witch as iw
    from sph_mountain_waves_tpu_torch.models import rayleigh_benard as rb
    module, cfg = {
        "isph_witch": (iw, iw.ISPHWitchConfig(**{**ISPH, "use_pallas": False})),
        "rayleigh_benard": (rb, rb.Config(**{**RB, "use_pallas": False}))}[name]
    sys_ = module.make_system(cfg)
    state = sys_.freeze(device=card)
    wrappers = (ps.isph_div_visc_pass, ps.rb_mass_heat_pass)
    before = [wr.launches for wr in wrappers]
    with pytest.raises(ValueError, match="use_pallas=False on a CUDA state"):
        module.make_step(cfg, sys_.engine)(state)
    assert [wr.launches for wr in wrappers] == before


def _nusselt(Ra: float, t_end: float) -> float:
    """The steady square-cavity Nusselt number: 48 rows, adiabatic
    sidewalls, a strong seed (0.3), averaged over the last 8 of 20 frames;
    the reference's published-value gates (tests/test_rayleigh_benard.py)
    at the reference's settings, on the card."""
    from sph_mountain_waves_tpu_torch.models import rayleigh_benard as rb
    cfg = rb.Config(n_rows=48, aspect=1.0, Ra=Ra, sidewalls="adiabatic",
                    seed_amp=0.3, t_end=t_end, n_frames=20, layout="bucket",
                    skin=0.15, use_pallas=True)
    out = rb.run(cfg, device="cuda")
    nu = float(sum(out["Nu"][-8:]) / 8)
    print(f"Nu(Ra={Ra:g}) = {nu:.6f} on {torch.cuda.get_device_name(0)}")
    return nu


@pytest.mark.cuda
@pytest.mark.slow
def test_nusselt_ra1e4_published_value(card):
    """Ouertatani et al. (2008): Nu = 2.158 at Ra = 1e4; within 13 %."""
    nu = _nusselt(1e4, 60.0)
    assert abs(nu / 2.158 - 1.0) < 0.13, nu


@pytest.mark.cuda
@pytest.mark.slow
def test_nusselt_ra1e5_published_value(card):
    """Ouertatani et al. (2008): Nu = 3.91 at Ra = 1e5; within 12 %."""
    nu = _nusselt(1e5, 30.0)
    assert abs(nu / 3.91 - 1.0) < 0.12, nu
