"""The port's Pavelka (entropy/GENERIC) scheme against the JAX package, on
the CPU at n_rows=10 (flagship flags: N=3,514, grid 128×16, cap 8).

What is compared, and at which tolerance:

* the frozen state, slot for slot and bit for bit (S included: it is built
  with NumPy on both sides);
* the two sweeps' plain twins (continuity with ``fixed_diffusion=True``,
  the fused momentum + entropy sweep with exact divides) against the
  reference passes' own pair bodies summed eagerly in the Pallas harness's
  order (tests/torch_reference_harness.py, which tests/test_torch_sweeps.py
  ties to real interpret-mode ``pallas_call``s; an interpret-mode pass of
  each Pavelka kernel cost 10 s and 20 s of tracing and compiling here), on
  one seeded state with v, h, ρ, P and T perturbed so that every term is
  live. Gate: the reference's pass gate
  rtol 1e-5 (tests/test_pallas.py), with atol = 1e-6 × the output's largest
  |value|. The continuity sum and the momentum sum cancel (Σ ker·x·v and
  the pressure gradient against its neighbours), so an absolute error is
  measured against the size of the sum, not of each slot; PyTorch's CPU
  ``sqrt`` is also not the correctly rounded one on every input (about
  0.7 % of f32 values are one ulp off), which can move single terms by a
  few ulp. Measured on this state: Drho, Dv and dS bitwise equal to the
  reference body;
* the variants (``fixed_diffusion=False``, ``fast_math``) against the same
  eager evaluation of the reference's pair *body*, at the same gate.
  ``fixed_diffusion=False`` is held at this one pass only: the scheme
  diverges with it by design. With ``fast_math`` the reference body runs
  with the exact reciprocal its ``_div_fn`` documents (the installed JAX
  evaluates ``pl.reciprocal(approx=True)`` in bfloat16 in interpret mode,
  see tests/test_torch_sweeps.py);
* 8 steps against the JAX XLA path (``use_pallas=False``) at the reference's
  own Pallas-vs-XLA gate: u_avg and u_max within rel 1e-5 and exactly equal
  active counts; plus mean T, max |ρ − ρ0| and S. T = ρ^(γ−1)·exp(s/(ρ·c_v))
  has s/(ρ·c_v) ≈ 10–13, so one ulp of ``exp``'s argument is ~1e-6 of T,
  and PyTorch's and XLA's f32 ``pow``/``exp`` differ in the last bit: T, ρ
  and S are held at 1e-5 of their largest |value| (measured: T 7.9e-7,
  ρ 1.2e-8, S and h equal);
* 10 Colagrossi packing steps, then the set-up's initial passes (continuity,
  smoothing rate, s, T, P, momentum) on the packed state, against the
  reference's packing and the same passes of its ``setup`` (XLA pair sums):
  ∇Γ, |∇Γ| and the passes within 1e-5 of their largest |value| (measured
  ≤ 5.8e-7), equal active masks, x within 1e-4 m (the test says why);
* ``setup`` on the flat layout in float64 (n_rows 8), its packing cut to
  10 steps on both sides, against the reference's ``setup`` run op by op:
  every field within 1e-12 of its largest |value| (measured: at most
  2.5e-16, on Dv), equal active masks.

Every JAX function the tests compile is compiled once, with
``QUICK_COMPILE`` (tests/torch_reference_harness.py: XLA backend
optimisation level 0 and cheap CPU code generation; compile time only, the
reference's numbers move far inside the gates). The reference's packings
run under their own ``jax.jit`` (the bucket one) or op by op (the flat
one).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_mountain_waves_tpu.ops.pallas_pairs as pp
from sph_mountain_waves_tpu.models import pavelka_total_witch as jpv
from sph_mountain_waves_tpu.models.witch_common import (
    velocity_diagnostics as j_diag,
)
from sph_mountain_waves_tpu.ops.apply import (
    apply_binary as j_apply_binary, apply_unary as j_apply_unary,
)
from sph_mountain_waves_tpu.structs import ParticleState as JState
import sph_mountain_waves_tpu.utils.packing as j_packing_module
from sph_mountain_waves_tpu.utils.packing import (
    colagrossi_packing as j_colagrossi,
)

from sph_mountain_waves_tpu_torch.interop import state_from_numpy, state_to_numpy
from sph_mountain_waves_tpu_torch.models import pavelka_total_witch as tpv
from sph_mountain_waves_tpu_torch.models.common import frame_runner
from sph_mountain_waves_tpu_torch.models.witch_common import (
    velocity_diagnostics as t_diag,
)
from sph_mountain_waves_tpu_torch.ops import pair_sweeps as tps
import sph_mountain_waves_tpu_torch.utils.packing as t_packing_module
from sph_mountain_waves_tpu_torch.utils.packing import colagrossi_packing
from torch_reference_harness import (
    QUICK_COMPILE, jit_at_level0, reference_body_sweep,
)

torch.set_num_threads(1)

BENCH = dict(n_rows=10, dtype="float32", self_density=True, layout="bucket",
             skin=0.15, use_pallas=True, lattice_cells=True)
RTOL, ATOL_REL = 1e-5, 1e-6
N_STEPS = 8


def _to_np(jstate):
    return ({k: np.asarray(v) for k, v in jstate.fields.items()},
            np.asarray(jstate.active))


def _compiled(fn, *args):
    """``fn`` traced once and compiled with ``QUICK_COMPILE``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=QUICK_COMPILE)


@pytest.fixture(scope="module")
def built():
    """(JAX system, its frozen state, port system, its frozen state)."""
    js = jpv.make_system(jpv.PavelkaConfig(**BENCH))
    jstate = js.freeze()
    ts = tpv.make_system(tpv.PavelkaConfig(**BENCH))
    tstate = ts.freeze(device="cpu")
    return js, jstate, ts, tstate


@pytest.fixture(scope="module")
def live(built):
    """(JAX engine, JAX state, port engine, port state): the frozen state
    with v ±1 m/s and h, ρ, P, T ±1 % from a seeded NumPy generator."""
    js, jstate, ts, _ = built
    fields, active = _to_np(jstate)
    rng = np.random.default_rng(0)
    n = active.shape[0]
    fields["v"] = np.where(active[:, None], rng.uniform(-1, 1, (n, 2)),
                           0.0).astype(np.float32)
    for name in ("h", "rho", "P", "T"):
        fields[name] = np.where(
            active, fields[name] * rng.uniform(0.99, 1.01, n),
            0.0).astype(np.float32)
    jlive = JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                   active=jnp.asarray(active))
    return js.engine, jlive, ts.engine, state_from_numpy(fields, active, "cpu")


def _check(got, ref, active):
    """The pass gate with atol scaled to the output's largest |value|; empty
    slots exactly zero."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                               atol=ATOL_REL * np.abs(ref).max())
    assert np.all(got.numpy()[~active] == 0.0)


def test_frozen_state_matches_jax(built):
    js, jstate, ts, tstate = built
    je, te = js.engine, ts.engine
    assert (te.cap, te.lims, te.phase, te.cells) == (je.cap, je.lims, je.phase,
                                                     je.cells)
    jf, ja = _to_np(jstate)
    tf, ta = state_to_numpy(tstate)
    assert sorted(jf) == sorted(tf)
    np.testing.assert_array_equal(ta, ja)
    for name in jf:
        assert tf[name].dtype == jf[name].dtype, name
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    assert np.abs(tf["S"]).max() > 0.0


def test_mass_twin_matches_pallas(live, monkeypatch):
    je, jlive, te, tlive = live
    jcfg = jpv.PavelkaConfig(**BENCH)
    (ref,), captured = reference_body_sweep(pp.pavelka_mass_pass, je, jlive,
                                            jcfg, monkeypatch)
    assert captured["self_pair"] is False
    before = tps.pavelka_mass_pass.launches
    got = tps.pavelka_mass_pass(te, tlive, tpv.PavelkaConfig(**BENCH))
    assert tps.pavelka_mass_pass.launches == before  # CPU tensors: the twin
    _check(got, ref, tlive.active.numpy())
    assert np.abs(np.asarray(ref)).max() > 1e-3


def test_momentum_entropy_twin_matches_pallas(live, monkeypatch):
    je, jlive, te, tlive = live
    jcfg = jpv.PavelkaConfig(**BENCH)
    refs, captured = reference_body_sweep(pp.pavelka_momentum_entropy_pass,
                                          je, jlive, jcfg, monkeypatch)
    assert captured["self_pair"] is False
    before = tps.pavelka_momentum_entropy_pass.launches
    gots = tps.pavelka_momentum_entropy_pass(te, tlive,
                                             tpv.PavelkaConfig(**BENCH))
    assert tps.pavelka_momentum_entropy_pass.launches == before
    assert len(gots) == len(refs) == 3
    for got, ref in zip(gots, refs):
        _check(got, ref, tlive.active.numpy())
    assert np.abs(np.asarray(refs[2])).max() > 0.0  # entropy production is live


@pytest.mark.parametrize("variant", ["mass-faithful-diffusion",
                                     "mass-fast_math",
                                     "momentum-entropy-fast_math"])
def test_sweep_variants_match_reference_body(live, variant, monkeypatch):
    je, jlive, te, tlive = live
    over = ({"fixed_diffusion": False} if variant == "mass-faithful-diffusion"
            else {"fast_math": True})
    jcfg = jpv.PavelkaConfig(**BENCH, **over)
    tcfg = tpv.PavelkaConfig(**BENCH, **over)
    if variant.startswith("mass"):
        refs, captured = reference_body_sweep(pp.pavelka_mass_pass, je, jlive,
                                              jcfg, monkeypatch)
        gots = [tps.pavelka_mass_pass(te, tlive, tcfg)]
    else:
        refs, captured = reference_body_sweep(
            pp.pavelka_momentum_entropy_pass, je, jlive, jcfg, monkeypatch)
        gots = tps.pavelka_momentum_entropy_pass(te, tlive, tcfg)
    assert captured["self_pair"] is False
    assert len(gots) == len(refs)
    for got, ref in zip(gots, refs):
        _check(got, ref, tlive.active.numpy())


def test_eight_steps_match_jax(built):
    js, jstate, ts, tstate = built
    jcfg = jpv.PavelkaConfig(**{**BENCH, "use_pallas": False})
    jstep = _compiled(jpv.make_step(jcfg, js.engine), jstate)
    for _ in range(N_STEPS):
        jstate = jstep(jstate)
    tcfg = tpv.PavelkaConfig(**BENCH)
    tstate = frame_runner(tpv.make_step(tcfg, ts.engine), N_STEPS)(tstate)
    jd = [float(v) for v in j_diag(jstate)]
    td = [float(v) for v in t_diag(tstate)]
    assert np.all(np.isfinite(td))
    assert td[0] == pytest.approx(jd[0], rel=1e-5)
    assert td[1] == pytest.approx(jd[1], rel=1e-5)
    jf, ja = _to_np(jstate)
    tf, ta = state_to_numpy(tstate)
    assert int(ta.sum()) == int(ja.sum()) == 3514
    np.testing.assert_array_equal(ta, ja)
    assert tf["T"][ta].mean() == pytest.approx(jf["T"][ja].mean(), rel=1e-5)
    assert (np.abs(tf["rho"][ta] - tcfg.rho0).max() == pytest.approx(
        np.abs(jf["rho"][ja] - jcfg.rho0).max(), rel=1e-5))
    for name in ("T", "rho", "S", "h"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0,
                                   atol=1e-5 * np.abs(jf[name]).max(),
                                   err_msg=name)


def test_packing_and_setup_passes_match_jax(built):
    js, jstate, ts, tstate = built
    jcfg, tcfg = jpv.PavelkaConfig(**BENCH), tpv.PavelkaConfig(**BENCH)
    x0 = np.asarray(jstate.fields["x"])
    # the reference's packing holds β and ζ as NumPy doubles; with x64
    # enabled (tests/conftest.py) they promote v, Dv and x to float64, which
    # its bucket rebuild refuses. It runs here as it does in production,
    # with x64 off.
    with jax.enable_x64(False):
        jpacked = j_colagrossi(jcfg, js.engine, jstate, max_steps=10)
    tpacked, info = colagrossi_packing(tcfg, ts.engine, tstate, max_steps=10,
                                       return_info=True)
    assert info["steps"] == 10
    jf, ja = _to_np(jpacked)
    tf, ta = state_to_numpy(tpacked)
    np.testing.assert_array_equal(ta, ja)
    # On the perfect lattice ∇Γ is zero inside the fluid up to rounding, and
    # the walls do not move: 10 steps move a particle by at most ~1.5e-5 m
    # (less than one f32 ulp of most positions), in a direction that the
    # summation order decides. x is therefore held at 1e-4 m (dr = 2600 m),
    # and ∇Γ, which the fence's outer edge dominates, is the check proper.
    assert np.abs(jf["x"] - x0).max() > 0.0
    np.testing.assert_allclose(tf["x"], jf["x"], rtol=0, atol=1e-4)
    gscale = np.abs(jf["gGamma"]).max()
    np.testing.assert_allclose(tf["gGamma"], jf["gGamma"], rtol=0,
                               atol=1e-5 * gscale)
    jnorm = float(np.sqrt((jf["gGamma"][ja] ** 2).sum()))
    assert info["res_g"] == pytest.approx(jnorm, rel=1e-5)
    assert np.all(tf["v"] == 0.0) and np.all(tf["Dv"] == 0.0)

    # the initial passes of ``setup`` on the packed state: the reference's
    # own sequence (XLA pair sums), one compile
    parts = jpv.make_step(jcfg, js.engine, parts=True)

    def j_initial(state):
        state, nbrs = js.engine.rebuild(state)
        state = j_apply_binary(js.engine, state, nbrs, parts["balance_of_mass"])
        for name in ("balance_of_smoothing", "find_s", "set_temperature",
                     "set_pressure"):
            state = j_apply_unary(state, parts[name])
        return j_apply_binary(js.engine, state, nbrs,
                              parts["balance_of_momentum"])

    jout = _compiled(j_initial, jpacked)(jpacked)
    tout = tpv.make_step(tcfg, ts.engine, parts=True)["initial_passes"](tpacked)
    jf, ja = _to_np(jout)
    tf, ta = state_to_numpy(tout)
    np.testing.assert_array_equal(ta, ja)
    for name in ("Drho", "Dh", "s", "T", "P", "Dv", "S"):
        np.testing.assert_allclose(tf[name], jf[name], rtol=0,
                                   atol=1e-5 * np.abs(jf[name]).max(),
                                   err_msg=name)
    assert np.abs(jf["Dv"]).max() > 1.0


def test_setup_runs_the_packing_then_the_passes(built):
    """``setup`` = the 100-step packing followed by the initial passes."""
    _, _, ts, tstate = built
    cfg = tpv.PavelkaConfig(**BENCH)
    got = tpv.setup(cfg, ts.engine, tstate)
    packed = colagrossi_packing(cfg, ts.engine, tstate, 1e-10, 1e-10, 100)
    want = tpv.make_step(cfg, ts.engine, parts=True)["initial_passes"](packed)
    for name in want.fields:
        assert torch.equal(got.fields[name], want.fields[name]), name
    assert float(got.fields["Dv"].abs().max()) > 1.0
    assert torch.equal(got.fields["S"], tstate.fields["S"])  # no production


def test_flat_setup_matches_jax(monkeypatch):
    """``setup`` (the Colagrossi packing, then the initial passes) on the
    flat layout in float64, n_rows 8 (N = 2,607, ``pair_mode="cell"``): its
    packing cut to 10 steps on both sides (each ``setup`` calls it), the
    reference's own ``jax.jit`` calls compiled with ``QUICK_COMPILE``
    (``jit_at_level0``: 5.6 s against 7.1 s op by op under
    ``jax.disable_jit`` on one core). Every field row by row within 1e-12
    of its largest |value| (measured: at most 2.5e-16 of it, on Dv; x, ∇Γ, Dρ, Dh, s and S
    equal), equal active masks, and the packing's last |∇Γ| the norm of
    the reference's ∇Γ."""
    infos = []

    def cut(packing, record):
        def packing_10(cfg, engine, state, abs_tol, rel_tol, max_steps,
                       **kw):
            got = packing(cfg, engine, state, abs_tol, rel_tol, 10, **kw)
            if record:
                infos.append(got[1])
            return got
        return packing_10

    monkeypatch.setattr(j_packing_module, "colagrossi_packing",
                        cut(j_colagrossi, False))
    monkeypatch.setattr(t_packing_module, "colagrossi_packing",
                        cut(colagrossi_packing, True))
    kw = dict(n_rows=8, dtype="float64", layout="flat", self_density=True)
    jcfg, tcfg = jpv.PavelkaConfig(**kw), tpv.PavelkaConfig(**kw)
    js = jpv.make_system(jcfg)
    jstate = js.freeze()
    ts = tpv.make_system(tcfg)
    tstate = ts.freeze(device="cpu")
    assert ts.engine.layout == "flat" and ts.engine.pair_mode == "cell"
    jit_at_level0(monkeypatch)
    jout = jpv.setup(jcfg, js.engine, jstate)
    tout = tpv.setup(tcfg, ts.engine, tstate)
    assert len(infos) == 1 and infos[0]["steps"] == 10
    jf, ja = _to_np(jout)
    tf, ta = state_to_numpy(tout)
    assert int(ta.sum()) == 2607
    np.testing.assert_array_equal(ta, ja)
    assert sorted(tf) == sorted(jf)
    for name in jf:
        np.testing.assert_allclose(tf[name], jf[name], rtol=0,
                                   atol=1e-12 * np.abs(jf[name]).max(),
                                   err_msg=name)
    assert np.abs(jf["Dv"]).max() > 1.0
    jnorm = float(np.sqrt((jf["gGamma"][ja] ** 2).sum()))
    assert infos[0]["res_g"] == pytest.approx(jnorm, rel=1e-12)


def test_use_pallas_off_on_cpu_and_route_check(built):
    """On CPU tensors the step runs with ``use_pallas`` on or off (the
    twins either way) and gives the same state."""
    _, _, ts, tstate = built
    outs = []
    for up in (True, False):
        cfg = tpv.PavelkaConfig(**{**BENCH, "use_pallas": up})
        outs.append(tpv.make_step(cfg, ts.engine)(tstate))
    for name in outs[0].fields:
        assert torch.equal(outs[0].fields[name], outs[1].fields[name]), name


def test_run_on_cpu_and_default_device(monkeypatch):
    """``run(..., device="cpu")`` drives the packing and two short frames;
    without ``device=`` it asks for the card and raises where there is
    none."""
    cfg = tpv.PavelkaConfig(n_rows=8, dtype="float32", self_density=True,
                            layout="bucket", skin=0.15, lattice_cells=True,
                            use_pallas=True, t_end=0.5, n_frames=2)
    out = tpv.run(cfg, device="cpu", packing=False)
    assert len(out["t"]) == 2 and np.all(np.isfinite(out["u_max"]))
    assert int(out["state"].n) == out["system"].n_built
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tpv.run(dataclasses.replace(cfg, n_frames=1))
