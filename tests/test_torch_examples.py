"""Four of the canonical examples of the port against the JAX package on the
CPU: ``kepler_vortex``, ``collapse_symplectic``, ``cavity_flow`` and
``cylinder``, each at its config's defaults (the flat layout, float64) but
smoke-sized.

Sizes: ``kepler_vortex.Config(N_rings=15)`` (N = 3,196, gather),
``collapse_symplectic.Config(dr=0.04)`` (N = 2,046, gather),
``cavity_flow.Config(N=20)`` (N = 662, cell) and
``cylinder.Config(n_around=12)`` (N = 7,218, cell; capacity 1.5 N).

What is compared, and at which tolerance:

* ``make_system``: the host fields and the built count exactly, the frozen
  flat states bit for bit, the engines' grid, cap and pair mode equal;
* the bootstrap (where the model has one) and 6 steps (the cylinder: 4
  steps of its carry) against the reference's own flat float64 steps,
  compiled once per model with ``QUICK_COMPILE`` as one multi-step
  function: rows matched by position
  (``tests/torch_reference_harness.py::matched_rows``), every field within
  1e-12 of its largest |value|, equal active counts; the cylinder's time,
  force sums and sample count too. In the two summation-density models
  (Kepler, symplectic) P = c²(ρ − ρ0) cancels two densities that agree to
  ~1e-5 of themselves, so P and the pressure acceleration a are held on
  the cancelled terms' scale (``_scales``; on their own max they differ by
  2.6e-8 and 3.6e-8 while x and v are equal bit for bit and ρ within
  2.3e-16). Measured: at most 2.5e-14 (the cavity's v), 6.4e-16 for the
  scaled P and a;
* ``cylinder``: one step from a state where, in both packages, INFLOW rows
  are moved to x ≥ 0 so that spawns happen: the recycling's output
  (spawn count, target rows, every spawned field) bit for bit against the
  reference's own ``add_new_particles`` (taken from its step's closure),
  with free rows for every spawn and with too few (spawns dropped), then
  (with free rows) the whole step within 1e-12 of each field's max;
* ``collapse_symplectic``: ``run`` forward then reversed on the port,
  ``recovery_error < 100·FIXPA_EPS``; the forward entropies and kinetic
  energies within rtol 1e-12 of the reference's forward ``run``;
* ``cavity_flow``: ``run(out_path=...)`` (8 steps) writes the reference's
  files and ``data.csv`` columns, and its profiles (``compute_fluxes``'s
  probes on the final state) are within 1e-12 of the reference's on the
  scale of the interpolated field (max |v|: a probe is a Shepard average
  of v, and the profiles are near 0 this early; measured: 3.8e-15 of
  it), the final states within 1e-12;
* the entry points refuse to start without a card unless the caller asks
  for the CPU.

The reference's ``run``s compile their bootstrap and frames with
``QUICK_COMPILE`` (``jit_at_level0``).
"""
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_mountain_waves_tpu.models import (
    cavity_flow as jcf, collapse_symplectic as jcs, cylinder as jcy,
    kepler_vortex as jkv,
)
from sph_mountain_waves_tpu.structs import ParticleState as JState
from sph_mountain_waves_tpu.utils.fixpa import FIXPA_EPS

from sph_mountain_waves_tpu_torch.interop import state_from_numpy, state_to_numpy
from sph_mountain_waves_tpu_torch.io import read_csv
from sph_mountain_waves_tpu_torch.models import (
    cavity_flow as tcf, collapse_symplectic as tcs, cylinder as tcy,
    kepler_vortex as tkv,
)
from torch_reference_harness import QUICK_COMPILE, jit_at_level0, matched_rows

torch.set_num_threads(1)

MODELS = {"kepler_vortex": (jkv, tkv, dict(N_rings=15), 6),
          "collapse_symplectic": (jcs, tcs, dict(dr=0.04), 6),
          "cavity_flow": (jcf, tcf, dict(N=20), 6),
          "cylinder": (jcy, tcy, dict(n_around=12), 4)}
REL = 1e-12


def _carry(state, xp):
    """The cylinder's step carry (state, t, C_acc, nsamp) at t = 0."""
    if xp is jnp:
        return (state, jnp.zeros((), jnp.float64), jnp.zeros(2, jnp.float64),
                jnp.zeros((), jnp.int32))
    x = state.fields["x"]
    return (state, x.new_zeros(()), x.new_zeros(2),
            torch.zeros((), dtype=torch.int32))


def _freeze(name, sysm, device=None):
    kw = {} if device is None else {"device": device}
    if name == "cylinder":
        kw["capacity"] = int(sysm.n_built * 1.5)
    return sysm.freeze(**kw)


@functools.lru_cache(maxsize=None)
def _cylinder_step(engine, capacity):
    """The reference cylinder's step on a carry of ``capacity`` rows,
    compiled once with QUICK_COMPILE and shared by the tests that step it
    (the engine is hashable; its config is the default n_around=12 one)."""
    cfg = jcy.Config(**MODELS["cylinder"][2])
    step = jcy.make_step(cfg, engine)
    proto = jcy.make_system(cfg).freeze(capacity=capacity)
    return jax.jit(step).lower(_carry(proto, jnp)).compile(
        compiler_options=QUICK_COMPILE)


def _reference_steps(name, cfg, engine, jstate, n_steps):
    """The reference's bootstrap and ``n_steps`` steps, compiled with
    QUICK_COMPILE (the bootstrap and the steps as one function), applied
    to ``jstate``; the cylinder's steps one compiled step at a time on its
    carry."""
    jm = MODELS[name][0]
    if name == "cylinder":
        step = _cylinder_step(engine, jstate.capacity)
        carry = _carry(jstate, jnp)
        for _ in range(n_steps):
            carry = step(carry)
        return carry
    step, init = jm.make_step(cfg, engine)

    def run(s):
        return jax.lax.fori_loop(0, n_steps, lambda i, c: step(c), init(s))

    return jax.jit(run).lower(jstate).compile(
        compiler_options=QUICK_COMPILE)(jstate)


def _port_steps(name, cfg, engine, tstate, n_steps):
    tm = MODELS[name][1]
    if name == "cylinder":
        step = tm.make_step(cfg, engine)
        carry = _carry(tstate, torch)
        for _ in range(n_steps):
            carry = step(carry)
        return carry
    step, init = tm.make_step(cfg, engine)
    tstate = init(tstate)
    for _ in range(n_steps):
        tstate = step(tstate)
    return tstate


def _scales(name, cfg, jf):
    """Per-field scales of the comparison: each field's largest |value|,
    but in the two summation-density models P = c²(ρ − ρ0) cancels two
    densities that agree to ~1e-5, so P is held on the cancelled terms'
    scale c²·max ρ, and the pressure acceleration a on that scale carried
    through a's ratio to P."""
    out = {k: max(np.abs(v).max(), 1e-300) for k, v in jf.items()}
    if name in ("kepler_vortex", "collapse_symplectic"):
        p_scale = cfg.c**2 * np.abs(jf["rho"]).max()
        out["a"] *= p_scale / out["P"]
        out["P"] = p_scale
    return out


def _fields_close(name, cfg, jstate, tstate, rel=REL):
    """Rows matched by position; every field within rel × its scale
    (``_scales``). Returns the largest relative difference."""
    assert int(jstate.active.sum()) == int(tstate.active.sum())
    jf, tf = matched_rows(jstate, tstate)
    worst = 0.0
    for k, scale in _scales(name, cfg, jf).items():
        err = np.abs(tf[k] - jf[k]).max() / scale
        assert err <= rel, (k, err)
        worst = max(worst, err)
    return worst


@functools.lru_cache(maxsize=None)
def stepped(name):
    """(name, cfg, JAX system, port system, JAX state, port state), the
    states after the bootstrap and the model's steps from the frozen
    state; computed once per model and shared by the tests that read
    them."""
    jm, tm, kw, n_steps = MODELS[name]
    jcfg, tcfg = jm.Config(**kw), tm.Config(**kw)
    js, ts = jm.make_system(jcfg), tm.make_system(tcfg)
    jstate = _freeze(name, js)
    tstate = _freeze(name, ts, "cpu")
    jout = _reference_steps(name, jcfg, js.engine, jstate, n_steps)
    tout = _port_steps(name, tcfg, ts.engine, tstate, n_steps)
    return name, tcfg, js, ts, jout, tout


@pytest.mark.parametrize("name", list(MODELS))
def test_make_system_host_fields_exact(name):
    _, cfg, js, ts, _, _ = stepped(name)
    assert ts.n_built == js.n_built
    jh, th = js.host_fields(), ts.host_fields()
    assert list(th) == list(jh)
    for k in jh:
        np.testing.assert_array_equal(th[k], jh[k], err_msg=k)
    je, te = js.engine, ts.engine
    assert (te.lims, te.cap, te.pair_mode, te.layout, te.phase) == (
        je.lims, je.cap, je.pair_mode, "flat", je.phase)
    jstate = _freeze(name, js)
    tfields, tactive = state_to_numpy(_freeze(name, ts, "cpu"))
    np.testing.assert_array_equal(tactive, np.asarray(jstate.active))
    for k, arr in jstate.fields.items():
        assert tfields[k].dtype == np.float64
        np.testing.assert_array_equal(tfields[k], np.asarray(arr), err_msg=k)


@pytest.mark.parametrize("name", list(MODELS))
def test_steps_match_jax(name):
    _, cfg, js, ts, jout, tout = stepped(name)
    if name == "cylinder":
        (jst, jt, jC, jn), (tst, tt, tC, tn) = jout, tout
        assert float(tt) == float(jt) and int(tn) == int(jn)
        np.testing.assert_allclose(tC.numpy(), np.asarray(jC), rtol=REL,
                                   atol=REL * max(np.abs(np.asarray(jC)).max(), 1e-300))
        jout, tout = jst, tst
    assert tout.fields["x"].dtype == torch.float64
    _fields_close(name, cfg, jout, tout)


def _spawn_states(headroom):
    """(cfg, JAX system and state, port system and state): the cylinder
    frozen with free rows for every spawn (capacity 1.5 N) or for fewer
    than the spawns (capacity N, rounded up to 8 rows), and the first 8
    INFLOW rows (in row order) moved to x = 0.25 dr, ready to convert."""
    cfg = jcy.Config(n_around=12)
    js = jcy.make_system(cfg)
    ts = tcy.make_system(tcy.Config(n_around=12))
    cap = int(js.n_built * (1.5 if headroom else 1.0))
    jstate = js.freeze(capacity=cap)
    ts.freeze(device="cpu", capacity=cap)
    fields = {k: np.array(v) for k, v in jstate.fields.items()}
    active = np.array(jstate.active)
    rows = np.flatnonzero(active & (fields["type"] == jcy.INFLOW))[:8]
    fields["x"][rows, 0] = 0.25 * cfg.dr
    jstate = JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                    active=jnp.asarray(active))
    return cfg, js, jstate, ts, state_from_numpy(fields, active, "cpu")


@pytest.mark.parametrize("headroom", [True, False], ids=["free-rows", "drops"])
def test_cylinder_spawn_matches_jax(headroom):
    cfg, js, jstate, ts, tstate = _spawn_states(headroom)
    jstep = jcy.make_step(cfg, js.engine)
    closure = dict(zip(jstep.__code__.co_freevars,
                       (c.cell_contents for c in jstep.__closure__)))
    jnew = jax.jit(closure["add_new_particles"]).lower(jstate).compile(
        compiler_options=QUICK_COMPILE)(jstate)
    tnew = tcy.add_new_particles(tcy.Config(n_around=12), tstate)
    n0 = int(tstate.active.sum())
    spawned = int(tnew.active.sum()) - n0
    assert spawned == int(jnew.active.sum()) - n0
    free = tstate.capacity - n0
    assert spawned == min(8, free) and (headroom or spawned < 8)
    np.testing.assert_array_equal(tnew.active.numpy(), np.asarray(jnew.active))
    for k, arr in jnew.fields.items():
        np.testing.assert_array_equal(tnew.fields[k].numpy(), np.asarray(arr),
                                      err_msg=k)
    if not headroom:
        return
    # the whole step from that state (the same compiled step as the
    # steps test's: the same capacity)
    jout = _reference_steps("cylinder", cfg, js.engine, jstate, 1)
    (tst, tt, _, _) = _port_steps("cylinder", tcy.Config(n_around=12),
                                  ts.engine, tstate, 1)
    assert float(tt) == float(jout[1])
    _fields_close("cylinder", cfg, jout[0], tst)


def test_symplectic_run_reverts_and_matches_jax(monkeypatch):
    jit_at_level0(monkeypatch)  # the reference run's own jax.jit
    kw = dict(dr=0.04, t_end=20 * tcs.Config(dr=0.04).dt)  # 20 steps
    tout = tcs.run(tcs.Config(**kw), revert=True, n_entropy=2, device="cpu")
    assert tout["recovery_error"] < 100 * FIXPA_EPS
    assert int(tout["state"].n) == tout["system"].n_built
    jout = jcs.run(jcs.Config(**kw), revert=False, n_entropy=2)
    assert len(tout["S_forward"]) == len(jout["S_forward"]) == 2
    np.testing.assert_allclose(tout["S_forward"], jout["S_forward"], rtol=REL)
    np.testing.assert_allclose(tout["Ekin"], jout["Ekin"], rtol=REL)
    assert np.all(np.isfinite(tout["S_backward"]))


def test_cavity_run_writes_the_reference_files(monkeypatch):
    jit_at_level0(monkeypatch)  # the reference run's own jax.jit
    cfg = dict(N=20, n_frames=2)
    dt = tcf.Config(**cfg).dt
    cfg["t_end"] = 8 * dt
    with tempfile.TemporaryDirectory() as tmp:
        jdir, tdir = os.path.join(tmp, "jax"), os.path.join(tmp, "port")
        jout = jcf.run(jcf.Config(**cfg), out_path=jdir)
        tout = tcf.run(tcf.Config(**cfg), out_path=tdir, device="cpu")
        files = sorted(os.listdir(tdir))
        assert files == sorted(os.listdir(jdir))
        assert {"frame0.vtp", "frame1.vtp", "result.pvd", "data.csv"} <= set(files)
        jcsv, tcsv = read_csv(os.path.join(jdir, "data.csv")), read_csv(
            os.path.join(tdir, "data.csv"))
    assert list(tcsv) == list(jcsv) == ["s", "v1", "v2"]
    # the profiles are compute_fluxes's probes on the final state; a probe
    # is a Shepard average of v, held on v's scale (the profiles are near
    # 0 this early)
    v_max = float(tout["state"].fields["v"].abs().max())
    np.testing.assert_array_equal(tcsv["s"], jcsv["s"])
    for k in ("v1", "v2"):
        assert np.all(np.isfinite(tcsv[k])) and np.abs(jcsv[k]).max() > 0.0
        np.testing.assert_allclose(tcsv[k], jcsv[k], rtol=0.0,
                                   atol=REL * v_max)
    np.testing.assert_array_equal(tcsv["v1"], tout["v1"])
    _fields_close("cavity_flow", tcf.Config(**cfg),
                  jout["state"], tout["state"])


def test_entry_points_need_a_card():
    for run, cfg in ((tkv.run, tkv.Config(N_rings=15)),
                     (tcs.run, tcs.Config(dr=0.04)),
                     (tcf.run, tcf.Config(N=20)),
                     (tcy.run, tcy.Config(n_around=12))):
        with pytest.raises(RuntimeError, match="CUDA"):
            run(cfg)
