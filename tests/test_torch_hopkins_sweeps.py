"""The port's Hopkins sweeps (plain twins on the CPU) against the JAX Pallas
passes' own pair bodies, on one seeded state fed to both sides.

The state is the full Hopkins scheme at n_rows=10 (flagship flags; it
carries A and A_bg) with v perturbed by ±1 m/s, h by ±1 % and P by ±1 %, so
that the viscosity and both P^(1−2/γ) terms are live. Gate: rtol 1e-5 /
atol 1e-6, the reference's own pass gate (tests/test_pallas.py).

The Hopkins momentum is checked twice against one reference run: its pair
sweep on the reference's own hoisted powers (A^{1/γ}, max(P, P_floor)^(1−2/γ)
and their background twins) at the gate, and the wrapper end to end on the
port's hoisting. PyTorch's and XLA's f32 ``pow`` differ in the last bit on a
few dozen slots (62 of 16,392 for P^(1−2/γ) here), and the Hopkins sums
cancel: the total form adds terms of ~15 m/s² into x components of ~1e-4,
and the split form subtracts two such sums into ~0.1 m/s². One ulp of one
term then moves an output by up to ~6e-6, so the end-to-end check takes
atol = 1e-6 × the total form's max |Dv| (≈ 34 m/s² on this state), the
scale of the terms both forms sum.

Every form (pressure; the Hopkins momentum split and total, exact and
fast_math) is held against the reference's own pair body summed eagerly in
the Pallas harness's order (tests/torch_reference_harness.py, which
tests/test_torch_sweeps.py ties to real interpret-mode ``pallas_call``s of
the flagship's density and momentum passes). An interpret-mode pass of its
own per kernel cost 7 s (pressure) and 26 s (Hopkins momentum) of tracing
and compiling here; the eager body is the same code with the same mask and
order of summation, and agrees bitwise with the twin when fed the same
hoisted powers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_mountain_waves_tpu.ops.pallas_pairs as pp
from sph_mountain_waves_tpu.models import full_hopkins_perturbed_witch as jfh
from sph_mountain_waves_tpu.models.witch_common import (
    WitchConfig as JCfg, background_entropy_j,
)
from sph_mountain_waves_tpu.structs import ParticleState as JState

from sph_mountain_waves_tpu_torch.interop import state_from_numpy
from sph_mountain_waves_tpu_torch.models import full_hopkins_perturbed_witch as tfh
from sph_mountain_waves_tpu_torch.models.witch_common import (
    WitchConfig as TCfg, background_entropy, background_entropy_t,
)
from sph_mountain_waves_tpu_torch.ops import pair_sweeps as tps
from torch_reference_harness import reference_body_sweep

torch.set_num_threads(1)

BENCH = dict(n_rows=10, dtype="float32", self_density=True, layout="bucket",
             skin=0.15, use_pallas=True, lattice_cells=True)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def states():
    """(JAX engine, JAX state, port engine, port state), identical inputs."""
    js = jfh.make_system(JCfg(**BENCH))
    jstate = js.freeze()
    je = js.engine
    fields = {k: np.asarray(v) for k, v in jstate.fields.items()}
    active = np.asarray(jstate.active)
    rng = np.random.default_rng(0)
    n = active.shape[0]
    fields["v"] = np.where(active[:, None], rng.uniform(-1, 1, (n, 2)),
                           0.0).astype(np.float32)
    fields["h"] = np.where(active, fields["h"] * rng.uniform(0.99, 1.01, n),
                           0.0).astype(np.float32)
    fields["P"] = np.where(active, fields["P"] * rng.uniform(0.99, 1.01, n),
                           0.0).astype(np.float32)
    jstate = JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                    active=jnp.asarray(active))
    ts = tfh.make_system(TCfg(**BENCH))
    ts.freeze(device="cpu")
    te = ts.engine
    assert (te.lims, te.phase, te.cap) == (je.lims, je.phase, je.cap)
    return je, jstate, te, state_from_numpy(fields, active, "cpu")


def _check(got, ref, active, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=atol)
    assert np.all(got.numpy()[~active] == 0.0)


def test_pressure_twin_matches_pallas(states, monkeypatch):
    je, jstate, te, tstate = states
    (ref,), captured = reference_body_sweep(pp.pressure_pass, je, jstate,
                                            JCfg(**BENCH), monkeypatch)
    assert captured["self_pair"] is True  # self_density
    got = tps.pressure_pass(te, tstate, TCfg(**BENCH))
    _check(got, np.asarray(ref), tstate.active.numpy())


def _check_hopkins(states, jcfg, tcfg, split, ref, powers):
    """The sweep on the reference's hoisted power planes ``powers`` at the
    gate, then the wrapper end to end with atol scaled to the terms (module
    docstring)."""
    _, jstate, te, tstate = states
    active = tstate.active.numpy()
    planes, pad_vals = tps._hopkins_inputs(te, tstate, tcfg, split)
    assert len(powers) == len(planes) - 9
    planes[9:] = [te.resident(torch.from_numpy(np.array(a).reshape(-1))).contiguous()
                  for a in powers]
    band, _ = tps.row_kmax(te, tstate)
    sweep = tps._sweep_plain(te, planes, pad_vals, band,
                             tps._hopkins_body(tcfg, split), 2,
                             self_pair=False)
    got = tps.hopkins_momentum_pass(te, tstate, tcfg, background_split=split)
    scale = max(float(d.abs().max()) for d in tps.hopkins_momentum_pass(
        te, tstate, tcfg, background_split=False))
    for r, s, g_ in zip(ref, sweep, got):
        _check(s, r, active)
        _check(g_, r, active, atol=ATOL * scale)


def _eager_reference(states, cfg, split, monkeypatch):
    """The reference pass from its own pair body summed eagerly
    (tests/torch_reference_harness.py), and its hoisted power planes (the
    fields after x0, x1, h, m, v0, v1, ρ_f, c)."""
    je, jstate, _, _ = states
    ref, captured = reference_body_sweep(
        pp.hopkins_momentum_pass, je, jstate, cfg, monkeypatch,
        background_split=split)
    assert captured["self_pair"] is False
    return [np.asarray(r) for r in ref], captured["fields"][8:]


@pytest.mark.parametrize("split", [False, True], ids=["total", "split"])
def test_hopkins_momentum_twin_matches_pallas(states, split, monkeypatch):
    """The split and the total form (the same kernel with two planes fewer)
    against the reference's pair body evaluated eagerly."""
    cfg = JCfg(**BENCH)
    ref, powers = _eager_reference(states, cfg, split, monkeypatch)
    _check_hopkins(states, cfg, TCfg(**BENCH), split, ref, powers)


def test_hopkins_momentum_fast_math_twin_matches_pallas(states, monkeypatch):
    """fast_math, split on, against the reference's pair body evaluated
    eagerly. The body multiplies by ``pl.reciprocal(approx=True)``, whose
    documented interpret-mode value is the exact reciprocal (``_div_fn``'s
    docstring) and which the port's twin computes; the installed JAX's
    interpret lowering evaluates it in bfloat16 instead (see
    tests/test_torch_sweeps.py). The reference body therefore runs with the
    exact reciprocal it documents, at the unchanged gate."""
    cfg = JCfg(**BENCH, fast_math=True)
    ref, powers = _eager_reference(states, cfg, True, monkeypatch)
    _check_hopkins(states, cfg, TCfg(**BENCH, fast_math=True), True, ref,
                   powers)


def test_hopkins_wrappers_take_twin_only_on_cpu(states):
    """On CPU tensors the wrappers return the twins' values and count no
    launch."""
    _, _, te, tstate = states
    cfg = TCfg(**BENCH)
    before = (tps.pressure_pass.launches, tps.hopkins_momentum_pass.launches)
    assert torch.equal(tps.pressure_pass(te, tstate, cfg),
                       tps.pressure_pass_plain(te, tstate, cfg))
    for g, r in zip(tps.hopkins_momentum_pass(te, tstate, cfg, False),
                    tps.hopkins_momentum_pass_plain(te, tstate, cfg, False)):
        assert torch.equal(g, r)
    assert (tps.pressure_pass.launches,
            tps.hopkins_momentum_pass.launches) == before


def test_background_entropy_matches_jax():
    """A_bg = P_bg/ρ_bg^γ: the NumPy build-time form exactly, the torch twin
    in f32 to rtol 1e-6 (exp and pow round differently in the last bits)."""
    y = np.linspace(-6 * 2600.0, 26e3 + 6 * 2600.0, 257)
    jcfg, tcfg = JCfg(**BENCH), TCfg(**BENCH)
    from sph_mountain_waves_tpu.models.witch_common import (
        background_entropy as j_background_entropy)
    np.testing.assert_array_equal(background_entropy(tcfg, y),
                                  j_background_entropy(jcfg, y))
    y32 = y.astype(np.float32)
    ref = np.asarray(background_entropy_j(jcfg, jnp.asarray(y32)))
    got = background_entropy_t(tcfg, torch.from_numpy(y32)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6)
