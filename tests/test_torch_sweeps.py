"""The port's pair sweeps (plain twins on the CPU) against the JAX Pallas
passes in interpret mode, on one seeded state fed to both sides.

The state is the flagship at n_rows=10 (bench flags) with v perturbed by
±1 m/s, h by ±1 % and P′ by ±50 Pa, so every term of the momentum body is
live. Gate: rtol 1e-5 / atol 1e-6, the reference's own pass gate
(tests/test_pallas.py). The density twin is held against the interpret-mode
Pallas pass, the one real ``pallas_call`` of the port's tests: it ties the
eager harness (tests/torch_reference_harness.py) to the Pallas kernel's
summation order and masking. The momentum twin, with exact divides and with
fast_math, is held against the reference's own pair body summed by that
harness (an interpret-mode trace of the momentum kernel costs ~20 s).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_mountain_waves_tpu.ops.pallas_pairs as pp
from sph_mountain_waves_tpu.models import wcsph_perturbed_witch as jw
from sph_mountain_waves_tpu.models.witch_common import WitchConfig as JCfg
from sph_mountain_waves_tpu.structs import ParticleState as JState

from sph_mountain_waves_tpu_torch.interop import state_from_numpy
from sph_mountain_waves_tpu_torch.models import wcsph_perturbed_witch as tw
from sph_mountain_waves_tpu_torch.models.witch_common import WitchConfig as TCfg
from sph_mountain_waves_tpu_torch.ops import pair_sweeps as tps
from sph_mountain_waves_tpu_torch.structs import ParticleState
from torch_reference_harness import reference_body_sweep

torch.set_num_threads(1)

BENCH = dict(n_rows=10, dtype="float32", self_density=True, layout="bucket",
             skin=0.15, use_pallas=True, lazy_diagnostics=True,
             lattice_cells=True)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def states():
    """(JAX engine, JAX state, port engine, port state), identical inputs."""
    js = jw.make_system(JCfg(**BENCH))
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
    fields["P_p"] = np.where(active, rng.uniform(-50.0, 50.0, n),
                             0.0).astype(np.float32)
    jstate = JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                    active=jnp.asarray(active))
    te = tw.make_system(TCfg(**BENCH))
    te.freeze(device="cpu")
    te = te.engine
    assert (te.lims, te.phase, te.cap) == (je.lims, je.phase, je.cap)
    return je, jstate, te, state_from_numpy(fields, active, "cpu")


def _active(state):
    return state.active.numpy()


def _reference(pass_fn, jstate):
    """``pass_fn(state)`` traced once, compiled at XLA backend optimisation
    level 0 (the unrolled interpret-mode kernel otherwise spends most of
    its time in XLA's optimiser) and run."""
    compiled = jax.jit(pass_fn).lower(jstate).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return compiled(jstate)


def test_density_twin_matches_pallas(states):
    je, jstate, te, tstate = states
    cfg = JCfg(**BENCH)
    ref = np.asarray(_reference(
        lambda s: pp.density_pass(je, s, cfg, interpret=True), jstate))
    got = tps.density_pass(te, tstate, TCfg(**BENCH)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert np.all(got[~_active(tstate)] == 0.0)


@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
def test_momentum_twin_matches_pallas(states, fast_math, monkeypatch):
    """The reference's own momentum pair body, captured from its pass and
    summed eagerly in the Pallas harness's order
    (tests/torch_reference_harness.py, tied to the Pallas kernel by the
    density test's interpret-mode pass). With fast_math the reference body
    multiplies by ``pl.reciprocal(approx=True)``. Its documented
    interpret-mode value is the exact reciprocal (``_div_fn``'s docstring),
    which is what the port's twin computes; the installed JAX's interpret
    lowering instead evaluates it in bfloat16
    (jax/_src/pallas/primitives.py, _reciprocal_lowering_rule), a 2^-8
    relative error that moves Dv by ~1.4e-3 relative. The reference body
    therefore runs with the exact reciprocal it documents, at the unchanged
    gate."""
    je, jstate, te, tstate = states
    jcfg = JCfg(**BENCH, fast_math=fast_math)
    ref, captured = reference_body_sweep(pp.momentum_pass, je, jstate, jcfg,
                                         monkeypatch)
    assert captured["self_pair"] is False
    got = tps.momentum_pass(te, tstate, TCfg(**BENCH, fast_math=fast_math))
    assert len(got) == len(ref) == 2
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
        assert np.all(g.numpy()[~_active(tstate)] == 0.0)


def test_sweep_wrappers_take_twin_only_on_cpu(states):
    """The wrappers run the twin for CPU tensors, count no launch, and refuse
    any device other than cpu and cuda."""
    _, _, te, tstate = states
    cfg = TCfg(**BENCH)
    before = (tps.density_pass.launches, tps.momentum_pass.launches)
    assert torch.equal(tps.density_pass(te, tstate, cfg),
                       tps.density_pass_plain(te, tstate, cfg))
    assert (tps.density_pass.launches, tps.momentum_pass.launches) == before
    meta = ParticleState(fields=tstate.fields, active=tstate.active.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        tps.density_pass(te, meta, cfg)
