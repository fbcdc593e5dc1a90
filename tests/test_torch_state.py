"""The PyTorch port's host build and neighbour engine against the JAX package.

Both packages build the flagship configuration (the bench flags at
n_rows=10: N=3,514, grid 128×16, cap 8) and must agree EXACTLY: the frozen
state slot for slot, and the rebuild (drift check + stencil rescatter),
field for field including the dropped-row count. The port never imports JAX;
only this test does.
"""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sph_mountain_waves_tpu.ops.pallas_pairs as pp
from sph_mountain_waves_tpu.kernels import rDwendland2 as j_rDw2, wendland2 as j_w2
from sph_mountain_waves_tpu.models import wcsph_perturbed_witch as jw
from sph_mountain_waves_tpu.models.witch_common import WitchConfig as JCfg
from sph_mountain_waves_tpu.structs import ParticleState as JState

from sph_mountain_waves_tpu_torch.interop import state_from_numpy, state_to_numpy
from sph_mountain_waves_tpu_torch.kernels import rDwendland2, wendland2
from sph_mountain_waves_tpu_torch.models import wcsph_perturbed_witch as tw
from sph_mountain_waves_tpu_torch.models.witch_common import WitchConfig as TCfg
from sph_mountain_waves_tpu_torch.ops import pair_sweeps as tps
from torch_reference_harness import QUICK_COMPILE

torch.set_num_threads(1)

BENCH = dict(n_rows=10, dtype="float32", self_density=True, layout="bucket",
             skin=0.15, use_pallas=True, lazy_diagnostics=True,
             lattice_cells=True, fast_math=True)


def _build_both(**over):
    kw = {**BENCH, **over}
    js = jw.make_system(JCfg(**kw))
    jstate = js.freeze()
    ts = tw.make_system(TCfg(**kw))
    tstate = ts.freeze(device="cpu")
    return js, jstate, ts, tstate


def _to_np(jstate):
    return ({k: np.asarray(v) for k, v in jstate.fields.items()},
            np.asarray(jstate.active))


def _assert_states_equal(jstate, tstate):
    jf, ja = _to_np(jstate)
    tf, ta = state_to_numpy(tstate)
    assert sorted(jf) == sorted(tf)
    np.testing.assert_array_equal(ta, ja)
    for name in jf:
        assert tf[name].dtype == jf[name].dtype, name
        assert tf[name].shape == jf[name].shape, name
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)


def test_package_does_not_import_jax():
    code = ("import sys\n"
            "import sph_mountain_waves_tpu_torch\n"
            "import sph_mountain_waves_tpu_torch.models.wcsph_perturbed_witch\n"
            "import sph_mountain_waves_tpu_torch.models.witch3d\n"
            "import sph_mountain_waves_tpu_torch.models.collapse_dry\n"
            "import sph_mountain_waves_tpu_torch.models.collapse3d\n"
            "import sph_mountain_waves_tpu_torch.models.legacy_witch\n"
            "import sph_mountain_waves_tpu_torch.ops.pair_sweeps\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'sph_mountain_waves_tpu'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, check=False)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("lattice_cells", [True, False], ids=["lattice", "skin"])
def test_built_state_matches_jax(lattice_cells):
    js, jstate, ts, tstate = _build_both(lattice_cells=lattice_cells)
    je, te = js.engine, ts.engine
    assert (te.cap, te.lims, te.phase, te.cells) == (je.cap, je.lims, je.phase, je.cells)
    assert te.slots == je.slots and te.skin_slack == je.skin_slack
    if lattice_cells:
        assert (js.n_built, te.lims, te.cap) == (3514, (128, 16), 8)
    _assert_states_equal(jstate, tstate)


@pytest.mark.parametrize("cap", [None, 4], ids=["bench_cap", "cap4_overflow"])
def test_rebuild_matches_jax(cap):
    """x displaced by seeded noise of up to 0.45 cell (far past the skin
    budget, within one cell): both rebuilds rescatter and must agree
    exactly. At cap 4 the lattice's uniform occupancy 4 leaves no headroom,
    so cells that gain a particle overflow and the dropped counts are
    nonzero. Both states carry the opt-in ``_rescatter_count`` field, which
    the rescatter must leave in place and count once."""
    js, jstate, ts, _ = _build_both(bucket_cap=cap)
    je, te = js.engine, ts.engine
    fields, active = _to_np(jstate)
    rng = np.random.default_rng(1)
    dx = rng.uniform(-0.45, 0.45, fields["x"].shape) * np.asarray(je.cell_size)
    fields["x"] = np.where(active[:, None], fields["x"] + dx,
                           0.0).astype(np.float32)
    fields["_rescatter_count"] = np.zeros(active.shape, np.float32)
    jin = JState(fields={k: jnp.asarray(v) for k, v in fields.items()},
                 active=jnp.asarray(active))
    jout, jn = jax.jit(je.rebuild).lower(jin).compile(
        compiler_options=QUICK_COMPILE)(jin)
    tout, tn = te.rebuild(state_from_numpy(fields, active, "cpu"))
    assert int(tn.overflow) == int(jn.overflow)
    if cap == 4:
        assert int(tn.overflow) > 0
    np.testing.assert_array_equal(tn.counts.numpy(), np.asarray(jn.counts))
    _assert_states_equal(jout, tout)
    assert tout.fields["_rescatter_count"].sum().item() == 1.0
    for jb, tb in zip(pp.row_kmax(je, jout), tps.row_kmax(te, tout)):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_rebuild_without_drift_keeps_state():
    """A freshly frozen state has not drifted: rebuild returns it as is."""
    _, _, ts, tstate = _build_both()
    out, nbrs = ts.engine.rebuild(tstate)
    assert int(nbrs.overflow) == 0
    for name, t in tstate.fields.items():
        assert torch.equal(out.fields[name], t), name


def test_forced_rescatter_is_identity_on_frozen_state():
    """Every particle is already in its slot after freeze: a forced
    rescatter moving all fields gives the state back bitwise, none dropped
    (the same check chip_smoke.py runs on the card at full size)."""
    _, _, ts, tstate = _build_both()
    eng = dataclasses.replace(ts.engine, persistent=())
    out, dropped = eng._stencil_rescatter(tstate)
    assert int(dropped) == 0
    assert torch.equal(out.active, tstate.active)
    for name, t in tstate.fields.items():
        assert torch.equal(out.fields[name], t), name


def test_wendland2_matches_jax():
    rng = np.random.default_rng(2)
    h = rng.uniform(100.0, 400.0, 257).astype(np.float32)
    r = (h * rng.uniform(0.0, 1.2, 257)).astype(np.float32)
    for jf, tf in ((j_w2, wendland2), (j_rDw2, rDwendland2)):
        ref = np.asarray(jf(jnp.asarray(h), jnp.asarray(r)))
        got = tf(torch.as_tensor(h), torch.as_tensor(r)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
