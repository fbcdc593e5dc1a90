"""The port's three Hopkins schemes and its hydrostatic packing against the
JAX package, end to end on the CPU.

8 steps of each port scheme (flagship flags, n_rows=10; on CPU tensors the
sweeps take their plain twins) against 8 jitted steps of the JAX scheme on
its XLA bucket path (``use_pallas=False``, which the reference holds to its
Pallas path at rel 1e-5, tests/test_pallas.py). The JAX steps are compiled
at XLA backend optimisation level 0, which only saves compile time (the
level changes the rounding, far inside the gate).

Also: the packing from one frozen state on both sides, ``run`` on the CPU,
and the entry points' default device (the card).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from sph_mountain_waves_tpu.models import (
    full_hopkins_perturbed_witch as jfh, hopkins_perturbed_witch as jhp,
    hopkins_total_witch as jht,
)
from sph_mountain_waves_tpu.models.witch_common import (
    WitchConfig as JCfg, velocity_diagnostics as j_diag,
)
from sph_mountain_waves_tpu.utils.packing import (
    hydrostatic_packing as j_packing,
)

from sph_mountain_waves_tpu_torch.interop import state_from_numpy
from sph_mountain_waves_tpu_torch.models import (
    full_hopkins_perturbed_witch as tfh, hopkins_perturbed_witch as thp,
    hopkins_total_witch as tht,
)
from sph_mountain_waves_tpu_torch.models.common import frame_runner
from sph_mountain_waves_tpu_torch.models.witch_common import (
    WitchConfig as TCfg, velocity_diagnostics as t_diag,
)
from sph_mountain_waves_tpu_torch.utils.packing import hydrostatic_packing

torch.set_num_threads(1)

BENCH = dict(n_rows=10, dtype="float32", self_density=True, layout="bucket",
             skin=0.15, lattice_cells=True, fast_math=True)
N_STEPS = 8
SCHEMES = {"hopkins_perturbed": (jhp, thp), "full_hopkins": (jfh, tfh),
           "hopkins_total": (jht, tht)}


def _jax_steps(module, cfg, n):
    sys_ = module.make_system(cfg)
    state = sys_.freeze()
    step = jax.jit(module.make_step(cfg, sys_.engine)).lower(state).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    for _ in range(n):
        state = step(state)
    return state


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_eight_steps_match_jax(scheme):
    """u_avg/u_max within rel 1e-5 and exactly equal active counts (the
    reference's Pallas-vs-XLA gate). hopkins_total runs without its
    packing here (both sides start from the built state)."""
    jm, tm = SCHEMES[scheme]
    jstate = _jax_steps(jm, JCfg(**BENCH, use_pallas=False), N_STEPS)
    tcfg = TCfg(**BENCH, use_pallas=True)
    sys_ = tm.make_system(tcfg)
    tstate = sys_.freeze(device="cpu")
    tstate = frame_runner(tm.make_step(tcfg, sys_.engine), N_STEPS)(tstate)
    jd = [float(v) for v in j_diag(jstate)]
    td = [float(v) for v in t_diag(tstate)]
    assert np.all(np.isfinite(td))
    assert td[0] == pytest.approx(jd[0], rel=1e-5)
    assert td[1] == pytest.approx(jd[1], rel=1e-5)
    assert int(tstate.n) == int(np.asarray(jstate.active).sum()) == 3514


def test_packing_matches_jax():
    """20 packing steps from the same frozen state. The step count is equal
    and err0 agrees within rtol 1e-5. The packing's sweeps round otherwise
    than the reference's XLA pair sums (module docstring of
    utils/packing.py); measured on this state: err 1.3e-7 relative apart,
    x 2.1e-9 m apart after a largest displacement of 3.7e-3 m, ρ 1.8e-7
    apart. Held at err rtol 1e-6, x atol 1e-6 m, ρ atol 1e-6."""
    jcfg, tcfg = JCfg(**BENCH), TCfg(**BENCH)
    jsys = jht.make_system(jcfg)
    jstate = jsys.freeze()
    fields = {k: np.asarray(v) for k, v in jstate.fields.items()}
    active = np.asarray(jstate.active)
    jpacked, jinfo = j_packing(jcfg, jsys.engine, jstate, max_steps=20,
                               return_info=True)
    tsys = tht.make_system(tcfg)
    tsys.freeze(device="cpu")
    tpacked, tinfo = hydrostatic_packing(
        tcfg, tsys.engine, state_from_numpy(fields, active, "cpu"),
        max_steps=20, return_info=True)
    assert tinfo["steps"] == jinfo["steps"] == 20
    assert tinfo["err0"] == pytest.approx(jinfo["err0"], rel=1e-5)
    assert tinfo["err"] == pytest.approx(jinfo["err"], rel=1e-6)
    jx = np.asarray(jpacked.fields["x"])
    assert np.abs(jx - fields["x"]).max() > 1e-3  # the packing moved particles
    np.testing.assert_allclose(tpacked.fields["x"].numpy(), jx, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tpacked.fields["rho"].numpy(),
                               np.asarray(jpacked.fields["rho"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(tpacked.active.numpy(),
                                  np.asarray(jpacked.active))


def test_run_on_cpu():
    """``run(..., device="cpu")`` drives two short frames of the full
    Hopkins scheme, keeps every particle and stays near rest; live plots
    (``utils/plots.py``, not ported) are refused."""
    cfg = TCfg(n_rows=8, dtype="float32", self_density=True, layout="bucket",
               skin=0.15, lattice_cells=True, use_pallas=True, t_end=1.0,
               n_frames=2)
    out = tfh.run(cfg, device="cpu")
    assert len(out["t"]) == 2
    assert np.all(np.isfinite(out["u_max"])) and out["u_max"][-1] < 5.0
    assert int(out["state"].n) == out["system"].n_built
    with pytest.raises(NotImplementedError, match="live plots"):
        tfh.run(dataclasses.replace(cfg, live_plot=True), device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device=``, ``freeze`` and every scheme's ``run`` ask for
    CUDA; where there is none they raise, and never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TCfg(n_rows=8, dtype="float32", layout="bucket", use_pallas=True,
               t_end=1.0, n_frames=1)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        thp.make_system(cfg).freeze()
    for module in (thp, tfh, tht):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            module.run(cfg)
