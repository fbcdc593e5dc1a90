"""The port's three Hopkins schemes and its hydrostatic packing against the
JAX package, end to end on the CPU.

8 steps of each port scheme (flagship flags, n_rows=10; on CPU tensors the
sweeps take their plain twins) against 8 jitted steps of the JAX scheme on
its XLA bucket path (``use_pallas=False``, which the reference holds to its
Pallas path at rel 1e-5, tests/test_pallas.py). The JAX steps are compiled
with ``QUICK_COMPILE`` (tests/torch_reference_harness.py: XLA backend
optimisation level 0 and cheap CPU code generation), which only saves
compile time (the options change the rounding, far inside the gate).

Also: the packing from one frozen state on both sides, ``run`` on the CPU,
and the entry points' default device (the card); and on the flat layout in
float64, ``hopkins_total.run`` with its packing against the reference's.
"""
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
import sph_mountain_waves_tpu.utils.packing as j_packing_module
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
import sph_mountain_waves_tpu_torch.utils.packing as t_packing_module
from sph_mountain_waves_tpu_torch.utils.packing import hydrostatic_packing
from torch_reference_harness import QUICK_COMPILE, jit_at_level0

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
        compiler_options=QUICK_COMPILE)
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


def test_packing_matches_jax(monkeypatch):
    """20 packing steps from the same frozen state. The step count is equal
    and err0 agrees within rtol 1e-5. The packing's sweeps round otherwise
    than the reference's XLA pair sums (module docstring of
    utils/packing.py); measured on this state: err 1.3e-7 relative apart,
    x 2.1e-9 m apart after a largest displacement of 3.7e-3 m, ρ 1.8e-7
    apart. Held at err rtol 1e-6, x atol 1e-6 m, ρ atol 1e-6."""
    jit_at_level0(monkeypatch)  # the reference packing's own jax.jit
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


def test_flat_packing_and_run_match_jax(monkeypatch):
    """``hopkins_total.run`` on the flat layout in float64 (n_rows 8, N =
    2,607, ``pair_mode="cell"``), its hydrostatic packing cut to 20 steps on
    both sides (each run's own ``setup`` calls the packing), then 16 steps
    in 4 frames, against the reference's run. The packing: equal step
    counts, err0 and err within rtol 1e-12, the packed x within 1e-9 m and
    ρ within 1e-12 of its largest value, row by row (measured: err 4e-16
    relative apart, x 1.7e-18 m, ρ 1.1e-16). The run: u_avg and u_max of
    every frame within rtol 1e-8 (measured: u_avg 6.5e-11, u_max 3.3e-16)
    and equal active counts. The walls are not held (the reference's move
    and accelerate carry no FLUID filter), so u_max grows by about 19 m/s
    every 4 steps on both sides, with the whole packing as with this one."""
    jit_at_level0(monkeypatch)  # the reference run's own jax.jit
    packed = {}

    def cut(tag, packing):
        def packing_20(cfg, engine, state):
            state, info = packing(cfg, engine, state, max_steps=20,
                                  return_info=True)
            # copied now: the reference's frame loop donates its input
            packed[tag] = ({k: np.array(state.fields[k]) for k in ("x", "rho")},
                           np.array(state.active), info)
            return state
        return packing_20

    monkeypatch.setattr(j_packing_module, "hydrostatic_packing",
                        cut("jax", j_packing))
    monkeypatch.setattr(t_packing_module, "hydrostatic_packing",
                        cut("port", hydrostatic_packing))
    kw = dict(n_rows=8, dtype="float64", layout="flat", self_density=True)
    kw.update(t_end=16 * TCfg(**kw).dt, n_frames=4)
    ref = jht.run(JCfg(**kw))
    out = tht.run(TCfg(**kw), device="cpu")
    assert out["system"].engine.layout == "flat"
    assert out["system"].engine.pair_mode == "cell"

    (jf, ja, jinfo), (tf, ta, tinfo) = packed["jax"], packed["port"]
    assert tinfo["steps"] == jinfo["steps"] == 20
    assert tinfo["err0"] == pytest.approx(jinfo["err0"], rel=1e-12)
    assert tinfo["err"] == pytest.approx(jinfo["err"], rel=1e-12)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tf["x"], jf["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(tf["rho"], jf["rho"], rtol=0,
                               atol=1e-12 * np.abs(jf["rho"]).max())

    assert len(out["u_max"]) == len(ref["u_max"]) == 4
    for key in ("t", "u_avg", "u_max"):
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-8,
                                   err_msg=key)
    assert np.all(np.diff(out["u_max"]) > 10.0)  # the walls fall
    assert int(out["state"].n) == out["system"].n_built == 2607


def test_run_on_cpu(capsys):
    """``run(..., device="cpu")`` drives two short frames of the full
    Hopkins scheme, keeps every particle and stays near rest; with
    ``live_plot`` each frame prints the u_max sparkline."""
    cfg = TCfg(n_rows=8, dtype="float32", self_density=True, layout="bucket",
               skin=0.15, lattice_cells=True, use_pallas=True, t_end=1.0,
               n_frames=2, live_plot=True)
    out = tfh.run(cfg, device="cpu")
    assert len(out["t"]) == 2
    assert np.all(np.isfinite(out["u_max"])) and out["u_max"][-1] < 5.0
    assert int(out["state"].n) == out["system"].n_built
    assert capsys.readouterr().out.count("u_max [") == 2


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
