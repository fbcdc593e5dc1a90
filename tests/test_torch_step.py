"""The port's flagship step against the JAX package, end to end on the CPU.

8 steps of the port's ``make_step`` (bench flags, n_rows=10; on CPU tensors
the sweeps take their plain twins) against 8 jitted steps of the JAX
``make_step`` on its XLA bucket path (``use_pallas=False``, which the
reference holds to its Pallas path at rel 1e-5, tests/test_pallas.py).
"""
import jax
import dataclasses

import numpy as np
import pytest
import torch

from sph_mountain_waves_tpu.models import wcsph_perturbed_witch as jw
from sph_mountain_waves_tpu.models.witch_common import (
    WitchConfig as JCfg, velocity_diagnostics as j_diag,
)

from sph_mountain_waves_tpu_torch.interop import state_from_numpy, state_to_numpy
from sph_mountain_waves_tpu_torch.models import wcsph_perturbed_witch as tw
from sph_mountain_waves_tpu_torch.models.common import frame_runner
from sph_mountain_waves_tpu_torch.models.witch_common import (
    WitchConfig as TCfg, velocity_diagnostics as t_diag,
)

torch.set_num_threads(1)

BENCH = dict(n_rows=10, dtype="float32", self_density=True, layout="bucket",
             skin=0.15, lazy_diagnostics=True, lattice_cells=True,
             fast_math=True)
N_STEPS = 8


@pytest.fixture(scope="module")
def stepped():
    """(JAX state, port state) after N_STEPS steps from the same build."""
    jcfg = JCfg(**BENCH, use_pallas=False)
    js = jw.make_system(jcfg)
    jstate = js.freeze()
    jstep = jax.jit(jw.make_step(jcfg, js.engine))
    for _ in range(N_STEPS):
        jstate = jstep(jstate)

    tcfg = TCfg(**BENCH, use_pallas=True)
    ts = tw.make_system(tcfg)
    tstate = ts.freeze(device="cpu")
    run_frame = frame_runner(tw.make_step(tcfg, ts.engine), N_STEPS)
    return jstate, run_frame(tstate)


def test_eight_steps_match_jax(stepped):
    """u_avg/u_max within rel 1e-5 and an equal active count (the
    reference's Pallas-vs-XLA gate). Slot by slot: x within 1/64 m, one f32
    ulp at the domain's largest |x| (2e5 m); v within 2e-5 of the largest
    |v|, because the XLA path sums each particle's pairs in another order
    than the sweep (q axis reduced per offset, then offsets) and the
    last-bit differences compound over 8 steps (measured 6e-6)."""
    jstate, tstate = stepped
    jd = [float(v) for v in j_diag(jstate)]
    td = [float(v) for v in t_diag(tstate)]
    assert np.all(np.isfinite(td))
    assert td[0] == pytest.approx(jd[0], rel=1e-5)
    assert td[1] == pytest.approx(jd[1], rel=1e-5)
    ja = np.asarray(jstate.active)
    tf, ta = state_to_numpy(tstate)
    assert ta.sum() == ja.sum() == 3514
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_allclose(tf["x"], np.asarray(jstate.fields["x"]),
                               rtol=0, atol=2.0**-6)
    jv = np.asarray(jstate.fields["v"])
    np.testing.assert_allclose(tf["v"], jv, rtol=0,
                               atol=2e-5 * np.abs(jv).max())


def test_finalize_matches_jax(stepped):
    """The lazy diagnostics (T, θ and perturbations) of the same stepped
    state. θ goes through exp and pow(·, 2/7), which XLA and PyTorch round
    differently in the last bits: rtol 1e-6, with an absolute floor of 1e-6
    of the total's largest value (T_p and θ_p are differences of totals and
    backgrounds, so they inherit the totals' rounding)."""
    jstate, _ = stepped
    jcfg, tcfg = JCfg(**BENCH), TCfg(**BENCH)
    fields = {k: np.asarray(v) for k, v in jstate.fields.items()}
    ref = jax.jit(jw.make_finalize(jcfg))(jstate)
    got = tw.make_finalize(tcfg)(
        state_from_numpy(fields, np.asarray(jstate.active), "cpu"))
    for name, total in (("T", "T"), ("T_p", "T"), ("theta", "theta"),
                        ("theta_bg", "theta_bg"), ("theta_p", "theta")):
        scale = np.abs(np.asarray(ref.fields[total])).max()
        np.testing.assert_allclose(got.fields[name].numpy(),
                                   np.asarray(ref.fields[name]), rtol=1e-6,
                                   atol=1e-6 * scale, err_msg=name)


def test_run_small():
    """``run`` drives frames end to end and keeps the static atmosphere
    near rest; live plots (``utils/plots.py``, not ported) are refused."""
    cfg = TCfg(n_rows=8, dtype="float32", self_density=True, layout="bucket",
               skin=0.15, lattice_cells=True, use_pallas=True,
               lazy_diagnostics=True, t_end=1.0, n_frames=2)
    out = tw.run(cfg, device="cpu")
    assert len(out["t"]) == 2
    assert np.all(np.isfinite(out["u_max"])) and out["u_max"][-1] < 5.0
    assert int(out["state"].n) == out["system"].n_built
    with pytest.raises(NotImplementedError, match="live plots"):
        tw.run(dataclasses.replace(cfg, live_plot=True), device="cpu")
