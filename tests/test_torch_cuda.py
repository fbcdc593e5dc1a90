"""CUDA kernels of the port against their plain twins, on the card.

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


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _live_state(device, module=w):
    """The flagship (or another scheme) at n_rows=10 after one step, with v
    perturbed by a seeded ±1 m/s so that the viscosity term is live."""
    sys_ = module.make_system(BENCH)
    state = sys_.freeze(device=device)
    state = module.make_step(BENCH, sys_.engine)(state)
    gen = torch.Generator(device=device).manual_seed(0)
    dv = torch.rand(state.fields["v"].shape, generator=gen, device=device) * 2 - 1
    return sys_.engine, state.replace(
        v=torch.where(state.active[:, None], state.fields["v"] + dv, 0.0))


@pytest.mark.cuda
def test_density_kernel_matches_twin(card):
    eng, st = _live_state(card)
    before = ps.density_pass.launches
    got = ps.density_pass(eng, st, BENCH)
    assert ps.density_pass.launches == before + 1
    assert torch.equal(got, ps.density_pass(eng, st, BENCH))
    torch.testing.assert_close(got, ps.density_pass_plain(eng, st, BENCH),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
def test_momentum_kernel_matches_twin(card, fast_math):
    """Exact divides: the gate rtol 1e-5 / atol 1e-6. fast_math: the
    hardware's approximate reciprocal, held within 1e-3 of max |Dv|."""
    eng, st = _live_state(card)
    cfg = dataclasses.replace(BENCH, fast_math=fast_math)
    got = ps.momentum_pass(eng, st, cfg)
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
def test_pressure_kernel_matches_twin(card):
    eng, st = _live_state(card, fh)
    before = ps.pressure_pass.launches
    got = ps.pressure_pass(eng, st, BENCH)
    assert ps.pressure_pass.launches == before + 1
    assert torch.equal(got, ps.pressure_pass(eng, st, BENCH))
    torch.testing.assert_close(got, ps.pressure_pass_plain(eng, st, BENCH),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("fast_math", [False, True], ids=["exact", "fast_math"])
@pytest.mark.parametrize("split", [False, True], ids=["total", "split"])
def test_hopkins_momentum_kernel_matches_twin(card, split, fast_math):
    """Both forms of the Hopkins momentum, with the gates of the momentum
    kernel; reruns bitwise equal."""
    eng, st = _live_state(card, fh)
    cfg = dataclasses.replace(BENCH, fast_math=fast_math)
    before = ps.hopkins_momentum_pass.launches
    got = ps.hopkins_momentum_pass(eng, st, cfg, split)
    assert ps.hopkins_momentum_pass.launches == before + 1
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
@pytest.mark.parametrize("module", [w, fh], ids=["wcsph", "full_hopkins"])
def test_use_pallas_off_is_refused_on_the_card(card, module):
    """A CUDA state with use_pallas=False raises instead of running the
    plain twins on the card, and launches nothing."""
    cfg = dataclasses.replace(BENCH, use_pallas=False)
    sys_ = module.make_system(cfg)
    state = sys_.freeze(device=card)
    before = (ps.density_pass.launches, ps.pressure_pass.launches)
    with pytest.raises(ValueError, match="use_pallas=False on a CUDA state"):
        module.make_step(cfg, sys_.engine)(state)
    assert (ps.density_pass.launches, ps.pressure_pass.launches) == before
