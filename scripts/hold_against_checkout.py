#!/usr/bin/env python3
"""Hold this checkout's sweeps of the 2-D density, the Colagrossi packing's
gradient, the Hopkins pressure root, the legacy continuity, the dam-break
continuity and force (2-D and 3-D, one body each), the Rayleigh–Bénard
continuity + conduction, the ISPH divergence/viscous sweep and pressure
gradient, the per-particle-h (isothermal static) continuity and force and
the fused adiabatic entropy + force sweep against
another checkout's build of ``csrc/pair_sweep.cu`` on the card, bit for
bit: the other checkout's one-thread-per-slot design of
each (its ``_direct`` yardstick where it has one, else the export itself,
which then ran on ``pair_sweep``) against this one's ``_direct`` yardsticks
and tiled exports. Tiny live states of the card tests
(``tests/test_torch_cuda.py``):
the flagship and full_hopkins at caps 8 and 24 with the self pair and
without it, the adiabatic density on the adiabatic flow (cap 16, gated and
corrected), the Pavelka state at caps 8 and 24, the terrain flow at caps 16
and 24, the isothermal static state at its own cap and at 24, collapse_dry
at dr 0.08 and at the timed size (dr 0.014, cap 24), collapse3d at dr 0.02
(cap 40), each with its continuity and force, Rayleigh–Bénard at n_rows 16
with both sidewalls at its own cap 16 and at cap 24, its continuity +
conduction and its force, the kicked ISPH state at its own cap 16 and at
caps 8 and 24, its divergence and its gradient, the isothermal static
state's continuity and force at its own cap 8 and at cap 24 (the force
without AV and with it, fast_math off and on), the fused adiabatic sweep on
the adiabatic static state at its own cap 8 and at cap 24 in the same four
forms and on the adiabatic flow (cap 16, gated and corrected).

    python3 scripts/hold_against_checkout.py build/parent

The other checkout's source is built with this checkout's nvcc flags into
``build/other_kernels/`` and called with this checkout's argument lists
(an export of the other's that ran on ``pair_sweep`` takes those of this
checkout's ``_direct`` export). Prints one line per case and a count;
exits non-zero on the first difference.
"""
from __future__ import annotations

import dataclasses
import ctypes
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

# exports of this checkout taken from the other checkout's build: under the
# same name there, or (a "_direct" yardstick the other lacks) under the name
# without "_direct", the export that ran the same design there
SHARED = ("density_sweep_direct", "gamma_grad_sweep_direct",
          "pressure_sweep_direct", "legacy_mass_sweep_direct",
          "dambreak_mass_sweep_direct", "dambreak_mass_sweep_3d_direct",
          "dambreak_force_sweep_direct", "dambreak_force_sweep_3d_direct",
          "rb_mass_heat_sweep_direct", "isph_div_visc_sweep_direct",
          "isph_grad_sweep_direct", "iso_static_force_sweep_direct",
          "iso_static_mass_sweep_direct", "adia_entropy_force_sweep_direct",
          "pair_sweep_error_string")


def other_library(other: Path):
    """The other checkout's pair_sweep.cu built here, its exports of SHARED
    under this checkout's names and signatures."""
    from sph_mountain_waves_tpu_torch.ops import _build
    out = ROOT / "build" / "other_kernels" / "pair_sweep.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    src = other / "sph_mountain_waves_tpu_torch" / "csrc" / "pair_sweep.cu"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    shim = types.SimpleNamespace()
    for mine in SHARED:
        try:
            fn = getattr(lib, mine)
        except AttributeError:
            fn = getattr(lib, mine.removesuffix("_direct"))
        fn.argtypes, fn.restype = _build.SIGNATURES["pair_sweep"][mine]
        setattr(shim, mine, fn)
    return shim


def main(other: Path) -> None:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    import test_torch_cuda as t
    from sph_mountain_waves_tpu_torch.models import (
        full_hopkins_perturbed_witch as fh, pavelka_total_witch as pv,
        wcsph_perturbed_witch as w,
    )
    from sph_mountain_waves_tpu_torch.ops import _build, pair_sweeps as ps
    dev = torch.device("cuda", 0)
    theirs, mine = other_library(other), _build.load("pair_sweep")

    def on_other(call):
        _build.load = lambda name: theirs
        try:
            return call()
        finally:
            _build.load = lambda name: mine

    cases = []  # (label, kernel, engine, state, config, tiled_yardsticks' kw)
    for cap in (None, 24):
        for self_pair in (True, False):
            cfg = dataclasses.replace(t.BENCH, bucket_cap=cap,
                                      self_density=self_pair)
            for kernel, module in (("density_sweep", w),
                                   ("pressure_sweep", fh)):
                eng, st = t._live_state(dev, module, cfg)
                cases.append((f"{kernel} cap {eng.cap} self_pair "
                              f"{self_pair}", kernel, eng, st, cfg, {}))
    for extra in ({}, dict(true_rayleigh=True, consistent_entropy=True,
                           outflow_buffer=2 * 1.8 * (26e3 / 14),
                           av_alpha=0.05)):
        eng, st, cfg = t._terrain_live("adiabatic_flow_config", dev, **extra)
        cases.append((f"density_sweep adiabatic cap {eng.cap}"
                      + (" corrected" if extra else ""), "density_sweep",
                      eng, st, cfg, {"adiabatic": True}))
    for cap in (None, 24):
        cfg = dataclasses.replace(t.PV_BENCH, bucket_cap=cap)
        eng, st = t._live_state(dev, pv, cfg)
        cases.append((f"gamma_grad_sweep cap {eng.cap}", "gamma_grad_sweep",
                      eng, st, None, {"V0": 6.0e6}))
    for cap in (None, 24):
        eng, st, cfg = t._terrain_live("isothermal_flow_config", dev,
                                       bucket_cap=cap)
        cases.append((f"legacy_mass_sweep cap {eng.cap}", "legacy_mass_sweep",
                      eng, st, cfg, {}))
    for name, over in (("2d", {}), ("2d", dict(dr=0.014, skin=0.15)),
                       ("3d", {})):
        eng, cfg, st = t._live_dam(dev, name, **over)
        for body in ("dambreak_mass_sweep", "dambreak_force_sweep"):
            kernel = body + ("_3d" if name == "3d" else "")
            cases.append((f"{kernel} dr {cfg.dr} cap {eng.cap}", kernel, eng,
                          st, cfg, {}))
    for cap in (None, 24):
        for sidewalls in ("conducting", "adiabatic"):
            cfg, eng, st = t._live_rb(dev, sidewalls, cap)
            for kernel in ("rb_mass_heat_sweep", "dambreak_force_sweep"):
                cases.append((f"{kernel} {sidewalls} cap {eng.cap}", kernel,
                              eng, st, cfg, {}))
    for cap in (None, 8, 24):
        cfg, eng, st = t._isph_live(dev, cap)
        for kernel in ("isph_div_visc_sweep", "isph_grad_sweep"):
            cases.append((f"{kernel} cap {eng.cap}", kernel, eng, st, cfg,
                          {}))
    for cap in (None, 24):
        eng, st, cfg = t._terrain_live("isothermal_static_config", dev,
                                       bucket_cap=cap)
        cases.append((f"iso_static_mass_sweep cap {eng.cap}",
                      "iso_static_mass_sweep", eng, st, cfg, {}))
        for factory, kernel in (
                ("isothermal_static_config", "iso_static_force_sweep"),
                ("adiabatic_static_config", "adia_entropy_force_sweep")):
            for av in (0.0, 0.05):
                for fm in (False, True):
                    eng, st, cfg = t._terrain_live(
                        factory, dev, bucket_cap=cap, av_alpha=av,
                        fast_math=fm)
                    cases.append((f"{kernel} cap {eng.cap} av_alpha {av} "
                                  f"fast_math {fm}", kernel, eng, st, cfg, {}))
    for extra in ({}, dict(true_rayleigh=True, consistent_entropy=True,
                           outflow_buffer=2 * 1.8 * (26e3 / 14),
                           av_alpha=0.05, fast_math=True)):
        eng, st, cfg = t._terrain_live("adiabatic_flow_config", dev, **extra)
        cases.append((f"adia_entropy_force_sweep adiabatic flow cap {eng.cap}"
                      + (" corrected" if extra else ""),
                      "adia_entropy_force_sweep", eng, st, cfg, {}))
    n = 0
    for label, kernel, eng, st, cfg, kw in cases:
        runs = ps.tiled_yardsticks(kernel, eng, st, cfg, **kw)
        got = on_other(runs["direct"])
        for name in ("direct", "tiled"):
            if not all(torch.equal(a, b) for a, b in zip(got, runs[name]())):
                raise AssertionError(f"{label}: the other checkout's sweep "
                                     f"differs from this one's {name}")
            n += 1
        print(f"{label}: the other checkout's sweep == this one's direct and "
              f"tiled", flush=True)
    print(f"{n} comparisons bit for bit against {other}")


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(Path(sys.argv[1]).resolve())
