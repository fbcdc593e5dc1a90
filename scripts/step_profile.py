#!/usr/bin/env python3
"""Device time, device kernels and wall time per step of nine paths of the
PyTorch port on one card, under torch.profiler: the WCSPH flagship and
full_hopkins (10 steps each from the built flagship-size state),
hopkins_total (10 steps after its hydrostatic packing), the terrain
baseline (10 steps after a 300-step frame, as ``chip_smoke.py`` builds
it), the isothermal and adiabatic static atmospheres at their configs'
default sizes (10 steps after 100, fast_math on as in ``chip_smoke.py``),
collapse_dry (dr
0.014) and collapse3d (dr 5e-3, cap 40) at ``chip_smoke.py``'s sizes (10
steps after init_forces where the path has it and 100 steps) and the
Rayleigh–Bénard baseline (10 steps after 100).
Each path's kernels and their launch counts are those of the checkout it
imports, so two checkouts can be compared on one card by running this
script once for each, in turns:

    python3 scripts/step_profile.py                      # this checkout
    python3 scripts/step_profile.py --root build/parent  # another checkout
    python3 scripts/step_profile.py --paths collapse_dry rayleigh_benard
    python3 scripts/step_profile.py --paths isothermal_static adiabatic_static

Prints one line per path (device ms/step, device kernels per step, wall
ms/step under the profiler, the device's idle share, the pair-sweep
kernels' own ms/step) and the card (nvidia-smi name and power limit).
Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time
from pathlib import Path

N_ROWS = 246       # the flagship size: N = 978,463, grid 1792 x 144, cap 8
TERRAIN_WARM = 300  # steps before the terrain's profiled ones
DAM_WARM = 100      # steps before the profiled ones of the two static
                    # paths, the dam breaks and Rayleigh–Bénard
N_STEPS = 10
PATHS = ("flagship", "full_hopkins", "hopkins_total", "terrain",
         "isothermal_static", "adiabatic_static", "collapse_dry",
         "collapse3d", "rayleigh_benard")


def kernel_name(key: str) -> str:
    """A demangled kernel name without its namespace, casts and argument
    list: pair_sweep_tiled<Pressure, true, true>."""
    key = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\((?:bool|int)\)|"
                 r"^void ", "", key)
    return key.split("(")[0]


def profiled(label, step, state, n_steps=N_STEPS):
    """One line: the device time (CUDA activity), the kernels (copies and
    fills left out), the wall time of ``n_steps`` steps under the profiler
    and the pair sweeps' share of the device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof
    with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state = step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n_steps * 1e3
    cuda = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not cuda:
        return f"{label}: not measured (torch.profiler recorded no kernel)"
    device_ms = sum(e.self_device_time_total for e in cuda) / n_steps / 1e3
    kernels = sum(e.count for e in cuda
                  if not e.key.startswith(("Memcpy", "Memset"))) / n_steps
    sweeps = {kernel_name(e.key): e.self_device_time_total / n_steps / 1e3
              for e in cuda if "pair_sweep" in e.key}
    return (f"{label}: device {device_ms:.4f} ms/step, {kernels:g} device "
            f"kernels per step, wall {wall_ms:.3f} ms/step under the "
            f"profiler, device idle {100 * (1 - device_ms / wall_ms):.1f} %; "
            f"pair sweeps {sum(sweeps.values()):.4f} ms/step ("
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(sweeps.items()))
            + ")")


def main(root: Path, paths) -> None:
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile needs one GPU")
    dev = torch.device("cuda", 0)
    from sph_mountain_waves_tpu_torch.models import (
        collapse3d as c3, collapse_dry as cd, full_hopkins_perturbed_witch as fh,
        hopkins_total_witch as ht, legacy_witch as lw, rayleigh_benard as rb,
        wcsph_perturbed_witch as w,
    )
    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.models.witch_common import WitchConfig
    from sph_mountain_waves_tpu_torch.utils.packing import hydrostatic_packing
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"checkout {root}", flush=True)

    cfg = WitchConfig(n_rows=N_ROWS, dtype="float32", self_density=True,
                      layout="bucket", skin=0.15, use_pallas=True,
                      lazy_diagnostics=True, lattice_cells=True,
                      fast_math=True)
    for label, module in (("flagship", w), ("full_hopkins", fh)):
        if label not in paths:
            continue
        system = module.make_system(cfg)
        state = system.freeze(device=dev)
        step = module.make_step(cfg, system.engine)
        step(state)  # warm-up: the kernels' build and first launches
        print(profiled(label, step, state), flush=True)
        del state, system

    if "hopkins_total" in paths:
        system = ht.make_system(cfg)
        state = system.freeze(device=dev)  # freeze makes system.engine
        state = hydrostatic_packing(cfg, system.engine, state)
        step = ht.make_step(cfg, system.engine)
        step(state)
        print(profiled("hopkins_total", step, state), flush=True)
        del state, system

    if "terrain" in paths:
        tcfg = lw.terrain_baseline_config(use_pallas=True, fast_math=True)
        system = lw.run_system(tcfg)
        state = system.freeze(device=dev)
        step = lw.make_step(tcfg, system.engine)
        state = frame_runner(step, TERRAIN_WARM)(state)
        print(profiled("terrain", step, state), flush=True)
        del state, system

    for label, factory in (("isothermal_static", lw.isothermal_static_config),
                           ("adiabatic_static", lw.adiabatic_static_config)):
        if label not in paths:
            continue
        scfg = factory(use_pallas=True, fast_math=True)
        system = lw.run_system(scfg)
        state = system.freeze(device=dev)
        step = lw.make_step(scfg, system.engine)
        state = frame_runner(step, DAM_WARM)(state)
        print(profiled(label, step, state), flush=True)
        del state, system

    # the dam breaks and Rayleigh–Bénard at chip_smoke.py's sizes
    others = {"collapse_dry": (cd, cd.Config(dr=0.014, dtype="float32",
                                             layout="bucket", skin=0.15,
                                             use_pallas=True)),
              "collapse3d": (c3, c3.Config(dtype="float32", layout="bucket",
                                           skin=0.15, use_pallas=True)),
              "rayleigh_benard": (rb, rb.baseline_config())}
    for label, (module, mcfg) in others.items():
        if label not in paths:
            continue
        system = module.make_system(mcfg)
        state = system.freeze(device=dev)
        step = module.make_step(mcfg, system.engine)
        if module is cd:
            step, init_forces = step
            state = init_forces(state)
        state = frame_runner(step, DAM_WARM)(state)
        print(profiled(label, step, state), flush=True)
        del state, system
    print(card, flush=True)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", type=Path,
                        default=Path(__file__).resolve().parent.parent,
                        help="the checkout whose port is profiled")
    parser.add_argument("--paths", nargs="+", choices=PATHS, default=PATHS,
                        help="the paths to profile (default: all)")
    args = parser.parse_args()
    main(args.root.resolve(), args.paths)
