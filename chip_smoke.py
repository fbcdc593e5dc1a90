#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: the WCSPH mountain-wave flagship, the
three pressure–entropy (Hopkins) schemes, the entropy-based (Pavelka) scheme,
the file output of ``run``, the 3-D mountain wave (``witch3d``), the two
dam breaks (``collapse_dry``, ``collapse3d``) and the terrain family
(``legacy_witch``: isothermal and adiabatic, flow and static), the ISPH
mountain wave (``isph_witch``: matrix-free CG with the two-level multigrid
preconditioner) and Rayleigh–Bénard convection (``rayleigh_benard``).

Drives ``sph_mountain_waves_tpu_torch`` (never JAX) on one CUDA card at the
bench configuration (2-D mountain wave, n_rows=246: N=978,463 particles,
f32, bucket layout, lattice cells, skin 0.15, self_density, fast_math)
through the entry points a user calls: make_system -> freeze -> make_step ->
frame_runner -> velocity_diagnostics (and, for hopkins_total and Pavelka,
their packing set-ups), and ``run(cfg, out_path=...)`` at a small size;
then the 3-D path at the stretch size (``witch3d.stretch_config(bucket_cap=8)``:
N=3,247,157, grid 384 x 56 x 32, 27-cell stencil), the dam breaks at the
reference's sizes (``collapse_dry`` dr=0.014, ``collapse3d`` dr=5e-3, cap 40)
and the terrain baseline (``legacy_witch.terrain_baseline_config``: N=212,819,
grid 256 x 72, cap 24, square lattice, inflow recycling with slot-targeted
spawns under the stencil rescatter) with the other three terrain variants at
their configs' default sizes; then the ISPH baseline
(``isph_witch.baseline_config()``: N=207,672, grid 896 x 72, cap 8, kicked)
and the Rayleigh–Bénard baseline (``rayleigh_benard.baseline_config()``:
N=53,621, grid 256 x 80, cap 16); last, the flat layout in float32 and
float64 (phases 35-39): the flagship at full width, the 2-D schemes at their
default configurations and the reference's cross-layout gates; the 3-D
schemes on the flat layout and the flat pressure solves (phases 40-43); and
the terrain family on the flat layout in float32 and float64 with
Rayleigh–Bénard's RKPM conduction (phases 44-45).

Phases, each printing one or more lines:
  1. the card (nvidia-smi name and power limit);
  2. build of the CUDA kernels from csrc/ (nvcc, sm_90a), with ptxas
     registers, spills and static shared memory of every instantiation;
  3. flagship build and shape checks;
  4. a forced rescatter of the frozen state, which must be the identity;
  5. the flagship's kernels against their plain PyTorch twins at full size
     (fast_math off and on), plus bitwise-equal reruns; the density (with
     the self pair and without it) and the momentum (the tiled 9-cell
     design) with their tile plans, bit for bit against the
     one-thread-per-slot design (``_direct``), the tiled export on the row
     band and its other staging scheme;
  6. a small-input check: 8 flagship kernel steps on the card against 8
     steps of the plain twins on the CPU;
  7. the flagship main path: 1 warm-up frame and 2 timed frames of 100
     steps, with the kernels' launch counters set to 0 before and read after;
  8. the Hopkins kernels against their twins at full size on a live full
     Hopkins state: the pressure root with the self pair and without it,
     and the Hopkins momentum with the background split on and off,
     fast_math off and on; reruns bitwise equal; both (the tiled design:
     the pressure root in either self-pair form, the momentum each form on
     its own plan) with their tile plans, bit for bit against ``_direct``,
     the row band and the other staging scheme;
  9. 8 small steps of each Hopkins scheme, card against CPU twins;
 10. the full Hopkins main path: 1 warm-up and 2 timed frames of 100 steps;
 11. hopkins_total: its hydrostatic packing at full size, then 1 warm-up and
     1 timed frame;
 12. hopkins_perturbed: 1 frame of 100 steps;
 13. the Pavelka kernels (continuity with both diffusion forms, fused
     momentum + entropy) and the packing's gradient sweep (each the tiled
     9-cell design) against their twins at full size on a live Pavelka
     state, fast_math off and on; reruns bitwise equal; the three with
     their tile plan (TX, threads, blocks, dynamic shared bytes of both
     staging schemes, tiles with a non-zero bound, the mean per-tile bound
     against the mean row band, the warps of the working blocks that hold
     no occupied p slot), bit for bit against the one-thread-per-slot
     design (``_direct``), the tiled export on the row band and its other
     staging scheme;
 14. 8 small Pavelka steps, card against CPU twins;
 15. the Pavelka main path: its set-up (Colagrossi packing, 100 steps, then
     the initial passes) at full size, then 1 warm-up and 2 timed frames of
     100 steps, with max h over the cell width and over the cutoff; then
     the device and wall time of 10 steps from the packed state under
     torch.profiler, with the device's idle share of those steps;
 16. ``run(cfg, out_path=..., device="cuda")`` of the flagship at n_rows=10
     with a checkpoint every frame: the file set, the last frame read back,
     and a resumed run against the uninterrupted one, bit for bit;
 17. witch3d build at the stretch size with shape checks, host build
     seconds and peak device memory;
 18. a forced 3-D rescatter of the frozen state (27 offsets), which must be
     the identity, with its time and peak memory;
 19. the 3-D density and momentum kernels (the tiled design) at full width
     on a live state: the tile plan and the per-tile trip bound against the
     row band, bit for bit against the one-thread-per-slot design they
     replaced (``_direct``) and the tiled export on the row band, fast_math
     off and on; bit for bit against their
     twins with fast_math off, within 1e-3 of the output's max with it;
     reruns bitwise equal;
 20. witch3d: its set-up (4 mass-renormalisation iterations; the summed
     density's median over the background within 1e-3 of 1), 6 tiny steps
     card against CPU twins, then the main path: 1 warm-up and 2 timed frames
     of 20 steps, and the device and wall time of 10 more steps under
     torch.profiler, with the device's idle share of those steps;
 21. the dam-break continuity and force kernels, 2-D and 3-D, against their
     twins on live collapse_dry and collapse3d states at full size: the
     tiled design of each pair with its tile plan (TX, threads, blocks,
     dynamic shared bytes, tiles with a non-zero bound, the mean per-tile
     bound against the mean row band), bit for bit against the
     one-thread-per-slot design (``_direct``), the tiled export on the row
     band, (2-D) the other staging scheme and their twins; the force exactly
     0 on WALL slots;
 22. 8 small steps of each dam break, card against CPU twins;
 23. the dam-break main paths: 1 warm-up and 1 timed frame of 100 steps
     (collapse_dry after init_forces), with the energy; then the device and
     wall time of 10 more collapse3d steps under torch.profiler, with the
     device's idle share of those steps;
 24. the terrain baseline built as ``legacy_witch.run`` builds it, with
     shape checks and host seconds; forced stencil and sort rescatters of the
     frozen state (stencil: the identity; sort: equal to it slot for slot);
 25. the five terrain kernels and the adiabatic density (the density kernel
     with the FLUID-gated weight) against their twins at full width: the
     isothermal-flow pair on the baseline after 50 steps, the others on the
     isothermal and adiabatic static configs' default sizes; exact divides,
     fast_math, and the AV term with both; reruns bitwise equal; all six
     run the tiled 9-cell design: the terrain continuity and force, the
     per-particle-h (isothermal static) continuity and force (each terrain
     force each AV form on its own plan), the fused adiabatic entropy +
     force sweep (one plan for both AV forms) and the adiabatic density (the
     tiled density with the self pair and the gated weight, cap 8), with
     their tile plans, bit for bit against the one-thread-per-slot design
     (``_direct``), the tiled export on the row band and its other staging
     scheme;
 26. 8 small steps of each terrain variant, card against CPU twins;
 27. the terrain main path: 1 warm-up and 2 timed frames of 300 steps (past
     the first inflow spawn event), with the spawn events, spawn_drops, the
     INFLOW and active counts, drag/lift and the rescatters;
 28. one 100-step run (warm-up and timed halves) of each other terrain
     variant at its default size, the adiabatic flow with the corrected
     bundle (Rayleigh sponge, consistent entropy, OUTFLOW buffer, AV); then
     the adiabatic density and the fused adiabatic entropy + force sweep on
     that flow's final state (cap 16, TX 16) with their tile plan, bit for
     bit against their designs and within their twins' gate;
 29. ``legacy_witch.run(cfg, out_path=..., device="cuda")`` of a small flow
     config through a spawn event, a checkpoint every frame: the file set,
     the data.csv columns, and a resumed run bit for bit;
 31. the ISPH baseline, kicked: build, shapes, the V-cycle's levels, the
     coarse stencil's and one V-cycle's time; the three ISPH kernels
     (divergence/viscous, CG matvec on the first solve's P, pressure
     gradient) against their twins at full width, max abs err 0, reruns
     bitwise; the matvec (the tiled design, prepared once per solve), the
     divergence/viscous sweep and the pressure gradient (tiled) with their
     tile plans, bit for bit against ``_direct``, the row band and the other
     staging scheme (the matvec's each prepared once); 2 small kicked steps
     card against
     CPU twins; the main path:
     a warm-up frame of 5 steps and 20 timed steps with every launch
     counted, cg_it per step (matvec launches = sum of (cg_it + 1)), the
     last solve's cg_res, and over 2 more steps the kernel launches per CG
     iteration (torch.profiler) and the host syncs per step (sync debug
     mode);
 32. the Rayleigh–Bénard baseline: its fused continuity + conduction
     kernel and its dam-break force (both the tiled design) with their tile
     plans, bit for bit against ``_direct``, the row band and the other
     staging scheme and against the twin (max abs err 0) with conducting
     and adiabatic sidewalls, reruns bitwise; 6 small steps card against
     CPU twins; the main path: a warm-up frame and 2 timed frames of 500
     steps, KE and Nu;
 33. ``run(cfg, out_path=..., device="cuda")`` of both baselines at full
     width, a checkpoint every frame: the file set, the data.csv columns and
     a resumed run bit for bit;
 34. the reference's slow dam-break gate on the port's f32 bucket path and
     in the reference's own configuration (f64 flat, skin 0):
     ``collapse_dry.run`` at dr 0.02 to t_end 1.2 s (10,000 steps), the
     wavefront X against the digitised Violeau curve
     (tests/reference_data/dambreak_X_Violeau.csv), max relative error
     < 0.016 and mean < 0.005, each with the seconds it took;
 35. the flagship's flat path at full width (n_rows 246, skin 0,
     self_density; N = 978,463), f32 and f64: build, 1 warm-up and 2 timed
     frames of 20 steps through frame_runner with the sweep counters set to
     0 before and read after (the flat path launches none), every value
     finite, every particle kept, overflow 0 on a rebuild of the final
     state; ms/step, the flat grid, cap, pair mode and peak memory, and the
     device and wall time of 5 more steps under torch.profiler; on the f64
     state a flat rebuild and a whole step each run twice, bit for bit;
 36. ``collapse_dry.run(Config())`` at its defaults (f64 flat, dr 0.015) for
     3 frames of its default cadence (666 steps), a checkpoint every frame,
     its files written; X, H, the energy drift and the overflow of a flat
     rebuild of the final state; 10 more steps under torch.profiler;
 37. ``rayleigh_benard.run(Config())`` at its flat default (f32, N =
     53,621) for 3 frames of 100 steps; KE, Nu and the overflow; 10 more
     steps under torch.profiler;
 38. the mountain-wave schemes at their default configurations
     (``WitchConfig()``: n_rows 75, f32 flat, skin 0; Pavelka's
     ``PavelkaConfig()``), two frames each through ``run(out_path=...)``:
     the flagship, hopkins_perturbed, full_hopkins, hopkins_total (after its
     hydrostatic packing) and Pavelka (after its Colagrossi packing), each
     with the overflow of a flat rebuild of its final state;
 39. the reference's two cross-layout gates on the card, the hand kernels on
     f32 bucket (skin 0.2) against the flat f64 path (skin 0): the flagship
     at n_rows 14 over 200 steps (u_avg/u_max every 50 steps) and the dam
     break at dr 0.05 to t_end 0.5 in 10 frames (X/H/E), rtol 1e-3; then a
     CUDA bucket state with ``use_pallas=False`` and a float64 bucket state,
     each refused;
 40. ``collapse3d.run(Config())`` at its defaults (f64 flat, dr 5e-3) for 3
     frames of its cadence (125 steps each) with its files and the energy
     per frame; the reference's energy gate (dr 0.015, t_end 0.06: max
     |E/E0 - 1| < 0.02, every particle kept); one f32 flat frame;
 41. witch3d on the flat layout, f32 and f64: a probe at n_rows 12 measures
     the peak memory of a set-up and a step, the peak at a width is
     reckoned from it by the particle count, and the widest n_rows <= 40
     whose reckoned peak stays under 60 GB is run (set-up, 2 frames); then
     the reference's gates at its TINY in f64 (median rho/rho_bg within
     1e-3 of 1 after one step, u_max < 1 m/s after 12 steps);
 42. ``isph_witch.run(ISPHWitchConfig())`` at its defaults (f32 flat,
     "mg": the reference's RuntimeWarning, printed, and Jacobi), the
     baseline width (n_rows 110) on the flat layout in f32 and f64, kicked,
     with cg_it and cg_res; the reference's gates at n_rows 12 in f64
     (static u_max < 1e-6; a kick's rms divergence below 0.3x in 10 steps);
 43. ``collapse_dry_implicit.run``: the reference's gates (dr 0.05 to t_end
     0.4 in 8 frames: X never falls and ends past 1.8, H falls, E/E0 within
     [0.9, 1.01]; dr 0.06: P finite, |P| < 20 rho g H), then
     ``Config(t_end=0.1, n_frames=10)`` (180 steps) at its default dr 0.01
     (f64) with its files; phases 40-43 each print their seconds, ms/step,
     peak memory and the overflow of a flat rebuild of their final states,
     and launch no sweep;
 44. the terrain family on the flat layout: the five named configs at their
     defaults (f32 flat; ``terrain_baseline_config()`` at N = 212,819)
     through ``legacy_witch.run(cfg, out_path=...)`` for a fixed number of
     steps (the flow ones past their first inflow spawn event), with the
     file set, every value finite, the flat layout and the config's dtype,
     the active count (static) or the INFLOW count conserved with
     spawn_drops 0 (flow), no sweep launched, ms/step, peak memory, the flat
     grid, cap and pair mode and the device profile of 5 more steps; the
     baseline in float64 through a spawn event, then 50 steps run twice
     from its state, states and the binned wave observables bit for bit;
     the reference's physics gates of tests/test_legacy.py in float64 flat
     at their sizes and limits (drag discrimination, consistent-entropy T0,
     true Rayleigh sponge, spawn drops at zero headroom, AV dissipative and
     conserving to 1e-12, the outflow buffer);
 45. ``rayleigh_benard.Config(conduction="rkpm")`` at its flat defaults for
     2 frames of 100 steps with the device profile of 5 more, then the
     reference's two RKPM gates (tests/test_rayleigh_benard.py: the RKPM
     Laplacian exact at the walls to rtol 5e-3; the short supercritical
     run, 6,400 steps, stable with growing KE); phases 44 and 45 print their
     seconds, and the run its whole seconds before the card line;
 30. (run last) every kernel timed on prepared inputs (CUDA events, kernel
     over 50 runs, twin over 5) beside its bound, and the kernels' own
     time that torch.profiler records over 50 more runs (``device_ms``;
     null, "not measured", where three sessions record no kernel);
     the adiabatic density
     too; the ISPH matvec in its prepared form (one launch, no allocation),
     beside one CSR sparse product of the same operator (``library_ms``);
     the twenty-seven tiled rows (the flagship density and momentum, the
     adiabatic density, the Hopkins pressure root and momentum in both
     forms, the two Pavelka sweeps, the packing's gradient, the terrain
     continuity and the isothermal static continuity, the terrain force,
     the isothermal static force and the fused adiabatic sweep in both AV
     forms, the ISPH matvec in its prepared form, the ISPH
     divergence/viscous sweep and pressure gradient, collapse_dry's
     dam-break continuity and force, the Rayleigh–Bénard continuity +
     conduction, witch3d's density and momentum, collapse3d's dam-break
     continuity and force) in turns with the design they replaced
     and with each tile's bound its row's band (direct, tiled, row band, row
     band, tiled, direct; the 2-D ones with their other staging scheme after
     each tiled turn), each beside its bound, and each design's kernel time
     in torch.profiler over 50 more launches. A bound counts
     the bytes the state needs (the occupancy plane, the other input planes
     at the occupied slots, every output slot, the trip bound) and the
     operations (every candidate's distance, every pair's body).
Then the card line, one JSON line of per-kernel results and, last, the ok
line.

Exits non-zero, printing no ok line, on any failure or without a card.

Usage: python3 chip_smoke.py [--profile]
  --profile  also print torch.profiler tables of 10 flagship steps (after
             the timed frames), 10 full Hopkins steps (from the built state),
             10 hopkins_total steps and 10 Pavelka steps (each from its
             packed state), 10 witch3d steps (whose device time is printed
             in any case, as are Pavelka's and collapse3d's), 10 terrain
             steps (after its timed frames), 10 ISPH steps and 10
             Rayleigh–Bénard steps, with the device time and device kernels
             per step
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import os
import shutil
import subprocess
import sys
import tempfile
import time

N_ROWS = 246
EXPECT = {"n": 978_463, "lims": (1792, 144), "cap": 8}
STEPS_PER_FRAME = 100
RTOL, ATOL = 1e-5, 1e-6
# the exported kernels; a "_3d" name shares its wrapper (and so its launch
# counter) with the 2-D form
KERNELS = ("density_sweep", "momentum_sweep", "pressure_sweep",
           "hopkins_momentum_sweep", "pavelka_mass_sweep",
           "pavelka_momentum_entropy_sweep", "gamma_grad_sweep",
           "density_sweep_3d", "momentum_sweep_3d", "dambreak_mass_sweep",
           "dambreak_force_sweep", "dambreak_mass_sweep_3d",
           "dambreak_force_sweep_3d", "legacy_mass_sweep",
           "legacy_force_sweep", "iso_static_mass_sweep",
           "iso_static_force_sweep", "adia_entropy_force_sweep",
           "isph_div_visc_sweep", "isph_matvec_sweep", "isph_grad_sweep",
           "rb_mass_heat_sweep")
# the launch counters, one per wrapper (<kernel>_sweep -> <kernel>_pass): a
# "_3d" kernel shares its wrapper with the 2-D form, and the adiabatic
# density launches density_sweep through a wrapper (and counter) of its own
COUNTED = tuple(k for k in KERNELS if not k.endswith("_3d")) + (
    "adia_density_pass",)
SOURCE = "sph_mountain_waves_tpu_torch/csrc/pair_sweep.cu"
REPLACES = {k: f"sph_mountain_waves_tpu/ops/pallas_pairs.py:{line}"
            for k, line in zip(KERNELS, (715, 751, 722, 806, 1323, 1373, 0,
                                         715, 751, 884, 913, 884, 913, 946,
                                         973, 1023, 1055, 1126, 1197, 1221,
                                         1255, 1276))}
# not a Pallas kernel in the reference: the packing's XLA pair sum
REPLACES["gamma_grad_sweep"] = "sph_mountain_waves_tpu/utils/packing.py:160"
W3D_EXPECT = {"n": 3_247_157, "lims": (384, 56, 32), "cap": 8}
W3D_STEPS_PER_FRAME = 20
# One H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Arithmetic operations (each +, -, *, /, sqrt and max one; compares and
# selects not counted), read off csrc/pair_sweep.cu. Every candidate (an
# occupied q slot in one of the 9 or 27 stencil cells of an occupied p slot)
# costs the distance: 5 operations in 2-D, 8 in 3-D. Every pair inside the
# cutoff costs the body and the accumulation besides. The Hopkins momentum
# without the split does 7 fewer.
DIST_OPS = {2: 5, 3: 8}
BODY_OPS = {"density_sweep": 14, "momentum_sweep": 42,
            "pressure_sweep": 17, "hopkins_momentum_sweep": 76,
            "pavelka_mass_sweep": 28,
            "pavelka_momentum_entropy_sweep": 56,
            "gamma_grad_sweep": 15,
            "density_sweep_3d": 15, "momentum_sweep_3d": 48,
            "dambreak_mass_sweep": 17, "dambreak_force_sweep": 22,
            "dambreak_mass_sweep_3d": 20, "dambreak_force_sweep_3d": 27,
            "legacy_mass_sweep": 15, "legacy_force_sweep": 27,
            "iso_static_mass_sweep": 18, "iso_static_force_sweep": 34,
            "adia_entropy_force_sweep": 35, "isph_div_visc_sweep": 24,
            "isph_matvec_sweep": 12, "isph_grad_sweep": 16,
            "rb_mass_heat_sweep": 19}
HOPKINS_SPLIT_OPS = 7
# the FLUID-gated Monaghan term of the legacy force bodies (av_alpha > 0),
# 13 operations more; the terrain main path runs without it
LEGACY_AV_OPS = 13
# planes in (occupancy included) and out, each [cap, C+1] f32
PLANES = {"density_sweep": (5, 1), "momentum_sweep": (10, 2),
          "pressure_sweep": (5, 1), "hopkins_momentum_sweep": (13, 2),
          "pavelka_mass_sweep": (9, 1),
          "pavelka_momentum_entropy_sweep": (12, 3),
          "gamma_grad_sweep": (4, 2),
          "density_sweep_3d": (6, 1), "momentum_sweep_3d": (12, 3),
          "dambreak_mass_sweep": (6, 1), "dambreak_force_sweep": (7, 2),
          "dambreak_mass_sweep_3d": (8, 1), "dambreak_force_sweep_3d": (9, 3),
          "legacy_mass_sweep": (6, 1), "legacy_force_sweep": (8, 2),
          "iso_static_mass_sweep": (7, 1), "iso_static_force_sweep": (9, 2),
          "adia_entropy_force_sweep": (10, 3),
          "isph_div_visc_sweep": (5, 5), "isph_matvec_sweep": (4, 1),
          "isph_grad_sweep": (4, 2), "rb_mass_heat_sweep": (7, 2)}
# the terrain baseline (legacy_witch.terrain_baseline_config), built as run()
# builds it: capacity 1.3 N, stencil rescatter, slot-targeted spawns
TERRAIN_EXPECT = {"n": 212_819, "lims": (256, 72), "cap": 24}
TERRAIN_STEPS_PER_FRAME = 300
# the ISPH baseline (isph_witch.baseline_config(), the bench_all isph_witch
# cell) and the Rayleigh–Bénard baseline (the rayleigh_benard cell)
ISPH_EXPECT = {"n": 207_672, "lims": (896, 72), "cap": 8}
ISPH_WARM_STEPS, ISPH_TIMED_STEPS = 5, 20
RB_EXPECT = {"n": 53_621, "lims": (256, 80), "cap": 16}
RB_STEPS_PER_FRAME = 500


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps calls, by CUDA events (after one
    warm-up call)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_ms(fn, reps, tries=3):
    """The CUDA kernel's own time per call of fn() (one kernel a call), as
    torch.profiler (CUDA activity only) records it over reps calls: the
    card's busy time, without the host's launch path that paces an event
    time below ~0.1 ms. Taken over its own reps calls: the profiler's host
    cost would inflate an event time taken under it. Returns (the mean
    duration of the kernels it recorded, how many it recorded): late in a
    long run a session can lose kernel records, so the mean is taken over
    those it has, not divided by reps. A session that records none is
    tried again, up to ``tries`` sessions; if none records a kernel (the
    profiler cannot attach to the card's activity, e.g. while another
    tracer holds it) the reading is (None, 0): "not measured", which fails
    nothing, since the CUDA-event time is the row's time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof
    fn()
    for _ in range(tries):
        with tprof(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation]
        n = sum(e.count for e in kernels)
        if n:
            return sum(e.self_device_time_total for e in kernels) / n / 1e3, n
    return None, 0


def compare(name, got, ref, rtol=RTOL, atol=ATOL, gate=True):
    """Max abs error of got against ref and ref's max |value|; raises past
    the gate."""
    import torch
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if gate:
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=name)
    return err, scale


def ptxas_report(log):
    """'kernel: N regs, S B spill stores, L B spill loads[, M B static
    smem]' per instantiation, from nvcc's -Xptxas -v output (names demangled
    where a demangler is installed). Dynamic shared memory (the tiled 3-D
    sweep's stages) is the launch's, printed with its plan."""
    rows, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", ln)
            rows.append((name, f"{m.group(1)} regs, {spill}"
                         + (f", {smem.group(1)} B static smem" if smem else "")))
            name, spill = None, ""
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(n for n, _ in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        # void <unnamed>::pair_sweep<<unnamed>::Hopkins<(bool)1, (bool)0>,
        # (bool)0>(...) -> pair_sweep<Hopkins<1, 0>, 0>; DamMass<(int)3> ->
        # DamMass<3>
        tidy = [re.sub(r"<unnamed>::|\(anonymous namespace\)::|\((?:bool|int)\)|^void ",
                       "", d).split("(")[0] for d in names]
        rows = [(t or n, r) for t, (n, r) in zip(tidy, rows)]
    return rows


class Counters:
    """The sweep wrappers' launch counters."""

    def __init__(self, ps):
        self.wrappers = {k: getattr(ps, k.replace("_sweep", "_pass"))
                         for k in COUNTED}

    def reset(self):
        for w in self.wrappers.values():
            w.launches = 0

    def read(self):
        return {k: w.launches for k, w in self.wrappers.items()}


def all_finite(state):
    import torch
    return all(bool(torch.isfinite(t[state.active]).all())
               for t in state.fields.values())


def drive(phase, label, counters, run_frame, state, n_timed, expect, card, n,
          steps_per_frame=None):
    """The main path of one scheme: counters set to 0, 1 warm-up frame and
    ``n_timed`` timed frames of ``steps_per_frame`` steps (default
    STEPS_PER_FRAME), counters read. Raises unless each wrapper launched its
    kernel exactly ``expect[kernel]`` times (0 for the others) and every
    value is finite. Returns (state, ms/step, counts, u_avg, u_max)."""
    steps_per_frame = steps_per_frame or STEPS_PER_FRAME
    import torch
    from sph_mountain_waves_tpu_torch.models.witch_common import (
        velocity_diagnostics,
    )
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run_frame(state)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frame_s = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        state = run_frame(state)
        u_avg, u_max = (float(v) for v in velocity_diagnostics(state))
        frame_s.append(time.perf_counter() - t0)
    counts = counters.read()
    want = {k: expect.get(k, 0) for k in COUNTED}
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected {want}")
    if not all_finite(state):
        raise AssertionError(f"{label}: non-finite values")
    ms = 1e3 * sum(frame_s) / (n_timed * steps_per_frame)
    say(phase, f"{label}: warm-up frame {warm_s:.2f} s; {n_timed} x "
               f"{steps_per_frame} steps in {sum(frame_s):.3f} s = {ms:.3f} "
               f"ms/step = {n * n_timed * steps_per_frame / sum(frame_s):.4e} "
               f"particle-steps/s at N={n} ({card}); u_avg {u_avg:.4e} "
               f"u_max {u_max:.4e} m/s; active {int(state.n)}; launches "
               f"{ {k: v for k, v in counts.items() if v} }")
    return state, ms, counts, u_avg, u_max


def rescatters(run_frame, state, n_frames):
    """Drift-triggered rescatters in n_frames frames from state, counted on
    a rerun with the opt-in bookkeeping field (kept out of timed runs)."""
    import torch
    s = state.replace(_rescatter_count=torch.zeros(
        state.capacity, dtype=torch.float32, device=state.active.device))
    for _ in range(n_frames):
        s = run_frame(s)
    return int(s.fields["_rescatter_count"].sum())


def profile_steps(phase, label, step, state, n_steps=10, table=True):
    """torch.profiler table of n_steps steps (unless ``table`` is False),
    the device time per step (the CUDA kernels' self time, as the table's
    footer sums it), and the wall time per step of the same steps with the
    device's idle share in them (the profiler's own host cost included)."""
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
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation]
    device_us = sum(e.self_device_time_total for e in kernels)
    # kernels, not copies or fills (as phase 31 counts them)
    launched = sum(e.count for e in kernels
                   if not e.key.startswith(("Memcpy", "Memset")))
    if table:
        print(events.table(sort_by="self_cuda_time_total", row_limit=25))
    if not device_us:
        say(phase, f"{label} profile: device time not measured "
                   f"(torch.profiler recorded no kernel), wall {wall_ms:.3f} "
                   f"ms/step over {n_steps} steps under the profiler")
        return
    device_ms = device_us / n_steps / 1e3
    say(phase, f"{label} profile: device time {device_ms:.3f} ms/step, wall "
               f"{wall_ms:.3f} ms/step over the same {n_steps} steps under "
               f"the profiler: device idle {100 * (1 - device_ms / wall_ms):.1f}"
               f" % of them; {launched / n_steps:g} device kernels per step")


FORMS = {"split": True, "total": False, "av": True, "no_av": False,
         "adia": None}


def tiled_label(kernel):
    """(export name, form, ``tiled_yardsticks``' keyword arguments) of a
    tiled sweep's label: the Hopkins momentum's carries its form
    ("hopkins_momentum_sweep split" or "... total": ``background_split``,
    a keyword), the terrain forces' and the fused adiabatic sweep's its AV
    switch ("legacy_force_sweep av" or "... no_av": the config's, so no
    keyword; a plan's form only where the sweep has two, ``ps._FORM_KEY``:
    the fused adiabatic sweep stages the same planes in both), the adiabatic
    density
    ("density_sweep adia": the density's one plan, the keyword
    ``adiabatic``); the others are export names (form None). The ∇Γ
    sweep's ``V0`` comes from its state, not its label."""
    name, _, label = kernel.partition(" ")
    form = FORMS[label] if label else None
    kw = ({"background_split": form} if name == "hopkins_momentum_sweep" else
          {"adiabatic": True} if label == "adia" else {})
    return name, form, kw


def tile_plan_line(ps, e, state, kernels):
    """The tiled sweep's launch plan of each of ``kernels`` (tiled exports,
    labelled as ``tiled_label`` reads them)
    on engine ``e`` (2-D or 3-D), and its per-tile trip bound on ``state``
    against the row band: the tiles with a non-zero bound, each bound's mean
    over those tiles, the rank walks each asks for (9 or 27 cells times the
    bound, summed over the occupied p slots, and the bound summed over the
    warps that hold an occupied p slot: a warp walks its tile's ranks when
    any of its lanes does), and the warps of the working tiles (an occupied
    p slot and a non-zero bound) that hold no occupied p slot: they only
    stage."""
    import torch
    F = torch.nn.functional
    nx = e.lims[0]
    rows = e.num_cells // nx
    parts = []
    for k in kernels:
        name, form, _ = tiled_label(k)
        staged = ps._staged(name, form if name in ps._FORM_KEY else None)
        p = ps._tile_plan(e, staged)
        part = (f"{k} TX {p.tx}, block {p.block} = {p.tx * e.cap} threads, "
                f"{-(-nx // p.tx) * rows} blocks, {p.smem_bytes} B dynamic "
                f"smem ({p.stages} stages)")
        if e.dim == 2:
            o = ps._tile_plan(e, staged, every_rank=not ps._EVERY_RANK)
            part += f"; the other scheme {o.smem_bytes} B ({o.stages} stages)"
        parts.append(part)
    tx = ps._tile_tx(e)
    ntiles = -(-nx // tx)
    tile = ps._trip_bound(tiled_label(kernels[0])[0], e, state).to(
        torch.int64)
    band = ps.row_kmax(e, state)[0].to(torch.int64).repeat_interleave(ntiles)
    slots = F.pad(e.grid_view(state.active).to(torch.int64),
                  (0, -nx % tx)).reshape(e.cap, rows * ntiles, tx)
    p_slots = slots.sum(dim=(0, 2))                         # per tile
    per_warp = F.pad(slots.permute(1, 0, 2).reshape(rows * ntiles, -1),
                     (0, -(e.cap * tx) % 32)).reshape(rows * ntiles, -1, 32)
    busy = per_warp.any(dim=-1)                             # [tiles, warps]
    work = tile > 0
    working = work & (p_slots > 0)
    cells = len(e.stencil)
    parts.append(
        f"per-tile bound non-zero in {int(work.sum())} of {tile.numel()} "
        f"tiles ({int((p_slots > 0).sum())} hold an occupied p slot), mean "
        f"{float(tile[work].double().mean()):.2f} over them against the row "
        f"band's {float(band[work].double().mean()):.2f}; "
        f"rank walks {cells * int((p_slots * tile).sum()):.4e} against "
        f"{cells * int((p_slots * band).sum()):.4e} (warp rank walks "
        f"{int((busy.sum(dim=1) * tile).sum())} against "
        f"{int((busy.sum(dim=1) * band).sum())}); {busy.shape[1]} warps a "
        f"block, {int((~busy[working]).sum())} of the "
        f"{busy.shape[1] * int(working.sum())} in the {int(working.sum())} "
        f"working blocks hold no occupied p slot")
    return f"tile plan at cap {e.cap}: " + "; ".join(parts)


def build_full(module, cfg, dev):
    """make_system + freeze at full width; checks the flagship's shapes."""
    import torch
    t0 = time.perf_counter()
    system = module.make_system(cfg)
    state = system.freeze(device=dev)
    torch.cuda.synchronize()
    eng = system.engine
    got = {"n": system.n_built, "lims": eng.lims, "cap": eng.cap}
    if got != EXPECT or int(state.n) != system.n_built:
        raise AssertionError(f"{module.__name__}: shapes {got}, active "
                             f"{int(state.n)}; expected {EXPECT}")
    return system, state, time.perf_counter() - t0


def small_steps(module, cfg, dev, n_steps=8):
    """u_avg/u_max and active count after n_steps at n_rows=10: kernels on
    the card against the plain twins on the CPU (fast_math off)."""
    import torch
    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.models.witch_common import (
        velocity_diagnostics,
    )
    small = dataclasses.replace(cfg, n_rows=10, fast_math=False)
    diag = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        sysm = module.make_system(small)
        s = sysm.freeze(device=where)
        s = frame_runner(module.make_step(small, sysm.engine), n_steps)(s)
        diag[label] = ([float(v) for v in velocity_diagnostics(s)], int(s.n))
    (gk, nk), (gc, nc) = diag["card"], diag["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gk, gc))
    if nk != nc or rel > 1e-5:
        raise AssertionError(f"{module.__name__}: small-input steps disagree: "
                             f"card {gk} n={nk}, cpu {gc} n={nc}")
    return gk, gc, rel, nk


def perturbed(state, dev):
    """v + U(−1, 1) m/s and h·(1 + U(−1 %, 1 %)) on active rows, seeded."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    act = state.active
    dv = torch.rand(state.fields["v"].shape, generator=gen, device=dev) * 2 - 1
    dh = torch.rand(state.fields["h"].shape, generator=gen, device=dev) * 0.02 - 0.01
    return state.replace(
        v=torch.where(act[:, None], state.fields["v"] + dv, 0.0),
        h=torch.where(act, state.fields["h"] * (1 + dh), 0.0))


def frame_equals_state(points, data, state, variables):
    """True when a frame read back by ``read_vtp`` holds exactly the state's
    active rows (VTP stores float64 copies, vectors padded to 3)."""
    import numpy as np
    act = state.active.cpu().numpy()

    def rows(name):
        return state.fields[name].cpu().numpy()[act].astype(np.float64)

    x = rows("x")
    ok = np.array_equal(points[:, :x.shape[1]], x)
    for name in variables:
        want = rows(name)
        got = data[name] if want.ndim == 1 else data[name][:, :want.shape[1]]
        ok = ok and np.array_equal(got, want)
    return ok


def kernel_vs_twin(label, kern, rerun, twin, fast, scaled=False):
    """Kernel outputs against the twin's: the gate with exact divides (with
    ``scaled``, atol times each output's largest |value|: sums that cancel),
    1e-3 of max |out| with fast_math; reruns bitwise. Returns (err, scale)."""
    import torch
    if not all(torch.equal(a, b) for a, b in zip(kern, rerun)):
        raise AssertionError(f"{label}: kernel reruns differ")
    e = [compare(f"{label}[{a}]", k, t, gate=not fast,
                 atol=ATOL * (t.abs().max().item() if scaled else 1.0))
         for a, (k, t) in enumerate(zip(kern, twin))]
    err, scale = max(x[0] for x in e), max(x[1] for x in e)
    if fast and not err <= 1e-3 * scale:
        raise AssertionError(f"{label}: fast_math error {err} vs scale {scale}")
    return err, scale


def exact(label, kern, rerun, twin):
    """``kernel_vs_twin`` with exact divides, and max abs err 0 besides: the
    ISPH and Rayleigh–Bénard kernels equal their twins bit for bit."""
    err, scale = kernel_vs_twin(label, kern, rerun, twin, fast=False,
                                scaled=True)
    if err != 0.0:
        raise AssertionError(f"{label}: max abs err {err} against the twin, "
                             "expected 0")
    return err, scale


def designs_equal(label, kernel, e, s_, c, got, **kw):
    """The wrapper's outputs bit for bit against every other design of a
    tiled sweep (``tiled_yardsticks``; ``kw``: the Hopkins momentum's
    ``background_split``, the density's ``adiabatic``, the ∇Γ sweep's
    ``V0``); returns their names."""
    import torch

    from sph_mountain_waves_tpu_torch.ops import pair_sweeps as ps
    others = {name: run() for name, run in
              ps.tiled_yardsticks(kernel, e, s_, c, **kw).items()}
    bad = [name for name, out in others.items()
           if not all(torch.equal(a, b) for a, b in zip(got, out))]
    if bad:
        raise AssertionError(f"{label}: the wrapper's output differs from "
                             f"{bad}")
    return ", ".join(others)


def figures_written() -> bool:
    """The runs write their figures only where matplotlib imports (a
    missing matplotlib is a warning, not a failure)."""
    import importlib.util
    return importlib.util.find_spec("matplotlib") is not None


def check_run_files(label, files, data_files, figures):
    """The file set of a run: its data files, and its figures where
    matplotlib is installed."""
    want = sorted(data_files + (figures if figures_written() else []))
    if files != want:
        raise AssertionError(f"{label} run(out_path) wrote {files}, "
                             f"expected {want}")


def same_outputs(dir_a, dir_b, files):
    """True when every frame, result.pvd and data.csv are equal byte for
    byte (the checkpoint and the figures are compared apart or not at all:
    a figure carries its creation date)."""
    return all(open(os.path.join(dir_a, f), "rb").read()
               == open(os.path.join(dir_b, f), "rb").read()
               for f in files if not f.endswith((".npz", ".pdf")))


def kick(state, dev):
    """v = 0.1·N(0, 1) on FLUID rows from NumPy's default_rng(3), as the
    reference's ISPH gate kicks its state: every step then solves a real
    pressure system."""
    import numpy as np
    import torch
    f = state.fields
    rng = np.random.default_rng(3)
    v = torch.as_tensor(0.1 * rng.standard_normal(tuple(f["v"].shape)),
                        dtype=f["v"].dtype, device=dev)
    return state.replace(v=torch.where((f["type"] == 0.0)[:, None], v,
                                       f["v"]))


def isph_phase(dev, card, counters, errs, profile):
    """Phase 31: the ISPH baseline. Returns (config, engine, final state,
    launch counts of the main path, cg_it per step)."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof

    from sph_mountain_waves_tpu_torch.kernels import rDspline23
    from sph_mountain_waves_tpu_torch.models import isph_witch as iw
    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.models.witch_common import (
        velocity_diagnostics,
    )
    from sph_mountain_waves_tpu_torch.ops import mg
    from sph_mountain_waves_tpu_torch.ops import pair_sweeps as ps

    cfg = iw.baseline_config()
    t0 = time.perf_counter()
    system = iw.make_system(cfg)
    state0 = kick(system.freeze(device=dev), dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    e = system.engine
    n = system.n_built
    got = {"n": n, "lims": e.lims, "cap": e.cap}
    if got != ISPH_EXPECT or int(state0.n) != n:
        raise AssertionError(f"isph: shapes {got}, active {int(state0.n)}; "
                             f"expected {ISPH_EXPECT}")
    step = iw.make_step(cfg, e)

    # one step in: the live state, whose P is the first solve's solution
    st = step(state0)
    f = st.fields
    h, vol = cfg.h0, cfg.dr ** 2
    diag = torch.where(st.active, h**2 * f["L"] + torch.where(
        f["type"] == 0.0, cfg.C_free * torch.clamp(f["lam"], min=0.0), 0.0),
        0.0)

    def offdiag_w(r):
        return 2.0 * h**2 * vol * rDspline23(h, r)

    W = mg.coarse_stencil_2d(e, st, offdiag_w, diag)
    stencil_ms = cuda_ms(lambda: mg.coarse_stencil_2d(e, st, offdiag_w, diag),
                         3)
    vc = mg.GridVcycle(W)
    rc = torch.ones(e.grid_shape, dtype=torch.float32, device=dev)
    vcycle_ms = cuda_ms(lambda: vc.apply(rc), 10)
    levels = " -> ".join(f"{a}x{b}" for a, b, _ in (t.shape for t in vc.Wts))
    say(31, f"ISPH baseline built in {build_s:.2f} s (host): N={n} "
            f"lims={e.lims} cap={e.cap} slots={e.slots} h0={cfg.h0:.2f} m "
            f"dt={cfg.dt_isph:.4f} s; V-cycle {vc.n_levels} levels ({levels}); "
            f"coarse stencil {stencil_ms:.3f} ms, one V-cycle {vcycle_ms:.3f} "
            f"ms ({card})")

    # the divergence/viscous sweep, the gradient and the matvec run the
    # tiled design: held bit for bit against every other design
    say(31, tile_plan_line(ps, e, st, ("isph_matvec_sweep",
                                       "isph_div_visc_sweep",
                                       "isph_grad_sweep")))
    got = ps.isph_div_visc_pass(e, st, cfg)
    div_designs = designs_equal("isph div/visc", "isph_div_visc_sweep", e, st,
                                cfg, got)
    errs["isph_div_visc_sweep"] = exact(
        "isph div/visc", got, ps.isph_div_visc_pass(e, st, cfg),
        ps.isph_div_visc_pass_plain(e, st, cfg))
    got = ps.isph_grad_pass(e, st, cfg)
    grad_designs = designs_equal("isph grad", "isph_grad_sweep", e, st, cfg,
                                 got)
    errs["isph_grad_sweep"] = exact(
        "isph grad", got, ps.isph_grad_pass(e, st, cfg),
        ps.isph_grad_pass_plain(e, st, cfg))
    del got
    # the matvec is prepared once per solve: each other design prepared once
    # as well
    mv = ps.isph_matvec_prepared(e, st, cfg)
    got = mv(f["P"]).clone()
    errs["isph_matvec_sweep"] = exact(
        "isph matvec", [got], [mv(f["P"]).clone()],
        [ps.isph_matvec_pass_plain(e, st, cfg, f["P"])])
    designs = ps.tiled_yardsticks("isph_matvec_sweep", e, st, cfg)
    bad = [name for name, run in designs.items()
           if not torch.equal(run(f["P"])[0], got)]
    if bad:
        raise AssertionError(f"isph matvec: the prepared tiled kernel differs "
                             f"from {bad}")
    held = {"isph_matvec_sweep": " (tiled, prepared), bit for bit equal to "
                                 + ", ".join(designs) + ";",
            "isph_div_visc_sweep": " (tiled), bit for bit equal to "
                                   + div_designs + ";",
            "isph_grad_sweep": " (tiled), bit for bit equal to "
                               + grad_designs + ";"}
    for k, label in (("isph_div_visc_sweep", "div/visc (5 sums)"),
                     ("isph_grad_sweep", "pressure gradient"),
                     ("isph_matvec_sweep", "CG matvec on the first solve's P")):
        say(31, f"ISPH {label} kernel{held.get(k, '')} vs twin at full width: "
                f"max abs err {errs[k][0]:.1e} (max |out| {errs[k][1]:.4e}), "
                f"rerun bitwise equal")
    del st, W, mv, designs

    # 2 small kicked steps: kernels on the card against the CPU twins (the
    # f32 CG's iterates depend on the reductions' order: the reference's
    # Pallas-vs-XLA gate, rtol 2e-3)
    small = dataclasses.replace(cfg, n_rows=10, lattice_cells=False, skin=0.2)
    out = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        sysm = iw.make_system(small)
        s = kick(sysm.freeze(device=where), where)
        s = frame_runner(iw.make_step(small, sysm.engine), 2)(s)
        out[label] = ([float(v) for v in velocity_diagnostics(s)], int(s.n),
                      int(s.fields["cg_it"][0]))
    (gk, nk, ik), (gc, nc, ic) = out["card"], out["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gk, gc))
    if nk != nc or rel > 2e-3:
        raise AssertionError(f"isph small steps disagree: card {out['card']}, "
                             f"cpu {out['cpu']}")
    say(31, f"n_rows=10 kicked, 2 steps: card u_avg/u_max {gk} (cg_it {ik}) vs "
            f"cpu twins {gc} (cg_it {ic}), rel {rel:.2e}, active {nk} == {nc}")

    # the main path, every launch counted from 0
    mvc = ps.isph_matvec_pass
    counters.reset()
    its = []
    st = state0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ISPH_WARM_STEPS):
        before = mvc.launches
        st = step(st)
        its.append(int(st.fields["cg_it"][0]))
        if mvc.launches - before != its[-1] + 1:
            raise AssertionError(f"isph: {mvc.launches - before} matvec "
                                 f"launches for cg_it {its[-1]}")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(ISPH_TIMED_STEPS):
        before = mvc.launches
        st = step(st)
        its.append(mvc.launches - before - 1)
    u_avg, u_max = (float(v) for v in velocity_diagnostics(st))
    timed_s = time.perf_counter() - t0
    counts = counters.read()
    steps = ISPH_WARM_STEPS + ISPH_TIMED_STEPS
    want = {k: 0 for k in COUNTED}
    want.update(isph_div_visc_sweep=steps, isph_grad_sweep=steps,
                isph_matvec_sweep=sum(i + 1 for i in its))
    if counts != want:
        raise AssertionError(f"isph main path: launch counts {counts}, "
                             f"expected {want}")
    cg_res = float(st.fields["cg_res"][0])
    if (int(st.fields["cg_it"][0]) != its[-1] or not all_finite(st)
            or int(st.n) != n or not u_max < cfg.v_char):
        raise AssertionError(f"isph main path: cg_it {its}, finite "
                             f"{all_finite(st)}, active {int(st.n)}/{n}, "
                             f"u_max {u_max}")
    ms = 1e3 * timed_s / ISPH_TIMED_STEPS
    say(31, f"ISPH main path: warm-up {ISPH_WARM_STEPS} steps {warm_s:.2f} s; "
            f"{ISPH_TIMED_STEPS} steps in {timed_s:.3f} s = {ms:.3f} ms/step "
            f"= {n * ISPH_TIMED_STEPS / timed_s:.4e} particle-steps/s at N={n} "
            f"({card}); cg_it per step {its} ({sum(its[ISPH_WARM_STEPS:]) / ISPH_TIMED_STEPS:.1f} "
            f"a timed step); matvec launches {counts['isph_matvec_sweep']} = "
            f"sum(cg_it + 1); last cg_res {cg_res:.3e}; u_avg {u_avg:.4e} "
            f"u_max {u_max:.4e} m/s; active {int(st.n)}; launches "
            f"{ {k: v for k, v in counts.items() if v} }")

    # kernel launches per CG iteration (profiler) and host syncs per step
    # (sync debug mode), each over 2 steps from the main path's state
    before = mvc.launches
    with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        s2 = step(step(st))
        torch.cuda.synchronize()
    prof_its = mvc.launches - before - 2
    kernels = sum(ev.count for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA
                  and not ev.key.startswith(("Memcpy", "Memset")))
    before = mvc.launches
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            s2 = step(step(st))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync_its = mvc.launches - before - 2
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    del s2
    per_it = (f"{kernels / max(prof_its, 1):.1f}" if kernels else
              "not measured (torch.profiler recorded no kernel)")
    say(31, f"ISPH launches: {kernels} device kernels in 2 steps with "
            f"{prof_its} CG iterations = {per_it} per "
            f"CG iteration; host syncs {syncs} in 2 steps with {sync_its} CG "
            f"iterations = {syncs / 2:.1f} per step")
    if profile:
        profile_steps(31, "isph", step, st)
    return cfg, e, st, counts, its


def rb_phase(dev, card, counters, errs, profile):
    """Phase 32: the Rayleigh–Bénard baseline. Returns (config, engine,
    final state, launch counts of the main path)."""
    import torch

    from sph_mountain_waves_tpu_torch.models import rayleigh_benard as rb
    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.ops import pair_sweeps as ps

    def live(rcfg):
        """(system, frozen state, one step in with v ± 0.01 seeded)."""
        t0 = time.perf_counter()
        system = rb.make_system(rcfg)
        state0 = system.freeze(device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        st = rb.make_step(rcfg, system.engine)(state0)
        gen = torch.Generator(device=dev).manual_seed(0)
        dv = (torch.rand(st.fields["v"].shape, generator=gen, device=dev)
              - 0.5) * 0.02
        st = st.replace(v=torch.where(st.active[:, None], st.fields["v"] + dv,
                                      0.0))
        return system, state0, st, build_s

    cfg = rb.baseline_config()
    system, state0, _, build_s = None, None, None, 0.0
    for sidewalls in ("conducting", "adiabatic"):
        rcfg = dataclasses.replace(cfg, sidewalls=sidewalls)
        rsys, rstate0, st, b_s = live(rcfg)
        e = rsys.engine
        if sidewalls == "conducting":
            system, state0, build_s = rsys, rstate0, b_s
            got = {"n": rsys.n_built, "lims": e.lims, "cap": e.cap}
            if got != RB_EXPECT or int(rstate0.n) != rsys.n_built:
                raise AssertionError(f"rayleigh_benard: shapes {got}, active "
                                     f"{int(rstate0.n)}; expected {RB_EXPECT}")
        key = "rb_mass_heat_sweep" + ("" if sidewalls == "conducting"
                                      else " adiabatic")
        if sidewalls == "conducting":
            say(32, tile_plan_line(ps, e, st, ("rb_mass_heat_sweep",
                                               "dambreak_force_sweep")))
        got = ps.rb_mass_heat_pass(e, st, rcfg)
        designs = designs_equal(f"rb {sidewalls}", "rb_mass_heat_sweep", e,
                                st, rcfg, got)
        errs[key] = exact(f"rb {sidewalls}", got,
                          ps.rb_mass_heat_pass(e, st, rcfg),
                          ps.rb_mass_heat_pass_plain(e, st, rcfg))
        n_adia = int((st.fields["type"] == rb.WALL_ADIA).sum())
        say(32, f"Rayleigh–Bénard baseline ({sidewalls} sidewalls, "
                f"{n_adia} zero-flux wall rows) built in {b_s:.2f} s: "
                f"N={rsys.n_built} lims={e.lims} cap={e.cap} slots={e.slots} "
                f"dt={rcfg.dt:.4e}; continuity + conduction kernel (tiled) bit "
                f"for bit equal to {designs}; vs twin: max abs err "
                f"{errs[key][0]:.1e} (max |out| {errs[key][1]:.4e}), rerun "
                f"bitwise equal")
        # its force: the dam-break force's tiled export on the RB state
        got = ps.dambreak_force_pass(e, st, rcfg)
        designs = designs_equal(f"rb {sidewalls} force",
                                "dambreak_force_sweep", e, st, rcfg, got)
        err, scale = exact(f"rb {sidewalls} force", got,
                           ps.dambreak_force_pass(e, st, rcfg),
                           ps.dambreak_force_pass_plain(e, st, rcfg))
        say(32, f"Rayleigh–Bénard ({sidewalls} sidewalls) force kernel "
                f"(tiled) bit for bit equal to {designs}; vs twin: max abs "
                f"err {err:.1e} (max |out| {scale:.4e}), rerun bitwise equal")
        del got
        del st
    e = system.engine
    n = system.n_built

    # 6 small steps, card against CPU twins
    small = dataclasses.replace(cfg, n_rows=16, skin=0.2)
    out = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        sysm = rb.make_system(small)
        s = sysm.freeze(device=where)
        s = frame_runner(rb.make_step(small, sysm.engine), 6)(s)
        speed = s.fields["v"][s.active].abs()
        out[label] = ([float(speed.mean()), float(speed.max())], int(s.n))
    (gk, nk), (gc, nc) = out["card"], out["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(gk, gc))
    if nk != nc or rel > 1e-5:
        raise AssertionError(f"rb small steps disagree: card {out['card']}, "
                             f"cpu {out['cpu']}")
    say(32, f"n_rows=16, 6 steps: card mean/max |v| {gk} vs cpu twins {gc} "
            f"(rel {rel:.2e}), active {nk} == {nc}")

    step = rb.make_step(cfg, e)
    frame = frame_runner(step, RB_STEPS_PER_FRAME)
    steps = 3 * RB_STEPS_PER_FRAME
    st, ms, counts, _, u_max = drive(
        32, "rayleigh_benard main path", counters, frame, state0, 2,
        {"rb_mass_heat_sweep": steps, "dambreak_force_sweep": steps}, card, n,
        steps_per_frame=RB_STEPS_PER_FRAME)
    ke, nu = (float(v) for v in rb.diagnostics(cfg, st))
    if int(st.n) != n or not u_max < cfg.c:
        raise AssertionError(f"rayleigh_benard: active {int(st.n)}/{n}, u_max "
                             f"{u_max}")
    say(32, f"rayleigh_benard after {steps} steps (t = {steps * cfg.dt:.4f}): "
            f"KE {ke:.6e} J, Nu {nu:.6f}; rescatters in the {steps} steps: "
            f"{rescatters(frame, state0, 3)} ({card})")
    if profile:
        profile_steps(32, "rayleigh_benard", step, st)
    return cfg, e, st, counts


def full_runs_phase(dev):
    """Phase 33: ``run(cfg, out_path=...)`` of the ISPH and Rayleigh–Bénard
    baselines at full width, a checkpoint every frame, and a run stopped
    after its first frame and resumed, against the uninterrupted one."""
    import torch

    from sph_mountain_waves_tpu_torch import io as port_io
    from sph_mountain_waves_tpu_torch.models import isph_witch as iw
    from sph_mountain_waves_tpu_torch.models import rayleigh_benard as rb

    icfg = iw.baseline_config(n_frames=2, checkpoint_every=1)
    rcfg = rb.baseline_config(n_frames=2, checkpoint_every=1)
    for label, module, cfg, dt, data, figures, columns in (
            ("isph_witch", iw, icfg, icfg.dt_isph,
             ["checkpoint.npz", "data.csv", "frame0.vtp", "frame1.vtp",
              "frame2.vtp", "result.pvd"], ["velocities.pdf"],
             ["t", "u_avg", "u_max", "cg_it", "cg_res"]),
            ("rayleigh_benard", rb, rcfg, rcfg.dt,
             ["checkpoint.npz", "data.csv", "frame0.vtp", "frame1.vtp",
              "result.pvd"], ["kinetic_energy.pdf", "nusselt.pdf"],
             ["t", "KE", "Nu"])):
        cfg = dataclasses.replace(cfg, t_end=4 * dt)
        with tempfile.TemporaryDirectory() as tmp:
            whole_dir = os.path.join(tmp, "whole")
            part_dir = os.path.join(tmp, "part")
            t0 = time.perf_counter()
            whole = module.run(cfg, out_path=whole_dir, device=dev)
            run_s = time.perf_counter() - t0
            files = sorted(os.listdir(whole_dir))
            check_run_files(label, files, data, figures)
            csv = port_io.read_csv(os.path.join(whole_dir, "data.csv"))
            final = whole["state"]
            n = whole["system"].n_built
            if (list(csv) != columns or len(csv["t"]) != 2
                    or not all_finite(final) or int(final.n) != n):
                raise AssertionError(f"{label} run: columns {list(csv)}, "
                                     f"finite {all_finite(final)}, active "
                                     f"{int(final.n)}/{n}")
            module.run(dataclasses.replace(cfg, t_end=2 * dt, n_frames=1),
                       out_path=part_dir, device=dev)
            resumed = module.run(dataclasses.replace(
                cfg, resume=os.path.join(part_dir, "checkpoint.npz")),
                out_path=part_dir, device=dev)
            differing = [k for k, v in final.fields.items()
                         if not torch.equal(resumed["state"].fields[k], v)]
            same = same_outputs(part_dir, whole_dir, files)
            if (differing or not same
                    or not torch.equal(resumed["state"].active, final.active)):
                raise AssertionError(f"{label} resumed run differs: fields "
                                     f"{differing}, files equal {same}")
            tail = {k: float(v[-1]) for k, v in csv.items() if k != "t"}
            say(33, f"{label} run(out_path) on the card at N={n}, 4 steps in "
                    f"{run_s:.2f} s (build included): wrote {files}; last row "
                    f"{tail}; resumed run equals the uninterrupted one bit for "
                    f"bit (state, frames and data.csv)")


def matvec_library(e, s, cfg):
    """The ISPH matvec's operator, A_pq = rD(h0, r_pq) over the pairs within
    the cutoff with q ≠ p, assembled once as a CSR matrix (the twin's pair
    walk; not timed), then ``A @ P`` held against the kernel at rtol 1e-5
    and timed: the one PyTorch call that computes the kernel's function.
    Returns (ms, max abs err, nonzeros)."""
    import torch
    import torch.nn.functional as F

    from sph_mountain_waves_tpu_torch.ops import pair_sweeps as ps

    cap, C, grid = e.cap, e.num_cells, e.grid_shape
    dev = s.active.device
    hinv, kw = ps._isph_consts(cfg)
    occ = e.grid_view(s.active)
    x0, x1 = (e.grid_view(s.fields["x"][:, a].contiguous()) for a in range(2))
    sid = torch.arange(e.slots, device=dev).reshape(cap, C + 1)[:, :C]
    sid = sid.reshape((cap,) + grid)
    O, X0, X1 = (F.pad(a, (1, 1, 1, 1)) for a in (occ.float(), x0, x1))
    S = F.pad(sid, (1, 1, 1, 1), value=-1)
    hh = torch.tensor(e.h * e.h, dtype=torch.float32, device=dev)
    ranks = torch.arange(cap, device=dev).reshape(cap, 1, 1)
    rows, cols, vals = [], [], []
    for kq in range(cap):
        for off in e.stencil:
            win = (kq,) + tuple(slice(1 + o, 1 + o + n)
                                for o, n in zip(reversed(off), grid))
            d0, d1 = x0 - X0[win], x1 - X1[win]
            r2 = d0 * d0 + d1 * d1
            m = occ & (O[win] > 0.5) & (r2 <= hh)
            if not any(off):
                m = m & (ranks != kq)
            rows.append(sid[m])
            cols.append(S[win].expand_as(sid)[m])
            vals.append(ps._rd_spline23(hinv, kw, torch.sqrt(r2))[m])
    A = torch.sparse_coo_tensor(
        torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals),
        (e.slots, e.slots)).coalesce().to_sparse_csr()
    P = s.fields["P"].contiguous()
    kern = ps.isph_matvec_pass(e, s, cfg, P)
    lib = A @ P
    scale = kern.abs().max().item()
    torch.testing.assert_close(lib, kern, rtol=1e-5, atol=1e-6 * scale,
                               msg="CSR matvec against the kernel")
    return cuda_ms(lambda: A @ P, 50), (lib - kern).abs().max().item(), \
        A.values().numel()


# the reference's slow dam-break gate (tests/test_collapse_dry.py
# test_collapse_dry_vs_violeau): the wavefront X(t) of collapse_dry at dr 0.02
# to t_end 1.2 s against the digitised Violeau curve, max and mean relative
# error
VIOLEAU_CSV = os.path.join("tests", "reference_data", "dambreak_X_Violeau.csv")
VIOLEAU_MAX, VIOLEAU_MEAN = 0.016, 0.005


def violeau_errors(dev, **layout):
    """(max, mean relative error of X against the Violeau curve at its
    digitised times, seconds, steps) of ``collapse_dry.run`` at dr 0.02 to
    t_end 1.2 s on the card, the reference's slow gate, in ``layout`` (the
    config's fields: dtype, layout, skin, use_pallas; default the config's
    own, float64 flat)."""
    import numpy as np

    from sph_mountain_waves_tpu_torch.models import collapse_dry as cd
    vcfg = cd.Config(dr=0.02, t_end=1.2, n_frames=40, **layout)
    t0 = time.perf_counter()
    out = cd.run(vcfg, device=dev)
    secs = time.perf_counter() - t0
    ref = np.genfromtxt(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), VIOLEAU_CSV), delimiter=",", names=True)
    sel = ref["time"] <= out["t"][-1]
    ours = np.interp(ref["time"][sel], out["t"], out["X"])
    err = np.abs(ours - ref["X"][sel]) / ref["X"][sel]
    return (float(err.max()), float(err.mean()), secs,
            int(round(vcfg.t_end / vcfg.dt)))


def violeau_phase(dev, card) -> None:
    """Phase 34: the Violeau gate on the f32 bucket path (skin 0.15, the
    kernels) and on the reference's own configuration (f64 flat, skin 0),
    the errors beside the limits; raises if either misses."""
    for label, layout in (
            ("f32 bucket", dict(dtype="float32", layout="bucket", skin=0.15,
                                use_pallas=True)),
            ("f64 flat", {})):
        mx, mean, secs, steps = violeau_errors(dev, **layout)
        say(34, f"collapse_dry vs Violeau (dr 0.02, {steps} steps, {label}): "
                f"max rel err {mx:.6f} (limit {VIOLEAU_MAX}), mean {mean:.6f} "
                f"(limit {VIOLEAU_MEAN}); {secs:.1f} s ({card})")
        if not (mx < VIOLEAU_MAX and mean < VIOLEAU_MEAN):
            raise AssertionError(f"collapse_dry ({label}) misses the Violeau "
                                 "gate")


def flat_frames(phase, label, module, cfg, dev, card, counters,
                steps_per_frame, n_timed=2):
    """One scheme's flat path through make_system -> freeze -> make_step ->
    frame_runner: 1 warm-up frame and ``n_timed`` timed frames of
    ``steps_per_frame`` steps, with the sweep counters set to 0 before and
    read after (the flat path launches no sweep kernel). Raises unless every
    value is finite, every particle is kept and a rebuild of the final state
    drops no row (overflow 0). Prints ms/step, the flat grid, cap, pair mode
    and the peak device memory. Returns the final state."""
    import torch

    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.models.witch_common import (
        velocity_diagnostics,
    )
    t0 = time.perf_counter()
    system = module.make_system(cfg)
    state = system.freeze(device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    eng, n = system.engine, system.n_built
    if eng.layout != "flat" or state.fields["x"].dtype != cfg.torch_dtype:
        raise AssertionError(f"{label}: layout {eng.layout}, dtype "
                             f"{state.fields['x'].dtype}")
    run_frame = frame_runner(module.make_step(cfg, eng), steps_per_frame)
    counters.reset()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    state = run_frame(state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        state = run_frame(state)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (n_timed * steps_per_frame)
    peak = torch.cuda.max_memory_allocated() / 2**30
    own = peak - before / 2**30
    launched = {k: v for k, v in counters.read().items() if v}
    _, nbrs = eng.rebuild(state)
    overflow = int(nbrs.overflow)
    u_avg, u_max = (float(v) for v in velocity_diagnostics(state))
    if launched or not all_finite(state) or int(state.n) != n or overflow:
        raise AssertionError(f"{label}: sweep launches {launched}, finite "
                             f"{all_finite(state)}, active {int(state.n)}/{n},"
                             f" overflow {overflow}")
    say(phase, f"{label}: N={n} flat grid {eng.lims} cap {eng.cap} pair mode "
               f"{eng.pair_mode}; built in {build_s:.2f} s; {n_timed} x "
               f"{steps_per_frame} steps after a warm-up frame: {ms:.3f} "
               f"ms/step; peak memory {peak:.2f} GiB ({own:.2f} GiB above "
               f"what was allocated before the frames); active {int(state.n)}, "
               f"overflow 0, u_avg {u_avg:.4e} u_max {u_max:.4e} m/s; no sweep "
               f"launched ({card})")
    return system, state


def flat_rebuild_twice(phase, eng, state) -> None:
    """A flat rebuild and a whole flat step, each run twice on the same card
    state, must give the same result bit for bit."""
    import torch
    a_state, a_n = eng.rebuild(state)
    b_state, b_n = eng.rebuild(state)
    diff = [k for k in a_state.fields
            if not torch.equal(a_state.fields[k], b_state.fields[k])]
    diff += [k for k in ("cell", "key", "rank", "counts", "starts", "bucket",
                         "overflow")
             if not torch.equal(getattr(a_n, k), getattr(b_n, k))]
    if diff or not torch.equal(a_state.active, b_state.active):
        raise AssertionError(f"flat rebuild reruns differ: {diff}")
    say(phase, "flat rebuild run twice on the same card state: equal bit for "
               "bit (rows, active, cell, key, rank, counts, starts, bucket, "
               "overflow)")


def flat_overflow(system, state) -> int:
    """The overflow (largest cell count past cap) of a flat rebuild of
    ``state``: rows the bucket table drops. Non-zero is a finding."""
    _, nbrs = system.engine.rebuild(state)
    return int(nbrs.overflow)


def flat_phases(dev, card, counters) -> None:
    """Phases 35-39: the flat layout and float64 on the card."""
    import numpy as np
    import torch

    from sph_mountain_waves_tpu_torch.models import (
        collapse_dry as cd, full_hopkins_perturbed_witch as fh,
        hopkins_perturbed_witch as hp, hopkins_total_witch as ht,
        pavelka_total_witch as pv, rayleigh_benard as rb,
        wcsph_perturbed_witch as w,
    )
    from sph_mountain_waves_tpu_torch.models.witch_common import (
        WitchConfig, velocity_diagnostics,
    )

    # 35: the flagship's flat path at full width, f32 and f64
    for dtype in ("float32", "float64"):
        cfg = WitchConfig(n_rows=N_ROWS, layout="flat", skin=0.0,
                          self_density=True, dtype=dtype)
        system, state = flat_frames(35, f"flagship flat {dtype}", w, cfg, dev,
                                    card, counters, steps_per_frame=20)
        if system.n_built != EXPECT["n"]:
            raise AssertionError(f"flagship flat: N={system.n_built}")
        step = w.make_step(cfg, system.engine)
        profile_steps(35, f"flagship flat {dtype}", step, state, n_steps=5,
                      table=False)
        if dtype == "float64":
            flat_rebuild_twice(35, system.engine, state)
            one, two = step(state), step(state)
            if not all(torch.equal(one.fields[k], two.fields[k])
                       for k in one.fields):
                raise AssertionError("flat f64 step reruns differ")
            say(35, "flagship flat f64: one step run twice on the same card "
                    "state: equal bit for bit")
        del system, state
        torch.cuda.empty_cache()

    # 36: collapse_dry.run at its defaults (f64 flat, dr 0.015), 3 frames of
    # 222 steps (666), writing its files
    cfg0 = cd.Config()
    cfg = dataclasses.replace(cfg0, t_end=666 * cfg0.dt, n_frames=3,
                              checkpoint_every=1)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        out = cd.run(cfg, out_path=tmp, device=dev)
        secs = time.perf_counter() - t0
        files = sorted(os.listdir(tmp))
        check_run_files("collapse_dry", files,
                        ["checkpoint.npz", "data.csv", "frame0.vtp",
                         "frame1.vtp", "frame2.vtp", "frame3.vtp",
                         "result.pvd"], ["dambreak_H.pdf", "dambreak_X.pdf"])
    final, sysm = out["state"], out["system"]
    if (not all_finite(final) or int(final.n) != sysm.n_built
            or final.fields["x"].dtype != torch.float64
            or sysm.engine.layout != "flat"):
        raise AssertionError(f"collapse_dry defaults: finite "
                             f"{all_finite(final)}, active {int(final.n)}/"
                             f"{sysm.n_built}, {final.fields['x'].dtype}")
    step, _ = cd.make_step(cfg, sysm.engine)
    profile_steps(36, "collapse_dry flat f64", step, final, table=False)
    drift = abs(out["E"][-1] / out["E"][0] - 1.0)
    say(36, f"collapse_dry.run(Config()) at its defaults (f64 flat, dr "
            f"{cfg.dr}): N={sysm.n_built} flat grid {sysm.engine.lims} cap "
            f"{sysm.engine.cap} pair mode {sysm.engine.pair_mode}; 666 steps "
            f"in {secs:.2f} s = {1e3 * secs / 666:.3f} ms/step (set-up and "
            f"files included); wrote {files}; X {out['X'][-1]:.4f} H "
            f"{out['H'][-1]:.4f}, E drift {drift:.3e}; overflow "
            f"{flat_overflow(sysm, final)} ({card})")

    # 37: rayleigh_benard.Config() at its flat default, 3 frames of 100 steps
    cfg0 = rb.Config()
    cfg = dataclasses.replace(cfg0, t_end=300 * cfg0.dt, n_frames=3)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = rb.run(cfg, device=dev)
    secs = time.perf_counter() - t0
    final, sysm = out["state"], out["system"]
    profile_steps(37, "rayleigh_benard flat f32",
                  rb.make_step(cfg, sysm.engine), final, table=False)
    if (not all_finite(final) or int(final.n) != sysm.n_built
            or sysm.engine.layout != "flat"
            or not np.all(np.isfinite(out["Nu"]))):
        raise AssertionError(f"rayleigh_benard defaults: finite "
                             f"{all_finite(final)}, active {int(final.n)}/"
                             f"{sysm.n_built}, Nu {out['Nu']}")
    say(37, f"rayleigh_benard.run(Config()) at its flat default "
            f"({cfg.dtype}): N={sysm.n_built} flat grid {sysm.engine.lims} cap "
            f"{sysm.engine.cap} pair mode {sysm.engine.pair_mode}; 300 steps "
            f"in {secs:.2f} s = {1e3 * secs / 300:.3f} ms/step (set-up "
            f"included); peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; KE "
            f"{out['KE'][-1]:.4e} Nu {out['Nu'][-1]:.6f}; overflow "
            f"{flat_overflow(sysm, final)} ({card})")

    # 38: the mountain-wave schemes at their default configurations
    # (WitchConfig(): n_rows 75, f32 flat, skin 0), two frames each through
    # run(); hopkins_total and Pavelka after their packings
    for label, module, cfg in (
            ("flagship", w, WitchConfig()),
            ("hopkins_perturbed", hp, WitchConfig()),
            ("full_hopkins", fh, WitchConfig()),
            ("hopkins_total", ht, WitchConfig()),
            ("pavelka", pv, pv.PavelkaConfig())):
        steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
        cfg = dataclasses.replace(cfg, t_end=2 * steps_per_frame * cfg.dt,
                                  n_frames=2)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            out = module.run(cfg, out_path=tmp, device=dev)
            secs = time.perf_counter() - t0
            files = sorted(os.listdir(tmp))
        final, sysm = out["state"], out["system"]
        if (not all_finite(final) or sysm.engine.layout != "flat"
                or "frame2.vtp" not in files
                or not np.all(np.isfinite(out["u_max"]))):
            raise AssertionError(f"{label} defaults: finite "
                                 f"{all_finite(final)}, files {files}")
        say(38, f"{label}.run at its default config (f32 flat, n_rows "
                f"{cfg.n_rows}): N={sysm.n_built} flat grid "
                f"{sysm.engine.lims} cap {sysm.engine.cap} pair mode "
                f"{sysm.engine.pair_mode}; {2 * steps_per_frame} steps in "
                f"{secs:.2f} s (set-up{' and packing' if module in (ht, pv) else ''}"
                f" included); active {int(final.n)}/{sysm.n_built}; u_max "
                f"{out['u_max'][-1]:.4e} m/s; overflow "
                f"{flat_overflow(sysm, final)}; wrote {len(files)} files "
                f"({card})")

    # 39: the reference's two cross-layout gates on the card: the hand
    # kernels on f32 bucket (skin 0.2) against the flat f64 path (skin 0)
    series = {}
    for tag, kw in (("flat", dict(dtype="float64", layout="flat", skin=0.0)),
                    ("bucket", dict(dtype="float32", layout="bucket",
                                    skin=0.2, use_pallas=True))):
        cfg = WitchConfig(n_rows=14, self_density=True, **kw)
        sysm = w.make_system(cfg)
        state = sysm.freeze(device=dev)
        step = w.make_step(cfg, sysm.engine)
        rows = []
        for k in range(200):
            state = step(state)
            if (k + 1) % 50 == 0:
                rows.append([float(v) for v in velocity_diagnostics(state)])
        series[tag] = np.asarray(rows)
    rel = np.abs(series["bucket"] / series["flat"] - 1.0).max()
    if not rel < 1e-3:
        raise AssertionError(f"flagship cross-layout gate: rel {rel}")
    say(39, f"flagship cross-layout gate (n_rows 14, 200 steps, u_avg/u_max "
            f"every 50): f32 bucket (kernels) vs f64 flat, max rel diff "
            f"{rel:.3e} < 1e-3; f64 flat u_max {series['flat'][-1, 1]:.6e}")
    series = {}
    for tag, kw in (("flat", dict(dtype="float64", layout="flat", skin=0.0)),
                    ("bucket", dict(dtype="float32", layout="bucket",
                                    skin=0.2, use_pallas=True))):
        out = cd.run(cd.Config(dr=0.05, t_end=0.5, n_frames=10, **kw),
                     device=dev)
        series[tag] = np.stack([out["X"], out["H"], out["E"]])
    rel = np.abs(series["bucket"] / series["flat"] - 1.0).max()
    if not rel < 1e-3:
        raise AssertionError(f"dam-break cross-layout gate: rel {rel}")
    say(39, f"dam-break cross-layout gate (dr 0.05, t_end 0.5, 10 frames, "
            f"X/H/E): f32 bucket (kernels) vs f64 flat, max rel diff "
            f"{rel:.3e} < 1e-3; f64 flat X {series['flat'][0, -1]:.6f} H "
            f"{series['flat'][1, -1]:.6f}")

    # the routes the card refuses: a bucket state without use_pallas, and a
    # float64 bucket state
    for kw, err in ((dict(dtype="float32", use_pallas=False), ValueError),
                    (dict(dtype="float64", use_pallas=True),
                     NotImplementedError)):
        cfg = WitchConfig(n_rows=10, layout="bucket", skin=0.15, **kw)
        sysm = w.make_system(cfg)
        state = sysm.freeze(device=dev)
        try:
            w.make_step(cfg, sysm.engine)(state)
        except err:
            continue
        raise AssertionError(f"a bucket state with {kw} was not refused")
    say(39, "a CUDA bucket state with use_pallas=False and a float64 bucket "
            "state are refused")


def timed(fn):
    """(fn(), seconds, peak GiB): fn run on the card between two
    synchronisations; the peak of allocated memory during fn, counted from
    a reset just before, less what was allocated before it (earlier
    phases' live tensors)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            (torch.cuda.max_memory_allocated() - before) / 2**30)


def no_sweep_launched(label, counters) -> None:
    """The flat paths take no sweep kernel: every counter still 0."""
    launched = {k: v for k, v in counters.read().items() if v}
    if launched:
        raise AssertionError(f"{label}: sweep launches {launched} on a flat "
                             "path")


def kept_and_finite(label, out) -> None:
    """A run's final state: every value finite, every particle kept."""
    final, sysm = out["state"], out["system"]
    if not all_finite(final) or int(final.n) != sysm.n_built:
        raise AssertionError(f"{label}: finite {all_finite(final)}, active "
                             f"{int(final.n)}/{sysm.n_built}")


def grid_line(sysm) -> str:
    e = sysm.engine
    return (f"N={sysm.n_built} flat grid {e.lims} cap {e.cap} pair mode "
            f"{e.pair_mode}")


def collapse3d_flat_phase(dev, card, counters) -> None:
    """Phase 40: collapse3d on the flat layout: its defaults (f64, dr 5e-3)
    through ``run`` for 3 frames of its cadence with its files, the
    reference's energy gate, and one f32 frame."""
    import numpy as np

    from sph_mountain_waves_tpu_torch.models import collapse3d as c3
    cfg0 = c3.Config()
    spf = max(1, int(round(cfg0.t_end / cfg0.n_frames / cfg0.dt)))
    cfg = dataclasses.replace(cfg0, t_end=3 * spf * cfg0.dt, n_frames=3)
    with tempfile.TemporaryDirectory() as tmp:
        counters.reset()
        out, secs, peak = timed(lambda: c3.run(cfg, out_path=tmp, device=dev))
        files = sorted(os.listdir(tmp))
    no_sweep_launched("collapse3d defaults", counters)
    kept_and_finite("collapse3d defaults", out)
    sysm = out["system"]
    want = ["frame0.vtp", "frame1.vtp", "frame2.vtp", "result.pvd"]
    if (files != want or sysm.engine.layout != "flat"
            or out["state"].fields["x"].dtype != cfg.torch_dtype
            or not np.all(np.isfinite(out["E"])) or len(out["E"]) != 3):
        raise AssertionError(f"collapse3d defaults: files {files}, E "
                             f"{out['E']}")
    say(40, f"collapse3d.run(Config()) at its defaults (f64 flat, dr "
            f"{cfg.dr}): {grid_line(sysm)}; 3 frames of {spf} steps in "
            f"{secs:.2f} s = {1e3 * secs / (3 * spf):.3f} ms/step (set-up "
            f"and files included); peak memory {peak:.2f} GiB over its start; E per frame "
            f"{[float(f'{e:.9e}') for e in out['E']]}; wrote {files}; "
            f"overflow {flat_overflow(sysm, out['state'])}; no sweep "
            f"launched ({card})")
    profile_steps(40, "collapse3d flat f64", c3.make_step(cfg, sysm.engine),
                  out["state"], n_steps=5, table=False)

    # the reference's energy gate (tests/test_examples.py)
    gate = c3.Config(dr=0.015, t_end=0.06, n_frames=3)
    out, secs, peak = timed(lambda: c3.run(gate, device=dev))
    E = out["E"]
    drift = float(np.max(np.abs(E / E[0] - 1.0)))
    kept_and_finite("collapse3d energy gate", out)
    if not (np.all(np.isfinite(E)) and drift < 0.02):
        raise AssertionError(f"collapse3d energy gate: E {E}")
    n_steps = int(round(gate.t_end / gate.dt))
    say(40, f"collapse3d energy gate (dr {gate.dr}, t_end {gate.t_end}, 3 "
            f"frames, f64 flat): {grid_line(out['system'])}; max |E/E0 - 1| {drift:.3e} "
            f"< 0.02, every particle kept; {n_steps} steps in {secs:.2f} s "
            f"= {1e3 * secs / n_steps:.3f} ms/step; peak memory {peak:.2f} "
            f"GiB; overflow {flat_overflow(out['system'], out['state'])}")

    # one f32 frame at the default width
    cfg = dataclasses.replace(cfg0, dtype="float32", t_end=spf * cfg0.dt,
                              n_frames=1)
    counters.reset()
    out, secs, peak = timed(lambda: c3.run(cfg, device=dev))
    no_sweep_launched("collapse3d f32 flat", counters)
    kept_and_finite("collapse3d f32 flat", out)
    say(40, f"collapse3d f32 flat, one frame of {spf} steps: "
            f"{grid_line(out['system'])}; {secs:.2f} s = "
            f"{1e3 * secs / spf:.3f} ms/step; peak memory {peak:.2f} GiB over its start; E "
            f"{out['E'][-1]:.9e}; overflow "
            f"{flat_overflow(out['system'], out['state'])}")


# witch3d on the flat layout: the probe width, the widest width asked for
# (the stretch width) and the memory the reckoned peak must stay under
W3D_PROBE_ROWS = 12
W3D_MAX_ROWS = 40
W3D_LIMIT_BYTES = 60e9


def w3d_particles(cfg) -> float:
    """The particle count of a witch3d config, up to lattice rounding: the
    domain and its fence (bc_rows·dr on every side) filled at one particle
    per dr³ (the ridge is fluid too)."""
    w = 2 * cfg.bc_width
    return ((cfg.dom_length + w) * (cfg.dom_depth + w) * (cfg.dom_height + w)
            / cfg.dr**3)


def witch3d_flat_phase(dev, card, counters) -> None:
    """Phase 41: witch3d on the flat layout in f32 and f64. A probe at
    n_rows 12 measures the peak memory of a set-up and a step; the peak at
    a width is reckoned as the probe's scaled by the particle count, and
    the widest n_rows ≤ 40 under 60 GB is run: set-up and 2 frames. Then
    the reference's static and renormalisation gates at its TINY in f64."""
    import numpy as np
    import torch

    from sph_mountain_waves_tpu_torch.models import witch3d as w3
    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.models.witch_common import (
        background_density_t, velocity_diagnostics,
    )
    from sph_mountain_waves_tpu_torch.ops.apply import _largest_count

    for dtype in ("float32", "float64"):
        probe = w3.Witch3DConfig(n_rows=W3D_PROBE_ROWS, dtype=dtype,
                                 self_density=True)
        sysm = w3.make_system(probe)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = sysm.freeze(device=dev)
        state_bytes = torch.cuda.memory_allocated() - before
        state = w3.make_step(probe, sysm.engine)(
            w3.setup(probe, sysm.engine, state))
        torch.cuda.synchronize()
        peak_probe = torch.cuda.max_memory_allocated() - before
        e = sysm.engine
        _, nbrs = e.rebuild(state)
        k, S = _largest_count(e, nbrs), len(e.stencil)
        slots = (e.num_cells * k if e.pair_mode == "cell"
                 else state.capacity) * S * k
        block = slots * state.fields["x"].element_size()
        ratio = sysm.n_built / w3d_particles(probe)
        del state, nbrs
        torch.cuda.empty_cache()

        def reckoned(n_rows, probe=probe):
            cfg = dataclasses.replace(probe, n_rows=n_rows)
            return peak_probe * w3d_particles(cfg) / w3d_particles(probe)

        n_rows = max(n for n in range(W3D_PROBE_ROWS, W3D_MAX_ROWS + 1)
                     if reckoned(n) < W3D_LIMIT_BYTES)
        say(41, f"witch3d flat {dtype} probe at n_rows {W3D_PROBE_ROWS}: "
                f"{grid_line(sysm)} (N/estimate {ratio:.4f}); k {k}: one "
                f"{'[C, k, 27k]' if e.pair_mode == 'cell' else '[N, 27k]'} "
                f"plane {block / 2**30:.3f} GiB; state {state_bytes / 2**30:.3f}"
                f" GiB; set-up + step peak {peak_probe / 2**30:.2f} GiB "
                f"({(peak_probe - state_bytes) / block:.1f} planes above the "
                f"state); reckoned peak at n_rows {W3D_MAX_ROWS} "
                f"{reckoned(W3D_MAX_ROWS) / 1e9:.1f} GB; widest n_rows under "
                f"{W3D_LIMIT_BYTES / 1e9:.0f} GB: {n_rows} (reckoned "
                f"{reckoned(n_rows) / 1e9:.1f} GB)")

        cfg = dataclasses.replace(probe, n_rows=n_rows)
        spf = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
        t0 = time.perf_counter()
        sysm = w3.make_system(cfg)
        build_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        counters.reset()

        def run_it():
            state = sysm.freeze(device=dev)
            state = w3.setup(cfg, sysm.engine, state)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run_frame = frame_runner(w3.make_step(cfg, sysm.engine), spf)
            state = run_frame(run_frame(state))
            torch.cuda.synchronize()
            return state, time.perf_counter() - t1

        (state, step_s), secs, peak = timed(run_it)
        no_sweep_launched(f"witch3d flat {dtype}", counters)
        u_avg, u_max = (float(v) for v in velocity_diagnostics(state))
        if not all_finite(state) or int(state.n) != sysm.n_built:
            raise AssertionError(f"witch3d flat {dtype}: finite "
                                 f"{all_finite(state)}, active "
                                 f"{int(state.n)}/{sysm.n_built}")
        say(41, f"witch3d flat {dtype} at n_rows {n_rows}: {grid_line(sysm)}; "
                f"host build {build_s:.2f} s; freeze, set-up "
                f"({cfg.renorm_iters} iterations) and 2 frames of {spf} "
                f"steps in {secs:.2f} s, the steps {1e3 * step_s / (2 * spf):.1f}"
                f" ms/step; peak memory {peak:.2f} GiB over its start (reckoned "
                f"{reckoned(n_rows) / 2**30:.2f} GiB); active {int(state.n)}; "
                f"u_avg {u_avg:.4e} u_max {u_max:.4e} m/s; overflow "
                f"{flat_overflow(sysm, state)}; no sweep launched ({card})")
        del state
        torch.cuda.empty_cache()

    # the reference's gates (tests/test_witch3d.py) at its TINY in f64
    tiny = w3.Witch3DConfig(n_rows=6, dom_length=60e3, dom_depth=10e3,
                            bc_rows=3, self_density=True, dtype="float64")
    sysm = w3.make_system(tiny)
    state = sysm.freeze(device=dev)
    state = w3.setup(tiny, sysm.engine, state)
    step = w3.make_step(tiny, sysm.engine)
    t0 = time.perf_counter()
    ratio = None
    for k in range(12):
        state = step(state)
        if k == 0:
            act = state.active
            ratio = float(torch.median(
                state.fields["rho"][act]
                / background_density_t(tiny, state.fields["x"][act][:, 2])))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    v = state.fields["v"][state.active]
    u_max = float(torch.linalg.norm(v, dim=1).max())
    if not (all_finite(state) and int(state.n) == sysm.n_built
            and u_max < 1.0 and abs(ratio - 1.0) < 1e-3):
        raise AssertionError(f"witch3d TINY gates: u_max {u_max}, median "
                             f"ratio {ratio}, active {int(state.n)}")
    say(41, f"witch3d reference gates at TINY (f64 flat, {grid_line(sysm)}):"
            f" median rho/rho_bg after one step {ratio:.6f} (within 1e-3 of "
            f"1); u_max after 12 steps {u_max:.4e} m/s < 1, every particle "
            f"kept; {1e3 * secs / 12:.2f} ms/step")


ISPH_WARNING = ("ISPH precond='mg' requires a bucket engine (got "
                "layout='flat'); falling back to Jacobi")


def isph_flat_phase(dev, card, counters) -> None:
    """Phase 42: the flat ISPH solve: ``run(ISPHWitchConfig())`` at its
    defaults (f32 flat, "mg", which warns and solves with Jacobi), the
    baseline width on the flat layout in f32 and f64 kicked, and the
    reference's f64 static and projection gates at n_rows 12."""
    import warnings

    import numpy as np
    import torch

    from sph_mountain_waves_tpu_torch.kernels import rDspline23
    from sph_mountain_waves_tpu_torch.models import isph_witch as iw
    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.ops.apply import apply_binary

    cfg = iw.ISPHWitchConfig()
    with tempfile.TemporaryDirectory() as tmp:
        counters.reset()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out, secs, peak = timed(lambda: iw.run(cfg, out_path=tmp,
                                                   device=dev))
        files = sorted(os.listdir(tmp))
    no_sweep_launched("isph_witch defaults", counters)
    kept_and_finite("isph_witch defaults", out)
    msgs = [str(w.message) for w in caught
            if str(w.message).startswith("ISPH precond")]
    n_steps = len(out["t"])
    if (msgs != [ISPH_WARNING] or "result.pvd" not in files
            or "data.csv" not in files
            or not np.all(np.isfinite(out["u_max"]))):
        raise AssertionError(f"isph_witch defaults: warnings {msgs}, files "
                             f"{files}")
    sysm = out["system"]
    say(42, f"isph_witch.run(ISPHWitchConfig()) at its defaults (f32 flat, "
            f"precond 'mg'): caught RuntimeWarning: {msgs[0]!r}; "
            f"{grid_line(sysm)}; {n_steps} steps in {secs:.2f} s = "
            f"{1e3 * secs / n_steps:.2f} ms/step (set-up and files "
            f"included); peak memory {peak:.2f} GiB over its start; cg_it per step "
            f"{[int(c) for c in out['cg_it']]}, last cg_res "
            f"{out['cg_res'][-1]:.3e}; u_max {out['u_max'][-1]:.4e} m/s; "
            f"wrote {len(files)} files; overflow "
            f"{flat_overflow(sysm, out['state'])} ({card})")

    # the baseline width on the flat layout, kicked
    for dtype in ("float32", "float64"):
        cfg = iw.ISPHWitchConfig(n_rows=110, dtype=dtype, precond="jacobi")
        sysm = iw.make_system(cfg)
        state = kick(sysm.freeze(device=dev), dev)
        run_frame = frame_runner(iw.make_step(cfg, sysm.engine), 1)
        counters.reset()
        state = run_frame(state)  # warm-up
        warm_it = int(state.fields["cg_it"][0])
        (state, its, ress), secs, peak = timed(lambda s=state: _isph_frames(
            run_frame, s, 2))
        no_sweep_launched(f"isph flat {dtype}", counters)
        if not all_finite(state) or int(state.n) != sysm.n_built:
            raise AssertionError(f"isph flat {dtype}: finite "
                                 f"{all_finite(state)}")
        say(42, f"isph_witch flat {dtype} at the baseline width (n_rows 110, "
                f"Jacobi, kicked): {grid_line(sysm)}; a warm-up step "
                f"(cg_it {warm_it}) then 2 frames of 1 step: cg_it {its}, "
                f"cg_res {[float(f'{r:.3e}') for r in ress]}, "
                f"{1e3 * secs / 2:.2f} ms/step; peak memory {peak:.2f} GiB over its start; "
                f"overflow {flat_overflow(sysm, state)}; no sweep launched "
                f"({card})")
        if dtype == "float64":
            profile_steps(42, "isph flat f64 baseline",
                          iw.make_step(cfg, sysm.engine), state, n_steps=2,
                          table=False)
        del state
        torch.cuda.empty_cache()

    # the reference's gates (tests/test_isph.py): the static atmosphere at
    # n_rows 12 in f64 stays static; a kick is projected toward a
    # divergence-free flow
    cfg = iw.ISPHWitchConfig(n_rows=12, dtype="float64", t_end=12.0,
                             n_frames=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        out = iw.run(cfg, device=dev)
        sysm = iw.make_system(cfg)
        state = sysm.freeze(device=dev)
        step = iw.make_step(cfg, sysm.engine)
    eng = sysm.engine
    f = state.fields
    rng = np.random.default_rng(0)
    v = torch.as_tensor(0.5 * rng.standard_normal(tuple(f["v"].shape)),
                        dtype=f["v"].dtype, device=dev)
    state = state.replace(v=torch.where((f["type"] == 0.0)[:, None], v,
                                        f["v"]))

    def divf(p, q, r):
        return {"div": -torch.sum((p.x - q.x) * (p.v - q.v), dim=-1)
                * p.rho_bg * cfg.dr**2 * rDspline23(cfg.h0, r)}

    def rms_div(st):
        st, nbrs = eng.rebuild(st)
        st = st.replace(div=torch.zeros_like(st.fields["div"]))
        d = apply_binary(eng, st, nbrs, divf).fields["div"]
        return float(torch.sqrt(torch.mean(torch.where(st.active, d, 0.0)
                                           ** 2)))

    d0 = rms_div(state)
    for _ in range(10):
        state = step(state)
    d10 = rms_div(state)
    if not (out["u_max"][-1] < 1e-6 and math.isfinite(d10) and d10 < 0.3 * d0):
        raise AssertionError(f"isph gates: u_max {out['u_max']}, div "
                             f"{d0} -> {d10}")
    say(42, f"isph_witch reference gates (n_rows 12, f64 flat): static u_max "
            f"{out['u_max'][-1]:.3e} < 1e-6; kicked, rms divergence {d0:.4e} "
            f"-> {d10:.4e} after 10 steps (< 0.3x)")


def _isph_frames(run_frame, state, n):
    """n frames; (state, cg_it per frame, cg_res per frame)."""
    its, ress = [], []
    for _ in range(n):
        state = run_frame(state)
        its.append(int(state.fields["cg_it"][0]))
        ress.append(float(state.fields["cg_res"][0]))
    return state, its, ress


def implicit_dam_break_phase(dev, card, counters) -> None:
    """Phase 43: ``collapse_dry_implicit.run``: the reference's gates
    (tests/test_isph.py) at dr 0.05 and 0.06, then ``Config(t_end=0.1,
    n_frames=10)`` (180 steps) at its default dr 0.01 (f64 flat) with its
    files."""
    import numpy as np

    from sph_mountain_waves_tpu_torch.models import collapse_dry_implicit as ci

    cfg = ci.Config(dr=0.05, t_end=0.4, n_frames=8)
    out, secs, peak = timed(lambda: ci.run(cfg, device=dev))
    X, H, E = out["X"], out["H"], out["E"]
    kept_and_finite("implicit dam break gate", out)
    if not (np.all(np.diff(X) > -1e-6) and X[-1] > 1.8 and H[-1] < H[0]
            and np.max(E / E[0]) < 1.01 and E[-1] / E[0] > 0.9):
        raise AssertionError(f"implicit dam break gate: X {X} H {H} E {E}")
    n_steps = int(round(cfg.t_end / cfg.dt))
    say(43, f"collapse_dry_implicit gate (dr 0.05, t_end 0.4, 8 frames): "
            f"{grid_line(out['system'])}; X {X[-1]:.4f} > 1.8 and never "
            f"falls, H {H[0]:.4f} -> {H[-1]:.4f}, max E/E0 "
            f"{np.max(E / E[0]):.6f} < 1.01, E/E0 at the end "
            f"{E[-1] / E[0]:.6f} > 0.9, every particle kept; {n_steps} steps "
            f"in {secs:.2f} s = {1e3 * secs / n_steps:.2f} ms/step; peak "
            f"memory {peak:.2f} GiB; overflow "
            f"{flat_overflow(out['system'], out['state'])}")

    cfg = ci.Config(dr=0.06, t_end=0.1, n_frames=2)
    out = ci.run(cfg, device=dev)
    st = out["state"]
    P = st.fields["P"][st.active]
    rho_g_H = cfg.rho * abs(cfg.g) * cfg.water_column_height
    p_max = float(P.abs().max())
    if not (bool(P.isfinite().all()) and p_max < 20 * rho_g_H):
        raise AssertionError(f"implicit dam break pressure: max |P| {p_max}")
    say(43, f"collapse_dry_implicit pressure gate (dr 0.06, t_end 0.1): P "
            f"finite, max |P| {p_max:.1f} < 20 rho g H = {20 * rho_g_H:.1f}")

    # a fixed 180 steps at the default dr (t_end 0.1, 10 frames): each step
    # runs its Jacobi CG to the 200-iteration cap, so the default t_end 0.5
    # (900 steps) took 110-147 s of the card call
    cfg = ci.Config(t_end=0.1, n_frames=10)
    spf = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
    n_steps = int(round(cfg.t_end / cfg.dt))
    with tempfile.TemporaryDirectory() as tmp:
        counters.reset()
        out, secs, peak = timed(lambda: ci.run(cfg, out_path=tmp, device=dev))
        files = sorted(os.listdir(tmp))
    no_sweep_launched("implicit dam break defaults", counters)
    kept_and_finite("implicit dam break defaults", out)
    frames = len(out["X"])
    want = sorted([f"frame{i}.vtp" for i in range(frames)] + ["result.pvd"])
    sysm = out["system"]
    if (files != want or sysm.engine.layout != "flat"
            or out["state"].fields["x"].dtype != cfg.torch_dtype
            or not np.all(np.isfinite(out["E"]))):
        raise AssertionError(f"implicit dam break defaults: files {files}")
    steps_run = frames * spf
    say(43, f"collapse_dry_implicit.run(Config(t_end=0.1, n_frames=10)) at "
            f"its default dr {cfg.dr} (f64 flat): {grid_line(sysm)}; "
            f"{frames} frames of {spf} steps ({steps_run}; {n_steps} asked) "
            f"in {secs:.2f} s = {1e3 * secs / steps_run:.2f} ms/step (set-up "
            f"and files included); peak memory {peak:.2f} GiB over its start; X "
            f"{out['X'][-1]:.4f} H {out['H'][-1]:.4f}, E/E0 "
            f"{out['E'][-1] / out['E'][0]:.6f}; wrote {len(files)} files; "
            f"overflow {flat_overflow(sysm, out['state'])}; no sweep "
            f"launched ({card})")
    profile_steps(43, "collapse_dry_implicit f64 flat",
                  ci.make_step(cfg, sysm.engine), out["state"], n_steps=5,
                  table=False)


def run_phases(phases, dev, card, counters) -> None:
    """Each (number, phase) in turn, with its seconds printed and the
    allocator's cache emptied after it."""
    import torch
    for number, phase in phases:
        t0 = time.perf_counter()
        phase(dev, card, counters)
        torch.cuda.empty_cache()
        say(number, f"phase {number}: {time.perf_counter() - t0:.1f} s")


def solve_and_3d_flat_phases(dev, card, counters) -> None:
    """Phases 40-43: the 3-D schemes on the flat layout and the flat
    pressure solves on the card."""
    run_phases(((40, collapse3d_flat_phase), (41, witch3d_flat_phase),
                (42, isph_flat_phase), (43, implicit_dam_break_phase)),
               dev, card, counters)


# the five named terrain configurations at their defaults (f32 flat), each
# run for a fixed number of steps in that many frames: the flow ones past
# their first inflow spawn event (the boot inflow column converts at step
# 492 for isothermal_flow_config, 55 for adiabatic_flow_config and 383 for
# the terrain baseline)
TERRAIN_FLAT = (("isothermal_static_config", 100, 2),
                ("isothermal_flow_config", 520, 4),
                ("adiabatic_static_config", 100, 2),
                ("adiabatic_flow_config", 100, 2),
                ("terrain_baseline_config", 400, 4))
TERRAIN_BASELINE_N = 212_819


class SpawnEvents:
    """Counts the calls of ``legacy_witch.add_new_particles`` (a spawn
    event each) while it is entered; the step looks the function up in the
    module when it runs."""

    def __init__(self, lw):
        self.lw, self.count = lw, 0
        self.add = lw.add_new_particles

    def __enter__(self):
        def counted(*args, **kwargs):
            self.count += 1
            return self.add(*args, **kwargs)
        self.lw.add_new_particles = counted
        return self

    def __exit__(self, *exc):
        self.lw.add_new_particles = self.add


def terrain_flat_run(label, lw, cfg, n_steps, n_frames, dev, card, counters):
    """``legacy_witch.run(cfg, out_path=...)`` of ``n_steps`` steps in
    ``n_frames`` frames on the card, the gates of phase 44 and its line
    (ms/step with set-up and files, the flat grid, peak memory), then the
    device profile of 5 more steps. Returns the run's output."""
    import numpy as np
    cfg = dataclasses.replace(cfg, t_end=n_steps * cfg.dt, n_frames=n_frames)
    with tempfile.TemporaryDirectory() as tmp, SpawnEvents(lw) as spawns:
        counters.reset()
        out, secs, peak = timed(lambda: lw.run(cfg, out_path=tmp, device=dev))
        files = sorted(os.listdir(tmp))
    no_sweep_launched(label, counters)
    final, sysm = out["state"], out["system"]
    check_run_files(label, files,
                    [f"frame{i}.vtp" for i in range(n_frames + 1)]
                    + ["data.csv", "result.pvd"], ["velocities.pdf"])
    if (not all_finite(final) or sysm.engine.layout != "flat"
            or final.fields["x"].dtype != cfg.torch_dtype
            or len(out["u_max"]) != n_frames):
        raise AssertionError(f"{label}: finite {all_finite(final)}, layout "
                             f"{sysm.engine.layout}, dtype "
                             f"{final.fields['x'].dtype}")
    if cfg.flow:
        n_inflow0 = int((sysm.host_fields()["type"] == lw.INFLOW).sum())
        if (spawns.count < 1 or np.any(out["n_inflow"] != n_inflow0)
                or np.any(out["spawn_drops"] != 0)):
            raise AssertionError(f"{label}: spawn events {spawns.count}, "
                                 f"INFLOW {n_inflow0} -> {out['n_inflow']}, "
                                 f"spawn_drops {out['spawn_drops']}")
        held = (f"{spawns.count} spawn events, INFLOW rows {n_inflow0} "
                f"conserved, spawn_drops 0, active {sysm.n_built} -> "
                f"{int(final.n)}")
    else:
        if int(final.n) != sysm.n_built:
            raise AssertionError(f"{label}: active {int(final.n)}/"
                                 f"{sysm.n_built}")
        held = f"every particle kept ({sysm.n_built})"
    say(44, f"{label} ({cfg.dtype} flat): {grid_line(sysm)}, capacity "
            f"{final.capacity}; run(out_path) of {n_steps} steps in "
            f"{n_frames} frames: {secs:.2f} s = {1e3 * secs / n_steps:.3f} "
            f"ms/step (set-up and files included); peak memory {peak:.2f} "
            f"GiB over its start; {held}; u_avg {out['u_avg'][-1]:.4e} "
            f"u_max {out['u_max'][-1]:.4e} m/s; overflow "
            f"{flat_overflow(sysm, final)}; wrote {len(files)} files; no "
            f"sweep launched ({card})")
    profile_steps(44, f"{label} {cfg.dtype} flat",
                  lw.make_step(cfg, sysm.engine), final, n_steps=5,
                  table=False)
    return out


def binned_diagnostics(lw, cfg):
    """The binned wave observables (sorted, segment-summed bins) and the
    drag and INFLOW counters in one function of the state; the bands sit
    above the 13 km ridge."""
    parts = (lw.mountain_force, lw.inflow_reservoir,
             lw.wave_momentum_flux_binned(cfg, 16e3, 2e3),
             lw.wave_amplitude_profile(cfg, [15e3, 18e3]),
             lw.stationary_wave_bins(cfg, 16e3))

    def diag(state):
        out = {}
        for d in parts:
            out.update(d(state))
        return out
    return diag


def terrain_reference_gates(lw, dev) -> None:
    """Phase 44 (c): the reference's physics gates of the terrain family
    (tests/test_legacy.py), on the card in float64 on the flat layout, at
    their own sizes and limits."""
    import numpy as np
    import torch

    def active_fluid(state):
        return (state.active & (state.fields["type"] == lw.FLUID)).cpu().numpy()

    t0 = time.perf_counter()
    geo = dict(n_rows=24, dom_length=60e3, h_m=2000.0, a=6e3, t_end=9.0,
               n_frames=6, dtype="float64")
    out_flow = lw.run(lw.isothermal_flow_config(**geo), device=dev)
    out_static = lw.run(lw.isothermal_static_config(**geo), device=dev)
    drag_f, drag_s = out_flow["drag"], out_static["drag"]
    lift_s = out_static["lift"]
    if not (np.isfinite(drag_f).all() and np.isfinite(drag_s).all()
            and (drag_f > 0).all() and drag_f[-1] > 1e7
            and abs(drag_s[-1]) < 1e-6 * abs(lift_s[-1])
            and abs(drag_s[-1]) < 1e-6 * drag_f[-1]
            and int(out_flow["spawn_drops"][-1]) == 0):
        raise AssertionError(f"drag discrimination: flow {drag_f}, static "
                             f"{drag_s}, lift {lift_s}")
    say(44, f"gate test_mountain_wave_drag (n_rows 24, 60 km, t_end 9 s): "
            f"flow drag {drag_f[-1]:.4e} > 1e7 N/m and > 0 every frame; "
            f"static drag {drag_s[-1]:.3e}, |drag| < 1e-6 x lift "
            f"{lift_s[-1]:.4e} and < 1e-6 x the flow drag; spawn_drops 0 "
            f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    kw = dict(n_rows=12, t_end=0.5, n_frames=1, dtype="float64")
    ratio = {}
    for flag in (False, True):
        st = lw.run(lw.adiabatic_static_config(consistent_entropy=flag, **kw),
                    device=dev)["state"]
        T = st.fields["T"].cpu().numpy()[active_fluid(st)]
        ratio[flag] = float(np.mean(T)) / 250.0
    gamma = lw.adiabatic_static_config(**kw).gamma
    if not (abs(ratio[True] - 1.0) < 0.02
            and abs(ratio[False] - 1.0 / gamma) < 0.05):
        raise AssertionError(f"consistent entropy: T/T0 {ratio}")
    say(44, f"gate test_consistent_entropy_recovers_T0 (n_rows 12): mean "
            f"T/T0 {ratio[True]:.6f} (|-1| < 0.02) consistent, "
            f"{ratio[False]:.6f} (1/gamma = {1 / gamma:.6f}, within 0.05) "
            f"faithful ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    kw = dict(n_rows=16, t_end=2.0, n_frames=1, dtype="float64")
    w_sponge = {}
    for flag in (False, True):
        cfg = lw.isothermal_static_config(true_rayleigh=flag, **kw)
        st = lw.run(cfg, device=dev)["state"]
        y = st.fields["x"][:, 1].cpu().numpy()
        sel = active_fluid(st) & (y >= cfg.z_t - cfg.z_b)
        w_sponge[flag] = float(np.mean(st.fields["v"][:, 1].cpu().numpy()[sel]))
    if not (w_sponge[False] < -0.8
            and abs(w_sponge[True]) < 0.55 * abs(w_sponge[False])):
        raise AssertionError(f"sponge: mean w in the sponge {w_sponge}")
    say(44, f"gate test_true_rayleigh_sponge_vs_faithful (n_rows 16, t_end "
            f"2 s): mean w in the sponge {w_sponge[False]:.4f} m/s faithful "
            f"(< -0.8), {w_sponge[True]:.4f} corrected (|.| < 0.55 x) "
            f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    cfg = lw.isothermal_flow_config(n_rows=12, dom_length=60e3,
                                    dtype="float64")
    sysm = lw.make_system(cfg)
    st = sysm.freeze(device=dev, capacity=sysm.n_built)
    n_inflow0 = int(lw.inflow_reservoir(st)["n_inflow"])
    step = lw.make_step(cfg, sysm.engine)
    for _ in range(120):
        st = step(st)
    res = lw.inflow_reservoir(st)
    drops = int(res["spawn_drops"])
    if not (sysm.engine.layout == "flat" and drops > 0
            and n_inflow0 - int(res["n_inflow"]) == drops):
        raise AssertionError(f"spawn drops: {drops}, INFLOW {n_inflow0} -> "
                             f"{int(res['n_inflow'])}")
    say(44, f"gate test_spawn_drops_are_counted (flat, capacity == N = "
            f"{sysm.n_built}, 120 steps): {drops} drops, INFLOW {n_inflow0} "
            f"-> {int(res['n_inflow'])} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    Dv, vf = {}, {}
    for av in (0.0, 1.0):
        cfg = lw.adiabatic_flow_config(
            n_rows=12, dom_length=40e3, h_m=500.0, a=6e3, dtype="float64",
            true_rayleigh=True, consistent_entropy=True, av_alpha=av)
        sysm = lw.make_system(cfg)
        st = sysm.freeze(device=dev)
        f = st.fields
        x, y = f["x"][:, 0], f["x"][:, 1]
        k = 2 * np.pi / (4 * cfg.dr)
        fl = st.active & (f["type"] == lw.FLUID)
        noise = torch.stack([3.0 * torch.sin(k * x) * torch.cos(k * y),
                             3.0 * torch.cos(k * x) * torch.sin(k * y)], -1)
        st = st.replace(v=torch.where(fl[:, None], f["v"] + noise, f["v"]))
        s1 = lw.make_step(cfg, sysm.engine)(st)
        Dv[av] = s1.fields["Dv"].cpu().numpy()
        vf[av] = s1.fields["v"].cpu().numpy()
        m = s1.fields["m"].cpu().numpy()
        act = s1.active.cpu().numpy()
    dDv = (Dv[1.0] - Dv[0.0]) * act[:, None]
    m = m * act
    work = float(np.sum(m[:, None] * vf[0.0] * dDv))
    net = np.abs((m[:, None] * dDv).sum(0))
    scale = (m[:, None] * np.abs(dDv)).sum(0)
    if not (np.abs(dDv).max() > 0.1 and work < 0
            and (net < 1e-12 * scale).all()):
        raise AssertionError(f"AV: max |dDv| {np.abs(dDv).max()}, work "
                             f"{work}, net {net} scale {scale}")
    say(44, f"gate test_av_alpha_is_dissipative_and_conservative (n_rows 12, "
            f"one step, av 0 vs 1): max |dDv| {np.abs(dDv).max():.4e} > 0.1, "
            f"sum m v dDv {work:.4e} < 0, net momentum {net.max():.3e} < "
            f"1e-12 x {scale.min():.4e} ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    cfg = lw.isothermal_flow_config(
        n_rows=16, dom_length=80e3, t_end=1.0, n_frames=1, dtype="float64",
        outflow_buffer=2 * 1.8 * (26e3 / 16))
    out = lw.run(cfg, device=dev)
    st = out["state"]
    act = st.active.cpu().numpy()
    typ = st.fields["type"].cpu().numpy()
    x = st.fields["x"].cpu().numpy()
    v = st.fields["v"].cpu().numpy()
    outflow = act & (typ == lw.OUTFLOW)
    x_out = cfg.dom_length / 2 - cfg.outflow_buffer
    fluid = active_fluid(st)
    if not (outflow.sum() > 0
            and np.all(np.abs(v[outflow, 0] - cfg.U_max) <= 1e-12)
            and np.all(np.abs(v[outflow, 1]) <= 1e-12)
            and x[fluid, 0].max() <= x_out + cfg.U_max * cfg.dt + 1e-9
            and np.isfinite(out["u_avg"]).all()):
        raise AssertionError(f"outflow buffer: {outflow.sum()} OUTFLOW rows")
    say(44, f"gate test_outflow_buffer_conversion_and_freeze (n_rows 16, 80 "
            f"km, t_end 1 s): {int(outflow.sum())} OUTFLOW rows at (U, 0) "
            f"within 1e-12, no FLUID row past x_out + U dt "
            f"({time.perf_counter() - t0:.1f} s)")


def terrain_flat_phase(dev, card, counters) -> None:
    """Phase 44: the terrain family on the flat layout. (a) the five named
    configs at their defaults (f32 flat) through ``run(out_path=...)``;
    (b) the terrain baseline in float64 at full width through a spawn
    event, then 50 steps run twice from its state with the binned
    observables: bit for bit; (c) the reference's physics gates."""
    import torch

    from sph_mountain_waves_tpu_torch.models import legacy_witch as lw
    from sph_mountain_waves_tpu_torch.models.common import frame_runner

    for factory, n_steps, n_frames in TERRAIN_FLAT:
        cfg = getattr(lw, factory)()
        out = terrain_flat_run(f"{factory}()", lw, cfg, n_steps, n_frames,
                               dev, card, counters)
        if (factory == "terrain_baseline_config"
                and out["system"].n_built != TERRAIN_BASELINE_N):
            raise AssertionError(f"terrain baseline N "
                                 f"{out['system'].n_built}")
        del out
        torch.cuda.empty_cache()

    cfg = lw.terrain_baseline_config(dtype="float64")
    out = terrain_flat_run("terrain_baseline_config(dtype='float64')", lw,
                           cfg, 400, 1, dev, card, counters)
    sysm, state = out["system"], out["state"]
    del out
    diag = binned_diagnostics(lw, cfg)
    frame = frame_runner(lw.make_step(cfg, sysm.engine), 50)
    counters.reset()
    a, b = frame(state), frame(state)
    no_sweep_launched("terrain f64 reruns", counters)
    differ = [k for k in a.fields if not torch.equal(a.fields[k], b.fields[k])]
    da, db, da2 = diag(a), diag(b), diag(a)
    dd = [k for k in da if not (torch.equal(da[k], db[k])
                                and torch.equal(da[k], da2[k]))]
    if differ or dd or not torch.equal(a.active, b.active):
        raise AssertionError(f"terrain f64 reruns differ: fields {differ}, "
                             f"diagnostics {dd}")
    vals = {k: float(v) for k, v in da.items()}
    say(44, f"terrain baseline f64: 50 steps run twice from the same state: "
            f"states bit for bit equal ({len(a.fields)} fields, active); the "
            f"binned observables ({len(vals)} values: wave_flux "
            f"{vals['wave_flux']:.6e}, ampu15000 {vals['ampu15000']:.6e}, "
            f"ampw18000 {vals['ampw18000']:.6e}, su0 {vals['su0']:.6e}) and "
            f"drag {vals['drag']:.6e} N/m equal bit for bit on both states "
            f"and on a second evaluation")
    del a, b, state
    torch.cuda.empty_cache()

    terrain_reference_gates(lw, dev)


def rkpm_phase(dev, card, counters) -> None:
    """Phase 45: Rayleigh–Bénard with ``conduction="rkpm"`` on the flat
    layout: its flat defaults for 2 frames of 100 steps with the profile of
    5 more, then the reference's two RKPM gates
    (tests/test_rayleigh_benard.py)."""
    import numpy as np
    import torch

    from sph_mountain_waves_tpu_torch.models import rayleigh_benard as rb
    from sph_mountain_waves_tpu_torch.utils.rkpm import corrected_laplacian

    cfg0 = rb.Config(conduction="rkpm")
    cfg = dataclasses.replace(cfg0, t_end=200 * cfg0.dt, n_frames=2)
    counters.reset()
    out, secs, peak = timed(lambda: rb.run(cfg, device=dev))
    no_sweep_launched("rayleigh_benard rkpm", counters)
    kept_and_finite("rayleigh_benard rkpm", out)
    sysm = out["system"]
    if (sysm.engine.layout != "flat" or len(out["KE"]) != 2
            or not np.all(np.isfinite(out["Nu"]))):
        raise AssertionError(f"rkpm defaults: KE {out['KE']} Nu {out['Nu']}")
    say(45, f"rayleigh_benard.run(Config(conduction='rkpm')) at its flat "
            f"defaults ({cfg.dtype}): {grid_line(sysm)}; 2 frames of 100 "
            f"steps in {secs:.2f} s = {1e3 * secs / 200:.3f} ms/step (set-up "
            f"included); peak memory {peak:.2f} GiB over its start; KE "
            f"{out['KE'][-1]:.6e} Nu {out['Nu'][-1]:.6f}; overflow "
            f"{flat_overflow(sysm, out['state'])}; no sweep launched ({card})")
    profile_steps(45, "rayleigh_benard rkpm f32 flat",
                  rb.make_step(cfg, sysm.engine), out["state"], n_steps=5,
                  table=False)
    del out

    t0 = time.perf_counter()
    cfg = rb.Config(n_rows=20, aspect=1.0, Ra=1e-3, beta=1e-8, seed_amp=0.0,
                    sidewalls="adiabatic", dtype="float64")
    sysm = rb.make_system(cfg)
    a2, b1 = 0.35, -0.2
    for chunk in sysm._chunks:
        y = chunk["x"][:, 1]
        chunk["T"] = 0.7 + b1 * y + a2 * y * y
    st = sysm.freeze(device=dev)
    st, nbrs = sysm.engine.rebuild(st)
    f = st.fields
    inc = st.active & (f["type"] != rb.WALL_ADIA)
    lap = corrected_laplacian(
        sysm.engine, st, nbrs, f["T"], include_q=inc,
        vol_of=lambda q: cfg.m / torch.clamp(q.rho, min=1e-30)).cpu().numpy()
    fl = (st.active & (f["type"] == rb.FLUID)).cpu().numpy()
    err = np.abs(lap[fl] - 2 * a2)
    if not np.all(err <= 1e-5 + 5e-3 * 2 * a2):
        raise AssertionError(f"rkpm exact at walls: max err {err.max()}")
    say(45, f"gate test_rkpm_conduction_exact_at_walls (n_rows 20, f64 "
            f"flat, adiabatic sidewalls, quadratic T): the RKPM Laplacian on "
            f"{int(fl.sum())} FLUID rows, max |lap - {2 * a2}| "
            f"{err.max():.3e} (rtol 5e-3, atol 1e-5) "
            f"({time.perf_counter() - t0:.1f} s)")

    cfg = rb.Config(n_rows=16, Ra=1e6, t_end=8.0, n_frames=8,
                    conduction="rkpm")
    n_steps = int(round(cfg.t_end / cfg.dt))
    out, secs, _ = timed(lambda: rb.run(cfg, device=dev))
    st = out["state"]
    T = st.fields["T"][st.active].cpu().numpy()
    KE = out["KE"]
    if not (np.isfinite(T).all() and T.min() > -0.7 and T.max() < 1.7
            and np.all(np.isfinite(KE)) and KE[-1] > 10 * KE[2]):
        raise AssertionError(f"rkpm short run: T [{T.min()}, {T.max()}], "
                             f"KE {KE}")
    say(45, f"gate test_rkpm_conduction_short_run_stable (n_rows 16, Ra 1e6, "
            f"t_end 8, f32 flat): {n_steps} steps in {secs:.2f} s = "
            f"{1e3 * secs / n_steps:.3f} ms/step; T in [{T.min():.4f}, "
            f"{T.max():.4f}] within (-0.7, 1.7); KE {KE[2]:.4e} at frame 2 -> "
            f"{KE[-1]:.4e} (> 10x) ({card})")


def terrain_and_rkpm_phases(dev, card, counters) -> None:
    """Phases 44-45: the terrain family on the flat layout and in float64,
    and Rayleigh–Bénard's RKPM conduction, on the card."""
    run_phases(((44, terrain_flat_phase), (45, rkpm_phase)), dev, card,
               counters)


def main(profile: bool) -> None:
    import torch
    run_t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke run needs one GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    card = card.strip().splitlines()[0]
    print(card, flush=True)
    say(1, f"torch {torch.__version__} cuda {torch.version.cuda} on "
           f"{torch.cuda.get_device_name(0)} ({card})")

    from sph_mountain_waves_tpu_torch import io as port_io
    from sph_mountain_waves_tpu_torch.models import (
        collapse3d as c3, collapse_dry as cd,
        full_hopkins_perturbed_witch as fh, hopkins_perturbed_witch as hp,
        hopkins_total_witch as ht, legacy_witch as lw,
        pavelka_total_witch as pv, wcsph_perturbed_witch as w, witch3d as w3,
    )
    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.models.witch_common import (
        WitchConfig, velocity_diagnostics,
    )
    from sph_mountain_waves_tpu_torch.ops import _build
    from sph_mountain_waves_tpu_torch.ops import pair_sweeps as ps
    from sph_mountain_waves_tpu_torch.utils.packing import hydrostatic_packing

    b = _build.build("pair_sweep")
    _build.load("pair_sweep")
    say(2, f"built {b.path.name} in {b.seconds:.2f} s")
    for name, regs in ptxas_report(b.log):
        say(2, f"ptxas {name}: {regs}")
    counters = Counters(ps)

    cfg = WitchConfig(n_rows=N_ROWS, dtype="float32", self_density=True,
                      layout="bucket", skin=0.15, use_pallas=True,
                      lazy_diagnostics=True, lattice_cells=True,
                      fast_math=True)
    system, state0, build_s = build_full(w, cfg, dev)
    eng = system.engine
    n = system.n_built
    say(3, f"flagship built in {build_s:.2f} s: N={n} lims={eng.lims} "
           f"cap={eng.cap} slots={eng.slots} h={eng.h:.2f} m dt={cfg.dt:.4e} s")

    # 4: every particle already sits in its slot, so a rescatter that moves
    # every field must return the state bitwise; the engine's own rescatter
    # (persistent fields only) must return those fields bitwise
    for label, e in (("all fields", dataclasses.replace(eng, persistent=())),
                     ("persistent", eng)):
        out, dropped = e._stencil_rescatter(state0)
        names = e.persistent or tuple(state0.fields)
        bad = [k for k in names if not torch.equal(out.fields[k], state0.fields[k])]
        if int(dropped) != 0 or bad or not torch.equal(out.active, state0.active):
            raise AssertionError(f"rescatter ({label}) not the identity: "
                                 f"dropped={int(dropped)} differing={bad}")
        ms = cuda_ms(lambda: e._stencil_rescatter(state0), 3)
        say(4, f"forced rescatter ({label}): identical, 0 dropped; "
               f"{ms:.2f} ms per rescatter ({card})")

    # 5: the flagship's kernels against their twins on a live state: one
    # step in, then v and h perturbed from a seeded generator; the density
    # (with the self pair, the flagship's self_density, and without it) and
    # the momentum run the tiled design: held bit for bit against the direct
    # one, the row band and the other staging scheme, then against the twin
    st = perturbed(w.make_step(cfg, eng)(state0), dev)
    say(5, tile_plan_line(ps, eng, st, ("density_sweep", "momentum_sweep")))
    errs = {}
    for self_pair in (True, False):
        c = dataclasses.replace(cfg, self_density=self_pair)
        label = f"density self_pair={self_pair}"
        kern = [ps.density_pass(eng, st, c)]
        held = designs_equal(label, "density_sweep", eng, st, c, kern)
        err, scale = errs[f"density_self{int(self_pair)}"] = kernel_vs_twin(
            label, kern, [ps.density_pass(eng, st, c)],
            [ps.density_pass_plain(eng, st, c)], fast=False)
        say(5, f"density kernel (tiled), self_pair={self_pair}: bit for bit "
               f"equal to {held}; vs twin max abs err {err:.3e} (max |rho| "
               f"{scale:.4f}), gate rtol {RTOL} atol {ATOL}, rerun bitwise "
               f"equal")
    for fm in (False, True):
        c = dataclasses.replace(cfg, fast_math=fm)
        label = f"momentum fast_math={fm}"
        kern = ps.momentum_pass(eng, st, c)
        held = designs_equal(label, "momentum_sweep", eng, st, c, kern)
        err, scale = errs[f"momentum_fm{int(fm)}"] = kernel_vs_twin(
            label, kern, ps.momentum_pass(eng, st, c),
            ps.momentum_pass_plain(eng, st, c), fm)
        say(5, f"momentum kernel (tiled), fast_math={fm}: bit for bit equal "
               f"to {held}; vs twin max abs err {err:.3e} "
               f"(max |Dv| {scale:.4f}, rel {err / scale:.3e})"
               + ("" if fm else f", gate rtol {RTOL} atol {ATOL}")
               + ", rerun bitwise equal")
    del st

    # 6: small input, 8 steps: kernels on the card against the plain twins
    # on the CPU (the path the tier-1 tests hold to the JAX package)
    gk, gc, rel, nk = small_steps(w, cfg, dev)
    say(6, f"n_rows=10, 8 steps: card u_avg/u_max {gk} vs cpu twins {gc} "
           f"(rel {rel:.2e}), active {nk} == {nk}")

    # 7: the flagship main path
    step = w.make_step(cfg, eng)
    run_frame = frame_runner(step, STEPS_PER_FRAME, finalize=w.make_finalize(cfg))
    steps = 3 * STEPS_PER_FRAME
    flag_state, flag_ms, flag_counts, _, u_max = drive(
        7, "flagship main path", counters, run_frame, state0, 2,
        {"density_sweep": steps, "momentum_sweep": steps}, card, n)
    if int(flag_state.n) != n or not u_max < 10.0:
        raise AssertionError(f"flagship: active {int(flag_state.n)}/{n}, "
                             f"u_max {u_max}")
    say(7, f"rescatters in the {steps} flagship steps: "
           f"{rescatters(run_frame, state0, 3)}")
    del state0
    if profile:
        profile_steps(7, "flagship", step, flag_state)

    # 8: the Hopkins kernels against their twins on a live full Hopkins
    # state (one step in, v and h perturbed)
    fh_sys, fh_state0, build_s = build_full(fh, cfg, dev)
    say(8, f"full Hopkins system built in {build_s:.2f} s")
    st = perturbed(fh.make_step(cfg, fh_sys.engine)(fh_state0), dev)
    e8 = fh_sys.engine
    # the pressure root and the Hopkins momentum run the tiled design: the
    # pressure root with the self pair (the Hopkins paths' self_density) and
    # without it, the momentum each form on its own plan
    say(8, tile_plan_line(ps, e8, st, ("pressure_sweep",
                                       "hopkins_momentum_sweep split",
                                       "hopkins_momentum_sweep total")))
    for self_pair in (True, False):
        c = dataclasses.replace(cfg, self_density=self_pair)
        label = f"pressure self_pair={self_pair}"
        kern = [ps.pressure_pass(e8, st, c)]
        held = designs_equal(label, "pressure_sweep", e8, st, c, kern)
        err, scale = errs[f"pressure_self{int(self_pair)}"] = kernel_vs_twin(
            label, kern, [ps.pressure_pass(e8, st, c)],
            [ps.pressure_pass_plain(e8, st, c)], fast=False)
        say(8, f"pressure kernel (tiled), self_pair={self_pair}: bit for bit "
               f"equal to {held}; vs twin max abs err {err:.3e} (max |P root| "
               f"{scale:.4f}), gate rtol {RTOL} atol {ATOL}, rerun bitwise "
               f"equal")
    for split in (True, False):
        for fm in (False, True):
            c = dataclasses.replace(cfg, fast_math=fm)
            label = f"hopkins split={split} fast_math={fm}"
            kern = ps.hopkins_momentum_pass(e8, st, c, split)
            held = designs_equal(label, "hopkins_momentum_sweep", e8, st, c,
                                 kern, background_split=split)
            err, scale = errs[f"hopkins_s{int(split)}_fm{int(fm)}"] = kernel_vs_twin(
                label, kern, ps.hopkins_momentum_pass(e8, st, c, split),
                ps.hopkins_momentum_pass_plain(e8, st, c, split), fm)
            say(8, f"hopkins momentum kernel (tiled), split={split} "
                   f"fast_math={fm}: bit for bit equal to {held}; vs twin max "
                   f"abs err {err:.3e} (max |Dv| "
                   f"{scale:.4f}, rel {err / scale:.3e})"
                   + ("" if fm else f", gate rtol {RTOL} atol {ATOL}")
                   + ", rerun bitwise equal")
    del st

    # 9: 8 small steps of each Hopkins scheme, card against CPU twins
    for module in (hp, fh, ht):
        gk, gc, rel, nk = small_steps(module, cfg, dev)
        say(9, f"{module.__name__.rsplit('.', 1)[-1]}, n_rows=10, 8 steps: "
               f"card u_avg/u_max {gk} vs cpu twins {gc} (rel {rel:.2e}), "
               f"active {nk} == {nk}")

    # 10: the full Hopkins main path
    fh_frame = frame_runner(fh.make_step(cfg, e8), STEPS_PER_FRAME)
    fh_state, fh_ms, fh_counts, _, _ = drive(
        10, "full_hopkins main path", counters, fh_frame, fh_state0, 2,
        {"density_sweep": steps, "pressure_sweep": steps,
         "hopkins_momentum_sweep": steps}, card, n)
    if int(fh_state.n) != n:
        raise AssertionError(f"full_hopkins: active {int(fh_state.n)}/{n}")
    say(10, f"rescatters in the {steps} full_hopkins steps: "
            f"{rescatters(fh_frame, fh_state0, 3)}")
    if profile:  # from the built state: no rescatter in these steps
        profile_steps(10, "full_hopkins", fh.make_step(cfg, e8), fh_state0)
    del fh_state0

    # 11: hopkins_total through its run-style setup (the packing), then frames
    ht_sys, ht_state, build_s = build_full(ht, cfg, dev)
    e11 = ht_sys.engine
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ht_state, info = hydrostatic_packing(cfg, e11, ht_state, return_info=True)
    torch.cuda.synchronize()
    say(11, f"hopkins_total built in {build_s:.2f} s; hydrostatic packing: "
            f"{info['steps']} steps, err {info['err0']:.6e} -> {info['err']:.6e} "
            f"in {time.perf_counter() - t0:.2f} s; active {int(ht_state.n)}; "
            f"finite {all_finite(ht_state)} ({card})")
    ht_frame = frame_runner(ht.make_step(cfg, e11), STEPS_PER_FRAME)
    packed = ht_state
    ht_state, ht_ms, _, _, _ = drive(
        11, "hopkins_total main path", counters, ht_frame, packed, 1,
        {"density_sweep": 2 * STEPS_PER_FRAME,
         "pressure_sweep": 2 * STEPS_PER_FRAME,
         "hopkins_momentum_sweep": 2 * STEPS_PER_FRAME}, card, n)
    say(11, f"hopkins_total active after packing and "
            f"{2 * STEPS_PER_FRAME} steps: "
            f"{int(ht_state.n)} of {n} (walls are not FLUID-filtered, as in "
            f"the reference: {n - int(ht_state.n)} dropped); rescatters in "
            f"them: {rescatters(ht_frame, packed, 2)}")
    if profile:  # from the packed state
        profile_steps(11, "hopkins_total", ht.make_step(cfg, e11), packed)
    del packed

    # 12: hopkins_perturbed, one frame
    hp_sys, hp_state, build_s = build_full(hp, cfg, dev)
    counters.reset()
    t0 = time.perf_counter()
    hp_state = frame_runner(hp.make_step(cfg, hp_sys.engine),
                            STEPS_PER_FRAME)(hp_state)
    torch.cuda.synchronize()
    hp_counts = counters.read()
    want = {k: 0 for k in COUNTED}
    want.update(density_sweep=STEPS_PER_FRAME, momentum_sweep=STEPS_PER_FRAME,
                pressure_sweep=STEPS_PER_FRAME)
    if hp_counts != want or not all_finite(hp_state) or int(hp_state.n) != n:
        raise AssertionError(f"hopkins_perturbed: counts {hp_counts}, finite "
                             f"{all_finite(hp_state)}, active {int(hp_state.n)}")
    say(12, f"hopkins_perturbed: built in {build_s:.2f} s; {STEPS_PER_FRAME} "
            f"steps in {time.perf_counter() - t0:.2f} s (first frame, "
            f"warm-up included); active {int(hp_state.n)}; launches "
            f"{ {k: v for k, v in hp_counts.items() if v} }")
    del hp_state, hp_sys

    # 13: the Pavelka kernels and the packing's gradient sweep against their
    # twins on a live full-width Pavelka state (one step in, v and h
    # perturbed). The sums cancel (Dv_y is about +g against terms of
    # hundreds), so the gate's atol is scaled by each output's largest |value|.
    pcfg = pv.PavelkaConfig(**dataclasses.asdict(dataclasses.replace(
        cfg, lazy_diagnostics=False)))
    pv_sys, pv_state0, build_s = build_full(pv, pcfg, dev)
    e13 = pv_sys.engine
    say(13, f"Pavelka system built in {build_s:.2f} s")
    st = perturbed(pv.make_step(pcfg, e13)(pv_state0), dev)
    # the two Pavelka sweeps run the tiled design: held bit for bit against
    # the direct one, the row band and the other staging scheme, then
    # against their twins at the gate
    say(13, tile_plan_line(ps, e13, st, ("pavelka_mass_sweep",
                                         "pavelka_momentum_entropy_sweep",
                                         "gamma_grad_sweep")))
    for fixed in (True, False):
        for fm in (False, True):
            c = dataclasses.replace(pcfg, fixed_diffusion=fixed, fast_math=fm)
            label = f"pavelka mass fixed_diffusion={fixed} fast_math={fm}"
            kern = [ps.pavelka_mass_pass(e13, st, c)]
            held = designs_equal(label, "pavelka_mass_sweep", e13, st, c, kern)
            err, scale = errs[f"pmass_fx{int(fixed)}_fm{int(fm)}"] = kernel_vs_twin(
                label, kern, [ps.pavelka_mass_pass(e13, st, c)],
                [ps.pavelka_mass_pass_plain(e13, st, c)], fm, scaled=True)
            say(13, f"pavelka mass kernel (tiled), fixed_diffusion={fixed} "
                    f"fast_math={fm}: bit for bit equal to {held}; vs twin max "
                    f"abs err {err:.3e} (max |Drho| {scale:.4e}, rel "
                    f"{err / scale:.3e})"
                    + ("" if fm else f", gate rtol {RTOL} atol {ATOL} x max")
                    + ", rerun bitwise equal")
    for fm in (False, True):
        c = dataclasses.replace(pcfg, fast_math=fm)
        kern = ps.pavelka_momentum_entropy_pass(e13, st, c)
        held = designs_equal(f"pavelka momentum + entropy fast_math={fm}",
                             "pavelka_momentum_entropy_sweep", e13, st, c, kern)
        rerun = ps.pavelka_momentum_entropy_pass(e13, st, c)
        twin = ps.pavelka_momentum_entropy_pass_plain(e13, st, c)
        err_dv, scale_dv = kernel_vs_twin(
            f"pavelka momentum fast_math={fm}", kern[:2], rerun[:2], twin[:2],
            fm, scaled=True)
        err_ds, scale_ds = kernel_vs_twin(
            f"pavelka entropy fast_math={fm}", kern[2:], rerun[2:], twin[2:],
            fm, scaled=True)
        errs[f"pmoment_fm{int(fm)}"] = (max(err_dv, err_ds), scale_dv)
        say(13, f"pavelka momentum + entropy kernel (tiled), fast_math={fm}: "
                f"bit for bit equal to {held}; vs twin Dv max abs err "
                f"{err_dv:.3e} (max |Dv| {scale_dv:.4f}, rel "
                f"{err_dv / scale_dv:.3e}); dS max abs err {err_ds:.3e} (max "
                f"|dS| {scale_ds:.4e}, rel {err_ds / scale_ds:.3e})"
                + ("" if fm else f", gate rtol {RTOL} atol {ATOL} x max")
                + ", rerun bitwise equal")
    # the packing's gradient (the self pair, an exact divide) runs the tiled
    # design too
    V0 = float((st.fields["m"][st.active] / st.fields["rho"][st.active]).mean())
    kern = ps.gamma_grad_pass(e13, st, V0)
    held = designs_equal("gamma_grad", "gamma_grad_sweep", e13, st, None, kern,
                         V0=V0)
    errs["gamma"] = kernel_vs_twin(
        "gamma_grad", kern, ps.gamma_grad_pass(e13, st, V0),
        ps.gamma_grad_pass_plain(e13, st, V0), fast=False, scaled=True)
    say(13, f"gamma_grad kernel (tiled), V0 {V0:.4e}, h varying: bit for bit "
            f"equal to {held}; vs twin max abs err {errs['gamma'][0]:.3e} (max "
            f"|gGamma| {errs['gamma'][1]:.4e}), gate rtol {RTOL} atol {ATOL} x "
            f"max, rerun bitwise equal")
    del st

    # 14: 8 small Pavelka steps, card against CPU twins
    gk, gc, rel, nk = small_steps(pv, pcfg, dev)
    say(14, f"pavelka_total_witch, n_rows=10, 8 steps: card u_avg/u_max {gk} "
            f"vs cpu twins {gc} (rel {rel:.2e}), active {nk} == {nk}")

    # 15: the Pavelka main path: its set-up (Colagrossi packing + initial
    # passes), then frames. The rescatters of the set-up are counted with
    # the opt-in bookkeeping field, which is dropped before the frames.
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counted = pv_state0.replace(_rescatter_count=torch.zeros(
        pv_state0.capacity, dtype=torch.float32, device=dev))
    packed, info = pv.setup(pcfg, e13, counted, return_info=True)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_counts = counters.read()
    setup_rescatters = int(packed.fields["_rescatter_count"].sum())
    packed = type(packed)(fields={k: v for k, v in packed.fields.items()
                                  if k != "_rescatter_count"},
                          active=packed.active)
    want = {k: 0 for k in COUNTED}
    want.update(gamma_grad_sweep=info["steps"] + 1, pavelka_mass_sweep=1,
                pavelka_momentum_entropy_sweep=1)
    if (setup_counts != want or not all_finite(packed)
            or int(packed.n) != n):
        raise AssertionError(f"pavelka set-up: counts {setup_counts}, expected "
                             f"{want}; finite {all_finite(packed)}; active "
                             f"{int(packed.n)}/{n}")
    say(15, f"pavelka set-up: Colagrossi packing {info['steps']} steps, "
            f"|gGamma| {info['res_g0']:.6e} -> {info['res_g']:.6e}, |v| "
            f"{info['res_v']:.4e}; with the initial passes {setup_s:.2f} s; "
            f"rescatters {setup_rescatters}; active {int(packed.n)}; launches "
            f"{ {k: v for k, v in setup_counts.items() if v} } ({card})")
    del pv_state0, counted
    pv_frame = frame_runner(pv.make_step(pcfg, e13), STEPS_PER_FRAME)
    pv_state, pv_ms, pv_counts, _, _ = drive(
        15, "pavelka main path", counters, pv_frame, packed, 2,
        {"pavelka_mass_sweep": steps, "pavelka_momentum_entropy_sweep": steps},
        card, n)
    h_act = pv_state.fields["h"][pv_state.active]
    say(15, f"pavelka after {steps} steps: active {int(pv_state.n)} of {n}; "
            f"max h / cell width {float(h_act.max()) / min(e13.cell_size):.4f}, "
            f"max h / pair cutoff {float(h_act.max()) / e13.h:.4f}, min h / h0 "
            f"{float(h_act.min()) / pcfg.h0:.4f} (the sweeps cut every pair at "
            f"the engine's cutoff h0, which no cell is narrower than); "
            f"rescatters in the {steps} steps: "
            f"{rescatters(pv_frame, packed, 3)}")
    if int(pv_state.n) != n:
        raise AssertionError(f"pavelka: active {int(pv_state.n)}/{n}")
    profile_steps(15, "pavelka", pv.make_step(pcfg, e13), packed,
                  table=profile)
    del packed

    # 16: run(out_path=...) on the card at a small size: the file set, the
    # last frame read back, and a resumed run against the uninterrupted one
    small = dataclasses.replace(cfg, n_rows=10, t_end=1.0, n_frames=2,
                                checkpoint_every=1)
    with tempfile.TemporaryDirectory() as tmp:
        whole_dir, part_dir = os.path.join(tmp, "whole"), os.path.join(tmp, "part")
        whole = w.run(small, out_path=whole_dir, device=dev)
        files = sorted(os.listdir(whole_dir))
        check_run_files("flagship", files,
                        ["checkpoint.npz", "data.csv", "frame0.vtp",
                         "frame1.vtp", "frame2.vtp", "result.pvd"],
                        ["velocities.pdf"])
        points, data = port_io.read_vtp(os.path.join(whole_dir, "frame2.vtp"))
        final = whole["state"]
        if not frame_equals_state(points, data, final, w.EXPORT_VARS):
            raise AssertionError("frame2.vtp differs from the final state")
        w.run(dataclasses.replace(small, t_end=0.5, n_frames=1),
              out_path=part_dir, device=dev)
        resumed = w.run(dataclasses.replace(
            small, resume=os.path.join(part_dir, "checkpoint.npz")),
            out_path=part_dir, device=dev)
        differing = [k for k, v in final.fields.items()
                     if not torch.equal(resumed["state"].fields[k], v)]
        same_files = same_outputs(part_dir, whole_dir, files)
        if (differing or not same_files
                or not torch.equal(resumed["state"].active, final.active)):
            raise AssertionError(f"resumed run differs: fields {differing}, "
                                 f"files equal {same_files}")
        say(16, f"run(out_path) on the card, n_rows=10: wrote {files}; "
                f"frame2.vtp read back equal to the {len(points)} active rows; "
                f"resumed run equals the uninterrupted one bit for bit "
                f"(state, frames and data.csv)")

    # 17: witch3d at the stretch size
    torch.cuda.reset_peak_memory_stats()
    wcfg = w3.stretch_config(bucket_cap=8, lazy_diagnostics=True,
                             fast_math=True)
    t0 = time.perf_counter()
    w3_sys = w3.make_system(wcfg)
    w3_state0 = w3_sys.freeze(device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    e17 = w3_sys.engine
    n3 = w3_sys.n_built
    occ_max = int(e17.resident(w3_state0.active)[:, :-1].sum(dim=0).max())
    got = {"n": n3, "lims": e17.lims, "cap": e17.cap}
    if got != W3D_EXPECT or int(w3_state0.n) != n3 or occ_max != 8:
        raise AssertionError(f"witch3d: shapes {got}, active "
                             f"{int(w3_state0.n)}, max occupancy {occ_max}; "
                             f"expected {W3D_EXPECT}, occupancy 8")
    say(17, f"witch3d built in {build_s:.2f} s (host): N={n3} lims={e17.lims} "
            f"cap={e17.cap} slots={e17.slots} max occupancy {occ_max}, 0 "
            f"dropped; h={e17.h:.1f} m dt={wcfg.dt:.4e} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # 18: a forced 3-D rescatter (27 offsets) must be the identity
    for label, e in (("all fields", dataclasses.replace(e17, persistent=())),
                     ("persistent", e17)):
        torch.cuda.reset_peak_memory_stats()
        out, dropped = e._stencil_rescatter(w3_state0)
        names = e.persistent or tuple(w3_state0.fields)
        bad = [k for k in names
               if not torch.equal(out.fields[k], w3_state0.fields[k])]
        if (int(dropped) != 0 or bad
                or not torch.equal(out.active, w3_state0.active)):
            raise AssertionError(f"3-D rescatter ({label}) not the identity: "
                                 f"dropped={int(dropped)} differing={bad}")
        del out
        ms = cuda_ms(lambda: e._stencil_rescatter(w3_state0), 1)
        say(18, f"forced 3-D rescatter ({label}): identical, 0 dropped; "
                f"{ms:.1f} ms per rescatter, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")

    # 19: the 3-D kernels (the tiled design) at full width on a live state:
    # bit for bit against the design they replaced and their twins
    say(19, tile_plan_line(ps, e17, w3_state0, ("density_sweep_3d",
                                                "momentum_sweep_3d")))
    st = perturbed(w3.make_step(wcfg, e17)(w3_state0), dev)

    got = [ps.density_pass(e17, st, wcfg)]
    designs_equal("density 3-D", "density_sweep_3d", e17, st, wcfg, got)
    errs["density_3d"] = exact("density 3-D", got,
                               [ps.density_pass(e17, st, wcfg)],
                               [ps.density_pass_plain(e17, st, wcfg)])
    say(19, f"3-D density kernel (tiled): bit for bit equal to the direct "
            f"design and the twin (max abs err "
            f"{errs['density_3d'][0]:.3e}, max |rho| "
            f"{errs['density_3d'][1]:.4f}), rerun bitwise equal")
    for fm in (False, True):
        c = dataclasses.replace(wcfg, fast_math=fm)
        got = ps.momentum_pass(e17, st, c)
        label = f"momentum 3-D fast_math={fm}"
        designs_equal(label, "momentum_sweep_3d", e17, st, c, got)
        rerun = ps.momentum_pass(e17, st, c)
        twin = ps.momentum_pass_plain(e17, st, c)
        err, scale = errs[f"momentum_3d_fm{int(fm)}"] = (
            kernel_vs_twin(label, got, rerun, twin, True, scaled=True) if fm
            else exact(label, got, rerun, twin))
        say(19, f"3-D momentum kernel (tiled), fast_math={fm}: bit for bit "
                f"equal to the direct design; "
                f"against the twin max abs err {err:.3e} (max |Dv| "
                f"{scale:.4e}, rel {err / scale:.3e}"
                + (", gate 1e-3" if fm else ", bit for bit") + "), rerun "
                "bitwise equal")
    del st

    # 20: witch3d set-up and main path
    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w3_ready = w3.setup(wcfg, e17, w3_state0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    w3_setup_counts = counters.read()
    want = {k: 0 for k in COUNTED}
    want.update(density_sweep=wcfg.renorm_iters)
    rho_sum = ps.density_pass(e17, w3_ready, wcfg)[w3_ready.active]
    ratio = float((rho_sum / w3_ready.fields["rho_bg"][w3_ready.active]).median())
    if (w3_setup_counts != want or abs(ratio - 1.0) > 1e-3
            or not all_finite(w3_ready) or int(w3_ready.n) != n3):
        raise AssertionError(f"witch3d set-up: counts {w3_setup_counts}, median "
                             f"rho/rho_bg {ratio}, active {int(w3_ready.n)}")
    say(20, f"witch3d set-up: {wcfg.renorm_iters} renormalisation iterations "
            f"(on the 3-D density kernel) in {setup_s:.2f} s; median summed "
            f"rho / rho_bg {ratio:.6f}; active {int(w3_ready.n)} ({card})")
    del w3_state0, rho_sum
    tiny = dict(n_rows=6, dom_length=60e3, dom_depth=10e3, bc_rows=3, eta=1.2,
                skin=0.15, renorm_iters=2, bucket_cap=None, fast_math=False)
    diag = {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        tcfg = dataclasses.replace(wcfg, **tiny)
        tsys = w3.make_system(tcfg)
        ts_ = tsys.freeze(device=where)
        ts_ = w3.setup(tcfg, tsys.engine, ts_)
        ts_ = frame_runner(w3.make_step(tcfg, tsys.engine), 6)(ts_)
        diag[label] = ([float(v) for v in velocity_diagnostics(ts_)], int(ts_.n))
    rel = max(abs(a - b) / abs(b) for a, b in zip(diag["card"][0], diag["cpu"][0]))
    if diag["card"][1] != diag["cpu"][1] or rel > 1e-5:
        raise AssertionError(f"witch3d small-input steps disagree: {diag}")
    say(20, f"witch3d n_rows=6, set-up + 6 steps: card u_avg/u_max "
            f"{diag['card'][0]} vs cpu twins {diag['cpu'][0]} (rel {rel:.2e}), "
            f"active {diag['card'][1]} == {diag['cpu'][1]}")
    w3_step = w3.make_step(wcfg, e17)
    w3_frame = frame_runner(w3_step, W3D_STEPS_PER_FRAME,
                            finalize=w3.make_finalize(wcfg))
    w3_steps = 3 * W3D_STEPS_PER_FRAME
    w3_state, _, w3_counts, _, u_max = drive(
        20, "witch3d main path", counters, w3_frame, w3_ready, 2,
        {"density_sweep": w3_steps, "momentum_sweep": w3_steps}, card, n3,
        steps_per_frame=W3D_STEPS_PER_FRAME)
    if int(w3_state.n) != n3 or not u_max < 0.01 * wcfg.c:
        raise AssertionError(f"witch3d: active {int(w3_state.n)}/{n3}, u_max "
                             f"{u_max} against c = {wcfg.c:.1f}")
    say(20, f"rescatters in the {w3_steps} witch3d steps: "
            f"{rescatters(w3_frame, w3_ready, 3)}; peak device memory so far "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_steps(20, "witch3d", w3_step, w3_state, table=profile)
    del w3_ready

    # 21: the dam-break kernels against their twins on live states at the
    # reference's sizes (collapse_dry: the dam_break bench cell)
    dams = {"collapse_dry": (cd, cd.Config(dr=0.014, dtype="float32",
                                           layout="bucket", skin=0.15,
                                           use_pallas=True)),
            "collapse3d": (c3, c3.Config(dtype="float32", layout="bucket",
                                         skin=0.15, use_pallas=True))}
    dam_sys, dam_state0 = {}, {}
    for name, (module, dcfg) in dams.items():
        suffix = "_3d" if module is c3 else ""
        t0 = time.perf_counter()
        dsys = module.make_system(dcfg)
        ds = dsys.freeze(device=dev)
        build_s = time.perf_counter() - t0
        de = dsys.engine
        dam_sys[name], dam_state0[name] = dsys, ds
        say(21, f"{name} built in {build_s:.2f} s: N={dsys.n_built} "
                f"lims={de.lims} cap={de.cap} slots={de.slots} h={de.h} "
                f"dt={dcfg.dt:.3e} s")
        gen = torch.Generator(device=dev).manual_seed(0)
        act = ds.active
        st = ds.replace(
            v=torch.where(act[:, None], torch.rand(
                ds.fields["v"].shape, generator=gen, device=dev) * 2 - 1, 0.0),
            rho=torch.where(act, ds.fields["rho"] * (0.99 + 0.02 * torch.rand(
                act.shape, generator=gen, device=dev)), 0.0),
            P=torch.where(act, torch.rand(act.shape, generator=gen,
                                          device=dev) * 5e3, 0.0))
        # the tiled design of both (2-D and 3-D): bit for bit against its
        # other designs and the twin
        say(21, tile_plan_line(ps, de, ds, [
            k + suffix for k in ("dambreak_mass_sweep",
                                 "dambreak_force_sweep")]))
        for kernel, what, scale_of, wrapper, twin_of in (
                ("dambreak_mass_sweep", "continuity", "Drho",
                 ps.dambreak_mass_pass, ps.dambreak_mass_pass_plain),
                ("dambreak_force_sweep", "force", "Dv",
                 ps.dambreak_force_pass, ps.dambreak_force_pass_plain)):
            kern, rerun, twin = (f(de, st, dcfg) for f in
                                 (wrapper, wrapper, twin_of))
            if kernel == "dambreak_mass_sweep":
                kern, rerun, twin = [kern], [rerun], [twin]
            label = f"{name} {what}"
            designs = designs_equal(label, kernel + suffix, de, st, dcfg, kern)
            err, scale = exact(label, kern, rerun, twin)
            held = f"bit for bit equal to {designs} and the twin"
            errs[kernel + suffix] = (err, scale)
            extra = ""
            if what == "force":
                wall = act & (st.fields["type"] == 1.0)
                if not all(bool((k[wall] == 0.0).all()) for k in kern):
                    raise AssertionError(f"{name}: force on WALL slots is "
                                         "not zero")
                extra = f"; {int(wall.sum())} WALL slots exactly 0"
            say(21, f"{label} kernel: {held} (max abs err {err:.3e}, max "
                    f"|{scale_of}| {scale:.4e}, rel {err / scale:.3e}), rerun "
                    f"bitwise equal{extra}")
            del kern, rerun, twin
        del st

    # 22: 8 small steps of each dam break, card against CPU twins
    def dam_steps(module, dcfg, where, n_steps):
        dsys = module.make_system(dcfg)
        ds = dsys.freeze(device=where)
        step = module.make_step(dcfg, dsys.engine)
        if module is cd:
            step, init_forces = step
            ds = init_forces(ds)
        ds = frame_runner(step, n_steps)(ds)
        speed = ds.fields["v"][ds.active].abs()
        return [float(speed.mean()), float(speed.max())], int(ds.n)

    for name, module, small in (
            ("collapse_dry", cd, dataclasses.replace(
                dams["collapse_dry"][1], dr=0.08, skin=0.2)),
            ("collapse3d", c3, dataclasses.replace(
                dams["collapse3d"][1], dr=2e-2, skin=0.2))):
        gk, nk = dam_steps(module, small, dev, 8)
        gc, nc = dam_steps(module, small, torch.device("cpu"), 8)
        rel = max(abs(a - b) / abs(b) for a, b in zip(gk, gc))
        if nk != nc or rel > 1e-5:
            raise AssertionError(f"{name}: small-input steps disagree: card "
                                 f"{gk} n={nk}, cpu {gc} n={nc}")
        say(22, f"{name}, dr={small.dr}, 8 steps: card mean/max |v| {gk} vs "
                f"cpu twins {gc} (rel {rel:.2e}), active {nk} == {nc}")

    # 23: the dam-break main paths
    dam_counts, dam_state, dam_ms = {}, {}, {}
    for name, (module, dcfg) in dams.items():
        de, ds, nd = dam_sys[name].engine, dam_state0[name], dam_sys[name].n_built
        step = module.make_step(dcfg, de)
        counters.reset()
        if module is cd:
            step, init_forces = step
            ds = init_forces(ds)
            init_counts = counters.read()
            if init_counts != {**{k: 0 for k in COUNTED},
                               "dambreak_force_sweep": 1}:
                raise AssertionError(f"init_forces: counts {init_counts}")

        def energy(s_):
            if module is cd:
                return float(cd.get_globals(dcfg, s_)[2])
            return float(c3.energy(dcfg, s_))

        e0 = energy(ds)
        dframe = frame_runner(step, STEPS_PER_FRAME)
        dam_state[name], dam_ms[name], dam_counts[name], _, u_max = drive(
            23, f"{name} main path", counters, dframe, ds, 1,
            {"dambreak_mass_sweep": 2 * STEPS_PER_FRAME,
             "dambreak_force_sweep": 2 * STEPS_PER_FRAME}, card, nd)
        e1 = energy(dam_state[name])
        if int(dam_state[name].n) != nd or not u_max < dcfg.c:
            raise AssertionError(f"{name}: active {int(dam_state[name].n)}/"
                                 f"{nd}, u_max {u_max}")
        say(23, f"{name}: E {e0:.6e} -> {e1:.6e} J after "
                f"{2 * STEPS_PER_FRAME} steps (rel "
                f"{abs(e1 / e0 - 1):.2e}); rescatters in them: "
                f"{rescatters(dframe, ds, 2)}")
        if module is c3 or profile:
            profile_steps(23, name, step, dam_state[name], table=profile)
    del dam_state0

    # 24: the terrain baseline (the bench_all terrain_flow cell), built as
    # run() builds it: capacity 1.3 N, stencil rescatter, slot-targeted
    # spawns
    tcfg = lw.terrain_baseline_config(use_pallas=True, fast_math=True)
    t0 = time.perf_counter()
    t_sys = lw.run_system(tcfg)
    t_state0 = t_sys.freeze(device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    e24 = t_sys.engine
    nt = t_sys.n_built
    got = {"n": nt, "lims": e24.lims, "cap": e24.cap}
    if (got != TERRAIN_EXPECT or int(t_state0.n) != nt
            or e24.effective_rescatter_mode != "stencil"):
        raise AssertionError(f"terrain: shapes {got}, active "
                             f"{int(t_state0.n)}, rescatter "
                             f"{e24.effective_rescatter_mode}; "
                             f"expected {TERRAIN_EXPECT}, stencil")
    say(24, f"terrain baseline built in {build_s:.2f} s (host): N={nt} "
            f"lims={e24.lims} cap={e24.cap} slots={e24.slots} h={e24.h:.2f} m "
            f"cells {e24.cell_size[0]:.2f} m dt={tcfg.dt:.4e} s; rescatter "
            f"{e24.effective_rescatter_mode}, spawn slot-targeted")
    # every particle already sits in its slot: the stencil rescatter is the
    # identity, and the sort rescatter places every row as it does
    for label, e in (("all fields", dataclasses.replace(e24, persistent=())),
                     ("persistent", e24)):
        out, dropped = e._stencil_rescatter(t_state0)
        by_sort, sort_dropped = e._full_rescatter(t_state0)
        names = e.persistent or tuple(t_state0.fields)
        bad = [k for k in names
               if not torch.equal(out.fields[k], t_state0.fields[k])]
        bad += [k for k in out.fields
                if not torch.equal(out.fields[k], by_sort.fields[k])]
        if (int(dropped) or int(sort_dropped) or bad
                or not torch.equal(out.active, t_state0.active)
                or not torch.equal(by_sort.active, t_state0.active)):
            raise AssertionError(f"terrain rescatters ({label}): dropped "
                                 f"{int(dropped)}/{int(sort_dropped)}, "
                                 f"differing {bad}")
        del out, by_sort
        ms = cuda_ms(lambda: e._stencil_rescatter(t_state0), 3)
        ms_sort = cuda_ms(lambda: e._full_rescatter(t_state0), 3)
        say(24, f"forced rescatters ({label}): stencil identical, sort equal "
                f"to it slot for slot, 0 dropped; stencil {ms:.2f} ms, sort "
                f"{ms_sort:.2f} ms per rescatter ({card})")

    # 25: the terrain kernels against their twins at full width on live
    # states (v, h perturbed from a seeded generator): the isothermal-flow
    # pair on the baseline after 50 steps, the others on their configs'
    # default sizes after one step. The sums cancel (Dv_y is about +g against
    # pressure terms), so the gate's atol is scaled by each output's
    # largest |value|.
    others = {
        "isothermal static": lw.isothermal_static_config(
            use_pallas=True, fast_math=True),
        "adiabatic static": lw.adiabatic_static_config(
            use_pallas=True, fast_math=True)}
    base = lw.adiabatic_flow_config(use_pallas=True, fast_math=True)
    others["adiabatic flow, corrected"] = dataclasses.replace(
        base, true_rayleigh=True, consistent_entropy=True,
        outflow_buffer=2 * base.h0, av_alpha=0.05)
    other_sys, other_state0 = {}, {}
    for label, ocfg in others.items():
        osys = lw.run_system(ocfg)
        other_sys[label], other_state0[label] = osys, osys.freeze(device=dev)
        oe = osys.engine
        say(25, f"{label} built: N={osys.n_built} lims={oe.lims} cap={oe.cap} "
                f"slots={oe.slots} dt={ocfg.dt:.4e} s; rescatter "
                f"{oe.effective_rescatter_mode}")
    live = {"terrain": (e24, perturbed(
        frame_runner(lw.make_step(tcfg, e24), 50)(t_state0), dev), tcfg)}
    for label in ("isothermal static", "adiabatic static"):
        oe = other_sys[label].engine
        live[label] = (oe, perturbed(lw.make_step(others[label], oe)(
            other_state0[label]), dev), others[label])
    cases = (  # (errs key, live state, wrapper, twin, divides)
        ("legacy_mass_sweep", "terrain", ps.legacy_mass_pass,
         ps.legacy_mass_pass_plain, False),
        ("legacy_force_sweep", "terrain", ps.legacy_force_pass,
         ps.legacy_force_pass_plain, True),
        ("iso_static_mass_sweep", "isothermal static", ps.iso_static_mass_pass,
         ps.iso_static_mass_pass_plain, False),
        ("iso_static_force_sweep", "isothermal static",
         ps.iso_static_force_pass, ps.iso_static_force_pass_plain, True),
        ("adia_density_pass", "adiabatic static", ps.adia_density_pass,
         ps.adia_density_pass_plain, False),
        ("adia_entropy_force_sweep", "adiabatic static",
         ps.adia_entropy_force_pass, ps.adia_entropy_force_pass_plain, True))
    # every terrain kernel runs the tiled design: the two forces each AV
    # form on its own plan, the fused adiabatic sweep both on one, the
    # adiabatic density on the density's export with the self pair and the
    # gated weight
    say(25, tile_plan_line(ps, e24, live["terrain"][1],
                           ("legacy_mass_sweep", "legacy_force_sweep no_av",
                            "legacy_force_sweep av")))
    say(25, tile_plan_line(ps, live["isothermal static"][0],
                           live["isothermal static"][1],
                           ("iso_static_mass_sweep",
                            "iso_static_force_sweep no_av",
                            "iso_static_force_sweep av")))
    say(25, tile_plan_line(ps, live["adiabatic static"][0],
                           live["adiabatic static"][1],
                           ("density_sweep adia",
                            "adia_entropy_force_sweep")))
    tiled = {"legacy_mass_sweep": "legacy_mass_sweep",  # key: tiled label
             "legacy_force_sweep": "legacy_force_sweep",
             "iso_static_mass_sweep": "iso_static_mass_sweep",
             "iso_static_force_sweep": "iso_static_force_sweep",
             "adia_entropy_force_sweep": "adia_entropy_force_sweep",
             "adia_density_pass": "density_sweep adia"}
    for key, where, kern, twin, divides in cases:
        e, st, base_cfg = live[where]
        variants = ((0.0, False), (0.0, True), (0.05, False),
                    (0.05, True)) if divides else ((0.0, False),)
        for av, fm in variants:
            c = dataclasses.replace(base_cfg, av_alpha=av, fast_math=fm)
            as_list = (lambda o: o if isinstance(o, list) else [o])
            label = f"{key} av={av} fast_math={fm}"
            got = as_list(kern(e, st, c))
            held = ""
            if key in tiled:
                name, _, kw = tiled_label(tiled[key])
                held = (" (tiled), bit for bit equal to "
                        + designs_equal(label, name, e, st, c, got, **kw))
            err, scale = kernel_vs_twin(
                label, got, as_list(kern(e, st, c)), as_list(twin(e, st, c)),
                fm, scaled=True)
            errs[f"{key}_av{int(av > 0)}_fm{int(fm)}"] = (err, scale)
            say(25, f"{key} kernel{held}; vs twin on the {where} state, "
                    f"av_alpha={av} fast_math={fm}: max abs err {err:.3e} "
                    f"(max |out| {scale:.4e}, rel {err / scale:.3e})"
                    + ("" if fm else f", gate rtol {RTOL} atol {ATOL} x max")
                    + ", rerun bitwise equal")
    del live

    # 26: 8 small steps of each terrain variant, card against CPU twins
    for label, small in (("isothermal flow", tcfg),
                         *((k, v) for k, v in others.items())):
        gk, gc, rel, nk = small_steps(lw, small, dev)
        say(26, f"{label}, n_rows=10, 8 steps: card u_avg/u_max {gk} vs cpu "
                f"twins {gc} (rel {rel:.2e}), active {nk} == {nk}")

    # 27: the terrain main path, long enough to cross an inflow spawn event
    # (the boot inflow column converts after ~380 steps)
    t_step = lw.make_step(tcfg, e24)
    t_frame = frame_runner(t_step, TERRAIN_STEPS_PER_FRAME)
    t_steps = 3 * TERRAIN_STEPS_PER_FRAME
    n_inflow0 = int(lw.inflow_reservoir(t_state0)["n_inflow"])
    with SpawnEvents(lw) as spawns:
        t_state, t_ms, t_counts, u_avg, u_max = drive(
            27, "terrain main path", counters, t_frame, t_state0, 2,
            {"legacy_mass_sweep": t_steps, "legacy_force_sweep": t_steps},
            card, nt, steps_per_frame=TERRAIN_STEPS_PER_FRAME)
    res = lw.inflow_reservoir(t_state)
    force = {k: float(v) for k, v in lw.mountain_force(t_state).items()}
    if (spawns.count < 1 or not all(map(math.isfinite, force.values()))
            or not math.isfinite(u_max)):
        raise AssertionError(f"terrain: spawn events {spawns.count}, "
                             f"force {force}, u_max {u_max}")
    say(27, f"terrain after {t_steps} steps: {spawns.count} spawn events, "
            f"spawn_drops {int(res['spawn_drops'])}, INFLOW rows {n_inflow0} "
            f"-> {int(res['n_inflow'])}, active {nt} -> {int(t_state.n)}; "
            f"drag {force['drag']:.6e} N/m, lift {force['lift']:.6e} N/m; "
            f"u_avg {u_avg:.4e} u_max {u_max:.4e} m/s; rescatters in the "
            f"{t_steps} steps: {rescatters(t_frame, t_state0, 3)} ({card})")
    if profile:
        profile_steps(27, "terrain", t_step, t_state)

    # 28: one frame of each other terrain variant at its config's default
    # size (the adiabatic flow with the corrected bundle: Rayleigh sponge,
    # consistent entropy, OUTFLOW buffer, AV)
    other_state, other_counts = {}, {}
    for label, ocfg in others.items():
        o_frame = frame_runner(lw.make_step(ocfg, other_sys[label].engine), 50)
        kernels = (("iso_static_mass_sweep", "iso_static_force_sweep")
                   if not ocfg.adiabatic
                   else ("adia_density_pass", "adia_entropy_force_sweep"))
        other_state[label], _, other_counts[label], _, _ = drive(
            28, label, counters, o_frame, other_state0[label], 1,
            {k: 100 for k in kernels}, card, other_sys[label].n_built,
            steps_per_frame=50)
    del other_state0
    # the adiabatic density and the fused adiabatic sweep once more, on the
    # corrected adiabatic flow's final state: cap 16, TX 16 (the template at
    # another cap than phase 25's 8)
    label = "adiabatic flow, corrected"
    oe, ost, ocfg = other_sys[label].engine, other_state[label], others[label]
    say(28, tile_plan_line(ps, oe, ost, ("density_sweep adia",
                                         "adia_entropy_force_sweep")))
    kern = [ps.adia_density_pass(oe, ost, ocfg)]
    held = designs_equal(f"adia_density_pass on the {label} state",
                         "density_sweep", oe, ost, ocfg, kern, adiabatic=True)
    err, scale = errs["adia_density_cap16"] = kernel_vs_twin(
        "adia_density_pass cap 16", kern, [ps.adia_density_pass(oe, ost, ocfg)],
        [ps.adia_density_pass_plain(oe, ost, ocfg)], False, scaled=True)
    say(28, f"adia_density_pass kernel (tiled) on the {label} state (cap "
            f"{oe.cap}): bit for bit equal to {held}; vs twin max abs err "
            f"{err:.3e} (max |rho| {scale:.4e}), gate rtol {RTOL} atol {ATOL} "
            f"x max, rerun bitwise equal")
    got = ps.adia_entropy_force_pass(oe, ost, ocfg)
    held = designs_equal(f"adia_entropy_force_pass on the {label} state",
                         "adia_entropy_force_sweep", oe, ost, ocfg, got)
    err, scale = errs["adia_entropy_force_cap16"] = kernel_vs_twin(
        "adia_entropy_force_pass cap 16", got,
        ps.adia_entropy_force_pass(oe, ost, ocfg),
        ps.adia_entropy_force_pass_plain(oe, ost, ocfg), ocfg.fast_math,
        scaled=True)
    say(28, f"adia_entropy_force_pass kernel (tiled) on the {label} state "
            f"(cap {oe.cap}, av_alpha={ocfg.av_alpha} fast_math="
            f"{ocfg.fast_math}): bit for bit equal to {held}; vs twin max abs "
            f"err {err:.3e} (max |out| {scale:.4e}, rel {err / scale:.3e}), "
            f"rerun bitwise equal")
    del got

    # 29: run(out_path=...) of a small flow config on the card through a
    # spawn event, a checkpoint every frame: the file set, the data.csv
    # columns, and a resumed run against the uninterrupted one, bit for bit
    small = lw.isothermal_flow_config(
        n_rows=12, dom_length=51.9e3, h_m=2000.0, a=6e3, use_pallas=True,
        fast_math=True, checkpoint_every=1, n_frames=2)
    small = dataclasses.replace(small, t_end=24 * small.dt)
    with tempfile.TemporaryDirectory() as tmp:
        whole_dir = os.path.join(tmp, "whole")
        part_dir = os.path.join(tmp, "part")
        whole = lw.run(small, out_path=whole_dir, device=dev)
        files = sorted(os.listdir(whole_dir))
        columns = list(port_io.read_csv(os.path.join(whole_dir, "data.csv")))
        check_run_files("terrain", files,
                        ["checkpoint.npz", "data.csv", "frame0.vtp",
                         "frame1.vtp", "frame2.vtp", "result.pvd"],
                        ["velocities.pdf"])
        if (columns != ["t", "u_avg", "u_max", "drag", "lift",
                               "n_inflow", "spawn_drops"]
                or not int(whole["state"].n) > whole["system"].n_built):
            raise AssertionError(f"terrain run(out_path) wrote {files}, "
                                 f"columns {columns}, active "
                                 f"{int(whole['state'].n)}")
        lw.run(dataclasses.replace(small, t_end=small.t_end / 2, n_frames=1),
               out_path=part_dir, device=dev)
        resumed = lw.run(dataclasses.replace(
            small, resume=os.path.join(part_dir, "checkpoint.npz")),
            out_path=part_dir, device=dev)
        final = whole["state"]
        differing = [k for k, v in final.fields.items()
                     if not torch.equal(resumed["state"].fields[k], v)]
        same_files = same_outputs(part_dir, whole_dir, files)
        if (differing or not same_files
                or not torch.equal(resumed["state"].active, final.active)):
            raise AssertionError(f"terrain resumed run differs: fields "
                                 f"{differing}, files equal {same_files}")
        say(29, f"terrain run(out_path) on the card, n_rows=12, 24 steps: "
                f"wrote {files}, data.csv {columns}; active "
                f"{whole['system'].n_built} -> {int(final.n)} (a spawn "
                f"event); resumed run equals the uninterrupted one bit for "
                f"bit (state, frames and data.csv)")

    # 31-33: the ISPH and Rayleigh–Bénard baselines (run before the timing
    # phase, which times their kernels on their main paths' final states)
    icfg, e31, i_state, i_counts, i_its = isph_phase(dev, card, counters, errs,
                                                     profile)
    rcfg, e32, r_state, r_counts = rb_phase(dev, card, counters, errs, profile)
    full_runs_phase(dev)
    # 34: the dam break against the Violeau curve
    violeau_phase(dev, card)
    # 35-39: the flat layout and float64
    flat_phases(dev, card, counters)
    # 40-43: the 3-D schemes on the flat layout and the flat pressure solves
    solve_and_3d_flat_phases(dev, card, counters)
    # 44-45: the terrain family flat and in float64, and RKPM conduction
    terrain_and_rkpm_phases(dev, card, counters)

    # 30: kernel and twin times on prepared inputs, beside their bounds
    def prepared(kernel, e, s, c):
        """(kernel launch, twin call, pair-count call) on planes and the
        trip bound prepared once from state s (the twin reads only the
        bound's largest value, the same per tile as per row)."""
        band = ps._trip_bound(kernel.split()[0], e, s)
        d = e.dim
        f32 = ps.ctypes.c_float
        if kernel in ("density_sweep", "density_sweep_3d"):
            planes, pads = ps._density_inputs(e, s, s.fields["m"])
            args, body, n_out, self_pair = (
                [1, f32(ps.C_W2 if d == 2 else ps.C_W3)],
                ps._density_body(d), 1, True)
        elif kernel in ("momentum_sweep", "momentum_sweep_3d"):
            planes, pads = ps._momentum_inputs(e, s, c)
            args, body, n_out, self_pair = (
                ps._momentum_scalars(c, d) + [1], ps._momentum_body(c, d), d,
                False)
        elif kernel.startswith("dambreak_mass_sweep"):
            planes, pads = ps._dambreak_mass_inputs(e, s)
            kc, hinv = ps._dambreak_consts(c, d)
            args, body, n_out, self_pair = (
                [f32(kc), f32(hinv), f32(2.0 * c.nu)],
                ps._dambreak_mass_body(c, d), 1, False)
        elif kernel.startswith("dambreak_force_sweep"):
            planes, pads = ps._dambreak_force_inputs(e, s)
            kc, hinv = ps._dambreak_consts(c, d)
            args, body, n_out, self_pair = (
                [f32(kc), f32(hinv), f32(2.0 * c.mu / c.rho0**2)],
                ps._dambreak_force_body(c, d), d, False)
        elif kernel in ("legacy_mass_sweep", "iso_static_mass_sweep"):
            adaptive = kernel.startswith("iso")
            planes, pads = (ps._iso_static_mass_inputs(e, s) if adaptive
                            else ps._legacy_mass_inputs(e, s))
            args, body, n_out, self_pair = (
                ps._legacy_mass_scalars(c, d, adaptive),
                ps._legacy_mass_body(c, d, adaptive), 1, False)
        elif kernel in ("legacy_force_sweep", "iso_static_force_sweep"):
            adaptive = kernel.startswith("iso")
            planes, pads = ps._legacy_force_inputs(e, s, c, adaptive)
            args, body, n_out, self_pair = (
                ps._legacy_force_scalars(c, d, adaptive),
                ps._legacy_force_body(c, d, adaptive), d, False)
            planes_k = ps._legacy_force_planes(planes, c)
            # each tiled terrain force takes the plan of its form
            plan = ps._tile_plan(e, ps._staged(kernel, bool(c.av_alpha)))
            return (lambda: ps._launch(kernel, e, planes_k, band, n_out, args,
                                       plan),
                    lambda: ps._sweep_plain(e, planes, pads, band, body, n_out,
                                            self_pair),
                    lambda: ps._sweep_plain(e, planes, pads, band,
                                            lambda p, q, r2, m: [m], 1,
                                            self_pair))
        elif kernel == "adia_entropy_force_sweep":
            planes, pads = ps._adia_entropy_force_inputs(e, s)
            args, body, n_out, self_pair = (
                ps._adia_entropy_force_scalars(c, d),
                ps._adia_entropy_force_body(c, d), 1 + d, False)
        elif kernel == "density_sweep adia":
            planes, pads = ps._density_inputs(e, s,
                                              ps._adia_density_weight(s, c))
            args, body, n_out, self_pair = (
                [1, f32(ps.C_W2)], ps._density_body(d), 1, True)
            return (lambda: ps._launch("density_sweep", e, planes, band,
                                       n_out, args),
                    lambda: ps._sweep_plain(e, planes, pads, band, body, n_out,
                                            self_pair),
                    lambda: ps._sweep_plain(e, planes, pads, band,
                                            lambda p, q, r2, m: [m], 1,
                                            self_pair))
        elif kernel == "isph_div_visc_sweep":
            planes, pads = ps._isph_div_visc_inputs(e, s)
            args, body, n_out, self_pair = (
                ps._isph_scalars(c), ps._isph_div_visc_body(c, d), 5, False)
        elif kernel == "isph_grad_sweep":
            planes, pads = ps._isph_grad_inputs(e, s)
            args, body, n_out, self_pair = (
                ps._isph_scalars(c), ps._isph_grad_body(c, d), 2, False)
        elif kernel == "isph_matvec_sweep":
            # the main path's form: prepared once, one launch per call on the
            # iterate (the first solve's P), no allocation
            planes, pads = ps._isph_matvec_inputs(e, s)
            it = s.fields["P"].contiguous()
            mv = ps.isph_matvec_prepared(e, s, c)
            body = ps._isph_matvec_body(c, d)
            planes = planes + [ps._plane(e, it)]
            return (lambda: mv(it),
                    lambda: ps._sweep_plain(e, planes, pads, band, body, 1,
                                            False),
                    lambda: ps._sweep_plain(e, planes, pads, band,
                                            lambda p, q, r2, m: [m], 1,
                                            False))
        elif kernel == "rb_mass_heat_sweep":
            planes, pads = ps._rb_mass_heat_inputs(e, s, c)
            kc, hinv, twokap = ps._rb_consts(c, d)
            args, body, n_out, self_pair = (
                [f32(kc), f32(hinv), f32(twokap)], ps._rb_mass_heat_body(c, d),
                2, False)
        elif kernel == "pressure_sweep":
            planes, pads = ps._pressure_inputs(e, s, c)
            args, body, n_out, self_pair = ([1, ps.ctypes.c_float(ps.C_W2)],
                                            ps._pressure_body, 1, True)
        elif kernel == "pavelka_mass_sweep":
            planes, pads = ps._pavelka_mass_inputs(e, s, c)
            args, body, n_out, self_pair = (
                ps._pavelka_mass_scalars(c), ps._pavelka_mass_body(c), 1, False)
        elif kernel == "pavelka_momentum_entropy_sweep":
            planes, pads = ps._pavelka_momentum_entropy_inputs(e, s, c)
            args, body, n_out, self_pair = (
                ps._pavelka_momentum_entropy_scalars(c),
                ps._pavelka_momentum_entropy_body(c), 3, False)
        elif kernel == "gamma_grad_sweep":
            planes, pads = ps._gamma_grad_inputs(e, s)
            args, body, n_out, self_pair = (
                ps._gamma_grad_scalars(V0), ps._gamma_grad_body(V0), 2, True)
        else:
            split = kernel.endswith("split")
            planes, pads = ps._hopkins_inputs(e, s, c, split)
            planes_k, args = ps._hopkins_launch_inputs(e, s, c, split)
            body, n_out, self_pair = ps._hopkins_body(c, split), 2, False
            plan = ps._tile_plan(e, ps._staged("hopkins_momentum_sweep",
                                               split))
            return (lambda: ps._launch("hopkins_momentum_sweep", e, planes_k,
                                       band, n_out, args, plan),
                    lambda: ps._sweep_plain(e, planes, pads, band, body, n_out,
                                            self_pair),
                    lambda: ps._sweep_plain(e, planes, pads, band,
                                            lambda p, q, r2, m: [m], 1,
                                            self_pair))
        # the exported name without "_3d": _launch appends it by engine.dim
        return (lambda: ps._launch(kernel.removesuffix("_3d"), e, planes, band,
                                   n_out, args),
                lambda: ps._sweep_plain(e, planes, pads, band, body, n_out,
                                        self_pair),
                lambda: ps._sweep_plain(e, planes, pads, band,
                                        lambda p, q, r2, m: [m], 1, self_pair))

    def candidates(e, s, self_pair):
        """Occupied q slots in the stencil cells of every occupied p slot:
        the distance tests this state needs (q = p left out unless the sweep
        includes the self pair)."""
        counts = e.grid_view(s.active).sum(dim=0).double()
        padded = torch.nn.functional.pad(counts, (1, 1) * e.dim)
        around = torch.zeros_like(counts)
        for off in e.stencil:
            around += padded[tuple(slice(1 + o, 1 + o + n) for o, n in
                                   zip(reversed(off), counts.shape))]
        total = int((counts * around).sum().item())
        return total if self_pair else total - int(counts.sum().item())

    timing = {}
    ISO, ADIA = "isothermal static", "adiabatic static"
    iso_e, adia_e = other_sys[ISO].engine, other_sys[ADIA].engine
    dry_cfg, c3_cfg = dams["collapse_dry"][1], dams["collapse3d"][1]
    dry_e, c3_e = dam_sys["collapse_dry"].engine, dam_sys["collapse3d"].engine
    for kernel, e, s, c in (
            ("density_sweep", eng, flag_state, cfg),
            ("momentum_sweep", eng, flag_state, cfg),
            ("pressure_sweep", e8, fh_state, cfg),
            ("hopkins_momentum_sweep split", e8, fh_state, cfg),
            ("hopkins_momentum_sweep total", e11, ht_state, cfg),
            ("pavelka_mass_sweep", e13, pv_state, pcfg),
            ("pavelka_momentum_entropy_sweep", e13, pv_state, pcfg),
            ("gamma_grad_sweep", e13, pv_state, pcfg),
            ("density_sweep_3d", e17, w3_state, wcfg),
            ("momentum_sweep_3d", e17, w3_state, wcfg),
            ("dambreak_mass_sweep", dry_e, dam_state["collapse_dry"], dry_cfg),
            ("dambreak_force_sweep", dry_e, dam_state["collapse_dry"], dry_cfg),
            ("dambreak_mass_sweep_3d", c3_e, dam_state["collapse3d"], c3_cfg),
            ("dambreak_force_sweep_3d", c3_e, dam_state["collapse3d"], c3_cfg),
            ("legacy_mass_sweep", e24, t_state, tcfg),
            ("legacy_force_sweep", e24, t_state, tcfg),
            ("iso_static_mass_sweep", iso_e, other_state[ISO], others[ISO]),
            ("iso_static_force_sweep", iso_e, other_state[ISO], others[ISO]),
            ("adia_entropy_force_sweep", adia_e, other_state[ADIA],
             others[ADIA]),
            ("density_sweep adia", adia_e, other_state[ADIA], others[ADIA]),
            ("isph_div_visc_sweep", e31, i_state, icfg),
            ("isph_matvec_sweep", e31, i_state, icfg),
            ("isph_grad_sweep", e31, i_state, icfg),
            ("rb_mass_heat_sweep", e32, r_state, rcfg)):
        launch, twin, count = prepared(kernel, e, s, c)
        km, (dm, recorded), pm = (cuda_ms(launch, 50), kernel_ms(launch, 50),
                                  cuda_ms(twin, 5))
        pairs = int(count()[0].double().sum().item())
        name = kernel.split()[0]
        tested = candidates(e, s, name in ("density_sweep", "pressure_sweep",
                                           "gamma_grad_sweep",
                                           "density_sweep_3d"))
        if c is not None and getattr(c, "av_alpha", 0.0):
            raise AssertionError(f"{kernel}: timed with the AV term on")
        n_in, n_out = PLANES[name]
        if kernel.endswith("total"):
            n_in -= 2
        body_ops = BODY_OPS[name] - (HOPKINS_SPLIT_OPS
                                     if kernel.endswith("total") else 0)
        ops = tested * DIST_OPS[e.dim] + pairs * body_ops
        # what the state needs: the occupancy plane, the other input planes
        # at the occupied slots, every output slot, the trip bound
        occupied = int(s.active.sum())
        nbytes = (e.slots + (n_in - 1) * occupied + n_out * e.slots) * 4 + (
            ps._trip_bound(name, e, s).numel() * 4)
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
        timing[kernel] = {"ms": km, "device_ms": dm, "plain_ms": pm,
                          "bound_ms": max(bytes_ms, ops_ms),
                          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        bound = timing[kernel]["bound_ms"]
        own = ("not measured: torch.profiler recorded no kernel in "
               "3 sessions of 50 more calls" if dm is None else
               f"{dm:.4f} ms of kernel time, torch.profiler over 50 more "
               f"calls, {recorded} kernels recorded")
        own_share = ("" if dm is None else
                     f" ({100 * bound / dm:.1f} % of the kernel time)")
        say(30, f"{kernel}: kernel {km:.4f} ms (events; {own}), plain twin "
                f"{pm:.4f} ms; bound {bound * 1e3:.1f} us ({nbytes / 1e6:.1f} "
                f"MB -> {bytes_ms * 1e3:.1f} us; {tested} candidates x "
                f"{DIST_OPS[e.dim]} + {pairs} pairs x {body_ops} ops -> "
                f"{ops_ms * 1e3:.1f} us), {100 * bound / km:.1f} % of it"
                f"{own_share} ({card})")

    # the tiled sweeps against the design they replaced, in turns on one
    # card (the 2-D ones with their other staging scheme too)
    for kernel, e, s, c in (
            ("density_sweep", eng, flag_state, cfg),
            ("density_sweep adia", adia_e, other_state[ADIA], others[ADIA]),
            ("gamma_grad_sweep", e13, pv_state, None),
            ("momentum_sweep", eng, flag_state, cfg),
            ("pressure_sweep", e8, fh_state, cfg),
            ("hopkins_momentum_sweep split", e8, fh_state, cfg),
            ("hopkins_momentum_sweep total", e11, ht_state, cfg),
            ("pavelka_mass_sweep", e13, pv_state, pcfg),
            ("pavelka_momentum_entropy_sweep", e13, pv_state, pcfg),
            ("legacy_mass_sweep", e24, t_state, tcfg),
            ("legacy_force_sweep no_av", e24, t_state, tcfg),
            ("legacy_force_sweep av", e24, t_state,
             dataclasses.replace(tcfg, av_alpha=0.05)),
            ("iso_static_force_sweep no_av", iso_e, other_state[ISO],
             others[ISO]),
            ("iso_static_force_sweep av", iso_e, other_state[ISO],
             dataclasses.replace(others[ISO], av_alpha=0.05)),
            ("iso_static_mass_sweep", iso_e, other_state[ISO], others[ISO]),
            ("adia_entropy_force_sweep no_av", adia_e, other_state[ADIA],
             others[ADIA]),
            ("adia_entropy_force_sweep av", adia_e, other_state[ADIA],
             dataclasses.replace(others[ADIA], av_alpha=0.05)),
            ("isph_matvec_sweep", e31, i_state, icfg),
            ("isph_div_visc_sweep", e31, i_state, icfg),
            ("isph_grad_sweep", e31, i_state, icfg),
            ("dambreak_mass_sweep", dry_e, dam_state["collapse_dry"], dry_cfg),
            ("dambreak_force_sweep", dry_e, dam_state["collapse_dry"], dry_cfg),
            ("rb_mass_heat_sweep", e32, r_state, rcfg),
            ("density_sweep_3d", e17, w3_state, wcfg),
            ("momentum_sweep_3d", e17, w3_state, wcfg),
            ("dambreak_mass_sweep_3d", c3_e, dam_state["collapse3d"], c3_cfg),
            ("dambreak_force_sweep_3d", c3_e, dam_state["collapse3d"],
             c3_cfg)):
        say(30, tile_plan_line(ps, e, s, (kernel,)) + " (the timed state)")
        name, _, kw = tiled_label(kernel)
        if name == "gamma_grad_sweep":  # phase 13's V0, as in its row above
            kw = {"V0": V0}
        runs = ps.tiled_yardsticks(name, e, s, c, **kw)
        # the terrain forces' and the fused adiabatic sweep's AV forms have
        # no row of their own: the main path's bound (without the AV term's
        # operations) stands beside them
        bound = timing[kernel if kernel in timing else name]["bound_ms"]
        other = tuple(n for n in runs
                      if n not in ("tiled", "tiled_row_band", "direct"))
        order = ("direct", "tiled", *other, "tiled_row_band",
                 "tiled_row_band", *other, "tiled", "direct")
        ms = [cuda_ms(runs[name], 50) for name in order]
        say(30, f"{kernel} in turns: " + ", ".join(
            f"{name} {t:.4f} ms ({100 * bound / t:.1f} % of the "
            f"{bound * 1e3:.1f} us bound)" for name, t in zip(order, ms))
            + f" ({card})")
        # each design's own kernel time, beside the event times above
        own = {name: kernel_ms(run, 50)[0] for name, run in runs.items()}
        say(30, f"{kernel} kernel time (torch.profiler, 50 launches each): "
                + ", ".join(f"{name} " + ("not measured" if t is None else
                                          f"{t:.4f} ms ({100 * bound / t:.1f}"
                                          " % of the bound)")
                            for name, t in own.items()) + f" ({card})")
        del runs

    # the ISPH matvec's one library counterpart: a CSR sparse product
    lib_ms, lib_err, nnz = matvec_library(e31, i_state, icfg)
    library_ms = {"isph_matvec_sweep": lib_ms}
    say(30, f"isph_matvec_sweep library yardstick: CSR A @ P ({nnz} nonzeros, "
            f"assembled once, not timed) {lib_ms:.4f} ms against the kernel's "
            f"{timing['isph_matvec_sweep']['ms']:.4f} ms; max abs err "
            f"{lib_err:.3e} (rtol 1e-5) ({card})")
    steps31 = len(i_its)
    say(30, f"launches per step on the main paths: isph_div_visc_sweep "
            f"{i_counts['isph_div_visc_sweep'] / steps31:g}, isph_grad_sweep "
            f"{i_counts['isph_grad_sweep'] / steps31:g}, isph_matvec_sweep "
            f"{i_counts['isph_matvec_sweep'] / steps31:.2f} (mean cg_it + 1), "
            f"rb_mass_heat_sweep and its dambreak_force_sweep "
            f"{r_counts['rb_mass_heat_sweep'] / (3 * RB_STEPS_PER_FRAME):g} and "
            f"{r_counts['dambreak_force_sweep'] / (3 * RB_STEPS_PER_FRAME):g}")

    launches = {"density_sweep": flag_counts["density_sweep"],
                "momentum_sweep": flag_counts["momentum_sweep"],
                "pressure_sweep": fh_counts["pressure_sweep"],
                "hopkins_momentum_sweep": fh_counts["hopkins_momentum_sweep"],
                "pavelka_mass_sweep": pv_counts["pavelka_mass_sweep"],
                "pavelka_momentum_entropy_sweep":
                    pv_counts["pavelka_momentum_entropy_sweep"],
                "gamma_grad_sweep": setup_counts["gamma_grad_sweep"],
                "density_sweep_3d": w3_counts["density_sweep"],
                "momentum_sweep_3d": w3_counts["momentum_sweep"],
                "dambreak_mass_sweep":
                    dam_counts["collapse_dry"]["dambreak_mass_sweep"],
                "dambreak_force_sweep":
                    dam_counts["collapse_dry"]["dambreak_force_sweep"],
                "dambreak_mass_sweep_3d":
                    dam_counts["collapse3d"]["dambreak_mass_sweep"],
                "dambreak_force_sweep_3d":
                    dam_counts["collapse3d"]["dambreak_force_sweep"],
                "legacy_mass_sweep": t_counts["legacy_mass_sweep"],
                "legacy_force_sweep": t_counts["legacy_force_sweep"],
                "iso_static_mass_sweep":
                    other_counts[ISO]["iso_static_mass_sweep"],
                "iso_static_force_sweep":
                    other_counts[ISO]["iso_static_force_sweep"],
                "adia_entropy_force_sweep":
                    other_counts[ADIA]["adia_entropy_force_sweep"],
                **{k: i_counts[k] for k in ("isph_div_visc_sweep",
                                            "isph_matvec_sweep",
                                            "isph_grad_sweep")},
                "rb_mass_heat_sweep": r_counts["rb_mass_heat_sweep"]}
    err_of = {"density_sweep": max(errs["density_self1"][0],
                                   errs["density_self0"][0]),
              "momentum_sweep": errs["momentum_fm1"][0],
              "pressure_sweep": max(errs["pressure_self1"][0],
                                    errs["pressure_self0"][0]),
              "hopkins_momentum_sweep": max(errs["hopkins_s1_fm1"][0],
                                            errs["hopkins_s0_fm1"][0]),
              "pavelka_mass_sweep": errs["pmass_fx1_fm1"][0],
              "pavelka_momentum_entropy_sweep": errs["pmoment_fm1"][0],
              "gamma_grad_sweep": errs["gamma"][0],
              "density_sweep_3d": errs["density_3d"][0],
              "momentum_sweep_3d": errs["momentum_3d_fm1"][0],
              **{k: errs[k][0] for k in KERNELS if k.startswith("dambreak")},
              "legacy_mass_sweep": errs["legacy_mass_sweep_av0_fm0"][0],
              "legacy_force_sweep": errs["legacy_force_sweep_av0_fm1"][0],
              "iso_static_mass_sweep":
                  errs["iso_static_mass_sweep_av0_fm0"][0],
              "iso_static_force_sweep":
                  errs["iso_static_force_sweep_av0_fm1"][0],
              "adia_entropy_force_sweep":
                  errs["adia_entropy_force_sweep_av0_fm1"][0],
              **{k: errs[k][0] for k in ("isph_div_visc_sweep",
                                         "isph_matvec_sweep",
                                         "isph_grad_sweep")},
              "rb_mass_heat_sweep": max(
                  errs["rb_mass_heat_sweep"][0],
                  errs["rb_mass_heat_sweep adiabatic"][0])}
    timed_as = {"hopkins_momentum_sweep": "hopkins_momentum_sweep split"}
    say("end", f"the whole run: {time.perf_counter() - run_t0:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": err_of[k],
         **timing[timed_as.get(k, k)], "library_ms": library_ms.get(k)}
        for k in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main(profile="--profile" in sys.argv[1:])
    except Exception as exc:  # report, then fail without an ok line
        import traceback
        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        sys.exit(1)
