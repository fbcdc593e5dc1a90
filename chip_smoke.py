#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: the WCSPH mountain-wave flagship and
the three pressure–entropy (Hopkins) schemes.

Drives ``sph_mountain_waves_tpu_torch`` (never JAX) on one CUDA card at the
bench configuration (2-D mountain wave, n_rows=246: N=978,463 particles,
f32, bucket layout, lattice cells, skin 0.15, self_density, fast_math)
through the entry points a user calls: make_system -> freeze -> make_step ->
frame_runner -> velocity_diagnostics (and, for hopkins_total, its packing
setup).

Phases, each printing one or more lines:
  1. the card (nvidia-smi name and power limit);
  2. build of the CUDA kernels from csrc/ (nvcc, sm_90a), with ptxas
     registers and spills of every instantiation;
  3. flagship build and shape checks;
  4. a forced rescatter of the frozen state, which must be the identity;
  5. the flagship's kernels against their plain PyTorch twins at full size
     (fast_math off and on), plus bitwise-equal reruns;
  6. a small-input check: 8 flagship kernel steps on the card against 8
     steps of the plain twins on the CPU;
  7. the flagship main path: 1 warm-up frame and 2 timed frames of 100
     steps, with the kernels' launch counters set to 0 before and read after;
  8. the Hopkins kernels against their twins at full size on a live full
     Hopkins state: pressure, and the Hopkins momentum with the background
     split on and off, fast_math off and on; reruns bitwise equal;
  9. 8 small steps of each Hopkins scheme, card against CPU twins;
 10. the full Hopkins main path: 1 warm-up and 2 timed frames of 100 steps;
 11. hopkins_total: its hydrostatic packing at full size, then 1 warm-up and
     1 timed frame;
 12. hopkins_perturbed: 1 frame of 100 steps;
 13. every kernel timed on prepared inputs (CUDA events, kernel over 50 runs,
     twin over 5) beside its bound.
Then the card line, one JSON line of per-kernel results and, last, the ok
line.

Exits non-zero, printing no ok line, on any failure or without a card.

Usage: python3 chip_smoke.py [--profile]
  --profile  also print torch.profiler tables of 10 flagship steps (after
             the timed frames) and 10 full Hopkins steps (from the built
             state), with the device time per step
"""
from __future__ import annotations

import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time

N_ROWS = 246
EXPECT = {"n": 978_463, "lims": (1792, 144), "cap": 8}
STEPS_PER_FRAME = 100
RTOL, ATOL = 1e-5, 1e-6
KERNELS = ("density_sweep", "momentum_sweep", "pressure_sweep",
           "hopkins_momentum_sweep")
SOURCE = "sph_mountain_waves_tpu_torch/csrc/pair_sweep.cu"
REPLACES = {k: f"sph_mountain_waves_tpu/ops/pallas_pairs.py:{line}"
            for k, line in zip(KERNELS, (715, 751, 722, 806))}
# One H100 SXM at its 700 W limit (NVIDIA's data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Arithmetic operations per pair inside the cutoff (each +, -, *, /, sqrt
# and max one; compares and selects not counted), read off the bodies in
# csrc/pair_sweep.cu: 5 for the distance, the rest for the body and the
# accumulation. The Hopkins momentum without the split does 7 fewer.
OPS_PER_PAIR = {"density_sweep": 5 + 14, "momentum_sweep": 5 + 42,
                "pressure_sweep": 5 + 17, "hopkins_momentum_sweep": 5 + 76}
HOPKINS_SPLIT_OPS = 7
# planes in (occupancy included) and out, each [cap, C+1] f32
PLANES = {"density_sweep": (5, 1), "momentum_sweep": (10, 2),
          "pressure_sweep": (5, 1), "hopkins_momentum_sweep": (13, 2)}


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
    """'kernel: N regs, S B spill stores, L B spill loads' per instantiation,
    from nvcc's -Xptxas -v output (names demangled where a demangler is
    installed)."""
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
            rows.append((name, f"{m.group(1)} regs, {spill}"))
            name, spill = None, ""
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(n for n, _ in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        # void <unnamed>::pair_sweep<<unnamed>::Hopkins<(bool)1, (bool)0>,
        # (bool)0>(...) -> pair_sweep<Hopkins<1, 0>, 0>
        tidy = [re.sub(r"<unnamed>::|\(anonymous namespace\)::|\(bool\)|^void ",
                       "", d).split("(")[0] for d in names]
        rows = [(t or n, r) for t, (n, r) in zip(tidy, rows)]
    return rows


class Counters:
    """The four sweep wrappers' launch counters."""

    def __init__(self, ps):
        self.wrappers = dict(zip(KERNELS, (
            ps.density_pass, ps.momentum_pass, ps.pressure_pass,
            ps.hopkins_momentum_pass)))

    def reset(self):
        for w in self.wrappers.values():
            w.launches = 0

    def read(self):
        return {k: w.launches for k, w in self.wrappers.items()}


def all_finite(state):
    import torch
    return all(bool(torch.isfinite(t[state.active]).all())
               for t in state.fields.values())


def drive(phase, label, counters, run_frame, state, n_timed, expect, card, n):
    """The main path of one scheme: counters set to 0, 1 warm-up frame and
    ``n_timed`` timed frames, counters read. Raises unless each kernel was
    launched exactly ``expect[kernel]`` times (0 for the others) and every
    value is finite. Returns (state, ms/step, counts, u_avg, u_max)."""
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
    want = {k: expect.get(k, 0) for k in KERNELS}
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected {want}")
    if not all_finite(state):
        raise AssertionError(f"{label}: non-finite values")
    ms = 1e3 * sum(frame_s) / (n_timed * STEPS_PER_FRAME)
    say(phase, f"{label}: warm-up frame {warm_s:.2f} s; {n_timed} x "
               f"{STEPS_PER_FRAME} steps in {sum(frame_s):.3f} s = {ms:.3f} "
               f"ms/step = {n * n_timed * STEPS_PER_FRAME / sum(frame_s):.4e} "
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


def profile_steps(phase, label, step, state, n_steps=10):
    """torch.profiler table of n_steps steps, and the device time per step
    (the CUDA kernels' self time, as the table's footer sums it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprof
    with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            state = step(state)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA
                    and not e.is_user_annotation)
    print(events.table(sort_by="self_cuda_time_total", row_limit=25))
    say(phase, f"{label} profile: device time {device_us / n_steps / 1e3:.3f} "
               f"ms/step over {n_steps} steps")


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


def kernel_vs_twin(label, kern, rerun, twin, fast):
    """Kernel outputs against the twin's: the gate with exact divides, 1e-3
    of max |out| with fast_math; reruns bitwise. Returns (err, scale)."""
    import torch
    if not all(torch.equal(a, b) for a, b in zip(kern, rerun)):
        raise AssertionError(f"{label}: kernel reruns differ")
    e = [compare(f"{label}[{a}]", k, t, gate=not fast)
         for a, (k, t) in enumerate(zip(kern, twin))]
    err, scale = max(x[0] for x in e), max(x[1] for x in e)
    if fast and not err <= 1e-3 * scale:
        raise AssertionError(f"{label}: fast_math error {err} vs scale {scale}")
    return err, scale


def main(profile: bool) -> None:
    import torch
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

    from sph_mountain_waves_tpu_torch.models import (
        full_hopkins_perturbed_witch as fh, hopkins_perturbed_witch as hp,
        hopkins_total_witch as ht, wcsph_perturbed_witch as w,
    )
    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.models.witch_common import WitchConfig
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
    # step in, then v and h perturbed from a seeded generator
    st = perturbed(w.make_step(cfg, eng)(state0), dev)
    errs = {}
    errs["density"] = kernel_vs_twin(
        "density", [ps.density_pass(eng, st, cfg)],
        [ps.density_pass(eng, st, cfg)], [ps.density_pass_plain(eng, st, cfg)],
        fast=False)
    say(5, f"density kernel vs twin: max abs err {errs['density'][0]:.3e} "
           f"(max |rho| {errs['density'][1]:.4f}), rerun bitwise equal")
    for fm in (False, True):
        c = dataclasses.replace(cfg, fast_math=fm)
        err, scale = errs[f"momentum_fm{int(fm)}"] = kernel_vs_twin(
            f"momentum fast_math={fm}", ps.momentum_pass(eng, st, c),
            ps.momentum_pass(eng, st, c), ps.momentum_pass_plain(eng, st, c), fm)
        say(5, f"momentum kernel vs twin, fast_math={fm}: max abs err {err:.3e} "
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
    errs["pressure"] = kernel_vs_twin(
        "pressure", [ps.pressure_pass(e8, st, cfg)],
        [ps.pressure_pass(e8, st, cfg)], [ps.pressure_pass_plain(e8, st, cfg)],
        fast=False)
    say(8, f"pressure kernel vs twin: max abs err {errs['pressure'][0]:.3e} "
           f"(max |P root| {errs['pressure'][1]:.4f}), gate rtol {RTOL} "
           f"atol {ATOL}, rerun bitwise equal")
    for split in (True, False):
        for fm in (False, True):
            c = dataclasses.replace(cfg, fast_math=fm)
            err, scale = errs[f"hopkins_s{int(split)}_fm{int(fm)}"] = kernel_vs_twin(
                f"hopkins split={split} fast_math={fm}",
                ps.hopkins_momentum_pass(e8, st, c, split),
                ps.hopkins_momentum_pass(e8, st, c, split),
                ps.hopkins_momentum_pass_plain(e8, st, c, split), fm)
            say(8, f"hopkins momentum kernel vs twin, split={split} "
                   f"fast_math={fm}: max abs err {err:.3e} (max |Dv| "
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
    del packed

    # 12: hopkins_perturbed, one frame
    hp_sys, hp_state, build_s = build_full(hp, cfg, dev)
    counters.reset()
    t0 = time.perf_counter()
    hp_state = frame_runner(hp.make_step(cfg, hp_sys.engine),
                            STEPS_PER_FRAME)(hp_state)
    torch.cuda.synchronize()
    hp_counts = counters.read()
    want = {"density_sweep": STEPS_PER_FRAME, "momentum_sweep": STEPS_PER_FRAME,
            "pressure_sweep": STEPS_PER_FRAME, "hopkins_momentum_sweep": 0}
    if hp_counts != want or not all_finite(hp_state) or int(hp_state.n) != n:
        raise AssertionError(f"hopkins_perturbed: counts {hp_counts}, finite "
                             f"{all_finite(hp_state)}, active {int(hp_state.n)}")
    say(12, f"hopkins_perturbed: built in {build_s:.2f} s; {STEPS_PER_FRAME} "
            f"steps in {time.perf_counter() - t0:.2f} s (first frame, "
            f"warm-up included); active {int(hp_state.n)}; launches "
            f"{ {k: v for k, v in hp_counts.items() if v} }")
    del hp_state, hp_sys

    # 13: kernel and twin times on prepared inputs, beside their bounds
    def prepared(kernel, e, s, c):
        """(kernel launch, twin call, pair-count call) on planes prepared
        once from state s."""
        band, _ = ps.row_kmax(e, s)
        if kernel == "density_sweep":
            planes, pads = ps._density_inputs(e, s, s.fields["m"])
            args, body, n_out, self_pair = ([1, ps.ctypes.c_float(ps.C_W2)],
                                            ps._density_body, 1, True)
        elif kernel == "momentum_sweep":
            planes, pads = ps._momentum_inputs(e, s, c)
            args, body, n_out, self_pair = (
                ps._momentum_scalars(c) + [1], ps._momentum_body(c), 2, False)
        elif kernel == "pressure_sweep":
            planes, pads = ps._pressure_inputs(e, s, c)
            args, body, n_out, self_pair = ([1, ps.ctypes.c_float(ps.C_W2)],
                                            ps._pressure_body, 1, True)
        else:
            split = kernel.endswith("split")
            planes, pads = ps._hopkins_inputs(e, s, c, split)
            args, body, n_out, self_pair = (
                ps._momentum_scalars(c) + [int(split), 1],
                ps._hopkins_body(c, split), 2, False)
            planes_k = planes if split else planes + [None, None]
            return (lambda: ps._launch("hopkins_momentum_sweep", e, planes_k,
                                       band, n_out, args),
                    lambda: ps._sweep_plain(e, planes, pads, band, body, n_out,
                                            self_pair),
                    lambda: ps._sweep_plain(e, planes, pads, band,
                                            lambda p, q, r2, m: [m], 1,
                                            self_pair))
        return (lambda: ps._launch(kernel, e, planes, band, n_out, args),
                lambda: ps._sweep_plain(e, planes, pads, band, body, n_out,
                                        self_pair),
                lambda: ps._sweep_plain(e, planes, pads, band,
                                        lambda p, q, r2, m: [m], 1, self_pair))

    timing = {}
    for kernel, e, s in (("density_sweep", eng, flag_state),
                         ("momentum_sweep", eng, flag_state),
                         ("pressure_sweep", e8, fh_state),
                         ("hopkins_momentum_sweep split", e8, fh_state),
                         ("hopkins_momentum_sweep total", e11, ht_state)):
        launch, twin, count = prepared(kernel, e, s, cfg)
        km, pm = cuda_ms(launch, 50), cuda_ms(twin, 5)
        pairs = int(count()[0].double().sum().item())
        name = kernel.split()[0]
        n_in, n_out = PLANES[name]
        if kernel.endswith("total"):
            n_in -= 2
        ops = pairs * (OPS_PER_PAIR[name]
                       - (HOPKINS_SPLIT_OPS if kernel.endswith("total") else 0))
        nbytes = (n_in + n_out) * e.slots * 4 + e.lims[1] * 4
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S
        timing[kernel] = {"ms": km, "plain_ms": pm,
                          "bound_ms": max(bytes_ms, ops_ms),
                          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        say(13, f"{kernel}: kernel {km:.4f} ms, plain twin {pm:.4f} ms; bound "
                f"{timing[kernel]['bound_ms'] * 1e3:.1f} us ({nbytes / 1e6:.1f} MB "
                f"-> {bytes_ms * 1e3:.1f} us; {pairs} pairs x "
                f"{ops // max(pairs, 1)} ops -> {ops_ms * 1e3:.1f} us), "
                f"{100 * timing[kernel]['bound_ms'] / km:.1f} % of it ({card})")

    launches = {"density_sweep": flag_counts["density_sweep"],
                "momentum_sweep": flag_counts["momentum_sweep"],
                "pressure_sweep": fh_counts["pressure_sweep"],
                "hopkins_momentum_sweep": fh_counts["hopkins_momentum_sweep"]}
    err_of = {"density_sweep": errs["density"][0],
              "momentum_sweep": errs["momentum_fm1"][0],
              "pressure_sweep": errs["pressure"][0],
              "hopkins_momentum_sweep": max(errs["hopkins_s1_fm1"][0],
                                            errs["hopkins_s0_fm1"][0])}
    timed_as = {"hopkins_momentum_sweep": "hopkins_momentum_sweep split"}
    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
         "launches": launches[k], "max_abs_err": err_of[k],
         **timing[timed_as.get(k, k)], "library_ms": None}
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
