#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port's mountain-wave flagship.

Drives ``sph_mountain_waves_tpu_torch`` (never JAX) on one CUDA card at the
bench configuration (2-D WCSPH perturbed mountain wave, n_rows=246:
N=978,463 particles, f32, bucket layout, lattice cells, fast_math) through
the entry points a user calls: make_system -> freeze -> make_step ->
frame_runner -> velocity_diagnostics.

Phases, each printing one line:
  1. the card (nvidia-smi name and power limit);
  2. build of the CUDA kernels from csrc/ (nvcc, sm_90a);
  3. flagship build and shape checks;
  4. a forced rescatter of the frozen state, which must be the identity;
  5. each kernel against its plain PyTorch twin at full size (fast_math off
     and on), plus bitwise-equal reruns;
  6. a small-input check: 8 kernel steps on the card against 8 steps of the
     plain twins on the CPU;
  7. the main path: 1 warm-up frame and 2 timed frames of 100 steps, with
     the kernels' launch counters read around them.
Then one JSON line of per-kernel results and, last, the ok line.

Exits non-zero, printing no ok line, on any failure or without a card.

Usage: python3 chip_smoke.py [--profile]
  --profile  also print a torch.profiler table of 10 main-path steps
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

N_ROWS = 246
EXPECT = {"n": 978_463, "lims": (1792, 144), "cap": 8}
STEPS_PER_FRAME = 100
RTOL, ATOL = 1e-5, 1e-6


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
    """Max abs/rel error of got against ref; raises past the gate."""
    import torch
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if gate:
        torch.testing.assert_close(got, ref, rtol=rtol, atol=atol, msg=name)
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

    from sph_mountain_waves_tpu_torch.models import wcsph_perturbed_witch as w
    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.models.witch_common import (
        WitchConfig, velocity_diagnostics,
    )
    from sph_mountain_waves_tpu_torch.ops import _build
    from sph_mountain_waves_tpu_torch.ops import pair_sweeps as ps

    b = _build.build("pair_sweep")
    _build.load("pair_sweep")
    ptxas = " | ".join(ln.strip() for ln in b.log.splitlines()
                       if "registers" in ln or "spill" in ln)
    say(2, f"built {b.path.name} in {b.seconds:.2f} s; ptxas: {ptxas}")

    cfg = WitchConfig(n_rows=N_ROWS, dtype="float32", self_density=True,
                      layout="bucket", skin=0.15, use_pallas=True,
                      lazy_diagnostics=True, lattice_cells=True,
                      fast_math=True)
    t0 = time.perf_counter()
    system = w.make_system(cfg)
    state0 = system.freeze(device=dev)
    torch.cuda.synchronize()
    eng = system.engine
    n = system.n_built
    got = {"n": n, "lims": eng.lims, "cap": eng.cap}
    if got != EXPECT or int(state0.n) != n:
        raise AssertionError(f"flagship shapes {got}, active {int(state0.n)}; "
                             f"expected {EXPECT}")
    say(3, f"flagship built in {time.perf_counter() - t0:.2f} s: N={n} "
           f"lims={eng.lims} cap={eng.cap} slots={eng.slots} h={eng.h:.2f} m "
           f"dt={cfg.dt:.4e} s")

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

    # 5: kernels against twins on a live state: one step in, then v
    # perturbed by ±1 m/s and h by ±1 % from a seeded generator
    gen = torch.Generator(device=dev).manual_seed(0)
    st = w.make_step(cfg, eng)(state0)
    act = st.active
    dv = torch.rand(st.fields["v"].shape, generator=gen, device=dev) * 2 - 1
    dh = torch.rand(st.fields["h"].shape, generator=gen, device=dev) * 0.02 - 0.01
    st = st.replace(v=torch.where(act[:, None], st.fields["v"] + dv, 0.0),
                    h=torch.where(act, st.fields["h"] * (1 + dh), 0.0))
    errs = {}
    rho_k = ps.density_pass(eng, st, cfg)
    if not torch.equal(rho_k, ps.density_pass(eng, st, cfg)):
        raise AssertionError("density kernel reruns differ")
    errs["density"] = compare("density", rho_k, ps.density_pass_plain(eng, st, cfg))
    say(5, f"density kernel vs twin: max abs err {errs['density'][0]:.3e} "
           f"(max |rho| {errs['density'][1]:.4f}), rerun bitwise equal")
    for fm in (False, True):
        c = dataclasses.replace(cfg, fast_math=fm)
        kern = ps.momentum_pass(eng, st, c)
        if not all(torch.equal(a, b) for a, b in zip(kern, ps.momentum_pass(eng, st, c))):
            raise AssertionError(f"momentum kernel reruns differ (fast_math={fm})")
        twin = ps.momentum_pass_plain(eng, st, c)
        e = [compare(f"momentum[{a}] fast_math={fm}", kern[a], twin[a], gate=not fm)
             for a in range(2)]
        err, scale = max(x[0] for x in e), max(x[1] for x in e)
        if fm and not err <= 1e-3 * scale:
            raise AssertionError(f"fast_math momentum error {err} vs scale {scale}")
        errs[f"momentum_fm{int(fm)}"] = (err, scale)
        say(5, f"momentum kernel vs twin, fast_math={fm}: max abs err {err:.3e} "
               f"(max |Dv| {scale:.4f}, rel {err / scale:.3e})"
               + ("" if fm else f", gate rtol {RTOL} atol {ATOL}")
               + ", rerun bitwise equal")

    # 6: small input, 8 steps: kernels on the card against the plain twins
    # on the CPU (the path the tier-1 tests hold to the JAX package)
    small = dataclasses.replace(cfg, n_rows=10, fast_math=False)
    diag = {}
    for where, use_kernels in ((dev, True), (torch.device("cpu"), False)):
        c = dataclasses.replace(small, use_pallas=use_kernels)
        sysm = w.make_system(c)
        s = sysm.freeze(device=where)
        s = frame_runner(w.make_step(c, sysm.engine), 8)(s)
        diag[where.type] = ([float(v) for v in velocity_diagnostics(s)], int(s.n))
    (gk, nk), (gc, nc) = diag["cuda"], diag["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(gk, gc)]
    if nk != nc or max(rel) > 1e-5:
        raise AssertionError(f"small-input steps disagree: card {gk} n={nk}, "
                             f"cpu {gc} n={nc}")
    say(6, f"n_rows=10, 8 steps: card u_avg/u_max {gk} vs cpu twins {gc} "
           f"(rel {max(rel):.2e}), active {nk} == {nc}")

    # 7: the main path
    step = w.make_step(cfg, eng)
    run_frame = frame_runner(step, STEPS_PER_FRAME, finalize=w.make_finalize(cfg))
    ps.density_pass.launches = 0
    ps.momentum_pass.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run_frame(state0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    frame_s = []
    for _ in range(2):
        t0 = time.perf_counter()
        state = run_frame(state)
        u_avg, u_max = (float(v) for v in velocity_diagnostics(state))
        frame_s.append(time.perf_counter() - t0)
    launches = {"density_sweep": ps.density_pass.launches,
                "momentum_sweep": ps.momentum_pass.launches}
    steps = 3 * STEPS_PER_FRAME
    if any(v != steps for v in launches.values()):
        raise AssertionError(f"launch counts {launches}, expected {steps} each")
    n_act = int(state.n)
    finite = all(bool(torch.isfinite(t[state.active]).all())
                 for t in state.fields.values())
    if not finite or n_act != n or not u_max < 10.0:
        raise AssertionError(f"main path: finite={finite} active={n_act}/{n} "
                             f"u_max={u_max}")
    ms_step = 1e3 * sum(frame_s) / (2 * STEPS_PER_FRAME)
    say(7, f"main path: warm-up frame {warm_s:.2f} s; 2 x {STEPS_PER_FRAME} steps "
           f"in {sum(frame_s):.3f} s = {ms_step:.3f} ms/step = "
           f"{n * 2 * STEPS_PER_FRAME / sum(frame_s):.4e} particle-steps/s "
           f"at N={n} ({card}); u_avg {u_avg:.4e} u_max {u_max:.4e} m/s; "
           f"active {n_act}; launches {launches}")

    # kernel and twin times on the final state, inputs prepared once
    timings = {}
    band, _ = ps.row_kmax(eng, state)
    dplanes, dpads = ps._density_inputs(eng, state, state.fields["m"])
    mplanes, mpads = ps._momentum_inputs(eng, state, cfg)
    momentum_scalars = [ps.ctypes.c_float(ps._rdw_const(2)),
                        ps.ctypes.c_float(cfg.eps), ps.ctypes.c_float(-cfg.alpha),
                        ps.ctypes.c_float(cfg.beta), 1]
    timings["density_sweep"] = (
        cuda_ms(lambda: ps._launch("density_sweep", eng, dplanes, band, 1,
                                   [1, ps.ctypes.c_float(ps.C_W2)]), 50),
        cuda_ms(lambda: ps._sweep_plain(eng, dplanes, dpads, band,
                                        ps._density_body, 1, True), 5))
    timings["momentum_sweep"] = (
        cuda_ms(lambda: ps._launch("momentum_sweep", eng, mplanes, band, 2,
                                   momentum_scalars), 50),
        cuda_ms(lambda: ps._sweep_plain(eng, mplanes, mpads, band,
                                        ps._momentum_body(cfg), 2, False), 5))
    for k, (km, pm) in timings.items():
        say(7, f"{k}: kernel {km:.4f} ms, plain twin {pm:.4f} ms ({card})")
    # rescatter cadence of the same 300 steps, counted on a rerun with the
    # opt-in bookkeeping field (kept out of the timed run)
    s = state0.replace(_rescatter_count=torch.zeros(
        state0.capacity, dtype=torch.float32, device=dev))
    for _ in range(3):
        s = run_frame(s)
    say(7, f"rescatters in the {steps} main-path steps: "
           f"{int(s.fields['_rescatter_count'].sum())}")

    if profile:
        from torch.profiler import ProfilerActivity, profile as tprof
        with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            s = state
            for _ in range(10):
                s = step(s)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

    src = "sph_mountain_waves_tpu_torch/csrc/pair_sweep.cu"
    replaces = {"density_sweep": "sph_mountain_waves_tpu/ops/pallas_pairs.py:715",
                "momentum_sweep": "sph_mountain_waves_tpu/ops/pallas_pairs.py:751"}
    err_of = {"density_sweep": errs["density"][0],
              "momentum_sweep": errs["momentum_fm1"][0]}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": launches[k], "max_abs_err": err_of[k],
         "ms": timings[k][0], "plain_ms": timings[k][1]}
        for k in ("density_sweep", "momentum_sweep")]}))
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
