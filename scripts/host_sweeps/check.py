"""Build ``sph_mountain_waves_tpu_torch/csrc/pair_sweep.cu`` for the host
with g++ and hold its tiled sweeps (the 3-D dam-break and witch3d pairs,
the 2-D dam-break continuity and force, the Rayleigh–Bénard continuity +
conduction and its dam-break force with both sidewalls, the 2-D Pavelka
pair, the 2-D flagship density with and without the self pair and the
adiabatic density, the 2-D flagship momentum, the Hopkins pressure root
with and without the self pair, the Hopkins momentum in both forms, the
Colagrossi packing's gradient, the terrain continuity, the per-particle-h
(isothermal static) continuity, the terrain force and the per-particle-h
force, each with and without AV, the fused adiabatic entropy + force sweep
with and without AV, the ISPH CG matvec in its prepared form, the ISPH
divergence/viscous sweep and the ISPH pressure gradient) against the
one-thread-per-slot design they replaced,
against the tiled export on the row band (and, in 2-D, its other staging
scheme) and against the plain twins, bit for bit, on tiny states, through
the port's own wrappers (``ops/pair_sweeps.py``: the tile plan, the
per-tile trip bound, the export names and arguments).

    python scripts/host_sweeps/check.py            # every tiled sweep
    python scripts/host_sweeps/check.py pavelka    # the Pavelka pair only
    python scripts/host_sweeps/check.py momentum hopkins   # 2-D momenta, P root
    python scripts/host_sweeps/check.py legacy isph   # terrain pair, ISPH
    python scripts/host_sweeps/check.py iso   # per-particle-h pair
    python scripts/host_sweeps/check.py adia  # fused adiabatic sweep
    python scripts/host_sweeps/check.py density gamma  # densities, packing
    python scripts/host_sweeps/check.py dam2 rb dam   # dam pairs, RB

No card and no nvcc: the source is rewritten for g++ 12 (-std=c++20) with
the stand-in runtime ``cuda_runtime.h`` beside this file. A launch runs its
blocks one after another; the tiled sweeps (barriers, shared memory) run
one std::thread per CUDA thread and a std::barrier per block, the other
templates loop over their threads. ``cp.async`` becomes a plain copy (zero
for an out-of-grid cell) and its commit and wait no-ops; ``rcp.approx``
becomes a divide. The twins' ``torch.sqrt`` is replaced by NumPy's, which is
correctly rounded as the card's is. A tiled launch of the tiny collapse3d
(2,816 blocks of 240 threads) takes ~40 s.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT))

from sph_mountain_waves_tpu_torch.ops import _build, pair_sweeps as ps  # noqa: E402


def _sub(pat, rep, s, count, flags=0):
    n = len(re.findall(pat, s, flags))
    if n != count:
        raise RuntimeError(f"{pat!r}: {n} matches, expected {count}")
    return re.sub(pat, rep, s, flags=flags)


def host_source(src: str) -> str:
    """pair_sweep.cu rewritten for g++ and the stand-in runtime."""
    src = _sub(r'asm\("rcp\.approx\.ftz\.f32 %0, %1;" : "=f"\(r\) : "f"\(b\)\);',
               "r = 1.0f / b;", src, 1)
    src = _sub(r"(void cp_async4\(float\* dst, const float\* src,\s*bool valid\) \{).*?\n\}",
               r"\1\n  *dst = valid ? *src : 0.0f;\n}", src, 1, re.S)
    src = _sub(r"(void cp_async_commit\(\) \{).*?\n\}", r"\1}", src, 1, re.S)
    src = _sub(r"(void cp_async_wait\(\) \{).*?\n\}", r"\1}", src, 1, re.S)
    src = _sub(r"extern __shared__ float4 stage\[\];",
               "float4* stage = host_dyn_smem;", src, 2)
    src = _sub(r"__shared__ int cell_off\[[^\]]*\];",
               "int* cell_off = reinterpret_cast<int*>(host_static_smem);",
               src, 2)
    src = _sub(r"__syncthreads_or\(", "host_sync_or(", src, 2)
    src = _sub(r"__syncthreads\(\)", "host_sync()", src, 5)

    def launch(m):
        # launch3_tiled and launch_tiled name their kernel "kernel": the ones
        # with barriers
        threaded = "true" if m.group(1) == "kernel" else "false"
        return f"host_launch({threaded}, {m.group(1)}, {m.group(2)}, "
    return _sub(r"(\w+(?:<[^<>;]*>)?)<<<(.*?)>>>\(", launch, src, 4, re.S)


def build() -> ctypes.CDLL:
    """Compile the host form into build/host/ (a directory git ignores) and
    load it with the exports' ctypes signatures."""
    out = ROOT / "build" / "host" / "pair_sweep_host.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cpp = out.with_suffix(".cpp")
    cpp.write_text(host_source((_build.CSRC / "pair_sweep.cu").read_text()))
    subprocess.run(["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-shared",
                    "-fPIC", "-pthread", "-I", str(HERE), "-o", str(out),
                    str(cpp)], check=True)
    lib = ctypes.CDLL(str(out))
    for fn, (argtypes, restype) in _build.SIGNATURES["pair_sweep"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def _perturbed(state, **ranges):
    """``state`` with each named field drawn uniformly from its range on the
    active rows (a ``scale`` entry multiplies the field instead), from a
    seeded NumPy generator."""
    rng = np.random.default_rng(0)
    act = state.active
    new = {}
    for name, (lo, hi, scale) in ranges.items():
        f = state.fields[name]
        r = torch.from_numpy(rng.uniform(lo, hi, f.shape).astype(np.float32))
        val = f * r if scale else r
        mask = act[:, None] if f.ndim == 2 else act
        new[name] = torch.where(mask, val, 0.0)
    return state.replace(**new)


def held(kernel, engine, state, cfg, twin, **kw) -> bool:
    """The tiled launch bit for bit against every other design
    (``tiled_yardsticks``: the direct one, the row band, the other 2-D
    staging scheme; raises otherwise); returns whether it also equals the
    twin bit for bit. ``kw``: ``tiled_yardsticks``' keywords (the Hopkins
    momentum's ``background_split``, the density's ``adiabatic``, the
    packing gradient's ``V0``)."""
    runs = ps.tiled_yardsticks(kernel, engine, state, cfg, **kw)
    t0 = time.perf_counter()
    tiled = runs.pop("tiled")()
    secs = time.perf_counter() - t0
    for name, run in runs.items():
        if not all(torch.equal(a, b) for a, b in zip(tiled, run())):
            raise AssertionError(f"{kernel}: the tiled design differs from "
                                 f"{name}")
    ref = twin(engine, state, cfg)
    ref = ref if isinstance(ref, list) else [ref]
    same = all(torch.equal(a, b) for a, b in zip(tiled, ref))
    bound = ps._trip_bound(kernel, engine, state)
    form = "".join(f" {k}={v}" for k, v in kw.items()) + (
        f" av_alpha={cfg.av_alpha}"
        if kernel in ("legacy_force_sweep", "iso_static_force_sweep",
                      "adia_entropy_force_sweep") else
        f" sidewalls={cfg.sidewalls}" if hasattr(cfg, "sidewalls") else
        f" self_pair={cfg.self_density}"
        if kernel in ("pressure_sweep", "density_sweep")
        and not kw.get("adiabatic") else "")
    fast = "" if cfg is None else f" fast_math={ps._fast(cfg)}"
    print(f"{kernel}{form}{fast}, lims {engine.lims}, "
          f"cap {engine.cap}: tiled == "
          f"{', '.join(runs)}; tiled == twin {same}; max |out| "
          f"{max(float(a.abs().max()) for a in tiled):.4e}; "
          f"{int((bound > 0).sum())} of {bound.numel()} tiles with a non-zero "
          f"bound; tiled launch {secs:.1f} s", flush=True)
    return same


def main(which) -> None:
    lib = build()
    _build.load = lambda name: lib
    torch.cuda.current_stream = lambda device=None: types.SimpleNamespace(
        cuda_stream=0)
    torch.sqrt = lambda x: torch.from_numpy(np.sqrt(x.numpy()))
    torch.set_num_threads(1)
    ok = True
    if "dam" in which:
        from sph_mountain_waves_tpu_torch.models import collapse3d as c3
        cfg = c3.Config(dr=2e-2, dtype="float32", layout="bucket", skin=0.2,
                        use_pallas=True)
        system = c3.make_system(cfg)
        state = _perturbed(system.freeze(device="cpu"), v=(-1, 1, False),
                           rho=(0.99, 1.01, True), P=(0, 5e3, False))
        for kernel, twin in (
                ("dambreak_mass_sweep_3d", ps.dambreak_mass_pass_plain),
                ("dambreak_force_sweep_3d", ps.dambreak_force_pass_plain)):
            ok &= held(kernel, system.engine, state, cfg, twin)
    if "dam2" in which:
        from sph_mountain_waves_tpu_torch.models import collapse_dry as cd
        # the tiny collapse_dry of the card's small steps (dr 0.08) and the
        # card's timed state (dr 0.014: 11,702 particles, 128 x 64 cells);
        # cap 24 (the engine's own) in both: TX 10, a ragged last tile of 8
        for dr, skin in ((0.08, 0.2), (0.014, 0.15)):
            cfg = cd.Config(dr=dr, dtype="float32", layout="bucket",
                            skin=skin, use_pallas=True)
            system = cd.make_system(cfg)
            state = _perturbed(system.freeze(device="cpu"), v=(-1, 1, False),
                               rho=(0.99, 1.01, True), P=(0, 5e3, False))
            for kernel, twin in (
                    ("dambreak_mass_sweep", ps.dambreak_mass_pass_plain),
                    ("dambreak_force_sweep", ps.dambreak_force_pass_plain)):
                ok &= held(kernel, system.engine, state, cfg, twin)
    if "rb" in which:
        import dataclasses
        from sph_mountain_waves_tpu_torch.models import rayleigh_benard as rb
        # n_rows 16 at its own cap 16 (TX 16 on 128 x-cells) and at cap 24
        # (TX 10, a ragged last tile of 8), and the baseline (n_rows 160: cap
        # 16, 256 x 80 cells); each after one step, with both sidewalls: the
        # continuity + conduction and the force
        for n_rows, cap in ((16, None), (16, 24), (160, None)):
            for sidewalls in ("conducting", "adiabatic"):
                cfg = rb.baseline_config(n_rows=n_rows, sidewalls=sidewalls,
                                         skin=0.2 if n_rows < 160 else 0.15)
                system = rb.make_system(cfg)
                if cap:
                    system.freeze_opts["cap"] = cap
                state = system.freeze(device="cpu")
                state = rb.make_step(cfg, system.engine)(state)
                state = _perturbed(state, v=(-1, 1, False),
                                   T=(0.99, 1.01, True))
                for kernel, twin in (
                        ("rb_mass_heat_sweep", ps.rb_mass_heat_pass_plain),
                        ("dambreak_force_sweep",
                         ps.dambreak_force_pass_plain)):
                    ok &= held(kernel, system.engine, state, cfg, twin)
    if "witch" in which:
        from sph_mountain_waves_tpu_torch.models import witch3d as w3
        for cap in (None, 24):
            cfg = w3.Witch3DConfig(
                n_rows=6, dom_length=60e3, dom_depth=10e3, bc_rows=3,
                self_density=True, eta=1.2, dtype="float32", layout="bucket",
                lattice_cells=True, skin=0.15, use_pallas=True,
                renorm_iters=2, bucket_cap=cap)
            system = w3.make_system(cfg)
            state = _perturbed(system.freeze(device="cpu"), v=(-1, 1, False),
                               P_p=(-50, 50, False))
            for kernel, twin in (
                    ("density_sweep_3d", ps.density_pass_plain),
                    ("momentum_sweep_3d", ps.momentum_pass_plain)):
                ok &= held(kernel, system.engine, state, cfg, twin)
    if "pavelka" in which:
        import dataclasses
        from sph_mountain_waves_tpu_torch.models import (
            pavelka_total_witch as pv,
        )
        # cap 8: TX 32 on 128 x-cells; cap 24: TX 10, a ragged last tile of 8
        for cap in (None, 24):
            cfg = pv.PavelkaConfig(
                n_rows=10, dtype="float32", self_density=True,
                layout="bucket", skin=0.15, use_pallas=True,
                lattice_cells=True, bucket_cap=cap)
            system = pv.make_system(cfg)
            state = _perturbed(system.freeze(device="cpu"), v=(-1, 1, False),
                               h=(0.99, 1.01, True), rho=(0.99, 1.01, True),
                               P=(0.99, 1.01, True), T=(0.99, 1.01, True))
            for fm in (False, True):
                for fixed in (True, False):
                    c = dataclasses.replace(cfg, fast_math=fm,
                                            fixed_diffusion=fixed)
                    ok &= held("pavelka_mass_sweep", system.engine, state, c,
                               ps.pavelka_mass_pass_plain) or fm
                c = dataclasses.replace(cfg, fast_math=fm)
                ok &= held("pavelka_momentum_entropy_sweep", system.engine,
                           state, c, ps.pavelka_momentum_entropy_pass_plain
                           ) or fm
    if "density" in which:
        import dataclasses
        from sph_mountain_waves_tpu_torch.models import (
            legacy_witch as lw, wcsph_perturbed_witch as w,
        )
        from sph_mountain_waves_tpu_torch.models.witch_common import (
            WitchConfig,
        )
        # the tiny flagship state, h varied; cap 8: TX 32 on 128 x-cells;
        # cap 24: TX 10, a ragged last tile of 8. The density has no divide:
        # one form, with the self pair or without it
        for cap in (None, 24):
            cfg = WitchConfig(n_rows=10, dtype="float32", self_density=True,
                              layout="bucket", skin=0.15, use_pallas=True,
                              lazy_diagnostics=True, lattice_cells=True,
                              bucket_cap=cap)
            system = w.make_system(cfg)
            state = _perturbed(system.freeze(device="cpu"),
                               h=(0.99, 1.01, True), m=(0.99, 1.01, True))
            for self_pair in (True, False):
                ok &= held("density_sweep", system.engine, state,
                           dataclasses.replace(cfg, self_density=self_pair),
                           ps.density_pass_plain)
        # the adiabatic density (the self pair, the FLUID-gated weight; m
        # on every row under the corrected bundle's OUTFLOW buffer) on the
        # tiny adiabatic flow: cap 16, TX 16 on 128 x-cells
        terrain = dict(n_rows=14, dom_length=40e3, h_m=2000.0, a=6e3,
                       dtype="float32", layout="bucket", skin=0.15,
                       use_pallas=True)
        for extra in ({}, dict(true_rayleigh=True, consistent_entropy=True,
                               outflow_buffer=2 * 1.8 * (26e3 / 14),
                               av_alpha=0.05)):
            cfg = lw.adiabatic_flow_config(**terrain, **extra)
            system = lw.make_system(cfg)
            state = _perturbed(system.freeze(device="cpu"),
                               h=(0.99, 1.01, True), m=(0.99, 1.01, True))
            ok &= held("density_sweep", system.engine, state, cfg,
                       ps.adia_density_pass_plain, adiabatic=True)
    if "gamma" in which:
        from sph_mountain_waves_tpu_torch.models import (
            pavelka_total_witch as pv,
        )
        # the tiny Pavelka state, h varied; cap 8: TX 32; cap 24: TX 10, a
        # ragged last tile of 8. One form (the self pair, an exact divide)
        for cap in (None, 24):
            cfg = pv.PavelkaConfig(
                n_rows=10, dtype="float32", self_density=True,
                layout="bucket", skin=0.15, use_pallas=True,
                lattice_cells=True, bucket_cap=cap)
            system = pv.make_system(cfg)
            state = _perturbed(system.freeze(device="cpu"),
                               h=(0.99, 1.01, True))
            V0 = float((state.fields["m"][state.active]
                        / state.fields["rho"][state.active]).mean())
            ok &= held("gamma_grad_sweep", system.engine, state, None,
                       lambda e, s_, c_, V0=V0: ps.gamma_grad_pass_plain(
                           e, s_, V0), V0=V0)
    if "momentum" in which or "hopkins" in which:
        import dataclasses
        from sph_mountain_waves_tpu_torch.models import (
            full_hopkins_perturbed_witch as fh, wcsph_perturbed_witch as w,
        )
        from sph_mountain_waves_tpu_torch.models.witch_common import (
            WitchConfig,
        )
        # the tiny flagship and full_hopkins states; cap 8: TX 32 on 128
        # x-cells; cap 24: TX 10, a ragged last tile of 8
        for cap in (None, 24):
            cfg = WitchConfig(n_rows=10, dtype="float32", self_density=True,
                              layout="bucket", skin=0.15, use_pallas=True,
                              lazy_diagnostics=True, lattice_cells=True,
                              bucket_cap=cap)
            for fm in (False, True):
                c = dataclasses.replace(cfg, fast_math=fm)
                if "momentum" in which:
                    system = w.make_system(cfg)
                    state = _perturbed(
                        system.freeze(device="cpu"), v=(-1, 1, False),
                        h=(0.99, 1.01, True), rho=(0.99, 1.01, True),
                        P=(0.99, 1.01, True), P_p=(-50, 50, False))
                    ok &= held("momentum_sweep", system.engine, state, c,
                               ps.momentum_pass_plain) or fm
                if "hopkins" in which:
                    system = fh.make_system(cfg)
                    state = _perturbed(
                        system.freeze(device="cpu"), v=(-1, 1, False),
                        h=(0.99, 1.01, True), rho=(0.99, 1.01, True),
                        P=(0.99, 1.01, True), P_bg=(0.99, 1.01, True),
                        A=(0.99, 1.01, True), A_bg=(0.99, 1.01, True))
                    for split in (True, False):  # total: null A_bg, P_bg,e
                        ok &= held("hopkins_momentum_sweep", system.engine,
                                   state, c,
                                   lambda e, s_, c_, split=split:
                                   ps.hopkins_momentum_pass_plain(e, s_, c_,
                                                                  split),
                                   background_split=split) or fm
                    if fm:
                        continue
                    # the pressure root has exact divides only: its self
                    # pair per self_density
                    for self_pair in (True, False):
                        ok &= held("pressure_sweep", system.engine, state,
                                   dataclasses.replace(
                                       c, self_density=self_pair),
                                   ps.pressure_pass_plain)
    if "legacy" in which:
        import dataclasses
        from sph_mountain_waves_tpu_torch.models import legacy_witch as lw
        # the tiny terrain state; cap 16: TX 16 on 128 x-cells; cap 24: TX
        # 10, a ragged last tile of 8
        for cap in (None, 24):
            cfg = lw.isothermal_flow_config(
                n_rows=14, dom_length=40e3, h_m=2000.0, a=6e3,
                dtype="float32", layout="bucket", skin=0.15, use_pallas=True,
                bucket_cap=cap)
            system = lw.make_system(cfg)
            state = _perturbed(system.freeze(device="cpu"), v=(-1, 1, False),
                               rho=(0.99, 1.01, True), P=(0.99, 1.01, True))
            # the continuity has no divide and no AV term: one form
            ok &= held("legacy_mass_sweep", system.engine, state, cfg,
                       ps.legacy_mass_pass_plain)
            for av in (0.0, 0.05):  # without AV: a null FLUID plane
                for fm in (False, True):
                    c = dataclasses.replace(cfg, av_alpha=av, fast_math=fm)
                    ok &= held("legacy_force_sweep", system.engine, state, c,
                               ps.legacy_force_pass_plain) or fm
    if "iso" in which:
        import dataclasses
        from sph_mountain_waves_tpu_torch.models import legacy_witch as lw
        # the tiny isothermal static state (per-particle h); cap 8 (its
        # own): TX 32 on 128 x-cells; cap 24: TX 10, a ragged last tile of 8
        for cap in (None, 24):
            cfg = lw.isothermal_static_config(
                n_rows=10, dtype="float32", layout="bucket", skin=0.15,
                use_pallas=True, bucket_cap=cap)
            system = lw.make_system(cfg)
            state = _perturbed(system.freeze(device="cpu"), v=(-1, 1, False),
                               rho=(0.99, 1.01, True), P=(0.99, 1.01, True),
                               h=(0.99, 1.01, True))
            # the continuity has no divide and no AV term: one form
            ok &= held("iso_static_mass_sweep", system.engine, state, cfg,
                       ps.iso_static_mass_pass_plain)
            for av in (0.0, 0.05):  # without AV: a null FLUID plane
                for fm in (False, True):
                    c = dataclasses.replace(cfg, av_alpha=av, fast_math=fm)
                    ok &= held("iso_static_force_sweep", system.engine, state,
                               c, ps.iso_static_force_pass_plain) or fm
    if "adia" in which:
        import dataclasses
        from sph_mountain_waves_tpu_torch.models import legacy_witch as lw
        # the fused adiabatic sweep on the tiny adiabatic static state (cap
        # 8, its own: TX 32 on 128 x-cells; cap 24: TX 10, a ragged last
        # tile of 8) and on the tiny adiabatic flow (cap 16: TX 16); one
        # plan for both AV forms (the FLUID gate is staged in both)
        terrain = dict(n_rows=14, dom_length=40e3, h_m=2000.0, a=6e3)
        for factory, extra, cap in (
                (lw.adiabatic_static_config, dict(n_rows=10), None),
                (lw.adiabatic_static_config, dict(n_rows=10), 24),
                (lw.adiabatic_flow_config, terrain, None)):
            cfg = factory(dtype="float32", layout="bucket", skin=0.15,
                          use_pallas=True, bucket_cap=cap, **extra)
            system = lw.make_system(cfg)
            state = _perturbed(system.freeze(device="cpu"), v=(-1, 1, False),
                               rho=(0.99, 1.01, True), P=(0.99, 1.01, True),
                               T=(0.99, 1.01, True))
            for av in (0.0, 0.05):
                for fm in (False, True):
                    c = dataclasses.replace(cfg, av_alpha=av, fast_math=fm)
                    ok &= held("adia_entropy_force_sweep", system.engine,
                               state, c, ps.adia_entropy_force_pass_plain
                               ) or fm
    if "isph" in which:
        import dataclasses
        from sph_mountain_waves_tpu_torch.models import isph_witch as iw
        # the tiny ISPH state, P drawn as the iterate (and the pressure) and
        # v as the velocity; cap 16 (its own): TX 16; cap 8: TX 32
        for cap in (None, 8):
            cfg = iw.ISPHWitchConfig(n_rows=10, dtype="float32",
                                     layout="bucket", skin=0.2,
                                     use_pallas=True, bucket_cap=cap)
            system = iw.make_system(cfg)
            state = _perturbed(system.freeze(device="cpu"), P=(-1, 1, False),
                               v=(-1, 1, False))
            ok &= held("isph_matvec_sweep", system.engine, state, cfg,
                       lambda e, s_, c_: ps.isph_matvec_pass_plain(
                           e, s_, c_, s_.fields["P"]))
            ok &= held("isph_div_visc_sweep", system.engine, state, cfg,
                       ps.isph_div_visc_pass_plain)
            ok &= held("isph_grad_sweep", system.engine, state, cfg,
                       ps.isph_grad_pass_plain)
    if not ok:
        raise AssertionError("a tiled sweep differs from its twin")
    print("host check passed")


if __name__ == "__main__":
    main(sys.argv[1:] or ["dam", "dam2", "rb", "witch", "pavelka",
                          "density", "gamma", "momentum", "hopkins", "legacy",
                          "iso", "adia", "isph"])
