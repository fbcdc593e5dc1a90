"""Build the port's CUDA sources with nvcc on first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface; it is compiled for sm_90a
into ``build/kernels/`` at the root of the checkout (a directory git
ignores), under a name that carries a hash of the source and the flags, and
loaded with ``ctypes``. Nothing is built when the module is imported: CPU-only
installations (no nvcc) import the package and run the plain twins.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (argtypes, restype) of every exported function, by library
SIGNATURES = {
    "pair_sweep": {
        "pair_sweep_error_string": ([_I], ctypes.c_char_p),
        # occ, x0, x1, 1/h, w, kmax, out, cap, nx, ny, h2, self_pair, cw, the
        # tiled sweep's plan (TX, dynamic shared bytes), stream; one bound
        # per x-tile (the "_direct" yardstick: no plan, one per grid row)
        "density_sweep": ([_P] * 7 + [_I] * 3 + [_F, _I, _F, _I, _I, _P], _I),
        "density_sweep_direct": ([_P] * 7 + [_I] * 3 + [_F, _I, _F, _P], _I),
        # 10 planes, kmax, 2 outs, cap, nx, ny, h2, dw, eps, -alpha, beta,
        # fast_math, the tiled sweep's plan (TX, dynamic shared bytes),
        # stream; kmax is one bound per x-tile
        "momentum_sweep": ([_P] * 13 + [_I] * 3 + [_F] * 5 + [_I] * 3 + [_P],
                           _I),
        # occ, x0, x1, h, w, kmax, out, cap, nx, ny, h2, self_pair, cw, the
        # tiled sweep's plan (TX, dynamic shared bytes), stream; one bound
        # per x-tile (the "_direct" yardstick: no plan, one per grid row)
        "pressure_sweep": ([_P] * 7 + [_I] * 3 + [_F, _I, _F, _I, _I, _P],
                           _I),
        "pressure_sweep_direct": ([_P] * 7 + [_I] * 3 + [_F, _I, _F, _P], _I),
        # 13 planes (the last two null without the split), kmax, 2 outs, cap,
        # nx, ny, h2, dw, eps, -alpha, beta, background_split, fast_math,
        # the plan (TX, dynamic shared bytes), stream; one bound per x-tile
        "hopkins_momentum_sweep": ([_P] * 16 + [_I] * 3 + [_F] * 5
                                   + [_I] * 4 + [_P], _I),
        # 9 planes, kmax, out, cap, nx, ny, h2, dw, 2nu, fixed_diffusion,
        # fast_math, the tiled sweep's plan (TX, dynamic shared bytes),
        # stream; kmax is one bound per x-tile
        "pavelka_mass_sweep": ([_P] * 11 + [_I] * 3 + [_F] * 3
                               + [_I] * 4 + [_P], _I),
        # 12 planes, kmax, 3 outs, cap, nx, ny, h2, dw, mu, dt, fast_math,
        # the plan (TX, dynamic shared bytes), stream; one bound per x-tile
        "pavelka_momentum_entropy_sweep": ([_P] * 16 + [_I] * 3 + [_F] * 4
                                           + [_I] * 3 + [_P], _I),
        # the "_direct" yardsticks of the four tiled 2-D sweeps (the
        # one-thread-per-slot design): no plan, one bound per grid row
        "momentum_sweep_direct": ([_P] * 13 + [_I] * 3 + [_F] * 5
                                  + [_I, _P], _I),
        "hopkins_momentum_sweep_direct": ([_P] * 16 + [_I] * 3 + [_F] * 5
                                          + [_I, _I, _P], _I),
        "pavelka_mass_sweep_direct": ([_P] * 11 + [_I] * 3 + [_F] * 3
                                      + [_I, _I, _P], _I),
        "pavelka_momentum_entropy_sweep_direct": ([_P] * 16 + [_I] * 3
                                                  + [_F] * 4 + [_I, _P], _I),
        # occ, x0, x1, h, kmax, 2 outs, cap, nx, ny, h2, coef, the tiled
        # sweep's plan (TX, dynamic shared bytes), stream; one bound per
        # x-tile (the "_direct" yardstick: no plan, one per grid row)
        "gamma_grad_sweep": ([_P] * 7 + [_I] * 3 + [_F] * 2 + [_I, _I, _P],
                             _I),
        "gamma_grad_sweep_direct": ([_P] * 7 + [_I] * 3 + [_F] * 2 + [_P], _I),
        # occ, x0, x1, v0, v1, rho, kmax, out, cap, nx, ny, h2, kc, 1/h, 2nu,
        # the tiled sweep's plan (TX, dynamic shared bytes), stream; one
        # bound per x-tile (the "_direct" yardstick: no plan, one per grid
        # row)
        "dambreak_mass_sweep": ([_P] * 8 + [_I] * 3 + [_F] * 4
                                + [_I, _I, _P], _I),
        "dambreak_mass_sweep_direct": ([_P] * 8 + [_I] * 3 + [_F] * 4 + [_P],
                                       _I),
        # occ, x0, x1, v0, v1, P/rho^2, fluid, kmax, 2 outs, cap, nx, ny, h2,
        # kc, 1/h, 2mu/rho0^2, the tiled sweep's plan (TX, dynamic shared
        # bytes), stream; one bound per x-tile (the "_direct" yardstick: no
        # plan, one per grid row)
        "dambreak_force_sweep": ([_P] * 10 + [_I] * 3 + [_F] * 4
                                 + [_I, _I, _P], _I),
        "dambreak_force_sweep_direct": ([_P] * 10 + [_I] * 3 + [_F] * 4
                                        + [_P], _I),
        # occ, x0, x1, v0, v1, m, kmax, out, cap, nx, ny, h2, kc, 1/h0, the
        # tiled sweep's plan (TX, dynamic shared bytes), stream; one bound
        # per x-tile (the "_direct" yardstick: no plan, one per grid row)
        "legacy_mass_sweep": ([_P] * 8 + [_I] * 3 + [_F] * 3 + [_I, _I, _P],
                              _I),
        "legacy_mass_sweep_direct": ([_P] * 8 + [_I] * 3 + [_F] * 3 + [_P],
                                     _I),
        # occ, x0, x1, 1/h, v0, v1, m/rho, kmax, out, cap, nx, ny, h2, dw,
        # the tiled sweep's plan (TX, dynamic shared bytes), stream; one
        # bound per x-tile (the "_direct" yardstick: no plan, one per grid
        # row)
        "iso_static_mass_sweep": ([_P] * 9 + [_I] * 3 + [_F] * 2
                                  + [_I, _I, _P], _I),
        "iso_static_mass_sweep_direct": ([_P] * 9 + [_I] * 3 + [_F] * 2
                                         + [_P], _I),
        # 9 planes (fluid null without AV), kmax, 2 outs, cap, nx, ny, h2, kc,
        # 1/h0, 0.01 h0^2, 8mu, -alpha c, 2 alpha, h0, av, fast_math, the
        # tiled sweep's plan (TX, dynamic shared bytes), stream; one bound
        # per x-tile (the "_direct" yardstick: no plan, one per grid row)
        "legacy_force_sweep": ([_P] * 12 + [_I] * 3 + [_F] * 8
                               + [_I] * 4 + [_P], _I),
        "legacy_force_sweep_direct": ([_P] * 12 + [_I] * 3 + [_F] * 8
                                      + [_I, _I, _P], _I),
        # 10 planes (fluid null without AV), kmax, 2 outs, cap, nx, ny, h2,
        # dw, 8mu, -alpha c, 2 alpha, av, fast_math, the tiled sweep's plan
        # (TX, dynamic shared bytes), stream; one bound per x-tile (the
        # "_direct" yardstick: no plan, one per grid row)
        "iso_static_force_sweep": ([_P] * 13 + [_I] * 3 + [_F] * 5
                                   + [_I] * 4 + [_P], _I),
        "iso_static_force_sweep_direct": ([_P] * 13 + [_I] * 3 + [_F] * 5
                                          + [_I, _I, _P], _I),
        # 10 planes, kmax, 3 outs, cap, nx, ny, h2, kc, 1/h0, 0.01 h0^2, 8mu,
        # -4 mu dt, -alpha c, 2 alpha, h0, av, fast_math, the tiled sweep's
        # plan (TX, dynamic shared bytes), stream; one bound per x-tile (the
        # "_direct" yardstick: no plan, one per grid row)
        "adia_entropy_force_sweep": ([_P] * 14 + [_I] * 3 + [_F] * 9
                                     + [_I] * 4 + [_P], _I),
        "adia_entropy_force_sweep_direct": ([_P] * 14 + [_I] * 3 + [_F] * 9
                                            + [_I, _I, _P], _I),
        # occ, x0, x1, v0, v1, kmax, 5 outs, cap, nx, ny, h2, 1/h0, kw, the
        # tiled sweep's plan (TX, dynamic shared bytes), stream; one bound
        # per x-tile (the "_direct" yardstick: no plan, one per grid row)
        "isph_div_visc_sweep": ([_P] * 11 + [_I] * 3 + [_F] * 3
                                + [_I, _I, _P], _I),
        "isph_div_visc_sweep_direct": ([_P] * 11 + [_I] * 3 + [_F] * 3 + [_P],
                                       _I),
        # occ, x0, x1, v, kmax, out, cap, nx, ny, h2, 1/h0, kw, the tiled
        # sweep's plan (TX, dynamic shared bytes), stream; one bound per
        # x-tile (the "_direct" yardstick: no plan, one per grid row)
        "isph_matvec_sweep": ([_P] * 6 + [_I] * 3 + [_F] * 3 + [_I, _I, _P],
                              _I),
        "isph_matvec_sweep_direct": ([_P] * 6 + [_I] * 3 + [_F] * 3 + [_P],
                                     _I),
        # occ, x0, x1, P, kmax, 2 outs, cap, nx, ny, h2, 1/h0, kw, the tiled
        # sweep's plan (TX, dynamic shared bytes), stream; one bound per
        # x-tile (the "_direct" yardstick: no plan, one per grid row)
        "isph_grad_sweep": ([_P] * 7 + [_I] * 3 + [_F] * 3 + [_I, _I, _P],
                            _I),
        "isph_grad_sweep_direct": ([_P] * 7 + [_I] * 3 + [_F] * 3 + [_P], _I),
        # occ, x0, x1, v0, v1, T, 1/rho, kmax, 2 outs, cap, nx, ny, h2, kc,
        # 1/h, 2 kappa, the tiled sweep's plan (TX, dynamic shared bytes),
        # stream; one bound per x-tile (the "_direct" yardstick: no plan, one
        # per grid row)
        "rb_mass_heat_sweep": ([_P] * 10 + [_I] * 3 + [_F] * 4
                               + [_I, _I, _P], _I),
        "rb_mass_heat_sweep_direct": ([_P] * 10 + [_I] * 3 + [_F] * 4 + [_P],
                                      _I),
        # the 3-D forms take x2 (and v2) planes, one more output for the
        # vector sweeps, and nz after ny; the 3-D density, momentum and
        # dam-break sweeps take the tiled sweep's plan (TX, dynamic shared
        # bytes) before the stream and one trip bound per x-tile, their
        # "_direct" exports (the one-thread-per-slot design, a yardstick)
        # take no plan and one bound per grid row
        "density_sweep_3d": ([_P] * 8 + [_I] * 4 + [_F, _I, _F, _I, _I, _P],
                             _I),
        "momentum_sweep_3d": ([_P] * 16 + [_I] * 4 + [_F] * 5
                              + [_I, _I, _I, _P], _I),
        "dambreak_mass_sweep_3d": ([_P] * 10 + [_I] * 4 + [_F] * 4
                                   + [_I, _I, _P], _I),
        "dambreak_force_sweep_3d": ([_P] * 13 + [_I] * 4 + [_F] * 4
                                    + [_I, _I, _P], _I),
        "density_sweep_3d_direct": ([_P] * 8 + [_I] * 4 + [_F, _I, _F, _P],
                                    _I),
        "momentum_sweep_3d_direct": ([_P] * 16 + [_I] * 4 + [_F] * 5
                                     + [_I, _P], _I),
        "dambreak_mass_sweep_3d_direct": ([_P] * 10 + [_I] * 4 + [_F] * 4
                                          + [_P], _I),
        "dambreak_force_sweep_3d_direct": ([_P] * 13 + [_I] * 4 + [_F] * 4
                                           + [_P], _I),
    },
}


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when an existing build was reused
    log: str        # nvcc's output (ptxas register and spill report)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (PATH or CUDA_HOME)")
    return nvcc


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source and
    these flags exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                       capture_output=True, text=True, check=False)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return Build(out, time.perf_counter() - t0, r.stdout + r.stderr)


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with every exported
    function's argument and result types declared."""
    lib = ctypes.CDLL(str(build(name).path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
