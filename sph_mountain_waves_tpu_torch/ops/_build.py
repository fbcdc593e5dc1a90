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
        # occ, x0, x1, 1/h, w, kmax, out, cap, nx, ny, h2, self_pair, cw, stream
        "density_sweep": ([_P] * 7 + [_I] * 3 + [_F, _I, _F, _P], _I),
        # 10 planes, kmax, 2 outs, cap, nx, ny, h2, dw, eps, -alpha, beta,
        # fast_math, stream
        "momentum_sweep": ([_P] * 13 + [_I] * 3 + [_F] * 5 + [_I, _P], _I),
        # occ, x0, x1, h, w, kmax, out, cap, nx, ny, h2, self_pair, cw, stream
        "pressure_sweep": ([_P] * 7 + [_I] * 3 + [_F, _I, _F, _P], _I),
        # 13 planes (the last two null without the split), kmax, 2 outs, cap,
        # nx, ny, h2, dw, eps, -alpha, beta, background_split, fast_math,
        # stream
        "hopkins_momentum_sweep": ([_P] * 16 + [_I] * 3 + [_F] * 5
                                   + [_I, _I, _P], _I),
        # 9 planes, kmax, out, cap, nx, ny, h2, dw, 2nu, fixed_diffusion,
        # fast_math, stream
        "pavelka_mass_sweep": ([_P] * 11 + [_I] * 3 + [_F] * 3
                               + [_I, _I, _P], _I),
        # 12 planes, kmax, 3 outs, cap, nx, ny, h2, dw, mu, dt, fast_math,
        # stream
        "pavelka_momentum_entropy_sweep": ([_P] * 16 + [_I] * 3 + [_F] * 4
                                           + [_I, _P], _I),
        # occ, x0, x1, h, kmax, 2 outs, cap, nx, ny, h2, coef, stream
        "gamma_grad_sweep": ([_P] * 7 + [_I] * 3 + [_F] * 2 + [_P], _I),
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
