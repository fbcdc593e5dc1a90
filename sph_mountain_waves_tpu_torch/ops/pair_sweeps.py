"""Pair sweeps of the mountain-wave, dam-break, terrain, ISPH and
Rayleigh–Bénard schemes: density and momentum (2-D and 3-D), the Hopkins
pressure root and momentum, the Pavelka continuity and fused momentum +
entropy sweeps, the Colagrossi packing's ∇Γ sum, the dam-break continuity and
force (2-D and 3-D), the legacy (terrain) continuity and force with fixed or
per-particle h, the adiabatic density and the fused adiabatic entropy + force
sweep, the ISPH divergence/viscous sweep, CG matvec and pressure gradient,
and the Rayleigh–Bénard fused continuity + conduction sweep.

Port of ``sph_mountain_waves_tpu/ops/pallas_pairs.py`` (every pass that
reaches its ``pl.pallas_call``): the pair-sweep harness
(``make_pair_kernel_fn`` with ``_make_pair_kernel``, the one
``pl.pallas_call``) over 9 or 27 stencil cells, its trip bound ``row_kmax``,
``weighted_w_pass(ker_h="p")``/``density_pass`` and ``momentum_pass`` in both
dimensions, ``weighted_w_pass(ker_h="sym")``/``pressure_pass``,
``hopkins_momentum_pass`` (``background_split`` on and off),
``pavelka_mass_pass``, ``pavelka_momentum_entropy_pass``,
``dambreak_mass_pass``, ``dambreak_force_pass``, ``legacy_mass_pass``,
``legacy_force_pass``, ``iso_static_mass_pass``, ``iso_static_force_pass``,
``adia_density_pass`` (on the density kernel), ``adia_entropy_force_pass``,
``isph_div_visc_pass``, ``isph_matvec_prepared`` (prepared once per CG
solve; ``isph_matvec_pass`` is its one-shot form), ``isph_grad_pass`` and
``rb_mass_heat_pass``. ``gamma_grad_pass`` has no Pallas counterpart:
the reference's Colagrossi
packing takes that sum as an XLA pair sum
(``utils/packing.py::colagrossi_packing``, ``find_gGamma``).

Every sweep reads f32 planes in the bucket layout ``[cap, C+1]`` (an
occupancy plane plus per-particle fields) and writes one ``[cap, C+1]`` plane
per output, zero on empty slots and in the trash column. A pair (p, q) counts
when both slots are occupied, q's cell is one of p's 9 stencil cells inside
the grid (27 in 3-D), ``r² ≤ h²`` and, unless the sweep includes the self
pair, q ≠ p. Sums are taken in a fixed order: for each q rank ``kq`` the
stencil's contributions are summed (the last axis' offset outermost: dj, or
dk then dj in 3-D) and then added to the accumulator, as the Pallas kernel
does, so reruns are bitwise identical.

Each sweep has two implementations:

* a CUDA C++ kernel for sm_90a (``csrc/pair_sweep.cu``), launched by the
  wrapper (``density_pass``, ``momentum_pass``, ``pressure_pass``,
  ``hopkins_momentum_pass``, ``pavelka_mass_pass``,
  ``pavelka_momentum_entropy_pass``, ``gamma_grad_pass``,
  ``dambreak_mass_pass``, ``dambreak_force_pass``, the six terrain
  wrappers and the four ISPH/Rayleigh–Bénard ones) for CUDA tensors, which
  counts its launches in ``<wrapper>.launches``; ``density_pass``,
  ``momentum_pass`` and the dam-break wrappers take the 2-D or the 3-D
  kernel by ``engine.dim``. The 3-D density, momentum and dam-break
  sweeps, the 2-D density (the adiabatic density on it) and momentum, the
  Hopkins pressure root and momentum, the two Pavelka sweeps, the packing's
  ∇Γ sum, the terrain continuity and force (fixed h) and the ISPH CG matvec
  run the tiled design
  (``_tile_plan``: one block per x-tile of a grid row covering every p
  rank, q ranks staged in shared memory, each tile walking the q ranks to
  its own bound, ``tile_kmax``); ``tiled_yardsticks``
  launches them beside the one-thread-per-slot design they replaced, for
  timing and for bit-for-bit comparison only;
* a plain PyTorch twin (``<wrapper>_plain``) with the Pallas body's math,
  vectorised over shifted views of the padded ``[cap, (nz+2,) ny+2, nx+2]``
  grid. The wrapper takes it for CPU tensors only.

What bounds the kernel on an H100: per occupied p slot it reads the q slots
of 9 cells up to the row's band occupancy (about 9·kmax slots) of 4 (∇Γ),
5 (density, pressure), 6/7 (legacy continuity), 8–10 (legacy force), 9
(Pavelka continuity), 10 (momentum, adiabatic entropy + force), 11/13
(Hopkins momentum) or 12 (Pavelka momentum + entropy) f32 fields; the ISPH
matvec reads 4 (its coordinates and the iterate), the ISPH gradient 4, the
divergence/viscous sweep 5 and the Rayleigh–Bénard sweep 7.
Neighbouring threads share most of those q reads, so they hit L1/L2; memory
traffic and occupancy bound the 2-D sweeps, not FLOPs. In 3-D a slot tests
up to 27·kmax candidates (6 to 12 fields) for the few dozen pairs inside the
cutoff: the candidate loop, not the bytes, paces the density and momentum
(``csrc/pair_sweep.cu`` says why).
"""
from __future__ import annotations

import ctypes
import types
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import C_DSPLINE23, C_DW2, C_DW3, C_W2, C_W3
from ..structs import ParticleState
from . import _build

__all__ = ["row_kmax", "tile_kmax", "density_pass", "density_pass_plain",
           "momentum_pass", "momentum_pass_plain", "pressure_pass",
           "pressure_pass_plain", "hopkins_momentum_pass",
           "hopkins_momentum_pass_plain", "pavelka_mass_pass",
           "pavelka_mass_pass_plain", "pavelka_momentum_entropy_pass",
           "pavelka_momentum_entropy_pass_plain", "gamma_grad_pass",
           "gamma_grad_pass_plain", "dambreak_mass_pass",
           "dambreak_mass_pass_plain", "dambreak_force_pass",
           "dambreak_force_pass_plain", "legacy_mass_pass",
           "legacy_mass_pass_plain", "legacy_force_pass",
           "legacy_force_pass_plain", "iso_static_mass_pass",
           "iso_static_mass_pass_plain", "iso_static_force_pass",
           "iso_static_force_pass_plain", "adia_density_pass",
           "adia_density_pass_plain", "adia_entropy_force_pass",
           "adia_entropy_force_pass_plain", "isph_div_visc_pass",
           "isph_div_visc_pass_plain", "isph_matvec_prepared",
           "isph_matvec_pass", "isph_matvec_pass_plain", "isph_grad_pass",
           "isph_grad_pass_plain", "rb_mass_heat_pass",
           "rb_mass_heat_pass_plain"]


def row_kmax(engine, state: ParticleState):
    """(band_max, row_max): per-grid-row max bucket occupancy maxed over the
    stencil band (the q-slot trip bound: 3 rows in 2-D, the 3×3 (dj, dk)
    neighbourhood of rows in 3-D) and for the row itself. Each [R] int32 with
    R = ny (2-D) or ny·nz (3-D, z major)."""
    per_cell = engine.grid_view(state.active).sum(dim=0)     # [(nz,) ny, nx]
    per_row = per_cell.amax(dim=-1)                           # [(nz,) ny]
    if engine.dim == 2:
        padded = F.pad(per_row, (1, 1))
        band = torch.maximum(torch.maximum(padded[:-2], padded[1:-1]),
                             padded[2:])
    else:
        nz, ny = per_row.shape
        padded = F.pad(per_row, (1, 1, 1, 1))
        band = torch.zeros_like(per_row)
        for dk in range(3):
            for dj in range(3):
                band = torch.maximum(band, padded[dk:dk + nz, dj:dj + ny])
    return (band.reshape(-1).to(torch.int32),
            per_row.reshape(-1).to(torch.int32))


def tile_kmax(engine, state: ParticleState, tx: int) -> torch.Tensor:
    """The tiled sweeps' trip bound, one per x-tile of ``tx`` cells of a grid
    row: the largest bucket occupancy among the (tx+2)×3 (2-D) or
    (tx+2)×3×3 (3-D) cells the tile stages (its cells and their neighbours
    inside the grid), as int32 [(nz·)ny·ntiles] in the sweep's block order
    (x-tiles fastest, then y, then z; ntiles = ⌈nx / tx⌉, the last tile
    ragged). Ranks are packed from 0, so every rank past the bound is empty
    in all of those cells; the bound is never above ``row_kmax``'s band of
    the tile's row."""
    per_cell = engine.grid_view(state.active).sum(dim=0).to(torch.float32)
    # the largest count in each cell's 3×3(×3) neighbourhood (pads count
    # -inf)
    pool = F.max_pool2d if engine.dim == 2 else F.max_pool3d
    around = pool(per_cell[None, None], 3, stride=1, padding=1)[0, 0]
    nx = engine.lims[0]
    tiles = F.pad(around, (0, -nx % tx)).reshape(
        around.shape[:-1] + (-1, tx)).amax(dim=-1)
    return tiles.reshape(-1).to(torch.int32)


def _hfloor(engine) -> float:
    # keeps 1/h finite on empty rows; far smaller than any physical h
    return 1e-3 * engine.h


def _rdw_const(dim: int) -> float:
    # -C of rDwendland{2,3} = (dw/dr)/r = -C·pos(1-r/h)^3 / h^(dim+2)
    return -C_DW2 if dim == 2 else -C_DW3


def _div_fn(cfg):
    """Division for the pair bodies. With ``cfg.fast_math`` the twin
    multiplies by the exact reciprocal (what the Pallas kernel's approximate
    reciprocal evaluates to in interpret mode); the CUDA kernel uses the
    hardware's approximate reciprocal, ``rcp.approx.ftz.f32``."""
    if getattr(cfg, "fast_math", False):
        return lambda a, b: a * (1.0 / b)
    return lambda a, b: a / b


def _plane(engine, arr: torch.Tensor) -> torch.Tensor:
    """A flat [slots] field as a contiguous f32 [cap, C+1] plane."""
    return engine.resident(arr).to(torch.float32).contiguous()


# ----------------------------------------------------------------- inputs

def _axes(engine, arr: torch.Tensor) -> list:
    """The per-axis components of a vector field [slots, dim]."""
    return [arr[:, a] for a in range(engine.dim)]


def _density_inputs(engine, state: ParticleState, weight: torch.Tensor):
    """Planes (occ, x[dim], 1/h, weight) and their grid-edge pad values.
    1/h is streamed so the body has no divide."""
    f = state.fields
    hinv = 1.0 / torch.clamp(f["h"], min=_hfloor(engine))
    planes = [_plane(engine, a) for a in (
        [state.active] + _axes(engine, f["x"]) + [hinv, weight])]
    return planes, [0.0] * len(planes)


def _momentum_inputs(engine, state: ParticleState, cfg):
    """Planes (occ, x[dim], h, m, v[dim], ρ_f, P′/ρ_f², c) with the
    per-particle quantities hoisted: floored ρ, the pressure term and the
    sound speed. h pads with its floor so that a pad never yields 1/0."""
    f = state.fields
    d = engine.dim
    rho_f = torch.clamp(f["rho"], min=cfg.rho_floor)
    Aterm = f["P_p"] / rho_f**2
    cs = torch.sqrt(torch.clamp(cfg.gamma * f["P"] / rho_f, min=0.0))
    h = torch.clamp(f["h"], min=_hfloor(engine))
    planes = [_plane(engine, a) for a in (
        [state.active] + _axes(engine, f["x"]) + [h, f["m"]]
        + _axes(engine, f["v"]) + [rho_f, Aterm, cs])]
    pad_vals = [0.0] * (1 + d) + [_hfloor(engine)] + [0.0] * (4 + d)
    return planes, pad_vals


def _dambreak_mass_inputs(engine, state: ParticleState):
    """Planes (occ, x[dim], v[dim], ρ); every pad is 0 (fixed h: no 1/h)."""
    f = state.fields
    planes = [_plane(engine, a) for a in (
        [state.active] + _axes(engine, f["x"]) + _axes(engine, f["v"])
        + [f["rho"]])]
    return planes, [0.0] * len(planes)


def _dambreak_force_inputs(engine, state: ParticleState):
    """Planes (occ, x[dim], v[dim], P/max(ρ, 1e-12)², [type == FLUID]); the
    floored ρ keeps the pressure term finite on empty slots."""
    f = state.fields
    rho_f = torch.clamp(f["rho"], min=1e-12)
    Pterm = f["P"] / rho_f**2
    fluid = (f["type"] == 0.0).to(torch.float32)
    planes = [_plane(engine, a) for a in (
        [state.active] + _axes(engine, f["x"]) + _axes(engine, f["v"])
        + [Pterm, fluid])]
    return planes, [0.0] * len(planes)


def _dambreak_consts(cfg, dim: int):
    """(kc, 1/h) of the fixed-h dam-break bodies: m and the kernel's
    normalisation folded into kc = m·(−C of rDW)/h^(dim+2), in double on the
    host as the reference computes them."""
    return cfg.m * _rdw_const(dim) / cfg.h ** (dim + 2), 1.0 / cfg.h


def _legacy_consts(cfg, dim: int):
    """(kc, 1/h0) of the fixed-h0 legacy bodies: kc = (−C of rDW)/h0^(dim+2),
    in double on the host as the reference computes them."""
    return _rdw_const(dim) / cfg.h0 ** (dim + 2), 1.0 / cfg.h0


def _legacy_mass_inputs(engine, state: ParticleState):
    """Planes (occ, x[dim], v[dim], m); every pad is 0."""
    f = state.fields
    planes = [_plane(engine, a) for a in (
        [state.active] + _axes(engine, f["x"]) + _axes(engine, f["v"])
        + [f["m"]])]
    return planes, [0.0] * len(planes)


def _iso_static_mass_inputs(engine, state: ParticleState):
    """Planes (occ, x[dim], 1/h, v[dim], wq = m/max(ρ, 1e-12)), 1/h from h
    clamped at its floor; every pad is 0, as the reference's."""
    f = state.fields
    hinv = 1.0 / torch.clamp(f["h"], min=_hfloor(engine))
    wq = f["m"] / torch.clamp(f["rho"], min=1e-12)
    planes = [_plane(engine, a) for a in (
        [state.active] + _axes(engine, f["x"]) + [hinv]
        + _axes(engine, f["v"]) + [wq])]
    return planes, [0.0] * len(planes)


def _legacy_force_inputs(engine, state: ParticleState, cfg, adaptive: bool):
    """Planes (occ, x[dim], (h,) v[dim], m, P/ρ_f², 1/ρ_f (, [type ==
    FLUID] with ``cfg.av_alpha``)), ρ_f = max(ρ, 1e-12): the pressure term
    and 1/ρ hoisted per particle and finite on empty slots. With the
    per-particle h (``adaptive``) h is clamped at its floor and pads with
    it."""
    f = state.fields
    rho_f = torch.clamp(f["rho"], min=1e-12)
    scalars = [f["m"], f["P"] / rho_f**2, 1.0 / rho_f]
    if cfg.av_alpha:
        scalars.append((f["type"] == 0.0).to(f["m"].dtype))
    hs = [torch.clamp(f["h"], min=_hfloor(engine))] if adaptive else []
    planes = [_plane(engine, a) for a in (
        [state.active] + _axes(engine, f["x"]) + hs + _axes(engine, f["v"])
        + scalars)]
    pad_vals = ([0.0] * (1 + engine.dim) + [_hfloor(engine)] * len(hs)
                + [0.0] * (engine.dim + len(scalars)))
    return planes, pad_vals


def _adia_entropy_force_inputs(engine, state: ParticleState):
    """Planes (occ, x[dim], v[dim], m, P/ρ_f², 1/ρ_f, [type == FLUID],
    m/max(T, 1e-30)), ρ_f = max(ρ, 1e-12); every pad is 0."""
    f = state.fields
    rho_f = torch.clamp(f["rho"], min=1e-12)
    planes = [_plane(engine, a) for a in (
        [state.active] + _axes(engine, f["x"]) + _axes(engine, f["v"])
        + [f["m"], f["P"] / rho_f**2, 1.0 / rho_f,
           (f["type"] == 0.0).to(f["m"].dtype),
           f["m"] / torch.clamp(f["T"], min=1e-30)])]
    return planes, [0.0] * len(planes)


def _adia_density_weight(state: ParticleState, cfg):
    """The adiabatic density's q weight: m on FLUID rows (the q-side gate),
    or m on every row under the corrected open boundary
    (``cfg.outflow_buffer``)."""
    f = state.fields
    if getattr(cfg, "outflow_buffer", 0.0):
        return f["m"]
    return f["m"] * (f["type"] == 0.0)


def _pressure_inputs(engine, state: ParticleState, cfg):
    """Planes (occ, x0, x1, h, w = m·A^{1/γ}); h pads with its floor."""
    f = state.fields
    h = torch.clamp(f["h"], min=_hfloor(engine))
    w = f["m"] * f["A"] ** (1.0 / cfg.gamma)
    planes = [_plane(engine, a) for a in (
        state.active, f["x"][:, 0], f["x"][:, 1], h, w)]
    return planes, [0.0] * 3 + [_hfloor(engine), 0.0]


def _hopkins_inputs(engine, state: ParticleState, cfg, background_split: bool):
    """Planes (occ, x0, x1, h, m, v0, v1, ρ_f, c, A^{1/γ}, P_e) and, with the
    background split, (A_bg^{1/γ}, P_bg,e), where P_e = max(P, P_floor)^(1−2/γ):
    every per-particle power hoisted out of the pair body. Each is finite on
    an empty slot (A = 0 gives 0, P = 0 gives P_floor^(1−2/γ)); h pads with
    its floor."""
    f = state.fields
    expfac = 1.0 - 2.0 / cfg.gamma
    rho_f = torch.clamp(f["rho"], min=cfg.rho_floor)
    cs = torch.sqrt(torch.clamp(cfg.gamma * f["P"] / rho_f, min=0.0))
    hoisted = [f["m"], f["v"][:, 0], f["v"][:, 1], rho_f, cs,
               f["A"] ** (1.0 / cfg.gamma),
               torch.clamp(f["P"], min=cfg.P_floor) ** expfac]
    if background_split:
        hoisted += [f["A_bg"] ** (1.0 / cfg.gamma),
                    torch.clamp(f["P_bg"], min=cfg.P_floor) ** expfac]
    h = torch.clamp(f["h"], min=_hfloor(engine))
    planes = [_plane(engine, a) for a in [
        state.active, f["x"][:, 0], f["x"][:, 1], h] + hoisted]
    pad_vals = [0.0] * 3 + [_hfloor(engine)] + [0.0] * len(hoisted)
    return planes, pad_vals


def _pavelka_mass_inputs(engine, state: ParticleState, cfg):
    """Planes (occ, x0, x1, h, v0, v1, ρ_f, wq = m/ρ_f, [type == FLUID]);
    h pads with its floor."""
    f = state.fields
    rho_f = torch.clamp(f["rho"], min=cfg.rho_floor)
    wq = f["m"] / rho_f
    fluid = (f["type"] == 0.0).to(torch.float32)
    h = torch.clamp(f["h"], min=_hfloor(engine))
    planes = [_plane(engine, a) for a in (
        state.active, f["x"][:, 0], f["x"][:, 1], h,
        f["v"][:, 0], f["v"][:, 1], rho_f, wq, fluid)]
    return planes, [0.0] * 3 + [_hfloor(engine)] + [0.0] * 5


def _pavelka_momentum_entropy_inputs(engine, state: ParticleState, cfg):
    """Planes (occ, x0, x1, h, m, v0, v1, ρ_f, wq = m/ρ_f, P/ρ_f²,
    T_f = max(T, 1e-12), [type == FLUID]). ρ_f and T_f sit in the ρ_p·ρ_q and
    T_p·ρ_q denominators, so they are non-zero on every slot and ρ pads with
    its floor (0/0 is NaN even under the mask); h pads with its floor."""
    f = state.fields
    rho_f = torch.clamp(f["rho"], min=cfg.rho_floor)
    wq = f["m"] / rho_f
    Pterm = f["P"] / rho_f**2
    T_f = torch.clamp(f["T"], min=1e-12)
    fluid = (f["type"] == 0.0).to(torch.float32)
    h = torch.clamp(f["h"], min=_hfloor(engine))
    planes = [_plane(engine, a) for a in (
        state.active, f["x"][:, 0], f["x"][:, 1], h, f["m"],
        f["v"][:, 0], f["v"][:, 1], rho_f, wq, Pterm, T_f, fluid)]
    pad_vals = ([0.0] * 3 + [_hfloor(engine)] + [0.0] * 3
                + [cfg.rho_floor] + [0.0] * 4)
    return planes, pad_vals


def _gamma_grad_inputs(engine, state: ParticleState):
    """Planes (occ, x0, x1, h); h pads with its floor."""
    f = state.fields
    h = torch.clamp(f["h"], min=_hfloor(engine))
    planes = [_plane(engine, a) for a in (
        state.active, f["x"][:, 0], f["x"][:, 1], h)]
    return planes, [0.0] * 3 + [_hfloor(engine)]


def _isph_div_visc_inputs(engine, state: ParticleState):
    """Planes (occ, x[dim], v[dim]); every pad is 0 (fixed h0: no 1/h)."""
    f = state.fields
    planes = [_plane(engine, a) for a in (
        [state.active] + _axes(engine, f["x"]) + _axes(engine, f["v"]))]
    return planes, [0.0] * len(planes)


def _isph_matvec_inputs(engine, state: ParticleState):
    """The matvec's prepared planes (occ, x[dim]); the iterate is streamed
    as the last plane at each call."""
    f = state.fields
    planes = [_plane(engine, a) for a in
              [state.active] + _axes(engine, f["x"])]
    return planes, [0.0] * (len(planes) + 1)


def _isph_grad_inputs(engine, state: ParticleState):
    """Planes (occ, x[dim], P); every pad is 0."""
    f = state.fields
    planes = [_plane(engine, a) for a in
              [state.active] + _axes(engine, f["x"]) + [f["P"]]]
    return planes, [0.0] * len(planes)


def _rb_mass_heat_inputs(engine, state: ParticleState, cfg):
    """Planes (occ, x[dim], v[dim], T, 1/max(ρ, 0.01ρ0)); every pad is 0.
    The hoisted q weight 1/ρ is zero on ``WALL_ADIA`` rows under adiabatic
    sidewalls (the q-side zero-flux gate) and finite on every slot."""
    from ..models.rayleigh_benard import WALL_ADIA
    f = state.fields
    rinv = 1.0 / torch.clamp(f["rho"], min=0.01 * cfg.rho0)
    if getattr(cfg, "sidewalls", "conducting") == "adiabatic":
        rinv = torch.where(f["type"] == WALL_ADIA, 0.0, rinv)
    planes = [_plane(engine, a) for a in (
        [state.active] + _axes(engine, f["x"]) + _axes(engine, f["v"])
        + [f["T"], rinv])]
    return planes, [0.0] * len(planes)


# ------------------------------------------------------------ plain twins

def _dot(dx: list, dv: list):
    """x_pq·v_pq summed in axis order."""
    dot = dx[0] * dv[0]
    for a in range(1, len(dx)):
        dot = dot + dx[a] * dv[a]
    return dot


def _density_body(d: int):
    """Σ w_q·W_d(h_p, r) with 1/h_p streamed (fields occ, x[d], 1/h, w)."""
    CW = C_W2 if d == 2 else C_W3

    def body(p, q, r2, maskf):
        wq = q[2 + d]
        r = torch.sqrt(r2)
        hinv = p[1 + d]
        x = r * hinv
        t = torch.clamp(1.0 - x, min=0.0)
        t2 = t * t
        hpow = hinv * hinv if d == 2 else hinv * hinv * hinv
        ker = CW * t2 * t2 * (1.0 + 4.0 * x) * hpow
        return [maskf * wq * ker]

    return body


def _momentum_body(cfg, d: int = 2):
    """Symmetric P′ gradient plus Monaghan viscosity (fields occ, x[d], h,
    m, v[d], ρ_f, P′/ρ², c), term for term the Pallas momentum body."""
    alpha, beta, eps = cfg.alpha, cfg.beta, cfg.eps
    DW = _rdw_const(d)
    div = _div_fn(cfg)

    def body(p, q, r2, maskf):
        hp, rhop, Ap, cp = p[1 + d], p[3 + 2 * d], p[4 + 2 * d], p[5 + 2 * d]
        mq, rhoq, Aq, cq = q[2 + d], q[3 + 2 * d], q[4 + 2 * d], q[5 + 2 * d]
        r = torch.sqrt(r2)
        h_ij = 0.5 * (hp + q[1 + d])
        hinv = div(1.0, h_ij)
        t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
        hinv2 = hinv * hinv
        ker = DW * t * t * t * (hinv2 * hinv2 if d == 2
                                else hinv2 * hinv2 * hinv)
        dx = [p[1 + a] - q[1 + a] for a in range(d)]
        dv = [p[3 + d + a] - q[3 + d + a] for a in range(d)]
        dot = _dot(dx, dv)
        c_ij = 0.5 * (cp + cq)
        rho_ij = 0.5 * (rhop + rhoq)
        mu_ij = div(h_ij * dot, r2 + eps * h_ij * h_ij)
        pi_ij = div(-alpha * c_ij * mu_ij + beta * mu_ij * mu_ij, rho_ij)
        s = -mq * ker * (Ap + Aq + (dot < 0.0).to(torch.float32) * pi_ij)
        return [s * dx[a] for a in range(d)]

    return body


def _dambreak_mass_body(cfg, d: int):
    """Fixed-h continuity Σ kc·t³·(x_pq·v_pq + 2ν(ρ_p − ρ_q)) (fields occ,
    x[d], v[d], ρ), term for term the Pallas dam-break mass body."""
    kc, hinv = _dambreak_consts(cfg, d)
    two_nu = 2.0 * cfg.nu

    def body(p, q, r2, maskf):
        r = torch.sqrt(r2)
        t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
        ker = kc * t * t * t
        dx = [p[1 + a] - q[1 + a] for a in range(d)]
        dv = [p[1 + d + a] - q[1 + d + a] for a in range(d)]
        drho = p[1 + 2 * d] - q[1 + 2 * d]
        return [ker * (_dot(dx, dv) + two_nu * drho)]

    return body


def _dambreak_force_body(cfg, d: int):
    """Fixed-h fluid-only force −ker·(Pt_p + Pt_q)·x_pq + ker·(2μ/ρ0²)·v_pq
    with the p-side FLUID gate in t (fields occ, x[d], v[d], Pt, fluid), term
    for term the Pallas dam-break force body."""
    kc, hinv = _dambreak_consts(cfg, d)
    visc_c = 2.0 * cfg.mu / cfg.rho0**2

    def body(p, q, r2, maskf):
        r = torch.sqrt(r2)
        t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf * p[2 + 2 * d]
        ker = kc * t * t * t
        s = -ker * (p[1 + 2 * d] + q[1 + 2 * d])
        w = ker * visc_c
        return [s * (p[1 + a] - q[1 + a]) + w * (p[1 + d + a] - q[1 + d + a])
                for a in range(d)]

    return body


def _legacy_mass_body(cfg, d: int, adaptive: bool):
    """Legacy continuity Σ ker·(x_pq·v_pq): ker = kc·t³·m_q with fixed h0
    (fields occ, x[d], v[d], m), or rDW(h_p, r)·wq_q with 1/h_p streamed
    (fields occ, x[d], 1/h, v[d], wq); term for term the Pallas
    ``legacy_mass_pass``/``iso_static_mass_pass`` bodies."""
    DW = _rdw_const(d)
    kc, hinv = _legacy_consts(cfg, d)
    vo = 2 + d if adaptive else 1 + d

    def body(p, q, r2, maskf):
        r = torch.sqrt(r2)
        if adaptive:
            hi = p[1 + d]
            t = torch.clamp(1.0 - r * hi, min=0.0) * maskf
            h2 = hi * hi
            ker = DW * t * t * t * (h2 * h2 if d == 2 else h2 * h2 * hi)
            ker = ker * q[vo + d]
        else:
            t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
            ker = kc * t * t * t * q[vo + d]
        dx = [p[1 + a] - q[1 + a] for a in range(d)]
        dv = [p[vo + a] - q[vo + a] for a in range(d)]
        return [ker * _dot(dx, dv)]

    return body


def _legacy_av_pi(cfg, mu_av, ri_sum):
    """The Monaghan Π of the legacy bodies, (−α·c·μ + 2α·μ²)·½(1/ρ_p+1/ρ_q)."""
    av = cfg.av_alpha
    return ((-av * cfg.c_av * mu_av + (2.0 * av) * mu_av * mu_av)
            * 0.5 * ri_sum)


def _legacy_force_body(cfg, d: int, adaptive: bool):
    """Legacy pressure + 8μ viscous force (+ the FLUID-gated Monaghan term
    with ``cfg.av_alpha``), fixed h0 or per-particle h (fields occ, x[d],
    (h,) v[d], m, P/ρ², 1/ρ (, fluid)); term for term the Pallas
    ``legacy_force_pass``/``iso_static_force_pass`` bodies."""
    DW = _rdw_const(d)
    kc, hinv = _legacy_consts(cfg, d)
    eps_h2 = 0.01 * cfg.h0 * cfg.h0
    mu8 = 8.0 * cfg.mu
    av = cfg.av_alpha
    div = _div_fn(cfg)
    vo = 2 + d if adaptive else 1 + d
    mo = vo + d  # m, P/ρ², 1/ρ, fluid

    def body(p, q, r2, maskf):
        r = torch.sqrt(r2)
        dx = [p[1 + a] - q[1 + a] for a in range(d)]
        dv = [p[vo + a] - q[vo + a] for a in range(d)]
        dot = _dot(dx, dv)
        if adaptive:
            hp = p[1 + d]
            hi = div(1.0, hp)
            t = torch.clamp(1.0 - r * hi, min=0.0) * maskf
            h2 = hi * hi
            ker = DW * t * t * t * (h2 * h2 if d == 2 else h2 * h2 * hi)
            ker = ker * q[mo]
            h_pq = hp + q[1 + d]
            di = div(dot, r2 + 0.0025 * h_pq * h_pq)
        else:
            t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
            ker = kc * t * t * t * q[mo]
            di = div(dot, r2 + eps_h2)
        s = -ker * (p[mo + 1] + q[mo + 1])
        w = mu8 * ker * p[mo + 2] * q[mo + 2] * di
        if av:
            both = p[mo + 3] * q[mo + 3]
            mu_av = (0.5 * h_pq if adaptive else cfg.h0) * di
            pi = _legacy_av_pi(cfg, mu_av, p[mo + 2] + q[mo + 2])
            w = w - both * (dot < 0.0).to(torch.float32) * ker * pi
        return [(s + w) * dx[a] for a in range(d)]

    return body


def _adia_entropy_force_body(cfg, d: int):
    """Fused adiabatic entropy production (both-FLUID, dt folded in) and the
    fixed-h0 legacy force sharing ker, x_pq·v_pq and 1/(r²+0.01h0²) (fields
    occ, x[d], v[d], m, P/ρ², 1/ρ, fluid, m/T): outputs (dS, Dv[d]), term
    for term the Pallas ``adia_entropy_force_pass`` body."""
    kc, hinv = _legacy_consts(cfg, d)
    eps_h2 = 0.01 * cfg.h0 * cfg.h0
    mu8 = 8.0 * cfg.mu
    mu4dt = 4.0 * cfg.mu * cfg.dt
    av = cfg.av_alpha
    div = _div_fn(cfg)
    mo = 1 + 2 * d  # m, P/ρ², 1/ρ, fluid, m/T

    def body(p, q, r2, maskf):
        r = torch.sqrt(r2)
        t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
        kerq = kc * t * t * t * q[mo]
        dx = [p[1 + a] - q[1 + a] for a in range(d)]
        dv = [p[1 + d + a] - q[1 + d + a] for a in range(d)]
        dot = _dot(dx, dv)
        rr = p[mo + 2] * q[mo + 2]
        di = div(dot, r2 + eps_h2)
        s = -kerq * (p[mo + 1] + q[mo + 1])
        both = p[mo + 3] * q[mo + 3]
        w = mu8 * kerq * rr * di
        if av:
            pi = _legacy_av_pi(cfg, cfg.h0 * di, p[mo + 2] + q[mo + 2])
            w = w - both * (dot < 0.0).to(torch.float32) * kerq * pi
        dS = -mu4dt * p[mo + 4] * kerq * rr * dot * di * both
        return [dS] + [(s + w) * dx[a] for a in range(d)]

    return body


def _pressure_body(p, q, r2, maskf):
    """Σ w_q·W₂(h̄, r), h̄ = ½(h_p+h_q), with the exact divides of
    ``wendland2`` (fields occ, x0, x1, h, w)."""
    r = torch.sqrt(r2)
    hk = 0.5 * (p[3] + q[3])
    x = r / hk
    t = torch.clamp(1.0 - x, min=0.0)
    t2 = t * t
    ker = C_W2 * (t2 * t2) * (1.0 + 4.0 * x) / (hk * hk)
    return [maskf * q[4] * ker]


def _hopkins_body(cfg, background_split: bool):
    """Two-kernel P^(1−2/γ) gradient (minus its background form with the
    split) plus Monaghan viscosity, term for term the Pallas Hopkins body
    (fields occ, x0, x1, h, m, v0, v1, ρ_f, c, A^{1/γ}, P_e[, A_bg^{1/γ},
    P_bg,e])."""
    alpha, beta, eps = cfg.alpha, cfg.beta, cfg.eps
    DW = _rdw_const(2)
    div = _div_fn(cfg)

    def body(p, q, r2, maskf):
        hp, hq, mq = p[3], q[3], q[4]
        r = torch.sqrt(r2)

        def rdw(h):
            hinv = div(1.0, h)
            t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
            hinv2 = hinv * hinv
            return DW * t * t * t * (hinv2 * hinv2)

        ker_i = rdw(hp)
        ker_j = rdw(hq)
        s = -mq * p[9] * q[9] * (p[10] * ker_i + q[10] * ker_j)
        if background_split:
            s = s + mq * p[11] * q[11] * (p[12] * ker_i + q[12] * ker_j)
        dx = [p[1] - q[1], p[2] - q[2]]
        dv = [p[5] - q[5], p[6] - q[6]]
        dot = dx[0] * dv[0] + dx[1] * dv[1]
        h_ij = 0.5 * (hp + hq)
        ker = rdw(h_ij)
        c_ij = 0.5 * (p[8] + q[8])
        rho_ij = 0.5 * (p[7] + q[7])
        mu_ij = div(h_ij * dot, r2 + eps * h_ij * h_ij)
        pi_ij = div(-alpha * c_ij * mu_ij + beta * mu_ij * mu_ij, rho_ij)
        s = s + (dot < 0.0).to(torch.float32) * (-mq) * pi_ij * ker
        return [s * dx[0], s * dx[1]]

    return body


def _pavelka_mass_body(cfg):
    """δ-SPH continuity: ρ_p·ker·(x_pq·v_pq) plus the fluid–fluid density
    diffusion, ker = wq_q·rDW(h̄, r); term for term the Pallas Pavelka mass
    body (fields occ, x0, x1, h, v0, v1, ρ_f, wq, fluid)."""
    DW = _rdw_const(2)
    two_nu = 2.0 * cfg.nu
    fixed = cfg.fixed_diffusion
    div = _div_fn(cfg)

    def body(p, q, r2, maskf):
        rhop, rhoq = p[6], q[6]
        r = torch.sqrt(r2)
        h_ij = 0.5 * (p[3] + q[3])
        hinv = div(1.0, h_ij)
        t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
        hinv2 = hinv * hinv
        ker = q[7] * DW * t * t * t * (hinv2 * hinv2)
        dot = (p[1] - q[1]) * (p[4] - q[4]) + (p[2] - q[2]) * (p[5] - q[5])
        conv = rhop * ker * dot
        if fixed:  # Molteni–Colagrossi
            diff = two_nu * (rhop - rhoq) * ker
        else:      # the reference's kernel-less form: diverges by design
            # a tensor numerator: torch takes scalar / tensor as
            # reciprocal times scalar, which rounds twice
            diff = div(torch.full_like(rhop, two_nu), rhop) * (rhop - rhoq) * maskf
        return [conv + (p[8] * q[8]) * diff]

    return body


def _pavelka_momentum_entropy_body(cfg):
    """Pressure gradient + laminar viscosity (Dv) and the fluid–fluid
    viscous entropy production with dt folded in (dS), sharing ker and
    x_pq·v_pq; term for term the Pallas fused Pavelka body (fields occ, x0,
    x1, h, m, v0, v1, ρ_f, wq, P/ρ_f², T_f, fluid)."""
    DW = _rdw_const(2)
    mu, dt = cfg.mu, cfg.dt
    div = _div_fn(cfg)

    def body(p, q, r2, maskf):
        hp, hq = p[3], q[3]
        rhop, rhoq = p[7], q[7]
        r = torch.sqrt(r2)
        h_ij = 0.5 * (hp + hq)
        hinv = div(1.0, h_ij)
        t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
        hinv2 = hinv * hinv
        ker = q[8] * DW * t * t * t * (hinv2 * hinv2)
        dx = [p[1] - q[1], p[2] - q[2]]
        dot = dx[0] * (p[5] - q[5]) + dx[1] * (p[6] - q[6])
        du = -rhop * ker * (p[9] + q[9])
        hs = hp + hq
        visc = div(div(rhop * 8.0 * ker * mu, rhop * rhoq) * dot,
                   r2 + 0.0025 * (hs * hs))
        s = du + visc
        dS = (div(div(-4.0 * p[4] * q[4] * ker * mu, p[10] * rhoq) * dot * dot,
                  r2 + 0.01 * hp * hq) * dt) * (p[11] * q[11])
        return [s * dx[0], s * dx[1], dS]

    return body


def _gamma_grad_body(V0: float):
    """Σ V0·rDW(h_p, r)·x_pq with exact divides (fields occ, x0, x1, h). The
    self pair contributes exactly 0 (x_pq = 0)."""
    coef = V0 * _rdw_const(2)

    def body(p, q, r2, maskf):
        r = torch.sqrt(r2)
        hinv = 1.0 / p[3]
        t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
        hinv2 = hinv * hinv
        ker = coef * t * t * t * (hinv2 * hinv2)
        return [ker * (p[1] - q[1]), ker * (p[2] - q[2])]

    return body


def _isph_consts(cfg):
    """(1/h0, −C·(1/h0)⁸) of the cubic-spline weight, in double on the host
    as the reference computes them (C = 240/(7π))."""
    hinv = 1.0 / cfg.h0
    h4 = hinv * hinv
    return hinv, -C_DSPLINE23 * (h4 * h4)


def _rd_spline23(hinv: float, kw: float, r):
    """(dw/dr)/r of the 2-D cubic spline at fixed h0 (``kernels.rDspline23``
    with 1/h0⁴ folded into kw): kw·(x < ½ ? 2 − 3x : (1−x)₊²/max(x, ½)),
    x = r/h0, with an exact divide. The mask is left to the caller."""
    x = r * hinv
    inner = 2.0 - 3.0 * x
    tpos = torch.clamp(1.0 - x, min=0.0)
    outer = tpos * tpos / torch.clamp(x, min=0.5)
    return kw * torch.where(x < 0.5, inner, outer)


def _isph_div_visc_body(cfg, d: int):
    """Raw spline sums Σ rD·(x_pq·v_pq, 1, r², v_pq[d]) (fields occ, x[d],
    v[d]), term for term the Pallas ``isph_div_visc_pass`` body."""
    hinv, kw = _isph_consts(cfg)

    def body(p, q, r2, maskf):
        w = maskf * _rd_spline23(hinv, kw, torch.sqrt(r2))
        dx = [p[1 + a] - q[1 + a] for a in range(d)]
        dv = [p[1 + d + a] - q[1 + d + a] for a in range(d)]
        return [w * _dot(dx, dv), w, w * r2] + [w * dv[a] for a in range(d)]

    return body


def _isph_matvec_body(cfg, d: int):
    """Σ rD(h0, r)·v_q (fields occ, x[d], v), the Pallas matvec body."""
    hinv, kw = _isph_consts(cfg)

    def body(p, q, r2, maskf):
        return [maskf * _rd_spline23(hinv, kw, torch.sqrt(r2)) * q[1 + d]]

    return body


def _isph_grad_body(cfg, d: int):
    """Per axis Σ rD·(P_p + P_q)·x_pq (fields occ, x[d], P), the Pallas
    ``isph_grad_pass`` body."""
    hinv, kw = _isph_consts(cfg)

    def body(p, q, r2, maskf):
        w = maskf * _rd_spline23(hinv, kw, torch.sqrt(r2))
        s = w * (p[1 + d] + q[1 + d])
        return [s * (p[1 + a] - q[1 + a]) for a in range(d)]

    return body


def _rb_consts(cfg, dim: int):
    """(kc, 1/h, 2κ) of the fixed-h Rayleigh–Bénard body: kc = m·(−C of
    rDW)/h^(dim+2), in double on the host as the reference computes them."""
    return (cfg.m * _rdw_const(dim) / cfg.h ** (dim + 2), 1.0 / cfg.h,
            2.0 * cfg.kappa)


def _rb_mass_heat_body(cfg, d: int):
    """Fused continuity kc·t³·(x_pq·v_pq) and Cleary–Monaghan conduction
    2κ·(1/ρ)_q·kc·t³·(T_p − T_q) (fields occ, x[d], v[d], T, 1/ρ gated),
    term for term the Pallas ``rb_mass_heat_pass`` body."""
    kc, hinv, twokap = _rb_consts(cfg, d)

    def body(p, q, r2, maskf):
        r = torch.sqrt(r2)
        t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
        ker = kc * t * t * t
        dx = [p[1 + a] - q[1 + a] for a in range(d)]
        dv = [p[1 + d + a] - q[1 + d + a] for a in range(d)]
        dT = p[1 + 2 * d] - q[1 + 2 * d]
        return [ker * _dot(dx, dv), twokap * q[2 + 2 * d] * ker * dT]

    return body


def _occupied_box(occ: torch.Tensor):
    """Per grid axis, the slice that spans the occupied cells of the
    occupancy grid [cap, *grid]; None if no slot is occupied."""
    cells = occ.sum(dim=0) > 0.5
    if not bool(cells.any()):
        return None
    box = []
    for ax in range(cells.ndim):
        others = tuple(a for a in range(cells.ndim) if a != ax)
        idx = torch.nonzero(cells.any(dim=others) if others else cells)
        box.append(slice(int(idx.min()), int(idx.max()) + 1))
    return tuple(box)


# the largest [q ranks, cap, cells] block one plain stencil offset evaluates
# at once (64 MiB per f32 temporary); the q ranks are split into chunks of it
_PLAIN_BLOCK = 1 << 24


def _sweep_plain(engine, planes, pad_vals, band, body, n_out: int,
                 self_pair: bool):
    """The pair-sweep harness in plain PyTorch: p fields are the
    [1, cap, (nz,) ny, nx] grid, q fields at a block of ranks ``kq`` and one
    stencil offset a shifted [ranks, 1, (nz,) ny, nx] view of the padded
    grid. For each rank the offsets' contributions are summed first and the
    ranks are then added to the accumulator one after another: the kernel's
    order, element for element. Masked pairs contribute exactly zero,
    because every hoisted input (and every pad) is finite."""
    cap = engine.cap
    full = engine.grid_shape
    d = engine.dim
    C = engine.num_cells
    dev = planes[0].device
    G = [pl[:, :C].reshape((cap,) + full) for pl in planes]
    # work on the bounding box of the occupied cells only: cells outside it
    # hold no p slot and, like the pads, no q slot (the grid is rounded up
    # to multiples of 128 and 8 cells, so small systems fill little of it)
    box = _occupied_box(G[0])
    if box is None:
        return [torch.zeros_like(planes[0]).reshape(-1) for _ in range(n_out)]
    G = [g[(slice(None),) + box] for g in G]
    grid = tuple(G[0].shape[1:])
    P = [F.pad(g, (1, 1) * d, value=v) for g, v in zip(G, pad_vals)]
    Gp = [g.unsqueeze(0) for g in G]                      # [1, cap, *grid]
    occ_p = Gp[0] > 0.5
    hh = torch.tensor(engine.h * engine.h, dtype=torch.float32, device=dev)
    ranks = torch.arange(cap, device=dev)
    other = (ranks[:, None] != ranks[None, :]).reshape((cap, cap) + (1,) * d)
    acc = [torch.zeros((cap,) + grid, dtype=torch.float32, device=dev)
           for _ in range(n_out)]
    cells = 1
    for n in grid:
        cells *= n
    # q ranks past the largest band occupancy are empty everywhere
    kend = int(band.max())
    step = max(1, _PLAIN_BLOCK // (cap * cells))
    for k0 in range(0, kend, step):
        ks = slice(k0, min(k0 + step, kend))
        shape = (ks.stop - ks.start, cap) + grid
        tot = None
        for off in engine.stencil:
            window = (ks,) + tuple(slice(1 + o, 1 + o + n)
                                   for o, n in zip(reversed(off), grid))
            q = [Pf[window].unsqueeze(1) for Pf in P]     # [ranks, 1, *grid]
            r2 = (Gp[1] - q[1]) ** 2 + (Gp[2] - q[2]) ** 2
            if d == 3:
                r2 = r2 + (Gp[3] - q[3]) ** 2
            mask = occ_p & (q[0] > 0.5) & (r2 <= hh)
            if not self_pair and not any(off):
                mask = mask & other[ks]
            contribs = [c.expand(shape) for c in
                        body(Gp, q, r2, mask.to(torch.float32))]
            tot = contribs if tot is None else [t + c for t, c in zip(tot, contribs)]
        for j in range(shape[0]):
            acc = [a + t[j] for a, t in zip(acc, tot)]
    outs = []
    for a in acc:
        whole = torch.zeros((cap,) + full, dtype=torch.float32, device=dev)
        whole[(slice(None),) + box] = a
        outs.append(engine.to_flat(whole))
    return outs


def density_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``density_pass``."""
    planes, pad_vals = _density_inputs(engine, state, state.fields["m"])
    band, _ = row_kmax(engine, state)
    (out,) = _sweep_plain(engine, planes, pad_vals, band,
                          _density_body(engine.dim), 1,
                          self_pair=cfg.self_density)
    return out


def momentum_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``momentum_pass``: the per-axis Dv pair sums."""
    planes, pad_vals = _momentum_inputs(engine, state, cfg)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band,
                        _momentum_body(cfg, engine.dim), engine.dim,
                        self_pair=False)


def dambreak_mass_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``dambreak_mass_pass``."""
    planes, pad_vals = _dambreak_mass_inputs(engine, state)
    band, _ = row_kmax(engine, state)
    (out,) = _sweep_plain(engine, planes, pad_vals, band,
                          _dambreak_mass_body(cfg, engine.dim), 1,
                          self_pair=False)
    return out


def dambreak_force_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``dambreak_force_pass``: the per-axis pair sums."""
    planes, pad_vals = _dambreak_force_inputs(engine, state)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band,
                        _dambreak_force_body(cfg, engine.dim), engine.dim,
                        self_pair=False)


def legacy_mass_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``legacy_mass_pass``."""
    planes, pad_vals = _legacy_mass_inputs(engine, state)
    band, _ = row_kmax(engine, state)
    (out,) = _sweep_plain(engine, planes, pad_vals, band,
                          _legacy_mass_body(cfg, engine.dim, False), 1,
                          self_pair=False)
    return out


def iso_static_mass_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``iso_static_mass_pass``."""
    planes, pad_vals = _iso_static_mass_inputs(engine, state)
    band, _ = row_kmax(engine, state)
    (out,) = _sweep_plain(engine, planes, pad_vals, band,
                          _legacy_mass_body(cfg, engine.dim, True), 1,
                          self_pair=False)
    return out


def legacy_force_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``legacy_force_pass``: the per-axis Dv pair sums."""
    planes, pad_vals = _legacy_force_inputs(engine, state, cfg, False)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band,
                        _legacy_force_body(cfg, engine.dim, False), engine.dim,
                        self_pair=False)


def iso_static_force_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``iso_static_force_pass``: the per-axis Dv pair sums."""
    planes, pad_vals = _legacy_force_inputs(engine, state, cfg, True)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band,
                        _legacy_force_body(cfg, engine.dim, True), engine.dim,
                        self_pair=False)


def adia_entropy_force_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``adia_entropy_force_pass``: (dS, Dv0, Dv1)."""
    planes, pad_vals = _adia_entropy_force_inputs(engine, state)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band,
                        _adia_entropy_force_body(cfg, engine.dim),
                        1 + engine.dim, self_pair=False)


def adia_density_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``adia_density_pass``: ``density_pass_plain`` with the
    gated weight as the mass and the self pair."""
    return density_pass_plain(
        engine, state.replace(m=_adia_density_weight(state, cfg)),
        types.SimpleNamespace(self_density=True))


def pressure_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``pressure_pass``."""
    planes, pad_vals = _pressure_inputs(engine, state, cfg)
    band, _ = row_kmax(engine, state)
    (out,) = _sweep_plain(engine, planes, pad_vals, band, _pressure_body, 1,
                          self_pair=cfg.self_density)
    return out


def hopkins_momentum_pass_plain(engine, state: ParticleState, cfg,
                                background_split: bool):
    """Plain twin of ``hopkins_momentum_pass``: the per-axis Dv pair sums."""
    planes, pad_vals = _hopkins_inputs(engine, state, cfg, background_split)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band,
                        _hopkins_body(cfg, background_split), 2,
                        self_pair=False)


def pavelka_mass_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``pavelka_mass_pass``."""
    planes, pad_vals = _pavelka_mass_inputs(engine, state, cfg)
    band, _ = row_kmax(engine, state)
    (out,) = _sweep_plain(engine, planes, pad_vals, band,
                          _pavelka_mass_body(cfg), 1, self_pair=False)
    return out


def pavelka_momentum_entropy_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``pavelka_momentum_entropy_pass``: (Dv0, Dv1, dS)."""
    planes, pad_vals = _pavelka_momentum_entropy_inputs(engine, state, cfg)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band,
                        _pavelka_momentum_entropy_body(cfg), 3,
                        self_pair=False)


def gamma_grad_pass_plain(engine, state: ParticleState, V0: float):
    """Plain twin of ``gamma_grad_pass``: the two components of ∇Γ."""
    planes, pad_vals = _gamma_grad_inputs(engine, state)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band, _gamma_grad_body(V0),
                        2, self_pair=True)


def isph_div_visc_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``isph_div_visc_pass``: (S_divv, S_L, S_lam, S_dv[d])."""
    planes, pad_vals = _isph_div_visc_inputs(engine, state)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band,
                        _isph_div_visc_body(cfg, engine.dim), 3 + engine.dim,
                        self_pair=False)


def isph_grad_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``isph_grad_pass``: the per-axis raw sums."""
    planes, pad_vals = _isph_grad_inputs(engine, state)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band,
                        _isph_grad_body(cfg, engine.dim), engine.dim,
                        self_pair=False)


def isph_matvec_pass_plain(engine, state: ParticleState, cfg, v):
    """Plain twin of ``isph_matvec_pass``: Σ_q rD(h0, r)·v_q."""
    planes, pad_vals = _isph_matvec_inputs(engine, state)
    band, _ = row_kmax(engine, state)
    (out,) = _sweep_plain(engine, planes + [_plane(engine, v)], pad_vals,
                          band, _isph_matvec_body(cfg, engine.dim), 1,
                          self_pair=False)
    return out


def rb_mass_heat_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``rb_mass_heat_pass``: (Drho, DT)."""
    planes, pad_vals = _rb_mass_heat_inputs(engine, state, cfg)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band,
                        _rb_mass_heat_body(cfg, engine.dim), 2,
                        self_pair=False)


# ----------------------------------------------------------- CUDA kernels

def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer; None is a null pointer (an input the
    kernel does not read)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check_planes(engine, planes, band, n_bound):
    shape = (engine.cap, engine.num_cells + 1)
    dev = planes[0].device
    for pl in planes:
        if pl is None:
            continue
        if (pl.device != dev or pl.dtype != torch.float32
                or tuple(pl.shape) != shape or not pl.is_contiguous()):
            raise ValueError(f"sweep input must be contiguous f32 {shape} "
                             f"on {dev}, got {pl.dtype} {tuple(pl.shape)} "
                             f"on {pl.device}")
    if (band.device != dev or band.dtype != torch.int32
            or band.numel() != n_bound):
        raise ValueError(f"trip bound must be int32 [{n_bound}] on the "
                         "planes' device")


class TilePlan(NamedTuple):
    """Launch plan of the tiled sweeps (``pair_sweep_tiled`` in 2-D,
    ``pair_sweep3_tiled`` in 3-D)."""
    tx: int            # x-cells per block
    block: tuple       # (tx, cap) threads: one per p slot of the tile
    smem_bytes: int    # dynamic shared memory: `stages` stages of q planes
    stages: int        # 2 (the two-stage pipeline) or cap (every rank at once)


# the tiled sweeps' block size bound (their __launch_bounds__), their
# widest tile (their offset tables' size), and a block's shared memory on an
# H100 (227 KB); the launch refuses a plan beyond the first two
_TILE_THREADS = 256
_TILE_MAX_X = 32
_MAX_SHARED_BYTES = 232_448
# q planes the tiled exports stage per cell (occupancy and coordinates
# included): the 3-D density body reads w of q (not 1/h), the 3-D momentum
# body every plane of q, the 3-D dam-break bodies v and ρ or v and P/ρ² (the
# force's FLUID gate is read on the p side only); the Pavelka continuity h,
# v, ρ_f, wq and the FLUID gate, the fused Pavelka sweep h, m, v, ρ_f, wq,
# P/ρ_f² and the FLUID gate (T_f is read on the p side only); the 2-D
# momentum every plane of q; the Hopkins momentum every plane of q, 11 in
# the total form and 13 with the background split (A_bg^{1/γ} and P_bg,e),
# keyed by ``background_split``; the Hopkins pressure root h and w (the
# float4 of occupancy, x and h, then w), in either self-pair form; the
# terrain continuity every plane of q (the float4 of occupancy, x and v0,
# then v1 and m); the terrain force every plane of q (the float4, then v1,
# m, P/ρ_f², 1/ρ_f), 8 without AV and 9 with it (the FLUID gate), keyed by
# the AV switch; the ISPH matvec the float4 of occupancy, x and the iterate,
# nothing besides; the 2-D density the float4 of occupancy, x and 1/h, then w
# (with the self pair or without it; the adiabatic density is the same
# export with the gated w); the packing's ∇Γ sum the float4 of occupancy, x
# and h, nothing besides; the 2-D dam-break continuity the float4 of
# occupancy, x and v0, then v1 and ρ (its 3-D form is
# ``dambreak_mass_sweep_3d``); the 2-D dam-break force the float4 of
# occupancy, x and v0, then v1 and P/ρ² (the FLUID gate is read on the p side
# only; its 3-D form is ``dambreak_force_sweep_3d``); the Rayleigh–Bénard
# continuity + conduction the float4 of occupancy, x and v0, then v1, T and
# 1/ρ; the ISPH divergence/viscous sweep the float4 of occupancy, x and v0,
# then v1; the ISPH pressure gradient the float4 of occupancy, x and P,
# nothing besides; the per-particle-h (isothermal static) force every plane
# of q (the float4 of occupancy, x and h, then v0, v1, m, P/ρ_f², 1/ρ_f), 9
# without AV and 10 with it (the FLUID gate), keyed by the AV switch; the
# per-particle-h (isothermal static) continuity the float4 of occupancy, x
# and 1/h (read on the p side only), then v0, v1 and m/ρ; the fused adiabatic
# entropy + force sweep the float4 of occupancy, x and v0, then v1, m,
# P/ρ_f², 1/ρ_f and the FLUID gate (which the entropy term reads with or
# without AV; m/T is read on the p side only), one form. A form's key is
# ``_FORM_KEY``'s (``_staged``)
_TILED_STAGED = {"density_sweep_3d": 5, "momentum_sweep_3d": 12,
                 "dambreak_mass_sweep_3d": 8, "dambreak_force_sweep_3d": 8,
                 "pavelka_mass_sweep": 9,
                 "pavelka_momentum_entropy_sweep": 11,
                 "momentum_sweep": 10,
                 "pressure_sweep": 5,
                 "hopkins_momentum_sweep": {False: 11, True: 13},
                 "legacy_mass_sweep": 6,
                 "legacy_force_sweep": {False: 8, True: 9},
                 "isph_matvec_sweep": 4,
                 "density_sweep": 5,
                 "gamma_grad_sweep": 4,
                 "dambreak_mass_sweep": 6,
                 "dambreak_force_sweep": 6,
                 "rb_mass_heat_sweep": 7,
                 "isph_div_visc_sweep": 5,
                 "isph_grad_sweep": 4,
                 "iso_static_force_sweep": {False: 9, True: 10},
                 "iso_static_mass_sweep": 7,
                 "adia_entropy_force_sweep": 9}
# the tiled exports with two forms, and what names the form: the Hopkins
# momentum's ``background_split`` argument, the AV switch of the terrain
# force and of the per-particle-h force (``cfg.av_alpha > 0``)
_FORM_KEY = {"hopkins_momentum_sweep": "background_split",
             "legacy_force_sweep": "av",
             "iso_static_force_sweep": "av"}
# the 2-D tiled sweep's staging scheme: every q rank up to the tile's bound
# in one go (one barrier) rather than the two-stage pipeline the 3-D sweep
# runs; both give the same outputs bit for bit, and this one was the faster
# on an H100 (PERF.md §6)
_EVERY_RANK = True


def _staged(fn_name: str, form: bool | None = None) -> int:
    """The q planes the tiled export ``fn_name`` stages a cell. The Hopkins
    momentum's and the two terrain forces' counts depend on their form
    (``_FORM_KEY``: ``background_split``, the AV switch), so ``form`` must
    be given for them, and only for them: neither form takes the other's
    plan."""
    staged = _TILED_STAGED[fn_name]
    if isinstance(staged, dict) != (form is not None):
        raise ValueError(
            f"{fn_name}: its form ({_FORM_KEY[fn_name]}) is needed"
            if isinstance(staged, dict) else
            f"{fn_name} has one form: no form key "
            f"({', '.join(sorted(set(_FORM_KEY.values())))}) applies")
    return staged[bool(form)] if isinstance(staged, dict) else staged


def _tile_tx(engine) -> int:
    """The tiled sweeps' x-cells per block, min(32, 256 // cap), whatever
    they stage; raises ValueError for a cap the templates cannot take."""
    cap = engine.cap
    if not 1 <= cap <= _TILE_THREADS:
        raise ValueError(f"the tiled sweep takes 1 to {_TILE_THREADS} "
                         f"ranks per cell (a block thread per p slot), got "
                         f"cap {cap}")
    return min(_TILE_MAX_X, _TILE_THREADS // cap)


def _tile_plan(engine, staged: int, every_rank: bool | None = None
               ) -> TilePlan:
    """The tiled sweep's launch plan for ``staged`` q planes: TX = min(32,
    256 // cap) x-cells of one grid row times every rank, one thread per p
    slot, and stages of (TX+2)·3 cells (2-D) or (TX+2)·9 cells (3-D), each
    rounded up to 16 bytes: two of them (the pipeline), or one per rank with
    ``every_rank`` (2-D only; its default there is ``_EVERY_RANK``).
    ``_launch`` passes it to the export. Raises ValueError for a shape the
    templates cannot take."""
    cap = engine.cap
    if engine.dim == 3 and every_rank:
        raise ValueError("the tiled 3-D sweep stages two ranks at a time")
    if every_rank is None:
        every_rank = engine.dim == 2 and _EVERY_RANK
    tx = _tile_tx(engine)
    if staged < 4:
        raise ValueError(f"the tiled sweep stages 4 planes a cell at least "
                         f"(one float4), got {staged}")
    cells = (tx + 2) * 3 ** (engine.dim - 1)
    stage = (cells * 4 * staged + 15) // 16 * 16
    stages = max(cap, 2) if every_rank else 2
    if stages * stage > _MAX_SHARED_BYTES:
        raise ValueError(f"the tiled sweep's {stages} stages of {staged} "
                         f"planes take {stages * stage} B of shared memory, "
                         f"over {_MAX_SHARED_BYTES}")
    return TilePlan(tx, (tx, cap), stages * stage, stages)


def _export(fn_name: str, engine) -> str:
    """The export of csrc/pair_sweep.cu that ``fn_name`` names on
    ``engine``: a 3-D engine takes ``<fn_name>_3d``, which has nz after ny
    (a name that holds "_3d" already, such as a yardstick's
    ``density_sweep_3d_direct``, is taken as it is)."""
    return fn_name + "_3d" if engine.dim == 3 and "_3d" not in fn_name else fn_name


def _trip_bound(fn_name: str, engine, state: ParticleState) -> torch.Tensor:
    """The q-rank trip bound the export ``fn_name`` (named as ``_launch``
    names it) reads: one per x-tile (``tile_kmax``) for a tiled export, one
    per grid row (``row_kmax``'s band) for the others."""
    if _export(fn_name, engine) in _TILED_STAGED:
        return tile_kmax(engine, state, _tile_tx(engine))
    return row_kmax(engine, state)[0]


def _with_plan(fn_name: str, engine, planes, band, scalars, plan):
    """The scalars of export ``fn_name`` (as ``_export`` names it) with a
    tiled export's plan (TX, dynamic shared bytes) after them: ``plan``, or
    ``_tile_plan``'s by default (an export with two forms has none: its
    caller passes the plan of its form); the planes and the trip bound
    checked against the shape the export reads (one bound per x-tile for a
    tiled export, per grid row for the others)."""
    rows = engine.num_cells // engine.lims[0]
    n_bound = rows
    if fn_name in _TILED_STAGED:
        plan = plan or _tile_plan(engine, _staged(fn_name))
        scalars = list(scalars) + [plan.tx, plan.smem_bytes]
        n_bound = rows * -(-engine.lims[0] // plan.tx)
    _check_planes(engine, planes, band, n_bound)
    return scalars


def _raise_on(lib, fn_name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.pair_sweep_error_string(err).decode()}")


def _launch(fn_name: str, engine, planes, band, n_out, scalars, plan=None):
    """Launch one sweep of csrc/pair_sweep.cu (the export ``_export``
    names) on the current stream with the trip bound ``band`` (as
    ``_trip_bound`` gives it) and, for a tiled export, its plan
    (``_with_plan``); raise if the launch was refused."""
    fn_name = _export(fn_name, engine)
    scalars = _with_plan(fn_name, engine, planes, band, scalars, plan)
    dev = planes[0].device
    band = band.contiguous()
    outs = [torch.empty((engine.cap, engine.num_cells + 1),
                        dtype=torch.float32, device=dev) for _ in range(n_out)]
    lib = _build.load("pair_sweep")
    h2 = ctypes.c_float(engine.h * engine.h)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, fn_name, getattr(lib, fn_name)(
        *[_ptr(p) for p in planes], _ptr(band), *[_ptr(o) for o in outs],
        engine.cap, *engine.lims, h2, *scalars, stream))
    return [o.reshape(-1) for o in outs]


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (use the twin); any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"pair sweeps run on cuda or cpu tensors, not {t.device}")


def _check_2d(engine, name: str) -> None:
    """The ISPH and Rayleigh–Bénard kernels exist in 2-D only (no 3-D
    caller)."""
    if engine.dim != 2:
        raise NotImplementedError(f"{name}: 2-D engines only")


def _momentum_scalars(cfg, dim: int = 2):
    """(−C of rDW, ε, −α, β) of the momentum bodies."""
    return [ctypes.c_float(_rdw_const(dim)), ctypes.c_float(cfg.eps),
            ctypes.c_float(-cfg.alpha), ctypes.c_float(cfg.beta)]


def _fast(cfg) -> int:
    return int(bool(getattr(cfg, "fast_math", False)))


def density_pass(engine, state: ParticleState, cfg):
    """ρ_p = Σ m_q·W(h_p, r) over the stencil (W₂ on a 2-D engine, W₃ on a
    3-D one), plus the self term per ``cfg.self_density``, as a flat [slots]
    tensor. Replaces ``weighted_w_pass(ker_h="p")``/``density_pass`` of
    pallas_pairs.py. CUDA tensors launch the kernel (counted in
    ``density_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return density_pass_plain(engine, state, cfg)
    planes, _ = _density_inputs(engine, state, state.fields["m"])
    band = _trip_bound("density_sweep", engine, state)
    (out,) = _launch("density_sweep", engine, planes, band, 1,
                     [int(bool(cfg.self_density)),
                      ctypes.c_float(C_W2 if engine.dim == 2 else C_W3)])
    density_pass.launches += 1
    return out


def momentum_pass(engine, state: ParticleState, cfg):
    """Perturbation-pressure + Monaghan-viscosity momentum sweep: the
    per-axis Dv pair sums as ``engine.dim`` flat [slots] tensors. Replaces
    ``momentum_pass`` of pallas_pairs.py. CUDA tensors launch the kernel
    (counted in ``momentum_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return momentum_pass_plain(engine, state, cfg)
    planes, _ = _momentum_inputs(engine, state, cfg)
    band = _trip_bound("momentum_sweep", engine, state)
    outs = _launch("momentum_sweep", engine, planes, band, engine.dim,
                   _momentum_scalars(cfg, engine.dim) + [_fast(cfg)])
    momentum_pass.launches += 1
    return outs


def tiled_yardsticks(kernel: str, engine, state: ParticleState, cfg,
                     background_split: bool | None = None,
                     adiabatic: bool = False, V0: float | None = None):
    """Launches of a tiled sweep (``"density_sweep_3d"``, with the self pair
    per ``cfg.self_density``, ``"momentum_sweep_3d"``,
    ``"dambreak_mass_sweep_3d"``, ``"dambreak_force_sweep_3d"``,
    ``"pavelka_mass_sweep"``, ``"pavelka_momentum_entropy_sweep"``, the 2-D
    ``"density_sweep"`` with the self pair per ``cfg.self_density`` or, with
    ``adiabatic``, in the adiabatic density's form (the self pair and the
    FLUID-gated weight of ``adia_density_pass``), the 2-D
    ``"momentum_sweep"``, ``"pressure_sweep"`` with the self pair per
    ``cfg.self_density``, ``"hopkins_momentum_sweep"`` in the form
    ``background_split`` names, ``"gamma_grad_sweep"``, which takes the
    packing's ``V0`` (a keyword, as ``background_split`` is) and no config
    (``cfg`` may be None), ``"legacy_mass_sweep"``,
    ``"iso_static_mass_sweep"``, ``"legacy_force_sweep"`` and
    ``"iso_static_force_sweep"`` in the form ``cfg.av_alpha`` names,
    ``"adia_entropy_force_sweep"`` (both AV forms on one plan),
    ``"isph_matvec_sweep"``,
    ``"isph_div_visc_sweep"``, ``"isph_grad_sweep"``, the 2-D
    ``"dambreak_mass_sweep"`` or ``"dambreak_force_sweep"``, or
    ``"rb_mass_heat_sweep"``, whose sidewalls are ``cfg``'s) on planes and
    trip bounds prepared once from ``state``, by design:
    ``"tiled"`` (the export the wrapper launches, with the per-tile bound),
    ``"tiled_row_band"`` (the same export with each tile's bound its row's
    band), ``"direct"`` (the one-thread-per-slot design it replaced, with
    the row band) and, for the 2-D sweeps, the staging scheme not kept
    (``"tiled_two_stages"`` or ``"tiled_every_rank"``, per-tile bound).
    Each returns the outputs as the wrapper does (a list). The matvec's run
    in its prepared form, as the CG loop does: each design prepared once
    (``_prepared_matvec``), one launch per call on the iterate it is given,
    ``state``'s P by default, into a buffer the next call overwrites.
    Yardsticks for timing and for holding the designs bit for bit against
    each other: on no path, and no launch is counted."""
    if kernel == "density_sweep_3d":
        planes, _ = _density_inputs(engine, state, state.fields["m"])
        args, n_out = [int(bool(cfg.self_density)), ctypes.c_float(C_W3)], 1
    elif kernel == "momentum_sweep_3d":
        planes, _ = _momentum_inputs(engine, state, cfg)
        args, n_out = _momentum_scalars(cfg, 3) + [_fast(cfg)], 3
    elif kernel == "dambreak_mass_sweep_3d":
        planes, _ = _dambreak_mass_inputs(engine, state)
        args, n_out = _dambreak_mass_scalars(cfg, 3), 1
    elif kernel == "dambreak_force_sweep_3d":
        planes, _ = _dambreak_force_inputs(engine, state)
        args, n_out = _dambreak_force_scalars(cfg, 3), 3
    elif kernel == "pavelka_mass_sweep":
        planes, _ = _pavelka_mass_inputs(engine, state, cfg)
        args, n_out = _pavelka_mass_scalars(cfg), 1
    elif kernel == "pavelka_momentum_entropy_sweep":
        planes, _ = _pavelka_momentum_entropy_inputs(engine, state, cfg)
        args, n_out = _pavelka_momentum_entropy_scalars(cfg), 3
    elif kernel in ("density_sweep", "momentum_sweep", "pressure_sweep",
                    "hopkins_momentum_sweep", "gamma_grad_sweep",
                    "legacy_mass_sweep", "iso_static_mass_sweep",
                    "legacy_force_sweep", "iso_static_force_sweep",
                    "adia_entropy_force_sweep", "isph_matvec_sweep",
                    "isph_div_visc_sweep", "isph_grad_sweep",
                    "dambreak_mass_sweep", "dambreak_force_sweep",
                    "rb_mass_heat_sweep"):
        # 2-D exports: a 3-D engine's density, momentum and dam-break
        # continuity and force are "density_sweep_3d", "momentum_sweep_3d",
        # "dambreak_mass_sweep_3d" and "dambreak_force_sweep_3d", and the
        # others have no 3-D form
        _check_2d(engine, kernel)
        n_out = 2
        if kernel == "density_sweep":
            weight = (_adia_density_weight(state, cfg) if adiabatic
                      else state.fields["m"])
            planes, _ = _density_inputs(engine, state, weight)
            args = [int(adiabatic or bool(cfg.self_density)),
                    ctypes.c_float(C_W2)]
            n_out = 1
        elif kernel == "momentum_sweep":
            planes, _ = _momentum_inputs(engine, state, cfg)
            args = _momentum_scalars(cfg) + [_fast(cfg)]
        elif kernel == "pressure_sweep":
            planes, _ = _pressure_inputs(engine, state, cfg)
            args, n_out = _pressure_scalars(cfg), 1
        elif kernel == "gamma_grad_sweep":
            planes, _ = _gamma_grad_inputs(engine, state)
            args = _gamma_grad_scalars(V0)
        elif kernel == "legacy_mass_sweep":
            planes, _ = _legacy_mass_inputs(engine, state)
            args, n_out = _legacy_mass_scalars(cfg, 2, False), 1
        elif kernel == "iso_static_mass_sweep":
            planes, _ = _iso_static_mass_inputs(engine, state)
            args, n_out = _legacy_mass_scalars(cfg, 2, True), 1
        elif kernel == "adia_entropy_force_sweep":
            planes, _ = _adia_entropy_force_inputs(engine, state)
            args, n_out = _adia_entropy_force_scalars(cfg, 2), 3
        elif kernel == "dambreak_mass_sweep":
            planes, _ = _dambreak_mass_inputs(engine, state)
            args, n_out = _dambreak_mass_scalars(cfg, 2), 1
        elif kernel == "dambreak_force_sweep":
            planes, _ = _dambreak_force_inputs(engine, state)
            args = _dambreak_force_scalars(cfg, 2)
        elif kernel == "rb_mass_heat_sweep":
            planes, _ = _rb_mass_heat_inputs(engine, state, cfg)
            args = _rb_mass_heat_scalars(cfg)
        elif kernel == "isph_div_visc_sweep":
            planes, _ = _isph_div_visc_inputs(engine, state)
            args, n_out = _isph_scalars(cfg), 5
        elif kernel == "isph_grad_sweep":
            planes, _ = _isph_grad_inputs(engine, state)
            args = _isph_scalars(cfg)
        elif kernel == "hopkins_momentum_sweep":
            planes, args = _hopkins_launch_inputs(engine, state, cfg,
                                                  background_split)
        elif kernel in ("legacy_force_sweep", "iso_static_force_sweep"):
            adaptive = kernel == "iso_static_force_sweep"
            planes, _ = _legacy_force_inputs(engine, state, cfg, adaptive)
            planes = _legacy_force_planes(planes, cfg)
            args = _legacy_force_scalars(cfg, 2, adaptive)
        else:
            planes, _ = _isph_matvec_inputs(engine, state)
            args = n_out = None  # its runs are prepared (_prepared_matvec)
    else:
        raise ValueError(f"no tiled sweep {kernel!r}")
    form = (bool(cfg.av_alpha) if _FORM_KEY.get(kernel) == "av"
            else background_split)
    staged = _staged(kernel, form)
    plan = _tile_plan(engine, staged)
    tile_band = _trip_bound(kernel, engine, state)
    row_band, _ = row_kmax(engine, state)

    if kernel == "isph_matvec_sweep":
        iterate = state.fields["P"].contiguous()

        def run(name, band, plan=None):
            mv = _prepared_matvec(engine, planes, band, cfg, name, plan)
            return lambda v=iterate: [mv(v)]
    else:
        def run(name, band, plan=None):
            return lambda: _launch(name, engine, planes, band, n_out, args,
                                   plan)
    per_tile = row_band.repeat_interleave(tile_band.numel() // row_band.numel())
    runs = {"tiled": run(kernel, tile_band, plan),
            "tiled_row_band": run(kernel, per_tile, plan),
            "direct": run(kernel + "_direct", row_band)}
    if engine.dim == 2:
        other = _tile_plan(engine, staged, every_rank=not _EVERY_RANK)
        name = "tiled_two_stages" if _EVERY_RANK else "tiled_every_rank"
        runs[name] = run(kernel, tile_band, other)
    return runs


def pressure_pass(engine, state: ParticleState, cfg):
    """Hopkins smoothed-pressure root P̄_p = Σ m_q·A_q^{1/γ}·W₂(½(h_p+h_q), r)
    plus the self term per ``cfg.self_density``, as a flat [slots] tensor.
    Replaces ``weighted_w_pass(ker_h="sym")``/``pressure_pass`` of
    pallas_pairs.py (exact divides: the reference has no fast_math form of
    it). CUDA tensors launch the kernel (counted in
    ``pressure_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return pressure_pass_plain(engine, state, cfg)
    planes, _ = _pressure_inputs(engine, state, cfg)
    band = _trip_bound("pressure_sweep", engine, state)
    (out,) = _launch("pressure_sweep", engine, planes, band, 1,
                     _pressure_scalars(cfg))
    pressure_pass.launches += 1
    return out


def _pressure_scalars(cfg):
    """(self_pair, 7/π) of the pressure root: the self term per
    ``cfg.self_density``."""
    return [int(bool(cfg.self_density)), ctypes.c_float(C_W2)]


def hopkins_momentum_pass(engine, state: ParticleState, cfg,
                          background_split: bool):
    """Hopkins two-kernel P^(1−2/γ) gradient + Monaghan viscosity: the
    per-axis Dv pair sums as two flat [slots] tensors. ``background_split``
    subtracts the same form on the background state (full_hopkins); without
    it the total form (hopkins_total). Replaces ``hopkins_momentum_pass`` of
    pallas_pairs.py. CUDA tensors launch the kernel (counted in
    ``hopkins_momentum_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return hopkins_momentum_pass_plain(engine, state, cfg,
                                           background_split)
    planes, args = _hopkins_launch_inputs(engine, state, cfg,
                                          background_split)
    band = _trip_bound("hopkins_momentum_sweep", engine, state)
    plan = _tile_plan(engine, _staged("hopkins_momentum_sweep",
                                      background_split))
    outs = _launch("hopkins_momentum_sweep", engine, planes, band, 2, args,
                   plan)
    hopkins_momentum_pass.launches += 1
    return outs


def _hopkins_launch_inputs(engine, state: ParticleState, cfg,
                           background_split: bool):
    """The Hopkins export's 13 plane pointers (A_bg^{1/γ} and P_bg,e null
    in the total form, which reads neither) and its scalars."""
    planes, _ = _hopkins_inputs(engine, state, cfg, background_split)
    return (planes if background_split else planes + [None, None],
            _momentum_scalars(cfg) + [int(bool(background_split)),
                                      _fast(cfg)])


def _pavelka_mass_scalars(cfg):
    """(−C of rDW, 2ν, fixed_diffusion, fast_math) of the Pavelka mass body."""
    return [ctypes.c_float(_rdw_const(2)), ctypes.c_float(2.0 * cfg.nu),
            int(bool(cfg.fixed_diffusion)), _fast(cfg)]


def _pavelka_momentum_entropy_scalars(cfg):
    """(−C of rDW, μ, dt, fast_math) of the fused Pavelka body."""
    return [ctypes.c_float(_rdw_const(2)), ctypes.c_float(cfg.mu),
            ctypes.c_float(cfg.dt), _fast(cfg)]


def pavelka_mass_pass(engine, state: ParticleState, cfg):
    """δ-SPH continuity sweep: Drho = Σ ρ_p·(m_q/ρ_q)·rDW(h̄, r)·(x_pq·v_pq)
    plus the fluid–fluid density diffusion (Molteni–Colagrossi with
    ``cfg.fixed_diffusion``, else the reference-faithful kernel-less form),
    as a flat [slots] tensor. Replaces ``pavelka_mass_pass`` of
    pallas_pairs.py. CUDA tensors launch the kernel (counted in
    ``pavelka_mass_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return pavelka_mass_pass_plain(engine, state, cfg)
    planes, _ = _pavelka_mass_inputs(engine, state, cfg)
    band = _trip_bound("pavelka_mass_sweep", engine, state)
    (out,) = _launch("pavelka_mass_sweep", engine, planes, band, 1,
                     _pavelka_mass_scalars(cfg))
    pavelka_mass_pass.launches += 1
    return out


def pavelka_momentum_entropy_pass(engine, state: ParticleState, cfg):
    """Fused momentum + viscous entropy-production sweep: (Dv0, Dv1, dS) as
    three flat [slots] tensors, dS with ``cfg.dt`` folded in. Replaces
    ``pavelka_momentum_entropy_pass`` of pallas_pairs.py. CUDA tensors launch
    the kernel (counted in ``pavelka_momentum_entropy_pass.launches``); CPU
    tensors take the twin."""
    if not _on_cuda(state.active):
        return pavelka_momentum_entropy_pass_plain(engine, state, cfg)
    planes, _ = _pavelka_momentum_entropy_inputs(engine, state, cfg)
    band = _trip_bound("pavelka_momentum_entropy_sweep", engine, state)
    outs = _launch("pavelka_momentum_entropy_sweep", engine, planes, band, 3,
                   _pavelka_momentum_entropy_scalars(cfg))
    pavelka_momentum_entropy_pass.launches += 1
    return outs


def gamma_grad_pass(engine, state: ParticleState, V0: float):
    """The Colagrossi packing's unevenness gradient ∇Γ_p = Σ V0·rDW(h_p, r)·x_pq
    over every occupied pair (self pair included, no FLUID gate), as two
    flat [slots] tensors. An XLA pair sum in the reference
    (``utils/packing.py``, ``find_gGamma``), a hand kernel here. CUDA tensors
    launch it (counted in ``gamma_grad_pass.launches``); CPU tensors take
    the twin."""
    if not _on_cuda(state.active):
        return gamma_grad_pass_plain(engine, state, V0)
    planes, _ = _gamma_grad_inputs(engine, state)
    band = _trip_bound("gamma_grad_sweep", engine, state)
    outs = _launch("gamma_grad_sweep", engine, planes, band, 2,
                   _gamma_grad_scalars(V0))
    gamma_grad_pass.launches += 1
    return outs


def _gamma_grad_scalars(V0: float):
    """(V0·(−C of rDW)) of the ∇Γ body."""
    return [ctypes.c_float(V0 * _rdw_const(2))]


def _dambreak_mass_scalars(cfg, dim: int):
    """(kc, 1/h, 2ν) of the dam-break continuity body."""
    kc, hinv = _dambreak_consts(cfg, dim)
    return [ctypes.c_float(kc), ctypes.c_float(hinv),
            ctypes.c_float(2.0 * cfg.nu)]


def _dambreak_force_scalars(cfg, dim: int):
    """(kc, 1/h, 2μ/ρ0²) of the dam-break force body."""
    kc, hinv = _dambreak_consts(cfg, dim)
    return [ctypes.c_float(kc), ctypes.c_float(hinv),
            ctypes.c_float(2.0 * cfg.mu / cfg.rho0**2)]


def dambreak_mass_pass(engine, state: ParticleState, cfg):
    """Dam-break continuity with fixed h: Drho = Σ m·rDW(h, r)·(x_pq·v_pq +
    2ν(ρ_p − ρ_q)) as a flat [slots] tensor, in 2-D (rDW₂) or 3-D (rDW₃) by
    ``engine.dim``. Replaces ``dambreak_mass_pass`` of pallas_pairs.py. CUDA
    tensors launch the kernel (counted in ``dambreak_mass_pass.launches``);
    CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return dambreak_mass_pass_plain(engine, state, cfg)
    planes, _ = _dambreak_mass_inputs(engine, state)
    band = _trip_bound("dambreak_mass_sweep", engine, state)
    (out,) = _launch("dambreak_mass_sweep", engine, planes, band, 1,
                     _dambreak_mass_scalars(cfg, engine.dim))
    dambreak_mass_pass.launches += 1
    return out


def dambreak_force_pass(engine, state: ParticleState, cfg):
    """Dam-break fluid-only force with fixed h: −m·rDW·(P_p/ρ_p² + P_q/ρ_q²)·
    x_pq + 2m·rDW·μ/ρ0²·v_pq on FLUID p slots (a WALL slot gets exact zeros),
    as ``engine.dim`` flat [slots] tensors. Replaces ``dambreak_force_pass``
    of pallas_pairs.py. CUDA tensors launch the kernel (counted in
    ``dambreak_force_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return dambreak_force_pass_plain(engine, state, cfg)
    planes, _ = _dambreak_force_inputs(engine, state)
    band = _trip_bound("dambreak_force_sweep", engine, state)
    outs = _launch("dambreak_force_sweep", engine, planes, band, engine.dim,
                   _dambreak_force_scalars(cfg, engine.dim))
    dambreak_force_pass.launches += 1
    return outs


def _legacy_mass_scalars(cfg, dim: int, adaptive: bool):
    """(kc, 1/h0) of the fixed-h0 continuity, or the −C of rDW of the
    per-particle-h one."""
    if adaptive:
        return [ctypes.c_float(_rdw_const(dim))]
    kc, hinv = _legacy_consts(cfg, dim)
    return [ctypes.c_float(kc), ctypes.c_float(hinv)]


def _legacy_force_scalars(cfg, dim: int, adaptive: bool):
    """The legacy force kernel's constants: (kc, 1/h0, 0.01·h0², 8μ, −α·c,
    2α, h0) with fixed h0, (−C of rDW, 8μ, −α·c, 2α) with per-particle h;
    then the AV and fast_math switches."""
    av = cfg.av_alpha
    shared = [ctypes.c_float(8.0 * cfg.mu),
              ctypes.c_float(-av * cfg.c_av if av else 0.0),
              ctypes.c_float(2.0 * av)]
    switches = [int(bool(av)), _fast(cfg)]
    if adaptive:
        return [ctypes.c_float(_rdw_const(dim))] + shared + switches
    kc, hinv = _legacy_consts(cfg, dim)
    return ([ctypes.c_float(kc), ctypes.c_float(hinv),
             ctypes.c_float(0.01 * cfg.h0 * cfg.h0)] + shared
            + [ctypes.c_float(cfg.h0)] + switches)


def _adia_entropy_force_scalars(cfg, dim: int):
    """(kc, 1/h0, 0.01·h0², 8μ, −4μ·dt, −α·c, 2α, h0, AV, fast_math) of the
    fused adiabatic body."""
    av = cfg.av_alpha
    kc, hinv = _legacy_consts(cfg, dim)
    return [ctypes.c_float(kc), ctypes.c_float(hinv),
            ctypes.c_float(0.01 * cfg.h0 * cfg.h0),
            ctypes.c_float(8.0 * cfg.mu),
            ctypes.c_float(-(4.0 * cfg.mu * cfg.dt)),
            ctypes.c_float(-av * cfg.c_av if av else 0.0),
            ctypes.c_float(2.0 * av), ctypes.c_float(cfg.h0), int(bool(av)),
            _fast(cfg)]


def _legacy_force_planes(planes, cfg):
    """The force kernels' plane list: a null FLUID plane without AV."""
    return planes if cfg.av_alpha else planes + [None]


def legacy_mass_pass(engine, state: ParticleState, cfg):
    """Isothermal-flow continuity with fixed h0: Drho = Σ m_q·rDW₂(h0, r)·
    (x_pq·v_pq) as a flat [slots] tensor. Replaces ``legacy_mass_pass`` of
    pallas_pairs.py. CUDA tensors launch the kernel (counted in
    ``legacy_mass_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return legacy_mass_pass_plain(engine, state, cfg)
    planes, _ = _legacy_mass_inputs(engine, state)
    band = _trip_bound("legacy_mass_sweep", engine, state)
    (out,) = _launch("legacy_mass_sweep", engine, planes, band, 1,
                     _legacy_mass_scalars(cfg, engine.dim, False))
    legacy_mass_pass.launches += 1
    return out


def iso_static_mass_pass(engine, state: ParticleState, cfg):
    """Isothermal-static continuity with per-particle h: Σ (m/ρ)_q·
    rDW₂(h_p, r)·(x_pq·v_pq) as a flat [slots] tensor (the caller multiplies
    by ρ_p). Replaces ``iso_static_mass_pass`` of pallas_pairs.py. CUDA
    tensors launch the kernel (counted in ``iso_static_mass_pass.launches``);
    CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return iso_static_mass_pass_plain(engine, state, cfg)
    planes, _ = _iso_static_mass_inputs(engine, state)
    band = _trip_bound("iso_static_mass_sweep", engine, state)
    (out,) = _launch("iso_static_mass_sweep", engine, planes, band, 1,
                     _legacy_mass_scalars(cfg, engine.dim, True))
    iso_static_mass_pass.launches += 1
    return out


def legacy_force_pass(engine, state: ParticleState, cfg):
    """Legacy pressure + 8μ viscous force with fixed h0 (+ the FLUID-gated
    Monaghan term with ``cfg.av_alpha``): the per-axis Dv pair sums as
    ``engine.dim`` flat [slots] tensors. Replaces ``legacy_force_pass`` of
    pallas_pairs.py. CUDA tensors launch the kernel (counted in
    ``legacy_force_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return legacy_force_pass_plain(engine, state, cfg)
    planes, _ = _legacy_force_inputs(engine, state, cfg, False)
    band = _trip_bound("legacy_force_sweep", engine, state)
    plan = _tile_plan(engine, _staged("legacy_force_sweep",
                                      bool(cfg.av_alpha)))
    outs = _launch("legacy_force_sweep", engine,
                   _legacy_force_planes(planes, cfg), band, engine.dim,
                   _legacy_force_scalars(cfg, engine.dim, False), plan)
    legacy_force_pass.launches += 1
    return outs


def iso_static_force_pass(engine, state: ParticleState, cfg):
    """Legacy force with per-particle h (the viscous denominator r² +
    0.0025(h_p+h_q)², the FLUID-gated Monaghan term with ``cfg.av_alpha``):
    the per-axis Dv pair sums as ``engine.dim`` flat [slots] tensors.
    Replaces ``iso_static_force_pass`` of pallas_pairs.py. CUDA tensors
    launch the kernel (counted in ``iso_static_force_pass.launches``); CPU
    tensors take the twin."""
    if not _on_cuda(state.active):
        return iso_static_force_pass_plain(engine, state, cfg)
    planes, _ = _legacy_force_inputs(engine, state, cfg, True)
    band = _trip_bound("iso_static_force_sweep", engine, state)
    plan = _tile_plan(engine, _staged("iso_static_force_sweep",
                                      bool(cfg.av_alpha)))
    outs = _launch("iso_static_force_sweep", engine,
                   _legacy_force_planes(planes, cfg), band, engine.dim,
                   _legacy_force_scalars(cfg, engine.dim, True), plan)
    iso_static_force_pass.launches += 1
    return outs


def adia_entropy_force_pass(engine, state: ParticleState, cfg):
    """Fused adiabatic entropy production + legacy force with fixed h0:
    (dS, Dv0, Dv1) as three flat [slots] tensors, dS with ``cfg.dt`` folded
    in and gated on FLUID–FLUID pairs. Replaces ``adia_entropy_force_pass``
    of pallas_pairs.py. CUDA tensors launch the kernel (counted in
    ``adia_entropy_force_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return adia_entropy_force_pass_plain(engine, state, cfg)
    planes, _ = _adia_entropy_force_inputs(engine, state)
    band = _trip_bound("adia_entropy_force_sweep", engine, state)
    outs = _launch("adia_entropy_force_sweep", engine, planes, band,
                   1 + engine.dim,
                   _adia_entropy_force_scalars(cfg, engine.dim))
    adia_entropy_force_pass.launches += 1
    return outs


def adia_density_pass(engine, state: ParticleState, cfg):
    """Adiabatic density: Σ w_q·W₂(h_p, r) with the self term and the
    q-side gate in the weight, w = m·[type == FLUID] (m under
    ``cfg.outflow_buffer``), as a flat [slots] tensor; the p-side gate stays
    with the caller. Replaces ``adia_density_pass`` of pallas_pairs.py on
    the density kernel (``density_sweep``). CUDA tensors launch it (counted
    in ``adia_density_pass.launches``, not in ``density_pass.launches``);
    CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return adia_density_pass_plain(engine, state, cfg)
    planes, _ = _density_inputs(engine, state,
                                _adia_density_weight(state, cfg))
    band = _trip_bound("density_sweep", engine, state)
    (out,) = _launch("density_sweep", engine, planes, band, 1,
                     [1, ctypes.c_float(C_W2 if engine.dim == 2 else C_W3)])
    adia_density_pass.launches += 1
    return out


def _isph_scalars(cfg):
    """(1/h0, −C·(1/h0)⁸) as f32 kernel arguments."""
    hinv, kw = _isph_consts(cfg)
    return [ctypes.c_float(hinv), ctypes.c_float(kw)]


def isph_div_visc_pass(engine, state: ParticleState, cfg):
    """The ISPH step's fused divergence/L/λ + viscous sweep: the raw
    cubic-spline sums Σ rD(h0, r)·(x_pq·v_pq, 1, r², v_pq[0], v_pq[1]) over
    pairs without the self pair, as five flat [slots] tensors (the caller
    applies the physics factors). Replaces ``isph_div_visc_pass`` of
    pallas_pairs.py. CUDA tensors launch the kernel (counted in
    ``isph_div_visc_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return isph_div_visc_pass_plain(engine, state, cfg)
    _check_2d(engine, "isph_div_visc_pass")
    planes, _ = _isph_div_visc_inputs(engine, state)
    band = _trip_bound("isph_div_visc_sweep", engine, state)
    outs = _launch("isph_div_visc_sweep", engine, planes, band, 5,
                   _isph_scalars(cfg))
    isph_div_visc_pass.launches += 1
    return outs


def isph_grad_pass(engine, state: ParticleState, cfg):
    """The ISPH pressure-correction gradient: per axis Σ rD(h0, r)·(P_p +
    P_q)·x_pq as two flat [slots] tensors (the caller applies
    −vol/max(ρ_bg, 1e-6)). Replaces ``isph_grad_pass`` of pallas_pairs.py.
    CUDA tensors launch the kernel (counted in ``isph_grad_pass.launches``);
    CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return isph_grad_pass_plain(engine, state, cfg)
    _check_2d(engine, "isph_grad_pass")
    planes, _ = _isph_grad_inputs(engine, state)
    band = _trip_bound("isph_grad_sweep", engine, state)
    outs = _launch("isph_grad_sweep", engine, planes, band, 2,
                   _isph_scalars(cfg))
    isph_grad_pass.launches += 1
    return outs


def isph_matvec_prepared(engine, state: ParticleState, cfg):
    """The CG matvec's off-diagonal sweep, prepared once per solve: returns
    ``mv(v) = Σ_q rD(h0, r)·v_q`` (flat [slots]; the caller scales it by
    2h0²·vol and adds the diagonal). Replaces ``isph_matvec_prepared`` of
    pallas_pairs.py.

    The occupancy and coordinate planes, the tiled sweep's per-tile trip
    bound and plan and (on the card) the output buffer are built here, once
    per solve; each ``mv(v)`` is then one launch of the tiled kernel on the
    resident view of ``v`` (a reshape, no copy), counted in
    ``isph_matvec_pass.launches``, with no allocation. The tensor it returns
    is that buffer: the next call overwrites it. CPU tensors take the twin
    (``isph_matvec_pass_plain``) at every call."""
    if not _on_cuda(state.active):
        return lambda v: isph_matvec_pass_plain(engine, state, cfg, v)
    _check_2d(engine, "isph_matvec_pass")
    planes, _ = _isph_matvec_inputs(engine, state)
    band = _trip_bound("isph_matvec_sweep", engine, state)
    return _prepared_matvec(engine, planes, band, cfg, "isph_matvec_sweep",
                            _tile_plan(engine, _staged("isph_matvec_sweep")),
                            counter=isph_matvec_pass)


def _prepared_matvec(engine, planes, band, cfg, fn_name: str, plan=None,
                     counter=None):
    """``mv(v)``: one launch of the matvec export ``fn_name`` (the tiled
    ``isph_matvec_sweep`` on ``plan``, or its ``_direct`` yardstick) on the
    prepared planes (occ, x[dim]) and trip bound ``band``, with the iterate
    ``v`` as the last plane, into one output buffer made here; the launch is
    counted in ``counter.launches`` when a counter is given (the wrapper's,
    not a yardstick's)."""
    tail = _with_plan(fn_name, engine, planes, band, _isph_scalars(cfg), plan)
    band = band.contiguous()
    dev = planes[0].device
    out = torch.empty(engine.slots, dtype=torch.float32, device=dev)
    lib = _build.load("pair_sweep")
    fn = getattr(lib, fn_name)
    head = [_ptr(p) for p in planes]
    tail = [_ptr(band), _ptr(out), engine.cap, *engine.lims,
            ctypes.c_float(engine.h * engine.h), *tail]
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    shape = (engine.slots,)

    def mv(v):
        if (v.device != dev or v.dtype != torch.float32
                or tuple(v.shape) != shape or not v.is_contiguous()):
            raise ValueError(f"matvec iterate must be contiguous f32 {shape} "
                             f"on {dev}, got {v.dtype} {tuple(v.shape)} on "
                             f"{v.device}")
        _raise_on(lib, fn_name, fn(*head, _ptr(v), *tail, stream))
        if counter is not None:
            counter.launches += 1
        return out

    # the kernel reads the prepared planes and the trip bound at every call:
    # keep them alive for as long as mv is (the launches hold raw pointers)
    mv.prepared = (planes, band)
    return mv


def isph_matvec_pass(engine, state: ParticleState, cfg, v):
    """One-shot form of ``isph_matvec_prepared``."""
    return isph_matvec_prepared(engine, state, cfg)(v)


def rb_mass_heat_pass(engine, state: ParticleState, cfg):
    """Rayleigh–Bénard continuity + Cleary–Monaghan conduction in one
    sweep: Drho = Σ kc·t³·(x_pq·v_pq) and DT = Σ 2κ·(1/ρ)_q·kc·t³·(T_p −
    T_q), t = max(1 − r/h, 0), kc = m·(−C of rDW₂)/h⁴, as two flat [slots]
    tensors; 1/ρ_q is zero on ``WALL_ADIA`` rows under adiabatic sidewalls
    and the caller applies the p-side FLUID gate to DT. Replaces
    ``rb_mass_heat_pass`` of pallas_pairs.py. CUDA tensors launch the kernel
    (counted in ``rb_mass_heat_pass.launches``); CPU tensors take the
    twin."""
    if not _on_cuda(state.active):
        return rb_mass_heat_pass_plain(engine, state, cfg)
    _check_2d(engine, "rb_mass_heat_pass")
    planes, _ = _rb_mass_heat_inputs(engine, state, cfg)
    band = _trip_bound("rb_mass_heat_sweep", engine, state)
    outs = _launch("rb_mass_heat_sweep", engine, planes, band, 2,
                   _rb_mass_heat_scalars(cfg))
    rb_mass_heat_pass.launches += 1
    return outs


def _rb_mass_heat_scalars(cfg):
    """(kc, 1/h, 2κ) of the 2-D Rayleigh–Bénard body."""
    return [ctypes.c_float(v) for v in _rb_consts(cfg, 2)]


density_pass.launches = 0
momentum_pass.launches = 0
pressure_pass.launches = 0
hopkins_momentum_pass.launches = 0
pavelka_mass_pass.launches = 0
pavelka_momentum_entropy_pass.launches = 0
gamma_grad_pass.launches = 0
dambreak_mass_pass.launches = 0
dambreak_force_pass.launches = 0
legacy_mass_pass.launches = 0
legacy_force_pass.launches = 0
iso_static_mass_pass.launches = 0
iso_static_force_pass.launches = 0
adia_entropy_force_pass.launches = 0
adia_density_pass.launches = 0
isph_div_visc_pass.launches = 0
isph_matvec_pass.launches = 0
isph_grad_pass.launches = 0
rb_mass_heat_pass.launches = 0
