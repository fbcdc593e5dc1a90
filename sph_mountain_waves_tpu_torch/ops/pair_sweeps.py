"""Pair sweeps of the 2-D mountain-wave schemes: density, momentum, the
Hopkins pressure root and momentum, the Pavelka continuity and fused
momentum + entropy sweeps, and the Colagrossi packing's ∇Γ sum.

Port of the slice of ``sph_mountain_waves_tpu/ops/pallas_pairs.py`` that the
WCSPH flagship, the three Hopkins schemes and the Pavelka scheme run: the
pair-sweep harness (``make_pair_kernel_fn`` with ``_make_pair_kernel``, the
one ``pl.pallas_call``), its trip bound ``row_kmax``,
``weighted_w_pass(ker_h="p")``/``density_pass``, the 2-D ``momentum_pass``,
``weighted_w_pass(ker_h="sym")``/``pressure_pass``,
``hopkins_momentum_pass`` (``background_split`` on and off),
``pavelka_mass_pass`` and ``pavelka_momentum_entropy_pass``.
``gamma_grad_pass`` has no Pallas counterpart: the reference's Colagrossi
packing takes that sum as an XLA pair sum
(``utils/packing.py::colagrossi_packing``, ``find_gGamma``).

Every sweep reads f32 planes in the bucket layout ``[cap, C+1]`` (an
occupancy plane plus per-particle fields) and writes one ``[cap, C+1]`` plane
per output, zero on empty slots and in the trash column. A pair (p, q) counts
when both slots are occupied, q's cell is one of p's 9 stencil cells inside
the grid, ``r² ≤ h²`` and, unless the sweep includes the self pair, q ≠ p.
Sums are taken in a fixed order: for each q rank ``kq`` the 9 stencil
contributions are summed (offsets dj-major) and then added to the
accumulator, as the Pallas kernel does, so reruns are bitwise identical.

Each sweep has two implementations:

* a CUDA C++ kernel for sm_90a (``csrc/pair_sweep.cu``), launched by the
  wrapper (``density_pass``, ``momentum_pass``, ``pressure_pass``,
  ``hopkins_momentum_pass``, ``pavelka_mass_pass``,
  ``pavelka_momentum_entropy_pass``, ``gamma_grad_pass``) for CUDA tensors,
  which counts its launches in ``<wrapper>.launches``;
* a plain PyTorch twin (``<wrapper>_plain``) with the Pallas body's math,
  vectorised over shifted views of the zero-padded ``[cap, ny+2, nx+2]``
  grid. The wrapper takes it for CPU tensors only.

What bounds the kernel on an H100: per occupied p slot it reads the q slots
of 9 cells up to the row's band occupancy (about 9·kmax slots) of 4 (∇Γ),
5 (density, pressure), 9 (Pavelka continuity), 10 (momentum), 11/13 (Hopkins
momentum) or 12 (Pavelka momentum + entropy) f32 fields.
Neighbouring threads share most of those q reads, so they hit L1/L2; memory
traffic and occupancy bound the sweep, not FLOPs.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..kernels import C_DW2, C_W2
from ..structs import ParticleState
from . import _build

__all__ = ["row_kmax", "density_pass", "density_pass_plain",
           "momentum_pass", "momentum_pass_plain", "pressure_pass",
           "pressure_pass_plain", "hopkins_momentum_pass",
           "hopkins_momentum_pass_plain", "pavelka_mass_pass",
           "pavelka_mass_pass_plain", "pavelka_momentum_entropy_pass",
           "pavelka_momentum_entropy_pass_plain", "gamma_grad_pass",
           "gamma_grad_pass_plain"]


def row_kmax(engine, state: ParticleState):
    """(band_max, row_max): per-grid-row max bucket occupancy maxed over the
    3-row stencil band (the q-slot trip bound) and for the row itself. Each
    [ny] int32."""
    nx, ny = engine.lims
    per_cell = engine.grid_view(state.active).sum(dim=0)     # [ny, nx]
    per_row = per_cell.amax(dim=1)                            # [ny]
    padded = F.pad(per_row, (1, 1))
    band = torch.maximum(torch.maximum(padded[:-2], padded[1:-1]), padded[2:])
    return band.to(torch.int32), per_row.to(torch.int32)


def _hfloor(engine) -> float:
    # keeps 1/h finite on empty rows; far smaller than any physical h
    return 1e-3 * engine.h


def _rdw_const(dim: int) -> float:
    # -C of rDwendland2 = (dw/dr)/r = -C·pos(1-r/h)^3 / h^4
    if dim != 2:
        raise NotImplementedError("only the 2-D momentum sweep is ported")
    return -C_DW2


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

def _density_inputs(engine, state: ParticleState, weight: torch.Tensor):
    """Planes (occ, x0, x1, 1/h, weight) and their grid-edge pad values.
    1/h is streamed so the body has no divide."""
    f = state.fields
    hinv = 1.0 / torch.clamp(f["h"], min=_hfloor(engine))
    planes = [_plane(engine, a) for a in (
        state.active, f["x"][:, 0], f["x"][:, 1], hinv, weight)]
    return planes, [0.0] * 5


def _momentum_inputs(engine, state: ParticleState, cfg):
    """Planes (occ, x0, x1, h, m, v0, v1, ρ_f, P′/ρ_f², c) with the per-particle
    quantities hoisted: floored ρ, the pressure term and the sound speed.
    h pads with its floor so that a pad never yields 1/0."""
    f = state.fields
    rho_f = torch.clamp(f["rho"], min=cfg.rho_floor)
    Aterm = f["P_p"] / rho_f**2
    cs = torch.sqrt(torch.clamp(cfg.gamma * f["P"] / rho_f, min=0.0))
    h = torch.clamp(f["h"], min=_hfloor(engine))
    planes = [_plane(engine, a) for a in (
        state.active, f["x"][:, 0], f["x"][:, 1], h, f["m"],
        f["v"][:, 0], f["v"][:, 1], rho_f, Aterm, cs)]
    pad_vals = [0.0] * 3 + [_hfloor(engine)] + [0.0] * 6
    return planes, pad_vals


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


# ------------------------------------------------------------ plain twins

def _density_body(p, q, r2, maskf):
    """Σ w_q·W₂(h_p, r) with 1/h_p streamed (fields occ, x0, x1, 1/h, w)."""
    wq = q[4]
    r = torch.sqrt(r2)
    hinv = p[3]
    x = r * hinv
    t = torch.clamp(1.0 - x, min=0.0)
    t2 = t * t
    hpow = hinv * hinv
    ker = C_W2 * t2 * t2 * (1.0 + 4.0 * x) * hpow
    return [maskf * wq * ker]


def _momentum_body(cfg):
    """Symmetric P′ gradient plus Monaghan viscosity (fields occ, x0, x1, h,
    m, v0, v1, ρ_f, P′/ρ², c), term for term the Pallas momentum body."""
    alpha, beta, eps = cfg.alpha, cfg.beta, cfg.eps
    DW = _rdw_const(2)
    div = _div_fn(cfg)

    def body(p, q, r2, maskf):
        hp, rhop, Ap, cp = p[3], p[7], p[8], p[9]
        mq, rhoq, Aq, cq = q[4], q[7], q[8], q[9]
        r = torch.sqrt(r2)
        h_ij = 0.5 * (hp + q[3])
        hinv = div(1.0, h_ij)
        t = torch.clamp(1.0 - r * hinv, min=0.0) * maskf
        hinv2 = hinv * hinv
        ker = DW * t * t * t * (hinv2 * hinv2)
        dx = [p[1] - q[1], p[2] - q[2]]
        dv = [p[5] - q[5], p[6] - q[6]]
        dot = dx[0] * dv[0] + dx[1] * dv[1]
        c_ij = 0.5 * (cp + cq)
        rho_ij = 0.5 * (rhop + rhoq)
        mu_ij = div(h_ij * dot, r2 + eps * h_ij * h_ij)
        pi_ij = div(-alpha * c_ij * mu_ij + beta * mu_ij * mu_ij, rho_ij)
        s = -mq * ker * (Ap + Aq + (dot < 0.0).to(torch.float32) * pi_ij)
        return [s * dx[0], s * dx[1]]

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


def _sweep_plain(engine, planes, pad_vals, band, body, n_out: int,
                 self_pair: bool):
    """The pair-sweep harness in plain PyTorch: p fields are the [cap, ny, nx]
    grid, q fields at one rank ``kq`` and one stencil offset are a shifted
    [ny, nx] view of the padded grid. Masked pairs contribute exactly zero,
    because every hoisted input (and every pad) is finite."""
    cap = engine.cap
    nx, ny = engine.lims
    C = engine.num_cells
    dev = planes[0].device
    G = [pl[:, :C].reshape(cap, ny, nx) for pl in planes]
    P = [F.pad(g, (1, 1, 1, 1), value=v) for g, v in zip(G, pad_vals)]
    occ_p = G[0] > 0.5
    hh = torch.tensor(engine.h * engine.h, dtype=torch.float32, device=dev)
    k_ids = torch.arange(cap, device=dev).reshape(cap, 1, 1)
    acc = [torch.zeros((cap, ny, nx), dtype=torch.float32, device=dev)
           for _ in range(n_out)]
    # q ranks past the largest band occupancy are empty everywhere
    for kq in range(int(band.max())):
        tot = None
        for di, dj in engine.stencil:
            q = [Pf[kq, 1 + dj:1 + dj + ny, 1 + di:1 + di + nx] for Pf in P]
            r2 = (G[1] - q[1]) ** 2 + (G[2] - q[2]) ** 2
            mask = occ_p & (q[0] > 0.5) & (r2 <= hh)
            if not self_pair and di == 0 and dj == 0:
                mask = mask & (k_ids != kq)
            contribs = body(G, q, r2, mask.to(torch.float32))
            tot = contribs if tot is None else [t + c for t, c in zip(tot, contribs)]
        acc = [a + t for a, t in zip(acc, tot)]
    return [engine.to_flat(a) for a in acc]


def density_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``density_pass``."""
    planes, pad_vals = _density_inputs(engine, state, state.fields["m"])
    band, _ = row_kmax(engine, state)
    (out,) = _sweep_plain(engine, planes, pad_vals, band, _density_body, 1,
                          self_pair=cfg.self_density)
    return out


def momentum_pass_plain(engine, state: ParticleState, cfg):
    """Plain twin of ``momentum_pass``: the per-axis Dv pair sums."""
    planes, pad_vals = _momentum_inputs(engine, state, cfg)
    band, _ = row_kmax(engine, state)
    return _sweep_plain(engine, planes, pad_vals, band, _momentum_body(cfg),
                        2, self_pair=False)


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


# ----------------------------------------------------------- CUDA kernels

def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's device pointer; None is a null pointer (an input the
    kernel does not read)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check_planes(engine, planes, band):
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
    if band.device != dev or band.dtype != torch.int32 or band.numel() != engine.lims[1]:
        raise ValueError("row bound must be int32 [ny] on the planes' device")


def _launch(fn_name: str, engine, planes, band, n_out, scalars):
    """Launch one sweep of csrc/pair_sweep.cu on the current stream; raise if
    the launch was refused."""
    _check_planes(engine, planes, band)
    dev = planes[0].device
    band = band.contiguous()
    outs = [torch.empty((engine.cap, engine.num_cells + 1),
                        dtype=torch.float32, device=dev) for _ in range(n_out)]
    lib = _build.load("pair_sweep")
    nx, ny = engine.lims
    h2 = ctypes.c_float(engine.h * engine.h)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    err = getattr(lib, fn_name)(*[_ptr(p) for p in planes], _ptr(band),
                                *[_ptr(o) for o in outs],
                                engine.cap, nx, ny, h2, *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: "
                           f"{lib.pair_sweep_error_string(err).decode()}")
    return [o.reshape(-1) for o in outs]


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (use the twin); any other device is refused."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"pair sweeps run on cuda or cpu tensors, not {t.device}")


def _momentum_scalars(cfg):
    """(−C of rDW, ε, −α, β) of the momentum bodies."""
    return [ctypes.c_float(_rdw_const(2)), ctypes.c_float(cfg.eps),
            ctypes.c_float(-cfg.alpha), ctypes.c_float(cfg.beta)]


def _fast(cfg) -> int:
    return int(bool(getattr(cfg, "fast_math", False)))


def density_pass(engine, state: ParticleState, cfg):
    """ρ_p = Σ m_q·W₂(h_p, r) over the stencil, plus the self term per
    ``cfg.self_density``, as a flat [slots] tensor. Replaces
    ``weighted_w_pass(ker_h="p")``/``density_pass`` of pallas_pairs.py. CUDA
    tensors launch the kernel (counted in ``density_pass.launches``); CPU
    tensors take the twin."""
    if not _on_cuda(state.active):
        return density_pass_plain(engine, state, cfg)
    planes, _ = _density_inputs(engine, state, state.fields["m"])
    band, _ = row_kmax(engine, state)
    (out,) = _launch("density_sweep", engine, planes, band, 1,
                     [int(bool(cfg.self_density)), ctypes.c_float(C_W2)])
    density_pass.launches += 1
    return out


def momentum_pass(engine, state: ParticleState, cfg):
    """Perturbation-pressure + Monaghan-viscosity momentum sweep: the
    per-axis Dv pair sums as two flat [slots] tensors. Replaces
    ``momentum_pass`` of pallas_pairs.py. CUDA tensors launch the kernel
    (counted in ``momentum_pass.launches``); CPU tensors take the twin."""
    if not _on_cuda(state.active):
        return momentum_pass_plain(engine, state, cfg)
    planes, _ = _momentum_inputs(engine, state, cfg)
    band, _ = row_kmax(engine, state)
    outs = _launch("momentum_sweep", engine, planes, band, 2,
                   _momentum_scalars(cfg) + [_fast(cfg)])
    momentum_pass.launches += 1
    return outs


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
    band, _ = row_kmax(engine, state)
    (out,) = _launch("pressure_sweep", engine, planes, band, 1,
                     [int(bool(cfg.self_density)), ctypes.c_float(C_W2)])
    pressure_pass.launches += 1
    return out


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
    planes, _ = _hopkins_inputs(engine, state, cfg, background_split)
    band, _ = row_kmax(engine, state)
    outs = _launch("hopkins_momentum_sweep", engine,
                   planes if background_split else planes + [None, None],
                   band, 2, _momentum_scalars(cfg)
                   + [int(bool(background_split)), _fast(cfg)])
    hopkins_momentum_pass.launches += 1
    return outs


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
    band, _ = row_kmax(engine, state)
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
    band, _ = row_kmax(engine, state)
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
    band, _ = row_kmax(engine, state)
    outs = _launch("gamma_grad_sweep", engine, planes, band, 2,
                   [ctypes.c_float(V0 * _rdw_const(2))])
    gamma_grad_pass.launches += 1
    return outs


density_pass.launches = 0
momentum_pass.launches = 0
pressure_pass.launches = 0
hopkins_momentum_pass.launches = 0
pavelka_mass_pass.launches = 0
pavelka_momentum_entropy_pass.launches = 0
gamma_grad_pass.launches = 0
