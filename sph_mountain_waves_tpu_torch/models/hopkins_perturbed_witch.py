"""Pressure–entropy (Hopkins 2013 / PSPH) mountain-wave scheme,
perturbation form.

Port of ``sph_mountain_waves_tpu/models/hopkins_perturbed_witch.py``: each
particle carries an entropy-like variable A = P/ρ^γ, set at build time; the
smoothed pressure is P̄ = (Σ m A^{1/γ} W)^γ with P′ = P̄ − P_bg; momentum is
the WCSPH scheme's perturbation form + Monaghan artificial viscosity;
per-particle adaptive h = η√(m/ρ).

On the bucket layout the step's three pair sums are the sweeps of
``ops/pair_sweeps.py`` (density, pressure, momentum), called through their
wrappers: CUDA kernels on CUDA tensors, plain twins on CPU tensors. On the
flat layout (float32 or float64) they are the reference's pair functions
summed by ``ops/apply.py::apply_binary``. ``_make_step`` also builds the
full Hopkins step (``full_hopkins_perturbed_witch``), which differs only in
its background entropy and its momentum.
"""
from __future__ import annotations

import torch

from ..kernels import rDwendland2, wendland2
from ..ops.apply import apply_binary, apply_unary
from ..ops.pair_sweeps import (
    density_pass, hopkins_momentum_pass, momentum_pass, pressure_pass,
)
from ..structs import ParticleState, ParticleSystem
from .common import check_sweep_route
from .witch_common import (
    FLUID, WitchConfig, background_density_t, background_pot_temperature_t,
    make_witch_system, monaghan_viscosity, rayleigh_damping,
)
from . import wcsph_perturbed_witch as _wcsph

FIELDS = dict(_wcsph.FIELDS, A=0)
EXPORT_VARS = _wcsph.EXPORT_VARS


def make_system(cfg: WitchConfig) -> ParticleSystem:
    # no persistent fields: a rescatter moves every field, A included
    sys = make_witch_system(cfg, FIELDS)
    for chunk in sys._chunks:  # A = P/ρ^γ at build time
        chunk["A"] = chunk["P"] / chunk["rho"] ** cfg.gamma
    return sys


def make_step(cfg: WitchConfig, engine):
    return _make_step(cfg, engine, full=False)


def _make_step(cfg: WitchConfig, engine, full: bool):
    """The perturbation-form Hopkins step; ``full`` adds the background
    entropy A_bg and takes the two-kernel momentum with the background split
    (full_hopkins) instead of the perturbation-pressure momentum."""
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt = cfg.dt

    def reset_density(u):
        return {"rho": torch.zeros_like(u.rho),
                "rho_p": torch.zeros_like(u.rho_p)}

    def compute_density(p, q, r):
        return {"rho": q.m * wendland2(p.h, r)}

    def finalize_density(u):
        rho_bg = background_density_t(cfg, u.x[:, 1])
        return {"rho_bg": rho_bg, "rho_p": u.rho - rho_bg}

    def update_smoothing(u):
        rho = torch.clamp(u.rho, min=cfg.rho_floor)
        return {"h": cfg.eta * torch.sqrt(u.m / rho)}

    def reset_pressure(u):
        return {"P": torch.zeros_like(u.P), "P_p": torch.zeros_like(u.P_p)}

    def compute_pressure(p, q, r):
        # P += m_q A_q^(1/γ) W(h_ij, r)
        ker = wendland2(0.5 * (p.h + q.h), r)
        return {"P": q.m * q.A ** (1.0 / cfg.gamma) * ker}

    def finalize_pressure(u):
        P = u.P ** cfg.gamma
        # P_bg = R·T_bg·ρ_bg (isothermal), from finalize_density's fresh ρ_bg
        P_bg = cfg.R_mass * cfg.T_bg * u.rho_bg
        out = {"P": P, "P_bg": P_bg, "P_p": P - P_bg}
        if full:
            out["A_bg"] = P_bg / u.rho_bg ** cfg.gamma
        return out

    def find_temperature(u):
        T = u.P / (cfg.R_mass * u.rho)
        return {"T": T, "T_p": T - u.T_bg}

    def find_pot_temp(u):
        theta = u.T * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / u.P) ** (2.0 / 7.0)
        theta_bg = background_pot_temperature_t(cfg, u.x[:, 1])
        return {"theta": theta, "theta_bg": theta_bg,
                "theta_p": theta - theta_bg}

    def perturbation_momentum(p, q, r):
        # perturbation pressure gradient + artificial viscosity
        h_ij = 0.5 * (p.h + q.h)
        ker = rDwendland2(h_ij, r)
        prho = torch.clamp(p.rho, min=cfg.rho_floor)
        qrho = torch.clamp(q.rho, min=cfg.rho_floor)
        dv = -(q.m * (p.P_p / prho**2 + q.P_p / qrho**2)
               * ker)[..., None] * (p.x - q.x)
        return {"Dv": dv + monaghan_viscosity(cfg, p, q, r, h_ij)}

    def split_momentum(p, q, r):
        # the Hopkins two-kernel gradient on the total state minus the same
        # form on the background state
        x_pq = p.x - q.x
        expfac = 1.0 - 2.0 / cfg.gamma
        ker_i = rDwendland2(p.h, r)
        ker_j = rDwendland2(q.h, r)

        prefac = q.m * (p.A * q.A) ** (1.0 / cfg.gamma)
        pP = torch.clamp(p.P, min=cfg.P_floor)
        qP = torch.clamp(q.P, min=cfg.P_floor)
        a_tot = -(prefac * (pP**expfac * ker_i
                            + qP**expfac * ker_j))[..., None] * x_pq

        prefac_bg = q.m * (p.A_bg * q.A_bg) ** (1.0 / cfg.gamma)
        pPb = torch.clamp(p.P_bg, min=cfg.P_floor)
        qPb = torch.clamp(q.P_bg, min=cfg.P_floor)
        a_bg = -(prefac_bg * (pPb**expfac * ker_i
                              + qPb**expfac * ker_j))[..., None] * x_pq

        return {"Dv": a_tot - a_bg + monaghan_viscosity(cfg, p, q, r)}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": torch.where(fluid, u.x + dt * u.v, u.x)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        buoy = -cfg.g * u.rho_p / torch.clamp(u.rho, min=cfg.rho_floor)
        acc_y = u.Dv[:, 1] + buoy + rayleigh_damping(cfg, u.x[:, 1])
        acc = torch.stack([u.Dv[:, 0], acc_y], dim=-1)
        return {"v": torch.where(fluid, u.v + 0.5 * dt * acc, u.v),
                "Dv": torch.zeros_like(u.Dv)}

    sweeps = engine.layout == "bucket"

    def density(state, nbrs):
        if not sweeps:
            state = apply_unary(state, reset_density)
            return apply_binary(engine, state, nbrs, compute_density,
                                self_interaction=cfg.self_density)
        rho = density_pass(engine, state, cfg)
        return state.replace(rho=torch.where(state.active, rho, 0.0))

    def pressure(state, nbrs):
        if not sweeps:
            state = apply_unary(state, reset_pressure)
            return apply_binary(engine, state, nbrs, compute_pressure,
                                self_interaction=cfg.self_density)
        Proot = pressure_pass(engine, state, cfg)
        return state.replace(P=torch.where(state.active, Proot, 0.0))

    def momentum(state, nbrs):
        if not sweeps:
            return apply_binary(engine, state, nbrs, split_momentum if full
                                else perturbation_momentum)
        if full:
            dv0, dv1 = hopkins_momentum_pass(engine, state, cfg,
                                             background_split=True)
        else:
            dv0, dv1 = momentum_pass(engine, state, cfg)
        Dv = state.fields["Dv"] + torch.stack([dv0, dv1], dim=-1)
        return state.replace(Dv=torch.where(state.active[:, None], Dv, 0.0))

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state, engine)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)

        state = density(state, nbrs)
        state = apply_unary(state, finalize_density)
        state = apply_unary(state, update_smoothing)

        state = pressure(state, nbrs)
        state = apply_unary(state, finalize_pressure)
        state = apply_unary(state, find_temperature)
        state = apply_unary(state, find_pot_temp)

        state = momentum(state, nbrs)
        return apply_unary(state, accelerate)

    return step


def run(cfg: WitchConfig = WitchConfig(), out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """Frames every t_end/n_frames with avg/max velocity diagnostics, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return _wcsph._run_witch_scheme(cfg, make_system, make_step, EXPORT_VARS,
                                    out_path, verbose, device=device)
