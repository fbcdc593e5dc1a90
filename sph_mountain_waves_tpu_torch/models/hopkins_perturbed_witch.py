"""Pressure–entropy (Hopkins 2013 / PSPH) mountain-wave scheme,
perturbation form.

Port of ``sph_mountain_waves_tpu/models/hopkins_perturbed_witch.py``: each
particle carries an entropy-like variable A = P/ρ^γ, set at build time; the
smoothed pressure is P̄ = (Σ m A^{1/γ} W)^γ with P′ = P̄ − P_bg; momentum is
the WCSPH scheme's perturbation form + Monaghan artificial viscosity;
per-particle adaptive h = η√(m/ρ).

The step's three pair sums are the sweeps of ``ops/pair_sweeps.py``
(density, pressure, momentum), called through their wrappers: CUDA kernels
on CUDA tensors, plain twins on CPU tensors. ``_make_step`` also builds the
full Hopkins step (``full_hopkins_perturbed_witch``), which differs only in
its background entropy and its momentum sweep.
"""
from __future__ import annotations

import torch

from ..ops.apply import apply_unary
from ..ops.pair_sweeps import (
    density_pass, hopkins_momentum_pass, momentum_pass, pressure_pass,
)
from ..structs import ParticleState, ParticleSystem
from .common import check_sweep_route
from .witch_common import (
    FLUID, WitchConfig, background_density_t, background_pot_temperature_t,
    make_witch_system, rayleigh_damping,
)
from . import wcsph_perturbed_witch as _wcsph

FIELDS = dict(_wcsph.FIELDS, A=0)


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

    def finalize_density(u):
        rho_bg = background_density_t(cfg, u.x[:, 1])
        return {"rho_bg": rho_bg, "rho_p": u.rho - rho_bg}

    def update_smoothing(u):
        rho = torch.clamp(u.rho, min=cfg.rho_floor)
        return {"h": cfg.eta * torch.sqrt(u.m / rho)}

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

    def momentum(state):
        if full:
            return hopkins_momentum_pass(engine, state, cfg,
                                         background_split=True)
        return momentum_pass(engine, state, cfg)

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, _ = engine.rebuild(state)

        rho = density_pass(engine, state, cfg)
        state = state.replace(rho=torch.where(state.active, rho, 0.0))
        state = apply_unary(state, finalize_density)
        state = apply_unary(state, update_smoothing)

        Proot = pressure_pass(engine, state, cfg)
        state = state.replace(P=torch.where(state.active, Proot, 0.0))
        state = apply_unary(state, finalize_pressure)
        state = apply_unary(state, find_temperature)
        state = apply_unary(state, find_pot_temp)

        dv0, dv1 = momentum(state)
        Dv = state.fields["Dv"] + torch.stack([dv0, dv1], dim=-1)
        state = state.replace(Dv=torch.where(state.active[:, None], Dv, 0.0))
        return apply_unary(state, accelerate)

    return step


def run(cfg: WitchConfig = WitchConfig(), out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """Frames every t_end/n_frames with avg/max velocity diagnostics, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return _wcsph._run_witch_scheme(cfg, make_system, make_step, out_path,
                                    verbose, device=device)
