"""Pressure–entropy mountain-wave scheme on total variables.

Port of ``sph_mountain_waves_tpu/models/hopkins_total_witch.py``: no
perturbation split — total (ρ, P, θ, T) with direct gravity −g·ŷ; the
Hopkins two-kernel momentum with per-particle kernels rDW(h_p, r) and
rDW(h_q, r) (``hopkins_momentum_pass`` without the background split); the
hydrostatic packing as its setup (``run(..., packing=True)``). As in the
reference, ``move`` and ``accelerate`` carry no FLUID filter: the walls are
dynamic here.

The step's three pair sums are the sweeps of ``ops/pair_sweeps.py``
(density, pressure, Hopkins momentum), called through their wrappers: CUDA
kernels on CUDA tensors, plain twins on CPU tensors.
"""
from __future__ import annotations

import torch

from ..ops.apply import apply_unary
from ..ops.pair_sweeps import density_pass, hopkins_momentum_pass, pressure_pass
from ..structs import ParticleState, ParticleSystem
from .common import check_sweep_route
from .witch_common import WitchConfig, make_witch_system, rayleigh_damping
from . import wcsph_perturbed_witch as _wcsph

FIELDS = {"h": 0, "x": 2, "m": 0, "v": 2, "Dv": 2, "rho": 0, "P": 0,
          "theta": 0, "T": 0, "type": 0, "A": 0}
EXPORT_VARS = ("v", "rho", "P", "theta", "T", "type")


def make_system(cfg: WitchConfig) -> ParticleSystem:
    # no persistent fields: a rescatter moves every field, A included
    sys = make_witch_system(cfg, FIELDS)
    for chunk in sys._chunks:  # A = P/ρ^γ at build time
        chunk["A"] = chunk["P"] / chunk["rho"] ** cfg.gamma
    return sys


def setup(cfg: WitchConfig, engine, state: ParticleState) -> ParticleState:
    """The hydrostatic packing, run once before the first step."""
    from ..utils.packing import hydrostatic_packing
    return hydrostatic_packing(cfg, engine, state)


def make_step(cfg: WitchConfig, engine):
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt = cfg.dt

    def update_smoothing(u):
        rho = torch.clamp(u.rho, min=cfg.rho_floor)
        return {"h": cfg.eta * torch.sqrt(u.m / rho)}

    def finalize_pressure(u):
        return {"P": u.P ** cfg.gamma}

    def find_temperature(u):
        return {"T": u.P / (cfg.R_mass * u.rho)}

    def find_pot_temp(u):
        return {"theta": u.T * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / u.P)
                ** (2.0 / 7.0)}

    def move(u):
        return {"x": u.x + dt * u.v}  # no FLUID filter

    def accelerate(u):
        # direct gravity + damping, no FLUID filter
        acc_y = u.Dv[:, 1] - cfg.g + rayleigh_damping(cfg, u.x[:, 1])
        acc = torch.stack([u.Dv[:, 0], acc_y], dim=-1)
        return {"v": u.v + 0.5 * dt * acc, "Dv": torch.zeros_like(u.Dv)}

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, _ = engine.rebuild(state)

        rho = density_pass(engine, state, cfg)
        state = state.replace(rho=torch.where(state.active, rho, 0.0))
        state = apply_unary(state, update_smoothing)

        Proot = pressure_pass(engine, state, cfg)
        state = state.replace(P=torch.where(state.active, Proot, 0.0))
        state = apply_unary(state, finalize_pressure)
        state = apply_unary(state, find_temperature)
        state = apply_unary(state, find_pot_temp)

        dv0, dv1 = hopkins_momentum_pass(engine, state, cfg,
                                         background_split=False)
        Dv = state.fields["Dv"] + torch.stack([dv0, dv1], dim=-1)
        state = state.replace(Dv=torch.where(state.active[:, None], Dv, 0.0))
        return apply_unary(state, accelerate)

    return step


def run(cfg: WitchConfig = WitchConfig(), out_path: str | None = None,
        verbose: bool = False, packing: bool = True, device="cuda"):
    """Hydrostatic packing (unless ``packing=False``), then frames every
    t_end/n_frames with avg/max velocity diagnostics, on ``device`` (the
    card unless the caller asks for the CPU)."""
    return _wcsph._run_witch_scheme(cfg, make_system, make_step, EXPORT_VARS,
                                    out_path, verbose,
                                    setup=setup if packing else None,
                                    device=device)
