"""Entropy-based SPH (GENERIC / Pavelka) mountain-wave scheme on total
variables, with continuity-equation density.

Port of ``sph_mountain_waves_tpu/models/pavelka_total_witch.py``: the density
evolves by the continuity equation with a δ-SPH diffusion (the fixed
Molteni–Colagrossi form by default; ``fixed_diffusion=False`` is the
reference-faithful kernel-less form, which diverges within a few steps by
design); the smoothing length is integrated from Dh = −(h/2ρ)Dρ; the entropy
S grows by viscous production; T follows from (ρ, s) by the GENERIC relation
T = ρ^(γ−1)·exp(s/(ρ·c_v))/(c_v(γ−1)); P = RρT; the momentum carries a
laminar Monaghan viscosity. The Colagrossi packing is its set-up.

The step's two pair sums are the sweeps of ``ops/pair_sweeps.py``
(``pavelka_mass_pass`` and the fused ``pavelka_momentum_entropy_pass``),
called through their wrappers: CUDA kernels on CUDA tensors, plain twins on
CPU tensors. A CUDA state with ``cfg.use_pallas`` off is refused.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.apply import apply_unary
from ..ops.pair_sweeps import pavelka_mass_pass, pavelka_momentum_entropy_pass
from ..structs import ParticleState, ParticleSystem
from .common import check_sweep_route
from .witch_common import FLUID, WitchConfig, make_witch_system
from . import wcsph_perturbed_witch as _wcsph

FIELDS = {"h": 0, "Dh": 0, "x": 2, "m": 0, "v": 2, "Dv": 2, "rho": 0,
          "Drho": 0, "P": 0, "theta": 0, "S": 0, "s": 0, "T": 0,
          "gGamma": 2, "type": 0}
EXPORT_VARS = ("v", "rho", "P", "theta", "T", "type")


@dataclasses.dataclass(frozen=True)
class PavelkaConfig(WitchConfig):
    mu: float = 1.0  # dynamic viscosity (the reference sets 1.0, not air's)
    # True: the Molteni–Colagrossi δ-SPH term 2ν(ρp−ρq)·(m_q/ρ_q)·rDW. False:
    # the reference's 2ν/ρp·(ρp−ρq) with no kernel factor, which drives ρ to
    # blow up within a few steps.
    fixed_diffusion: bool = True


def make_system(cfg: PavelkaConfig) -> ParticleSystem:
    # no persistent fields: a rescatter moves every field
    sys = make_witch_system(cfg, FIELDS)
    for chunk in sys._chunks:
        # S = m c_v log(c_v T (γ−1) / (γ ρ^(γ−1)))
        T, rho, m = chunk["T"], chunk["rho"], chunk["m"]
        chunk["S"] = m * cfg.cv * np.log(
            (cfg.cv * T * (cfg.gamma - 1.0)) / (cfg.gamma * rho ** (cfg.gamma - 1.0)))
    return sys


def setup(cfg: PavelkaConfig, engine, state: ParticleState,
          return_info: bool = False):
    """The Colagrossi packing, then the initial operator passes: continuity,
    the smoothing rate, s, T and P, and the momentum (the fused sweep's Dv
    outputs; its entropy production is not applied at set-up). With
    ``return_info`` also the packing's {"res_g0", "res_g", "res_v",
    "steps"}."""
    from ..utils.packing import colagrossi_packing
    state, info = colagrossi_packing(cfg, engine, state, 1e-10, 1e-10, 100,
                                     return_info=True)
    state = make_step(cfg, engine, parts=True)["initial_passes"](state)
    return (state, info) if return_info else state


def make_step(cfg: PavelkaConfig, engine, parts: bool = False):
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt = cfg.dt

    def balance_of_smoothing(u):
        return {"Dh": u.Dh - 0.5 * (u.h / u.rho) * u.Drho}

    def update_smoothing(u):
        fluid = u.type == FLUID
        return {"h": torch.where(fluid, u.h + dt * u.Dh, u.h),
                "Dh": torch.zeros_like(u.Dh)}

    def update_density(u):
        fluid = u.type == FLUID
        return {"rho": torch.where(fluid, u.rho + dt * u.Drho, u.rho),
                "Drho": torch.zeros_like(u.Drho)}

    def find_s(u):
        fluid = u.type == FLUID
        return {"s": torch.where(fluid, u.S * u.rho / u.m, u.s)}

    def set_temperature(u):
        fluid = u.type == FLUID
        T = (u.rho ** (cfg.gamma - 1.0)) * torch.exp(
            u.s / (u.rho * cfg.cv)) / (cfg.cv * (cfg.gamma - 1.0))
        return {"T": torch.where(fluid, T, u.T)}

    def set_pressure(u):
        fluid = u.type == FLUID
        return {"P": torch.where(fluid, cfg.R_mass * u.rho * u.T, u.P)}

    def find_pot_temp(u):
        fluid = u.type == FLUID
        theta = u.T * (((cfg.T_bg * cfg.R_gas * cfg.rho0) / u.P) ** 2) ** (1.0 / 7.0)
        return {"theta": torch.where(fluid, theta, u.theta)}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": torch.where(fluid, u.x + dt * u.v, u.x)}

    def accelerate(u):
        # v += dt/2 (Dv − g·ŷ); the reference's damping is disabled
        fluid = (u.type == FLUID)[:, None]
        acc = torch.stack([u.Dv[:, 0], u.Dv[:, 1] - cfg.g], dim=-1)
        return {"v": torch.where(fluid, u.v + 0.5 * dt * acc, u.v),
                "Dv": torch.zeros_like(u.Dv)}

    def mass_sweep(state):
        Drho = state.fields["Drho"] + pavelka_mass_pass(engine, state, cfg)
        return state.replace(Drho=torch.where(state.active, Drho, 0.0))

    def momentum_entropy_sweep(state, entropy: bool):
        dv0, dv1, dS = pavelka_momentum_entropy_pass(engine, state, cfg)
        act = state.active
        Dv = state.fields["Dv"] + torch.stack([dv0, dv1], dim=-1)
        new = {"Dv": torch.where(act[:, None], Dv, 0.0)}
        if entropy:
            new["S"] = torch.where(act, state.fields["S"] + dS, 0.0)
        return state.replace(**new)

    def initial_passes(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state)
        state, _ = engine.rebuild(state)
        state = mass_sweep(state)
        state = apply_unary(state, balance_of_smoothing)
        state = apply_unary(state, find_s)
        state = apply_unary(state, set_temperature)
        state = apply_unary(state, set_pressure)
        return momentum_entropy_sweep(state, entropy=False)

    if parts:
        return {"initial_passes": initial_passes}

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, _ = engine.rebuild(state)

        state = mass_sweep(state)
        state = apply_unary(state, balance_of_smoothing)
        state = apply_unary(state, update_smoothing)
        state = apply_unary(state, update_density)

        state = apply_unary(state, find_s)
        state = apply_unary(state, set_temperature)
        state = apply_unary(state, set_pressure)
        state = apply_unary(state, find_pot_temp)
        # fused sweep: entropy production and momentum share ker and x·v
        state = momentum_entropy_sweep(state, entropy=True)
        return apply_unary(state, accelerate)

    return step


def run(cfg: PavelkaConfig | None = None, out_path: str | None = None,
        verbose: bool = False, packing: bool = True, device="cuda"):
    """Colagrossi packing and the initial passes (unless ``packing=False``),
    then frames every t_end/n_frames with avg/max velocity diagnostics and,
    with ``out_path``, the PVD/CSV output of ``EXPORT_VARS``; on ``device``
    (the card unless the caller asks for the CPU)."""
    cfg = cfg or PavelkaConfig()
    return _wcsph._run_witch_scheme(cfg, make_system, make_step, EXPORT_VARS,
                                    out_path, verbose,
                                    setup=setup if packing else None,
                                    device=device)
