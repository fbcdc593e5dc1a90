"""3-D stratified mountain-wave flow (the stretch configuration).

Port of ``sph_mountain_waves_tpu/models/witch3d.py``: the WCSPH perturbed
scheme lifted to 3-D. Axes: x along the flow, y across it, z vertical
(gravity and stratification act on axis 2). Cubic lattice, m = ρ_bg·dr³,
the 3-D quintic Wendland kernel, adaptive h = η·(m/ρ)^(1/3); the mountain is
a ridge extruded along y. ``stretch_config()`` is the 3.2-million-particle
sizing (n_rows=40, dr = 650 m over 400 km × 56 km × 26 km).

On the float32 bucket layout the two pair sums of a step are the 3-D forms
of ``density_pass`` and ``momentum_pass`` (``ops/pair_sweeps.py``: 27
stencil cells), called through their wrappers: CUDA kernels on CUDA
tensors, plain PyTorch twins on CPU tensors. The set-up's mass
renormalisation takes its density sums through ``density_pass`` there too
(the reference sums ``wendland3(p.h, r)`` in XLA; the sweep's divide-free
form of the same kernel differs from it by rounding). On the flat layout
(float32 or float64; the config's default layout) the density, the
momentum and the renormalisation's density are the reference's pair
functions summed by ``ops/apply.py::apply_binary`` on the state's device,
and the rebuild sorts the rows into cell order every step. A float64
bucket state raises at its first step (``check_sweep_route``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import BoundaryLayer, Box, Specification
from ..grids import Grid
from ..kernels import rDwendland3, wendland3
from ..ops.apply import apply_binary, apply_unary
from ..ops.pair_sweeps import density_pass, momentum_pass
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import check_sweep_route
from .wcsph_perturbed_witch import EXPORT_VARS, _run_witch_scheme
from .witch_common import (
    FLUID, WALL, WitchConfig, background_density, background_density_t,
    background_pot_temperature, background_pot_temperature_t,
    background_pressure, monaghan_viscosity, rayleigh_damping, witch_profile,
)

FIELDS = {"h": 0, "x": 3, "m": 0, "v": 3, "Dv": 3,
          "rho_bg": 0, "rho_p": 0, "rho": 0,
          "P_bg": 0, "P_p": 0, "P": 0,
          "theta_bg": 0, "theta_p": 0, "theta": 0,
          "T_bg": 0, "T_p": 0, "T": 0, "type": 0}


@dataclasses.dataclass(frozen=True)
class Witch3DConfig(WitchConfig):
    """The WitchConfig constants plus the cross-flow extent; dr, h, dt and c
    derive exactly as in 2-D."""
    dom_depth: float = 56e3       # cross-flow (y) extent
    lattice: str = "cubic"
    # The cubic lattice overestimates the wendland3 kernel sum by ~11 % at
    # eta = 1.8, and the linear EOS P' = c²(ρ − ρ_bg) turns any summation
    # bias into a body force. ``setup`` renormalises the per-particle mass
    # (m <- m·ρ_bg/ρ_sum, a fixed point with the adaptive h) so that the
    # initial summed density is the hydrostatic background.
    renormalize: bool = True
    renorm_iters: int = 4


def stretch_config(**overrides) -> Witch3DConfig:
    """The stretch sizing: n_rows=40 (dr = 650 m over 400 km × 56 km ×
    26 km), float32, bucket layout with the sweeps' kernels, a skin for
    deferred rescatters. ``lattice_cells`` sizes the bucket cells to exactly
    2·dr (minus the 1e-6 edge nudge), so that every cell holds exactly 2
    cubic-lattice planes per axis = 8 particles; any other ratio aliases
    against the lattice (3³ = 27 in some cells). For provably static runs
    ``bucket_cap=8`` leaves no headroom (overflow is counted and surfaced)."""
    kw = dict(n_rows=40, dtype="float32", self_density=True,
              layout="bucket", skin=1.0 / 9.0, use_pallas=True,
              lattice_cells=True)
    kw.update(overrides)
    return Witch3DConfig(**kw)


def make_system(cfg: Witch3DConfig) -> ParticleSystem:
    """3-D domain + fence + mountain ridge with the hydrostatic isothermal
    initial state (mountain particles are FLUID, as in 2-D)."""
    grid = Grid(cfg.dr, cfg.lattice)
    domain = Box(-cfg.dom_length / 2.0, 0.0, 0.0,
                 cfg.dom_length / 2.0, cfg.dom_depth, cfg.dom_height)
    fence = BoundaryLayer(domain, grid, cfg.bc_width)
    mountain = Specification(
        domain, lambda x: x[..., 2] <= witch_profile(cfg, x[..., 0]))

    sys = ParticleSystem(fields=FIELDS, domain=domain + fence, h=cfg.h0,
                         dim=3, dtype=cfg.torch_dtype)
    sys.freeze_opts = {"layout": cfg.layout, "skin": cfg.skin,
                       # the irreducible state, as in the 2-D scheme
                       "persistent": ("x", "v", "h", "m", "type", "T_bg")}
    if cfg.bucket_cap:
        sys.freeze_opts["cap"] = cfg.bucket_cap
    if cfg.lattice_cells:
        # cells of exactly 2·dr with the 1e-6 DOWNWARD nudge: when dr is not
        # exactly representable (26000/12), lattice points that sit on bin
        # edges otherwise flip bins point by point with float rounding
        # (occupancy spikes to 27 and rows are dropped at cap 8)
        sys.freeze_opts["cells"] = (2.0 * cfg.dr * (1.0 - 1e-6),) * 3
    generate_particles(sys, grid, domain - mountain, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, fence, lambda xs: {"type": WALL})
    generate_particles(sys, grid, mountain, lambda xs: {"type": FLUID})

    # hydrostatic isothermal init with height = z (axis 2) and the 3-D mass
    # element ρ_bg·dr³
    for chunk in sys._chunks:
        z = chunk["x"][:, 2]
        chunk["h"] = np.full_like(z, cfg.h0)
        rho_bg = background_density(cfg, z)
        chunk["rho_bg"] = rho_bg
        chunk["rho"] = rho_bg
        chunk["P_bg"] = background_pressure(cfg, z)
        chunk["P"] = chunk["P_bg"]
        chunk["theta_bg"] = background_pot_temperature(cfg, z)
        chunk["theta"] = chunk["theta_bg"]
        chunk["T_bg"] = np.full_like(z, cfg.T_bg)
        chunk["T"] = np.full_like(z, cfg.T_bg)
        chunk["m"] = rho_bg * cfg.dr**3
    return sys


def renormalize_mass(cfg: Witch3DConfig, engine, state: ParticleState
                     ) -> ParticleState:
    """Fixed-point mass renormalisation: drive the kernel-summed initial
    density to the analytic hydrostatic background (see
    ``Witch3DConfig.renormalize``). Also calibrates fence-edge particles whose
    neighbourhoods are truncated. Converges to < 0.1 % in ~4 iterations."""
    check_sweep_route(cfg, state, engine)
    for _ in range(cfg.renorm_iters):
        state, nbrs = engine.rebuild(state)
        f = state.fields
        rho = _density(cfg, engine, state, nbrs)
        rho_bg = background_density_t(cfg, f["x"][:, 2])
        ratio = torch.where(
            state.active, rho_bg / torch.clamp(rho, min=cfg.rho_floor), 1.0)
        m = f["m"] * ratio
        h = cfg.eta * torch.pow(m / torch.clamp(rho_bg, min=cfg.rho_floor),
                                1.0 / 3.0)
        state = state.replace(
            m=m, h=torch.where(state.active, h, f["h"]),
            rho=torch.where(state.active, rho_bg, 0.0),
            rho_p=torch.zeros_like(f["rho_p"]))
    return state


def compute_density(p, q, r):
    """The density pair function of the flat layout: ρ += m_q W(h_p, r)."""
    return {"rho": q.m * wendland3(p.h, r)}


def _density(cfg: Witch3DConfig, engine, state: ParticleState, nbrs
             ) -> torch.Tensor:
    """The summed density Σ m_q W(h_p, r) (the self pair with
    ``cfg.self_density``), zero on inactive rows: the sweep on the bucket
    layout, ``apply_binary`` of ``compute_density`` on the flat one."""
    if engine.layout == "bucket":
        return torch.where(state.active, density_pass(engine, state, cfg), 0.0)
    zero = torch.zeros_like(state.fields["rho"])
    return apply_binary(engine, state.replace(rho=zero), nbrs,
                        compute_density,
                        self_interaction=cfg.self_density).fields["rho"]


def setup(cfg: Witch3DConfig, engine, state: ParticleState) -> ParticleState:
    if cfg.renormalize:
        state = renormalize_mass(cfg, engine, state)
    return state


def make_step(cfg: Witch3DConfig, engine):
    """One modified-Verlet step in 3-D (kick, drift, rebuild, density, EOS,
    momentum, kick); vertical physics acts on axis 2."""
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt = cfg.dt

    def finalize_density(u):
        rho_bg = background_density_t(cfg, u.x[:, 2])
        return {"rho_bg": rho_bg, "rho_p": u.rho - rho_bg}

    def update_smoothing(u):
        rho = torch.clamp(u.rho, min=cfg.rho_floor)
        return {"h": cfg.eta * torch.pow(u.m / rho, 1.0 / 3.0)}

    def compute_pressure(u):
        P_bg = cfg.R_mass * cfg.T_bg * u.rho_bg
        P_p = cfg.c**2 * u.rho_p
        return {"P_bg": P_bg, "P_p": P_p, "P": P_bg + P_p}

    finalize = make_finalize(cfg)

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": torch.where(fluid, u.x + dt * u.v, u.x)}

    def accelerate(u):
        # v += dt/2 (Dv + (buoyancy + damping) e_z); Dv reset
        fluid = (u.type == FLUID)[:, None]
        buoy = -cfg.g * u.rho_p / torch.clamp(u.rho, min=cfg.rho_floor)
        damp = rayleigh_damping(cfg, u.x[:, 2])
        acc = torch.stack([u.Dv[:, 0], u.Dv[:, 1], u.Dv[:, 2] + (buoy + damp)],
                          dim=-1)
        return {"v": torch.where(fluid, u.v + 0.5 * dt * acc, u.v),
                "Dv": torch.zeros_like(u.Dv)}

    def balance_of_momentum(p, q, r):
        # symmetric P' gradient + Monaghan viscosity, 3-D kernel
        x_pq = p.x - q.x
        h_ij = 0.5 * (p.h + q.h)
        ker = rDwendland3(h_ij, r)
        prho = torch.clamp(p.rho, min=cfg.rho_floor)
        qrho = torch.clamp(q.rho, min=cfg.rho_floor)
        dv = -(q.m * (p.P_p / prho**2 + q.P_p / qrho**2) * ker)[..., None] * x_pq
        return {"Dv": dv + monaghan_viscosity(cfg, p, q, r, h_ij, ker)}

    sweeps = engine.layout == "bucket"

    def momentum(state, nbrs):
        if not sweeps:
            return apply_binary(engine, state, nbrs, balance_of_momentum)
        Dv = state.fields["Dv"] + torch.stack(
            momentum_pass(engine, state, cfg), dim=-1)
        return state.replace(Dv=torch.where(state.active[:, None], Dv, 0.0))

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state, engine)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)

        state = state.replace(rho=_density(cfg, engine, state, nbrs))
        state = apply_unary(state, finalize_density)
        state = apply_unary(state, update_smoothing)
        state = apply_unary(state, compute_pressure)
        if not cfg.lazy_diagnostics:
            state = finalize(state)
        state = momentum(state, nbrs)
        return apply_unary(state, accelerate)

    return step


def make_finalize(cfg: Witch3DConfig):
    """T, θ and their perturbations with vertical = z (axis 2): every step,
    or once per frame with ``cfg.lazy_diagnostics``."""
    def find_temperature(u):
        T = u.P / (cfg.R_mass * torch.clamp(u.rho, min=cfg.rho_floor))
        return {"T": T, "T_p": T - u.T_bg}

    def find_pot_temp(u):
        theta = u.T * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / torch.clamp(
            u.P, min=cfg.P_floor)) ** (2.0 / 7.0)
        theta_bg = background_pot_temperature_t(cfg, u.x[:, 2])
        return {"theta": theta, "theta_bg": theta_bg,
                "theta_p": theta - theta_bg}

    def finalize(state):
        state = apply_unary(state, find_temperature)
        return apply_unary(state, find_pot_temp)

    return finalize


def run(cfg: Witch3DConfig = Witch3DConfig(), out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """The main loop of the mountain-wave schemes on the 3-D system, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return _run_witch_scheme(
        cfg, make_system, make_step, EXPORT_VARS, out_path, verbose,
        setup=setup,
        finalize=make_finalize(cfg) if cfg.lazy_diagnostics else None,
        device=device)
