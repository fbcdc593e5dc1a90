"""3-D WCSPH dam break.

Port of ``sph_mountain_waves_tpu/models/collapse3d.py``: the dam-break
scheme in 3-D with the 3-D quintic Wendland kernel, a cubic lattice and Box
geometry; gravity acts along z. It runs the 27-cell stencil of the engine.

The config's defaults are the reference's: the flat layout in float64. There
the two pair sums of a step are the reference's pair functions summed by
``ops/apply.py::apply_binary`` on the state's device (float32 or float64).
On the float32 bucket layout (h = 2·dr gives ~27 lattice points per cell, a
high bucket capacity) they are the 3-D forms of ``dambreak_mass_pass`` and
``dambreak_force_pass`` (``ops/pair_sweeps.py``), called through their
wrappers: CUDA kernels on CUDA tensors, plain PyTorch twins on CPU tensors;
a float64 bucket state raises at its first step (``check_sweep_route``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import BoundaryLayer, Box, Specification, boundarybox
from ..grids import Grid
from ..kernels import rDwendland3
from ..ops.apply import apply_binary, apply_unary
from ..ops.pair_sweeps import dambreak_force_pass, dambreak_mass_pass
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import check_sweep_route, frame_runner, masked_sum

FLUID = 0.0
WALL = 1.0


@dataclasses.dataclass(frozen=True)
class Config:
    dr: float = 5.0e-3
    rho0: float = 1000.0
    c: float = 50.0
    g: float = -9.8            # along z
    mu: float = 8.4e-4
    nu: float = 1.0e-4
    water_column_width: float = 0.142
    water_column_height: float = 0.293
    box_height: float = 0.35
    box_width: float = 0.584
    box_depth: float = 0.15
    t_end: float = 0.5
    n_frames: int = 200
    dtype: str = "float64"
    # "flat" (float32 or float64: ops/apply.py's pair sums) or "bucket"
    # (float32: the sweeps)
    layout: str = "flat"
    skin: float = 0.0
    # bucket layout: the pair sweeps launch their CUDA kernels on CUDA
    # tensors (CPU tensors take the plain twins either way); a CUDA bucket
    # state with False is refused. The flat layout ignores it.
    use_pallas: bool = False

    @property
    def h(self) -> float:
        return 2.0 * self.dr

    @property
    def m(self) -> float:
        return self.rho0 * self.dr**3

    @property
    def dt(self) -> float:
        return 0.1 * self.h / self.c

    @property
    def wall_width(self) -> float:
        return 2.5 * self.dr

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32


def make_system(cfg: Config) -> ParticleSystem:
    grid = Grid(cfg.dr, "cubic")
    box = Box(0.0, 0.0, 0.0, cfg.box_width, cfg.box_height, cfg.box_depth)
    fluid = Box(0.0, 0.0, 0.0, cfg.water_column_width,
                cfg.water_column_height, cfg.box_depth)
    walls = Specification(BoundaryLayer(box, grid, cfg.wall_width),
                          lambda x: x[..., 1] < cfg.box_height)
    domain = boundarybox(walls)
    sys = ParticleSystem(
        fields={"x": 3, "v": 3, "a": 3, "P": 0, "rho": 0, "Drho": 0, "type": 0},
        domain=domain, h=cfg.h, dim=3, dtype=cfg.torch_dtype,
        defaults={"rho": cfg.rho0})
    sys.freeze_opts = {"layout": cfg.layout, "skin": cfg.skin}
    generate_particles(sys, grid, fluid, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    return sys


def make_step(cfg: Config, engine):
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt, m, c, rho0, h = cfg.dt, cfg.m, cfg.c, cfg.rho0, cfg.h

    def balance_of_mass(p, q, r):
        ker = m * rDwendland3(h, r)
        return {"Drho": ker * (torch.sum((p.x - q.x) * (p.v - q.v), dim=-1)
                               + 2 * cfg.nu * (p.rho - q.rho))}

    def internal_force(p, q, r):
        # the symmetric P/ρ² form of the 2-D dam break, on FLUID rows only
        ker = m * rDwendland3(h, r)
        fluid = p.type == FLUID
        a = (-(ker * (p.P / p.rho**2 + q.P / q.rho**2))[..., None]
             * (p.x - q.x)
             + (2 * ker * cfg.mu / rho0**2)[..., None] * (p.v - q.v))
        return {"a": torch.where(fluid[..., None], a, 0.0)}

    def find_pressure(u):
        rho = u.rho + u.Drho * dt
        return {"rho": rho, "Drho": torch.zeros_like(rho),
                "P": c**2 * (rho - rho0)}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": torch.where(fluid, u.x + dt * u.v, u.x),
                "a": torch.zeros_like(u.a)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        gvec = torch.zeros_like(u.v)
        gvec[:, 2] = cfg.g
        return {"v": torch.where(fluid, u.v + 0.5 * dt * (u.a + gvec), u.v)}

    sweeps = engine.layout == "bucket"

    def mass(state, nbrs):
        if not sweeps:
            return apply_binary(engine, state, nbrs, balance_of_mass)
        drho = state.fields["Drho"] + dambreak_mass_pass(engine, state, cfg)
        return state.replace(Drho=torch.where(state.active, drho, 0.0))

    def force(state, nbrs):
        if not sweeps:
            return apply_binary(engine, state, nbrs, internal_force)
        acc = state.fields["a"] + torch.stack(
            dambreak_force_pass(engine, state, cfg), dim=-1)
        return state.replace(a=torch.where(state.active[:, None], acc, 0.0))

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state, engine)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)
        state = mass(state, nbrs)
        state = apply_unary(state, find_pressure)
        state = force(state, nbrs)
        state = apply_unary(state, accelerate)
        return apply_unary(state, accelerate)  # the reference's two kicks

    return step


def energy(cfg: Config, state: ParticleState) -> torch.Tensor:
    """Kinetic + potential energy over the active particles, a 0-d tensor."""
    f = state.fields
    kinetic = 0.5 * cfg.m * torch.sum(f["v"] ** 2, dim=-1)
    potential = -cfg.m * cfg.g * f["x"][:, 2]
    return masked_sum(kinetic + potential, state.active)


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """The full simulation on ``device`` (the card unless the caller asks for
    the CPU): the energy after every frame and, with ``out_path``,
    ``frame<k>.vtp`` of v, P, rho and type with ``result.pvd``."""
    from ..io import new_pvd_file, save_frame, save_pvd_file

    sys = make_system(cfg)
    state = sys.freeze(device=device)
    step = make_step(cfg, sys.engine)
    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
    run_frame = frame_runner(step, steps_per_frame)

    out = new_pvd_file(out_path) if out_path else None
    Es = []
    k = 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        E = float(energy(cfg, state))
        Es.append(E)
        if verbose:
            print(f"t = {k * cfg.dt:.5f}  E = {E:.6e}  n = {int(state.n)}")
        if out:
            save_frame(out, state, "v", "P", "rho", "type", time=k * cfg.dt)
    if out:
        save_pvd_file(out)
    sys.state = state
    return {"E": np.asarray(Es), "state": state, "system": sys}
