"""Lid-driven cavity (Re 100–400–1000): the CFD benchmark against Ghia et
al.

Port of ``sph_mountain_waves_tpu/models/cavity_flow.py``: WCSPH with a
background pressure P0 against the tensile instability, the lid's
Dirichlet condition by linear velocity extrapolation inside the pair force,
Monaghan's angular-momentum-conserving viscosity, and the steady-state
centerline profiles by Shepard-normalised SPH interpolation at probe
points (``compute_fluxes``, through ``ops/apply.py::point_sum``).

The config's defaults are the reference's: the flat layout in float64. The
pair sums are the reference's pair functions summed by
``ops/apply.py::apply_binary`` on the state's device and the probes are
``point_sum``'s masked sums, all plain PyTorch (the reference launches its
Pallas kernels only on the bucket layout). With an output directory ``run``
writes the frames, ``data.csv`` of the profiles and the Ghia comparison
figures (``utils/plots.py::plot_cavity``; skipped with a warning where
matplotlib is missing).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..geometry import BoundaryLayer, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDwendland2, wendland2
from ..ops.apply import apply_binary, apply_unary, point_sum
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import frame_runner

FLUID = 0.0
WALL = 1.0
LID = 2.0


@dataclasses.dataclass(frozen=True)
class Config:
    N: int = 100          # sample points per lid length
    Re: float = 100.0
    llid: float = 1.0
    rho0: float = 1.0
    vlid: float = 1.0
    P0: float = 5.0
    t_end: float = 0.4
    n_frames: int = 200
    dtype: str = "float64"

    @property
    def mu(self) -> float:
        return 1.0 / self.Re

    @property
    def dr(self) -> float:
        return self.llid / self.N

    @property
    def h(self) -> float:
        return 3.0 * self.dr

    @property
    def m(self) -> float:
        return self.rho0 * self.dr**2

    @property
    def c(self) -> float:
        return 20.0 * self.vlid

    @property
    def dt(self) -> float:
        return 0.1 * self.h / self.c

    @property
    def torch_dtype(self):
        return torch.float64 if self.dtype == "float64" else torch.float32


def make_system(cfg: Config) -> ParticleSystem:
    """The cavity's fluid, the lid above it and the side and bottom walls,
    on the hexagonal lattice."""
    grid = Grid(cfg.dr, "hexagonal")
    box = Rectangle(0.0, 0.0, cfg.llid, cfg.llid)
    wall = BoundaryLayer(box, grid, cfg.h)
    lid = Specification(wall, lambda x: x[..., 1] > cfg.llid)
    side = Specification(wall, lambda x: x[..., 1] <= cfg.llid)
    sys = ParticleSystem(
        fields={"x": 2, "v": 2, "Dv": 2, "rho": 0, "Drho": 0, "P": 0, "type": 0},
        domain=box + wall, h=cfg.h, dim=2, dtype=cfg.torch_dtype,
        defaults={"rho": cfg.rho0})
    sys.freeze_opts = {"layout": "flat"}  # the reference's default layout
    generate_particles(sys, grid, box, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, lid, lambda xs: {"type": LID})
    generate_particles(sys, grid, side, lambda xs: {"type": WALL})
    return sys


def make_step(cfg: Config, engine):
    """The Verlet step and the force bootstrap: ``(step, init)``."""
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt, m, c, rho0, h = cfg.dt, cfg.m, cfg.c, cfg.rho0, cfg.h

    def balance_of_mass(p, q, r):
        return {"Drho": m * rDwendland2(h, r)
                * torch.sum((p.x - q.x) * (p.v - q.v), dim=-1)}

    def find_pressure(u):
        rho = u.rho + u.Drho * dt
        return {"rho": rho, "Drho": torch.zeros_like(rho),
                "P": cfg.P0 + c**2 * (rho - rho0)}

    def internal_force(p, q, r):
        rDk = rDwendland2(h, r)
        x_pq = p.x - q.x
        v_pq = p.v - q.v
        # the lid's Dirichlet condition by linear extrapolation
        vlid_vec = v_pq.new_tensor([cfg.vlid, 0.0])
        s = torch.abs(x_pq[..., 1]) / (0.1 * h + torch.abs(p.x[..., 1] - cfg.llid))
        v_lid = s[..., None] * (p.v - vlid_vec)
        v_pq = torch.where((q.type == LID)[..., None], v_lid, v_pq)
        dv = -(m * rDk * (p.P / p.rho**2 + q.P / q.rho**2))[..., None] * x_pq
        visc = (8.0 / (cfg.Re * p.rho * q.rho) * m * rDk
                * torch.sum(v_pq * x_pq, dim=-1) / (r**2 + 0.01 * h**2))
        return {"Dv": dv + visc[..., None] * x_pq}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": torch.where(fluid, u.x + 0.5 * dt * u.v, u.x),
                "Dv": torch.zeros_like(u.Dv)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        return {"v": torch.where(fluid, u.v + 0.5 * dt * u.Dv, u.v)}

    def step(state: ParticleState) -> ParticleState:
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)
        state = apply_binary(engine, state, nbrs, balance_of_mass)
        state = apply_unary(state, find_pressure)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)
        state = apply_binary(engine, state, nbrs, internal_force)
        return apply_unary(state, accelerate)

    def init(state: ParticleState) -> ParticleState:
        state, nbrs = engine.rebuild(state)
        state = apply_unary(state, find_pressure)
        return apply_binary(engine, state, nbrs, internal_force)

    return step, init


def compute_fluxes(cfg: Config, engine, state: ParticleState, res: int = 100):
    """Centerline velocity profiles by Shepard-normalised SPH
    interpolation at ``res`` probes a line. Returns (s, v1, v2) as host
    arrays: the x-velocity along the vertical centerline and the
    y-velocity along the horizontal one."""
    state, nbrs = engine.rebuild(state)
    s = np.linspace(0.0, 1.0, res)
    probes_y = np.stack([np.full(res, 0.5), s], axis=-1)   # along y
    probes_x = np.stack([s, np.full(res, 0.5)], axis=-1)   # along x

    def fluid(q, r):
        return (q.type == FLUID).to(r.dtype)

    def gamma_fn(q, r):
        return fluid(q, r) * cfg.m * wendland2(cfg.h, r)

    def vx_fn(q, r):
        return fluid(q, r) * cfg.m * q.v[..., 0] * wendland2(cfg.h, r)

    def vy_fn(q, r):
        return fluid(q, r) * cfg.m * q.v[..., 1] * wendland2(cfg.h, r)

    g1 = point_sum(engine, state, nbrs, gamma_fn, probes_y)
    v1 = point_sum(engine, state, nbrs, vx_fn, probes_y) / torch.clamp(g1, min=1e-12)
    g2 = point_sum(engine, state, nbrs, gamma_fn, probes_x)
    v2 = point_sum(engine, state, nbrs, vy_fn, probes_x) / torch.clamp(g2, min=1e-12)
    return s, v1.cpu().numpy(), v2.cpu().numpy()


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """The cavity on ``device`` (the card unless the caller asks for the
    CPU) to ``cfg.t_end``, then the centerline profiles. Returns s, v1, v2,
    the final state and the system. With ``out_path``: ``frame<k>.vtp`` of
    P, v and type after every frame, ``result.pvd``, ``data.csv`` (s, v1,
    v2) and ``ldc-x2vy.pdf``/``ldc-y2vx.pdf`` against Ghia et al."""
    from ..io import new_pvd_file, save_csv, save_frame, save_pvd_file
    from ..utils.plots import plot_cavity

    sys = make_system(cfg)
    state = sys.freeze(device=device)
    step, init = make_step(cfg, sys.engine)
    state = init(state)

    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
    run_frame = frame_runner(step, steps_per_frame)

    out = new_pvd_file(out_path) if out_path else None
    k = 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        if verbose and (k // steps_per_frame) % 20 == 0:
            print(f"t = {k * cfg.dt:.4f} ({100 * k * cfg.dt / cfg.t_end:.0f}%)")
        if out:
            save_frame(out, state, "P", "v", "type", time=k * cfg.dt)
    if out:
        save_pvd_file(out)
    s, v1, v2 = compute_fluxes(cfg, sys.engine, state)
    if out:
        save_csv(os.path.join(out.path, "data.csv"), {"s": s, "v1": v1, "v2": v2})
        plot_cavity(out.path, s, v1, v2, Re=cfg.Re)
    sys.state = state
    return {"s": s, "v1": v1, "v2": v2, "state": state, "system": sys}
