"""Incompressible SPH (ISPH) dam break: the projection method.

Port of ``sph_mountain_waves_tpu/models/collapse_dry_implicit.py``: a
predictor step with gravity and viscosity, then a pressure-Poisson solve
with the Morris Laplacian and the Lee (2008) free-surface detection
λ = 1 − (1/d)∇·r (penalty C_free·max(λ, 0) on the diagonal), and a
pressure-corrected velocity update. WALL and DUMMY layers bound the box.

The scheme runs on the flat layout only, as the reference's does (it has no
bucket or Pallas path): the pair sums are the reference's pair functions
summed by ``ops/apply.py::apply_binary`` and the pressure solve is
matrix-free, the off-diagonal of the operator ``ops/solvers.py::
assemble_matvec`` (``include_self=False``) and the solve Jacobi-preconditioned
``ops/solvers.py::cg_solve``, all in plain PyTorch on the state's device
(float32 or float64; the config's default is float64).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import BoundaryLayer, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDspline23
from ..ops.apply import apply_binary, apply_unary
from ..ops.solvers import assemble_matvec, cg_solve
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import frame_runner, masked_max, masked_sum

FLUID = 0.0
WALL = 1.0
DUMMY = 2.0


@dataclasses.dataclass(frozen=True)
class Config:
    dim: int = 2
    dr: float = 1.0e-2
    rho: float = 1000.0
    g: float = -9.8
    mu: float = 8.4e-4
    C_free: float = 10.0
    v_char: float = 5.0
    water_column_width: float = 1.0
    water_column_height: float = 2.0
    box_height: float = 3.0
    box_width: float = 4.0
    nlayers: float = 3.5
    t_end: float = 2.0
    n_frames: int = 200
    cg_tol: float = 1e-6
    cg_maxiter: int = 200
    dtype: str = "float64"

    @property
    def h(self) -> float:
        return 2.8 * self.dr

    @property
    def m(self) -> float:
        return self.dr**self.dim * self.rho

    @property
    def dt(self) -> float:
        return 0.1 * self.h / self.v_char

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32


def make_system(cfg: Config) -> ParticleSystem:
    """The box with WALL and DUMMY layers (no lid) and the water column."""
    grid = Grid(cfg.dr, "hexagonal")
    box = Rectangle(0.0, 0.0, cfg.box_width, cfg.box_height)
    fluid = Rectangle(0.0, 0.0, cfg.water_column_width, cfg.water_column_height)
    walls = Specification(BoundaryLayer(box, grid, 1.2 * cfg.dr),
                          lambda x: x[..., 1] < cfg.box_height)
    dummy = Specification(BoundaryLayer(box, grid, cfg.nlayers * cfg.dr) - walls,
                          lambda x: x[..., 1] < cfg.box_height)
    sys = ParticleSystem(
        fields={"x": 2, "v": 2, "Dv": 2, "P": 0, "div": 0, "L": 0,
                "lam": 0, "type": 0},
        domain=fluid + dummy + walls, h=cfg.h, dim=2, dtype=cfg.torch_dtype)
    sys.freeze_opts = {"layout": "flat"}
    generate_particles(sys, grid, fluid, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    generate_particles(sys, grid, dummy, lambda xs: {"type": DUMMY})
    return sys


def make_step(cfg: Config, engine):
    """The projection step: predictor, rebuild, viscous force, divergence /
    L / λ, the Jacobi-preconditioned CG pressure solve, pressure force,
    velocity update."""
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt, m, rho, h, mu = cfg.dt, cfg.m, cfg.rho, cfg.h, cfg.mu

    def initialize(u):
        # predictor drift + gravity; reset the projection fields
        fluid = (u.type == FLUID)[:, None]
        gvec = torch.zeros_like(u.v)
        gvec[:, 1] = cfg.g
        return {"x": torch.where(fluid, u.x + dt * u.v, u.x),
                "v": torch.where(fluid, u.v + dt * gvec, u.v),
                "div": torch.zeros_like(u.div),
                "L": torch.zeros_like(u.L),
                "lam": torch.ones_like(u.lam)}

    def viscous_force(p, q, r):
        k = 2.0 * m * mu * rDspline23(h, r) / rho**2
        return {"Dv": k[..., None] * (p.v - q.v)}

    def div_L_lambda(p, q, r):
        rDk = rDspline23(h, r)
        return {"div": -torch.sum((p.x - q.x) * (p.v - q.v), dim=-1) * m * rDk,
                "L": -2.0 * m / rho * rDk,
                "lam": m / rho * rDk * r**2 / cfg.dim}

    def offdiag(p, q, r):
        return 2.0 * h**2 * m / rho * rDspline23(h, r)

    def internal_force(p, q, r):
        k = m * rDspline23(h, r) * (p.P + q.P) / rho**2
        return {"Dv": -k[..., None] * (p.x - q.x)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        return {"v": torch.where(fluid, u.v + dt * u.Dv, u.v),
                "Dv": torch.zeros_like(u.Dv)}

    def step(state: ParticleState) -> ParticleState:
        state = apply_unary(state, initialize)
        state, nbrs = engine.rebuild(state)
        state = apply_binary(engine, state, nbrs, viscous_force)
        state = apply_binary(engine, state, nbrs, div_L_lambda)

        # the pressure-Poisson system, matrix-free, Jacobi-preconditioned CG
        f = state.fields
        act = state.active
        diag = h**2 * f["L"] + torch.where(
            f["type"] == FLUID, cfg.C_free * torch.clamp(f["lam"], min=0.0),
            0.0)
        mv_off = assemble_matvec(engine, state, nbrs, offdiag,
                                 include_self=False)

        def matvec(v):
            return mv_off(v) + torch.where(act, diag * v, 0.0)

        b = torch.where(act, -h**2 * f["div"] / dt, 0.0)
        diag_safe = torch.where(torch.abs(diag) > 1e-30, diag, 1.0)
        P = cg_solve(matvec, b, x0=f["P"], M=lambda v: v / diag_safe,
                     tol=cfg.cg_tol, maxiter=cfg.cg_maxiter)
        state = state.replace(P=torch.where(act, P, 0.0))

        state = apply_binary(engine, state, nbrs, internal_force)
        return apply_unary(state, accelerate)

    return step


def get_globals(cfg: Config, state: ParticleState):
    """(X, H, E) observables, as 0-d tensors: the wavefront over the column
    width, the column height over its initial height, and the kinetic +
    potential energy."""
    f = state.fields
    act = state.active
    fluid = act & (f["type"] == FLUID)
    X = masked_max(f["x"][:, 0] / cfg.water_column_width, fluid)
    col = fluid & (f["x"][:, 0] > cfg.h) & (f["x"][:, 0] < 2.0)
    H = masked_max(f["x"][:, 1] / cfg.water_column_height, col)
    kinetic = 0.5 * cfg.m * torch.sum(f["v"] ** 2, dim=-1)
    potential = -cfg.m * cfg.g * f["x"][:, 1]
    E = masked_sum(kinetic + potential, act)
    return X, H, E


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """The full simulation on ``device`` (the card unless the caller asks for
    the CPU). Returns the time series t (scaled by sqrt(−2g)), X, H, E after
    every frame, the final state and the system; with ``out_path``,
    ``frame<k>.vtp`` of v, P and type after every frame and ``result.pvd``."""
    from ..io import new_pvd_file, save_frame, save_pvd_file

    sys = make_system(cfg)
    state = sys.freeze(device=device)
    step = make_step(cfg, sys.engine)
    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
    run_frame = frame_runner(step, steps_per_frame)

    out = new_pvd_file(out_path) if out_path else None
    ts, Xs, Hs, Es = [], [], [], []
    k = 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        t = k * cfg.dt
        X, H, E = (float(v) for v in get_globals(cfg, state))
        ts.append(t * np.sqrt(-2.0 * cfg.g))
        Xs.append(X)
        Hs.append(H)
        Es.append(E)
        if verbose:
            print(f"t = {t:.4f}  X = {X:.3f}  H = {H:.3f}  E = {E:.5e}")
        if out:
            save_frame(out, state, "v", "P", "type", time=t)
    if out:
        save_pvd_file(out)
    sys.state = state
    return {"t": np.asarray(ts), "X": np.asarray(Xs), "H": np.asarray(Hs),
            "E": np.asarray(Es), "state": state, "system": sys}
