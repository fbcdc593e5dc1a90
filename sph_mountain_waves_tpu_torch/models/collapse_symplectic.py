"""Bit-reversible dam break (fixed-point symplectic integration).

Port of ``sph_mountain_waves_tpu/models/collapse_symplectic.py``: the
position and velocity updates go through the reversible fixed-point
``rev_add`` (``utils/fixpa.py``), walls repel by a Lennard-Jones force
instead of SPH wall particles, the density is a summation against a
per-particle ρ0, the Boltzmann entropy of the velocity histogram
(``utils/entropy.py``) is recorded, and at t_end the velocities are
inverted and the run replayed backward to recover the initial positions.

The config's defaults are the reference's: the flat layout in float64
(fixed-point reversibility needs float64). The pair sums are the
reference's pair functions summed by ``ops/apply.py::apply_binary`` on the
state's device, no hand-written kernel. Reversibility rests on each step
being a deterministic function of the state: the flat pair sums take no
atomics and no split reductions (a fixed order of additions for a given
row order), so the replay comes back to the lattice on the card as on the
CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import BoundaryLayer, Rectangle
from ..grids import Grid
from ..kernels import rDwendland2, wendland2
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem, generate_particles
from ..utils.fixpa import rev_add
from .common import frame_runner, masked_sum

FLUID = 0.0
WALL = 1.0


@dataclasses.dataclass(frozen=True)
class Config:
    dr: float = 1.0e-2
    rho0: float = 1000.0
    g: float = -9.8
    mu: float = 0.0
    water_column_width: float = 1.0
    water_column_height: float = 2.0
    box_height: float = 3.0
    box_width: float = 4.0
    c: float = 50.0
    eps: float = 1e-16
    t_end: float = 1.0
    n_frames: int = 100
    dtype: str = "float64"   # fixed-point reversibility needs f64

    @property
    def h(self) -> float:
        return 3.0 * self.dr

    @property
    def m(self) -> float:
        return self.rho0 * self.dr**2

    @property
    def wall_width(self) -> float:
        return 2.5 * self.dr

    @property
    def dr_wall(self) -> float:
        return 0.95 * self.dr

    @property
    def E_wall(self) -> float:
        return 10 * abs(self.g) * self.water_column_height

    @property
    def dt(self) -> float:
        return 0.1 * self.h / self.c

    @property
    def torch_dtype(self):
        return torch.float64 if self.dtype == "float64" else torch.float32


def make_system(cfg: Config) -> ParticleSystem:
    """The water column and the wall layer, on the square lattice."""
    grid = Grid(cfg.dr, "square")
    box = Rectangle(0.0, 0.0, cfg.box_width, cfg.box_height)
    fluid = Rectangle(0.0, 0.0, cfg.water_column_width, cfg.water_column_height)
    walls = BoundaryLayer(box, grid, cfg.wall_width)
    domain = Rectangle(-cfg.box_width, -cfg.box_width, 2 * cfg.box_width,
                       3 * cfg.box_height)
    sys = ParticleSystem(
        fields={"x": 2, "v": 2, "a": 2, "P": 0, "rho": 0, "rho0": 0, "type": 0},
        domain=domain, h=cfg.h, dim=2, dtype=cfg.torch_dtype)
    sys.freeze_opts = {"layout": "flat"}  # the reference's default layout
    generate_particles(sys, grid, fluid, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    return sys


def make_step(cfg: Config, engine):
    """The reversible Verlet step and the bootstrap: ``(step, init)``."""
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt, m, c, h = cfg.dt, cfg.m, cfg.c, cfg.h

    def both_fluid(p, q):
        return (p.type == FLUID) & (q.type == FLUID)

    def find_rho(p, q, r):
        return {"rho": torch.where(both_fluid(p, q), m * wendland2(h, r), 0.0)}

    def find_rho0(p, q, r):
        return {"rho0": torch.where(both_fluid(p, q), m * wendland2(h, r),
                                    0.0)}

    def find_pressure(u):
        return {"P": c**2 * (u.rho - u.rho0)}

    def internal_force(p, q, r):
        ker = m * rDwendland2(h, r)
        x_pq = p.x - q.x
        a_ff = -(ker * (p.P / torch.clamp(p.rho, min=1e-12) ** 2
                        + q.P / torch.clamp(q.rho, min=1e-12) ** 2))[..., None] * x_pq
        # Lennard-Jones wall repulsion
        s = cfg.dr_wall / (r + cfg.eps)
        lj = (-cfg.E_wall / (r + cfg.eps) ** 2 * (s**2 - s**4))[..., None] * x_pq
        fw = (p.type == FLUID) & (q.type == WALL) & (r < cfg.dr_wall)
        out = torch.where(both_fluid(p, q)[..., None], a_ff, 0.0)
        return {"a": out + torch.where(fw[..., None], lj, 0.0)}

    def reset(u):
        return {"a": torch.zeros_like(u.a), "rho": torch.zeros_like(u.rho)}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": torch.where(fluid, rev_add(u.x, dt * u.v), u.x)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        gvec = torch.zeros_like(u.v)
        gvec[:, 1] = cfg.g
        return {"v": torch.where(fluid, rev_add(u.v, 0.5 * dt * (u.a + gvec)),
                                 u.v)}

    def step(state: ParticleState) -> ParticleState:
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, nbrs = engine.rebuild(state)
        state = apply_unary(state, reset)
        state = apply_binary(engine, state, nbrs, find_rho,
                             self_interaction=True)
        state = apply_unary(state, find_pressure)
        state = apply_binary(engine, state, nbrs, internal_force)
        return apply_unary(state, accelerate)

    def init(state: ParticleState) -> ParticleState:
        state, nbrs = engine.rebuild(state)
        state = apply_binary(engine, state, nbrs, find_rho0,
                             self_interaction=True, add=False)
        state = apply_binary(engine, state, nbrs, find_rho,
                             self_interaction=True, add=False)
        state = apply_unary(state, find_pressure)
        return apply_binary(engine, state, nbrs, internal_force)

    return step, init


def invert_velocities(state: ParticleState) -> ParticleState:
    return state.replace(v=-state.fields["v"])


def kinetic_energy(cfg: Config, state: ParticleState) -> float:
    v2 = torch.sum(state.fields["v"] ** 2, dim=-1)
    return float(masked_sum(0.5 * cfg.m * v2, state.active))


def recovery_error(x0: torch.Tensor, state: ParticleState) -> float:
    """The largest distance from an initial position (``x0``, the rows of
    the bootstrapped state) to the nearest final active position: the rows
    are permuted by the cell sorts, so the two are matched as point sets,
    256 initial points at a time against every final one, on the state's
    device (at the default dr that is 22,817² distances: ~25 s in NumPy on
    one core)."""
    xf = state.fields["x"][state.active]
    xi = x0[: len(xf)].to(xf.device)
    err = xf.new_zeros(())
    for i in range(0, len(xi), 256):
        d = torch.linalg.vector_norm(xi[i:i + 256, None, :] - xf[None, :, :],
                                     dim=-1)
        err = torch.maximum(err, d.min(dim=1).values.max())
    return float(err)


def run(cfg: Config = Config(), revert: bool = True, n_entropy: int = 20,
        verbose: bool = False, device="cuda"):
    """The forward run on ``device`` (the card unless the caller asks for
    the CPU) in ``n_entropy`` chunks, the velocity entropy and kinetic
    energy after each; with ``revert``, the velocities inverted and the
    same number of steps replayed, with the entropy of each chunk and the
    recovery error against the initial positions. Returns ``S_forward``,
    ``Ekin`` (and ``S_backward``, ``recovery_error``), the final state and
    the system."""
    from ..utils.entropy import entropy_2D_MB, velocity_histogram

    sys = make_system(cfg)
    state = sys.freeze(device=device)
    step, init = make_step(cfg, sys.engine)
    state = init(state)

    x0 = state.fields["x"].clone()
    n_steps = int(round(cfg.t_end / cfg.dt))
    chunk = max(1, n_steps // n_entropy)
    run_chunk = frame_runner(step, chunk)

    Ss, Ekin = [], []
    done = 0
    while done < n_steps:
        state = run_chunk(state)
        done += chunk
        Ss.append(entropy_2D_MB(velocity_histogram(state, N=100)))
        Ekin.append(kinetic_energy(cfg, state))
        if verbose:
            print(f"forward t = {done * cfg.dt:.3f}  S = {Ss[-1]:.4f}")

    out = {"S_forward": np.asarray(Ss), "Ekin": np.asarray(Ekin)}
    if revert:
        state = invert_velocities(state)
        Ss_rev = []
        done = 0
        while done < n_steps:
            state = run_chunk(state)
            done += chunk
            Ss_rev.append(entropy_2D_MB(velocity_histogram(
                state, v_max=float(np.sqrt(2 * abs(cfg.g)
                                           * cfg.water_column_height)), N=100)))
            if verbose:
                print(f"backward t = {done * cfg.dt:.3f}  S = {Ss_rev[-1]:.4f}")
        out["recovery_error"] = recovery_error(x0, state)
        out["S_backward"] = np.asarray(Ss_rev)
    out["state"] = state
    out["system"] = sys
    sys.state = state
    return out
