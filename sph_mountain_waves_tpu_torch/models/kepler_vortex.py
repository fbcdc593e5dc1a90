"""Kepler vortex: a self-gravitating-disc surrogate.

Port of ``sph_mountain_waves_tpu/models/kepler_vortex.py``: a Gaussian ring
of particles orbits a central mass. Ring radii by inverse-CDF sampling of
the surface density Σ(r) = 2πr·exp(−30(1−r/r0)²), circles built ring by
ring (no lattice), summation density against a per-particle ρ0, central
gravity −GM x/|x|³ inside the reversible ``rev_add`` kick and drift
(``utils/fixpa.py``), a Lennard-Jones wall fallback, and the energy budget
(kinetic, potential, internal) per frame.

The config's defaults are the reference's: the flat layout in float64. The
pair sums are the reference's pair functions summed by
``ops/apply.py::apply_binary`` on the state's device; no hand-written
kernel lies on this path (the reference launches its Pallas kernels only
on the bucket layout).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import Rectangle
from ..kernels import rDwendland2, wendland2
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem
from ..utils.fixpa import rev_add
from .common import frame_runner, masked_sum

FLUID = 0.0
WALL = 1.0


@dataclasses.dataclass(frozen=True)
class Config:
    r0: float = 10.0
    GM: float = 1000.0
    N_rings: int = 25
    c: float = 0.01
    rho0: float = 1.0
    eps: float = 1e-16
    n_orbits: float = 10.0
    n_frames: int = 200
    dtype: str = "float64"

    def vphi_r(self, r):
        return np.sqrt(self.GM) / np.sqrt(r)

    @property
    def omega0(self) -> float:
        return self.vphi_r(self.r0) / self.r0

    def sigma(self, r):
        return 2 * np.pi * r * np.exp(-30 * (1 - r / self.r0) ** 2)

    def ring_radii(self) -> np.ndarray:
        """Inverse-CDF sampled Gaussian ring radii."""
        r_grid = np.linspace(0.0, 40.0, 16001)
        pdf = self.sigma(r_grid)
        cdf = np.cumsum(pdf)
        cdf /= cdf[-1]
        us = np.arange(0.01, 0.99 + 1e-12, (0.99 - 0.01) / self.N_rings)
        return np.interp(us, cdf, r_grid)

    @property
    def dr(self) -> float:
        r_grid = np.linspace(0.0, 40.0, 16001)
        cdf = np.cumsum(self.sigma(r_grid))
        cdf /= cdf[-1]
        return float(np.interp(0.25 + 1.0 / self.N_rings, cdf, r_grid)
                     - np.interp(0.25, cdf, r_grid))

    @property
    def h(self) -> float:
        return 3.0 * self.dr

    @property
    def m(self) -> float:
        return self.rho0 * self.dr**2

    @property
    def box_width(self) -> float:
        return 4 * self.r0

    @property
    def dr_wall(self) -> float:
        return 0.95 * self.dr

    @property
    def E_wall(self) -> float:
        return self.GM / self.r0

    @property
    def dt(self) -> float:
        return 0.0001 * self.h / self.c

    @property
    def t_end(self) -> float:
        return self.n_orbits * 2 * np.pi / self.omega0

    @property
    def torch_dtype(self):
        return torch.float64 if self.dtype == "float64" else torch.float32


def make_system(cfg: Config) -> ParticleSystem:
    """The rings, one circle each: ring i at radius r_i with angular step
    dphi (the first from the first two radii, then the radial gap over the
    radius), on circular orbits."""
    domain = Rectangle(-cfg.box_width, -cfg.box_width, cfg.box_width,
                       cfg.box_width)
    sys = ParticleSystem(
        fields={"x": 2, "v": 2, "a": 2, "P": 0, "rho": 0, "rho0": 0, "type": 0},
        domain=domain, h=cfg.h, dim=2, dtype=cfg.torch_dtype)
    sys.freeze_opts = {"layout": "flat"}  # the reference's default layout
    rs = cfg.ring_radii()
    dphi = rs[1] / rs[0] - 1.0
    for i in range(len(rs) - 1):
        r = rs[i]
        phis = np.arange(0.0, 2 * np.pi, dphi)
        xs = np.stack([r * np.cos(phis), r * np.sin(phis)], axis=-1)
        vphi = cfg.vphi_r(r)
        vs = np.stack([-vphi * np.sin(phis), vphi * np.cos(phis)], axis=-1)
        sys.add_particles(xs, {"v": vs, "type": np.full(len(xs), FLUID)})
        dphi = (rs[i + 1] - r) / r
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
        a_ff = -(ker * (p.P / cfg.rho0**2 + q.P / cfg.rho0**2))[..., None] * x_pq
        s = cfg.dr_wall / (r + cfg.eps)
        lj = (-cfg.E_wall / (r + cfg.eps) ** 2 * (s**2 - s**4))[..., None] * x_pq
        fw = (p.type == FLUID) & (q.type == WALL) & (r < cfg.dr_wall)
        return {"a": torch.where(both_fluid(p, q)[..., None], a_ff, 0.0)
                + torch.where(fw[..., None], lj, 0.0)}

    def reset(u):
        return {"a": torch.zeros_like(u.a), "rho": torch.zeros_like(u.rho)}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": torch.where(fluid, rev_add(u.x, dt * u.v), u.x)}

    def accelerate(u):
        # central gravity inside the reversible kick
        fluid = (u.type == FLUID)[:, None]
        rr = torch.sqrt(torch.sum(u.x**2, dim=-1))
        grav = -cfg.GM / torch.clamp(rr, min=1e-12)[:, None] ** 3 * u.x
        kick = 0.5 * dt * rev_add(u.a, grav)
        return {"v": torch.where(fluid, rev_add(u.v, kick), u.v)}

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


def energies(cfg: Config, state: ParticleState):
    """(kinetic, potential, internal) energy as floats."""
    f = state.fields
    act = state.active
    E_kin = masked_sum(0.5 * cfg.m * torch.sum(f["v"] ** 2, dim=-1), act)
    rr = torch.sqrt(torch.sum(f["x"] ** 2, dim=-1))
    E_pot = masked_sum(-cfg.GM * cfg.m / torch.clamp(rr, min=1e-12), act)
    E_int = masked_sum(0.5 * cfg.m * cfg.c**2
                       * (f["rho"] - f["rho0"]) ** 2 / cfg.rho0**2, act)
    return float(E_kin), float(E_pot), float(E_int)


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False, n_orbits: float | None = None,
        device="cuda"):
    """The orbits on ``device`` (the card unless the caller asks for the
    CPU), ``n_orbits`` (default ``cfg.n_orbits``) of them. Returns the
    energies per frame (``E_kin``, ``E_pot``, ``E_int`` and their sum
    ``E``, the first at t = 0), the final state and the system. With
    ``out_path``: ``frame<k>.vtp`` of v, P and rho after every frame and
    ``result.pvd``."""
    from ..io import new_pvd_file, save_frame, save_pvd_file

    sys = make_system(cfg)
    state = sys.freeze(device=device)
    step, init = make_step(cfg, sys.engine)
    state = init(state)

    t_end = cfg.t_end if n_orbits is None else n_orbits * 2 * np.pi / cfg.omega0
    n_steps = int(round(t_end / cfg.dt))
    steps_per_frame = max(1, n_steps // cfg.n_frames)
    run_frame = frame_runner(step, steps_per_frame)
    out = new_pvd_file(out_path) if out_path else None
    Es = [energies(cfg, state)]
    k = 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        Es.append(energies(cfg, state))
        if verbose:
            Ek, Ep, Ei = Es[-1]
            print(f"t = {k * cfg.dt:.2f}  E = {Ek + Ep + Ei:.4f}  "
                  f"(kin {Ek:.3f} pot {Ep:.3f})")
        if out:
            save_frame(out, state, "v", "P", "rho", time=k * cfg.dt)
    if out:
        save_pvd_file(out)
    sys.state = state
    E = np.asarray(Es)
    return {"E_kin": E[:, 0], "E_pot": E[:, 1], "E_int": E[:, 2],
            "E": E.sum(axis=1), "state": state, "system": sys}
