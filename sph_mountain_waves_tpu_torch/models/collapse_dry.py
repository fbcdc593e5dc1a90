"""2-D WCSPH dam break ("water collapse", explicit scheme).

Port of ``sph_mountain_waves_tpu/models/collapse_dry.py`` (the Violeau
dam-break recomputation): continuity-equation density with δ-diffusion,
linear EOS, symmetric pressure + viscous forces, two-half-drift
pressure-stabilised Verlet, and the wavefront X / column height H / total
energy E observables.

The config's defaults are the reference's: the flat layout in float64. There
the two pair sums of a step are the reference's pair functions summed by
``ops/apply.py::apply_binary`` on the state's device. On the float32 bucket
layout they are ``dambreak_mass_pass`` and ``dambreak_force_pass``
(``ops/pair_sweeps.py``), called through their wrappers: CUDA kernels on
CUDA tensors, plain PyTorch twins on CPU tensors; a float64 bucket state
raises. With an output directory ``run`` also writes ``plot_dambreak``'s
figures (``utils/plots.py``); ``cfg.live_plot`` prints the X and H
sparklines every frame.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..geometry import BoundaryLayer, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDwendland2
from ..ops.apply import apply_binary, apply_unary
from ..ops.pair_sweeps import dambreak_force_pass, dambreak_mass_pass
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import (
    check_sweep_route, frame_runner, masked_max, masked_sum, maybe_checkpoint,
    maybe_resume,
)

FLUID = 0.0
WALL = 1.0


@dataclasses.dataclass(frozen=True)
class Config:
    # physical
    dr: float = 1.5e-2
    rho0: float = 1000.0
    c: float = 50.0
    g: float = -7.0          # gravity y-component
    mu: float = 8.4e-4
    nu: float = 1.0e-6
    # geometrical
    water_column_width: float = 1.0
    water_column_height: float = 2.0
    box_height: float = 3.0
    box_width: float = 4.0
    # temporal
    t_end: float = 4.0
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
    # write <out_path>/checkpoint.npz every this many frames (0: off) and on
    # the last; resume: path of a checkpoint to continue from, bitwise
    checkpoint_every: int = 0
    # terminal sparklines of X and H every frame
    live_plot: bool = False
    resume: str = ""

    @property
    def h(self) -> float:
        return 3.0 * self.dr

    @property
    def m(self) -> float:
        return self.rho0 * self.dr**2

    @property
    def dt(self) -> float:
        return 0.1 * self.h / self.c

    @property
    def wall_width(self) -> float:
        return 2.5 * self.dr


def make_system(cfg: Config) -> ParticleSystem:
    """Geometry + hydrostatic init."""
    grid = Grid(cfg.dr, "hexagonal")
    box = Rectangle(0.0, 0.0, cfg.box_width, cfg.box_height)
    fluid = Rectangle(0.0, 0.0, cfg.water_column_width, cfg.water_column_height)
    walls = BoundaryLayer(box, grid, cfg.wall_width)
    walls = Specification(walls, lambda x: x[..., 1] < cfg.box_height)  # no top lid

    sys = ParticleSystem(
        fields={"x": 2, "v": 2, "Dv": 2, "rho": 0, "Drho": 0, "P": 0, "type": 0},
        domain=box + walls, h=cfg.h, dim=2,
        dtype=torch.float64 if cfg.dtype == "float64" else torch.float32)
    sys.freeze_opts = {"layout": cfg.layout, "skin": cfg.skin}
    generate_particles(sys, grid, fluid, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    # hydrostatic pressure/density init
    for chunk in sys._chunks:
        P = cfg.rho0 * cfg.g * (chunk["x"][:, 1] - cfg.water_column_height)
        chunk["P"] = P
        chunk["rho"] = cfg.rho0 + P / cfg.c**2
    return sys


def make_step(cfg: Config, engine):
    """The Verlet step and the force bootstrap: ``(step, init_forces)``."""
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt, m, c, rho0, mu, nu, g = (cfg.dt, cfg.m, cfg.c, cfg.rho0, cfg.mu,
                                 cfg.nu, cfg.g)
    h = cfg.h

    def balance_of_mass(p, q, r):
        # Drho += m rDW (x_pq·v_pq + 2 ν (ρ_p − ρ_q))
        ker = m * rDwendland2(h, r)
        x_pq = p.x - q.x
        v_pq = p.v - q.v
        return {"Drho": ker * (torch.sum(x_pq * v_pq, dim=-1)
                               + 2.0 * nu * (p.rho - q.rho))}

    def internal_force(p, q, r):
        # symmetric pressure + viscous force, on FLUID rows only
        ker = m * rDwendland2(h, r)
        x_pq = p.x - q.x
        v_pq = p.v - q.v
        fluid = p.type == FLUID
        dv = (-(ker * (p.P / p.rho**2 + q.P / q.rho**2))[..., None] * x_pq
              + (2.0 * ker * mu / rho0**2)[..., None] * v_pq)
        return {"Dv": torch.where(fluid[..., None], dv, 0.0)}

    def find_pressure(u):
        rho = u.rho + u.Drho * dt
        return {"rho": rho, "Drho": torch.zeros_like(rho),
                "P": c**2 * (rho - rho0)}

    def move(u):
        # half drift + acceleration reset
        fluid = (u.type == FLUID)[:, None]
        return {"x": torch.where(fluid, u.x + 0.5 * dt * u.v, u.x),
                "Dv": torch.zeros_like(u.Dv)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        gvec = torch.zeros_like(u.v)
        gvec[:, 1] = g
        return {"v": torch.where(fluid, u.v + 0.5 * dt * (u.Dv + gvec), u.v)}

    sweeps = engine.layout == "bucket"

    def mass(state, nbrs):
        if not sweeps:
            return apply_binary(engine, state, nbrs, balance_of_mass)
        drho = state.fields["Drho"] + dambreak_mass_pass(engine, state, cfg)
        return state.replace(Drho=torch.where(state.active, drho, 0.0))

    def force(state, nbrs):
        if not sweeps:
            return apply_binary(engine, state, nbrs, internal_force)
        dv = state.fields["Dv"] + torch.stack(
            dambreak_force_pass(engine, state, cfg), dim=-1)
        return state.replace(Dv=torch.where(state.active[:, None], dv, 0.0))

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state, engine)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state = mass(*engine.rebuild(state))
        state = apply_unary(state, find_pressure)
        state = apply_unary(state, move)
        state = force(*engine.rebuild(state))
        return apply_unary(state, accelerate)

    def init_forces(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state, engine)
        return force(*engine.rebuild(state))

    return step, init_forces


def get_globals(cfg: Config, state: ParticleState):
    """(X, H, E) observables, as 0-d tensors."""
    f = state.fields
    act = state.active
    fluid = act & (f["type"] == FLUID)
    X = masked_max(f["x"][:, 0] / cfg.water_column_width, fluid)
    col = fluid & (f["x"][:, 0] > cfg.h) & (f["x"][:, 0] < 2.0)
    H = masked_max(f["x"][:, 1] / cfg.water_column_height, col)
    kinetic = 0.5 * cfg.m * torch.sum(f["v"] ** 2, dim=-1)
    potential = -cfg.m * cfg.g * f["x"][:, 1]
    rho_ratio = torch.abs(f["rho"] / cfg.rho0)
    internal = cfg.m * cfg.c**2 * (torch.log(rho_ratio) + cfg.rho0 / f["rho"] - 1.0)
    E = masked_sum(kinetic + potential + internal, act)
    return X, H, E


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """The full simulation on ``device`` (the card unless the caller asks for
    the CPU). Returns the time series t (scaled by sqrt(−2g)), X, H, E, the
    final state and the system. With ``out_path``: ``frame<k>.vtp`` of v, P
    and type at t = 0 and after every frame, ``result.pvd``, ``data.csv``
    ``dambreak_X.pdf``/``dambreak_H.pdf`` against the digitised reference
    curves and, every ``cfg.checkpoint_every`` frames and on the last,
    ``checkpoint.npz``; with ``cfg.live_plot`` the X and H sparklines every
    frame."""
    from ..io import new_pvd_file, save_csv, save_frame, save_pvd_file
    from ..utils.plots import live_plot, plot_dambreak

    sys = make_system(cfg)
    state = sys.freeze(device=device)
    step, init_forces = make_step(cfg, sys.engine)

    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
    run_frame = frame_runner(step, steps_per_frame)

    # bitwise restart; the checkpointed state is post-init_forces, so the
    # half-kick bootstrap must not re-run on resume
    state, k0 = maybe_resume(cfg, state)
    if not k0:
        state = init_forces(state)
    out = new_pvd_file(out_path, resume=k0 > 0) if out_path else None

    ts, Xs, Hs, Es = [], [], [], []

    def record(t):
        X, H, E = (float(v) for v in get_globals(cfg, state))
        ts.append(t)
        Xs.append(X)
        Hs.append(H)
        Es.append(E)
        return X, H, E

    if not k0:
        record(0.0)
        if out:
            save_frame(out, state, "v", "P", "type", time=0.0)

    k, frame = k0, 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        frame += 1
        t = k * cfg.dt
        X, H, E = record(t * np.sqrt(-2.0 * cfg.g))
        if verbose:
            print(f"t = {t:.4f} s  X = {X:.3f}  H = {H:.3f}  E = {E:.6e}")
        if cfg.live_plot:
            live_plot({"X": Xs, "H": Hs})
        if out:
            save_frame(out, state, "v", "P", "type", time=t)
        maybe_checkpoint(cfg, out, state, sys.engine, k, t, frame,
                         last=k >= n_steps)
    if out:
        save_pvd_file(out)
        save_csv(os.path.join(out.path, "data.csv"),
                 {"t": ts, "X": Xs, "H": Hs, "E": Es}, merge_history=k0 > 0)
        plot_dambreak(out.path, ts, Xs, Hs)
    sys.state = state
    return {"t": np.asarray(ts), "X": np.asarray(Xs), "H": np.asarray(Hs),
            "E": np.asarray(Es), "state": state, "system": sys}
