"""2-D Rayleigh–Bénard thermal convection: WCSPH with Boussinesq buoyancy.

Port of ``sph_mountain_waves_tpu/models/rayleigh_benard.py``: the dam-break
WCSPH scheme (continuity density, linear EOS, symmetric pressure + viscous
force, two-half-drift Verlet) with per-particle temperature and a
Cleary–Monaghan conduction sweep:

* Boussinesq buoyancy a_y = g·β·(T − T_ref) (gravity itself is absorbed into
  the hydrostatic reference state);
* conduction DT = κ·Σ 2(m_q/ρ_q)(T_p − T_q)·rDW on FLUID rows;
* isothermal plates (bottom T_hot, top T_cold) and sidewalls either clamped
  to the conductive profile ("conducting") or zero-flux ("adiabatic",
  ``WALL_ADIA`` rows excluded from conduction), the square-cavity
  configuration of the published steady Nu(Ra) benchmark (Ouertatani et al.
  2008).

Dimensionless control: Ra = g β ΔT H³/(ν κ), Pr = ν/κ.

A step has two rebuilds. On the flat layout (the config's default, as in
the reference; float32 or float64) the continuity and the conduction after
the first and the force after the second are the reference's pair
functions summed by ``ops/apply.py::apply_binary`` on the state's device.
On the float32 bucket layout they are the fused continuity + conduction
sweep ``rb_mass_heat_pass`` and the dam-break force sweep
``dambreak_force_pass`` (the config exposes m, h, μ and ρ0, which its body
reads), called through their wrappers: CUDA kernels on CUDA tensors, plain
twins on CPU tensors; a CUDA bucket state with ``use_pallas`` off is
refused, and so is a float64 bucket state. ``conduction="rkpm"`` replaces
the Cleary–Monaghan conduction by the reference's RKPM-corrected Laplacian
(``utils/rkpm.py``, quadratic-consistent at the plates and sidewalls) on the
flat layout; on the bucket layout it is refused (the reference runs it on
its resident XLA pair sum, which the port does not have).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..geometry import BoundaryLayer, Rectangle
from ..grids import Grid
from ..kernels import rDwendland2
from ..ops.apply import apply_binary, apply_unary
from ..ops.pair_sweeps import dambreak_force_pass, rb_mass_heat_pass
from ..structs import ParticleState, ParticleSystem, generate_particles
from ..utils.rkpm import corrected_laplacian
from .common import (
    check_sweep_route, frame_runner, masked_mean, masked_sum,
    maybe_checkpoint, maybe_resume,
)

FLUID = 0.0
WALL = 1.0        # isothermal (clamped-T) wall
WALL_ADIA = 2.0   # adiabatic (zero-flux) wall: excluded from conduction


@dataclasses.dataclass(frozen=True)
class Config:
    """The cavity, its physics and the engine options, with the JAX
    package's defaults."""
    H: float = 1.0                 # cavity height
    aspect: float = 2.0            # width / height
    n_rows: int = 160              # fluid rows
    rho0: float = 1000.0
    g: float = 10.0
    beta: float = 0.1              # thermal expansion coefficient
    T_hot: float = 1.0
    T_cold: float = 0.0
    Ra: float = 1.0e5
    Pr: float = 1.0
    c: float = 10.0                # artificial sound speed
    seed_amp: float = 1.0e-3       # initial temperature perturbation
    t_end: float = 5.0
    n_frames: int = 50
    # "conducting": sidewalls clamped to the conductive profile;
    # "adiabatic": zero-flux sidewalls (the published Nu(Ra) cavity)
    sidewalls: str = "conducting"
    # "cleary" (the pair Laplacian) or "rkpm" (the RKPM-corrected Laplacian,
    # flat layout only)
    conduction: str = "cleary"
    dtype: str = "float32"
    # "flat" (float32 or float64: ops/apply.py's pair sums) or "bucket"
    # (float32: the sweeps)
    layout: str = "flat"
    skin: float = 0.0
    # bucket layout: the sweeps launch their CUDA kernels on CUDA tensors
    # (CPU tensors take the plain twins either way); a CUDA bucket state
    # with False is refused. The flat layout ignores it.
    use_pallas: bool = False
    # write <out_path>/checkpoint.npz every this many frames (0: off) and on
    # the last; resume: path of a checkpoint to continue from, bitwise
    checkpoint_every: int = 0
    resume: str = ""
    # terminal sparklines of KE and Nu every frame
    live_plot: bool = False

    @property
    def dr(self) -> float:
        return self.H / self.n_rows

    @property
    def h(self) -> float:
        return 2.0 * self.dr

    @property
    def dT(self) -> float:
        return self.T_hot - self.T_cold

    @property
    def nu(self) -> float:
        """Kinematic viscosity from (Ra, Pr): ν = √(Pr·gβΔT H³ / Ra)."""
        return float(np.sqrt(self.Pr * self.g * self.beta * self.dT
                             * self.H**3 / self.Ra))

    @property
    def kappa(self) -> float:
        return self.nu / self.Pr

    @property
    def mu(self) -> float:
        """Dynamic viscosity (read by the dam-break force sweep)."""
        return self.nu * self.rho0

    @property
    def m(self) -> float:
        return self.rho0 * self.dr**2

    @property
    def dt(self) -> float:
        visc_dt = 0.125 * self.h**2 / max(self.nu, self.kappa)
        return min(0.1 * self.h / self.c, visc_dt)


def check_ported(cfg: Config) -> None:
    """Refuse a config the port does not know (RKPM on the bucket layout is
    refused by ``make_step``, a float64 bucket state at its first step by
    ``check_sweep_route``)."""
    if cfg.conduction not in ("cleary", "rkpm"):
        raise ValueError(f"conduction must be 'cleary' or 'rkpm', got "
                         f"{cfg.conduction!r}")
    if cfg.sidewalls not in ("conducting", "adiabatic"):
        raise ValueError(f"sidewalls must be 'conducting' or 'adiabatic', "
                         f"got {cfg.sidewalls!r}")


def conductive_T(cfg: Config, y):
    """The conductive profile T_hot − ΔT·clip(y/H, 0, 1), NumPy."""
    return cfg.T_hot - cfg.dT * np.clip(np.asarray(y) / cfg.H, 0.0, 1.0)


def make_system(cfg: Config) -> ParticleSystem:
    """Square-lattice cavity with 2.5·dr walls: the conductive T profile
    plus the single-roll seed on FLUID rows; with adiabatic sidewalls the
    wall rows beside the cavity become ``WALL_ADIA``."""
    check_ported(cfg)
    grid = Grid(cfg.dr, "square")
    box = Rectangle(0.0, 0.0, cfg.aspect * cfg.H, cfg.H)
    walls = BoundaryLayer(box, grid, 2.5 * cfg.dr)
    sys = ParticleSystem(
        fields={"x": 2, "v": 2, "Dv": 2, "rho": 0, "Drho": 0, "P": 0,
                "T": 0, "DT": 0, "type": 0},
        domain=box + walls, h=cfg.h, dim=2,
        dtype=torch.float64 if cfg.dtype == "float64" else torch.float32,
        defaults={"rho": cfg.rho0})
    sys.freeze_opts = {"layout": cfg.layout, "skin": cfg.skin}
    generate_particles(sys, grid, box, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    for chunk in sys._chunks:
        x, y = chunk["x"][:, 0], chunk["x"][:, 1]
        T = conductive_T(cfg, y)
        pert = (cfg.seed_amp * np.sin(np.pi * y / cfg.H)
                * np.cos(np.pi * x / cfg.H))
        chunk["T"] = np.where(chunk["type"] == FLUID, T + pert, T)
        if cfg.sidewalls == "adiabatic":
            # wall rows beyond the cavity's x-extent become zero-flux; the
            # plates stay clamped (they drive the instability)
            side = ((chunk["type"] == WALL)
                    & ((x < 0.0) | (x > cfg.aspect * cfg.H))
                    & (y >= 0.0) & (y <= cfg.H))
            chunk["type"] = np.where(side, WALL_ADIA, chunk["type"])
    return sys


def make_step(cfg: Config, engine):
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    check_ported(cfg)
    dt, m, c, rho0 = cfg.dt, cfg.m, cfg.c, cfg.rho0
    h = cfg.h
    mu = cfg.mu                    # dynamic viscosity
    T_ref = 0.5 * (cfg.T_hot + cfg.T_cold)

    def balance_of_mass(p, q, r):
        # continuity (the dam break's form, without its diffusion)
        ker = m * rDwendland2(h, r)
        return {"Drho": ker * torch.sum((p.x - q.x) * (p.v - q.v), dim=-1)}

    def heat_conduction(p, q, r):
        # DT = κ·Σ 2 (m_q/ρ_q) (T_p − T_q) rDW on FLUID rows; a WALL_ADIA q
        # exchanges no heat (zero-flux walls)
        ker = 2.0 * m * cfg.kappa / q.rho * rDwendland2(h, r)
        fluid_p = p.type == FLUID
        conducts_q = q.type != WALL_ADIA
        return {"DT": torch.where(fluid_p & conducts_q,
                                  ker * (p.T - q.T), 0.0)}

    def internal_force(p, q, r):
        ker = m * rDwendland2(h, r)
        fluid = p.type == FLUID
        dv = (-(ker * (p.P / p.rho**2 + q.P / q.rho**2))[..., None]
              * (p.x - q.x)
              + (2.0 * ker * mu / rho0**2)[..., None] * (p.v - q.v))
        return {"Dv": torch.where(fluid[..., None], dv, 0.0)}

    def find_pressure(u):
        rho = u.rho + u.Drho * dt
        fluid = u.type == FLUID
        T = torch.where(fluid, u.T + u.DT * dt, u.T)
        return {"rho": rho, "Drho": torch.zeros_like(rho),
                "P": c**2 * (rho - rho0),
                "T": T, "DT": torch.zeros_like(u.DT)}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": torch.where(fluid, u.x + 0.5 * dt * u.v, u.x),
                "Dv": torch.zeros_like(u.Dv)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        buoy = cfg.g * cfg.beta * (u.T - T_ref)  # Boussinesq anomaly force
        acc = u.Dv + torch.stack([torch.zeros_like(buoy), buoy], dim=-1)
        return {"v": torch.where(fluid, u.v + 0.5 * dt * acc, u.v)}

    sweeps = engine.layout == "bucket"
    if sweeps and cfg.conduction == "rkpm":
        raise NotImplementedError(
            "conduction='rkpm' on the bucket layout: the RKPM Laplacian runs "
            "on the flat layout's pair sums (the reference's resident bucket "
            "pair sum is not ported); take layout='flat'")

    def rkpm_conduction(state, nbrs):
        # the moment matrix and the sum both restricted to the conducting
        # rows (not WALL_ADIA): the zero-flux sidewall stays consistent
        f = state.fields
        inc = state.active & (f["type"] != WALL_ADIA)
        lap = corrected_laplacian(
            engine, state, nbrs, f["T"], include_q=inc,
            vol_of=lambda q: m / torch.clamp(q.rho, min=1e-30))
        fluid = f["type"] == FLUID
        return state.replace(DT=torch.where(
            state.active & fluid, f["DT"] + cfg.kappa * lap, f["DT"]))

    def mass_heat(state, nbrs):
        if not sweeps:
            state = apply_binary(engine, state, nbrs, balance_of_mass)
            if cfg.conduction == "rkpm":
                return rkpm_conduction(state, nbrs)
            return apply_binary(engine, state, nbrs, heat_conduction)
        drho, dT = rb_mass_heat_pass(engine, state, cfg)
        f = state.fields
        act = state.active
        fluid = f["type"] == FLUID
        return state.replace(
            Drho=torch.where(act, f["Drho"] + drho, 0.0),
            DT=torch.where(act & fluid, f["DT"] + dT, 0.0))

    def force(state, nbrs):
        if not sweeps:
            return apply_binary(engine, state, nbrs, internal_force)
        Dv = state.fields["Dv"] + torch.stack(
            dambreak_force_pass(engine, state, cfg), dim=-1)
        return state.replace(Dv=torch.where(state.active[:, None], Dv, 0.0))

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state, engine)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state = mass_heat(*engine.rebuild(state))
        state = apply_unary(state, find_pressure)
        state = apply_unary(state, move)
        state = force(*engine.rebuild(state))
        return apply_unary(state, accelerate)

    return step


def diagnostics(cfg: Config, state: ParticleState):
    """(KE, Nu) as 0-d tensors: the fluid's kinetic energy and the
    volume-averaged Nusselt number Nu = 1 + <v_y·(T − T_ref)>/(κ ΔT / H)
    (1 = pure conduction)."""
    f = state.fields
    fluid = state.active & (f["type"] == FLUID)
    ke = masked_sum(0.5 * cfg.m * torch.sum(f["v"] ** 2, dim=-1), fluid)
    conv = masked_mean(
        f["v"][:, 1] * (f["T"] - 0.5 * (cfg.T_hot + cfg.T_cold)), fluid)
    return ke, 1.0 + conv / (cfg.kappa * cfg.dT / cfg.H)


def baseline_config(**overrides) -> Config:
    """The ~50k-particle cavity (n_rows 160, aspect 2: N = 53,621) in the
    production layout: float32, bucket, the CUDA sweeps, skin 0.15."""
    kw = dict(n_rows=160, dtype="float32", layout="bucket", skin=0.15,
              use_pallas=True)
    kw.update(overrides)
    return Config(**kw)


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """The full simulation on ``device`` (the card unless the caller asks
    for the CPU): frames every n_steps // n_frames steps with KE and Nu;
    with ``out_path`` ``frame<k>.vtp`` of v, P, T and type after every
    frame, ``result.pvd``, ``data.csv`` (t, KE, Nu), ``kinetic_energy.pdf``,
    ``nusselt.pdf`` and ``checkpoint.npz`` (``cfg.checkpoint_every``;
    ``cfg.resume`` continues bit for bit); ``cfg.live_plot`` prints the KE
    and Nu sparklines every frame."""
    from ..io import new_pvd_file, save_csv, save_frame, save_pvd_file
    from ..utils.plots import live_plot, plot_series

    sys = make_system(cfg)
    state = sys.freeze(device=device)
    state, k0 = maybe_resume(cfg, state)  # bitwise restart
    step = make_step(cfg, sys.engine)
    n_steps = max(1, int(round(cfg.t_end / cfg.dt)))
    steps_per_frame = max(1, n_steps // max(cfg.n_frames, 1))
    run_frame = frame_runner(step, steps_per_frame)

    out = new_pvd_file(out_path, resume=k0 > 0) if out_path else None
    ts, KEs, Nus = [], [], []
    k, frame = k0, 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        frame += 1
        t = k * cfg.dt
        ke, nu = (float(v) for v in diagnostics(cfg, state))
        ts.append(t)
        KEs.append(ke)
        Nus.append(nu)
        if verbose:
            print(f"t = {t:.3f}  KE = {ke:.4e}  Nu = {nu:.3f}  "
                  f"n = {int(state.n)}")
        if cfg.live_plot:
            live_plot({"KE": KEs, "Nu": Nus})
        if out:
            save_frame(out, state, "v", "P", "T", "type", time=t)
        maybe_checkpoint(cfg, out, state, sys.engine, k, t, frame,
                         last=k >= n_steps)
    if out:
        save_pvd_file(out)
        save_csv(os.path.join(out.path, "data.csv"),
                 {"t": ts, "KE": KEs, "Nu": Nus}, merge_history=k0 > 0)
        plot_series(os.path.join(out.path, "kinetic_energy.pdf"), ts,
                    {"KE": KEs}, ylabel="kinetic energy (J)")
        plot_series(os.path.join(out.path, "nusselt.pdf"), ts,
                    {"Nu": Nus}, ylabel="Nusselt number")
    sys.state = state
    return {"t": np.asarray(ts), "KE": np.asarray(KEs), "Nu": np.asarray(Nus),
            "state": state, "system": sys}
