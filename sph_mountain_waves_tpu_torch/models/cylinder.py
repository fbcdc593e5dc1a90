"""DFG flow around a cylinder: a dynamic particle count.

Port of ``sph_mountain_waves_tpu/models/cylinder.py``: channel flow past a
cylinder with a ramped parabolic inflow; inflow-column recycling (an
INFLOW particle that crosses x ≥ 0 becomes FLUID and a fresh INFLOW
particle spawns one bc_width upstream, ``add_new_particles``); outflow
removal past the channel's end at each rebuild; drag and lift from the
force on the OBSTACLE particles, averaged over the second half of the run,
against the published DFG coefficients.

The config's defaults are the reference's: the flat layout in float64. The
state holds ``capacity_factor`` × the built count of rows; the spare rows
are the spawn pool, and outflow removal frees rows at each rebuild, so the
pool recycles. The pair sums are the reference's pair functions summed by
``ops/apply.py::apply_binary`` on the state's device, no hand-written
kernel. ``make_system(cfg, init_vtp=...)`` boots from a VTP state
(``io.import_particles``) in place of the geometric build.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import BoundaryLayer, Circle, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDwendland2
from ..ops.apply import apply_binary, apply_unary
from ..structs import ParticleState, ParticleSystem, generate_particles

FLUID = 0.0
INFLOW = 1.0
WALL = 2.0
OBSTACLE = 3.0


@dataclasses.dataclass(frozen=True)
class Config:
    chan_l: float = 2.2
    chan_w: float = 0.41
    cyl1: float = 0.2
    cyl2: float = 0.005
    cyl_r: float = 0.05
    n_around: int = 40            # dr = pi*cyl_r/n_around
    U_max: float = 0.3
    rho0: float = 1.0
    mu: float = 1.0e-3
    t_end: float = 40.0
    t_acc: float = 1.0
    n_frames: int = 200
    max_spawn: int = 128          # spawns a step, at most
    dtype: str = "float64"

    @property
    def dr(self) -> float:
        return np.pi * self.cyl_r / self.n_around

    @property
    def h0(self) -> float:
        return 2.4 * self.dr

    @property
    def bc_width(self) -> float:
        return 6 * self.dr

    @property
    def m0(self) -> float:
        return self.rho0 * self.dr**2

    @property
    def c(self) -> float:
        return 20.0 * self.U_max

    @property
    def nu(self) -> float:
        return 0.1 * self.h0 * self.c

    @property
    def dt(self) -> float:
        return 0.1 * self.h0 / self.c

    @property
    def t_measure(self) -> float:
        return self.t_end / 2

    @property
    def torch_dtype(self):
        return torch.float64 if self.dtype == "float64" else torch.float32


FIELDS = {"x": 2, "v": 2, "a": 2, "rho": 0, "Drho": 0, "h": 0, "Dh": 0,
          "P": 0, "m": 0, "type": 0}


def make_system(cfg: Config, init_vtp: str | None = None) -> ParticleSystem:
    """The channel's fluid, the cylinder, the side walls and the inflow
    column, on the hexagonal lattice; or, with ``init_vtp``, the particles
    of that VTP file."""
    x2_min = -cfg.chan_w / 2 - cfg.bc_width
    x2_max = cfg.chan_w / 2 + cfg.bc_width
    domain = Rectangle(-cfg.bc_width, x2_min, cfg.chan_l, x2_max)
    sys = ParticleSystem(fields=FIELDS, domain=domain, h=cfg.h0, dim=2,
                         dtype=cfg.torch_dtype,
                         defaults={"rho": cfg.rho0, "h": cfg.h0, "m": cfg.m0})
    sys.freeze_opts = {"layout": "flat"}  # the reference's default layout
    if init_vtp is not None:
        from ..io import import_particles
        import_particles(sys, init_vtp)
        return sys

    grid = Grid(cfg.dr, "hexagonal")
    channel = Rectangle(0.0, -cfg.chan_w / 2, cfg.chan_l, cfg.chan_w / 2)
    cyl = Circle(cfg.cyl1, cfg.cyl2, cfg.cyl_r)
    walls = Specification(BoundaryLayer(channel, grid, cfg.bc_width),
                          lambda x: (x[..., 0] > 0) & (x[..., 0] < cfg.chan_l))
    inflow = Rectangle(-cfg.bc_width, -cfg.chan_w / 2, -1e-9, cfg.chan_w / 2)
    generate_particles(sys, grid, channel - cyl, lambda xs: {"type": FLUID})
    generate_particles(sys, grid, cyl, lambda xs: {"type": OBSTACLE})
    generate_particles(sys, grid, walls, lambda xs: {"type": WALL})
    generate_particles(sys, grid, inflow, lambda xs: {"type": INFLOW})
    return sys


def add_new_particles(cfg: Config, state: ParticleState) -> ParticleState:
    """Inflow recycling: every active INFLOW row at x ≥ 0 becomes FLUID,
    and for each of the first ``cfg.max_spawn`` of them (in row order) a
    fresh INFLOW row spawns one bc_width upstream, at rest, with ρ0, h0 and
    m0, into the first free rows (in row order). A spawn with no free row
    left is dropped.

    The sources and targets are the first entries of stable sorts of row
    scores (a candidate scores its row index, the others the row count), as
    the reference takes them. The targets are distinct rows, so each field
    is written once at each target: a spawned row takes its new value, a
    dropped spawn's target row its old one. Nothing is written out of
    range and no index repeats, and the step reads nothing on the host."""
    f = state.fields
    n = state.capacity
    active = state.active
    dev = active.device
    conv = active & (f["type"] == INFLOW) & (f["x"][:, 0] >= 0.0)
    new_type = torch.where(conv, FLUID, f["type"])

    k = cfg.max_spawn
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    src = torch.argsort(torch.where(conv, rows, n), stable=True)[:k]
    tgt = torch.argsort(torch.where(active, n, rows), stable=True)[:k]
    ok = conv[src] & ~active[tgt]

    def put(arr, val):
        okb = ok.reshape((-1,) + (1,) * (arr.ndim - 1))
        out = arr.clone()
        out[tgt] = torch.where(okb, val, arr[tgt])
        return out

    x = f["x"]
    fields = dict(f)
    fields["type"] = put(new_type, INFLOW)
    fields["x"] = put(x, x[src] - x.new_tensor([cfg.bc_width, 0.0]))
    for name in ("v", "a", "Drho", "Dh", "P"):
        fields[name] = put(f[name], 0.0)
    fields["rho"] = put(f["rho"], cfg.rho0)
    fields["h"] = put(f["h"], cfg.h0)
    fields["m"] = put(f["m"], cfg.m0)
    return ParticleState(fields=fields, active=put(active, True))


def make_step(cfg: Config, engine):
    """The step on the carry ``(state, t, C_acc, nsamp)``: kick, drift,
    inflow recycling, the inflow speed at the new t, rebuild, continuity,
    EOS, force, the obstacle's force coefficients summed once t passes
    ``t_measure``, kick. ``t``, ``C_acc`` and ``nsamp`` are tensors on the
    state's device."""
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt = cfg.dt

    def set_inflow_speed(u, t):
        s = torch.clamp(t / cfg.t_acc, max=1.0)
        v1 = s * cfg.U_max * (1.0 - (2.0 * u.x[:, 1] / cfg.chan_w) ** 2)
        v = torch.stack([v1, torch.zeros_like(v1)], dim=-1)
        return {"v": torch.where((u.type == INFLOW)[:, None], v, u.v)}

    def balance_of_mass(p, q, r):
        ker = q.m * rDwendland2(p.h, r)
        conv = ker * torch.sum((p.x - q.x) * (p.v - q.v), dim=-1)
        both = (p.type == FLUID) & (q.type == FLUID)
        diff = torch.where(both, 2 * cfg.nu / p.rho * (p.rho - q.rho), 0.0)
        return {"Drho": conv + diff}

    def find_pressure(u):
        upd = u.x[:, 0] >= -cfg.bc_width + cfg.h0
        rho = torch.where(upd, u.rho + u.Drho * dt, u.rho)
        return {"rho": rho, "Drho": torch.zeros_like(u.Drho),
                "P": cfg.c**2 * (rho - cfg.rho0)}

    def internal_force(p, q, r):
        ker = q.m * rDwendland2(p.h, r)
        x_pq = p.x - q.x
        a = -(ker * (p.P / p.rho**2 + q.P / q.rho**2))[..., None] * x_pq
        visc = (8.0 * ker * cfg.mu / (p.rho * q.rho)
                * torch.sum((p.v - q.v) * x_pq, dim=-1)
                / (r * r + 0.01 * p.h * p.h))
        return {"a": a + visc[..., None] * x_pq}

    def move(u):
        mob = ((u.type == FLUID) | (u.type == INFLOW))[:, None]
        return {"x": torch.where(mob, u.x + dt * u.v, u.x),
                "a": torch.zeros_like(u.a)}

    def stir(u):
        # the artificial radial forcing toward the cylinder's axis
        fx = cfg.cyl1 - u.x[:, 0]
        fy = -u.x[:, 1]
        absf2 = fx**2 + u.x[:, 1] ** 2
        return 0.3 * cfg.U_max**2 * torch.stack([fx, fy], dim=-1) / absf2[:, None]

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        return {"v": torch.where(fluid, u.v + 0.5 * dt * (u.a + stir(u)), u.v)}

    def step(carry):
        state, t, C_acc, nsamp = carry
        t = t + dt
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state = add_new_particles(cfg, state)
        state = apply_unary(state, set_inflow_speed, t=t)
        state, nbrs = engine.rebuild(state)
        state = apply_binary(engine, state, nbrs, balance_of_mass)
        state = apply_unary(state, find_pressure)
        state = apply_binary(engine, state, nbrs, internal_force)
        measure = t > cfg.t_measure
        C_acc = C_acc + torch.where(measure, obstacle_force(cfg, state), 0.0)
        nsamp = nsamp + measure.to(nsamp.dtype)
        state = apply_unary(state, accelerate)
        return (state, t, C_acc, nsamp)

    return step


def obstacle_force(cfg: Config, state: ParticleState) -> torch.Tensor:
    """C = 2·Σ m·a / (L·U_mean²) over the OBSTACLE rows: [drag, lift]."""
    f = state.fields
    mask = (state.active & (f["type"] == OBSTACLE))[:, None]
    F = torch.sum(torch.where(mask, f["m"][:, None] * f["a"], 0.0), dim=0)
    U_mean = 2.0 / 3.0 * cfg.U_max
    return 2.0 * F / (0.1 * U_mean**2)


def run(cfg: Config = Config(), out_path: str | None = None,
        verbose: bool = False, capacity_factor: float = 1.5,
        init_vtp: str | None = None, device="cuda"):
    """The channel flow on ``device`` (the card unless the caller asks for
    the CPU) to ``cfg.t_end``. Returns the last frame's force coefficients
    ``C_SPH`` (drag, lift, averaged over t > t_measure), ``C_ref``, the
    relative error, the active count per frame ``n``, the final state and
    the system. With ``out_path``: ``frame<k>.vtp`` of v, P, rho and type
    after every frame and ``result.pvd``."""
    from ..io import new_pvd_file, save_frame, save_pvd_file

    sys = make_system(cfg, init_vtp=init_vtp)
    state = sys.freeze(capacity=int(sys.n_built * capacity_factor),
                       device=device)
    step = make_step(cfg, sys.engine)

    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))

    def run_frame(carry):
        for _ in range(steps_per_frame):
            carry = step(carry)
        return carry

    out = new_pvd_file(out_path) if out_path else None
    x = state.fields["x"]
    carry = (state, x.new_zeros(()), x.new_zeros(2),
             torch.zeros((), dtype=torch.int32, device=x.device))
    ns, Cs = [], []
    k = 0
    while k < n_steps:
        carry = run_frame(carry)
        k += steps_per_frame
        state, t, C_acc, nsamp = carry
        ns.append(int(state.n))
        C = C_acc.cpu().numpy() / max(int(nsamp), 1)
        Cs.append(C)
        if verbose:
            print(f"t = {float(t):.3f}  N = {ns[-1]}  C_drag = {C[0]:.4f}  "
                  f"C_lift = {C[1]:.5f}")
        if out:
            save_frame(out, state, "v", "P", "rho", "type", time=float(t))
    if out:
        save_pvd_file(out)
    C_ref = np.array([5.57953523384, 0.010618948146])
    C_SPH = Cs[-1]
    rel = np.linalg.norm(C_SPH - C_ref) / np.linalg.norm(C_ref)
    sys.state = state
    return {"C_SPH": C_SPH, "C_ref": C_ref, "relative_error": rel,
            "n": np.asarray(ns), "state": state, "system": sys}
