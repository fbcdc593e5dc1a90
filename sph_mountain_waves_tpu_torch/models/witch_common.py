"""Shared scaffolding for the mountain-wave (Witch of Agnesi) schemes.

Port of ``sph_mountain_waves_tpu/models/witch_common.py``: the configuration,
the hydrostatic isothermal background (NumPy on the host at build time, torch
in the step), the domain/fence/mountain geometry and particle generation, the
Rayleigh sponge and the velocity diagnostics. A 400 km × 26 km rectangle with
a 6·dr fence, hexagonal lattice at dr = 26 km / n_rows, T = 250 K,
N² = 0.0196, damping above 12 km.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..geometry import BoundaryLayer, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDwendland2
from ..structs import ParticleSystem, generate_particles
from .common import masked_max, masked_mean

FLUID = 0.0
WALL = 1.0


@dataclasses.dataclass(frozen=True)
class WitchConfig:
    """The mountain-wave constants and engine options, with the JAX
    package's defaults (see its WitchConfig for each option's rationale)."""
    # geometry
    dom_height: float = 26e3
    dom_length: float = 400e3
    n_rows: int = 75                  # dr = dom_height / n_rows
    bc_rows: int = 6                  # bc_width = 6 dr
    h_m: float = 0.0                  # mountain height (disabled by default)
    a: float = 0.0                    # mountain half-width
    # smoothing
    eta: float = 1.8
    # physical
    rho0: float = 1.393
    # artificial
    eps: float = 0.01
    alpha: float = 0.1
    # meteorological
    N_bv: float = float(np.sqrt(0.0196))
    g: float = 9.81
    R_mass: float = 287.05
    z_b: float = 12e3                 # bottom of damping layer
    # thermodynamical
    R_gas: float = 8.314
    T_bg: float = 250.0
    # temporal
    t_end: float = 20.0
    n_frames: int = 100
    # floors
    rho_floor: float = 1e-6
    P_floor: float = 1e-10
    dtype: str = "float32"
    # include the kernel self-term in the density sum
    self_density: bool = False
    # neighbor engine: "flat" (rows sorted at every rebuild, pair sums by
    # ops/apply.py, float32 or float64) or "bucket" (rows are bucket slots,
    # pair sums by the sweeps, float32); skin > 0 widens the cells to
    # (1+skin)·h and defers the bucket rescatter
    layout: str = "flat"
    skin: float = 0.0
    # bucket layout: the pair sweeps launch their CUDA kernels on CUDA
    # tensors (CPU tensors take the plain twins either way); a CUDA bucket
    # state with False is refused. The flat layout ignores it.
    use_pallas: bool = False
    # T/θ materialize once per frame (make_finalize) instead of every step
    lazy_diagnostics: bool = False
    # bucket cells sized to exact multiples of the hexagonal lattice pitch
    lattice_cells: bool = False
    # bucket-capacity override (None: measured occupancy + headroom)
    bucket_cap: int | None = None
    # approximate reciprocals for the momentum-body divides
    fast_math: bool = False
    # write <out_path>/checkpoint.npz every this many frames (0: off) and
    # on the last; resume: path of a checkpoint to continue from, bitwise
    checkpoint_every: int = 0
    resume: str = ""
    # boot from a saved ParaView frame instead of the lattice: positions and
    # the frame's fields from the file, every other field rebuilt from the
    # hydrostatic background at the saved positions (approximate by
    # construction; the bitwise restart is ``resume``)
    init_vtp: str = ""
    # terminal sparklines of the run's observables every frame
    live_plot: bool = False

    @property
    def dr(self) -> float:
        return self.dom_height / self.n_rows

    @property
    def bc_width(self) -> float:
        return self.bc_rows * self.dr

    @property
    def h0(self) -> float:
        return self.eta * self.dr

    @property
    def c(self) -> float:
        return float(np.sqrt(65e3 * (7 / 5) / self.rho0))

    @property
    def nu(self) -> float:
        return 0.1 * self.h0 * self.c

    @property
    def beta(self) -> float:
        return 2.0 * self.alpha

    @property
    def gamma_r(self) -> float:
        return 10.0 * self.N_bv

    @property
    def z_t(self) -> float:
        return self.dom_height

    @property
    def cp(self) -> float:
        return 7.0 * self.R_mass / 2.0

    @property
    def cv(self) -> float:
        return self.cp - self.R_mass

    @property
    def gamma(self) -> float:
        return self.cp / self.cv

    @property
    def dt(self) -> float:
        return 0.01 * self.h0 / self.c

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32


# ------------------------------------------------------- background state

def background_density(cfg: WitchConfig, y):
    """ρ_bg(y) = ρ0 exp(−y g / (R T_bg)), NumPy."""
    return cfg.rho0 * np.exp(-np.asarray(y) * cfg.g / (cfg.R_mass * cfg.T_bg))


def background_pressure(cfg: WitchConfig, y):
    """P_bg = R T_bg ρ_bg, NumPy."""
    return cfg.R_mass * cfg.T_bg * background_density(cfg, y)


def background_pot_temperature(cfg: WitchConfig, y):
    """θ_bg = T_bg ((T_bg R_gas ρ0)/P_bg)^(2/7), NumPy."""
    P_bg = background_pressure(cfg, y)
    return cfg.T_bg * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / P_bg) ** (2.0 / 7.0)


def background_entropy(cfg: WitchConfig, y):
    """A_bg = P_bg/ρ_bg^γ, NumPy (the full Hopkins scheme's build time)."""
    return background_pressure(cfg, y) / background_density(cfg, y) ** cfg.gamma


def background_density_t(cfg: WitchConfig, y: torch.Tensor) -> torch.Tensor:
    """Torch twin of ``background_density``, in y's dtype."""
    return cfg.rho0 * torch.exp(-y * cfg.g / (cfg.R_mass * cfg.T_bg))


def background_pressure_t(cfg: WitchConfig, y: torch.Tensor) -> torch.Tensor:
    return cfg.R_mass * cfg.T_bg * background_density_t(cfg, y)


def background_pot_temperature_t(cfg: WitchConfig, y: torch.Tensor) -> torch.Tensor:
    P_bg = background_pressure_t(cfg, y)
    return cfg.T_bg * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / P_bg) ** (2.0 / 7.0)


def background_entropy_t(cfg: WitchConfig, y: torch.Tensor) -> torch.Tensor:
    """Torch twin of ``background_entropy``."""
    return background_pressure_t(cfg, y) / background_density_t(cfg, y) ** cfg.gamma


def witch_profile(cfg: WitchConfig, x):
    """Mountain profile hₘa²/(x²+a²); 0 when disabled."""
    x = np.asarray(x, dtype=np.float64)
    if cfg.a == 0.0:
        return np.zeros_like(x)
    return cfg.h_m * cfg.a**2 / (x**2 + cfg.a**2)


# ------------------------------------------------------------- geometry

def make_witch_system(cfg: WitchConfig, fields: dict,
                      persistent: tuple = ()) -> ParticleSystem:
    """Domain + fence + mountain geometry and particle generation, with the
    hydrostatic isothermal initial state common to all schemes. ``fields``
    must include the scheme's per-particle variables."""
    grid = Grid(cfg.dr, "hexagonal")
    domain = Rectangle(-cfg.dom_length / 2.0, 0.0, cfg.dom_length / 2.0,
                       cfg.dom_height)
    fence = BoundaryLayer(domain, grid, cfg.bc_width)
    mountain = Specification(
        domain, lambda x: x[..., 1] <= witch_profile(cfg, x[..., 0]))

    sys = ParticleSystem(fields=fields, domain=domain + fence, h=cfg.h0,
                         dim=2, dtype=cfg.torch_dtype)
    sys.freeze_opts = {"layout": cfg.layout, "skin": cfg.skin}
    if persistent:
        # scheme-declared irreducible state: every other field is derived
        # after the rebuild before being read, so rescatters move only these
        sys.freeze_opts["persistent"] = tuple(persistent)
    if cfg.bucket_cap:
        sys.freeze_opts["cap"] = cfg.bucket_cap
    if cfg.lattice_cells:
        # exact hex-pitch cells. The 1e-6 DOWNWARD nudge puts lattice points
        # that sit exactly on a bin edge robustly ABOVE it, immune to f32
        # position roundoff; an upward nudge would drop every exact-edge
        # row/column into the previous bin
        a = (4.0 / 3.0) ** 0.25 * cfg.dr
        b = (3.0 / 4.0) ** 0.25 * cfg.dr
        sys.freeze_opts["cells"] = (2.0 * a * (1.0 - 1e-6),
                                    2.0 * b * (1.0 - 1e-6))
    imported: set = set()
    if cfg.init_vtp:
        from ..io import import_particles, read_vtp
        imported = set(read_vtp(cfg.init_vtp)[1])
        import_particles(sys, cfg.init_vtp)
    else:
        generate_particles(sys, grid, domain - mountain,
                           lambda xs: {"type": FLUID})
        generate_particles(sys, grid, fence, lambda xs: {"type": WALL})
        generate_particles(sys, grid, mountain, lambda xs: {"type": FLUID})

    # hydrostatic isothermal init common to all schemes; fields imported
    # from a frame are left as loaded
    for chunk in sys._chunks:
        y = chunk["x"][:, 1]
        if "h" in chunk and "h" not in imported:
            chunk["h"] = np.full_like(y, cfg.h0)
        rho_bg = background_density(cfg, y)
        for name, val in [
            ("rho_bg", rho_bg), ("rho", rho_bg),
            ("P_bg", background_pressure(cfg, y)),
            ("P", background_pressure(cfg, y)),
            ("theta_bg", background_pot_temperature(cfg, y)),
            ("theta", background_pot_temperature(cfg, y)),
            ("T_bg", np.full_like(y, cfg.T_bg)),
            ("T", np.full_like(y, cfg.T_bg)),
            ("m", rho_bg * cfg.dr**2),
        ]:
            if name in chunk and name not in imported:
                chunk[name] = val
    return sys


# ----------------------------------------------------------- diagnostics

def velocity_diagnostics(state):
    """(u_avg, u_max) over all active particles, as 0-d tensors."""
    v = torch.sqrt(torch.sum(state.fields["v"] ** 2, dim=-1))
    return masked_mean(v, state.active), masked_max(v, state.active)


def monaghan_viscosity(cfg: WitchConfig, p, q, r, h_ij=None, ker=None):
    """The Monaghan artificial-viscosity acceleration of a pair (α, β, ε
    form), for the flat layout's pair operator: −m_q·π_ij·rDW(h_ij, r)·x_pq
    for approaching pairs, else 0; h_ij defaults to the mean of the two
    smoothing lengths, ``ker`` = rDW(h_ij, r) to the 2-D Wendland kernel's
    (the 3-D scheme passes its own). Returns [..., d]."""
    x_pq = p.x - q.x
    dot_pq = torch.sum(x_pq * (p.v - q.v), dim=-1)
    if h_ij is None:
        h_ij = 0.5 * (p.h + q.h)
    if ker is None:
        ker = rDwendland2(h_ij, r)
    prho = torch.clamp(p.rho, min=cfg.rho_floor)
    qrho = torch.clamp(q.rho, min=cfg.rho_floor)
    c_i = torch.sqrt(torch.clamp(cfg.gamma * p.P / prho, min=0.0))
    c_j = torch.sqrt(torch.clamp(cfg.gamma * q.P / qrho, min=0.0))
    c_ij = 0.5 * (c_i + c_j)
    rho_ij = 0.5 * (prho + qrho)
    mu_ij = (h_ij * dot_pq) / (r * r + cfg.eps * h_ij * h_ij)
    pi_ij = (-cfg.alpha * c_ij * mu_ij + cfg.beta * mu_ij**2) / rho_ij
    visc = torch.where(dot_pq < 0.0, -q.m * pi_ij * ker, 0.0)
    return visc[..., None] * x_pq


def rayleigh_damping(cfg: WitchConfig, y: torch.Tensor) -> torch.Tensor:
    """Sponge acceleration above zₜ−zᵦ, in y's dtype. Faithful to the
    reference, including its z-independent magnitude (computed in double
    on the host; a float64 state keeps every digit of it)."""
    mag = -cfg.gamma_r * math.sin(
        math.pi / 2 * (1.0 - (cfg.z_t - cfg.z_b) / cfg.z_b)) ** 2
    return torch.where(y >= (cfg.z_t - cfg.z_b), y.new_tensor(mag), 0.0)
