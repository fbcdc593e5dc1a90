"""Legacy mountain-wave schemes: the terrain family.

Port of ``sph_mountain_waves_tpu/models/legacy_witch.py``. Four schemes in two
families, each with a static and a flow (open-boundary) variant:

* isothermal: EOS P = ρRT at fixed T; the static variant also evolves a
  per-particle smoothing length (Dh = −(h/2ρ)·Dρ), the flow variant keeps
  the global h0;
* adiabatic: summation density (FLUID-gated), the entropy S grows by viscous
  production, s = S·ρ/m, T from (ρ, s), P = RρT.

The flow variants add the INFLOW/OUTFLOW/WALL/MOUNTAIN typed open boundary
on a square lattice: a constant U_max wind enters from the left and the
inflow column recycles (an INFLOW particle crossing the domain edge becomes
FLUID and a fresh INFLOW particle spawns one bc_width upstream,
``add_new_particles``). The reference's corrections are kept as options with
its defaults (``true_rayleigh``, ``consistent_entropy``, ``outflow_buffer``,
``av_alpha``, ``lj_floor``).

Two pair paths, as in the reference. On the flat layout (the config's
default; float32 or float64) the step's pair sums are the reference's pair
functions summed by ``ops/apply.py::apply_binary`` on the state's device, and
the flow variants' spawns take the spare flat rows (the free pool; every
flat rebuild re-sorts every row). With ``use_pallas`` (which selects the
bucket layout, as in the reference; float32) they are the sweeps of
``ops/pair_sweeps.py``, called through their wrappers (CUDA kernels on CUDA
tensors, plain twins on CPU tensors): ``legacy_mass_pass`` and
``legacy_force_pass`` (isothermal flow, the terrain baseline),
``iso_static_mass_pass`` and ``iso_static_force_pass`` (isothermal static),
``adia_density_pass`` and the fused ``adia_entropy_force_pass``
(adiabatic). A CUDA bucket state with ``use_pallas`` off, and a float64
bucket state, are refused (``check_sweep_route``).
``run`` writes the velocities figure; ``live_plot=True`` prints the
sparklines every frame.
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache, partial

import numpy as np
import torch

from ..geometry import BoundaryLayer, Rectangle, Specification
from ..grids import Grid
from ..kernels import rDwendland2, wendland2
from ..ops.apply import apply_binary, apply_unary
from ..ops.pair_sweeps import (
    adia_density_pass, adia_entropy_force_pass, iso_static_force_pass,
    iso_static_mass_pass, legacy_force_pass, legacy_mass_pass,
)
from ..structs import ParticleState, ParticleSystem, generate_particles
from .common import check_sweep_route
from .witch_common import witch_profile

FLUID = 0.0
INFLOW = 1.0
OUTFLOW = 2.0
WALL = 3.0
MOUNTAIN = 4.0


@dataclasses.dataclass(frozen=True)
class LegacyConfig:
    """The legacy schemes' constants and options, with the JAX package's
    defaults (see its LegacyConfig for each option's rationale)."""
    dom_height: float = 26e3
    dom_length: float = 400e3
    n_rows: int = 50
    h_m: float = 100.0
    a: float = 10e3
    bc_rows: int = 6
    rho0: float = 1.393
    mu: float = 15.98e-6
    U_max: float = 20.0          # flow variants only
    N_bv: float = float(np.sqrt(0.0196))
    g: float = 9.81
    R_mass: float = 287.05
    R_gas: float = 8.314
    T0: float = 250.0
    z_b: float = 12e3
    t_end: float = 100.0
    n_frames: int = 100
    flow: bool = False
    adiabatic: bool = False
    max_spawn: int = 256         # spawns per step at most; 0: no recycling
    dtype: str = "float32"
    # write <out_path>/checkpoint.npz every this many frames (0: off) and on
    # the last; resume: path of a checkpoint to continue from, bitwise
    checkpoint_every: int = 0
    resume: str = ""
    # boot from a saved ParaView frame instead of the lattice
    init_vtp: str = ""
    # terminal sparklines of the run's observables every frame
    live_plot: bool = False
    # the pair sweeps launch their CUDA kernels on CUDA tensors (CPU tensors
    # take the plain twins either way); a CUDA bucket state with False is
    # refused. True also selects the bucket layout, as in the reference
    use_pallas: bool = False
    fast_math: bool = False
    # engine layout: "flat" (float32 or float64: apply_binary's pair sums)
    # or "bucket" (float32: the sweeps)
    layout: str = "flat"
    skin: float = 0.15
    # cells of exactly two lattice pitches (square lattice: 2·dr both axes;
    # hexagonal: 2a × 2b), nudged 1e-6 downward
    lattice_cells: bool = False
    # bucket-capacity override (None: measured occupancy + headroom)
    bucket_cap: int | None = None
    lazy_diagnostics: bool = False
    # False: the reference's sponge, a constant downward body force above
    # z_t − z_b. True: Rayleigh damping −γ(z)·(v − v_ref) with a sin² ramp
    true_rayleigh: bool = False
    # γ_max of the corrected sponge (s⁻¹; None: 10·N_bv)
    sponge_gamma: float | None = None
    # width (m) of the OUTFLOW buffer at the right edge (0: the reference's
    # open edge)
    outflow_buffer: float = 0.0
    # True: the adiabatic entropy init without the reference's stray γ, so
    # that T(ρ, s) = T0 at start
    consistent_entropy: bool = False
    # Monaghan artificial viscosity α on approaching FLUID–FLUID pairs
    av_alpha: float = 0.0
    # flow variants: no terrain particles; a Lennard-Jones-style repulsion
    # from the analytic surface y = h(x) instead (r0 = dr, D = R·T0/dr)
    lj_floor: bool = False
    lj_r0: float | None = None
    lj_D: float | None = None

    @property
    def dr(self) -> float:
        return self.dom_height / self.n_rows

    @property
    def h0(self) -> float:
        return 1.8 * self.dr

    @property
    def bc_width(self) -> float:
        return self.bc_rows * self.dr

    @property
    def c(self) -> float:
        return float(np.sqrt(65e3 * 1.4 / self.rho0))

    @property
    def cp(self) -> float:
        return 7 * (self.R_mass if self.adiabatic else self.R_gas) / 2

    @property
    def cv(self) -> float:
        return self.cp - self.R_mass

    @property
    def gamma(self) -> float:
        return self.cp / self.cv

    @property
    def gamma_r(self) -> float:
        return 10 * self.N_bv

    @property
    def c_av(self) -> float:
        """Signal speed of the ``av_alpha`` viscosity: the EOS sound speed at
        T0 (isothermal c² = R·T0, adiabatic c² = γ·R·T0)."""
        fac = self.gamma if self.adiabatic else 1.0
        return float(np.sqrt(fac * self.R_mass * self.T0))

    @property
    def z_t(self) -> float:
        return self.dom_height

    @property
    def dt(self) -> float:
        return 0.01 * self.h0 / self.c

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32

    @property
    def witch(self):
        """A WitchConfig of the same terrain (for ``witch_profile`` and the
        Colagrossi packing)."""
        from .witch_common import WitchConfig
        return WitchConfig(dom_height=self.dom_height,
                           dom_length=self.dom_length, n_rows=self.n_rows,
                           h_m=self.h_m, a=self.a, rho0=self.rho0,
                           T_bg=self.T0, dtype=self.dtype)


FIELDS = {"x": 2, "m": 0, "v": 2, "Dv": 2, "h": 0, "Dh": 0, "rho": 0,
          "Drho": 0, "P": 0, "theta": 0, "S": 0, "s": 0, "T": 0,
          "gGamma": 2, "type": 0}
EXPORT_VARS = ("v", "P", "theta", "rho", "type")


def make_system(cfg: LegacyConfig) -> ParticleSystem:
    """The four geometries (hexagonal lattice static, square lattice flow;
    MOUNTAIN body or the ``lj_floor``), the fence split into INFLOW and WALL
    for the flow variants, the hydrostatic init, and the engine options in
    ``freeze_opts`` (the skin only on the bucket layout, as the reference
    sets it)."""
    grid = Grid(cfg.dr, "hexagonal" if not cfg.flow else "square")
    domain = Rectangle(-cfg.dom_length / 2, 0.0, cfg.dom_length / 2,
                       cfg.dom_height)
    fence = BoundaryLayer(domain, grid, cfg.bc_width)
    mountain = Specification(
        domain, lambda x: x[..., 1] <= witch_profile(cfg.witch, x[..., 0]))

    fields = dict(FIELDS)
    if cfg.flow:
        # slot-bound spawn-drop accumulator: "_"-prefixed fields stay in
        # place through every rescatter; read by a global sum only
        fields["_spawn_drops"] = 0
    sys = ParticleSystem(fields=fields, domain=domain + fence, h=cfg.h0,
                         dim=2, dtype=cfg.torch_dtype)
    imported: set = set()
    if cfg.init_vtp:
        from ..io import import_particles, read_vtp
        imported = set(read_vtp(cfg.init_vtp)[1])
        import_particles(sys, cfg.init_vtp)
    else:
        gen = partial(generate_particles, sys, grid)
        if cfg.lj_floor:
            if not cfg.flow:
                raise ValueError("lj_floor supports the flow variants")
            clear = 0.75 * cfg.dr
            fluid_region = Specification(
                domain, lambda x: x[..., 1]
                > witch_profile(cfg.witch, x[..., 0]) + clear)
            gen(fluid_region, lambda xs: {"type": FLUID})
        else:
            gen(domain - mountain, lambda xs: {"type": FLUID})
            gen(mountain, lambda xs: {"type": MOUNTAIN})
        if cfg.flow:
            # fence split: ground and sky walls, the wind's inflow column
            ground = Specification(fence, lambda x: x[..., 1] < 0)
            sky = Specification(fence, lambda x: x[..., 1] > cfg.dom_height)
            wind = Specification(
                fence, lambda x: (x[..., 0] <= -cfg.dom_length / 2)
                & (x[..., 1] >= 0) & (x[..., 1] <= cfg.dom_height))
            if cfg.lj_floor:
                # inflow rows keep the same clearance from the surface
                clear = 0.75 * cfg.dr
                wind = Specification(
                    wind, lambda x: x[..., 1]
                    > witch_profile(cfg.witch, x[..., 0]) + clear)
                gen(wind, lambda xs: {"type": INFLOW})
                gen(sky, lambda xs: {"type": WALL})
            else:
                gen(wind, lambda xs: {"type": INFLOW})
                gen(ground + sky, lambda xs: {"type": WALL})
        else:
            gen(fence, lambda xs: {"type": WALL})

    for chunk in sys._chunks:
        y = chunk["x"][:, 1]
        rho = cfg.rho0 * np.exp(-y * cfg.g / (cfg.R_mass * cfg.T0))
        upd = {"h": np.full_like(y, cfg.h0), "rho": rho,
               "m": rho * cfg.dr**2,
               "P": rho * cfg.T0 * cfg.R_mass,
               "T": np.full_like(y, cfg.T0)}
        upd["theta"] = cfg.T0 * ((cfg.T0 * cfg.R_mass * cfg.rho0)
                                 / upd["P"]) ** (cfg.R_gas / cfg.cp)
        if cfg.adiabatic:
            # the reference's init carries a stray γ (consistent_entropy)
            gfac = 1.0 if cfg.consistent_entropy else cfg.gamma
            upd["S"] = upd["m"] * cfg.cv * np.log(
                (cfg.cv * cfg.T0 * (cfg.gamma - 1))
                / (gfac * rho ** (cfg.gamma - 1)))
        if cfg.flow and "v" not in imported:
            mob = (chunk["type"] == FLUID) | (chunk["type"] == INFLOW)
            upd["v"] = np.where(mob[:, None], [cfg.U_max, 0.0], 0.0)
        for name, val in upd.items():
            if name not in imported:
                chunk[name] = val
    if cfg.layout == "bucket" or cfg.use_pallas:
        sys.freeze_opts["layout"] = "bucket"
        sys.freeze_opts["skin"] = cfg.skin
    else:
        sys.freeze_opts["layout"] = cfg.layout
    # the irreducible per-row state: everything else is zero at rebuild time
    # or recomputed from these before it is read
    pers = ["x", "v", "h", "m", "rho", "type", "T"]
    if cfg.adiabatic:
        pers += ["S", "P", "theta"]
    elif not cfg.flow:
        pers += ["theta"]
    sys.freeze_opts["persistent"] = tuple(pers)
    if cfg.bucket_cap:
        sys.freeze_opts["cap"] = cfg.bucket_cap
    if cfg.lattice_cells:
        if cfg.flow:  # square lattice: pitch dr on both axes
            c = 2.0 * cfg.dr * (1.0 - 1e-6)
            sys.freeze_opts["cells"] = (c, c)
        else:  # hexagonal lattice
            a = (4.0 / 3.0) ** 0.25 * cfg.dr
            b = (3.0 / 4.0) ** 0.25 * cfg.dr
            sys.freeze_opts["cells"] = (2.0 * a * (1.0 - 1e-6),
                                        2.0 * b * (1.0 - 1e-6))
    if cfg.flow:
        # the free-pool spawn writes arbitrary free slots (rows), which only
        # the sort rescatter (on flat: the sort of every rebuild) re-places;
        # run_system selects the slot-targeted spawn and the stencil
        # rescatter on the bucket layout. The spare rows are the spawn pool
        sys.freeze_opts["rescatter_mode"] = "sort"
        sys.freeze_opts["capacity"] = int(sys.n_built * 1.3)
    return sys


# ------------------------------------------------------------- LJ floor

def _lj_params(cfg: LegacyConfig):
    r0 = cfg.lj_r0 if cfg.lj_r0 is not None else cfg.dr
    D = cfg.lj_D if cfg.lj_D is not None else cfg.R_mass * cfg.T0 / cfg.dr
    return r0, D


def _floor_gap(cfg: LegacyConfig, x: torch.Tensor):
    """(d, n̂): the normal gap to the analytic witch surface y = h(x) (the
    vertical gap times cos θ) and the unit surface normal."""
    xs, ys = x[..., 0], x[..., 1]
    if cfg.a == 0.0 or cfg.h_m == 0.0:
        hh = torch.zeros_like(xs)
        hp = torch.zeros_like(xs)
    else:
        den = xs * xs + cfg.a**2
        hh = torch.full_like(den, cfg.h_m * cfg.a**2) / den
        hp = -2.0 * cfg.h_m * cfg.a**2 * xs / (den * den)
    inv = 1.0 / torch.sqrt(1.0 + hp * hp)
    d = (ys - hh) * inv
    n_hat = torch.stack([-hp * inv, inv], dim=-1)
    return d, n_hat


def _lj_floor_acc(cfg: LegacyConfig, x: torch.Tensor, v=None):
    """Repulsion a = D·((r0/d)⁴ − (r0/d)²)·n̂ for d < r0, the gap clamped at
    0.05·r0 and the magnitude capped at 20·D; with ``v``, the normal
    velocity damped by −4√(D/r0)·(v·n̂)·n̂ within the contact range."""
    r0, D = _lj_params(cfg)
    d, n_hat = _floor_gap(cfg, x)
    dc = torch.clamp(d, min=0.05 * r0)
    s2 = (torch.full_like(dc, r0) / dc) ** 2
    mag = torch.clamp(D * torch.clamp(s2 * s2 - s2, min=0.0), max=20.0 * D)
    acc = mag[..., None] * n_hat
    if v is not None:
        gam = 4.0 * float(np.sqrt(D / r0))
        vn = torch.sum(v * n_hat, dim=-1)
        contact = (d < r0).to(v.dtype)
        acc = acc - (gam * contact * vn)[..., None] * n_hat
    return acc


@lru_cache(maxsize=None)
def _wall_fraction_table(n: int = 96, M: int = 600):
    """c(d/h): the fraction of the 2-D Wendland kernel's integral lying in
    the half-plane a normal distance d above the support centre (NumPy,
    cached)."""
    ds = np.linspace(0.0, 1.0, n)
    xs = np.linspace(-1.0, 1.0, M)
    X, Y = np.meshgrid(xs, xs)
    R = np.sqrt(X * X + Y * Y)
    t = np.maximum(1.0 - R, 0.0)
    W = t**4 * (1.0 + 4.0 * R)
    tot = W.sum()
    cs = np.array([(W * (Y > -d)).sum() / tot for d in ds])
    return ds, cs


def _wall_fraction(cfg: LegacyConfig, x: torch.Tensor) -> torch.Tensor:
    """c(d/h0) per row (1 beyond the kernel's reach of the surface), by
    linear interpolation in the uniform table."""
    _, cs_np = _wall_fraction_table()
    cs = torch.as_tensor(cs_np, dtype=x.dtype, device=x.device)
    n = cs.shape[0]
    d, _ = _floor_gap(cfg, x)
    u = torch.clamp(d / cfg.h0, 0.0, 1.0) * (n - 1)
    i = torch.clamp(torch.floor(u).to(torch.int64), 0, n - 2)
    frac = u - i.to(u.dtype)
    return cs[i] * (1.0 - frac) + cs[i + 1] * frac


def lj_floor_drag(cfg: LegacyConfig):
    """Surface drag/lift under ``lj_floor``: the reaction −Σ m·a_LJ of the
    fluid on the analytic surface (the conservative part only; the contact
    damping is left out), the same sign convention as ``mountain_force``."""
    def diag(state: ParticleState) -> dict:
        f = state.fields
        w = (state.active & (f["type"] == FLUID)).to(f["m"].dtype)
        a = _lj_floor_acc(cfg, f["x"])
        F = -torch.sum((w * f["m"])[:, None] * a, dim=0)
        return {"drag": F[0], "lift": F[1]}
    return diag


# ---------------------------------------------------------- inflow spawn

def spawn_sources(cfg: LegacyConfig, state: ParticleState) -> torch.Tensor:
    """[slots] bool: the active INFLOW rows that crossed the domain's left
    edge and convert to FLUID this step."""
    f = state.fields
    return (state.active & (f["type"] == INFLOW)
            & (f["x"][:, 0] >= -cfg.dom_length / 2))


def _slot_targeted(engine) -> bool:
    return (engine.layout == "bucket"
            and engine.effective_rescatter_mode == "stencil")


def add_new_particles(cfg: LegacyConfig, engine, state: ParticleState,
                      conv: torch.Tensor | None = None) -> ParticleState:
    """Inflow recycling: every INFLOW row past the left edge (``conv``,
    default ``spawn_sources``) becomes FLUID, and for the first
    ``cfg.max_spawn`` of them (in slot order) a fresh INFLOW row spawns one
    bc_width upstream with the background state.

    The event fires about once per dr/U_max of simulated time; the reference
    takes it under ``lax.cond``, here it is a host branch on ``conv.any()``
    (on the bucket layout the terrain step reads that flag with the
    rebuild's drift flag, one sync). Placement, as the reference's:

    * slot-targeted (bucket layout, the stencil rescatter): each spawn goes
      to a free slot of its home cell, binned with ``_screen_and_key``'s f32
      arithmetic, earlier candidates to earlier free ranks, and ``_xref`` is
      stamped with the new position, so the stencil rescatter's one-cell
      locality holds and the event forces no rescatter;
    * free pool (the sort rescatter, and the flat layout): the first free
      slots (flat: the first free rows in row order), ``_xref`` left stale
      (flat: there is none), so the next rebuild re-places the new rows by
      sort.

    Spawns with no free slot (or no free rank in their home cell) are
    dropped and counted into ``_spawn_drops[0]``."""
    f = state.fields
    if conv is None:
        conv = spawn_sources(cfg, state)
        if not bool(conv.any()):
            return state
    n = state.capacity
    k = cfg.max_spawn
    dev = conv.device
    x = f["x"]
    active = state.active

    def first_k(mask):
        # slot indices of the first k True entries; n pads the rest
        idx = torch.nonzero(mask).flatten()[:k].to(torch.int64)
        return torch.cat([idx, torch.full((k - idx.numel(),), n,
                                          dtype=torch.int64, device=dev)])

    new_type = torch.where(conv, FLUID, f["type"])
    src_raw = first_k(conv)
    src = torch.clamp(src_raw, max=n - 1)
    src_ok = (src_raw < n) & conv[src]
    x_new = x[src] - torch.tensor([cfg.bc_width, 0.0], dtype=x.dtype,
                                  device=dev)
    if _slot_targeted(engine):
        # home-cell binning, exactly as _screen_and_key bins
        C, cap = engine.num_cells, engine.cap
        L = torch.tensor(engine.cell_size, dtype=x.dtype, device=dev)
        phase = torch.tensor(engine.phase, dtype=torch.int32, device=dev)
        lims = torch.tensor(engine.lims, dtype=torch.int32, device=dev)
        cell = torch.floor(x_new / L).to(torch.int32) - phase
        cell = torch.minimum(torch.clamp(cell, min=0), lims - 1)
        # invalid candidates bin to the trash column C: they use free ranks
        # only there and are never written
        c = torch.where(src_ok, engine.flat_key(cell),
                        torch.full_like(cell[:, 0], C)).to(torch.int64)
        free_cols = (~active).reshape(cap, C + 1)[:, c]        # [cap, k]
        # rank among same-cell spawns (earlier candidate, earlier free rank)
        ar = torch.arange(k, device=dev)
        order = ((c[None, :] == c[:, None])
                 & (ar[None, :] < ar[:, None])).sum(dim=1)
        fcount = torch.cumsum(free_cols.to(torch.int32), dim=0)
        sel = free_cols & (fcount == (order + 1)[None, :])
        ok = src_ok & sel.any(dim=0)
        tgt = torch.argmax(sel.to(torch.int32), dim=0) * (C + 1) + c
    else:
        free = ~active
        tgt_raw = first_k(free)
        tgt = torch.clamp(tgt_raw, max=n - 1)
        ok = src_ok & (tgt_raw < n) & free[tgt]
    idx = tgt[ok]
    x_ok = x_new[ok]
    y = x_ok[:, 1]
    rho = cfg.rho0 * torch.exp(-y * cfg.g / (cfg.R_mass * cfg.T0))

    def put(arr, val):
        out = arr.clone()
        out[idx] = val
        return out

    fields = dict(f)
    fields["type"] = put(new_type, INFLOW)
    fields["x"] = put(x, x_ok)
    fields["v"] = put(f["v"], torch.tensor([cfg.U_max, 0.0],
                                           dtype=f["v"].dtype, device=dev))
    fields["rho"] = put(f["rho"], rho)
    fields["m"] = put(f["m"], rho * cfg.dr**2)
    fields["P"] = put(f["P"], rho * cfg.T0 * cfg.R_mass)
    fields["h"] = put(f["h"], cfg.h0)
    for name in ("Dv", "Dh", "Drho", "S", "s", "gGamma"):
        fields[name] = put(f[name], 0.0)
    fields["T"] = put(f["T"], cfg.T0)
    if cfg.adiabatic:
        gfac = 1.0 if cfg.consistent_entropy else cfg.gamma
        S = (rho * cfg.dr**2) * cfg.cv * torch.log(
            torch.full_like(rho, cfg.cv * cfg.T0 * (cfg.gamma - 1))
            / (gfac * rho ** (cfg.gamma - 1)))
        fields["S"] = put(fields["S"], S)
    if _slot_targeted(engine) and "_xref" in f:
        # placement is already slot-correct: stamp the rescatter reference
        fields["_xref"] = put(f["_xref"], x_ok)
    drops = f["_spawn_drops"].clone()
    drops[0] += (src_ok & ~ok).sum().to(drops.dtype)
    fields["_spawn_drops"] = drops
    return ParticleState(fields=fields, active=put(active, True))


# ------------------------------------------------------------------ step

def make_step(cfg: LegacyConfig, engine):
    """One Verlet step of the configured variant: kick, drift, (flow:
    recycling, inflow speed, outflow buffer), rebuild, the variant's
    density/continuity and EOS, the force, kick. The pair sums are the
    sweeps on the bucket layout and the reference's pair functions through
    ``apply_binary`` on the flat layout."""
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt, h0 = cfg.dt, cfg.h0
    # the reference's sponge: γᵣ·sin²(π/2·(1 − (zₜ − zᵦ)/zᵦ)), a constant
    # (its z is typo'd as zᵦ), in double and rounded once to the state dtype
    sponge = cfg.gamma_r * math.sin(
        math.pi / 2 * (1 - (cfg.z_t - cfg.z_b) / cfg.z_b)) ** 2

    def damping(y):
        # built in y's dtype: a where of two Python floats is float32
        return torch.where(y >= cfg.z_t - cfg.z_b, y.new_tensor(sponge),
                           y.new_zeros(()))

    def damping_gamma(y):
        # corrected Rayleigh coefficient γ(z): sin² ramp from the sponge
        # base (0) to the domain top (γ_max)
        gmax = cfg.gamma_r if cfg.sponge_gamma is None else cfg.sponge_gamma
        r = torch.clamp(1.0 - (cfg.z_t - y) / cfg.z_b, 0.0, 1.0)
        return gmax * torch.sin(math.pi / 2 * r) ** 2

    # --- isothermal closures
    def iso_balance_of_mass(p, q, r):
        # flat layout: the continuity, global h0 (flow) or the per-particle h
        # with p.rho·Σ (m/ρ)_q (static)
        if cfg.flow:
            ker = q.m * rDwendland2(h0, r)
            return {"Drho": ker * torch.sum((p.x - q.x) * (p.v - q.v),
                                            dim=-1)}
        ker = (q.m / torch.clamp(q.rho, min=1e-30)) * rDwendland2(p.h, r)
        return {"Drho": p.rho * ker
                * torch.sum((p.x - q.x) * (p.v - q.v), dim=-1)}

    def iso_balance_of_smoothing(u):
        return {"Dh": -0.5 * (u.h / torch.clamp(u.rho, min=1e-30)) * u.Drho}

    def iso_find_pressure(u):
        rho = u.rho + u.Drho * dt
        upd = {"rho": rho, "Drho": torch.zeros_like(u.Drho),
               "P": rho * cfg.R_mass * cfg.T0}
        if not cfg.flow:
            upd["h"] = u.h + u.Dh * dt
            upd["Dh"] = torch.zeros_like(u.Dh)
        return upd

    def find_pot_temp(u):
        # P floored: empty slots carry P = 0
        P = torch.clamp(u.P, min=1e-6)
        return {"theta": u.T * ((u.T * cfg.R_gas * cfg.rho0) / P)
                ** (cfg.R_gas / cfg.cp)}

    # --- adiabatic closures
    def adia_find_density(p, q, r):
        # flat layout: the both-FLUID summation density (with the self pair);
        # under the OUTFLOW buffer FLUID and OUTFLOW rows sum every neighbour
        if cfg.outflow_buffer:
            ok = (p.type == FLUID) | (p.type == OUTFLOW)
        else:
            ok = (p.type == FLUID) & (q.type == FLUID)
        return {"rho": torch.where(ok, q.m * wendland2(h0, r), 0.0)}

    def _eos_rows(u):
        # rows whose density is summed each step and whose thermodynamic
        # state follows: FLUID, and OUTFLOW under the corrected open boundary
        fl = u.type == FLUID
        if cfg.flow and cfg.outflow_buffer:
            fl = fl | (u.type == OUTFLOW)
        return fl

    def adia_find_s(u):
        return {"s": torch.where(_eos_rows(u), u.S * u.rho
                                 / torch.clamp(u.m, min=1e-30), u.s)}

    def adia_find_pressure(u):
        fl = _eos_rows(u)
        T = (u.rho ** (cfg.gamma - 1.0)) * torch.exp(
            u.s / torch.clamp(u.rho, min=1e-30) / cfg.cv) / (
                cfg.cv * (cfg.gamma - 1.0))
        T = torch.where(fl, T, u.T)
        return {"T": T, "P": torch.where(fl, cfg.R_mass * u.rho * T, u.P)}

    def adia_entropy_production(p, q, r):
        both = (p.type == FLUID) & (q.type == FLUID)
        ker = rDwendland2(h0, r)
        dux = torch.sum((p.v - q.v) * (p.x - q.x), dim=-1)
        # floors: empty rows carry T = ρ = 0
        denom = (torch.clamp(p.T, min=1e-30) * torch.clamp(p.rho, min=1e-30)
                 * torch.clamp(q.rho, min=1e-30))
        dS = (-4.0 * p.m * q.m * ker * cfg.mu / denom
              * dux**2 / (r * r + 0.01 * h0 * h0) * dt)
        return {"S": torch.where(both, dS, 0.0)}

    adaptive_h = not cfg.flow and not cfg.adiabatic

    def internal_force(p, q, r):
        # flat layout: the symmetric P/ρ² and viscous pair force (adaptive h
        # for the isothermal static variant), with the FLUID–FLUID-gated
        # Monaghan term on approaching pairs when av_alpha > 0
        ker = q.m * rDwendland2(p.h if adaptive_h else h0, r)
        x_pq = p.x - q.x
        rho_p = torch.clamp(p.rho, min=1e-30)
        rho_q = torch.clamp(q.rho, min=1e-30)
        du = -(ker * (p.P / rho_p**2 + q.P / rho_q**2))[..., None] * x_pq
        denom = (r * r + 0.0025 * (p.h + q.h) ** 2 if adaptive_h
                 else r * r + 0.01 * h0 * h0)
        dot = torch.sum((p.v - q.v) * x_pq, dim=-1)
        s = 8.0 * ker * cfg.mu / (rho_p * rho_q) * dot / denom
        if cfg.av_alpha:
            h_av = 0.5 * (p.h + q.h) if adaptive_h else h0
            mu_av = h_av * dot / denom
            pi = ((-cfg.av_alpha * cfg.c_av * mu_av
                   + 2.0 * cfg.av_alpha * mu_av**2)
                  * 0.5 * (1.0 / rho_p + 1.0 / rho_q))
            both_fl = (p.type == FLUID) & (q.type == FLUID)
            s = s - torch.where(both_fl & (dot < 0.0), ker * pi, 0.0)
        return {"Dv": du + s[..., None] * x_pq}

    def set_inflow_speed(u):
        pinned = u.type == INFLOW
        if cfg.outflow_buffer:
            pinned = pinned | (u.type == OUTFLOW)
        wind = torch.tensor([cfg.U_max, 0.0], dtype=u.v.dtype,
                            device=u.v.device)
        return {"v": torch.where(pinned[:, None], wind, u.v)}

    def move(u):
        mob = u.type == FLUID
        if cfg.flow:
            mob = mob | (u.type == INFLOW)
            if cfg.outflow_buffer:
                mob = mob | (u.type == OUTFLOW)
        upd = {"x": torch.where(mob[:, None], u.x + dt * u.v, u.x),
               "Dv": torch.zeros_like(u.Dv)}
        if cfg.adiabatic:  # the summed density restarts from 0
            reset = u.type == FLUID
            if cfg.flow and cfg.outflow_buffer:
                reset = reset | (u.type == OUTFLOW)
            upd["rho"] = torch.where(reset, 0.0, u.rho)
        return upd

    def to_outflow(u):
        # FLUID entering the last outflow_buffer of the domain freezes into
        # OUTFLOW: advected, a neighbour, skipped by the force
        x_out = cfg.dom_length / 2 - cfg.outflow_buffer
        conv = (u.type == FLUID) & (u.x[:, 0] >= x_out)
        return {"type": torch.where(conv, OUTFLOW, u.type)}

    def accelerate(u):
        fl = (u.type == FLUID)[:, None]
        if cfg.true_rayleigh:
            gam = damping_gamma(u.x[:, 1])
            vx_ref = cfg.U_max if cfg.flow else 0.0
            acc = torch.stack(
                [u.Dv[:, 0] - gam * (u.v[:, 0] - vx_ref),
                 u.Dv[:, 1] - cfg.g - gam * u.v[:, 1]], dim=-1)
        else:
            acc = torch.stack([u.Dv[:, 0],
                               u.Dv[:, 1] - cfg.g - damping(u.x[:, 1])],
                              dim=-1)
        if cfg.lj_floor:
            acc = acc + _lj_floor_acc(cfg, u.x, u.v)
        return {"v": torch.where(fl, u.v + 0.5 * dt * acc, u.v)}

    def complete_wall_density(u):
        # lj_floor: add the background image mass ρ_bg(y)·(1 − c(d/h)) that
        # the particle-free floor leaves out of the summed density
        c = _wall_fraction(cfg, u.x)
        rho_bg = cfg.rho0 * torch.exp(
            -u.x[:, 1] * cfg.g / (cfg.R_mass * cfg.T0))
        return {"rho": torch.where(u.type == FLUID, u.rho + rho_bg * (1.0 - c),
                                   u.rho)}

    slot_targeted = _slot_targeted(engine)
    sweeps = engine.layout == "bucket"

    def spawn(state):
        # the bucket layout reads the spawn flag and the rebuild's drift flag
        # in one host read: recycling changes no position of an active row
        # and a slot-targeted spawn stamps its _xref, so the drift flag holds
        # after it; a pool spawn leaves _xref stale. The flat rebuild reads
        # no drift flag
        conv = spawn_sources(cfg, state)
        if not sweeps:
            fired, need = bool(conv.any()), None
        else:
            fired, need = torch.stack(
                [conv.any(), engine.needs_rescatter(state)]).tolist()
        if fired:
            state = add_new_particles(cfg, engine, state, conv)
            if not slot_targeted:
                need = None
        return state, need

    def density(state, nbrs):
        # the adiabatic summation density or the isothermal continuity:
        # the reference's pair function on flat, its sweep on bucket
        if not sweeps:
            if cfg.adiabatic:
                return apply_binary(engine, state, nbrs, adia_find_density,
                                    self_interaction=True)
            return apply_binary(engine, state, nbrs, iso_balance_of_mass)
        f = state.fields
        act = state.active
        if cfg.adiabatic:
            fl = f["type"] == FLUID
            if cfg.flow and cfg.outflow_buffer:
                fl = fl | (f["type"] == OUTFLOW)
            return state.replace(rho=torch.where(
                act & fl, f["rho"] + adia_density_pass(engine, state, cfg),
                f["rho"]))
        if cfg.flow:
            drho = legacy_mass_pass(engine, state, cfg)
        else:  # Drho = ρ_p · Σ (m/ρ)_q·rDW(h_p)·(x·v)
            drho = f["rho"] * iso_static_mass_pass(engine, state, cfg)
        return state.replace(Drho=torch.where(act, f["Drho"] + drho, 0.0))

    def eos(state):
        if cfg.adiabatic:
            if cfg.lj_floor:
                state = apply_unary(state, complete_wall_density)
            state = apply_unary(state, adia_find_s)
            return apply_unary(state, adia_find_pressure)
        if not cfg.flow:
            state = apply_unary(state, iso_balance_of_smoothing)
        state = apply_unary(state, iso_find_pressure)
        if cfg.flow:
            state = apply_unary(state, find_pot_temp)
        return state

    def force(state, nbrs):
        # the force (adiabatic: after the entropy production; the bucket
        # layout fuses the two in one sweep)
        if not sweeps:
            if cfg.adiabatic:
                state = apply_binary(engine, state, nbrs,
                                     adia_entropy_production)
            return apply_binary(engine, state, nbrs, internal_force)
        act = state.active
        if cfg.adiabatic:
            dS, *dv = adia_entropy_force_pass(engine, state, cfg)
            state = state.replace(S=torch.where(act, state.fields["S"] + dS,
                                                0.0))
        else:
            sweep = legacy_force_pass if cfg.flow else iso_static_force_pass
            dv = sweep(engine, state, cfg)
        return state.replace(Dv=torch.where(
            act[:, None], state.fields["Dv"] + torch.stack(dv, dim=-1), 0.0))

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state, engine)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        need = None
        if cfg.flow:
            if cfg.max_spawn:
                state, need = spawn(state)
            state = apply_unary(state, set_inflow_speed)
            if cfg.outflow_buffer:
                state = apply_unary(state, to_outflow)
        state, nbrs = engine.rebuild(state, need=need)
        state = force(eos(density(state, nbrs)), nbrs)
        return apply_unary(state, accelerate)

    return step


def make_finalize(cfg: LegacyConfig):
    """The legacy schemes compute their diagnostics every step: no
    finalize."""
    return None


# ------------------------------------------------------------ observables

def mountain_force(state: ParticleState) -> dict:
    """Net SPH force of the air on the terrain, Σ m·Dv over MOUNTAIN rows:
    {"drag": F_x, "lift": F_y} (N per metre of span). Gravity and the
    sponge never enter Dv, so F_x is the mountain-wave drag."""
    f = state.fields
    w = (state.active & (f["type"] == MOUNTAIN)).to(f["Dv"].dtype)
    F = torch.sum((w * f["m"])[:, None] * f["Dv"], dim=0)
    return {"drag": F[0], "lift": F[1]}


def inflow_reservoir(state: ParticleState) -> dict:
    """The INFLOW row count (recycling conserves it: a falling count means
    lost spawns) and, where the state carries it, the cumulative
    ``spawn_drops`` counter."""
    f = state.fields
    out = {"n_inflow": torch.sum(state.active & (f["type"] == INFLOW))}
    if "_spawn_drops" in f:
        out["spawn_drops"] = torch.sum(f["_spawn_drops"]).to(torch.int32)
    return out


def _band(cfg, state, z0, dz, x_window):
    f = state.fields
    y = f["x"][:, 1]
    sel = (state.active & (f["type"] == FLUID)
           & (y >= z0 - dz / 2) & (y < z0 + dz / 2))
    if x_window is not None:
        sel = sel & (torch.abs(f["x"][:, 0]) <= x_window)
    return sel


def wave_momentum_flux(cfg: LegacyConfig, z0: float, dz: float,
                       tag: str = "wave_flux", x_window: float | None = None):
    """Per-frame D(z₀) = −Σ m·u′·w / dz over FLUID rows in the band
    |z − z₀| < dz/2 (and |x| ≤ ``x_window``): the vertical flux of
    horizontal momentum, u′ = u − U_max."""
    def diag(state: ParticleState) -> dict:
        f = state.fields
        sel = _band(cfg, state, z0, dz, x_window)
        up = f["v"][:, 0] - cfg.U_max
        return {tag: -torch.sum(torch.where(sel, f["m"] * up * f["v"][:, 1],
                                            0.0)) / dz}
    return diag


def _bin_sums(cfg, state, z0, dz, x_window, bin_w, nbx, nbz):
    """Mass, mass·u′ and mass·w summed per (x, z) bin of the band: the rows
    sorted by bin (stable) and each bin's run summed in row order, so that
    reruns on the card are bitwise equal (no atomics)."""
    f = state.fields
    y = f["x"][:, 1]
    sel = _band(cfg, state, z0, dz, x_window)
    m = torch.where(sel, f["m"], 0.0)
    bx = torch.clamp(((f["x"][:, 0] + x_window) / bin_w).to(torch.int32),
                     0, nbx - 1)
    bz = torch.clamp(((y - (z0 - dz / 2)) / (dz / nbz)).to(torch.int32),
                     0, nbz - 1)
    b = (bx * nbz + bz).to(torch.int64)
    vals = torch.stack([m, m * (f["v"][:, 0] - cfg.U_max), m * f["v"][:, 1]],
                       dim=-1)
    order = torch.argsort(b, stable=True)
    sums = torch.segment_reduce(
        vals[order], "sum", lengths=torch.bincount(b, minlength=nbx * nbz),
        unsafe=True)
    return sums[:, 0], sums[:, 1], sums[:, 2]


def wave_momentum_flux_binned(cfg: LegacyConfig, z0: float, dz: float,
                              tag: str = "wave_flux", x_window: float = 15e3,
                              bin_w: float = 1000.0, bin_h: float = 400.0):
    """``wave_momentum_flux`` from binned mass-weighted means:
    D(z₀) = −Σ_b M_b·ū′_b·w̄_b / dz over bins ``bin_w`` × ``bin_h`` tiling
    the band within |x| ≤ ``x_window`` (a top-hat Reynolds filter)."""
    nbx = int(round(2 * x_window / bin_w))
    nbz = max(1, int(round(dz / bin_h)))

    def diag(state: ParticleState) -> dict:
        sm, su, sw = _bin_sums(cfg, state, z0, dz, x_window, bin_w, nbx, nbz)
        sm_safe = torch.clamp(sm, min=1e-30)
        return {tag: -torch.sum(su * sw / sm_safe) / dz}
    return diag


def wave_momentum_flux_profile(cfg: LegacyConfig, z_levels,
                               dz: float = 1000.0, tag: str = "fp",
                               x_window: float = 15e3,
                               bin_w: float = 1000.0, bin_h: float = 400.0):
    """One ``wave_momentum_flux_binned`` band per level of ``z_levels``,
    keys ``{tag}{z}``."""
    bands = [wave_momentum_flux_binned(
        cfg, z0=float(z), dz=dz, tag=f"{tag}{int(z)}", x_window=x_window,
        bin_w=bin_w, bin_h=bin_h) for z in z_levels]

    def diag(state: ParticleState) -> dict:
        out = {}
        for d in bands:
            out.update(d(state))
        return out
    return diag


def wave_amplitude_profile(cfg: LegacyConfig, z_levels, dz: float = 1000.0,
                           tag: str = "amp", x_window: float = 15e3,
                           bin_w: float = 1000.0, bin_h: float = 400.0):
    """Per level, the mass-weighted RMS of the binned mean perturbation
    velocities within |x| ≤ ``x_window``: keys ``{tag}u{z}`` (ū′) and
    ``{tag}w{z}`` (w̄)."""
    nbx = int(round(2 * x_window / bin_w))
    nbz = max(1, int(round(dz / bin_h)))

    def one(z0):
        def diag(state: ParticleState) -> dict:
            sm, su, sw = _bin_sums(cfg, state, z0, dz, x_window, bin_w, nbx,
                                   nbz)
            sm_safe = torch.clamp(sm, min=1e-30)
            M = torch.clamp(torch.sum(sm), min=1e-30)
            return {f"{tag}u{int(z0)}":
                    torch.sqrt(torch.sum(sm * (su / sm_safe) ** 2) / M),
                    f"{tag}w{int(z0)}":
                    torch.sqrt(torch.sum(sm * (sw / sm_safe) ** 2) / M)}
        return diag

    bands = [one(float(z)) for z in z_levels]

    def diag(state: ParticleState) -> dict:
        out = {}
        for d in bands:
            out.update(d(state))
        return out
    return diag


def stationary_wave_bins(cfg: LegacyConfig, z0: float, dz: float = 500.0,
                         x_window: float = 15e3, bin_w: float = 1000.0,
                         tag: str = "s"):
    """Per x-bin mass-weighted band means of the perturbation velocities in
    one band: keys ``{tag}u{i}``/``{tag}w{i}``, i = 0 .. 2·x_window/bin_w
    − 1."""
    nbx = int(round(2 * x_window / bin_w))

    def diag(state: ParticleState) -> dict:
        sm, su, sw = _bin_sums(cfg, state, z0, dz, x_window, bin_w, nbx, 1)
        sm = torch.clamp(sm, min=1e-30)
        su, sw = su / sm, sw / sm
        out = {}
        for i in range(nbx):
            out[f"{tag}u{i}"] = su[i]
            out[f"{tag}w{i}"] = sw[i]
        return out
    return diag


# ------------------------------------------------------------------- run

def run_system(cfg: LegacyConfig, capacity_factor: float = 1.3
               ) -> ParticleSystem:
    """``make_system`` with the engine choices ``run`` makes: a flow
    variant on the bucket layout takes ``capacity_factor`` × N of capacity
    and the stencil rescatter, so that its spawns are slot-targeted (the
    engine still degrades to the sort rescatter, and the spawns to the free
    pool, past the stencil-cost limit)."""
    sys = make_system(cfg)
    if cfg.flow:
        sys.freeze_opts["capacity"] = int(sys.n_built * capacity_factor)
        if sys.freeze_opts.get("layout") == "bucket":
            sys.freeze_opts["rescatter_mode"] = "stencil"
    return sys


def run(cfg: LegacyConfig, out_path: str | None = None, verbose: bool = False,
        packing: bool = False, capacity_factor: float = 1.3,
        extra_diag=None, setup_hook=None, device="cuda"):
    """The main loop of the four schemes on ``device`` (the card unless the
    caller asks for the CPU): build (flow variants on the bucket layout:
    slot-targeted spawns under the stencil rescatter), the Colagrossi packing
    with ``packing``, ``setup_hook(state) -> state`` (both skipped on
    resume), then frames. Per frame: u_avg/u_max, ``extra_diag`` (default
    ``mountain_force``) and, for flow variants with recycling,
    ``inflow_reservoir``; with ``out_path`` the frames of ``EXPORT_VARS``,
    ``result.pvd``, ``data.csv`` and checkpoints."""
    from .wcsph_perturbed_witch import _run_witch_scheme

    def setup(cfg_, engine, state):
        if packing:
            from ..utils.packing import colagrossi_packing
            state = colagrossi_packing(cfg_.witch, engine, state,
                                       1e-10, 1e-10, 100)
        if setup_hook is not None:
            state = setup_hook(state)
        return state

    diag = extra_diag or mountain_force
    if cfg.flow and cfg.max_spawn:
        base_diag = diag

        def diag(state):
            return {**base_diag(state), **inflow_reservoir(state)}

    return _run_witch_scheme(cfg, partial(run_system,
                                          capacity_factor=capacity_factor),
                             make_step, EXPORT_VARS, out_path, verbose,
                             setup=setup, extra_diag=diag, device=device)


# named configurations of the reference files
def isothermal_static_config(**kw) -> LegacyConfig:
    kw.setdefault("t_end", 200.0)
    return LegacyConfig(flow=False, adiabatic=False, **kw)


def isothermal_flow_config(**kw) -> LegacyConfig:
    kw.setdefault("n_rows", 100)
    kw.setdefault("dom_length", 100e3)
    kw.setdefault("h_m", 13e3)
    kw.setdefault("t_end", 200.0)
    return LegacyConfig(flow=True, adiabatic=False, **kw)


def adiabatic_static_config(**kw) -> LegacyConfig:
    kw.setdefault("t_end", 100.0)
    return LegacyConfig(flow=False, adiabatic=True, **kw)


def adiabatic_flow_config(**kw) -> LegacyConfig:
    kw.setdefault("n_rows", 75)
    kw.setdefault("t_end", 200.0)
    return LegacyConfig(flow=True, adiabatic=True, **kw)


def terrain_baseline_config(**kw) -> LegacyConfig:
    """The terrain baseline: the isothermal flow scheme (U = 20 m/s, inflow
    recycling, hₘ = 13 km, a = 10 km) at n_rows = 228 on the square lattice
    (N ≈ 2.1e5 with the mountain body), skin 1.0 (wide cells: the blocked
    flow reaches u_max ≈ 400 m/s and the cell margin sets the rescatter
    cadence)."""
    kw.setdefault("n_rows", 228)
    kw.setdefault("skin", 1.0)
    return isothermal_flow_config(**kw)
