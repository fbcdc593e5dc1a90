"""ISPH mountain-wave scheme: the incompressible projection variant.

Port of ``sph_mountain_waves_tpu/models/isph_witch.py``: the witch-of-Agnesi
system (geometry, hydrostatic background, Rayleigh sponge) with a projection
step in the Boussinesq limit. Density stays at the hydrostatic background
ρ_bg(y); buoyancy comes from an advected potential-temperature perturbation
(Dθ′/Dt = −v_y·θ_bg·N²/g). Each step predicts (buoyancy, sponge, drift),
rebuilds, takes the divergence, the Morris Laplacian's diagonal L, the
free-surface λ and the viscous force (one pair sweep on the bucket layout),
solves the pressure-Poisson system with matrix-free preconditioned CG, and
corrects the velocity with the pressure gradient.

On the float32 bucket layout the pair sums are the sweeps of
``ops/pair_sweeps.py``, called through their wrappers:
``isph_div_visc_pass``, the CG matvec ``isph_matvec_prepared`` (prepared
once per solve, one launch per matvec) and ``isph_grad_pass`` (CUDA kernels
on CUDA tensors, plain twins on CPU tensors); the preconditioner is the
two-level V-cycle of ``ops/mg.py`` ("mg": additive, "mg_mult": symmetrized
multiplicative) or Jacobi. On the flat layout (float32 or float64; the
config's default layout) the viscous force, the divergence/L/λ sums and the
pressure gradient are the reference's pair functions summed by
``ops/apply.py::apply_binary``, the off-diagonal of the operator is
``ops/solvers.py::assemble_matvec`` (``include_self=False``), and the
preconditioner is Jacobi: the V-cycle needs the bucket cell grid, so with
``precond`` "mg" or "mg_mult" on a flat engine ``make_step`` warns
(``RuntimeWarning``) and solves with Jacobi, as the reference does. Either
way the solve is ``ops/solvers.pcg``, whose stop test is read on the host
once per iteration, and a float64 bucket state raises at its first step
(``check_sweep_route``); a CUDA bucket state with ``use_pallas`` off is
refused there too, and so is a sharded engine.
"""
from __future__ import annotations

import dataclasses
import math
import warnings

import torch

from ..kernels import rDspline23
from ..ops.apply import apply_binary, apply_unary
from ..ops.mg import two_level_preconditioner
from ..ops.pair_sweeps import (
    isph_div_visc_pass, isph_grad_pass, isph_matvec_prepared,
)
from ..ops.solvers import assemble_matvec, pcg
from ..structs import ParticleState, ParticleSystem
from .common import check_sweep_route
from .witch_common import (
    FLUID, WitchConfig, background_pot_temperature_t, make_witch_system,
    rayleigh_damping,
)

FIELDS = {"h": 0, "x": 2, "m": 0, "v": 2, "Dv": 2, "P": 0,
          "div": 0, "L": 0, "lam": 0,
          "rho_bg": 0, "theta_bg": 0, "theta_p": 0, "type": 0,
          # the last pressure solve's CG iteration count and relative
          # residual, broadcast over every slot and exported per frame
          "cg_it": 0, "cg_res": 0}
EXPORT_VARS = ("v", "P", "theta_p", "type")
PRECONDITIONERS = ("jacobi", "mg", "mg_mult")


@dataclasses.dataclass(frozen=True)
class ISPHWitchConfig(WitchConfig):
    """Witch constants plus the projection solver's parameters, with the
    JAX package's defaults (see its ISPHWitchConfig for their rationale)."""
    C_free: float = 10.0
    v_char: float = 50.0          # characteristic speed for the CFL dt
    mu_dyn: float = 1.8e-5        # dynamic viscosity of air
    # relative CG tolerance; the f32 solve stalls near rel_res ~7e-3 at
    # tighter ones (gate velocities, not P)
    cg_tol: float = 1e-4
    cg_maxiter: int = 200
    # "jacobi" | "mg" (additive two-level) | "mg_mult" (symmetrized
    # multiplicative, two extra matvecs per iteration); the two-level forms
    # need the bucket layout (a flat engine warns and solves with Jacobi)
    precond: str = "mg"

    @property
    def dt_isph(self) -> float:
        return 0.1 * self.h0 / self.v_char


def check_ported(cfg: ISPHWitchConfig) -> None:
    """Refuse a preconditioner the scheme does not know."""
    if cfg.precond not in PRECONDITIONERS:
        raise ValueError(f"precond must be one of {PRECONDITIONERS}, got "
                         f"{cfg.precond!r}")


def make_system(cfg: ISPHWitchConfig) -> ParticleSystem:
    check_ported(cfg)
    return make_witch_system(cfg, FIELDS)


def make_step(cfg: ISPHWitchConfig, engine):
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    if getattr(engine, "axis", None) is not None:
        raise NotImplementedError(
            "sharded ISPH needs a distributed CG (summed dots across devices "
            "and a ghost refresh per matvec), which is not ported")
    check_ported(cfg)
    sweeps = engine.layout == "bucket"
    if cfg.precond.startswith("mg") and not sweeps:
        warnings.warn(
            f"ISPH precond={cfg.precond!r} requires a bucket engine "
            f"(got layout={engine.layout!r}); falling back to Jacobi",
            RuntimeWarning, stacklevel=2)
    dt = cfg.dt_isph
    h = cfg.h0
    # m/ρ_bg = dr² exactly (m = ρ_bg·dr²): the constant-coefficient Morris
    # form with m/ρ → dr²
    vol = cfg.dr**2
    visc_c = 2.0 * vol * cfg.mu_dyn / cfg.rho0
    off_c = 2.0 * h**2 * vol

    def offdiag_w(r):
        return 2.0 * h**2 * vol * rDspline23(h, r)

    def initialize(u):
        # predictor: buoyancy + sponge + drift; reset the projection fields
        fluid = (u.type == FLUID)[:, None]
        buoy = cfg.g * u.theta_p / u.theta_bg
        damp = rayleigh_damping(cfg, u.x[:, 1])
        acc = torch.stack([damp * u.v[:, 0], buoy + damp * u.v[:, 1]], dim=-1)
        v = torch.where(fluid, u.v + dt * acc, u.v)
        return {"v": v, "x": torch.where(fluid, u.x + dt * v, u.x),
                "div": torch.zeros_like(u.div),
                "L": torch.zeros_like(u.L),
                "lam": torch.ones_like(u.lam)}

    def accelerate(u):
        fluid = (u.type == FLUID)[:, None]
        return {"v": torch.where(fluid, u.v + dt * u.Dv, u.v),
                "Dv": torch.zeros_like(u.Dv)}

    def advect_theta(u):
        # Dθ′/Dt = −v_y·dθ_bg/dy with dθ_bg/dy = θ_bg·N²/g
        fluid = u.type == FLUID
        dthdy = u.theta_bg * cfg.N_bv**2 / cfg.g
        return {"theta_p": torch.where(
            fluid, u.theta_p - dt * u.v[:, 1] * dthdy, u.theta_p),
            "theta_bg": background_pot_temperature_t(cfg, u.x[:, 1])}

    def viscous_force(p, q, r):
        k = visc_c * rDspline23(h, r)
        return {"Dv": k[..., None] * (p.v - q.v)}

    def div_L_lambda(p, q, r):
        rDk = rDspline23(h, r)
        return {"div": -torch.sum((p.x - q.x) * (p.v - q.v), dim=-1)
                       * p.rho_bg * vol * rDk,
                "L": -2.0 * vol * rDk,
                "lam": vol * rDk * r**2 / 2.0}

    def offdiag(p, q, r):
        return offdiag_w(r)

    def internal_force(p, q, r):
        # pressure correction: symmetric gradient of P′/ρ_bg
        k = vol * rDspline23(h, r) * (p.P + q.P) / p.rho_bg
        return {"Dv": -k[..., None] * (p.x - q.x)}

    def div_visc(state, nbrs):
        """The viscous force and the divergence, L and λ sums."""
        if not sweeps:
            state = apply_binary(engine, state, nbrs, viscous_force)
            return apply_binary(engine, state, nbrs, div_L_lambda)
        # one sweep gives the raw spline sums; the p-constant factors of the
        # divergence, L, λ and the viscous force are applied here
        s_divv, s_L, s_lam, s_dv0, s_dv1 = isph_div_visc_pass(
            engine, state, cfg)
        f = state.fields
        act = state.active
        Dv = f["Dv"] + visc_c * torch.stack([s_dv0, s_dv1], dim=-1)
        return state.replace(
            Dv=torch.where(act[:, None], Dv, 0.0),
            div=torch.where(act, f["div"] - vol * f["rho_bg"] * s_divv, 0.0),
            L=torch.where(act, f["L"] - 2.0 * vol * s_L, 0.0),
            lam=torch.where(act, f["lam"] + 0.5 * vol * s_lam, 0.0))

    def solve(state: ParticleState, nbrs):
        """The pressure-Poisson solve: (P, iterations, relative residual)."""
        f = state.fields
        act = state.active
        fluid = f["type"] == FLUID
        diag = h**2 * f["L"] + torch.where(
            fluid, cfg.C_free * torch.clamp(f["lam"], min=0.0), 0.0)
        if sweeps:
            mv_prep = isph_matvec_prepared(engine, state, cfg)

            def mv_off(v):
                return off_c * mv_prep(v)
        else:
            mv_off = assemble_matvec(engine, state, nbrs, offdiag,
                                     include_self=False)

        def matvec(v):
            return mv_off(v) + torch.where(act, diag * v, 0.0)

        diag_safe = torch.where(torch.abs(diag) > 1e-30, diag, 1.0)
        if cfg.precond == "jacobi" or not sweeps:
            def M(r):
                return r / diag_safe
        else:
            M = two_level_preconditioner(
                engine, state, offdiag_w, torch.where(act, diag, 0.0),
                matvec, diag_safe,
                mode="mult" if cfg.precond == "mg_mult" else "add")
        b = torch.where(act, -h**2 * f["div"] / dt, 0.0)
        # atol > 0: an exactly static state has b = 0, where CG would
        # iterate on a zero residual; any physical RHS is far above it
        return pcg(matvec, b, x0=f["P"], M=M, tol=cfg.cg_tol, atol=1e-18,
                   maxiter=cfg.cg_maxiter, return_info=True)

    def grad(state, nbrs):
        """The pressure-gradient correction of Dv."""
        if not sweeps:
            return apply_binary(engine, state, nbrs, internal_force)
        s0, s1 = isph_grad_pass(engine, state, cfg)
        f = state.fields
        gk = vol / torch.clamp(f["rho_bg"], min=1e-6)
        Dv = f["Dv"] - gk[:, None] * torch.stack([s0, s1], dim=-1)
        return state.replace(Dv=torch.where(state.active[:, None], Dv, 0.0))

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state, engine)
        state = apply_unary(state, initialize)
        state, nbrs = engine.rebuild(state)
        state = div_visc(state, nbrs)
        P, cg_it, cg_res = solve(state, nbrs)
        f = state.fields
        state = state.replace(
            P=torch.where(state.active, P, 0.0),
            cg_it=torch.full_like(f["cg_it"], cg_it),
            cg_res=cg_res.to(f["cg_res"].dtype).expand_as(f["cg_res"]).clone())
        state = grad(state, nbrs)
        state = apply_unary(state, accelerate)
        return apply_unary(state, advect_theta)

    return step


def baseline_config(**overrides) -> ISPHWitchConfig:
    """The ~200k-particle ISPH mountain wave (n_rows 110: N = 207,672) in the
    production layout: float32, bucket, Pallas/CUDA sweeps, lattice-aligned
    cells, skin 0.15."""
    n_rows = max(8, int(round(math.sqrt(2e5 / (400e3 / 26e3) / 1.0746))))
    kw = dict(n_rows=n_rows, dtype="float32", self_density=True,
              layout="bucket", skin=0.15, use_pallas=True,
              lattice_cells=True)
    kw.update(overrides)
    return ISPHWitchConfig(**kw)


def run(cfg: ISPHWitchConfig | None = None, out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """The witch main loop at the ISPH time step on ``device`` (the card
    unless the caller asks for the CPU): frames every n_steps // n_frames
    steps with the avg/max velocity and the last solve's ``cg_it`` and
    ``cg_res``; with ``out_path`` the PVD output of ``EXPORT_VARS``,
    ``data.csv`` (t, u_avg, u_max, cg_it, cg_res), ``velocities.pdf`` and
    ``checkpoint.npz`` (``cfg.checkpoint_every``; ``cfg.resume`` continues
    bit for bit)."""
    from .wcsph_perturbed_witch import _run_witch_scheme

    cfg = cfg or ISPHWitchConfig()
    n_steps = max(1, int(round(cfg.t_end / cfg.dt_isph)))
    steps_per_frame = max(1, n_steps // max(cfg.n_frames, 1))
    return _run_witch_scheme(
        cfg, make_system, make_step, EXPORT_VARS, out_path, verbose,
        device=device,
        extra_diag=lambda s: {"cg_it": s.fields["cg_it"][0],
                              "cg_res": s.fields["cg_res"][0]},
        timing=(cfg.dt_isph, n_steps, steps_per_frame))
