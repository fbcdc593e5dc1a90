"""Particle packing: initial-condition relaxation.

Port of ``sph_mountain_waves_tpu/utils/packing.py``, both algorithms:

* ``hydrostatic_packing``: damped pseudo-dynamics driving the SPH summation
  density toward the analytic hydrostatic profile ρt(z) = ρ0·exp(−zg/RT),
  with the pseudo-pressure c_pack²(ρ−ρt), vertical-only forces, implicit
  velocity damping v ← (v + dt·F)/(1 + ζ·dt) and an absolute+relative
  residual stopping rule checked every 10 steps.
* ``colagrossi_packing`` (after Colagrossi et al.,
  doi 10.1016/j.cpc.2012.02.032): the unevenness gradient ∇Γ_p = Σ V0·∇W
  with the stabilization force −β∇Γ − ζv, β = 2·p̄/ρ̄ from the analytic
  profile averages, ζ = α√(β/V0). Its pair sum is the ``gamma_grad_pass``
  sweep (a CUDA kernel of its own on CUDA tensors, its twin on CPU tensors).

The reference's pair sums in both packings are XLA pair sums, not Pallas
kernels. The hydrostatic packing's two run on sweeps the schemes already
have, through their wrappers (the CUDA kernel on CUDA tensors, the plain
twin on CPU tensors):

* the density is the density sweep with weight m and no self pair, taken on
  FLUID rows only (walls keep their ρ);
* the force is the momentum sweep on a stand-in state: mass m·[FLUID] (the
  q-side gate), pressure term P′/ρ_f² = c_pack²(ρ_f − ρt(y))/ρ_f², sound
  speed 0, α = β = 0 (the Monaghan term is exactly ±0; μ stays finite
  because ε > 0) and exact divides. Only its y output is kept, on FLUID rows.

The sweeps order their arithmetic as the Pallas bodies do (1/h streamed,
−m·W′ times the pressure sum), not as the reference's pair functions, so the
result matches the reference to rounding, not bitwise.
"""
from __future__ import annotations

import math
import types

import torch

from ..ops.pair_sweeps import density_pass, gamma_grad_pass, momentum_pass
from ..structs import ParticleState

__all__ = ["hydrostatic_packing", "colagrossi_packing"]

FLUID = 0.0


def hydrostatic_packing(cfg, engine, state: ParticleState,
                        abs_tol: float = 1e-3, rel_tol: float = 1e-2,
                        max_steps: int = 500, verbose: bool = False,
                        return_info: bool = False):
    """Relax ``state`` toward hydrostatic density. ``cfg`` provides dt, c,
    eps, rho0, g, R_mass, T_bg, rho_floor and gamma (a WitchConfig works).
    Returns the packed state with zero velocities and a fresh density, and
    with ``return_info`` also {"err0", "err", "steps"}."""
    dt_pack = 1.0 * cfg.dt
    c_pack = 2.0 * cfg.c
    zeta = 1.0 * cfg.c / dt_pack
    # what the two sweeps read of a config: no self pair, no viscosity
    sweep_cfg = types.SimpleNamespace(
        self_density=False, alpha=0.0, beta=0.0, eps=cfg.eps,
        fast_math=False, rho_floor=cfg.rho_floor, gamma=cfg.gamma)

    def rho_target(z):
        return cfg.rho0 * torch.exp(-z * cfg.g / (cfg.R_mass * cfg.T_bg))

    def fluid_of(state):
        return state.fields["type"] == FLUID

    def density(state):
        state, _ = engine.rebuild(state)
        rho = density_pass(engine, state, sweep_cfg)
        return state.replace(rho=torch.where(fluid_of(state), rho,
                                             state.fields["rho"]))

    def force(state):
        f = state.fields
        fluid = fluid_of(state)
        rho_f = torch.clamp(f["rho"], min=cfg.rho_floor)
        stand_in = state.replace(
            m=torch.where(fluid, f["m"], 0.0),
            P_p=c_pack**2 * (rho_f - rho_target(f["x"][:, 1])),
            P=torch.zeros_like(f["rho"]))
        _, fy = momentum_pass(engine, stand_in, sweep_cfg)
        fy = torch.where(fluid, fy, 0.0)
        return state.replace(Dv=f["Dv"] + torch.stack(
            [torch.zeros_like(fy), fy], dim=-1))

    def pack_accelerate(state):
        f = state.fields
        fluid = fluid_of(state)[:, None]
        v_new = (f["v"] + dt_pack * f["Dv"]) / (1.0 + zeta * dt_pack)
        return state.replace(v=torch.where(fluid, v_new, f["v"]),
                             Dv=torch.zeros_like(f["Dv"]))

    def pack_move(state):
        f = state.fields
        fluid = fluid_of(state)[:, None]
        return state.replace(x=torch.where(fluid, f["x"] + dt_pack * f["v"],
                                           f["x"]))

    def pack_step(state):
        state = pack_move(pack_accelerate(state))
        return pack_accelerate(force(density(state)))

    def residuals(state):
        f = state.fields
        fluid = state.active & fluid_of(state)
        d = torch.where(fluid, f["rho"] - rho_target(f["x"][:, 1]), 0.0)
        v2 = torch.where(fluid, torch.sum(f["v"] ** 2, dim=-1), 0.0)
        return float(torch.sqrt(torch.sum(d**2))), float(torch.sqrt(torch.sum(v2)))

    def at_rest(state):
        f = state.fields
        return state.replace(v=torch.zeros_like(f["v"]),
                             Dv=torch.zeros_like(f["Dv"]))

    state = density(at_rest(state))
    err0, _ = residuals(state)
    if verbose:
        print(f"packing init: density error = {err0:.6e}")

    k = 0
    while k < max_steps:
        state = pack_step(state)
        if k % 10 == 0:
            err, vn = residuals(state)
            crit = abs_tol + rel_tol * err0
            if verbose:
                print(f"packing step {k}: rho_err={err:.4e} |v|={vn:.4e} "
                      f"crit={crit:.4e}")
            if err < crit and vn < crit:
                break
        k += 1

    # leave the packed density consistent with a fresh summation
    state = density(at_rest(state))
    err = residuals(state)[0]
    if verbose:
        print(f"packing done after {k} steps (rho_err {err0:.4e} -> {err:.4e})")
    if return_info:
        return state, {"err0": err0, "err": err, "steps": k}
    return state


def colagrossi_packing(cfg, engine, state: ParticleState,
                       abs_tol: float = 1e-10, rel_tol: float = 1e-10,
                       max_steps: int = 100, alpha: float = 5e-3,
                       verbose: bool = False, return_info: bool = False):
    """Relax ``state`` along −β∇Γ − ζv until |v| + |∇Γ| falls under
    ``2·abs_tol + rel_tol·|∇Γ|₀`` or ``max_steps`` steps were taken. Needs a
    ``gGamma`` field; ``cfg`` provides dt, g, T_bg, R_mass, rho0 and
    dom_height. Returns the packed state with zero velocities, and with
    ``return_info`` also {"res_g0", "res_g", "res_v", "steps"}."""
    dt = cfg.dt

    # packing parameters from the analytic profile; V0 is a host mean over
    # the active rows (one transfer at set-up)
    K = cfg.g / (cfg.T_bg * cfg.R_mass)
    span = math.exp(-K * 0.0) - math.exp(-K * cfg.dom_height)
    p0 = (cfg.rho0**2 * cfg.T_bg**2 * cfg.R_mass**2 / cfg.g) * span
    rho_avg = (cfg.rho0 * cfg.T_bg * cfg.R_mass / cfg.g) * span
    act = state.active.cpu().numpy()
    host_m = state.fields["m"].cpu().numpy()[act]
    host_rho = state.fields["rho"].cpu().numpy()[act]
    V0 = float((host_m / host_rho.clip(min=1e-30)).mean())
    beta = 2.0 * p0 / rho_avg
    zeta = alpha * math.sqrt(beta / V0)

    def fluid_of(state):
        return (state.fields["type"] == FLUID)[:, None]

    def gamma_pass(state):
        state, _ = engine.rebuild(state)
        g0, g1 = gamma_grad_pass(engine, state, V0)
        gGamma = torch.where(state.active[:, None],
                             torch.stack([g0, g1], dim=-1), 0.0)
        # stabilization force; v is zero on empty slots, so Dv is too
        return state.replace(gGamma=gGamma,
                             Dv=-beta * gGamma - zeta * state.fields["v"])

    def pack_accelerate(state):
        f = state.fields
        return state.replace(v=torch.where(
            fluid_of(state), f["v"] + 0.5 * dt * f["Dv"], f["v"]))

    def pack_move(state):
        f = state.fields
        return state.replace(
            x=torch.where(fluid_of(state), f["x"] + dt * f["v"], f["x"]),
            Dv=torch.zeros_like(f["Dv"]),
            gGamma=torch.zeros_like(f["gGamma"]))

    def pack_step(state):
        state = pack_move(pack_accelerate(state))
        return pack_accelerate(gamma_pass(state))

    def at_rest(state):
        f = state.fields
        return state.replace(v=torch.zeros_like(f["v"]),
                             Dv=torch.zeros_like(f["Dv"]))

    def norms(state):
        f = state.fields
        am = state.active[:, None]
        g = torch.sqrt(torch.sum(torch.where(am, f["gGamma"], 0.0) ** 2))
        v = torch.sqrt(torch.sum(torch.where(am, f["v"], 0.0) ** 2))
        return float(g), float(v)

    state = gamma_pass(at_rest(state))
    res_g0, _ = norms(state)
    crit = 2 * abs_tol + rel_tol * res_g0
    if verbose:
        print(f"colagrossi packing init: |gGamma| = {res_g0:.6e}")

    k = 0
    res_v, res_g = 0.0, res_g0
    while (res_v + res_g) >= crit and k < max_steps:
        state = pack_step(state)
        res_g, res_v = norms(state)
        k += 1
    if verbose:
        print(f"colagrossi packing: {k} steps, |v|={res_v:.3e} "
              f"|gGamma|={res_g:.3e}")
    state = at_rest(state)
    if return_info:
        return state, {"res_g0": res_g0, "res_g": res_g, "res_v": res_v,
                       "steps": k}
    return state
