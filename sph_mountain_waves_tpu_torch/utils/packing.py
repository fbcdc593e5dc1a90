"""Particle packing: initial-condition relaxation.

Port of ``hydrostatic_packing`` of ``sph_mountain_waves_tpu/utils/packing.py``:
damped pseudo-dynamics driving the SPH summation density toward the analytic
hydrostatic profile ρt(z) = ρ0·exp(−zg/RT), with the pseudo-pressure
c_pack²(ρ−ρt), vertical-only forces, implicit velocity damping
v ← (v + dt·F)/(1 + ζ·dt) and an absolute+relative residual stopping rule
checked every 10 steps. ``colagrossi_packing`` is not ported yet.

The reference's two pair sums are XLA pair sums, not Pallas kernels. Here
each runs on a sweep the port already has, through its wrapper (the CUDA
kernel on CUDA tensors, the plain twin on CPU tensors):

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

import types

import torch

from ..ops.pair_sweeps import density_pass, momentum_pass
from ..structs import ParticleState

__all__ = ["hydrostatic_packing"]

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
