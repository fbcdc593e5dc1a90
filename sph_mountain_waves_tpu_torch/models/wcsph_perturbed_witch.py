"""WCSPH mountain-wave scheme on perturbation variables (the flagship).

Port of ``sph_mountain_waves_tpu/models/wcsph_perturbed_witch.py``: each
particle carries background + perturbation + total triplets for (ρ, P, θ, T);
density by kernel summation with per-particle adaptive h; linear EOS on the
perturbation P′ = c²ρ′; buoyancy −g ρ′/ρ; Rayleigh sponge; momentum =
symmetric pressure gradient on P′ + Monaghan artificial viscosity; modified
Verlet (kick, drift, rebuild, density, EOS, momentum, kick).

The two pair sums are the sweeps of ``ops/pair_sweeps.py``, called through
their wrappers: CUDA kernels on CUDA tensors, plain PyTorch twins on CPU
tensors. A CUDA state with ``cfg.use_pallas`` off is refused
(``check_sweep_route``).

``_run_witch_scheme`` is the run skeleton that every mountain-wave scheme's
``run`` goes through.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.apply import apply_unary
from ..ops.pair_sweeps import density_pass, momentum_pass
from ..structs import ParticleState, ParticleSystem
from .common import (
    check_sweep_route, frame_runner, maybe_checkpoint, maybe_resume,
)
from .witch_common import (
    FLUID, WitchConfig, background_density_t, background_pot_temperature_t,
    make_witch_system, rayleigh_damping, velocity_diagnostics,
)

FIELDS = {"h": 0, "x": 2, "m": 0, "v": 2, "Dv": 2,
          "rho_bg": 0, "rho_p": 0, "rho": 0,
          "P_bg": 0, "P_p": 0, "P": 0,
          "theta_bg": 0, "theta_p": 0, "theta": 0,
          "T_bg": 0, "T_p": 0, "T": 0, "type": 0}
EXPORT_VARS = ("v", "rho", "P", "theta", "T", "type")


def make_system(cfg: WitchConfig) -> ParticleSystem:
    # Irreducible per-step state: the step recomputes rho/rho_p/rho_bg,
    # P*/T*/theta* after every rebuild before reading them, and Dv is zero
    # at rebuild time, so bucket rescatters move only these + the constant
    # T_bg (read by find_temperature's T_p).
    return make_witch_system(
        cfg, FIELDS, persistent=("x", "v", "h", "m", "type", "T_bg"))


def make_step(cfg: WitchConfig, engine):
    if engine is None:
        raise ValueError("make_step needs the system's engine: call "
                         "sys.freeze() before make_step(cfg, sys.engine)")
    dt = cfg.dt

    def finalize_density(u):
        rho_bg = background_density_t(cfg, u.x[:, 1])
        return {"rho_bg": rho_bg, "rho_p": u.rho - rho_bg}

    def update_smoothing(u):
        rho = torch.clamp(u.rho, min=cfg.rho_floor)
        return {"h": cfg.eta * torch.sqrt(u.m / rho)}

    def compute_pressure(u):
        # P_bg = R·T_bg·ρ_bg (isothermal), from finalize_density's fresh ρ_bg
        P_bg = cfg.R_mass * cfg.T_bg * u.rho_bg
        P_p = cfg.c**2 * u.rho_p
        return {"P_bg": P_bg, "P_p": P_p, "P": P_bg + P_p}

    def find_temperature(u):
        T = u.P / (cfg.R_mass * u.rho)
        return {"T": T, "T_p": T - u.T_bg}

    def find_pot_temp(u):
        theta = u.T * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / u.P) ** (2.0 / 7.0)
        theta_bg = background_pot_temperature_t(cfg, u.x[:, 1])
        return {"theta": theta, "theta_bg": theta_bg,
                "theta_p": theta - theta_bg}

    def move(u):
        fluid = (u.type == FLUID)[:, None]
        return {"x": torch.where(fluid, u.x + dt * u.v, u.x)}

    def accelerate(u):
        # v += dt/2 (Dv + buoyancy + damping); Dv reset
        fluid = (u.type == FLUID)[:, None]
        buoy = -cfg.g * u.rho_p / torch.clamp(u.rho, min=cfg.rho_floor)
        damp = rayleigh_damping(cfg, u.x[:, 1])
        acc_y = u.Dv[:, 1] + buoy + damp
        acc = torch.stack([u.Dv[:, 0], acc_y], dim=-1)
        return {"v": torch.where(fluid, u.v + 0.5 * dt * acc, u.v),
                "Dv": torch.zeros_like(u.Dv)}

    def step(state: ParticleState) -> ParticleState:
        check_sweep_route(cfg, state)
        state = apply_unary(state, accelerate)
        state = apply_unary(state, move)
        state, _ = engine.rebuild(state)

        rho = density_pass(engine, state, cfg)
        state = state.replace(rho=torch.where(state.active, rho, 0.0))
        state = apply_unary(state, finalize_density)
        state = apply_unary(state, update_smoothing)
        # positions are unchanged and the cell size is fixed, so the
        # reference's second rebuild (after h changed) is a no-op
        state = apply_unary(state, compute_pressure)
        if not cfg.lazy_diagnostics:
            state = apply_unary(state, find_temperature)
            state = apply_unary(state, find_pot_temp)

        dv0, dv1 = momentum_pass(engine, state, cfg)
        Dv = state.fields["Dv"] + torch.stack([dv0, dv1], dim=-1)
        state = state.replace(Dv=torch.where(state.active[:, None], Dv, 0.0))
        return apply_unary(state, accelerate)

    return step


def make_finalize(cfg: WitchConfig):
    """Materialize the lazy diagnostics (T, θ and their perturbations),
    applied once per frame by run loops when cfg.lazy_diagnostics."""
    def find_temperature(u):
        T = u.P / (cfg.R_mass * torch.clamp(u.rho, min=cfg.rho_floor))
        return {"T": T, "T_p": T - u.T_bg}

    def find_pot_temp(u):
        theta = u.T * ((cfg.T_bg * cfg.R_gas * cfg.rho0) / torch.clamp(
            u.P, min=cfg.P_floor)) ** (2.0 / 7.0)
        theta_bg = background_pot_temperature_t(cfg, u.x[:, 1])
        return {"theta": theta, "theta_bg": theta_bg,
                "theta_p": theta - theta_bg}

    def finalize(state):
        state = apply_unary(state, find_temperature)
        return apply_unary(state, find_pot_temp)

    return finalize


def run(cfg: WitchConfig = WitchConfig(), out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """The reference main loop: frames every t_end/n_frames with avg/max
    velocity diagnostics and, with ``out_path``, the PVD output of
    ``EXPORT_VARS`` and ``data.csv``; on ``device`` (the card unless the
    caller asks for the CPU). Returns the time series, the final state and
    the system."""
    return _run_witch_scheme(
        cfg, make_system, make_step, EXPORT_VARS, out_path, verbose,
        finalize=make_finalize(cfg) if cfg.lazy_diagnostics else None,
        device=device)


def _run_witch_scheme(cfg, make_system_fn, make_step_fn, export_vars,
                      out_path=None, verbose=False, setup=None,
                      finalize=None, device="cuda"):
    """Shared main() skeleton of the mountain-wave schemes: build, freeze on
    ``device``, resume from ``cfg.resume`` or else ``setup(cfg, engine,
    state)`` (e.g. a packing) if given, then frames of ``make_step_fn``'s
    steps with ``finalize`` (lazy diagnostics) after each, and the avg/max
    velocity time series. With ``out_path``: ``frame<k>.vtp`` of
    ``export_vars`` at t = 0 and after every frame, ``result.pvd``,
    ``data.csv`` and, every ``cfg.checkpoint_every`` frames and on the last,
    ``checkpoint.npz``. The terminal sparklines (``cfg.live_plot``) and the
    velocities figure need ``utils/plots.py``, which is not ported: the
    first raises, the second is not written."""
    from ..io import new_pvd_file, save_csv, save_frame, save_pvd_file

    if cfg.live_plot:
        raise NotImplementedError("live plots (utils/plots.py) are not ported")
    sys = make_system_fn(cfg)
    state = sys.freeze(device=device)
    state, k0 = maybe_resume(cfg, state)  # bitwise restart
    if not k0 and setup is not None:
        state = setup(cfg, sys.engine, state)
    step = make_step_fn(cfg, sys.engine)

    n_steps = int(round(cfg.t_end / cfg.dt))
    steps_per_frame = max(1, int(round(cfg.t_end / cfg.n_frames / cfg.dt)))
    run_frame = frame_runner(step, steps_per_frame, finalize=finalize)

    out = new_pvd_file(out_path, resume=k0 > 0) if out_path else None
    if out and not k0:
        save_frame(out, state, *export_vars, time=0.0)

    ts, u_avgs, u_maxs = [], [], []
    k, frame = k0, 0
    while k < n_steps:
        state = run_frame(state)
        k += steps_per_frame
        frame += 1
        t = k * cfg.dt
        u_avg, u_max = (float(v) for v in velocity_diagnostics(state))
        ts.append(t)
        u_avgs.append(u_avg)
        u_maxs.append(u_max)
        if verbose:
            print(f"t = {t:.3f}  n = {int(state.n)}  "
                  f"u_avg = {u_avg:.4e}  u_max = {u_max:.4e}")
        if out:
            save_frame(out, state, *export_vars, time=t)
        maybe_checkpoint(cfg, out, state, sys.engine, k, t, frame,
                         last=k >= n_steps)
    if out:
        save_pvd_file(out)
        save_csv(os.path.join(out.path, "data.csv"),
                 {"t": ts, "u_avg": u_avgs, "u_max": u_maxs},
                 merge_history=k0 > 0)
    sys.state = state
    return {"t": np.asarray(ts), "u_avg": np.asarray(u_avgs),
            "u_max": np.asarray(u_maxs), "state": state, "system": sys}
