"""Pressure–entropy mountain-wave scheme, full gradient-form momentum with
background split.

Port of ``sph_mountain_waves_tpu/models/full_hopkins_perturbed_witch.py``:
the perturbed Hopkins scheme, but the momentum is the Hopkins two-kernel
P^(1−2/γ) gradient form on the total state minus the same form on the
background state (a_tot − a_bg), with a background entropy
A_bg = P_bg/ρ_bg^γ. The step is ``hopkins_perturbed_witch._make_step`` with
``full=True``: density, pressure and Hopkins-momentum sweeps (split on).
"""
from __future__ import annotations

from ..structs import ParticleSystem
from .witch_common import WitchConfig, background_entropy, make_witch_system
from . import hopkins_perturbed_witch as _hopkins
from . import wcsph_perturbed_witch as _wcsph

FIELDS = dict(_hopkins.FIELDS, A_bg=0)


def make_system(cfg: WitchConfig) -> ParticleSystem:
    # no persistent fields: a rescatter moves every field, A and A_bg included
    sys = make_witch_system(cfg, FIELDS)
    for chunk in sys._chunks:
        chunk["A"] = chunk["P"] / chunk["rho"] ** cfg.gamma
        chunk["A_bg"] = background_entropy(cfg, chunk["x"][:, 1])
    return sys


def make_step(cfg: WitchConfig, engine):
    return _hopkins._make_step(cfg, engine, full=True)


def run(cfg: WitchConfig = WitchConfig(), out_path: str | None = None,
        verbose: bool = False, device="cuda"):
    """Frames every t_end/n_frames with avg/max velocity diagnostics, on
    ``device`` (the card unless the caller asks for the CPU)."""
    return _wcsph._run_witch_scheme(cfg, make_system, make_step, out_path,
                                    verbose, device=device)
