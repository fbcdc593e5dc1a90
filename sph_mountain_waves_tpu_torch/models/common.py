"""Shared model scaffolding: frame loops and masked observables.

Port of ``sph_mountain_waves_tpu/models/common.py``. PyTorch runs eagerly,
so a frame is a Python loop over steps; the reference's donated ``lax.scan``
has no counterpart yet (a CUDA graph of the step is later work).
"""
from __future__ import annotations

import os
from typing import Callable

import torch

from ..structs import ParticleState

__all__ = ["frame_runner", "masked_mean", "masked_max", "masked_sum",
           "check_sweep_route", "maybe_resume", "maybe_checkpoint"]


def maybe_resume(cfg, state: ParticleState):
    """The cfg-driven checkpoint contract: if ``cfg.resume`` names a
    checkpoint, return its bitwise-restored state (on ``state``'s device) and
    its saved step counter; otherwise ``(state, 0)``. Callers skip their
    set-up hooks when the returned step is non-zero: the checkpoint already
    holds their effect."""
    if not cfg.resume:
        return state, 0
    from ..utils.checkpoint import load_checkpoint
    state, meta = load_checkpoint(cfg.resume, device=state.active.device)
    return state, int(meta["extra"].get("step", 0))


def maybe_checkpoint(cfg, out, state: ParticleState, engine, k, t, frame, *,
                     last: bool = False) -> None:
    """Overwrite ``<out.path>/checkpoint.npz`` (atomically) every
    ``cfg.checkpoint_every`` frames, and always on the run's final frame
    (``last=True``) so that a run shorter than the cadence still leaves a
    resume point. No-op without an output directory or with the feature
    off."""
    every = cfg.checkpoint_every
    if not (every and out and (last or frame % every == 0)):
        return
    from ..utils.checkpoint import save_checkpoint
    save_checkpoint(os.path.join(out.path, "checkpoint.npz"), state,
                    engine=engine, extra={"step": k, "t": t})


def check_sweep_route(cfg, state: ParticleState, engine) -> None:
    """Refuse a state the step's pair path cannot take. A flat state runs
    the pair operator ``ops/apply.py::apply_binary`` on its own device, as
    the reference takes its XLA pair sums off the bucket layout. A bucket
    state runs the sweep wrappers, which launch the CUDA kernels on CUDA
    tensors and take the plain twins on CPU tensors: so on the card it needs
    ``cfg.use_pallas`` (the twins are test oracles, never a card path), and
    it must be float32 (the kernels are; the reference's float64 bucket
    path, its resident XLA pair sum, is not ported)."""
    if engine.layout == "flat":
        return
    if state.fields["x"].dtype != torch.float32:
        raise NotImplementedError(
            f"a {state.fields['x'].dtype} state on the bucket layout: the "
            "bucket layout's sweeps are float32 (float64 runs on the flat "
            "layout; the reference's float64 bucket path, its resident pair "
            "sum, belongs to a later slice)")
    if not cfg.use_pallas and state.active.device.type == "cuda":
        raise ValueError(
            "use_pallas=False on a CUDA state: the port's only pair path on "
            "the card's bucket layout is its CUDA kernels (the plain twins "
            "are test oracles and run on CPU tensors only); set "
            "use_pallas=True, or take the flat layout")


def frame_runner(step_fn: Callable[[ParticleState], ParticleState],
                 steps_per_frame: int, finalize=None):
    """Return ``state -> state`` advancing ``steps_per_frame`` steps, then
    ``finalize`` (optional: lazy-diagnostics schemes materialize their frame
    observables there)."""

    def run_frame(state: ParticleState) -> ParticleState:
        for _ in range(steps_per_frame):
            state = step_fn(state)
        return state if finalize is None else finalize(state)

    return run_frame


def masked_sum(val, active):
    m = active if val.ndim == 1 else active[:, None]
    return torch.sum(torch.where(m, val, 0))


def masked_mean(val, active):
    return masked_sum(val, active) / torch.clamp(torch.sum(active), min=1)


def masked_max(val, active, init=0.0):
    return torch.max(torch.where(active, val, init))
