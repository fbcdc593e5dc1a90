"""Carry a particle state between NumPy and the port.

A JAX ``ParticleState`` converted to NumPy arrays (``{name: np.asarray(v)}``
and ``np.asarray(active)``) goes into the port unchanged with
``state_from_numpy``, so both packages can be fed the identical state;
``state_to_numpy`` brings a port state back for comparison. Dtypes and the
slot layout are kept exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .structs import ParticleState

__all__ = ["state_from_numpy", "state_to_numpy"]


def state_from_numpy(fields: dict, active, device) -> ParticleState:
    """A ``ParticleState`` on ``device`` holding copies of the arrays."""
    return ParticleState(
        fields={name: torch.as_tensor(np.array(arr), device=device)
                for name, arr in fields.items()},
        active=torch.as_tensor(np.array(active, dtype=bool), device=device))


def state_to_numpy(state: ParticleState) -> tuple[dict, np.ndarray]:
    """(fields, active) as host NumPy arrays."""
    return ({name: t.detach().cpu().numpy() for name, t in state.fields.items()},
            state.active.detach().cpu().numpy())
