"""Pointwise operator API: ``apply_unary`` over a ``FieldsView``.

Port of the unary half of ``sph_mountain_waves_tpu/ops/apply.py``. A unary
action is a function of the particle view returning a dict of new field
values; ``apply_unary`` builds a new state from them and never writes into
the old one. The pair half (``apply_binary``/``pair_sum``) is not ported:
the flagship's two pair sums are the sweeps in ``ops/pair_sweeps.py``.
"""
from __future__ import annotations

import torch

from ..structs import ParticleState

__all__ = ["apply_unary", "FieldsView"]


class FieldsView:
    """Attribute/item access to the raw field tensors of a state."""

    def __init__(self, fields: dict):
        object.__setattr__(self, "_fields", fields)

    def __getitem__(self, name: str):
        return self._fields[name]

    def __getattr__(self, name: str):
        try:
            return self.__getitem__(name)
        except KeyError as e:
            raise AttributeError(name) from e


def _bcast(mask, val):
    """Broadcast a per-row mask over any trailing component dims of val."""
    return mask.reshape(mask.shape + (1,) * (val.ndim - 1))


def apply_unary(state: ParticleState, action) -> ParticleState:
    """Apply a pointwise action: ``action(p)`` receives the raw-field view
    and returns a dict of new field values. (The reference's ``where`` mask
    and extra parameters have no caller on the ported slice.)
    """
    updates = action(FieldsView(state.fields))
    # Zero every updated field on inactive rows: unary physics on empty slots
    # (0/0, pow(0, .)) breeds NaN/Inf, and the pair sweeps need every empty
    # slot finite.
    act = state.active
    updates = {name: torch.where(_bcast(act, val), val, 0.0)
               for name, val in updates.items()}
    return state.replace(**updates)
