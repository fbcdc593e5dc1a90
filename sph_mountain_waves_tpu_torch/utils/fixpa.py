"""FixPA: reversible (fixed-point) arithmetic.

Port of ``sph_mountain_waves_tpu/utils/fixpa.py``: addition on a
fixed-point lattice of spacing ε = 2⁻³⁰, the mechanism behind the
bit-reversible time integration of ``models/collapse_symplectic.py``.
``rev_add(x, y) = ε·(round(x/ε) + round(y/ε))`` is exactly invertible:
``rev_add(rev_add(x, y), -y)`` is bit for bit x's lattice value, as long as
|x/ε| stays below 2⁵³ in float64 (the values stay in float: no integer
tensor is needed). ``torch.round`` rounds half to even, as ``jnp.round``
does, on the CPU and on the card alike. Elementwise on tensors of any
shape.
"""
from __future__ import annotations

import torch

__all__ = ["FIXPA_EPS", "nom", "rev_add"]

FIXPA_EPS = 1.0 / 2**30


def nom(x: torch.Tensor) -> torch.Tensor:
    """Fixed-point value of x, in x's float dtype (exact for |x/ε| < 2⁵³
    in float64)."""
    return torch.round(x / FIXPA_EPS)


def rev_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Reversible addition, elementwise on any shape."""
    return FIXPA_EPS * (nom(x) + nom(y))
