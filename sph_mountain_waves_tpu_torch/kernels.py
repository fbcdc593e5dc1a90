"""SPH smoothing kernels (2-D and 3-D quintic Wendland).

Port of ``sph_mountain_waves_tpu/kernels.py``, cut to the family the
mountain-wave and dam-break schemes use. Every kernel is normalized so that its support
radius is ``h``; ``rD`` is the reduced derivative (dw/dr)/r, finite at r=0.
Functions are branchless and elementwise on tensors; ``h`` may be a tensor
(per-pair smoothing lengths).
"""
from __future__ import annotations

import torch

__all__ = ["wendland2", "rDwendland2", "wendland3", "rDwendland3",
           "C_W2", "C_DW2", "C_W3", "C_DW3"]

C_W2 = 2.228169203286535              # 7/pi
C_DW2 = 44.563384065730695            # 140/pi
C_W3 = 3.3422538049298023             # 21/(2 pi)
C_DW3 = 66.84507609859604             # 210/pi


def _pos(x):
    """max(x, 0)."""
    return torch.clamp(x, min=0.0)


def wendland2(h, r):
    """2-D quintic Wendland kernel value."""
    x = r / h
    t = _pos(1.0 - x)
    return C_W2 * t**4 * (1.0 + 4.0 * x) / h**2


def rDwendland2(h, r):
    """(dw/dr)/r of wendland2, finite at r=0."""
    x = r / h
    t = _pos(1.0 - x)
    return -C_DW2 * t**3 / h**4


def wendland3(h, r):
    """3-D quintic Wendland kernel value."""
    x = r / h
    t = _pos(1.0 - x)
    return C_W3 * t**4 * (1.0 + 4.0 * x) / h**3


def rDwendland3(h, r):
    """(dw/dr)/r of wendland3, finite at r=0."""
    x = r / h
    t = _pos(1.0 - x)
    return -C_DW3 * t**3 / h**5
