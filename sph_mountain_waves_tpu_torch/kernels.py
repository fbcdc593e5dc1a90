"""SPH smoothing kernels: the quintic Wendland family in 1-D, 2-D and 3-D,
and the 2-D cubic and quartic splines.

Port of ``sph_mountain_waves_tpu/kernels.py``, every function of it, with
the same operations in the same order. Every kernel is normalized so that
its support radius is ``h``; ``D`` is the radial derivative dw/dr, ``rD``
the reduced derivative (dw/dr)/r, finite at r=0, and ``DDwendland3`` the
second radial derivative. Functions are branchless and elementwise on
tensors; ``h`` may be a tensor (per-pair smoothing lengths).
"""
from __future__ import annotations

import torch

__all__ = ["wendland1", "Dwendland1", "rDwendland1",
           "wendland2", "Dwendland2", "rDwendland2",
           "wendland3", "Dwendland3", "rDwendland3", "DDwendland3",
           "spline23", "Dspline23", "rDspline23",
           "spline24", "Dspline24", "rDspline24",
           "C_W2", "C_DW2", "C_W3", "C_DW3", "C_SPLINE23", "C_DSPLINE23"]

C_W2 = 2.228169203286535              # 7/pi
C_DW2 = 44.563384065730695            # 140/pi
C_W3 = 3.3422538049298023             # 21/(2 pi)
C_DW3 = 66.84507609859604             # 210/pi
C_SPLINE23 = 1.8189136353359467       # 40/(7 pi)
C_DSPLINE23 = 10.91348181201568       # 240/(7 pi)
C_SPLINE24 = 6.222175110452539
C_DSPLINE24 = 24.888700441810155


def _pos(x):
    """max(x, 0)."""
    return torch.clamp(x, min=0.0)


def wendland1(h, r):
    """1-D quintic Wendland kernel value."""
    x = r / h
    t = _pos(1.0 - x)
    return 1.5 * t**4 * (1.0 + 4.0 * x) / h


def Dwendland1(h, r):
    """dw/dr of wendland1."""
    x = r / h
    t = _pos(1.0 - x)
    return -30.0 * x * t**3 / h**2


def rDwendland1(h, r):
    """(dw/dr)/r of wendland1, finite at r=0."""
    x = r / h
    t = _pos(1.0 - x)
    return -30.0 * t**3 / h**3


def wendland2(h, r):
    """2-D quintic Wendland kernel value."""
    x = r / h
    t = _pos(1.0 - x)
    return C_W2 * t**4 * (1.0 + 4.0 * x) / h**2


def Dwendland2(h, r):
    """dw/dr of wendland2."""
    x = r / h
    t = _pos(1.0 - x)
    return -C_DW2 * x * t**3 / h**3


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


def Dwendland3(h, r):
    """dw/dr of wendland3."""
    x = r / h
    t = _pos(1.0 - x)
    return -C_DW3 * x * t**3 / h**4


def rDwendland3(h, r):
    """(dw/dr)/r of wendland3, finite at r=0."""
    x = r / h
    t = _pos(1.0 - x)
    return -C_DW3 * t**3 / h**5


def DDwendland3(h, r):
    """Second radial derivative of wendland3 (the surface-tension
    example's)."""
    x = r / h
    t = _pos(1.0 - x)
    return -C_DW3 * (1.0 - 4.0 * x) * t**2 / h**5


def spline23(h, r):
    """2-D cubic spline value."""
    x = r / h
    inner = C_SPLINE23 * (1.0 - 6.0 * x**2 + 6.0 * x**3)
    outer = 2.0 * C_SPLINE23 * _pos(1.0 - x) ** 3
    return torch.where(x < 0.5, inner, outer) / h**2


def Dspline23(h, r):
    """dw/dr of spline23."""
    x = r / h
    inner = -C_DSPLINE23 * (2.0 * x - 3.0 * x**2)
    outer = -C_DSPLINE23 * _pos(1.0 - x) ** 2
    return torch.where(x < 0.5, inner, outer) / h**3


def rDspline23(h, r):
    """(dw/dr)/r of spline23, finite at r=0. The outer branch's 1/x is
    guarded (x ≥ 0.5); below that the inner polynomial is selected, so the
    guarded value is never used."""
    x = r / h
    inner = -C_DSPLINE23 * (2.0 - 3.0 * x)
    x_safe = torch.clamp(x, min=0.5)
    outer = -C_DSPLINE23 * _pos(1.0 - x) ** 2 / x_safe
    return torch.where(x < 0.5, inner, outer) / h**4


def spline24(h, r):
    """2-D quartic spline value."""
    x = r / h
    return C_SPLINE24 * (
        _pos(1.0 - x) ** 4 - 5.0 * _pos(0.6 - x) ** 4 + 10.0 * _pos(0.2 - x) ** 4
    ) / h**2


def Dspline24(h, r):
    """dw/dr of spline24."""
    x = r / h
    return -C_DSPLINE24 * (
        _pos(1.0 - x) ** 3 - 5.0 * _pos(0.6 - x) ** 3 + 10.0 * _pos(0.2 - x) ** 3
    ) / h**3


def rDspline24(h, r):
    """(dw/dr)/r of spline24, finite at r=0. The outer branch's 1/x is
    guarded (x ≥ 0.2); below that the inner polynomial is selected."""
    x = r / h
    x_safe = torch.clamp(x, min=0.2)
    outer = -C_DSPLINE24 * (_pos(1.0 - x) ** 3 - 5.0 * _pos(0.6 - x) ** 3) / x_safe
    inner = -C_DSPLINE24 * (1.2 - 6.0 * x**2)
    return torch.where(x > 0.2, outer, inner) / h**4
