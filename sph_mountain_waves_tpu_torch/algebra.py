"""Small-vector and small-matrix algebra on tensors.

Port of ``sph_mountain_waves_tpu/algebra.py``: the vector and matrix
constructors (``RealVector``, ``RealMatrix`` (3×3), ``FlatMatrix`` (2×2),
column-major), the axis constants (``VECX`` … ``FMAT1``) and the batched
helpers ``dot``, ``norm``, ``outer``, ``trace``, ``dev``, ``det``,
``trans``, ``cof`` and ``inv``. Every helper accepts tensors with any
leading batch dimensions, as the fields ``[N, ...]`` of a state are.

The constants are host NumPy arrays in float64. A helper given a tensor
and a non-tensor operand (a constant, a NumPy array, a Python number)
builds the non-tensor one in the tensor's dtype and on its device; a
constructor given only Python numbers builds float64, never the float32
default of ``torch.tensor``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "RealVector", "RealMatrix", "FlatMatrix",
    "VECX", "VECY", "VECZ", "VEC0", "MAT0", "MAT1", "FMAT0", "FMAT1",
    "dot", "norm", "trace", "dev", "det", "trans", "cof", "inv", "outer",
]

# axis constants, float64 on the host: each takes the dtype and device of
# the tensor it meets in a helper
VECX = np.array([1.0, 0.0, 0.0])
VECY = np.array([0.0, 1.0, 0.0])
VECZ = np.array([0.0, 0.0, 1.0])
VEC0 = np.array([0.0, 0.0, 0.0])
MAT0 = np.zeros((3, 3))
MAT1 = np.eye(3)
FMAT0 = np.zeros((2, 2))
FMAT1 = np.eye(2)


def _like(*xs):
    """The operands as tensors: each non-tensor one built in the dtype and
    on the device of the first tensor operand (float64 on the CPU when
    there is none)."""
    ref = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    dtype = torch.float64 if ref is None else ref.dtype
    device = None if ref is None else ref.device
    return tuple(x if isinstance(x, torch.Tensor)
                 else torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
                 for x in xs)


def RealVector(*xs):
    """3-vector from its components (``RealVector(x, y)`` pads the third
    with zero, the 2-D usage); one argument is taken as the vector itself.
    Components may be batched tensors: the result is [..., 3]."""
    if len(xs) == 1:
        return _like(xs[0])[0]
    if len(xs) == 2:
        xs = (*xs, 0.0)
    return torch.stack(torch.broadcast_tensors(*_like(*xs)), dim=-1)


def _column_major(entries, d):
    cols = torch.stack(torch.broadcast_tensors(*_like(*entries)), dim=-1)
    return cols.reshape(tuple(cols.shape[:-1]) + (d, d)).transpose(-1, -2)


def RealMatrix(*entries):
    """3×3 matrix from 9 entries in column-major order
    (``RealMatrix(a11, a21, a31, a12, ...)``); one argument is taken as the
    matrix itself."""
    if len(entries) == 1:
        return _like(entries[0])[0]
    assert len(entries) == 9
    return _column_major(entries, 3)


def FlatMatrix(*entries):
    """2×2 matrix from 4 entries in column-major order."""
    if len(entries) == 1:
        return _like(entries[0])[0]
    assert len(entries) == 4
    return _column_major(entries, 2)


def _square(a) -> bool:
    return a.ndim >= 2 and a.shape[-2] == a.shape[-1]


def dot(a, b):
    """Vector·vector or, for square trailing matrices of one shape, the
    Frobenius product M:N, batched over the leading axes."""
    a, b = _like(a, b)
    if _square(a) and b.ndim >= 2 and a.shape[-2:] == b.shape[-2:]:
        return torch.sum(a * b, dim=(-2, -1))
    return torch.sum(a * b, dim=-1)


def norm(a):
    """Euclidean norm over the trailing vector axis, or the Frobenius norm
    of trailing 2×2 / 3×3 matrices."""
    (a,) = _like(a)
    if _square(a) and a.shape[-1] in (2, 3):
        return torch.sqrt(torch.sum(a * a, dim=(-2, -1)))
    return torch.sqrt(torch.sum(a * a, dim=-1))


def outer(a, b):
    """Outer product a ⊗ b over the trailing axes."""
    a, b = _like(a, b)
    return a[..., :, None] * b[..., None, :]


def trace(m):
    """tr(M) over the trailing two axes."""
    (m,) = _like(m)
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(dim=-1)


def dev(m):
    """Deviatoric part M − tr(M)/d · I."""
    (m,) = _like(m)
    d = m.shape[-1]
    return m - (trace(m) / d)[..., None, None] * torch.eye(
        d, dtype=m.dtype, device=m.device)


def det(m):
    """Determinant of the trailing square matrices."""
    return torch.linalg.det(_like(m)[0])


def trans(m):
    """Transpose over the trailing two axes."""
    return _like(m)[0].transpose(-1, -2)


def cof(m):
    """Cofactor matrix: det(M) · inv(M)ᵀ."""
    (m,) = _like(m)
    return det(m)[..., None, None] * trans(torch.linalg.inv(m))


def inv(m):
    """Inverse of the trailing square matrices."""
    return torch.linalg.inv(_like(m)[0])
