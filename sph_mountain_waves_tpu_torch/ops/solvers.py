"""Preconditioned conjugate gradients for the matrix-free ISPH pressure solve.

Port of ``pcg`` from ``sph_mountain_waves_tpu/ops/solvers.py``: the same
algorithm, stopping rule and observables. The reference runs it as one
``lax.while_loop`` on the device; PyTorch runs eagerly, so the loop is a
Python loop whose stop test is read on the host once per iteration (one
host sync each). Every other quantity (α, γ, the dot products and the
vectors) stays on the tensors' device.

Not ported yet: the ``axis=`` branch (psummed dots inside a sharded solve,
with multi-GPU), ``assemble_matvec``, ``assemble_matrix*`` and ``cg_solve``
(the flat layout).
"""
from __future__ import annotations

import torch

__all__ = ["pcg"]


def _dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Σ a·c as a 0-d tensor on the vectors' device."""
    return torch.sum(a * c)


def pcg(matvec, b: torch.Tensor, x0: torch.Tensor | None = None, M=None,
        tol: float = 1e-6, atol: float = 1e-18, maxiter: int = 500,
        return_info: bool = False):
    """Preconditioned CG on ``matvec`` (SPD) from ``x0`` (default 0), with
    the preconditioner apply ``M`` (default the identity).

    Iterates while ‖r‖² > max(tol²·‖b‖², atol²) and fewer than ``maxiter``
    iterations have run; the atol floor stops a zero right-hand side at once
    (CG on a zero residual divides 0 by 0). With ``return_info=True``
    returns ``(x, iters, rel_res)``: the iteration count as a Python int and
    the final relative residual ‖r‖/‖b‖ as a 0-d tensor."""
    x = torch.zeros_like(b) if x0 is None else x0
    Mfn = M if M is not None else (lambda v: v)
    r = b - matvec(x)
    z = Mfn(r)
    p = z
    gamma = _dot(r, z)
    bb = _dot(b, b)
    thresh = torch.clamp(tol * tol * bb, min=atol * atol)
    rr = _dot(r, r)
    k = 0
    while k < maxiter and bool(rr > thresh):  # the one host read
        Ap = matvec(p)
        alpha = gamma / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = Mfn(r)
        gamma2 = _dot(r, z)
        p = z + (gamma2 / gamma) * p
        gamma = gamma2
        k += 1
        rr = _dot(r, r)
    if not return_info:
        return x
    floor = 1e-300 if bb.dtype == torch.float64 else 1e-30
    return x, k, torch.sqrt(rr / torch.clamp(bb, min=floor))
