"""Sparse-operator layer: the matrix-free stencil operators of the flat
layout and conjugate gradients for the pressure-Poisson solves.

Port of ``sph_mountain_waves_tpu/ops/solvers.py``:

* ``assemble_vector(state, func)``: a pointwise evaluation, zero on
  inactive rows;
* ``assemble_matvec(engine, state, nbrs, coeff)``: the linear operator
  ``v ↦ A·v`` with ``A_ij = coeff(p_i, q_j, r_ij)`` for ``r_ij ≤ h``, the
  diagonal ``i = j`` included unless ``include_self=False``; one gather of
  ``v`` per application, the coefficients computed once;
* ``assemble_matrix`` (dense, for small systems) and
  ``assemble_matrix_bcoo`` (a ``torch.sparse_coo_tensor`` with the
  reference's fixed pattern) for callers that want the matrix itself;
* ``pcg`` (preconditioned CG with its iteration count and residual) and
  ``cg_solve`` (the same solve, the solution only).

The operators run on the flat layout (``engine.layout == "flat"``), in plain
PyTorch on the state's device, as the reference's XLA code does; the bucket
layout's ISPH solve takes its CG matvec from the CUDA sweep
(``ops/pair_sweeps.py::isph_matvec_prepared``). The reference runs CG as one
``lax.while_loop`` on the device; PyTorch runs eagerly, so the loop is a
Python loop whose stop test is read on the host once per iteration (one
host sync each). Every other quantity (α, γ, the dot products and the
vectors) stays on the tensors' device.

Not ported: ``pcg``'s ``axis=`` branch (dot products summed across devices
inside a sharded solve), which belongs to the multi-GPU slice.
"""
from __future__ import annotations

import torch

from ..structs import ParticleState
from .apply import FieldsView, _largest_count, dist

__all__ = ["assemble_vector", "assemble_matvec", "cg_solve", "pcg",
           "assemble_matrix", "assemble_matrix_bcoo"]


def assemble_vector(state: ParticleState, func, **params) -> torch.Tensor:
    """v_i = func(p_i) over the state, zero on inactive rows."""
    v = func(FieldsView(state.fields), **params)
    return torch.where(state.active, v, 0.0)


def _stencil_terms(engine, state: ParticleState, nbrs, include_self: bool,
                   ranks: int):
    """Every row's candidates at every stencil offset in one block:
    (cand, mask, r_safe), each [N, S·ranks] (offset-major, the first
    ``ranks`` ranks of each offset's cell). The pair mask keeps occupied
    slots with r ≤ h on active rows and, unlike ``apply_binary``, keeps
    i == j when ``include_self``; masked pairs have r presented as 2h."""
    x = state.fields["x"]
    n, S = x.shape[0], len(engine.stencil)
    h = torch.tensor(engine.h, dtype=x.dtype, device=x.device)
    cand, valid = engine.stencil_candidates(nbrs, engine.stencil)
    cand = cand[:, :, :ranks].reshape(n, S * ranks)
    valid = valid[:, :, :ranks].reshape(n, S * ranks)
    r = dist(x[:, None, :], x[cand.long()])
    mask = valid & (r <= h) & state.active[:, None]
    if not include_self:
        rows = torch.arange(n, dtype=cand.dtype, device=x.device)
        mask = mask & (cand != rows[:, None])
    return cand, mask, torch.where(mask, r, 2.0 * h)


def _coefficients(engine, state, nbrs, coeff, include_self, ranks, params):
    """(cand, mask, a): the stencil block and its coefficients
    ``coeff(p, q, r)`` [N, S·ranks], zeroed by selection where masked."""
    cand, mask, r_safe = _stencil_terms(engine, state, nbrs, include_self,
                                        ranks)
    pview = FieldsView(state.fields, expand=True)
    qview = FieldsView(state.fields, idx=cand.long())
    a = torch.broadcast_to(coeff(pview, qview, r_safe, **params), mask.shape)
    return cand, mask, torch.where(mask, a, 0.0)


def assemble_matvec(engine, state: ParticleState, nbrs, coeff,
                    include_self: bool = True, **params):
    """Return ``matvec(v) = A·v`` with ``A_ij = coeff(p_i, q_j, r_ij)`` for
    r ≤ h (zero beyond), rows and columns of inactive particles zero.

    ``coeff(p, q, r)`` follows the binary-action shape convention and
    returns [N, K]. The coefficients are computed once, masked pairs zeroed
    by selection, and cut to the largest cell occupancy k (ranks past it
    hold no particle: one host read); each application gathers v at the
    candidates and sums, as the reference does, each offset's Σ a·v[cand]
    and then the offsets in stencil order."""
    k = _largest_count(engine, nbrs)
    cand, _, a = _coefficients(engine, state, nbrs, coeff, include_self, k,
                               params)
    n, S = a.shape[0], len(engine.stencil)
    cand = cand.long()

    def matvec(v):
        per = torch.sum((a * v[cand]).reshape(n, S, k), dim=-1)
        out = per[:, 0]
        for o in range(1, S):
            out = out + per[:, o]
        return torch.where(state.active, out, 0.0)

    return matvec


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


def cg_solve(matvec, b: torch.Tensor, x0: torch.Tensor | None = None, M=None,
             tol: float = 1e-6, maxiter: int = 500) -> torch.Tensor:
    """(Preconditioned) conjugate gradients, the solution only.

    The reference wraps ``jax.scipy.sparse.linalg.cg``; its algorithm and
    stopping rule (‖r‖ ≤ max(tol·‖b‖, atol) with atol = 1e-18, so that a
    zero right-hand side returns x0 at once) are ``pcg``'s, so this is
    ``pcg`` without the iteration count and residual."""
    return pcg(matvec, b, x0=x0, M=M, tol=tol, atol=1e-18, maxiter=maxiter)


def assemble_matrix(engine, state: ParticleState, nbrs, coeff,
                    **params) -> torch.Tensor:
    """Dense [N, N] matrix with A_ij = coeff(p_i, q_j, r_ij) for r ≤ h, the
    diagonal included: for small systems and tests (production solves are
    matrix-free). The reference adds every stencil entry by a scatter-add,
    masked ones as exact zeros; on the flat layout each (i, j) pair occurs
    once among the unmasked entries (a row lies in one cell, reached by one
    offset), so writing those alone gives the same matrix with unique
    targets: no atomic adds, the same result on every run."""
    n = state.capacity
    cand, mask, a = _coefficients(engine, state, nbrs, coeff, True,
                                  _largest_count(engine, nbrs), params)
    rows = torch.arange(n, device=cand.device)[:, None].expand(cand.shape)
    A = torch.zeros((n, n), dtype=state.fields["x"].dtype,
                    device=cand.device)
    A[rows[mask], cand.long()[mask]] = a[mask]
    return A


def assemble_matrix_bcoo(engine, state: ParticleState, nbrs, coeff,
                         include_self: bool = True, **params):
    """The explicit sparse matrix as an uncoalesced ``torch.sparse_coo_tensor``
    [N, N] with the reference's fixed pattern and order: N·cap·|stencil|
    entries, offset-major, then row, then rank, a masked entry stored as 0
    at (i, i). Production solves should still prefer ``assemble_matvec``."""
    n, S, cap = state.capacity, len(engine.stencil), engine.cap
    cand, mask, a = _coefficients(engine, state, nbrs, coeff, include_self,
                                  cap, params)
    rows = torch.arange(n, device=cand.device)[:, None].expand(cand.shape)
    cols = torch.where(mask, cand.long(), rows)

    def offset_major(t):
        return t.reshape(n, S, cap).transpose(0, 1).reshape(-1)

    indices = torch.stack([offset_major(rows), offset_major(cols)])
    return torch.sparse_coo_tensor(indices, offset_major(a), (n, n),
                                   check_invariants=True)
