"""RKPM kernel correction (reproducing-kernel particle method).

Port of ``sph_mountain_waves_tpu/utils/rkpm.py``: per-particle quadratic
moment matrices assembled by one pair sum, batched solves
(``torch.linalg.solve``) and a corrected-kernel pair sum

    W~(p, q) = (beta_p . H(x_p - x_q)) W(p.h, r),
    beta_p   = M_p^{-1} e_0,
    M_p      = sum_q (m_q/rho_q) H H^T W(p.h, r),

which reproduces polynomials up to degree 2 exactly, also where the plain
kernel sum loses partition of unity (free surfaces, walls).

Basis (2-D, quadratic): H = [1, dx, dy, dx^2, dy^2, dx dy]; 3-D: the ten
monomials up to degree 2. Every sum is ``ops/apply.py::pair_sum`` with the
self pair, so the module runs on the flat layout, in float32 or float64,
on the state's device.
"""
from __future__ import annotations

import torch

from ..kernels import wendland2, wendland3
from ..ops.apply import pair_sum
from ..structs import ParticleState

__all__ = ["moment_matrix", "correction_vector", "corrected_sum",
           "laplacian_vector", "corrected_laplacian", "NB"]

NB = {2: 6, 3: 10}  # quadratic basis size per dimension


def _basis(dx_axes):
    """Quadratic monomial basis of the pair offset: [..., NB[dim]]."""
    one = torch.ones_like(dx_axes[0])
    if len(dx_axes) == 2:
        dx, dy = dx_axes
        cols = [one, dx, dy, dx * dx, dy * dy, dx * dy]
    else:
        dx, dy, dz = dx_axes
        cols = [one, dx, dy, dz, dx * dx, dy * dy, dz * dz,
                dx * dy, dx * dz, dy * dz]
    return torch.stack(cols, dim=-1)


def _default_vol(q):
    return q.m / torch.clamp(q.rho, min=1e-30)


def _pair_terms(engine, state, scaled, include_q, vol_of):
    """p, q, r → (H, vol_q·W(p.h, r)) of a pair: H of the offset (divided
    by p's h when ``scaled``), the weight zero where q is not in
    ``include_q`` (read from the ``_rk_inc`` field). p's h is the ``h``
    field, else the engine's."""
    d = engine.dim
    w = wendland2 if d == 2 else wendland3
    has_h = "h" in state.fields

    def terms(p, q, r):
        ph = p.h if has_h else engine.h
        dxs = [p.x[..., a] - q.x[..., a] for a in range(d)]
        H = _basis([dx / ph for dx in dxs] if scaled else dxs)
        wt = vol_of(q) * w(ph, r)
        if include_q is not None:
            wt = wt * q._rk_inc
        return H, wt

    return terms


def _moments(engine, state, nbrs, scaled, include_q, vol_of):
    """M_p = Σ_q vol_q·H H^T·W(p.h, r), [N, nb, nb]."""
    nb = NB[engine.dim]
    if include_q is not None:
        state = ParticleState(fields={**state.fields, "_rk_inc": include_q.to(
            state.fields["x"].dtype)}, active=state.active)
    terms = _pair_terms(engine, state, scaled, include_q, vol_of)

    def func(p, q, r):
        H, wt = terms(p, q, r)
        HH = H[..., :, None] * H[..., None, :]
        return (HH * wt[..., None, None]).reshape(HH.shape[:-2] + (nb * nb,))

    M = pair_sum(engine, state, nbrs, func, self_interaction=True)
    return M.reshape(-1, nb, nb)


def _corrected(engine, state, nbrs, values, beta, scaled, include_q, vol_of):
    """Σ_q vol_q·values_q·(β_p·H)·W(p.h, r), [N]."""
    fields = {**state.fields, "_rk_beta": beta,
              "_rk_val": torch.as_tensor(values, dtype=beta.dtype,
                                         device=beta.device)}
    if include_q is not None:
        fields["_rk_inc"] = include_q.to(beta.dtype)
    st = ParticleState(fields=fields, active=state.active)
    terms = _pair_terms(engine, state, scaled, include_q, vol_of)

    def func(p, q, r):
        H, wt = terms(p, q, r)
        return q._rk_val * wt * torch.sum(p._rk_beta * H, dim=-1)

    return pair_sum(engine, st, nbrs, func, self_interaction=True)


def _regularised_solve(M: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Solve M·β = F row by row: a row whose M[0, 0] is below 1e-30 (no
    neighbour, or an empty row) takes the identity, and every M gets a
    trace-relative ridge of 1e-7 that keeps rank-deficient neighbourhoods
    finite."""
    nb = M.shape[-1]
    eye = torch.eye(nb, dtype=M.dtype, device=M.device)
    M = torch.where((M[:, 0, 0] < 1e-30)[:, None, None], eye, M)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    M = M + (1e-7 * tr / nb)[:, None, None] * eye
    return torch.linalg.solve(M, F[..., None]).squeeze(-1)


def moment_matrix(engine, state: ParticleState, nbrs) -> torch.Tensor:
    """Per-particle moment matrix M_p = Σ_q (m_q/ρ_q)·H H^T·W(p.h, r),
    [N, nb, nb]."""
    return _moments(engine, state, nbrs, False, None, _default_vol)


def correction_vector(engine, state: ParticleState, nbrs) -> torch.Tensor:
    """β_p = M_p^{-1} e_0, [N, nb]. Inactive and isolated rows get the
    identity moment matrix (β = e_0: the uncorrected kernel)."""
    M = moment_matrix(engine, state, nbrs)
    F = torch.zeros(M.shape[:2], dtype=M.dtype, device=M.device)
    F[:, 0] = 1.0
    return _regularised_solve(M, F)


def corrected_sum(engine, state: ParticleState, nbrs, values,
                  beta: torch.Tensor | None = None) -> torch.Tensor:
    """Σ_q (m_q/ρ_q)·values_q·W~(p, q) with the corrected kernel: exact for
    any polynomial field of degree ≤ 2, boundaries included. ``beta``
    (default ``correction_vector``) sets the correction."""
    if beta is None:
        beta = correction_vector(engine, state, nbrs)
    beta = torch.as_tensor(beta, device=state.active.device)
    return _corrected(engine, state, nbrs, values, beta, False, None,
                      _default_vol)


def laplacian_vector(engine, state: ParticleState, nbrs, include_q=None,
                     vol_of=None) -> torch.Tensor:
    """β_L = M_p^{-1}·F_L with F_L selecting ∇²: the reproduction conditions
    Σ c·H = [0, 0, 0, 2, 2, 0] (2-D; 3-D: 2 on the three squares) make
    Σ_q c_q·T_q = ∇²T|_p exact for any quadratic T, one-sided
    neighbourhoods included. ``include_q`` ([N] bool) restricts the
    neighbourhood of the moment matrix and of the sum alike; ``vol_of``:
    q-view → particle volume (default m/ρ). The basis is scaled by h, so M
    is O(1) and its float32 solve stays accurate; the targets are 2/h²."""
    M = _moments(engine, state, nbrs, True, include_q,
                 vol_of or _default_vol)
    hs = state.fields.get("h")
    h2 = (hs.to(M.dtype) ** 2 if hs is not None
          else torch.tensor(engine.h, dtype=M.dtype, device=M.device) ** 2)
    F = torch.zeros((M.shape[0], M.shape[-1]), dtype=M.dtype,
                    device=M.device)
    for k in ((3, 4) if engine.dim == 2 else (4, 5, 6)):
        F[:, k] = 2.0 / h2
    return _regularised_solve(M, F)


def corrected_laplacian(engine, state: ParticleState, nbrs, values,
                        include_q=None, vol_of=None) -> torch.Tensor:
    """∇²values|_p = Σ_q vol_q·values_q·(β_L·H~_pq)·W(p.h, r), the
    quadratic-consistent Laplacian of ``laplacian_vector`` (H~ the h-scaled
    basis): exact for quadratic fields everywhere, boundaries included."""
    vol_of = vol_of or _default_vol
    beta_L = laplacian_vector(engine, state, nbrs, include_q, vol_of)
    return _corrected(engine, state, nbrs, values, beta_L, True, include_q,
                      vol_of)
