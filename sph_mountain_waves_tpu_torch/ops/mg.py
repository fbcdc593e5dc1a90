"""Two-level / multigrid preconditioning for the ISPH pressure-Poisson solve.

Port of the 2-D part of ``sph_mountain_waves_tpu/ops/mg.py``. With the
piecewise-constant-per-cell aggregation P (P[i, c] = 1 iff particle i lives
in cell c), the Galerkin coarse operator Pᵀ A P of the SPH Poisson matrix is
a 9-point stencil on the [ny, nx] bucket cell grid, because A couples only
particles within one cell of each other. One windowed pair sum over the
resident layout gives its weights (``coarse_stencil_2d``); coarser levels
sum 2×2 blocks (``_coarsen_stencil``), and a geometric V-cycle with
weighted-Jacobi smoothing (``GridVcycle``) approximates its inverse. Two
symmetric compositions of the coarse correction B = P·Vcycle(·)·Pᵀ with
Jacobi are offered (``two_level_preconditioner``):

    additive  ("add"):   M⁻¹ = B + D⁻¹                    (no extra matvec)
    symmetric ("mult"):  x₁ = D⁻¹r; x₂ = x₁ + B(r − A x₁);
                         M⁻¹r = x₂ + D⁻¹(r − A x₂)        (2 extra matvecs)

All of it is plain PyTorch, elementwise, in the dtype of its inputs (the
SPD gate runs in float64; the models run float32). Nothing contracts field
values through a matmul or an einsum. Each level's stencil is kept as a
contiguous [ny, nx, 9] tensor (tap t = 3·(dj+1) + (di+1)), built once per
solve, so that one stencil apply is one pad, one windowed view of the
padded grid and a multiply-and-sum over the taps (four launches). The
reference adds the taps one after another; the sum over the tap axis here
rounds differently in the last bit.

Not ported yet: ``coarse_stencil_3d`` and the 3-D V-cycle (no 3-D caller
on the ported paths).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["coarse_stencil_2d", "GridVcycle", "two_level_preconditioner"]

_OFFSETS_2D = [(di, dj) for dj in (-1, 0, 1) for di in (-1, 0, 1)]


def coarse_stencil_2d(engine, state, offdiag_w, diag):
    """Galerkin coarse matrix of A on the bucket cell grid, as ``W`` of
    shape [3, 3, ny, nx] (the reference's layout) with

        (A_c u)[c] = Σ_off W[1+dj, 1+di, c] · u[c + (di, dj)],

    W[1+dj, 1+di, c] = Σ_{i∈c, j∈c+off} A_ij and the particle diagonal summed
    into the centre tap. ``A_ij = offdiag_w(r_ij)`` for i ≠ j within the
    cutoff ``engine.h``; ``diag`` is the flat [slots] particle diagonal,
    zero on inactive rows. One [cap, cap, C] pair sum per offset."""
    if engine.dim != 2:
        raise NotImplementedError("coarse_stencil_2d: 2-D bucket grids only")
    nx, ny = engine.lims
    cap, C = engine.cap, engine.num_cells
    x = state.fields["x"]
    dtype = x.dtype
    h = torch.tensor(engine.h, dtype=dtype, device=x.device)

    Xr = engine.resident(x)                          # [cap, C+1, 2]
    Ar = engine.resident(state.active)               # [cap, C+1]
    Xp, Ap = Xr[:, :C], Ar[:, :C]                    # p side: own cell
    Xpad, Apad = engine.pad_resident(Xr), engine.pad_resident(Ar)
    eye = torch.eye(cap, dtype=torch.bool, device=x.device)[:, :, None]
    taps = []
    for off in _OFFSETS_2D:
        Xq = engine.slice_resident(Xpad, off)        # [cap, C, 2]
        Aq = engine.slice_resident(Apad, off)        # [cap, C]
        d = Xp[:, None] - Xq[None, :]                # [cap, cap, C, 2]
        r = torch.sqrt(torch.sum(d * d, dim=-1))
        mask = Ap[:, None] & Aq[None, :] & (r <= h)
        if off == (0, 0):
            mask = mask & ~eye                       # i == j is in diag
        w = torch.where(mask, offdiag_w(torch.where(mask, r, 2.0 * h)), 0.0)
        taps.append(torch.sum(w, dim=(0, 1)))        # [C]
    W = torch.stack(taps, dim=0).reshape(3, 3, C)
    W[1, 1] += torch.sum(engine.resident(diag)[:, :C], dim=0)
    return W.reshape(3, 3, ny, nx).to(dtype)


def _taps_last(W: torch.Tensor) -> torch.Tensor:
    """[3, 3, ny, nx] stencil → contiguous [ny, nx, 9], tap 3·(dj+1)+(di+1)."""
    return W.reshape(9, *W.shape[2:]).permute(1, 2, 0).contiguous()


def _stencil_apply(Wt: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(A_c u) for a [ny, nx, 9] stencil and a [ny, nx] grid vector: one
    pad, the 3×3 windows of the padded grid, a multiply-and-sum over the
    taps."""
    win = F.pad(u, (1, 1, 1, 1)).unfold(0, 3, 1).unfold(1, 3, 1)
    return torch.sum(Wt * win.reshape(Wt.shape), dim=-1)


def _coarsen_stencil(W: torch.Tensor) -> torch.Tensor:
    """Galerkin coarsening of a [3, 3, ny, nx] stencil under 2×2 PWC
    aggregation: fine cell (2J+b, 2I+a) reaching offset (dj, di) lands in
    coarse block (J + (b+dj)//2, I + (a+di)//2), still a 9-point stencil.
    Odd grids are padded with empty cells, which couple to nothing. Each
    coarse tap sums its fine contributions in the reference's order."""
    ny, nx = W.shape[2:]
    ny2, nx2 = (ny + 1) // 2, (nx + 1) // 2
    Wp = F.pad(W, (0, 2 * nx2 - nx, 0, 2 * ny2 - ny))
    fine = Wp.reshape(3, 3, ny2, 2, nx2, 2)
    out = torch.zeros((3, 3, ny2, nx2), dtype=W.dtype, device=W.device)
    for oy, ox in ((oy, ox) for oy in (-1, 0, 1) for ox in (-1, 0, 1)):
        for sy, sx in ((sy, sx) for sy in (0, 1) for sx in (0, 1)):
            out[1 + (sy + oy) // 2, 1 + (sx + ox) // 2] += (
                fine[1 + oy, 1 + ox, :, sy, :, sx])
    return out


class GridVcycle:
    """Geometric V-cycle for a 9-point stencil hierarchy on the 2-D cell
    grid.

    ``GridVcycle(W)`` builds the Galerkin hierarchy of a [3, 3, ny, nx]
    stencil once (coarsening while the grid's short side exceeds 4, at most
    ``levels`` levels) and keeps each level as [ny, nx, 9] with its scaled
    inverse diagonal ω/W_centre (zero where the centre is ~0: empty cells
    pass their residual through scaled). ``apply(r)`` runs one V(nu, nu)
    cycle from a zero initial guess, with ``coarse_iters`` smoothing sweeps
    on the coarsest level: a fixed linear operator, so a valid CG
    preconditioner."""

    def __init__(self, W: torch.Tensor, levels: int | None = None,
                 nu: int = 2, omega: float = 0.7, coarse_iters: int = 24):
        if W.ndim != 4:
            raise NotImplementedError("GridVcycle: 2-D stencils only")
        self.nu, self.omega, self.coarse_iters = nu, omega, coarse_iters
        Ws = [W]
        maxl = 32 if levels is None else levels
        while len(Ws) < maxl and min(W.shape[2:]) > 4:
            W = _coarsen_stencil(W)
            Ws.append(W)
        self.Wts = [_taps_last(Wl) for Wl in Ws]
        self.omdinvs = []
        for Wl in Ws:
            d = Wl[1, 1]
            dinv = torch.where(torch.abs(d) > 1e-30, 1.0 / d, 0.0)
            self.omdinvs.append(omega * dinv)

    @property
    def n_levels(self) -> int:
        return len(self.Wts)

    def _smooth(self, l, u, b, iters):
        Wt, omdinv = self.Wts[l], self.omdinvs[l]
        for _ in range(iters):
            u = u + omdinv * (b - _stencil_apply(Wt, u))
        return u

    def _cycle(self, l, b):
        u = self.omdinvs[l] * b                      # zero-guess pre-smooth
        if l == len(self.Wts) - 1:
            return self._smooth(l, u, b, self.coarse_iters)
        u = self._smooth(l, u, b, self.nu - 1)
        r = b - _stencil_apply(self.Wts[l], u)
        ny, nx = r.shape
        ny2, nx2 = self.Wts[l + 1].shape[:2]
        rp = F.pad(r, (0, 2 * nx2 - nx, 0, 2 * ny2 - ny))
        rc = rp.reshape(ny2, 2, nx2, 2).sum(dim=(1, 3))      # PWC restrict
        ec = self._cycle(l + 1, rc)
        ef = ec[:, None, :, None].expand(ny2, 2, nx2, 2).reshape(
            2 * ny2, 2 * nx2)
        u = u + ef[:ny, :nx]                                 # PWC prolong
        return self._smooth(l, u, b, self.nu)

    def apply(self, r: torch.Tensor) -> torch.Tensor:
        return self._cycle(0, r)


def two_level_preconditioner(engine, state, offdiag_w, diag, matvec,
                             diag_safe, mode: str = "add", **vkw):
    """M⁻¹ for the ISPH pressure CG: the coarse V-cycle correction on the
    bucket cell grid combined with Jacobi (the module docstring gives the
    two compositions). ``matvec`` must be the operator CG solves with
    (active-masked); ``mode`` is "add" or "mult". The stencil hierarchy is
    built here, once per solve. Returns the apply."""
    if mode not in ("add", "mult"):
        raise ValueError(f"mode must be 'add' or 'mult', got {mode!r}")
    W = coarse_stencil_2d(engine, state, offdiag_w, diag)
    vc = GridVcycle(W, **vkw)
    cap, C = engine.cap, engine.num_cells
    grid = engine.grid_shape
    act = state.active

    def coarse(r):
        rc = torch.sum(engine.resident(torch.where(act, r, 0.0))[:, :C],
                       dim=0).reshape(grid)
        ec = F.pad(vc.apply(rc).reshape(C), (0, 1))
        return torch.where(act, ec.expand(cap, C + 1).reshape(-1), 0.0)

    if mode == "add":
        def apply(r):
            return coarse(r) + r / diag_safe
    else:
        def apply(r):
            x = r / diag_safe
            x = x + coarse(r - matvec(x))
            return x + (r - matvec(x)) / diag_safe

    return apply
