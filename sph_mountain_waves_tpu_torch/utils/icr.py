"""ICR: implicit consistency renormalization (host side).

Port of ``sph_mountain_waves_tpu/utils/icr.py``: a density-restoring
particle shift. Each Newton step solves a dense 3N×3N saddle-point system
(identity, gradient and divergence blocks) for the displacements that drive
the kernel-summation density Σ w(h, r) to the uniform target 1/dr² (2-D).
As the reference does, the density and its gradient are taken densely over
all pairs of active particles (the port's kernels on the host arrays)
and the system is solved by ``numpy.linalg.lstsq``: it is meant for small
systems (preparing an initial condition).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import rDwendland2, wendland2
from ..structs import ParticleState

__all__ = ["renormalize"]


def _pairs(x, h):
    d = x[:, None, :] - x[None, :, :]
    r = np.linalg.norm(d, axis=-1)
    mask = r <= h
    return d, r, mask


def _kernel(fn, h, r) -> np.ndarray:
    """A kernel function of the port on a host array (in its dtype)."""
    return fn(h, torch.from_numpy(r)).numpy()


def renormalize(engine, state: ParticleState, dr: float, tol: float = 1e-6,
                max_steps: int = 10, jitter: float = 0.3, seed: int = 0,
                verbose: bool = False, return_info: bool = False):
    """Shift the active particles so that Σ w(h, r) → 1/dr² (2-D): a host
    Newton iteration, after a seeded jitter of the positions. Returns the
    state with the new positions (in its dtype, on its device) and, with
    ``return_info``, ``{"errs": the residual history}``.

    Satisfying the uniform-density target pushes edge particles slightly
    outside the original shape, as the reference's shifts do."""
    h = engine.h
    rho0 = 1.0 / dr**2
    x_t = state.fields["x"]
    act = state.active.detach().cpu().numpy()
    x = x_t.detach().cpu().numpy().copy()
    rng = np.random.default_rng(seed)
    x[act] += jitter * dr * (rng.random(x[act].shape) - 1.0)
    idx = np.where(act)[0]
    N = len(idx)

    errs = []
    for it in range(max_steps + 1):
        xa = x[idx]
        d, r, mask = _pairs(xa, h)
        W = _kernel(wendland2, h, np.where(mask, r, 2 * h))
        W[~mask] = 0.0
        b = np.zeros(3 * N)
        b[2 * N:] = W.sum(axis=1) - rho0
        err = np.abs(b).max()
        errs.append(err)
        if verbose:
            print(f"ICR iter {it}: err = {err:.3e}")
        if err < tol or it == max_steps:
            break

        rD = _kernel(rDwendland2, h, np.where(mask, r, 2 * h))
        rD[~mask] = 0.0
        grad = rD[:, :, None] * d  # [N, N, 2]: the ∇W contributions
        S = -2.0 * grad.sum(axis=1)  # row sums

        A = np.zeros((3 * N, 3 * N))
        A[:N, :N] = np.eye(N)
        A[N:2 * N, N:2 * N] = np.eye(N)
        # upper right: Grad − ½δ·S; lower left: Div + ½δ·S
        A[:N, 2 * N:] = grad[:, :, 0] - 0.5 * np.diag(S[:, 0])
        A[N:2 * N, 2 * N:] = grad[:, :, 1] - 0.5 * np.diag(S[:, 1])
        A[2 * N:, :N] = grad[:, :, 0] + 0.5 * np.diag(S[:, 0])
        A[2 * N:, N:2 * N] = grad[:, :, 1] + 0.5 * np.diag(S[:, 1])

        y, *_ = np.linalg.lstsq(A, b, rcond=None)
        x[idx, 0] += y[:N]
        x[idx, 1] += y[N:2 * N]

    new_state = state.replace(x=torch.as_tensor(x, dtype=x_t.dtype,
                                                device=x_t.device))
    if return_info:
        return new_state, {"errs": errs}
    return new_state
