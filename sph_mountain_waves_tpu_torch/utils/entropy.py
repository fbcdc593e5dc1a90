"""Velocity-distribution entropy diagnostics (host side, NumPy).

Port of ``sph_mountain_waves_tpu/utils/entropy.py``, a copy of its NumPy:
the histogram of 2-D velocity norms, the Boltzmann entropy of a 2-D
Maxwell–Boltzmann histogram with the v = 0 singularity correction, and the
MB fit of the single parameter β by a bracketed golden-section search.
``velocity_histogram`` takes a raw ``[n, d]`` velocity array or a
``ParticleState`` (the port's, whose tensors it reads to the host, or any
state whose fields NumPy can read), from its active rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["KB", "Histogram", "velocity_histogram", "entropy_2D_MB",
           "fit_maxwell_boltzmann"]

KB = 1.380649e-23


@dataclasses.dataclass
class Histogram:
    xs: np.ndarray
    ys: np.ndarray
    N: int
    dx: float


def _host(a) -> np.ndarray:
    """A tensor (on any device) or an array as a host NumPy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def velocity_histogram(state, v_max: float = 0.0, N: int = 100) -> Histogram:
    """Histogram of 2-D velocity norms: a ParticleState (active rows) or a
    raw [n, d] velocity array."""
    if hasattr(state, "fields"):
        act = _host(state.active)
        v = np.linalg.norm(_host(state.fields["v"])[act], axis=1)
    else:
        v = np.linalg.norm(_host(state), axis=1)
    if v_max == 0.0:
        v_max = float(v.max()) if len(v) else 1.0
    dv = v_max / N
    vs = np.arange(0.0, v_max + 0.5 * dv, dv)
    ns = np.zeros(len(vs))
    n_idx = np.round(v / dv).astype(int)
    sel = (n_idx >= 1) & (n_idx <= len(ns))
    # bin n (1-based) holds the speeds that round to n·dv
    np.add.at(ns, n_idx[sel] - 1, 1.0 / (dv * len(v)))
    return Histogram(xs=vs, ys=ns, N=N, dx=dv)


def entropy_2D_MB(fMB: Histogram) -> float:
    """Boltzmann entropy of a 2-D MB histogram, singularity-corrected at
    v = 0."""
    assert fMB.xs[0] == 0
    S = 0.0
    der = (fMB.ys[1] - fMB.ys[0]) / fMB.dx
    if der > 0:
        S = -fMB.ys[0] * (np.log(der) * fMB.dx - der * fMB.dx**3 / 6)
    for k in range(1, len(fMB.xs)):
        if fMB.xs[k] != 0 and fMB.ys[k] > 0:
            S += -fMB.ys[k] * np.log(fMB.ys[k] / fMB.xs[k]) * fMB.dx
    return S


def fit_maxwell_boltzmann(distr: Histogram, m: float) -> tuple[float, float]:
    """Fit f(v) = mβv·exp(−mβv²/2) to the histogram; return (β, T)."""
    xs, ys = distr.xs, distr.ys

    def obj(beta):
        f = m * beta * xs * np.exp(-0.5 * m * beta * xs**2)
        return float(np.sum((ys - f) ** 2))

    # bracket around the moment estimate beta0 = 2/(m<v^2>)
    v2 = np.sum(ys * xs**3) * distr.dx / max(np.sum(ys * xs) * distr.dx, 1e-300)
    beta0 = 2.0 / (m * max(v2, 1e-300))
    lo, hi = beta0 * 1e-3, beta0 * 1e3
    gr = (np.sqrt(5) - 1) / 2
    a, b = np.log(lo), np.log(hi)
    c, d = b - gr * (b - a), a + gr * (b - a)
    for _ in range(200):
        if obj(np.exp(c)) < obj(np.exp(d)):
            b = d
        else:
            a = c
        c, d = b - gr * (b - a), a + gr * (b - a)
    beta = float(np.exp((a + b) / 2))
    return beta, 1.0 / (beta * KB)
