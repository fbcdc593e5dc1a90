"""Figures and terminal sparklines of the runs, matplotlib-backed.

Port of ``sph_mountain_waves_tpu/utils/plots.py`` (NumPy and matplotlib
only, no tensors): the dam break's ``dambreak_X.pdf``/``dambreak_H.pdf``
against the digitised Violeau simulation and Koshizuka–Oka experiment, the
mountain-wave schemes' two-panel ``velocities.pdf``, one-figure series
(``plot_series``: Rayleigh–Bénard's kinetic energy and Nusselt number), the
cavity's centreline profiles, and the per-frame sparklines that ``run``
prints with ``cfg.live_plot``.

matplotlib is imported lazily with the Agg backend (headless nodes); where
it is missing or broken a figure is skipped with a warning and the run goes
on.
"""
from __future__ import annotations

import os
import warnings

__all__ = ["plot_series", "plot_dambreak", "plot_velocities",
           "plot_cavity"]


def _pyplot():
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        return plt
    except Exception as e:  # noqa: BLE001 — plotting must never kill a run
        warnings.warn(f"matplotlib unavailable, skipping plots: {e}",
                      stacklevel=3)
        return None


def plot_series(path: str, t, series: dict, xlabel: str = "t (s)",
                ylabel: str = "") -> bool:
    """One figure, one line per ``series`` entry. Returns True if written."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, ax = plt.subplots(figsize=(6.0, 3.6))
    for label, y in series.items():
        ax.plot(t, y, label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if len(series) > 1:
        ax.legend(frameon=False)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)
    return True


def _read_ref_csv(path: str):
    import numpy as np
    return np.genfromtxt(path, delimiter=",", names=True)


def plot_dambreak(out_dir: str, t, X, H, ref_dir: str | None = None) -> bool:
    """``dambreak_X.pdf`` + ``dambreak_H.pdf``: computed curves with the
    Violeau / Koshizuka–Oka reference points scattered on top when the
    digitized CSVs are available (collapse_dry.jl ``make_plot``,
    :232-247). ``ref_dir`` defaults to the packaged test reference data."""
    plt = _pyplot()
    if plt is None:
        return False
    if ref_dir is None:
        ref_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "tests", "reference_data")

    for name, ours in (("X", X), ("H", H)):
        fig, ax = plt.subplots(figsize=(6.0, 3.6))
        ax.plot(t, ours, label="sph_mountain_waves_tpu_torch")
        for src, marker in (("Violeau", "o"), ("Koshizuka", "s")):
            p = os.path.join(ref_dir, f"dambreak_{name}_{src}.csv")
            if os.path.exists(p):
                ref = _read_ref_csv(p)
                ax.scatter(ref["time"], ref[name], s=18, marker=marker,
                           label="Koshizuka&Oda" if src == "Koshizuka"
                           else src)
        ax.set_xlim(0.0, 3.0)
        ax.set_xlabel("t·√(2g/H₀)")
        ax.set_ylabel(name)
        ax.legend(frameon=False)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"dambreak_{name}.pdf"))
        plt.close(fig)
    return True


def plot_cavity(out_dir: str, s, v1, v2, Re: float = 100.0,
                ref_dir: str | None = None) -> bool:
    """``ldc-x2vy.pdf`` + ``ldc-y2vx.pdf``: centerline velocity profiles
    against the Ghia et al. reference columns (cavity_flow.jl ``make_plot``,
    :182-220 — v_y along the horizontal centerline, v_x along the vertical
    one, reference points scattered on top when the Re column exists)."""
    plt = _pyplot()
    if plt is None:
        return False
    if ref_dir is None:
        ref_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))),
            "tests", "reference_data")
    col = f"Re{int(Re)}"

    specs = (  # (file stem, ref abscissa col, ours as (x, y) curve)
        ("ldc-x2vy", "x", (s, v2), ("x", "v_y"), False),
        ("ldc-y2vx", "y", (v1, s), ("v_x", "y"), True),
    )
    for stem, ref_ax, (cx, cy), (xl, yl), swap in specs:
        fig, ax = plt.subplots(figsize=(4.6, 4.6))
        ax.plot(cx, cy, color="tab:orange", lw=2.5, label="SPH")
        p = os.path.join(ref_dir, f"{stem}.csv")
        if os.path.exists(p):
            ref = _read_ref_csv(p)
            if col in (ref.dtype.names or ()):
                pts = ((ref[col], ref[ref_ax]) if swap
                       else (ref[ref_ax], ref[col]))
                ax.scatter(*pts, s=22, marker="D", color="tab:blue",
                           label="REF")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.legend(frameon=False)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{stem}.pdf"))
        plt.close(fig)
    return True


def plot_velocities(out_dir: str, t, u_avg, u_max) -> bool:
    """``velocities.pdf``: the reference's two-panel avg/max velocity figure
    (wcsph_perturbed_witch.jl:393-405)."""
    plt = _pyplot()
    if plt is None:
        return False
    fig, (a1, a2) = plt.subplots(2, 1, figsize=(6.0, 5.4), sharex=True)
    a1.plot(t, u_avg, color="tab:blue")
    a1.set_ylabel("avg. velocity (m/s)")
    a2.plot(t, u_max, color="tab:orange")
    a2.set_ylabel("max. velocity (m/s)")
    a2.set_xlabel("t (s)")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "velocities.pdf"))
    plt.close(fig)
    return True


# --------------------------------------------------------- terminal plots

_SPARK = "▁▂▃▄▅▆▇█"


def ascii_series(name: str, values, width: int = 64) -> str:
    """One-line terminal sparkline of a time series, the in-run plotting
    channel (the original code draws unicodeplots line plots during its
    main loop; on a batch node a one-liner beats a 20-row canvas). Values
    are resampled to ``width`` columns and binned over the series range."""
    import numpy as np

    v = np.asarray(values, dtype=float).reshape(-1)
    v = v[np.isfinite(v)]
    if len(v) == 0:
        return f"{name}: (no data)"
    if len(v) > width:
        idx = np.linspace(0, len(v) - 1, width).round().astype(int)
        v = v[idx]
    lo, hi = float(v.min()), float(v.max())
    span = (hi - lo) or 1.0
    cells = ((v - lo) / span * (len(_SPARK) - 1)).round().astype(int)
    line = "".join(_SPARK[c] for c in cells)
    return f"{name} [{lo:.3g}, {hi:.3g}]: {line}"


def live_plot(series: dict, width: int = 64) -> None:
    """Print one sparkline per entry — called per frame by run loops when
    ``cfg.live_plot`` is set (unicodeplots-in-the-loop parity)."""
    for name, values in series.items():
        print("  " + ascii_series(name, values, width), flush=True)
