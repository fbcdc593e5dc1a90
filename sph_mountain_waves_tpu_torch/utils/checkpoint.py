"""Exact checkpoint/resume.

Port of ``sph_mountain_waves_tpu/utils/checkpoint.py``. The VTP/PVD frames
are approximate restart points (``io.import_particles``); this module saves
the full ``ParticleState`` (every field, ``_xref`` included, the active mask
and the engine configuration) as a compressed npz, and loading restores the
state bit for bit, so a resumed run continues exactly. The npz layout is the
JAX package's (``field:<name>``, ``active``, ``__meta__`` with
``format: "slots"``): a checkpoint written by either package loads in the
other.
"""
from __future__ import annotations

import json
import os

import numpy as np

from ..interop import state_from_numpy, state_to_numpy
from ..structs import ParticleState

__all__ = ["save_checkpoint", "load_checkpoint", "atomic_savez",
           "engine_from_meta"]


def save_checkpoint(path: str, state: ParticleState, engine=None,
                    extra: dict | None = None) -> None:
    """Write state (bitwise) + engine config + optional scalars to ``path``."""
    fields, active = state_to_numpy(state)
    arrays = {f"field:{k}": v for k, v in fields.items()}
    arrays["active"] = active
    meta = {"extra": extra or {}, "format": "slots"}
    if engine is not None:
        meta["engine"] = {
            "dim": engine.dim, "h": engine.h, "phase": list(engine.phase),
            "lims": list(engine.lims), "cap": engine.cap,
            "mins": list(engine.mins), "maxs": list(engine.maxs),
            "pair_mode": "cell", "layout": "bucket",
            "skin": engine.skin,
        }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    atomic_savez(path, arrays)


def atomic_savez(path: str, arrays: dict) -> None:
    """Write an npz atomically: a crash mid-write must never destroy the
    previous good checkpoint (the overwritten file IS the resume point), so
    compress to <path>.tmp and os.replace into place."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:  # file handle: savez must not append .npz
        np.savez_compressed(fh, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda"):
    """Return (state on ``device``, meta). ``meta['engine']`` (if saved)
    reconstructs the NeighborEngine via ``engine_from_meta``."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    fields = {}
    active = None
    meta = {}
    for k in data.files:
        if k == "__meta__":
            meta = json.loads(bytes(data[k].tobytes()).decode())
        elif k == "active":
            active = data[k]
        elif k.startswith("field:"):
            fields[k[len("field:"):]] = data[k]
    fmt = meta.get("format", "slots")
    if fmt != "slots":
        raise ValueError(
            f"{path} is a {fmt!r}-format checkpoint (compact rows from a "
            "sharded run); only the slot format is ported")
    return state_from_numpy(fields, active, device), meta


def engine_from_meta(meta: dict, **engine_opts):
    """The NeighborEngine a checkpoint was saved with. What the npz does not
    carry (``cells``, ``persistent``, ``dtype``) comes from ``engine_opts``."""
    from ..ops.neighbors import NeighborEngine
    e = meta["engine"]
    if e["layout"] != "bucket":
        raise NotImplementedError(
            f"layout={e['layout']!r}: only the bucket layout is ported")
    return NeighborEngine(dim=e["dim"], h=e["h"], phase=tuple(e["phase"]),
                          lims=tuple(e["lims"]), cap=e["cap"],
                          mins=tuple(e["mins"]), maxs=tuple(e["maxs"]),
                          skin=e["skin"], **engine_opts)
