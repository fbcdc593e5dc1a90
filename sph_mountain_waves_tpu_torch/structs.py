"""Domain model: particle-system container and struct-of-tensors state.

Port of ``sph_mountain_waves_tpu/structs.py``. ``ParticleState`` holds one
tensor per field plus an ``active`` mask, all on one device; updates build a
new state (``replace``) and never write into the old one. ``ParticleSystem``
is the host-side container: particles accumulate in NumPy, and ``freeze``
builds a ``NeighborEngine`` and moves the particles to the requested device
(CUDA unless the caller asks for the CPU): in the bucket-slot layout, each
particle placed in its slot, or in the flat layout, the rows in build order
(the engine sorts them at every rebuild).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .geometry import Shape, boundarybox

__all__ = ["ParticleState", "ParticleSystem", "generate_particles"]


def _numpy_dtype(dtype: torch.dtype):
    """NumPy twin of a floating torch dtype (host-side key arithmetic must
    round exactly like the device's)."""
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


@dataclasses.dataclass
class ParticleState:
    """Struct-of-tensors particle state: ``fields[name] -> [N_cap, ...]`` plus
    a bool ``active`` mask [N_cap], all on one device."""
    fields: dict[str, torch.Tensor]
    active: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.active.shape[0]

    @property
    def n(self) -> torch.Tensor:
        """Number of active particles, as a 0-d tensor on the state's device
        (no host sync until the caller reads it)."""
        return self.active.sum()

    def replace(self, **fields) -> "ParticleState":
        new = dict(self.fields)
        new.update(fields)
        return ParticleState(fields=new, active=self.active)


def _field_shape(spec) -> tuple:
    """Field spec: 0/() = scalar, d = d-vector, (a, b) = matrix."""
    if spec in (0, (), None):
        return ()
    if isinstance(spec, int):
        return (spec,)
    return tuple(spec)


class ParticleSystem:
    """Host-side simulation container.

    Parameters
    ----------
    fields : dict mapping field name -> shape spec (0 scalar, d vector,
        (a,b) matrix). Must contain ``x``.
    domain : Shape. Particles outside ``boundarybox(domain)`` are deactivated
        on the next rescatter.
    h : interaction radius: pairs farther than ``h`` never interact.
    dim : 2 or 3.
    defaults : optional dict of default field values for generated particles.
    dtype : state float dtype (torch.float32 for the flagship).
    """

    def __init__(self, fields: dict, domain: Shape, h: float, dim: int = 2,
                 defaults: dict | None = None, dtype=torch.float32):
        if not h > 0.0:
            raise ValueError("invalid ParticleSystem declaration! (h must be positive)")
        if "x" not in fields:
            raise ValueError("particles must have a field `x`")
        self.h = float(h)
        self.domain = boundarybox(domain)
        self.dim = int(dim)
        self.dtype = dtype
        self.field_specs = {name: _field_shape(spec) for name, spec in fields.items()}
        self.field_specs["x"] = (self.dim,)
        self.defaults = dict(defaults or {})
        self._chunks: list[dict[str, np.ndarray]] = []
        self.state: ParticleState | None = None
        self.engine = None  # set by freeze()
        self.freeze_opts: dict = {}  # default kwargs for freeze()

    # ---------------------------------------------------------------- build
    def add_particles(self, xs: np.ndarray, values: dict) -> None:
        """Append particles at positions ``xs`` [N, 2|3] with field values
        (scalars broadcast). Host-side; call before ``freeze``."""
        xs = np.asarray(xs, dtype=np.float64)
        if xs.ndim == 1:
            xs = xs[None]
        n = len(xs)
        if n == 0:
            return
        chunk: dict[str, np.ndarray] = {}
        for name, shape in self.field_specs.items():
            if name == "x":
                chunk["x"] = xs[:, : self.dim]
                continue
            if name in values:
                v = np.asarray(values[name], dtype=np.float64)
            elif name in self.defaults:
                v = np.asarray(self.defaults[name], dtype=np.float64)
            else:
                v = np.zeros(shape)
            v = np.broadcast_to(v, (n,) + shape).copy() if v.shape != (n,) + shape else v
            chunk[name] = v
        self._chunks.append(chunk)
        self.state = None  # invalidate frozen state

    @property
    def n_built(self) -> int:
        return sum(len(c["x"]) for c in self._chunks)

    def host_fields(self) -> dict[str, np.ndarray]:
        """Concatenated host-side field arrays of all built particles."""
        out = {}
        for name, shape in self.field_specs.items():
            if self._chunks:
                out[name] = np.concatenate(
                    [c.get(name, np.zeros((len(c["x"]),) + shape))
                     for c in self._chunks])
            else:
                out[name] = np.zeros((0,) + shape)
        return out

    # --------------------------------------------------------------- freeze
    def freeze(self, device="cuda", capacity: int | None = None,
               **engine_opts) -> ParticleState:
        """Move the built particles to ``device`` (the card unless the
        caller asks for the CPU) and return the ``ParticleState``; the
        ``NeighborEngine`` is stored as ``self.engine``. Asking for CUDA
        where there is no CUDA device raises; there is no fallback to the
        CPU.

        capacity : the flat layout's row count (≥ the built count, rounded
            up to a multiple of 8; the spare rows start inactive); default
            the ``freeze_opts`` entry of that name, else the built count.
            Ignored on the bucket layout, whose capacity is the engine's
            slot count.
        engine_opts : forwarded to NeighborEngine.create (layout, skin, cells,
            persistent, rescatter_mode, pair_mode, cap: the bucket capacity,
            default measured occupancy plus headroom); defaults come from
            ``self.freeze_opts``.
        """
        from .ops.neighbors import NeighborEngine  # avoid import cycle

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"freeze(device={str(device)!r}) needs a CUDA device and none "
                "is available; pass device='cpu' to run on the CPU")
        host = self.host_fields()
        n = len(host["x"])
        opts = {**self.freeze_opts, **engine_opts}
        if capacity is None:
            capacity = opts.pop("capacity", None)
        else:
            opts.pop("capacity", None)
        engine = NeighborEngine.create(
            box=self.domain, h=self.h, dim=self.dim,
            positions=host["x"] if n else None, dtype=self.dtype, **opts)
        self.engine = engine
        if engine.layout == "flat":
            return self._freeze_flat(host, n, capacity, device)
        # rows ARE bucket slots: place particles host-side directly in their
        # slots (rank*(C+1)+key, same f32 key arithmetic as _screen_and_key)
        # so no boot rescatter is needed and the 1-cell-local stencil
        # rescatter's assumption (rows near their cells) holds from step 0
        self.field_specs.setdefault("_xref", (self.dim,))
        if n > engine.slots:
            raise ValueError(f"{n} particles exceed {engine.slots} slots")
        return self._freeze_bucket(engine, host, n, device)

    def _freeze_flat(self, host: dict, n: int, capacity: int | None,
                     device: torch.device) -> ParticleState:
        """The flat layout: rows in build order, ``capacity`` (default n)
        rounded up to a multiple of 8, the spare rows inactive and zero
        (``_xref``, where the spec has it, is inf)."""
        capacity = max(n, 1) if capacity is None else int(capacity)
        if n > capacity:
            raise ValueError(f"{n} particles exceed capacity {capacity}")
        capacity = -(-capacity // 8) * 8
        sdt = _numpy_dtype(self.dtype)
        fields = {}
        for name, shape in self.field_specs.items():
            arr = np.zeros((capacity,) + shape, dtype=np.float64)
            if name == "_xref":
                arr[:] = np.inf
            elif name in host:
                arr[:n] = host[name]
            fields[name] = torch.as_tensor(arr.astype(sdt), device=device)
        active = torch.arange(capacity, device=device) < n
        self.state = ParticleState(fields=fields, active=active)
        return self.state

    def _freeze_bucket(self, engine, host: dict, n: int,
                       device: torch.device) -> ParticleState:
        """Host-side slot placement for the bucket layout (dtype-matched to
        the device key arithmetic of NeighborEngine._screen_and_key)."""
        C, cap = engine.num_cells, engine.cap
        slots = engine.slots
        sdt = _numpy_dtype(self.dtype)
        if n:
            x = np.asarray(host["x"], dtype=np.float64).astype(sdt)[:, :self.dim]
            L = np.asarray(engine.cell_size, dtype=sdt)
            ci = np.floor(x / L).astype(np.int64) - np.asarray(engine.phase)
            ci = np.clip(ci, 0, np.asarray(engine.lims) - 1)
            key = ci[:, 0]
            stride = engine.lims[0]
            for a in range(1, self.dim):
                key = key + stride * ci[:, a]
                stride *= engine.lims[a]
            order = np.argsort(key, kind="stable")
            key_s = key[order]
            counts = np.bincount(key_s, minlength=C + 1)
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            rank = np.arange(n) - starts[key_s]
            if rank.size and rank.max() >= cap:
                raise ValueError(
                    f"initial occupancy {int(rank.max()) + 1} > cap {cap}")
            slot = rank * (C + 1) + key_s
        else:
            order = slot = np.zeros(0, dtype=np.int64)

        fields = {}
        for name, shape in self.field_specs.items():
            arr = np.zeros((slots,) + shape, dtype=np.float64)
            if name != "_xref" and name in host and n:
                arr[slot] = np.asarray(host[name])[order]
            fields[name] = torch.as_tensor(arr.astype(sdt), device=device)
        # _xref is its own buffer, never an alias of x
        fields["_xref"] = fields["x"].clone()
        active = np.zeros(slots, dtype=bool)
        active[slot] = True
        self.state = ParticleState(fields=fields,
                                   active=torch.as_tensor(active, device=device))
        return self.state


def generate_particles(sys: ParticleSystem, grid, geometry: Shape,
                       constructor: Callable[[np.ndarray], dict]) -> int:
    """Create particles at every grid point inside ``geometry``.

    ``constructor`` receives the [N, 3] lattice points and returns a dict of
    field values (vectorized); scalars broadcast. Returns the particle count
    added.
    """
    from .grids import covering
    xs = covering(grid, geometry)
    if len(xs) == 0:
        return 0
    values = constructor(xs)
    if "x" in values:
        xs = np.asarray(values.pop("x"))
    sys.add_particles(xs, values)
    return len(xs)
