"""Neighbour engine: the bucket layout and the flat layout.

Port of ``sph_mountain_waves_tpu/ops/neighbors.py``. Two state layouts:

* "bucket": the state rows ARE bucket slots: slot = rank*(C+1) + key, so a
  field viewed as ``[cap, C+1]`` is one plane per in-cell rank with the cells
  (x minor) along the columns and one trash column. Pair sweeps read the
  9-cell (2-D) or 27-cell (3-D) stencil of a cell straight from that layout;
  nothing is gathered or sorted per step. ``rebuild`` checks how far
  particles drifted since the last rescatter and re-places them only past
  the skin budget, by one of two rescatters (``rescatter_mode``), both in
  plain PyTorch and both with the reference's slot layout and dropped-row
  count, so states stay slot-for-slot comparable with the JAX package:

  - "stencil": a windowed compaction over the 9 or 27 neighbour cells with
    the reference's packing order (offset-major, then source slot). It
    assumes every particle is at most one cell from its slot's cell;
  - "sort": ``sorted_slot_scatter``, a stable sort of every row by its cell
    key and one scatter per field, valid for any row placement (spawns
    written into arbitrary free slots). "stencil" degrades to it past
    ``_STENCIL_COST_MAX`` offsets × cap.

  ``pad_resident``, ``slice_resident`` and ``shift_resident`` give the
  stencil shifts of a resident field as slices of one padded grid (the
  multigrid preconditioner's coarse stencil reads them).

* "flat": particles in arbitrary row order, sorted by cell key at every
  rebuild (``_rebuild_flat``: the containment/finiteness screen, a stable
  argsort, per-cell counts and starts, each row's rank in its cell and a
  dense ``[C+1, cap]`` bucket table of row indices; rows past ``cap`` are
  left out of the table and only ``Neighbors.overflow`` says so). The pair
  operator of ``ops/apply.py`` reads it through ``bucketize``,
  ``occupancy``, ``pad_cells`` and ``slice_cells`` (``pair_mode="cell"``;
  ``shift_cells`` is one shift) or ``stencil_candidates``
  (``pair_mode="gather"``). Integer counts are the only sums taken by
  scatter-add: they are exact in any order.

Not ported: the sharded engine's ``count_cells``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..structs import ParticleState

__all__ = ["NeighborEngine", "Neighbors", "sorted_slot_scatter"]


@dataclasses.dataclass
class Neighbors:
    """Per-rebuild neighbour structure. The bucket layout needs only
    ``counts`` and ``overflow`` (everything else is implied by the slot
    layout); the flat layout fills the rest."""
    counts: torch.Tensor    # [C+1] int32 particles per cell (trash last)
    overflow: torch.Tensor  # [] int32: flat layout = max count beyond cap;
    #                         bucket layout = rows dropped at this rescatter
    cell: torch.Tensor | None = None    # [N, dim] int32 per-axis cell (clipped)
    key: torch.Tensor | None = None     # [N] int32 flat cell key; C = trash
    rank: torch.Tensor | None = None    # [N] int32 row's rank in its cell
    starts: torch.Tensor | None = None  # [C+1] int32 exclusive prefix of counts
    bucket: torch.Tensor | None = None  # [C+1, cap] int32 row indices (0-pad)


def sorted_slot_scatter(key: torch.Tensor, fields: dict, C: int, cap: int,
                        slots: int):
    """Move ``fields`` (name → [n] or [n, d] tensor) into the bucket-slot
    layout [slots] / [slots, d]: a stable sort of the rows by ``key`` (the
    flat cell key, int32; C drops the row), then rank within the cell,
    slot = rank·(C+1) + key, and one scatter per field. Rows whose cell
    overflows ``cap`` are dropped and counted. Dropped rows are written to
    an extra slot past the end that is trimmed, never indexed out of range.
    Returns (fields in slot layout, active, overflow), the reference's
    ``sorted_slot_scatter`` slot for slot."""
    n = key.shape[0]
    dev = key.device
    key_s, order = torch.sort(key, stable=True)
    counts = torch.bincount(key_s, minlength=C + 1).to(torch.int32)
    starts = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
    rank = (torch.arange(n, dtype=torch.int32, device=dev)
            - starts[key_s.long()])
    keep = (rank < cap) & (key_s < C)
    slot = torch.where(keep, rank * (C + 1) + key_s,
                       torch.full_like(key_s, slots)).long()
    overflow = ((rank >= cap) & (key_s < C)).sum().to(torch.int32)

    active = torch.zeros(slots + 1, dtype=torch.bool, device=dev)
    active[slot] = True
    moved = {}
    for name, arr in fields.items():
        buf = torch.zeros((slots + 1,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                          device=dev)
        buf[slot] = arr[order]
        moved[name] = buf[:slots]
    return moved, active[:slots], overflow


def _is_bookkeeping(name: str) -> bool:
    """Slot-bound accumulator fields, by convention "_"-prefixed (e.g.
    ``_rescatter_count``): rescatters leave them in place. ``_xref`` is
    particle data with its own handling."""
    return name.startswith("_") and name != "_xref"


@dataclasses.dataclass(frozen=True)
class NeighborEngine:
    """Static engine configuration.

    ``h`` is the pair cutoff; ``cells`` the per-axis cell widths (each ≥ h);
    ``phase``/``lims`` the reference's key_phase/key_lim. ``layout`` is
    "bucket" (state rows are slots) or "flat" (rows sorted by cell at every
    rebuild); ``pair_mode`` is how ``ops/apply.py`` sums the flat layout's
    pairs ("cell": dense blocks over the cell grid; "gather": per-row
    candidate gathers). ``persistent`` names the fields a bucket
    rescatter moves (() = all); the others are zeroed, because the step
    recomputes them before reading them.
    """
    dim: int
    h: float
    phase: tuple
    lims: tuple
    cap: int
    dtype: torch.dtype = torch.float32
    mins: tuple = ()
    maxs: tuple = ()
    pair_mode: str = "cell"
    layout: str = "bucket"
    skin: float = 0.0
    cells: tuple = ()
    persistent: tuple = ()
    # "stencil" (1-cell-local compaction) or "sort" (any row placement)
    rescatter_mode: str = "stencil"

    # largest stencil·cap for which the stencil compaction is kept; past it
    # the engine takes the sort rescatter, as the reference does
    _STENCIL_COST_MAX = 2048

    @property
    def effective_rescatter_mode(self) -> str:
        """The rescatter ``rebuild`` runs: "stencil" degrades to "sort" past
        ``_STENCIL_COST_MAX``."""
        if (self.rescatter_mode == "stencil"
                and len(self.stencil) * self.cap > self._STENCIL_COST_MAX):
            return "sort"
        return self.rescatter_mode

    # ------------------------------------------------------------- creation
    @staticmethod
    def create(box, h: float, dim: int, positions: np.ndarray | None = None,
               cap: int | None = None, dtype=torch.float32,
               pair_mode: str = "auto", layout: str = "bucket",
               skin: float = 0.0, cells: tuple | None = None,
               persistent: tuple = (),
               rescatter_mode: str = "stencil") -> "NeighborEngine":
        """Build an engine for domain ``box`` and interaction radius h.

        Key arithmetic: with per-axis cell size L_a (default (1+skin)·h),
        phase_a = floor(min_a/L_a), lim_a = floor(max_a/L_a) − phase_a + 1;
        on the bucket layout nx is then rounded up to a multiple of 128 and
        ny (and nz) to multiples of 8 (the JAX package's layout, kept so
        states compare slot for slot). ``pair_mode="auto"`` takes "cell"
        when num_cells·cap ≤ 4·n (a well-occupied grid), else "gather".
        The default layout is the bucket layout (the JAX package's default
        is flat; every scheme names its layout in its config).
        """
        if layout not in ("bucket", "flat"):
            raise ValueError(f"layout must be 'bucket' or 'flat', "
                             f"got {layout!r}")
        if pair_mode not in ("auto", "cell", "gather"):
            raise ValueError(f"pair_mode must be 'auto', 'cell' or 'gather', "
                             f"got {pair_mode!r}")
        if dim not in (2, 3):
            raise ValueError(f"dim must be 2 or 3, got {dim}")
        if rescatter_mode not in ("stencil", "sort"):
            raise ValueError(f"rescatter_mode must be 'stencil' or 'sort', "
                             f"got {rescatter_mode!r}")
        if cells is None or len(cells) == 0:
            cells = (h * (1.0 + skin),) * dim
        cells = tuple(float(c) for c in cells)
        if len(cells) != dim or not all(c >= h for c in cells):
            raise ValueError(f"cells {cells} must be {dim} widths ≥ h={h}")
        L = np.asarray(cells, dtype=np.float64)
        mins = np.asarray(box.mins[:dim], dtype=np.float64)
        maxs = np.asarray(box.maxs[:dim], dtype=np.float64)
        phase = np.floor(mins / L).astype(np.int64)
        lims = (np.floor(maxs / L).astype(np.int64) - phase + 1)
        if layout == "bucket":
            lims[0] = -(-lims[0] // 128) * 128
            for a in range(1, dim):
                lims[a] = -(-lims[a] // 8) * 8
        if cap is None:
            cap = NeighborEngine._estimate_cap(positions, L, phase, lims, dim)
        if pair_mode == "auto":
            n = 0 if positions is None else len(positions)
            pair_mode = ("cell" if int(np.prod(lims)) * cap <= 4 * max(n, 1)
                         else "gather")
        return NeighborEngine(dim=dim, h=float(h),
                              phase=tuple(int(p) for p in phase),
                              lims=tuple(int(l) for l in lims), cap=int(cap),
                              dtype=dtype, mins=tuple(mins), maxs=tuple(maxs),
                              pair_mode=pair_mode, layout=layout,
                              skin=float(skin), cells=cells,
                              persistent=tuple(persistent),
                              rescatter_mode=rescatter_mode)

    @staticmethod
    def _estimate_cap(positions, L, phase, lims, dim) -> int:
        """Max bucket occupancy from ``positions`` binned at the per-axis
        cell widths ``L``, plus a quarter for compression, rounded up to a
        multiple of 8 (the reference's rule; rounding kept for slot parity)."""
        if positions is None or len(positions) == 0:
            return 16
        pos = np.asarray(positions)[:, :dim]
        pos = pos[np.isfinite(pos).all(axis=1)]
        if len(pos) == 0:
            return 16
        ci = np.floor(pos / L).astype(np.int64) - phase
        ci = np.clip(ci, 0, np.asarray(lims) - 1)
        key = ci[:, 0]
        stride = lims[0]
        for a in range(1, dim):
            key = key + stride * ci[:, a]
            stride *= lims[a]
        occ = np.bincount(key).max()
        cap = int(occ) + max(1, int(occ) // 4)
        return -(-cap // 8) * 8

    # ------------------------------------------------------------ derived
    @property
    def cell_size(self) -> tuple:
        """Per-axis cell widths."""
        if self.cells:
            return self.cells
        return (self.h * (1.0 + self.skin),) * self.dim

    @property
    def skin_slack(self) -> float:
        """Drift budget before a rescatter is needed: the narrowest cell's
        margin over the pair cutoff h."""
        return min(self.cell_size) - self.h

    @property
    def num_cells(self) -> int:
        n = 1
        for l in self.lims:
            n *= l
        return n

    @property
    def slots(self) -> int:
        """State capacity: cap rows × (num_cells+1) columns."""
        return self.cap * (self.num_cells + 1)

    @property
    def stencil(self) -> list:
        """The 9 (2-D) or 27 (3-D) relative cell offsets (di, dj[, dk]),
        the last axis outermost."""
        if self.dim == 2:
            return [(di, dj) for dj in (-1, 0, 1) for di in (-1, 0, 1)]
        return [(di, dj, dk) for dk in (-1, 0, 1) for dj in (-1, 0, 1)
                for di in (-1, 0, 1)]

    @property
    def grid_shape(self) -> tuple:
        """The cell grid with x minor: (ny, nx) or (nz, ny, nx)."""
        return tuple(reversed(self.lims))

    def flat_key(self, cell: torch.Tensor) -> torch.Tensor:
        """Flat cell index from per-axis coords [..., dim]."""
        key = cell[..., 0]
        stride = self.lims[0]
        for a in range(1, self.dim):
            key = key + stride * cell[..., a]
            stride *= self.lims[a]
        return key

    def resident(self, arr: torch.Tensor) -> torch.Tensor:
        """View a flat field [slots(, d)] as [cap, C+1(, d)]."""
        return arr.reshape((self.cap, self.num_cells + 1) + tuple(arr.shape[1:]))

    def grid_view(self, arr: torch.Tensor) -> torch.Tensor:
        """A flat scalar field [slots] as [cap, (nz,) ny, nx] (trash column
        cut)."""
        return self.resident(arr)[:, : self.num_cells].reshape(
            (self.cap,) + self.grid_shape)

    def to_flat(self, g: torch.Tensor) -> torch.Tensor:
        """[cap, (nz,) ny, nx] back to flat [slots] with a zero trash
        column."""
        flat = g.reshape(self.cap, self.num_cells)
        return torch.nn.functional.pad(flat, (0, 1)).reshape(self.slots)

    # ------------------------------------------ flat layout: cell blocks
    def bucketize(self, nbrs: Neighbors, arr: torch.Tensor) -> torch.Tensor:
        """A flat field [N(, ...)] as the dense bucket tensor
        [C+1, cap(, ...)] (empty slots hold row 0's data; pair validity
        comes from ``occupancy``)."""
        return arr[nbrs.bucket.long()]

    def occupancy(self, nbrs: Neighbors) -> torch.Tensor:
        """[C+1, cap] bool: slot k of cell c holds a particle."""
        ranks = torch.arange(self.cap, dtype=torch.int32,
                             device=nbrs.counts.device)
        return ranks[None, :] < nbrs.counts[:, None]

    def pad_cells(self, B: torch.Tensor) -> torch.Tensor:
        """A bucket tensor [C+1, ...] as its cell grid padded by one empty
        (zero or False) cell on each side: [(nz+2,) ny+2, nx+2, ...]. Every
        stencil shift is then a slice of it (``slice_cells``)."""
        rest = tuple(B.shape[1:])
        G = B[: self.num_cells].reshape(self.grid_shape + rest)
        # F.pad pads trailing dims first: skip the block dims, then one cell
        # on each side of every grid axis
        return torch.nn.functional.pad(G, (0, 0) * len(rest)
                                       + (1, 1) * self.dim)

    def slice_cells(self, P: torch.Tensor, offset: tuple) -> torch.Tensor:
        """Stencil view of a ``pad_cells`` tensor: out[c] = B[c + offset]
        ([C, ...])."""
        idx = tuple(slice(1 + o, 1 + o + n)
                    for o, n in zip(reversed(offset), self.grid_shape))
        return P[idx].reshape((self.num_cells,) + tuple(P.shape[self.dim:]))

    def shift_cells(self, B: torch.Tensor, offset: tuple) -> torch.Tensor:
        """Each cell's stencil-neighbour block brought to the cell's own
        place: out[c] = B[c + offset] ([C, ...] from [C+1, ...]), zeros (or
        False) past the grid's edges. A pad and a slice, no gather."""
        return self.slice_cells(self.pad_cells(B), offset)

    def stencil_candidates(self, nbrs: Neighbors, offset):
        """Each row's candidate rows at a stencil offset and their validity:
        (cand [N, cap] int32 rows, valid [N, cap] bool), from the bucket row
        of the offset cell; invalid past the cell's count and for cells
        outside the grid. ``offset`` is one (di, dj[, dk]), or a list of
        them, which gives [N, len(offset), cap]."""
        dev = nbrs.cell.device
        off = torch.tensor(offset, dtype=torch.int32, device=dev)
        ncell = (nbrs.cell if off.ndim == 1 else nbrs.cell[:, None, :]) + off
        lims = torch.tensor(self.lims, dtype=torch.int32, device=dev)
        in_grid = torch.all((ncell >= 0) & (ncell < lims), dim=-1)
        clipped = torch.minimum(torch.clamp(ncell, min=0), lims - 1)
        nkey = torch.where(in_grid, self.flat_key(clipped),
                           self.num_cells).long()
        cnt = torch.where(in_grid, nbrs.counts[nkey], 0)
        cand = nbrs.bucket[nkey]
        ranks = torch.arange(self.cap, dtype=torch.int32, device=dev)
        return cand, ranks < cnt[..., None]

    def pad_resident(self, B: torch.Tensor) -> torch.Tensor:
        """Zero-pad the cell grid of a resident field [cap, C+1(, ...)] once
        (trash column cut): [cap, (nz+2,) ny+2, nx+2(, ...)]. Every stencil
        shift is then a slice of it (``slice_resident``)."""
        cap, rest = B.shape[0], tuple(B.shape[2:])
        G = B[:, : self.num_cells].reshape((cap,) + self.grid_shape + rest)
        # F.pad pads trailing dims first: skip the component dims, then
        # one cell on each side of every grid axis
        pad = (0, 0) * len(rest) + (1, 1) * self.dim
        return torch.nn.functional.pad(G, pad)

    def slice_resident(self, P: torch.Tensor, offset: tuple) -> torch.Tensor:
        """Stencil view of a ``pad_resident`` array: out[:, c] =
        B[:, c + offset] ([cap, C(, ...)], zeros past the grid's edges);
        ``offset`` = (di, dj[, dk])."""
        cap = P.shape[0]
        rest = tuple(P.shape[1 + self.dim:])
        idx = tuple(slice(1 + o, 1 + o + n)
                    for o, n in zip(reversed(offset), self.grid_shape))
        return P[(slice(None),) + idx].reshape((cap, self.num_cells) + rest)

    def shift_resident(self, B: torch.Tensor, offset: tuple) -> torch.Tensor:
        """Stencil shift of a resident field: B [cap, C+1, ...] ->
        [cap, C, ...] with out[:, c] = B[:, c + offset] (zeros at the grid's
        edges)."""
        return self.slice_resident(self.pad_resident(B), offset)

    # ------------------------------------------------------------- rebuild
    def needs_rescatter(self, state: ParticleState) -> torch.Tensor:
        """0-d bool tensor: some active particle drifted past the skin budget
        since the last rescatter (a non-finite drift counts as past it)."""
        x = state.fields["x"]
        d2 = torch.sum((x - state.fields["_xref"]) ** 2, dim=-1)
        d2 = torch.nan_to_num(torch.where(state.active, d2, 0.0),
                              nan=float("inf"), posinf=float("inf"))
        budget = torch.tensor((0.5 * self.skin_slack) ** 2, dtype=x.dtype,
                              device=x.device)
        return torch.max(d2) > budget

    def rebuild(self, state: ParticleState,
                need: bool | None = None) -> tuple[ParticleState, Neighbors]:
        """Refresh the neighbour structure.

        Flat layout: the screen, a stable sort into cell order and the
        bucket table (``_rebuild_flat``; ``need`` is not read). Bucket
        layout: rescatter if some particle drifted past the skin budget,
        then derive the neighbour structure from the slot layout. The
        reference decides under ``lax.cond`` on the device; here ``need``
        is read on the host, one sync per step. A caller that has already
        read ``needs_rescatter`` of a state with the same positions and
        ``_xref`` passes it as ``need`` and saves that sync. A device-side
        flag (and graph capture of the step) is later work."""
        if self.layout == "flat":
            return self._rebuild_flat(state)
        if need is None:
            need = bool(self.needs_rescatter(state))
        if need:
            resc = (self._stencil_rescatter
                    if self.effective_rescatter_mode == "stencil"
                    else self._full_rescatter)
            state, overflow = resc(state)
        else:
            overflow = torch.zeros((), dtype=torch.int32,
                                   device=state.active.device)
        if "_rescatter_count" in state.fields:
            # opt-in cadence observable: one count per drift-triggered
            # rescatter, summable per frame on the host
            rc = state.fields["_rescatter_count"].clone()
            rc[0] += float(need)
            state = state.replace(_rescatter_count=rc)
        counts = self.resident(state.active).sum(dim=0, dtype=torch.int32)
        return state, Neighbors(counts=counts, overflow=overflow)

    def _screen_and_key(self, state: ParticleState):
        """Containment/finiteness screen, per-row cell coordinates (clipped
        to the grid) and cell keys (C for a screened row), in the state's
        float dtype exactly as the reference (floor(x/L) in f32 or f64).
        Returns (active, cell, key)."""
        x = state.fields["x"]
        mins = torch.tensor(self.mins, dtype=x.dtype, device=x.device)
        maxs = torch.tensor(self.maxs, dtype=x.dtype, device=x.device)
        finite = torch.all(torch.isfinite(x), dim=-1)
        inside = torch.all((x >= mins) & (x <= maxs), dim=-1)
        active = state.active & finite & inside

        xsafe = torch.where(finite[:, None], x, 0.0)
        L = torch.tensor(self.cell_size, dtype=x.dtype, device=x.device)
        phase = torch.tensor(self.phase, dtype=torch.int32, device=x.device)
        lims = torch.tensor(self.lims, dtype=torch.int32, device=x.device)
        cell = torch.floor(xsafe / L).to(torch.int32) - phase
        cell = torch.minimum(torch.clamp(cell, min=0), lims - 1)
        key = torch.where(active, self.flat_key(cell),
                          self.num_cells).to(torch.int32)
        return active, cell, key

    def _rebuild_flat(self, state: ParticleState):
        """Sort every row into cell order (stable, screened rows last under
        the trash key C) and build the flat neighbour structure: counts,
        starts, each row's rank, and the bucket table, whose rows past
        ``cap`` are dropped (``overflow`` = the largest count beyond cap).
        Returns (sorted state, Neighbors)."""
        n = state.fields["x"].shape[0]
        C, cap = self.num_cells, self.cap
        active, cell, key = self._screen_and_key(state)
        order = torch.argsort(key, stable=True)
        sorted_state = ParticleState(
            fields={name: arr[order] for name, arr in state.fields.items()},
            active=active[order])
        key_s = key[order]
        counts = torch.bincount(key_s, minlength=C + 1).to(torch.int32)
        starts = torch.cumsum(counts, dim=0, dtype=torch.int32) - counts
        rows = torch.arange(n, dtype=torch.int32, device=key.device)
        rank = rows - starts[key_s.long()]
        # a row past cap goes to one extra entry that is cut off
        slot = torch.where(rank < cap, key_s * cap + rank,
                           (C + 1) * cap).long()
        bucket = torch.zeros((C + 1) * cap + 1, dtype=torch.int32,
                             device=key.device)
        bucket[slot] = rows
        bucket = bucket[:-1].reshape(C + 1, cap)
        overflow = torch.clamp(counts[:C].max() - cap, min=0)
        return sorted_state, Neighbors(
            counts=counts, overflow=overflow, cell=cell[order], key=key_s,
            rank=rank, starts=starts, bucket=bucket)

    def _moved_fields(self, state: ParticleState) -> dict:
        """The fields a rescatter moves: every field but ``_xref`` and the
        bookkeeping ones, cut to ``persistent`` where it is set."""
        return {n: arr for n, arr in state.fields.items()
                if n != "_xref" and not _is_bookkeeping(n)
                and (not self.persistent or n in self.persistent)}

    @staticmethod
    def _rescattered(state: ParticleState, moved: dict,
                     active: torch.Tensor) -> ParticleState:
        """The state after a rescatter: the moved fields, the bookkeeping
        fields in place, every other field zeroed (the step recomputes it
        before reading it) and ``_xref`` reset to the new positions."""
        fields = {n: moved[n] if n in moved else
                  arr if _is_bookkeeping(n) else torch.zeros_like(arr)
                  for n, arr in state.fields.items() if n != "_xref"}
        fields["_xref"] = fields["x"].clone()
        return ParticleState(fields=fields, active=active)

    def _full_rescatter(self, state: ParticleState):
        """Re-place every active particle at its slot rank·(C+1) + key by
        the sort move (``sorted_slot_scatter``), valid for any row placement.
        Screened-out rows and rows past ``cap`` are dropped, the latter
        counted. Returns (new_state, n_dropped)."""
        _, _, key = self._screen_and_key(state)
        moved, new_active, overflow = sorted_slot_scatter(
            key, self._moved_fields(state), self.num_cells, self.cap,
            self.slots)
        return self._rescattered(state, moved, new_active), overflow

    def _stencil_rescatter(self, state: ParticleState):
        """1-cell-local rescatter: every active particle moves to the slot
        of its new cell. Returns (new_state, n_dropped)."""
        _, _, key = self._screen_and_key(state)
        return self._stencil_compact(state, key)

    def _stencil_compact(self, state: ParticleState, key: torch.Tensor):
        """Windowed compaction over the stencil's cells. For every cell c
        and stencil offset o (offset-major, then source slot), the slots of
        cell c+o whose new key is c are packed into c's slots in scan order.
        Particles that overflow ``cap``, or land farther than one cell away,
        are dropped and counted. ``key`` is the per-slot destination cell
        ([slots] int32; ``num_cells`` = remove)."""
        C, cap = self.num_cells, self.cap
        grid = self.grid_shape
        dev = key.device
        ones = (1,) * len(grid)

        def pad1(a, value=0):
            return torch.nn.functional.pad(a, (1, 1) * len(grid), value=value)

        def sl(padded, off):
            # shifted[..., (z,) y, x] = a[..., (z+dk,) y+dj, x+di] over the
            # padded grid; off = (di, dj[, dk]), the grid axes are reversed
            idxs = tuple(slice(1 + o, 1 + o + n)
                         for o, n in zip(reversed(off), grid))
            return padded[(Ellipsis,) + idxs]

        keyg = pad1(self.grid_view(key.to(torch.int32)), value=C)
        idx = torch.arange(C, dtype=torch.int32, device=dev).reshape(grid)

        move = self._moved_fields(state)
        comps = []  # one zero-padded [cap, *grid+2] plane per component
        for arr in move.values():
            cols = [arr] if arr.ndim == 1 else [arr[:, a] for a in range(arr.shape[1])]
            comps += [pad1(self.grid_view(c)) for c in cols]
        vals = torch.stack(comps)                       # [F, cap, *grid+2]
        dt = vals.dtype

        cnt = torch.zeros(grid, dtype=torch.int32, device=dev)
        iota_k = torch.arange(cap, dtype=torch.int32,
                              device=dev).reshape((cap,) + ones)
        outs = torch.zeros((len(comps), cap) + grid, dtype=dt, device=dev)
        for off in self.stencil:
            member = sl(keyg, off) == idx                # [cap, *grid]
            sv = sl(vals, off)                           # [F, cap, *grid]
            mi = member.to(torch.int32)
            rank = cnt + torch.cumsum(mi, dim=0, dtype=torch.int32) - mi
            # one-hot placement, as the reference's k-loop: at most one
            # selected source per destination slot, so the sum is exact
            contrib = torch.zeros_like(outs)
            for k in range(cap):
                sel = ((iota_k == rank[k]) & member[k]).to(dt)  # [cap_s, *grid]
                contrib = contrib + sel[None] * sv[:, k][:, None]
            outs = outs + contrib
            cnt = cnt + mi.sum(dim=0, dtype=torch.int32)

        placed = torch.clamp(cnt, max=cap)
        dropped = ((cnt - placed).sum() + (key < C).sum()
                   - cnt.sum()).to(torch.int32)
        act_g = iota_k < placed                          # [cap, *grid]

        moved = {}
        i = 0
        for n, arr in move.items():
            if arr.ndim == 1:
                moved[n] = self.to_flat(outs[i])
                i += 1
            else:
                d = arr.shape[1]
                moved[n] = torch.stack([self.to_flat(outs[i + a])
                                        for a in range(d)], dim=-1)
                i += d
        new_active = self.to_flat(act_g.to(torch.int32)) > 0
        return self._rescattered(state, moved, new_active), dropped
