"""Operator API: ``apply_unary`` / ``apply_binary`` / ``pair_sum``.

Port of ``sph_mountain_waves_tpu/ops/apply.py``:

* a **unary** action is a function of the particle view returning a dict of
  new field values; ``apply_unary`` builds a new state from them and never
  writes into the old one;
* a **binary** action is a function ``f(p, q, r) -> {field: contribution}``
  evaluated on every neighbour pair of the flat layout and summed over the
  neighbours into the named fields of ``p``, with a fixed reduction order:
  for each stencil offset the q axis is summed, then the offsets are added
  in stencil order (the last axis' offset outermost).

Shapes inside a binary action: ``r`` is [N, K]; scalar fields are ``p.m`` →
[N, 1], ``q.m`` → [N, K]; vector fields are ``p.x`` → [N, 1, d], ``q.x`` →
[N, K, d] (in ``pair_mode="cell"`` the leading N is the cell axis and the
next the in-cell rank: p → [C, cap, 1], q → [C, 1, cap]). Broadcast a scalar
factor onto a vector with ``[..., None]``. Pairs beyond the interaction
radius, empty slots and a particle with itself are masked: their ``r`` is
presented as 2h, so compact-support kernels vanish, and their contributions
are zeroed by selection.

``self_interaction=True`` adds the r = 0 diagonal term once per active
particle.

The binary operator runs on the flat layout only, in 2-D (9 stencil
offsets) and 3-D (27), in plain PyTorch on the state's device: the
reference takes it (an XLA pair sum, no Pallas kernel) wherever its Pallas
sweeps do not run; ``ops/solvers.py`` builds the flat pressure solves'
operators on the same per-row candidate blocks. On the bucket layout the
schemes call the pair sweeps of ``ops/pair_sweeps.py`` instead; the
reference's resident form of this operator (``_binary_sums_resident``)
belongs to a later slice.

``point_sum`` interpolates at arbitrary probe points (the cavity's
centerline probes): each probe binned into the cell grid, its stencil
cells' candidates from the bucket table (on the bucket layout the slots
themselves), a masked sum over each offset's candidates in stencil order.
"""
from __future__ import annotations

import torch

from ..structs import ParticleState

__all__ = ["apply_unary", "apply_binary", "pair_sum", "point_sum", "dist",
           "FieldsView"]


def dist(p_x, q_x):
    """Pair distance: sqrt of the squared component differences summed over
    the last axis."""
    return torch.sqrt(torch.sum((p_x - q_x) ** 2, dim=-1))


class FieldsView:
    """Attribute/item access to particle fields, optionally gathered or
    expanded.

    ``idx`` given: each field gathered by the candidate rows [N, K] →
    [N, K(, d)] (the q side); ``expand``: scalar → [N, 1], vector →
    [N, 1, d] (the p side, broadcast against the K axis); neither: the raw
    [N(, d)] tensors (unary actions).
    """

    def __init__(self, fields: dict, idx=None, expand: bool = False):
        object.__setattr__(self, "_fields", fields)
        object.__setattr__(self, "_idx", idx)
        object.__setattr__(self, "_expand", expand)

    def __getitem__(self, name: str):
        arr = self._fields[name]
        if self._idx is not None:
            return arr[self._idx]
        if self._expand:
            return arr[:, None]
        return arr

    def __getattr__(self, name: str):
        try:
            return self.__getitem__(name)
        except KeyError as e:
            raise AttributeError(name) from e


def _bmask(mask, val):
    """Broadcast a mask over any trailing component dims of val."""
    return mask.reshape(tuple(mask.shape) + (1,) * (val.ndim - mask.ndim))


def apply_unary(state: ParticleState, action, where=None,
                **params) -> ParticleState:
    """Apply a pointwise action: ``action(p, **params)`` receives the
    raw-field view and returns a dict of new field values. With ``where``
    (a bool [N] mask, or a function of the view returning one) the updates
    apply only where it is true. Every updated field is zeroed on inactive
    rows: unary physics on empty rows (0/0, pow(0, .)) breeds NaN/Inf, and
    the pair sums need every empty row finite."""
    view = FieldsView(state.fields)
    updates = action(view, **params)
    if where is not None:
        mask = where(view) if callable(where) else where
        updates = {name: torch.where(_bmask(mask, val), val, state.fields[name])
                   for name, val in updates.items()}
    act = state.active
    updates = {name: torch.where(_bmask(act, val), val, 0.0)
               for name, val in updates.items()}
    return state.replace(**updates)


def _masked_sum(contrib, mask, dtype, dim):
    """Sum of the contributions over ``dim`` with masked pairs zeroed by
    selection."""
    contrib = contrib.to(dtype)
    return torch.sum(torch.where(_bmask(mask, contrib), contrib, 0.0),
                     dim=dim)


def _offset_sums(contrib, mask, dtype, n_offsets):
    """Pair sums of contributions laid out [..., S·k(, d)] (the last pair
    axis holds the S stencil offsets' k candidates, offset-major): each
    offset's k candidates summed, then the offsets added in stencil order,
    as the reference sums them (one offset at a time)."""
    lead = tuple(mask.shape[:-1])
    k = mask.shape[-1] // n_offsets
    contrib = torch.broadcast_to(
        contrib, tuple(mask.shape) + tuple(contrib.shape[mask.ndim:]))
    per = _masked_sum(contrib.reshape(lead + (n_offsets, k)
                                      + tuple(contrib.shape[mask.ndim:])),
                      mask.reshape(lead + (n_offsets, k)), dtype,
                      dim=mask.ndim)
    acc = per.select(mask.ndim - 1, 0)
    for o in range(1, n_offsets):
        acc = acc + per.select(mask.ndim - 1, o)
    return acc


def apply_binary(engine, state: ParticleState, nbrs, action, add: bool = True,
                 self_interaction: bool = False, **params) -> ParticleState:
    """Apply a binary action over all neighbour pairs of the flat layout and
    sum into p's fields. ``action(p, q, r, **params)`` returns
    ``{field: [N, K(, d)] contribution}``. With ``add=True`` the sums are
    added to the fields' values, with ``add=False`` they replace them."""
    sums = _binary_sums(engine, state, nbrs, action, self_interaction, params)
    return state.replace(**{
        name: (state.fields[name] + val) if add else val
        for name, val in sums.items()})


def pair_sum(engine, state: ParticleState, nbrs, func,
             self_interaction: bool = False, **params) -> torch.Tensor:
    """Per-particle neighbour sum of a scalar pair function
    ``func(p, q, r)`` → [N, K]."""
    sums = _binary_sums(engine, state, nbrs,
                        lambda p, q, r, **kw: {"__out__": func(p, q, r, **kw)},
                        self_interaction, params)
    return sums["__out__"]


def point_sum(engine, state: ParticleState, nbrs, func, xs,
              **params) -> torch.Tensor:
    """SPH interpolation at arbitrary points: ``xs`` [M, dim] (or one
    point [dim]; anything ``torch.as_tensor`` takes), ``func(q, r,
    **params)`` receives the q fields gathered to [M, cap] and the
    distances [M, cap] (2h where masked) and returns [M, cap]; the result
    [M] is the masked sum over every particle within h of each point.

    Probes are binned with the per-axis cell widths and the engine's phase
    (cells are skin-widened and may be lattice-aligned, so not h wide); a
    stencil cell outside the grid takes the trash key and no candidate.
    On the flat layout a cell's candidates are its bucket-table rows; on
    the bucket layout the cell's slots rank·(C+1) + key, the reference's
    implicit table. Each offset's candidates are summed, then the offsets
    added in stencil order. Plain PyTorch on the state's device."""
    x = state.fields["x"]
    dev = x.device
    xs = torch.as_tensor(xs, dtype=x.dtype, device=dev)
    if xs.ndim == 1:
        xs = xs[None]
    h = torch.tensor(engine.h, dtype=x.dtype, device=dev)
    L = torch.tensor(engine.cell_size, dtype=x.dtype, device=dev)
    phase = torch.tensor(engine.phase, dtype=torch.int32, device=dev)
    lims = torch.tensor(engine.lims, dtype=torch.int32, device=dev)
    C = engine.num_cells
    cell = torch.floor(xs / L).to(torch.int32) - phase
    ranks = torch.arange(engine.cap, dtype=torch.int32, device=dev)
    out = torch.zeros(xs.shape[0], dtype=x.dtype, device=dev)
    for offset in engine.stencil:
        ncell = cell + torch.tensor(offset, dtype=torch.int32, device=dev)
        in_grid = torch.all((ncell >= 0) & (ncell < lims), dim=-1)
        clipped = torch.minimum(torch.clamp(ncell, min=0), lims - 1)
        nkey = torch.where(in_grid, engine.flat_key(clipped), C).long()
        cnt = torch.where(in_grid, nbrs.counts[nkey], 0)
        if nbrs.bucket is not None:
            cand = nbrs.bucket[nkey].long()
        else:
            cand = ranks.long()[None, :] * (C + 1) + nkey[:, None]
        valid = ranks[None, :] < cnt[:, None]
        r = dist(xs[:, None, :], x[cand])
        mask = valid & (r <= h)
        val = func(FieldsView(state.fields, idx=cand),
                   torch.where(mask, r, 2.0 * h), **params)
        out = out + torch.sum(torch.where(mask, val, 0), dim=1)
    return out


class _BucketView:
    """Bucketized field access for the cell-dense pair sums: the p side
    [C, k, 1(, d)], or with ``stencil`` the q side of every stencil offset
    at once [C, 1, S·k(, d)] (offset-major). Each field is bucketized and
    padded once (cached) and the q side is cut from slices of the padded
    grid, never gathered."""

    def __init__(self, engine, nbrs, fields, cache, stencil=False):
        object.__setattr__(self, "_e", engine)
        object.__setattr__(self, "_n", nbrs)
        object.__setattr__(self, "_f", fields)
        object.__setattr__(self, "_c", cache)
        object.__setattr__(self, "_q", stencil)

    def _bucket(self, name):
        if name not in self._c:
            self._c[name] = self._e.bucketize(
                self._n, self._f[name])[:, : self._c["ranks"]]
        return self._c[name]

    def __getitem__(self, name):
        B = self._bucket(name)
        e = self._e
        if not self._q:
            return B[: e.num_cells].unsqueeze(2)
        key = ("q", name)
        if key not in self._c:
            P = e.pad_cells(B)
            self._c[key] = torch.cat([e.slice_cells(P, off)
                                      for off in e.stencil], dim=1)
        return self._c[key].unsqueeze(1)

    def __getattr__(self, name):
        try:
            return self.__getitem__(name)
        except KeyError as e:
            raise AttributeError(name) from e


def _largest_count(engine, nbrs) -> int:
    """The largest occupancy of a cell, at least 1 and at most cap (one
    read on the host): ranks past it are empty in every cell, so their
    pairs are all masked and the sums are those over all cap ranks. On an
    H100 (scripts/flat_block_variants.py) the cut takes the flagship's
    full-width flat step (cap 8, largest occupancy 4) from 63.5 to 22.0 ms
    in float32 and its peak memory from 14.0 to 4.0 GiB."""
    return max(1, min(engine.cap, int(nbrs.counts[: engine.num_cells].max())))


def _binary_sums_cell(engine, state, nbrs, action, params) -> dict:
    """Cell-dense pair sums: one dense [C, k, S·k] block holding every
    stencil offset's [C, k, k] block (S offsets, k = the largest occupancy
    of a cell), no gather in the pair loop (one per field at bucketize time
    and one per output at the end)."""
    x = state.fields["x"]
    dtype = x.dtype
    C, S = engine.num_cells, len(engine.stencil)
    h = torch.tensor(engine.h, dtype=dtype, device=x.device)
    k = _largest_count(engine, nbrs)

    cache: dict = {"ranks": k}
    occ = engine.occupancy(nbrs)[:, :k]                       # [C+1, k]
    occ_pad = engine.pad_cells(occ)
    occ_q = torch.cat([engine.slice_cells(occ_pad, off)
                       for off in engine.stencil], dim=1)     # [C, S·k]
    pview = _BucketView(engine, nbrs, state.fields, cache)
    qview = _BucketView(engine, nbrs, state.fields, cache, stencil=True)
    r = dist(pview.x, qview.x)                                # [C, k, S·k]
    mask = occ[:C][:, :, None] & occ_q[:, None, :] & (r <= h)
    # a particle is not its own neighbour: the diagonal of offset (0, 0)
    ranks = torch.arange(k, device=x.device)
    centre = engine.stencil.index((0,) * engine.dim)
    not_self = torch.ones((k, S, k), dtype=torch.bool, device=x.device)
    not_self[:, centre] = ranks[:, None] != ranks[None, :]
    mask = mask & not_self.reshape(k, S * k)
    r_safe = torch.where(mask, r, 2.0 * h)
    acc = {name: _offset_sums(val, mask, dtype, S)
           for name, val in action(pview, qview, r_safe, **params).items()}

    # back to the row order: out[i] = acc[key_i, rank_i] (an active row
    # within cap has rank < k)
    ok = state.active & (nbrs.rank < engine.cap)
    idx = torch.where(ok, nbrs.key * k + nbrs.rank, C * k)
    idx = torch.clamp(idx, max=C * k - 1).long()
    out: dict = {}
    for name, val in acc.items():
        g = val.reshape((C * k,) + tuple(val.shape[2:]))[idx]
        out[name] = torch.where(_bmask(ok, g), g, 0.0)
    return out


def _binary_sums_gather(engine, state, nbrs, action, params) -> dict:
    """Per-row pair sums: each row's candidates at every stencil offset
    gathered from the bucket table at once, [N, S·k] (offset-major, cut to
    the largest occupancy k of a cell)."""
    x = state.fields["x"]
    dtype = x.dtype
    n, S = x.shape[0], len(engine.stencil)
    h = torch.tensor(engine.h, dtype=dtype, device=x.device)
    k = _largest_count(engine, nbrs)
    rows = torch.arange(n, dtype=torch.int32, device=x.device)

    cand, valid = engine.stencil_candidates(nbrs, engine.stencil)
    cand = cand[:, :, :k].reshape(n, S * k)
    valid = valid[:, :, :k].reshape(n, S * k)
    cand_l = cand.long()
    r = dist(x[:, None, :], x[cand_l])                        # [N, S·k]
    mask = (valid & (r <= h) & (cand != rows[:, None])
            & state.active[:, None])
    r_safe = torch.where(mask, r, 2.0 * h)
    pview = FieldsView(state.fields, expand=True)
    qview = FieldsView(state.fields, idx=cand_l)
    return {name: _offset_sums(val, mask, dtype, S)
            for name, val in action(pview, qview, r_safe, **params).items()}


def _binary_sums(engine, state, nbrs, action, self_interaction, params) -> dict:
    if engine.layout != "flat":
        raise NotImplementedError(
            "apply_binary runs on the flat layout; on the bucket layout the "
            "schemes call the pair sweeps of ops/pair_sweeps.py (the "
            "resident form of this operator is not ported)")
    if engine.pair_mode == "cell":
        acc = _binary_sums_cell(engine, state, nbrs, action, params)
    else:
        acc = _binary_sums_gather(engine, state, nbrs, action, params)

    if self_interaction:
        # the r = 0 diagonal, once per active particle
        x = state.fields["x"]
        uview = FieldsView(state.fields, expand=True)
        zero_r = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
        amask = state.active[:, None]
        for name, val in action(uview, uview, zero_r, **params).items():
            acc[name] = acc[name] + _masked_sum(val, amask, x.dtype, dim=1)
    return acc
