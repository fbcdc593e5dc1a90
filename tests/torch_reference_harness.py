"""An eager evaluation of the reference's pair sweeps, shared by the port's
test files.

``reference_body_sweep`` captures a pass's hoisted fields and pair *body*
from the JAX package (``pallas_pairs._run_pair_kernel`` is intercepted, so
nothing is traced or compiled) and sums the body over the stencil the way
the Pallas harness does: q ranks outermost; for each rank the 9 (2-D) or 27
(3-D) offsets, the last axis' offset outermost, summed before they are added
to the accumulator; mask = both slots occupied, r² ≤ h² and, unless the pass
includes the self pair, q ≠ p. One interpret-mode ``pallas_call`` per kernel
ties this harness to the real thing (the test files say which); every
further variant, and every 3-D pass, whose interpret-mode unroll grows with
cap × 27, is held against this evaluation.

With ``cfg.fast_math`` the reference body multiplies by
``pl.reciprocal(approx=True)``. Its documented interpret-mode value is the
exact reciprocal (``_div_fn``'s docstring), which is what the port's twins
compute, so the body runs here with ``a * (1.0 / b)``.
"""
import jax.numpy as jnp
import numpy as np

import sph_mountain_waves_tpu.ops.pallas_pairs as pp


def capture_pass(pass_fn, je, jstate, jcfg, monkeypatch, **kw):
    """What ``pass_fn(je, jstate, jcfg, **kw)`` hands to the pair harness:
    a dict with ``fields`` (hoisted resident planes, without the occupancy),
    ``body``, ``n_out``, ``self_pair`` and ``pad_vals``."""
    captured = {}

    def record(engine, state, fields, body, n_out, self_pair, interpret=False,
               pad_vals=None):
        captured.update(fields=fields, body=body, n_out=n_out,
                        self_pair=self_pair, pad_vals=pad_vals)
        return [jnp.zeros(engine.slots)] * n_out

    monkeypatch.setattr(pp, "_run_pair_kernel", record)
    monkeypatch.setattr(pp, "_div_fn", lambda cfg, interpret: (
        (lambda a, b: a * (1.0 / b)) if getattr(cfg, "fast_math", False)
        else (lambda a, b: a / b)))
    pass_fn(je, jstate, jcfg, **kw)
    return captured


def reference_body_sweep(pass_fn, je, jstate, jcfg, monkeypatch, **kw):
    """The flat [slots] outputs of ``pass_fn``, from its own body summed
    eagerly in the Pallas harness's order; also returns what was captured."""
    cap_ = capture_pass(pass_fn, je, jstate, jcfg, monkeypatch, **kw)
    cap, C, d = je.cap, je.num_cells, je.dim
    grid = tuple(reversed(je.lims))
    occ = np.asarray(je.resident(jstate.active), dtype=np.float32)
    planes = [occ] + [np.asarray(f, dtype=np.float32) for f in cap_["fields"]]
    pads = [0.0] + list(cap_["pad_vals"] or [0.0] * len(cap_["fields"]))
    G = [p[:, :C].reshape((cap,) + grid) for p in planes]
    # only the bounding box of the occupied cells: outside it there is no p
    # slot and, as in the pads, no q slot
    full = grid
    cells = G[0].sum(axis=0) > 0.5
    box = tuple(slice(int(ix.min()), int(ix.max()) + 1)
                for ix in np.nonzero(cells))
    G = [g[(slice(None),) + box] for g in G]
    grid = G[0].shape[1:]
    P = [np.pad(g, ((0, 0),) + ((1, 1),) * d, constant_values=v)
         for g, v in zip(G, pads)]
    hh = np.float32(je.h * je.h)
    k_ids = np.arange(cap).reshape((cap,) + (1,) * d)
    kmax = int(occ[:, :C].sum(axis=0).max())
    acc = [np.zeros((cap,) + grid, np.float32) for _ in range(cap_["n_out"])]
    for kq in range(kmax):
        tot = None
        for off in je.stencil:  # (di, dj[, dk]), the last axis outermost
            window = (kq,) + tuple(slice(1 + o, 1 + o + n)
                                   for o, n in zip(reversed(off), grid))
            q = [Pf[window] for Pf in P]
            r2 = (G[1] - q[1]) ** 2
            for a in range(2, 1 + d):
                r2 = r2 + (G[a] - q[a]) ** 2
            mask = (G[0] > 0.5) & (q[0] > 0.5) & (r2 <= hh)
            if not cap_["self_pair"] and not any(off):
                mask = mask & (k_ids != kq)
            # the body indexes q fields as q[i][None, :]: give it the shape
            # it broadcasts against by flattening the grid
            contribs = [np.asarray(c).reshape((cap,) + grid)
                        for c in cap_["body"](
                            [g.reshape(cap, -1) for g in G],
                            [x.reshape(-1) for x in q],
                            r2.reshape(cap, -1),
                            mask.astype(np.float32).reshape(cap, -1))]
            tot = contribs if tot is None else [
                t + c for t, c in zip(tot, contribs)]
        acc = [a + t for a, t in zip(acc, tot)]
    outs = []
    for a in acc:
        whole = np.zeros((cap,) + full, np.float32)
        whole[(slice(None),) + box] = a
        outs.append(np.pad(whole.reshape(cap, C), ((0, 0), (0, 1))).reshape(-1))
    return outs, cap_
