"""An eager evaluation of the reference's pair sweeps, shared by the port's
test files.

``reference_body_sweep`` captures a pass's hoisted fields and pair *body*
from the JAX package (``pallas_pairs._run_pair_kernel`` is intercepted, so
nothing is traced or compiled; ``reference_prepared_sweep`` intercepts
``pallas_pairs.make_pair_kernel_fn`` instead, for the ISPH matvec, which is
prepared once and streams its iterate per call) and sums the body over the stencil the way
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
import functools

import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial import cKDTree

import sph_mountain_waves_tpu.ops.pallas_pairs as pp

# XLA compile options for the reference's functions in the port's tests:
# backend optimisation level 0, the CPU backend's loop emitters for fusions
# (``xla_cpu_use_fusion_emitters`` off) and LLVM's expensive passes off.
# They only cut compile time: the reference's ISPH step compiles in about
# 15 s instead of 27 s at level 0 alone (one core), with the same CG
# iteration counts and the same max |v| after 4 steps. Every comparison's
# tolerance holds as it did at level 0.
QUICK_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_cpu_use_fusion_emitters": False,
                 "xla_llvm_disable_expensive_passes": True}


def matched_rows(jstate, tstate):
    """(JAX fields, port fields) as NumPy arrays on the active rows, the JAX
    rows in the port's order: each port row matched to the nearest JAX row
    by position (within 1e-6, one to one). After flat rebuilds the two
    packages can order rows differently: a particle on a cell edge (x = 0
    on the mountain-wave lattice) takes the key on either side as its last
    bit rounds, and the stable sorts follow the keys."""
    jf = {k: np.asarray(v) for k, v in jstate.fields.items()}
    ja = np.asarray(jstate.active)
    tf = {k: v.cpu().numpy() for k, v in tstate.fields.items()}
    ta = tstate.active.cpu().numpy()
    dist, perm = cKDTree(jf["x"][ja]).query(tf["x"][ta])
    assert dist.max() < 1e-6 and len(np.unique(perm)) == len(perm)
    return ({k: v[ja][perm] for k, v in jf.items()},
            {k: v[ta] for k, v in tf.items()})


def jit_at_level0(monkeypatch):
    """For the rest of the test, ``jax.jit`` (as the reference's own code
    calls it, e.g. inside its packings and set-ups, and the donated
    ``jax.jit`` of its ``frame_runner``, which every ``run`` compiles its
    frames with) compiles with ``QUICK_COMPILE`` (XLA backend optimisation
    level 0 and cheap CPU code generation): the optimiser dominates the
    compile of these small programs, and a test runs each of them a few
    times at most. Each jitted function compiles once per argument
    structure and shapes, as ``jax.jit`` does; a call inside another
    trace, or with jit options other than ``donate_argnums``, takes the
    real ``jax.jit``."""
    real_jit = jax.jit

    def jit(fun=None, **options):
        if fun is None:
            return functools.partial(jit, **options)
        if set(options) - {"donate_argnums"}:
            return real_jit(fun, **options)
        jitted = real_jit(fun, **options)
        compiled = {}

        @functools.wraps(fun)
        def call(*args, **kwargs):
            leaves, tree = jax.tree_util.tree_flatten((args, kwargs))
            if any(isinstance(x, jax.core.Tracer) for x in leaves):
                return jitted(*args, **kwargs)  # inside another trace
            key = (tree, tuple((np.shape(x), np.result_type(x))
                               for x in leaves))
            if key not in compiled:
                compiled[key] = jitted.lower(*args, **kwargs).compile(
                    compiler_options=QUICK_COMPILE)
            return compiled[key](*args, **kwargs)

        call.lower = jitted.lower
        return call

    monkeypatch.setattr(jax, "jit", jit)


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


def _eager_sum(je, jstate, fields, pads, body, n_out, self_pair):
    """The flat [slots] outputs of ``body`` over the hoisted resident
    ``fields`` (without the occupancy), summed eagerly in the Pallas
    harness's order."""
    cap, C, d = je.cap, je.num_cells, je.dim
    grid = tuple(reversed(je.lims))
    occ = np.asarray(je.resident(jstate.active), dtype=np.float32)
    planes = [occ] + [np.asarray(f, dtype=np.float32) for f in fields]
    pads = [0.0] + list(pads or [0.0] * len(fields))
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
    acc = [np.zeros((cap,) + grid, np.float32) for _ in range(n_out)]
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
            if not self_pair and not any(off):
                mask = mask & (k_ids != kq)
            # the body indexes q fields as q[i][None, :]: give it the shape
            # it broadcasts against by flattening the grid
            contribs = [np.asarray(c).reshape((cap,) + grid)
                        for c in body(
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
    return outs


def reference_body_sweep(pass_fn, je, jstate, jcfg, monkeypatch, **kw):
    """The flat [slots] outputs of ``pass_fn``, from its own body summed
    eagerly in the Pallas harness's order; also returns what was captured."""
    cap_ = capture_pass(pass_fn, je, jstate, jcfg, monkeypatch, **kw)
    outs = _eager_sum(je, jstate, cap_["fields"], cap_["pad_vals"],
                      cap_["body"], cap_["n_out"], cap_["self_pair"])
    return outs, cap_


def reference_prepared_sweep(prepare_fn, je, jstate, jcfg, monkeypatch):
    """For a pass prepared through ``pallas_pairs.make_pair_kernel_fn``
    (static fields built once, dynamic fields streamed per call: the ISPH
    CG matvec), ``prepare_fn(je, jstate, jcfg)`` with that harness replaced
    by the eager sum: returns what ``prepare_fn`` returns (its calls then
    sum the body eagerly over static + dynamic fields) and a dict of what
    was captured (``static``, ``n_dyn``, ``body``, ``n_out``, ``self_pair``,
    ``pad_vals``)."""
    captured = {}

    def record(engine, state, static_fields, n_dyn, pair_body, n_out,
               self_pair, interpret=False, pad_vals=None):
        captured.update(static=static_fields, n_dyn=n_dyn, body=pair_body,
                        n_out=n_out, self_pair=self_pair, pad_vals=pad_vals)

        def call(dyn_fields):
            assert len(dyn_fields) == n_dyn
            fields = list(static_fields) + list(dyn_fields)
            return [jnp.asarray(o) for o in _eager_sum(
                engine, state, fields, pad_vals, pair_body, n_out,
                self_pair)]

        return call

    monkeypatch.setattr(pp, "make_pair_kernel_fn", record)
    return prepare_fn(je, jstate, jcfg), captured
