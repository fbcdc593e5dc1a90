#!/usr/bin/env python3
"""Time the flat layout's pair sums (``ops/apply.py``) in four variants, one
at a time in one process:

* ``k=largest``: the shipped form, every cell and candidate block cut to the
  largest cell occupancy k (one host read per pair sum);
* ``k=cap``: the blocks at the engine's cap, as the reference sizes them
  (static shapes, no host read);
* ``written-out dist``: ``dist`` with the squared components added one by
  one in axis order instead of one ``torch.sum`` over the last axis;
* ``per-component masked sum``: ``_masked_sum`` selecting a vector
  contribution component by component instead of one ``where`` broadcast
  over the component axis.

Each variant runs a few warm-up steps of the scheme, then times whole steps
(wall clock, synchronised). The shipped variant runs first and last.

    python3 scripts/flat_block_variants.py               # on the card
    python3 scripts/flat_block_variants.py --device cpu  # one core

On the card: the flagship's flat path at full width (n_rows 246, skin 0,
f32 and f64) and ``collapse_dry.Config()`` (f64 flat, dr 0.015). On the CPU
the test sizes: the flagship at n_rows 14 (f64 flat, skin 0, the cross-layout
gate's flat side) and ``collapse_dry`` at dr 0.08. Prints one line per
configuration and variant, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from sph_mountain_waves_tpu_torch.models import (  # noqa: E402
    collapse_dry as cd, wcsph_perturbed_witch as w,
)
from sph_mountain_waves_tpu_torch.models.witch_common import (  # noqa: E402
    WitchConfig,
)
from sph_mountain_waves_tpu_torch.ops import apply  # noqa: E402

SHIPPED = {name: getattr(apply, name)
           for name in ("_largest_count", "dist", "_masked_sum")}


def _written_out_dist(p_x, q_x):
    d = p_x - q_x
    d2 = d[..., 0] * d[..., 0]
    for a in range(1, d.shape[-1]):
        d2 = d2 + d[..., a] * d[..., a]
    return torch.sqrt(d2)


def _per_component_masked_sum(contrib, mask, dtype, dim):
    contrib = contrib.to(dtype)
    if contrib.ndim != mask.ndim + 1:
        return SHIPPED["_masked_sum"](contrib, mask, dtype, dim)
    return torch.stack([torch.sum(torch.where(mask, contrib[..., a], 0.0),
                                  dim=dim)
                        for a in range(contrib.shape[-1])], dim=-1)


VARIANTS = {
    "k=largest": {},
    "k=cap": {"_largest_count": lambda engine, nbrs: engine.cap},
    "written-out dist": {"dist": _written_out_dist},
    "per-component masked sum": {"_masked_sum": _per_component_masked_sum},
}


def sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def time_variant(module, cfg, dev, variant, warm, n):
    """(ms/step, largest occupancy, cap, pair mode, peak GiB) of ``n``
    steps after ``warm`` steps, from a fresh frozen state."""
    for name, fn in {**SHIPPED, **VARIANTS[variant]}.items():
        setattr(apply, name, fn)
    system = module.make_system(cfg)
    state = system.freeze(device=dev)
    step = module.make_step(cfg, system.engine)
    if isinstance(step, tuple):  # collapse_dry: (step, init_forces)
        step, init = step
        state = init(state)
    for _ in range(warm):
        state = step(state)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        state = step(state)
    sync(dev)
    ms = 1e3 * (time.perf_counter() - t0) / n
    _, nbrs = system.engine.rebuild(state)
    eng = system.engine
    k = int(nbrs.counts[: eng.num_cells].max())
    peak = (torch.cuda.max_memory_allocated() / 2**30 if dev == "cuda"
            else float("nan"))
    if int(state.n) != system.n_built or not bool(
            torch.isfinite(state.fields["v"]).all()):
        raise AssertionError(f"{variant}: lost particles or non-finite v")
    for name, fn in SHIPPED.items():
        setattr(apply, name, fn)
    return ms, k, eng.cap, eng.pair_mode, peak, system.n_built


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    dev = args.device
    if dev == "cuda":
        if not torch.cuda.is_available():
            sys.exit("no CUDA device")
        cases = [
            ("flagship flat f32 n_rows 246", w,
             WitchConfig(n_rows=246, layout="flat", skin=0.0,
                         self_density=True, dtype="float32"), 3, 20),
            ("flagship flat f64 n_rows 246", w,
             WitchConfig(n_rows=246, layout="flat", skin=0.0,
                         self_density=True, dtype="float64"), 3, 20),
            ("collapse_dry Config() f64 flat", cd, cd.Config(), 5, 100),
        ]
    else:
        torch.set_num_threads(1)
        cases = [
            ("flagship flat f64 n_rows 14", w,
             WitchConfig(n_rows=14, layout="flat", skin=0.0,
                         self_density=True, dtype="float64"), 1, 10),
            ("collapse_dry dr 0.08 f64 flat", cd, cd.Config(dr=0.08), 1, 10),
        ]
    order = list(VARIANTS) + ["k=largest"]
    for label, module, cfg, warm, n in cases:
        for variant in order:
            ms, k, cap, mode, peak, n_built = time_variant(
                module, cfg, dev, variant, warm, n)
            print(f"{label}: N={n_built} cap {cap} largest occupancy {k} "
                  f"pair mode {mode}; {variant}: {ms:.3f} ms/step over {n} "
                  f"steps; peak {peak:.2f} GiB", flush=True)
            if dev == "cuda":
                torch.cuda.empty_cache()
    if dev == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(f"card: {card.strip()}")
    else:
        print("device: cpu, one thread")


if __name__ == "__main__":
    main()
