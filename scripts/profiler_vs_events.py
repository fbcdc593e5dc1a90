#!/usr/bin/env python3
"""Hold the kernel time that ``chip_smoke.py::kernel_ms`` reads from
torch.profiler against two CUDA-event times of the same launches, in a
fresh process on one card: the event time of 50 launches from Python
(``chip_smoke.py::cuda_ms``, the launch path included) and the event time
per launch of a CUDA graph that replays 50 launches (no host path between
them, so the card's own time). Three launches: the flagship's tiled
momentum and its 2-D density (``pair_sweep``) on the flagship state after
100 steps, and the ISPH matvec in its prepared form on the kicked ISPH
baseline one step in (no graph: a prepared launch holds the stream it was
prepared on, so a capture would not hold it).

    python3 scripts/profiler_vs_events.py

Prints one line per launch and the card (nvidia-smi name and power limit).
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def graph_ms(fn, reps):
    """Event time per launch of a CUDA graph replaying ``reps`` calls of
    fn() (captured after one warm-up call on a side stream)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cs.cuda_ms(graph.replay, 5) / reps


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    dev = torch.device("cuda", 0)
    from sph_mountain_waves_tpu_torch.models import (
        isph_witch as iw, wcsph_perturbed_witch as w,
    )
    from sph_mountain_waves_tpu_torch.models.common import frame_runner
    from sph_mountain_waves_tpu_torch.models.witch_common import WitchConfig
    from sph_mountain_waves_tpu_torch.ops import pair_sweeps as ps

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cfg = WitchConfig(n_rows=cs.N_ROWS, dtype="float32", self_density=True,
                      layout="bucket", skin=0.15, use_pallas=True,
                      lazy_diagnostics=True, lattice_cells=True,
                      fast_math=True)
    system = w.make_system(cfg)
    state = system.freeze(device=dev)
    e = system.engine
    state = frame_runner(w.make_step(cfg, e), cs.STEPS_PER_FRAME,
                         finalize=w.make_finalize(cfg))(state)
    planes, _ = ps._momentum_inputs(e, state, cfg)
    band = ps._trip_bound("momentum_sweep", e, state)
    args = ps._momentum_scalars(cfg) + [1]
    dplanes, _ = ps._density_inputs(e, state, state.fields["m"])
    dband = ps._trip_bound("density_sweep", e, state)
    dargs = [1, ps.ctypes.c_float(ps.C_W2)]

    icfg = iw.baseline_config()
    isys = iw.make_system(icfg)
    ist = cs.kick(isys.freeze(device=dev), dev)
    ist = iw.make_step(icfg, isys.engine)(ist)
    it = ist.fields["P"].contiguous()
    mv = ps.isph_matvec_prepared(isys.engine, ist, icfg)

    for label, fn, graphed in (
            ("momentum_sweep (tiled)",
             lambda: ps._launch("momentum_sweep", e, planes, band, 2, args),
             True),
            ("density_sweep",
             lambda: ps._launch("density_sweep", e, dplanes, dband, 1,
                                dargs), True),
            ("isph_matvec_sweep (prepared)", lambda: mv(it), False)):
        events = cs.cuda_ms(fn, 50)
        kernel, recorded = cs.kernel_ms(fn, 50)
        replay = f"{graph_ms(fn, 50):.4f} ms per launch" if graphed else "n/a"
        print(f"{label}: events {events:.4f} ms, torch.profiler kernel time "
              f"{kernel:.4f} ms ({recorded} kernels recorded), CUDA graph "
              f"replay {replay} ({card})", flush=True)
    print(card)


if __name__ == "__main__":
    main()
