"""Performance instrumentation: a frame timer and a profiler session.

Port of ``sph_mountain_waves_tpu/utils/metrics.py``. ``StepTimer``
accumulates (steps, particles, wall seconds) per frame and reports
particle-steps/s; ``stop`` waits for the card's queued work first when it
is handed a CUDA tensor of the frame (``torch.cuda.synchronize``), since
kernels run asynchronously. ``trace(logdir)`` records the enclosed block
with ``torch.profiler`` (CPU activity, and CUDA activity where a card is
present) and writes a Chrome trace into ``logdir`` (viewable in
TensorBoard's profiler plugin or Perfetto).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

__all__ = ["StepTimer", "trace"]


class StepTimer:
    """Accumulates (steps, particles, wall) per frame; reports
    particle-steps/s. Pass ``sync_array`` (any tensor of the frame's
    result) to ``stop`` so that the frame's card work has finished before
    the clock is read."""

    def __init__(self):
        self.frames: list[tuple[int, int, float]] = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_steps: int, n_particles: int, sync_array=None):
        if isinstance(sync_array, torch.Tensor) and sync_array.is_cuda:
            torch.cuda.synchronize(sync_array.device)
        dt = time.perf_counter() - self._t0
        self.frames.append((n_steps, n_particles, dt))
        return dt

    @property
    def particle_steps_per_sec(self) -> float:
        work = sum(s * n for s, n, _ in self.frames)
        wall = sum(t for _, _, t in self.frames)
        return work / wall if wall else 0.0

    @property
    def series(self) -> np.ndarray:
        return np.asarray([[s, n, t] for s, n, t in self.frames])


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace of the enclosed block, written to ``logdir``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
