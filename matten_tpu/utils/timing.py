"""Timing + profiling: per-epoch wall time and jax profiler traces.

Reference: TimeMeter (model/utils.py:4-35). The additions SURVEY.md §5.1
calls for: a block_until_ready step timer, an edges/s counter, and
jax.profiler trace capture for xprof/tensorboard analysis.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import jax

__all__ = ["TimeMeter", "StepTimer", "profile_trace"]


class TimeMeter:
    """Epoch wall-time deltas + cumulative time."""

    def __init__(self, frequency: int = 1):
        self.frequency = frequency
        self.t0 = time.time()
        self.t_last = self.t0

    def update(self) -> tuple:
        now = time.time()
        delta = now - self.t_last
        cumulative = now - self.t0
        self.t_last = now
        return delta, cumulative


class StepTimer:
    """Synchronized step timing with an edges/s throughput counter."""

    def __init__(self):
        self.steps = 0
        self.edges = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def step(self, result_to_block=None, num_edges: int = 0):
        t0 = time.perf_counter()
        yield
        if result_to_block is not None:
            jax.block_until_ready(result_to_block)
        self.seconds += time.perf_counter() - t0
        self.steps += 1
        self.edges += num_edges

    @property
    def edges_per_s(self) -> float:
        return self.edges / self.seconds if self.seconds > 0 else 0.0


@contextlib.contextmanager
def profile_trace(logdir: str = "/tmp/matten_tpu_trace"):
    """Capture a jax profiler trace viewable in tensorboard/xprof."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()
