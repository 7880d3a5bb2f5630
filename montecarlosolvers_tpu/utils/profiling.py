"""Profiling helpers: flips/sec counters and JAX profiler traces — the
tracing layer the reference disables outright (`# cython: profile=False`,
sa.pyx:2; SURVEY.md §5)."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import jax


class FlipCounter:
    """Wall-clock spin-flip-attempt throughput for a timed region.

    `stop` takes the result and waits for it with `jax.block_until_ready`,
    so the region covers the device work and not only its dispatch.
    """

    def __init__(self):
        self.attempts = 0
        self._t0 = None
        self.elapsed = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def add_sweeps(self, n_sweeps, nspins, chains=1):
        self.attempts += int(n_sweeps) * int(nspins) * int(chains)

    def stop(self, result=None):
        if result is not None:
            jax.block_until_ready(result)
        self.elapsed = time.perf_counter() - self._t0
        return self

    @property
    def rate(self):
        return self.attempts / self.elapsed if self.elapsed else float("nan")


@contextlib.contextmanager
def trace(logdir=None):
    """JAX profiler trace context — open in XProf/TensorBoard. Writes to
    `logdir`, by default `mcs_trace` under the temporary directory."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "mcs_trace")
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label="region", fetch=None, verbose=True):
    """Time a region; `fetch` (a pytree of arrays) is waited on with
    `jax.block_until_ready` before the clock stops."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        if fetch is not None:
            jax.block_until_ready(fetch)
        box["elapsed"] = time.perf_counter() - t0
        if verbose:
            print(f"{label}: {box['elapsed']:.3f}s")
