"""Tracing / profiling / observability (SURVEY §5.1, §5.5).

The reference's observability is counters (``Simulatable.sim_count``,
``Model.call_count``) and wall-clock per update (``perf_testing``). The
This package keeps those (on ``SMCUpdater``) and adds:

- ``ThroughputMeter``: the north-star particle-updates/s meter;
- ``trace``: context manager around ``jax.profiler`` device traces;
- ``annotate``: named-scope annotation for profiler timelines.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["ThroughputMeter", "trace", "annotate"]


class ThroughputMeter:
    """Accumulates particle-updates and wall time → particles/s.

    Usage::

        meter = ThroughputMeter()
        with meter.measure(n_particles * n_updates):
            updater.batch_update(outcomes, expparams)
        print(meter.particles_per_second)
    """

    def __init__(self):
        self.total_particle_updates = 0
        self.total_seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_particle_updates, sync=None):
        t0 = time.perf_counter()
        yield self
        if sync is not None:
            jax.block_until_ready(sync)
        self.total_seconds += time.perf_counter() - t0
        self.total_particle_updates += int(n_particle_updates)

    @property
    def particles_per_second(self):
        if self.total_seconds == 0:
            return 0.0
        return self.total_particle_updates / self.total_seconds

    def report(self):
        return {
            "particle_updates": self.total_particle_updates,
            "seconds": self.total_seconds,
            "particle_updates_per_s": self.particles_per_second,
        }


@contextlib.contextmanager
def trace(log_dir="/tmp/qinfer_tpu_trace"):
    """Capture a jax.profiler device trace around a block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


annotate = jax.profiler.TraceAnnotation
