"""Tracing / profiling helpers.

The reference's only timing instrumentation is ``time.process_time`` around
MCMC saved as ``<dataset>_mcmc_time.npy`` (reference examples/common/
mcmc.py:53-59). Here: timed sections that block on device work (so async
dispatch doesn't fake instant results), the persist-timing-artifact
pattern, and a wrapper over ``jax.profiler`` traces for TensorBoard.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import jax
import numpy as np


class _Section:
    """Handle yielded by ``Timings.section``: register the section's device
    outputs with ``hold(...)`` so the exit sync can block on THEM."""

    def __init__(self):
        self._held: list = []

    def hold(self, *arrays):
        """Register outputs whose completion defines the section's end.
        Returns the single array (or the tuple) for inline use:
        ``w = s.hold(build(...))``."""
        self._held.extend(arrays)
        return arrays[0] if len(arrays) == 1 else arrays


class Timings:
    """Accumulates named wall-clock sections; saves the reference-style
    ``*_time.npy`` artifact plus a JSON summary."""

    def __init__(self):
        self.sections: Dict[str, list] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = True):
        s = _Section()
        t0 = time.perf_counter()
        yield s
        if sync:
            # Flush async dispatch so the measurement is real. A pure jitted
            # computation has no runtime effects, so jax.effects_barrier()
            # alone returns while the device still runs: block on the
            # section's registered outputs, and run the effects barrier for
            # the effectful remainder.
            jax.block_until_ready(s._held)
            jax.effects_barrier()
        self.sections.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return float(np.sum(self.sections.get(name, [0.0])))

    def save(self, path_prefix: str) -> None:
        for name, vals in self.sections.items():
            np.save(f"{path_prefix}_{name}_time.npy", np.asarray(vals))
        with open(f"{path_prefix}_timings.json", "w") as f:
            json.dump({k: {"total_s": float(np.sum(v)), "n": len(v),
                           "mean_s": float(np.mean(v))}
                       for k, v in self.sections.items()}, f, indent=2)

    def summary(self) -> str:
        return "; ".join(f"{k}: {self.total(k):.2f}s/{len(v)}"
                         for k, v in self.sections.items())


@contextlib.contextmanager
def trace(logdir: str = "/tmp/jax-trace", enabled: bool = True):
    """jax.profiler trace context (view with TensorBoard's profile plugin)."""
    if not enabled:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace annotation for profiler timelines."""
    return jax.profiler.TraceAnnotation(name)
