"""Tracing / profiling hooks (SURVEY.md §5).

`trace(dir)` wraps a region in `jax.profiler.trace` (Perfetto/XProf —
shows device kernels and H2D streams); `cost(fn, *args)` reports XLA's
static cost analysis for a jitted callable (per-bench kernel cost,
SURVEY.md §5 "Tracing / profiling").
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict

import jax


@contextlib.contextmanager
def trace(log_dir: str = "./prof"):
    with jax.profiler.trace(log_dir):
        yield


@contextlib.contextmanager
def timed(label: str, sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {(time.perf_counter() - t0) * 1e3:.2f} ms")


def cost(fn, *args, static_argnames=()) -> Dict[str, Any]:
    """Compile fn on args and return XLA cost analysis (flops, bytes)."""
    jitted = jax.jit(fn, static_argnames=static_argnames)
    compiled = jitted.lower(*args).compile()
    try:
        analysis = compiled.cost_analysis()
        if isinstance(analysis, list):
            analysis = analysis[0]
    except Exception:
        analysis = {}
    mem = {}
    try:
        ma = compiled.memory_analysis()
        mem = {"output_bytes": getattr(ma, "output_size_in_bytes", None),
               "temp_bytes": getattr(ma, "temp_size_in_bytes", None),
               "argument_bytes": getattr(ma, "argument_size_in_bytes", None)}
    except Exception:
        pass
    return {"cost": analysis, "memory": mem}
