"""Standalone async computation tracker + observability taps.

Reference analogs:
  * ``StandAloneJobHandler`` (/root/reference/Pipeline/StandAloneJob/
    StandAloneJobHandler.cs:6-36) — track/poll/complete one JobHandle
    outside a pipeline (used by LiveErosion's cycle scheduling);
  * the profiler markers / stopwatch logs sprinkled through the DAG
    hotspots (SURVEY.md §5 tracing) — here ``stage_timer`` +
    ``jax.profiler`` trace hooks;
  * array-stats taps (min/max/mean/NaN counts) as the structured-logging
    replacement for the reference's Debug.Log observability.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Any

import jax
import numpy as np

log = logging.getLogger("noize_tpu")


class StandAloneJobHandler:
    """Track one in-flight device computation (a pytree of jax.Arrays).

    JAX dispatch is asynchronous, so 'scheduled' work is simply arrays whose
    results haven't materialized; ``job_complete`` polls readiness without
    blocking, ``close_job`` joins."""

    def __init__(self):
        self.is_running = False
        self.handle: Any = None

    def track_job(self, arrays) -> bool:
        self.handle = arrays
        self.is_running = True
        return True

    def _leaves(self):
        return [x for x in jax.tree_util.tree_leaves(self.handle)
                if hasattr(x, "is_ready")]

    def job_complete(self) -> bool:
        if not self.is_running:
            return False
        return all(x.is_ready() for x in self._leaves())

    def close_job(self) -> bool:
        if not self.job_complete():
            return False
        jax.block_until_ready(self.handle)
        self.is_running = False
        return True

    def wait(self):
        if self.is_running:
            jax.block_until_ready(self.handle)
            self.is_running = False
        return self.handle


@contextlib.contextmanager
def stage_timer(name: str, sync: bool = False, result=None):
    """'scheduled in Xms / completed in Yms' log-shape parity
    (Pipeline.cs:115-126, 169-171)."""
    t0 = time.perf_counter()
    yield
    t_sched = (time.perf_counter() - t0) * 1e3
    if sync and result is not None:
        jax.block_until_ready(result)
        t_done = (time.perf_counter() - t0) * 1e3
        log.info("%s scheduled in (%.1fms), completed in %.1fms",
                 name, t_sched, t_done)
    else:
        log.info("%s scheduled in (%.1fms)", name, t_sched)


def array_stats(name: str, arr, warn_nonfinite: bool = True) -> dict:
    """Per-stage array tap: min/max/mean/nan — the structured replacement
    for the reference's invariant-violation Debug.LogError calls."""
    a = np.asarray(arr)
    finite = np.isfinite(a)
    stats = {
        "name": name,
        "shape": tuple(a.shape),
        "min": float(a[finite].min()) if finite.any() else float("nan"),
        "max": float(a[finite].max()) if finite.any() else float("nan"),
        "mean": float(a[finite].mean()) if finite.any() else float("nan"),
        "nonfinite": int((~finite).sum()),
    }
    if warn_nonfinite and stats["nonfinite"]:
        log.warning("array %s has %d non-finite values", name, stats["nonfinite"])
    return stats


@contextlib.contextmanager
def device_trace(outdir: str):
    """jax.profiler trace context — the Unity Profiler marker analog.

    Checked on the CPU backend (tests/test_misc.py)."""
    jax.profiler.start_trace(outdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def stage_cost(fn, *args, **kwargs) -> dict:
    """Per-call XLA cost analysis of a stage function: flops, bytes
    accessed, and arithmetic intensity (flops/byte).

    Complements ``device_trace`` (SURVEY.md §5 tracing row): compilation
    metadata travels with the executable, so this works wherever jit
    does — even headless, with no profiler plugin on the host.  Use it
    to attribute HBM-bandwidth vs compute-bound behavior per stage."""
    compiled = jax.jit(fn).lower(*args, **kwargs).compile()
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    flops = float(ca.get("flops", 0.0))
    bytes_acc = float(ca.get("bytes accessed", 0.0))
    return {
        "flops": flops,
        "bytes_accessed": bytes_acc,
        "arithmetic_intensity": flops / bytes_acc if bytes_acc else 0.0,
    }
