"""Pipeline runtime — the work-queue executor (reference L4).

Reference: ``BasePipeline`` (/root/reference/Pipeline/Executable/
Pipeline.cs:19-287): Enqueue → queue → per-frame ServiceQueue →
WorkIsSchedulable gate → eager stage cascade → LateUpdate completion poll →
callbacks; unschedulable work parks in ``dependencyHell``
(Pipeline.cs:183-214).

Device mapping: JAX dispatch is already asynchronous — "scheduling" a stage
cascade enqueues device work and returns immediately with futures
(jax.Array).  The executor thread plays the role of the frame loop: it
services the queue, applies the schedulability gates (context buffers
present & unlocked), runs the cascade, then waits for device completion
before firing ``on_complete`` — the ``pipelineHandle.IsCompleted`` poll
becomes ``block_until_ready``.  Timing logs keep the reference's
"fully scheduled … / completed → uuid: N ms" shape (Pipeline.cs:126,171).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import jax

from ..core.stageio import StageIO
from .stage import PipelineWorkItem, Stage

log = logging.getLogger("noize_tpu.pipeline")


class Pipeline:
    """BasePipeline equivalent.

    Synchronous use: ``run(payload)``.
    Async use: ``start()`` + ``enqueue(payload, on_complete=...)`` — the
    executor thread services the queue exactly once per loop tick, retrying
    dependency-hell items first (Pipeline.cs:183-200).
    """

    def __init__(self, stages: Sequence[Stage], state_manager=None, name: str = ""):
        self.stages: List[Stage] = list(stages)
        self.state_manager = state_manager
        self.name = name or type(self).__name__
        self.queue: "queue.Queue[PipelineWorkItem]" = queue.Queue()
        self.dependency_hell: List[PipelineWorkItem] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.pipeline_ready = True

    # --- IPipeline surface (Pipeline/Interface.cs:22-36) --------------------

    def enqueue(
        self,
        payload: StageIO,
        on_scheduled: Optional[Callable] = None,
        on_complete: Optional[Callable] = None,
    ):
        self.queue.put(
            PipelineWorkItem(
                data=payload,
                state_manager=self.state_manager,
                on_scheduled=on_scheduled,
                on_complete=on_complete,
            )
        )

    def run(self, payload: StageIO) -> StageIO:
        """Synchronous end-to-end run (schedule + wait)."""
        work = PipelineWorkItem(data=payload, state_manager=self.state_manager)
        work = self._schedule(work)
        jax.block_until_ready(getattr(work.data, "data", None))
        return work.data

    # --- scheduling ---------------------------------------------------------

    def work_is_schedulable(self, work: PipelineWorkItem) -> bool:
        """Every stage must pass its gate (Pipeline.cs:256-265)."""
        return all(s.is_schedulable(work) for s in self.stages)

    def _schedule(self, work: PipelineWorkItem) -> PipelineWorkItem:
        t0 = time.perf_counter()
        for s in self.stages:
            work = s.apply(work)
        t1 = time.perf_counter()
        log.debug(
            "%s fully scheduled %s in (%.1fms)",
            self.name, work.data.uuid, (t1 - t0) * 1e3,
        )
        if work.on_scheduled is not None:
            work.on_scheduled(work.data)
        return work

    def _complete(self, work: PipelineWorkItem, t_sched: float):
        jax.block_until_ready(getattr(work.data, "data", None))
        for s in self.stages:
            s.on_complete(work)
        log.debug(
            "%s completed -> %s: %.1fms",
            self.name, work.data.uuid, (time.perf_counter() - t_sched) * 1e3,
        )
        if work.on_complete is not None:
            work.on_complete(work.data)

    def _get_next_job(self) -> Optional[PipelineWorkItem]:
        """dependencyHell retry first, then fresh queue items
        (Pipeline.cs:183-200)."""
        for i, work in enumerate(self.dependency_hell):
            if self.work_is_schedulable(work):
                return self.dependency_hell.pop(i)
        try:
            work = self.queue.get_nowait()
        except queue.Empty:
            return None
        if not self.work_is_schedulable(work):
            self.dependency_hell.append(work)
            log.debug("%s: work -> dependency hell (%d parked)",
                      self.name, len(self.dependency_hell))
            return None
        return work

    # --- executor loop (the frame loop analog) ------------------------------

    def _loop(self):
        while not self._stop.is_set():
            work = self._get_next_job()
            if work is None:
                time.sleep(0.001)
                continue
            t0 = time.perf_counter()
            try:
                work = self._schedule(work)
                self._complete(work, t0)
            except Exception:  # pragma: no cover - surfaced via log
                log.exception("%s: stage cascade failed for %s",
                              self.name, work.data.uuid)

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def drain(self, timeout: float = 60.0):
        """Wait until the queue and dependency hell are empty."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.queue.empty() and not self.dependency_hell:
                return True
            time.sleep(0.005)
        return False


class GeneratorPipeline(Pipeline):
    """Scripts/GeneratorPipeline.cs:11-13 — trivial concrete pipeline."""
