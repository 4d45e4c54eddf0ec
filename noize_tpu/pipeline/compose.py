"""Pipeline composition: definitions, masking, fusion, fan-in reduce.

Reference: ``PipelineDefinition``/``MaskedPipeline``/``StageMask``
(/root/reference/Pipeline/Stage/PipelineDefinition.cs:28-115) and
``ReducePipeline``/``PipelineJoint`` (Pipeline/Executable/
ReducePipeline.cs:18-166).

Device mapping (SURVEY.md L4): a pipeline is stage composition.  For chains of
pure array stages, ``fuse`` produces ONE jitted function — the reference's
eagerly-scheduled JobHandle DAG becomes a single XLA program with every
elementwise op fused by the compiler.  Stages that touch the host (context
read/write) split the chain into jitted segments executed in order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, List, Optional, Sequence, Tuple

import jax

from ..core.stageio import GeneratorData, ReduceData, StageIO
from .stage import PipelineWorkItem, Stage


@dataclass(frozen=True)
class StageMask:
    """PipelineDefinition.cs:28-47: disable stages by index per instance."""

    disabled: Tuple[int, ...] = ()

    def enabled_stages(self, stages: Sequence[Stage]) -> List[Stage]:
        return [s for i, s in enumerate(stages) if i not in self.disabled]


@dataclass(frozen=True)
class PipelineDefinition:
    """Declarative ordered stage list (PipelineDefinition.cs:90-115)."""

    name: str
    stages: Tuple[Stage, ...]

    def masked(self, mask: StageMask) -> "PipelineDefinition":
        """MaskedPipeline parity (PipelineDefinition.cs:49-87)."""
        return PipelineDefinition(
            name=self.name, stages=tuple(mask.enabled_stages(self.stages))
        )


def run_stages(stages: Sequence[Stage], work: PipelineWorkItem) -> PipelineWorkItem:
    """Synchronous stage cascade (BasePipeline.Schedule wiring,
    Pipeline.cs:104-151)."""
    for s in stages:
        work = s.apply(work)
        if work.on_scheduled is not None:
            work.on_scheduled(work.data)
    for s in stages:
        s.on_complete(work)
    if work.on_complete is not None:
        work.on_complete(work.data)
    return work


def fuse(stages: Sequence[Stage], resolution: int):
    """Fuse a chain of array stages into one jitted fn(data, xpos, zpos).

    Only valid when every stage exposes ``array_fn`` (pure array ops).  The
    noise stage ignores incoming data and generates from (xpos, zpos).
    """
    not_fusable = [s for s in stages if not s.fusable]
    if not_fusable:
        raise ValueError(f"stages not fusable: {not_fusable}")

    stage_list = tuple(stages)

    @partial(jax.jit, static_argnames=())
    def fn(data, xpos, zpos):
        io = GeneratorData(resolution=resolution, xpos=xpos, zpos=zpos, data=data)
        for s in stage_list:
            try:
                data = s.array_fn(data, io)
            except TypeError:
                data = s.array_fn(data)
            io = io.with_(data=data)
        return data

    return fn


@dataclass
class ReducePipeline:
    """Fan-in combinator (ReducePipeline.cs:18-166): run left/right upstream
    pipelines on the same request, join, then apply a binary reduce chain.

    ``left``/``right``/``post`` are stage sequences; ``reduce_stage`` is a
    ReduceStage (or any Stage consuming ReduceData)."""

    left: Sequence[Stage]
    right: Sequence[Stage]
    reduce_stage: Stage
    post: Sequence[Stage] = field(default_factory=tuple)

    def run(self, work: PipelineWorkItem) -> PipelineWorkItem:
        d = work.data
        lw = run_stages(
            self.left,
            PipelineWorkItem(data=d.with_(), state_manager=work.state_manager),
        )
        rw = run_stages(
            self.right,
            PipelineWorkItem(data=d.with_(), state_manager=work.state_manager),
        )
        rd = ReduceData(
            uuid=d.uuid,
            resolution=d.resolution,
            xpos=getattr(d, "xpos", 0),
            zpos=getattr(d, "zpos", 0),
            data=lw.data.data,
            right_data=rw.data.data,
        )
        joined = PipelineWorkItem(
            data=rd,
            state_manager=work.state_manager,
            on_scheduled=work.on_scheduled,
            on_complete=work.on_complete,
        )
        return run_stages([self.reduce_stage, *self.post], joined)
