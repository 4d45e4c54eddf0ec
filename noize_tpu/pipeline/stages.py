"""Concrete pipeline stages — one per reference stage class, same
parameter names and ranges.

Reference stage classes (SURVEY.md §2): NoiseStage, KernelFilterStage,
StageGaussianBlur, StageSmoothBlur, StageThermalErosion, FlowMapStage,
ReduceStage, ConstantStage, CurveStage, CropStage, Read/Write
GeneratorContextStage, MeshTileStage, MeshTileReferenceDataStage,
MeshBakeStage.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional, Tuple

import jax.numpy as jnp

from ..core.stageio import (
    DownsampleData,
    GeneratorData,
    MeshStageData,
    ReduceData,
    StageIO,
)
from ..ops import blur as _blur
from ..ops import filters as _filters
from ..ops import flow as _flow
from ..ops import fractal as _fractal
from ..ops import kernels as _kernels
from ..ops import mesh as _mesh
from ..ops import thermal as _thermal
from .stage import PipelineWorkItem, Stage


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NoiseStage(Stage):
    """Noise/NoiseStage.cs:13-61 — params & ranges preserved."""

    noiseType: str = "Perlin"          # FractalNoise enum member name
    hurst: float = 0.0                 # [0, 2]
    startingAmplitude: float = 1.0     # [.01, 5]
    octaves: int = 1                   # [1, 24]
    stepdown: float = 2.0              # [1.8, 2.2]
    detuneRate: float = 0.0            # [-.05, .05]
    noiseSize: int = 1000              # [5, 32000]

    def __post_init__(self):
        # fail at construction like the reference's enum-typed inspector
        # field (FractalNoise, NoiseStage.cs:38), not at first run
        if self.noiseType not in _fractal.NOISE_TYPES:
            raise ValueError(
                f"unknown noiseType {self.noiseType!r}; expected one of "
                f"{_fractal.NOISE_TYPES}")

    def array_fn(self, data, io: GeneratorData):
        return _fractal.fractal(
            io.resolution,
            io.xpos,
            io.zpos,
            noise_type=self.noiseType,
            hurst=self.hurst,
            octaves=self.octaves,
            stepdown=self.stepdown,
            detune_rate=self.detuneRate,
            noise_size=float(self.noiseSize),
            starting_amplitude=self.startingAmplitude,
        )

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        d = work.data
        work.data = d.with_(data=self.array_fn(d.data, d))
        return work


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelFilterStage(Stage):
    """Filter/KernelFilterStage.cs:13-51."""

    filter: str = "Smooth3"            # KernelFilterType member
    iterations: int = 1                # [1, 32]

    def array_fn(self, data, io=None):
        return _kernels.kernel_filter(data, self.filter, self.iterations)

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        work.data = work.data.with_(data=self.array_fn(work.data.data))
        return work


@dataclass(frozen=True)
class StageGaussianBlur(Stage):
    """Filter/Kernel/Blur/StageGaussianBlur.cs:13-55."""

    sigma: str = "s1d00"               # GaussSigma member
    width: int = 3                     # [3, 25]
    iterations: int = 1                # [1, 32]

    def array_fn(self, data, io=None):
        for _ in range(self.iterations):
            data = _blur.gauss_blur(data, self.width, self.sigma)
        return data

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        work.data = work.data.with_(data=self.array_fn(work.data.data))
        return work


@dataclass(frozen=True)
class StageSmoothBlur(Stage):
    """Filter/Kernel/Blur/StageSmoothBlur.cs:13-55."""

    width: int = 3
    iterations: int = 1

    def array_fn(self, data, io=None):
        for _ in range(self.iterations):
            data = _blur.smooth_blur(data, self.width)
        return data

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        work.data = work.data.with_(data=self.array_fn(work.data.data))
        return work


@dataclass(frozen=True)
class StageThermalErosion(Stage):
    """Filter/Kernel/Blur/StageThermalErosion.cs:13-36."""

    iterations: int = 1                  # [1, 32]
    talus: int = 45                      # [1, 90] degrees
    increment: float = 0.5
    meshHeightWidthRatio: float = 0.75

    def array_fn(self, data, io=None):
        return _thermal.thermal_erosion(
            data, float(self.talus), self.increment,
            self.meshHeightWidthRatio, iterations=self.iterations,
        )

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        work.data = work.data.with_(data=self.array_fn(work.data.data))
        return work


@dataclass(frozen=True)
class ConstantStage(Stage):
    """Filter/ConstantStage.cs:13-57."""

    operation: str = "MULTIPLY"        # MULTIPLY | BINARIZE
    value: float = 0.5                 # [0, 1]

    def array_fn(self, data, io=None):
        return _filters.CONSTANT_OPS[self.operation](data, self.value)

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        work.data = work.data.with_(data=self.array_fn(work.data.data))
        return work


@dataclass(frozen=True)
class CurveStage(Stage):
    """Filter/Curve/CurveStage.cs:13-71 — ``curve`` is the discretized LUT
    (the AnimationCurve sampled at ``samples`` points)."""

    curve: Tuple[float, ...] = ()
    samples: int = 256

    @classmethod
    def from_function(cls, fn, samples: int = 256):
        return cls(
            curve=tuple(float(fn(i / samples)) for i in range(samples)),
            samples=samples,
        )

    @classmethod
    def from_keyframes(cls, keys, samples: int = 256):
        """Discretize real Unity AnimationCurve keyframes with the exact
        Hermite/Bezier evaluator (CurveStage.cs ExtractCurve parity)."""
        from ..utils.anim_curve import sample_lut

        return cls(curve=sample_lut(keys, samples), samples=samples)

    def array_fn(self, data, io=None):
        return _filters.curve_apply(data, jnp.asarray(self.curve, jnp.float32))

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        work.data = work.data.with_(data=self.array_fn(work.data.data))
        return work


@dataclass(frozen=True)
class ReduceStage(Stage):
    """Filter/Reduce/ReduceStage.cs:21-70 — consumes ReduceData, emits
    GeneratorData (TransformData parity)."""

    operation: str = "SUBTRACT"

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, ReduceData)
        d = work.data
        out = _filters.REDUCTION_OPS[self.operation](d.data, d.right_data)
        work.data = GeneratorData(
            uuid=d.uuid, resolution=d.resolution, data=out,
            xpos=d.xpos, zpos=d.zpos,
        )
        return work


@dataclass(frozen=True)
class CropStage(Stage):
    """Filter/Sample/CropStage.cs:12-19 — consumes DownsampleData, crops
    inputData to resolution² (reference offset quirk: starts at (0,0))."""

    offset: int = 0

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, DownsampleData)
        d = work.data
        out = _filters.crop(d.inputData, d.resolution, self.offset)
        work.data = d.with_(data=out)
        return work


@dataclass(frozen=True)
class FlowMapStage(Stage):
    """Geologic/Stage/FlowMapStage.cs:16-220 — output overwrites the height
    slice with the statically-normalized velocity map."""

    iterations: int = 5                # [1, 128]
    normMin: float = -0.1
    normMax: float = 0.1

    def array_fn(self, data, io=None):
        return _flow.flow_map(
            data, iterations=self.iterations,
            norm_min=self.normMin, norm_max=self.normMax,
        )

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        work.data = work.data.with_(data=self.array_fn(work.data.data))
        return work


# ---------------------------------------------------------------------------
# context (state-store) stages
# ---------------------------------------------------------------------------

def _context_buffer_name(d: GeneratorData, alias: str) -> str:
    """'{xpos}_{zpos}__{res}__{alias}' (ReadGeneratorContextStage.cs:18-20)."""
    return f"{d.xpos}_{d.zpos}__{d.resolution}__{alias}"


@dataclass(frozen=True)
class WriteGeneratorContextStage(Stage):
    """PipelineState/Stage/WriteGeneratorContextStage.cs — copies the
    payload into the named context buffer and locks it until committed."""

    contextAlias: str = ""

    def is_schedulable(self, work: PipelineWorkItem) -> bool:
        if work.state_manager is None:
            return False
        name = _context_buffer_name(work.data, self.contextAlias)
        return not work.state_manager.is_locked(name)

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        sm = work.state_manager
        name = _context_buffer_name(work.data, self.contextAlias)
        token = object()
        sm.try_set_lock(name, token)
        sm.set_buffer(name, work.data.data)
        sm.unlock(name, token)
        return work


@dataclass(frozen=True)
class ReadGeneratorContextStage(Stage):
    """PipelineState/Stage/ReadGeneratorContextStage.cs — replaces the
    payload data with the named context buffer; gated on existence+unlock."""

    contextAlias: str = ""

    def is_schedulable(self, work: PipelineWorkItem) -> bool:
        if work.state_manager is None:
            return False
        name = _context_buffer_name(work.data, self.contextAlias)
        if not work.state_manager.buffer_exists(name):
            return False
        return not work.state_manager.is_locked(name)

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, GeneratorData)
        name = _context_buffer_name(work.data, self.contextAlias)
        buf = work.state_manager.get_buffer(name)
        work.data = work.data.with_(data=buf)
        return work


# ---------------------------------------------------------------------------
# mesh stages
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshTileStage(Stage):
    """Mesh/Stage/MeshTileStage.cs:28-64 — heightmap payload → MeshArrays."""

    overshoot: bool = False

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, MeshStageData)
        d = work.data
        fn = (
            _mesh.heightmap_mesh_overshoot if self.overshoot else _mesh.heightmap_mesh
        )
        mesh = fn(
            d.data, d.resolution, d.inputResolution,
            float(d.tileHeight), float(d.tileSize),
        )
        work.data = d.with_(mesh=mesh)
        return work


@dataclass(frozen=True)
class MeshTileReferenceDataStage(Stage):
    """Mesh/Stage/MeshTileReferenceDataStage.cs:23-80 — meshes from a named
    context buffer instead of the payload, gated on its lock."""

    contextAlias: str = "TERRAIN_HEIGHT"
    overshoot: bool = True

    def _name(self, d: MeshStageData) -> str:
        return f"{d.xpos}_{d.zpos}__{d.inputResolution}__{self.contextAlias}"

    def is_schedulable(self, work: PipelineWorkItem) -> bool:
        sm = work.state_manager
        if sm is None:
            return False
        name = self._name(work.data)
        return sm.buffer_exists(name) and not sm.is_locked(name)

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, MeshStageData)
        d = work.data
        heights = work.state_manager.get_buffer(self._name(d))
        fn = (
            _mesh.heightmap_mesh_overshoot if self.overshoot else _mesh.heightmap_mesh
        )
        mesh = fn(
            heights, d.resolution, d.inputResolution,
            float(d.tileHeight), float(d.tileSize),
        )
        work.data = d.with_(mesh=mesh)
        return work


@dataclass(frozen=True)
class MeshBakeStage(Stage):
    """Mesh/Stage/MeshBakeStage.cs:12-25 — physics-collider bake is a Unity
    concept; here it materializes the mesh on host (blocks until device
    arrays are ready), the closest meaningful analog."""

    def apply(self, work: PipelineWorkItem) -> PipelineWorkItem:
        self.check_requirements(work, MeshStageData)
        if work.data.mesh is not None:
            import jax

            jax.block_until_ready(work.data.mesh)
        return work
