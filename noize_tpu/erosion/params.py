"""Erosion tuning surface — ErosionParameters / ErosionSettings parity.

Reference: ``ErosionParameters`` (/root/reference/Geologic/ParticleErosion/
LiveErosionDataTypes.cs:76-128) and the inspector asset ``ErosionSettings``
(ScriptableObject/ErosionSettings.cs:5-125) including its behavior-mode
gating in ``AsParameters()`` (ErosionSettings.cs:95-122).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from enum import Enum


class ErosionMode(Enum):
    """LiveErosionDataTypes.cs:28-33."""

    ALL_EROSION = 0
    ONLY_THERMAL_EROSION = 1
    THERMAL_FLOW_WATER = 2
    ONLY_FLOW_WATER = 3


# ErosionParameters fields that are pure arithmetic inputs to the cycle —
# safe to pass as traced scalars, so the inspector-slider workflow
# (LiveErosion tweaks ErosionSettings between triggers) never recompiles.
# Structural fields stay trace-time static: loop bounds and kernel widths
# (MAXAGE, PILING_RADIUS), Python-level mode gates (EXACT_PILES,
# VEGETATION_FRICTION), and the pile-shape values the serial exact-pile
# transcription consumes (MIN_PILE_INCREMENT, PILE_THRESHOLD).
TUNABLE_FIELDS = (
    "INERTIA", "GRAVITY", "DRAG", "FRICTION", "EVAP", "EROSION",
    "DEPOSITION", "FLOW_HEIGHT_CONTRIBUTION", "SLOW_CULL_ANGLE",
    "SLOW_CULL_SPEED", "CAPACITY", "TERMINAL_VELOCITY",
    "SURFACE_EVAPORATION_RATE", "POOL_PLACEMENT_MULTIPLIER",
    "TRACK_PLACEMENT_MULTIPLIER", "FLOW_LOSS_RATE",
)

# the ErosionSettings source fields behind TUNABLE_FIELDS (DRAG also feeds
# the derived TERMINAL_VELOCITY; CAPACITY/POOL_PLACEMENT_MULTIPLIER are
# mode-gated in as_parameters, host-side, before tracing)
_SETTINGS_TUNABLE_FIELDS = (
    "INERTIA", "GRAVITY", "DRAG", "FRICTION", "EVAP", "EROSION",
    "DEPOSITION", "FLOW_HEIGHT_CONTRIBUTION", "SLOW_CULL_ANGLE",
    "SLOW_CULL_SPEED", "CAPACITY", "SURFACE_EVAPORATION_RATE",
    "POOL_PLACEMENT_MULTIPLIER", "TRACK_PLACEMENT_MULTIPLIER",
    "FLOW_LOSS_RATE",
)


@dataclass(frozen=True)
class ErosionParameters:
    """Particle-sim parameters (trace-time constants by default; the
    TUNABLE_FIELDS subset may be overridden with traced scalars — see
    sim.erosion_cycle's ``tuned`` argument).

    Defaults follow ErosionParameters.Default()
    (LiveErosionDataTypes.cs:101-127).
    """

    INERTIA: float = 0.7
    GRAVITY: float = 1.0
    DRAG: float = 0.001
    FRICTION: float = 0.001
    EVAP: float = 0.001
    EROSION: float = 0.2
    DEPOSITION: float = 0.05
    FLOW_HEIGHT_CONTRIBUTION: float = 25.0

    SLOW_CULL_ANGLE: float = 3.0
    SLOW_CULL_SPEED: float = 0.1
    CAPACITY: float = 3.0
    MAXAGE: int = 64
    TERMINAL_VELOCITY: float = 1.0 / 0.001

    SURFACE_EVAPORATION_RATE: float = 0.1
    POOL_PLACEMENT_MULTIPLIER: float = 0.5
    TRACK_PLACEMENT_MULTIPLIER: float = 80.0
    FLOW_LOSS_RATE: float = 0.05

    PILING_RADIUS: int = 15
    MIN_PILE_INCREMENT: float = 1.0
    PILE_THRESHOLD: float = 2.0
    # opt-in serial-faithful Manhattan-ring pile solver (PARITY.md D3);
    # default is the fast separable tent profile
    EXACT_PILES: bool = False
    # beyond-parity extension: plant density scales particle friction
    # (0 = off = reference behavior; Vegetation.cs leaves growth a stub)
    VEGETATION_FRICTION: float = 0.0


@dataclass(frozen=True)
class ErosionSettings:
    """Inspector mirror with cycle control — defaults from
    ErosionSettings.Reset() (ErosionSettings.cs:59-93)."""

    CYCLES: int = 3
    PARTICLES_PER_CYCLE: int = 1000
    BEHAVIOR: ErosionMode = ErosionMode.ALL_EROSION

    INERTIA: float = 0.5
    GRAVITY: float = 1.0
    DRAG: float = 0.001
    FRICTION: float = 0.01
    EVAP: float = 0.01
    EROSION: float = 1.0
    DEPOSITION: float = 0.1
    FLOW_HEIGHT_CONTRIBUTION: float = 25.0

    SLOW_CULL_ANGLE: float = 3.0
    SLOW_CULL_SPEED: float = 0.11
    CAPACITY: float = 3.0
    MAXAGE: int = 100

    WATER_STEPS: int = 10
    SURFACE_EVAPORATION_RATE: float = 0.1
    POOL_PLACEMENT_MULTIPLIER: float = 0.5
    TRACK_PLACEMENT_MULTIPLIER: float = 80.0
    FLOW_LOSS_RATE: float = 0.05

    PILING_RADIUS: int = 15
    MIN_PILE_INCREMENT: float = 1.0
    PILE_THRESHOLD: float = 2.0  # meters
    EXACT_PILES: bool = False
    VEGETATION_FRICTION: float = 0.0

    ENABLE_THERMAL: bool = True
    TALUS: float = 55.0
    THERMAL_STEP: float = 0.6
    THERMAL_CYCLES: int = 1

    def as_parameters(self) -> ErosionParameters:
        """AsParameters() gating parity (ErosionSettings.cs:95-122)."""
        return ErosionParameters(
            INERTIA=self.INERTIA,
            GRAVITY=self.GRAVITY,
            FRICTION=self.FRICTION,
            DRAG=self.DRAG,
            EVAP=self.EVAP,
            EROSION=self.EROSION,
            DEPOSITION=self.DEPOSITION,
            FLOW_HEIGHT_CONTRIBUTION=self.FLOW_HEIGHT_CONTRIBUTION,
            SLOW_CULL_ANGLE=self.SLOW_CULL_ANGLE,
            SLOW_CULL_SPEED=self.SLOW_CULL_SPEED,
            CAPACITY=(
                self.CAPACITY if self.BEHAVIOR == ErosionMode.ALL_EROSION else 0.0
            ),
            MAXAGE=self.MAXAGE,
            TERMINAL_VELOCITY=1.0 / self.DRAG,
            SURFACE_EVAPORATION_RATE=self.SURFACE_EVAPORATION_RATE,
            POOL_PLACEMENT_MULTIPLIER=(
                0.0
                if self.BEHAVIOR == ErosionMode.ONLY_THERMAL_EROSION
                else self.POOL_PLACEMENT_MULTIPLIER
            ),
            TRACK_PLACEMENT_MULTIPLIER=self.TRACK_PLACEMENT_MULTIPLIER,
            FLOW_LOSS_RATE=self.FLOW_LOSS_RATE,
            PILING_RADIUS=self.PILING_RADIUS,
            MIN_PILE_INCREMENT=self.MIN_PILE_INCREMENT,
            PILE_THRESHOLD=self.PILE_THRESHOLD,
            EXACT_PILES=self.EXACT_PILES,
            VEGETATION_FRICTION=self.VEGETATION_FRICTION,
        )

    def tunable_values(self) -> dict:
        """The mode-gated tunable floats as a plain dict — the traced side
        of the static/traced split (pass as ``erosion_cycle(..., tuned=)``)."""
        p = self.as_parameters()
        return {k: float(getattr(p, k)) for k in TUNABLE_FIELDS}

    def canonical(self) -> "ErosionSettings":
        """This settings object with every tunable float reset to its class
        default — the trace key.  Two settings differing only in tunables
        canonicalize equal, so live slider tweaks reuse the compiled cycle
        instead of recompiling."""
        return replace(self, **{
            f: getattr(type(self), f) for f in _SETTINGS_TUNABLE_FIELDS
        })
