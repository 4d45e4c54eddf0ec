"""noize_tpu — procedural terrain framework on JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
xshazwar/noize-job (Unity Burst/Jobs).  See SURVEY.md for the layer map of
the reference, PARITY.md for the component mapping, README.md for usage.

Subpackages: core (tiles, store, serde), ops (compute kernels),
erosion (live particle sim), pipeline (stages + executor), parallel
(meshes, halo exchange, tile batching), app (orchestration, viz, CLI),
native (C++ IO runtime), utils.
"""

__version__ = "0.1.0"

__all__ = [
    "core", "ops", "erosion", "pipeline", "parallel", "app", "utils",
]
