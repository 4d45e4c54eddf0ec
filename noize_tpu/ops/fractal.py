"""Fractal (fBm) heightmap generation — the NoiseStage compute path.

Reference: ``FractalJob``/``FractalGenerator`` and the eight noise getters,
``/root/reference/Noise/Fractal/Fractal.cs:19-278``, configured by
``NoiseStage`` (``Noise/NoiseStage.cs:13-61``).

Design: the reference dispatches one Burst job per tile row; here the
whole ``(res, res)`` tile is one fused XLA computation.  The octave loop
is unrolled at trace time (octave count is static config, range [1, 24]),
letting XLA fuse every octave's hash + gradient math into a single
elementwise kernel with no intermediate device-memory traffic.

Formulas (Fractal.cs:109-138):
  * world coords:  xi = (x + xpos) / noiseSize, zi = (z + zpos) / noiseSize
  * per octave i:  t += a * noise(f * xi, f * zi)
                   detune += detuneRate;  f *= (stepdown - detune);  a *= G
    with gain G = exp2(-hurst)
  * normalization: t / sum_{i<octaves} G^i   (CalcFractalNormValue,
    Fractal.cs:31-40 — note it ignores startingAmplitude: the loop there
    starts at amplitude 1 regardless)
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from . import noise as _n

_F32 = jnp.float32

#: Order matches the reference's ``FractalNoise`` enum (NoiseStage.cs:15-24).
NOISE_TYPES = (
    "Sin",
    "Perlin",
    "PeriodicPerlin",
    "Simplex",
    "RotatedSimplex",
    "Cellular",
    "DomainRotatedPerlin",
    "DomainRotatedSimplex",
)

# Domain rotation constants (Fractal.cs:160-166): skew 2D -> 3D so the
# "grain" of the 3D lattice does not align with the 2D plane.
_ROT_S2 = -0.211324865405187
_ROT_Y = -0.577350269189626


def _rectify_half(v):
    """(1 + v) / 2  — maps [-1,1] noise to [0,1] (Fractal.cs:151-153)."""
    return (1.0 + v) * 0.5


def noise_value(kind: str, x, z):
    """Evaluate one rectified noise basis at world coords (x, z).

    Mirrors the ``IMakeNoise`` getter structs (Fractal.cs:141-278); output
    is in [0, 1]-ish for every basis.
    """
    if kind == "Sin":
        vx = 0.5 + 0.5 * jnp.sin(x)
        vz = 0.5 + 0.5 * jnp.sin(z)
        return vx * vz
    if kind == "Perlin":
        return _rectify_half(_n.cnoise2(x, z))
    if kind == "PeriodicPerlin":
        return _rectify_half(_n.psrnoise2(x, z, 1010.0, 102.0, 0.0))
    if kind == "Simplex":
        return _rectify_half(_n.snoise2(x, z))
    if kind == "RotatedSimplex":
        return _rectify_half(_n.psrnoise2(x, z, 1010.0, 102.0, 0.62))
    if kind == "Cellular":
        f1, f2 = _n.cellular2(x, z)
        return _rectify_half(f1) * _rectify_half(f2)
    if kind == "DomainRotatedPerlin":
        xz = x + z
        s2 = xz * _ROT_S2
        return _rectify_half(_n.cnoise3(x + s2, z + s2, xz * _ROT_Y))
    if kind == "DomainRotatedSimplex":
        xz = x + z
        s2 = xz * _ROT_S2
        return _rectify_half(_n.snoise3(x + s2, z + s2, xz * _ROT_Y))
    raise ValueError(f"unknown noise type {kind!r}; expected one of {NOISE_TYPES}")


def fractal_norm_value(hurst: float, octaves: int) -> float:
    """CalcFractalNormValue (Fractal.cs:31-40): sum of G^i, i < octaves."""
    g = 2.0 ** (-hurst)
    t, a = 0.0, 1.0
    for _ in range(octaves):
        t += a
        a *= g
    return t


@partial(
    jax.jit,
    static_argnames=(
        "resolution", "noise_type", "octaves",
    ),
)
def fractal(
    resolution: int,
    xpos,
    zpos,
    *,
    noise_type: str = "Perlin",
    hurst=0.0,
    octaves: int = 1,
    stepdown=2.0,
    detune_rate=0.0,
    noise_size=1000.0,
    starting_amplitude=1.0,
):
    """Generate one fBm heightmap tile of shape ``(resolution, resolution)``.

    Array layout is row-major ``[z, x]`` matching the reference's flat
    ``z * res + x`` tiles (TileData.cs:72-77).  ``xpos``/``zpos`` are the
    tile's offset in the global noise domain (tileRes * tilePos —
    MeshTileGenerator.cs:188-189), so adjacent tiles are seamless.
    """
    xpos = jnp.asarray(xpos, _F32)
    zpos = jnp.asarray(zpos, _F32)
    inv_size = 1.0 / jnp.asarray(noise_size, _F32)
    col = jax.lax.broadcasted_iota(_F32, (resolution, resolution), 1)
    row = jax.lax.broadcasted_iota(_F32, (resolution, resolution), 0)
    xi = (col + xpos) * inv_size
    zi = (row + zpos) * inv_size

    g = jnp.exp2(-jnp.asarray(hurst, _F32))
    stepdown = jnp.asarray(stepdown, _F32)
    detune_rate = jnp.asarray(detune_rate, _F32)

    t = jnp.zeros((resolution, resolution), _F32)
    f = jnp.asarray(1.0, _F32)
    a = jnp.asarray(starting_amplitude, _F32)
    detune = jnp.asarray(0.0, _F32)
    for _ in range(octaves):
        t = t + a * noise_value(noise_type, f * xi, f * zi)
        detune = detune + detune_rate
        f = f * (stepdown - detune)
        a = a * g

    # norm value is computed with the same accumulation (amplitude 1 start)
    norm = jnp.asarray(1.0, _F32)
    acc = jnp.asarray(0.0, _F32)
    gg = jnp.exp2(-jnp.asarray(hurst, _F32))
    for _ in range(octaves):
        acc = acc + norm
        norm = norm * gg
    return t / acc
