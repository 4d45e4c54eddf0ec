"""Thermal (talus-angle) erosion — 4-phase checkerboard slope limiter.

Reference: ``ThermalErosionFilter``
(/root/reference/Filter/Kernel/Blur/ThermalErosionFilter.cs:21-146).

The reference runs, per iteration, four parallel passes; each pass anchors
2x2 blocks at a distinct (x, z) parity so no two concurrent blocks overlap,
then *sequentially* rectifies all 6 pairs within the block (order xy, xz,
xw, yz, yw, zw — ThermalErosionFilter.cs:70-77).  Phase decode
(ThermalErosionFilter.cs:97-116):

    flip 0: x ∈ {1,3,...}, z ∈ {2,4,...,res-2}
    flip 1: x ∈ {2,4,...}, z ∈ {2,4,...,res-2}
    flip 2: x ∈ {1,3,...}, z ∈ {1,3,...,res-3}
    flip 3: x ∈ {2,4,...}, z ∈ {1,3,...,res-3}

(x always < res-1; row z=0 and column x=0 are never anchored — quirk
preserved.)  maxDiff = tan((talus/90)·π/2)·heightRatio / res
(ThermalErosionFilter.cs:135-136).

Design: each phase is a strided gather of the four block corners, a
vectorized 6-step rectify chain, and a strided scatter — all phases of all
iterations inside one jit/`lax.fori_loop`, no per-row jobs.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from .flow import shift_clamped

_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))  # a,b,c,d indices


def _rectify_pair(v1, v2, max_diff, increment):
    """rectify (ThermalErosionFilter.cs:80-94): move increment·excess from
    the higher cell to the lower when |v1-v2| exceeds max_diff."""
    diff = jnp.abs(v1 - v2)
    excess = jnp.maximum(diff - max_diff, 0.0) * increment
    delta = jnp.where(v1 > v2, -excess, excess)
    return v1 + delta, v2 - delta


def _phase(data, x0, z0, max_diff, increment):
    res = data.shape[0]
    nx = len(range(x0, res - 1, 2))
    nz = len(range(z0, res - 1, 2))  # z anchors satisfy z+1 <= res-1
    if nx == 0 or nz == 0:
        return data
    zs = slice(z0, z0 + 2 * nz, 2)
    xs = slice(x0, x0 + 2 * nx, 2)
    zs1 = slice(z0 + 1, z0 + 1 + 2 * nz, 2)
    xs1 = slice(x0 + 1, x0 + 1 + 2 * nx, 2)
    v = [
        data[zs, xs],    # (x, z)       — "x" in the reference's float4
        data[zs, xs1],   # (x+1, z)     — "y"
        data[zs1, xs],   # (x, z+1)     — "z"
        data[zs1, xs1],  # (x+1, z+1)   — "w"
    ]
    for i, j in _PAIRS:
        v[i], v[j] = _rectify_pair(v[i], v[j], max_diff, increment)
    data = data.at[zs, xs].set(v[0])
    data = data.at[zs, xs1].set(v[1])
    data = data.at[zs1, xs].set(v[2])
    data = data.at[zs1, xs1].set(v[3])
    return data


# phase → (x0, z0), from the Execute() decode (ThermalErosionFilter.cs:97-109)
_PHASE_OFFSETS = ((1, 2), (2, 2), (1, 1), (2, 1))


# Edge-clamped shift: out[z, x] = a[z+dz, x+dx] (values outside the array
# never survive the valid-block mask, clamping just keeps shapes).
_shift = shift_clamped


def thermal_phase_masked(d, x0: int, z0: int, origin_row, origin_col,
                         res_global: int, max_diff, increment):
    """Mask/role formulation of one checkerboard phase.

    Equivalent to ``_phase`` but expressed per cell instead of per strided
    slice: each covered cell determines its corner role within its 2x2
    block from *global* parity, reconstructs the block's four original
    values via shifts, applies the sequential rectify chain, and keeps its
    own corner's result.  Because a cell's new value depends only on its
    block's four inputs, this works on halo-extended shards — the basis of
    ``parallel.sharded_ops.sharded_thermal_erosion``.

    ``origin_row``/``origin_col``: global coordinates of d[0, 0] (may be
    traced, e.g. derived from a mesh axis index).
    """
    h, w = d.shape
    gz = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) + origin_row
    gx = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) + origin_col
    rx = (gx - x0) % 2
    rz = (gz - z0) % 2
    ax = gx - rx  # block anchor, global coords
    az = gz - rz
    # reference coverage: anchors x in [x0, res-2], z in [z0, zmax]
    zmax = res_global - 2 if z0 == 2 else res_global - 3
    valid = (ax >= x0) & (ax < res_global - 1) & (az >= z0) & (az <= zmax)

    shifted = {
        (dz, dx): _shift(d, dz, dx)
        for dz in (-1, 0, 1) for dx in (-1, 0, 1)
    }

    # corner (cx, cz) value seen from a cell with role (rx, rz):
    #   d[z + cz - rz, x + cx - rx].  The role is a pure parity, so the
    #   9-way per-combination select collapses to ONE nested 4-way select
    #   per corner over the two parity masks (the old formulation paid
    #   9 × (2 compares + and + where) per corner — ~12× the ops of this
    #   form for bitwise-identical results; it dominated the fused
    #   kernel's time at 8192²).
    rx0 = rx == 0
    rz0 = rz == 0

    def corner(cx, cz):
        return jnp.where(
            rz0,
            jnp.where(rx0, shifted[(cz, cx)], shifted[(cz, cx - 1)]),
            jnp.where(rx0, shifted[(cz - 1, cx)],
                      shifted[(cz - 1, cx - 1)]),
        )

    # float4 order: x=(0,0), y=(1,0), z=(0,1), w=(1,1); pairs as in _PAIRS
    order = [(0, 0), (1, 0), (0, 1), (1, 1)]
    vals = [corner(cx, cz) for cx, cz in order]
    for i, j in _PAIRS:
        vals[i], vals[j] = _rectify_pair(vals[i], vals[j], max_diff, increment)

    # own corner result by role: same nested parity select
    own = jnp.where(
        rz0,
        jnp.where(rx0, vals[0], vals[1]),
        jnp.where(rx0, vals[2], vals[3]),
    )
    return jnp.where(valid, own, d)


@partial(jax.jit, static_argnames=("iterations",))
def thermal_erosion(
    data,
    talus,
    increment_ratio,
    height_width_ratio,
    iterations: int = 1,
):
    """ThermalErosionFilter.Schedule parity (ThermalErosionFilter.cs:118-146).

    ``talus`` in degrees; ``increment_ratio`` = THERMAL_STEP;
    ``height_width_ratio`` = TILE_SIZE / HEIGHT (LiveErosion.cs:385).

    Uses the mask/role phase formulation: every phase is one elementwise
    pass over the grid instead of stride-2 gathers and scatters.
    """
    res = data.shape[0]
    talus_rad = (talus / 90.0) * 3.14159 / 2.0
    max_diff = (jnp.tan(talus_rad) * height_width_ratio) / res
    increment = increment_ratio

    def one_iter(_, d):
        for (x0, z0) in _PHASE_OFFSETS:
            d = thermal_phase_masked(d, x0, z0, 0, 0, res, max_diff, increment)
        return d

    if iterations == 1:
        return one_iter(0, data)
    return jax.lax.fori_loop(0, iterations, one_iter, data)
