"""Heightmap → mesh emission as device arrays.

Reference: ``HeightMapMeshJob``/``MeshJob``
(/root/reference/Mesh/Job/HeightMapMeshJob.cs:9-54, MeshJob.cs:9-55), the
grid generators ``SquareGridHeightMap`` / ``OvershootSquareGridHeightMap`` /
``SharedSquareGridPosition`` (/root/reference/Mesh/Generators/*.cs) and the
interleaved vertex streams (``PositionStream16/32``, ``TriangleUInt16/32`` —
Mesh/Streams/*.cs).

Design: the reference emits one Unity vertex row per job
iteration into interleaved MeshData buffers.  Here the whole vertex grid is
a handful of fused gather + finite-difference array ops returning an SoA
``MeshArrays`` pytree (positions/normals/tangents/uvs + triangle indices).
Index dtype parity: uint16 streams for meshes up to 256² (PositionStream16,
Mesh/README.md:10-12), uint32 above.

All formula quirks are preserved:
  * x = 0 gets position -(0.5·TileSize/Res) while x ≥ 1 gets
    x·TileSize/Res − 0.5 (constant!, SquareGridHeightMap.cs:85,92);
  * SquareGrid's edge extrapolation ``InterpolateEdge(a, b) = a − (b − a)``
    with its exact call asymmetry (SquareGridHeightMap.cs:70-73 — the r
    branch switches at x == Resolution−1, not Resolution);
  * uv denominators differ between the two generators (Res − 0.5 for
    Overshoot, Res + 1 for SquareGrid);
  * NormalStrength = 8 (HeightMapMeshJob.cs:41).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

_F32 = jnp.float32
NORMAL_STRENGTH = 8.0  # HeightMapMeshJob.cs:41


@jax.tree_util.register_pytree_node_class
@dataclass
class MeshArrays:
    """SoA vertex/index streams (the MeshData replacement)."""

    positions: Any  # f32[(R+1)², 3]
    normals: Any    # f32[(R+1)², 3]
    tangents: Any   # f32[(R+1)², 4]
    uvs: Any        # f32[(R+1)², 2]
    indices: Any    # ui16/ui32[6·R²] flat triangle list

    def tree_flatten(self):
        return (
            (self.positions, self.normals, self.tangents, self.uvs, self.indices),
            None,
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def vertex_count(self):
        return self.positions.shape[0]

    @property
    def index_count(self):
        return self.indices.shape[0]


@jax.tree_util.register_pytree_node_class
@dataclass
class MeshPlanes:
    """Component-major vertex streams: one f32[12, H, W] stack of planes
    [px, py, pz, nx, ny, nz, tx, ty, tz, tw, u, v] over the (R+1)² vertex
    grid, plus the flat triangle list.

    The vertex grid occupies the two minor dims, so each component is one
    dense plane instead of a 3/4/2-wide minor axis.  ``to_arrays()`` (or the
    field properties) materialize the interleavable ``MeshArrays`` SoA view
    for host consumers (bakery, export) — same math as the MeshArrays
    builders, agreeing to a few ulp (see ``vertex_plane_list``)."""

    planes: Any    # f32[12, H, W]
    indices: Any   # ui16/ui32[6·R²]

    def tree_flatten(self):
        return ((self.planes, self.indices), None)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def _field(self, lo: int, hi: int):
        n = self.planes.shape[1] * self.planes.shape[2]
        return jnp.moveaxis(self.planes[lo:hi], 0, -1).reshape(n, hi - lo)

    @property
    def positions(self):
        return self._field(0, 3)

    @property
    def normals(self):
        return self._field(3, 6)

    @property
    def tangents(self):
        return self._field(6, 10)

    @property
    def uvs(self):
        return self._field(10, 12)

    @property
    def vertex_count(self):
        return self.planes.shape[1] * self.planes.shape[2]

    @property
    def index_count(self):
        return self.indices.shape[0]

    def to_arrays(self) -> "MeshArrays":
        return MeshArrays(
            self.positions, self.normals, self.tangents, self.uvs,
            self.indices,
        )


def index_dtype(resolution: int):
    """PositionStream16 caveat: 16-bit indices only up to 256² meshes."""
    return jnp.uint16 if (resolution + 1) ** 2 <= 65536 else jnp.uint32


def grid_indices(resolution: int, dtype=None) -> np.ndarray:
    """Triangle index list parity (SquareGridHeightMap.cs:96-103): per cell
    (z≥1, x≥1) two triangles (vi−R−2, vi−1, vi−R−1), (vi−R−1, vi−1, vi)."""
    r = resolution
    if dtype is None:
        dtype = np.uint16 if (r + 1) ** 2 <= 65536 else np.uint32
    z, x = np.meshgrid(np.arange(1, r + 1), np.arange(1, r + 1), indexing="ij")
    vi = (r + 1) * z + x
    t0 = np.stack([vi - r - 2, vi - 1, vi - r - 1], -1)
    t1 = np.stack([vi - r - 1, vi - 1, vi], -1)
    tris = np.stack([t0, t1], -2)  # [r, r, 2, 3] — cell order z-major
    return tris.reshape(-1).astype(dtype)


def vertex_plane_list(t, l, rgt, u, d, vx_f, vz_f, step, height, uv_denom):
    """Per-vertex elementwise math — positions/normals/tangents/uvs from
    the five height taps and f32 vertex coordinates, as TWELVE component
    planes [px, py, pz, nx, ny, nz, tx, ty, tz, tw, u, v] each of the
    vertex-grid shape, stacked on axis 0 by the ``MeshPlanes`` assembly
    (dense planes instead of the (N, 3/4/2)-shaped ``MeshArrays`` streams).
    Same math as ``vertex_fields`` (which keeps its stacked form for the
    shard_map bit-exactness guarantee — see its docstring); values agree
    to a few ulp (normals carry the sqrt/divide chain XLA fuses per-program).

    Quirks preserved: vertex x == 0 gets position −(0.5·step) while x ≥ 1
    gets x·step − 0.5 (SquareGridHeightMap.cs:85,92 — z has NO such
    special case); tangent.xyz = cross(t2, t1) with t1 = (4, (r−l)/2, 0),
    t2 = (0, (u−d)/2, 4) → (−4·dx, 16, −4·dz), w stays 0 (never set in
    the reference's Vertex); NormalStrength = 8 (HeightMapMeshJob.cs:41)."""
    px = jnp.where(vx_f == 0.0, -(0.5 * step), vx_f * step - 0.5)
    py = t * height
    pz = vz_f * step - 0.5
    dx = (rgt - l) * 0.5
    dz = (u - d) * 0.5
    nx = (l - rgt) * 0.5 * NORMAL_STRENGTH
    ny = jnp.full_like(dx, 2.0 / height)
    nz = dz * NORMAL_STRENGTH
    # left-assoc square sum + TRUE division (not reciprocal-multiply or
    # rsqrt): XLA strength-reduces 1/sqrt to rsqrt in some programs but
    # not others, and the shard_map path must stay bit-identical to the
    # single-device path (tests/test_parallel.py::TestShardedMesh).  The
    # planes-vs-arrays layouts may still diverge by a few ulp here — separate
    # programs fuse the chain differently.
    norm = jnp.sqrt((nx * nx + ny * ny) + nz * nz)
    # explicit f32 reciprocal multiply: XLA strength-reduces division by a
    # constant to this form anyway (under allow_excess_precision), but the
    # shard_map constant folder performs TRUE division — writing the mul
    # form keeps single-device and sharded emission bit-identical
    recip = np.float32(1.0) / np.float32(uv_denom)
    return [
        px, py, pz,
        nx / norm, ny / norm, nz / norm,
        -4.0 * dx, 16.0 * jnp.ones_like(dx), -4.0 * dz, jnp.zeros_like(dx),
        vx_f * recip, vz_f * recip,
    ]


def vertex_fields(t, l, rgt, u, d, vx_f, vz_f, step, height, uv_denom):
    """Trailing-axis layout of the vertex math: returns (pos[..,3],
    n[..,3], tan[..,4], uv[..,2]) stacked on a new last axis.  Shared
    verbatim by the single-device grid assembly below and
    ``parallel.sharded_mesh.sharded_heightmap_mesh`` (same op order ⇒ the
    sharded emission is bit-exact with this path).

    NOT expressed via ``vertex_plane_list`` although the math is the same:
    normalizing the STACKED normal keeps plain-jit and shard_map programs
    lowering identically (the per-plane division form strength-reduces to
    rsqrt in one but not the other, breaking the sharded bit-exactness by
    1-2 ulp).  Keep the two in sync when touching either."""
    pos = jnp.stack(
        [
            jnp.where(vx_f == 0.0, -(0.5 * step), vx_f * step - 0.5),
            t * height,
            vz_f * step - 0.5,
        ],
        -1,
    )
    dx = (rgt - l) * 0.5
    dz = (u - d) * 0.5
    tan = jnp.stack(
        [-4.0 * dx, 16.0 * jnp.ones_like(dx), -4.0 * dz, jnp.zeros_like(dx)], -1
    )
    n = jnp.stack(
        [
            (l - rgt) * 0.5 * NORMAL_STRENGTH,
            jnp.full_like(dx, 2.0 / height),
            dz * NORMAL_STRENGTH,
        ],
        -1,
    )
    n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
    # explicit f32 reciprocal multiply: XLA strength-reduces division by a
    # constant to this form anyway (under allow_excess_precision), but the
    # shard_map constant folder performs TRUE division — writing the mul
    # form keeps single-device and sharded emission bit-identical
    recip = np.float32(1.0) / np.float32(uv_denom)
    uv = jnp.stack([vx_f * recip, vz_f * recip], -1)
    return pos, n, tan, uv


def _vertex_coords(resolution: int, tile_size):
    r = resolution
    step = tile_size / r
    vx = jnp.arange(r + 1, dtype=_F32)
    vx_f = jnp.broadcast_to(vx[None, :], (r + 1, r + 1))
    vz_f = jnp.broadcast_to(vx[:, None], (r + 1, r + 1))
    return vx_f, vz_f, step


def _assemble(resolution, t, l, rgt, u, d, tile_size, height, uv_denom):
    r = resolution
    vx_f, vz_f, step = _vertex_coords(r, tile_size)
    pos, n, tan, uv = vertex_fields(
        t, l, rgt, u, d, vx_f, vz_f, step, height, uv_denom
    )
    nverts = (r + 1) * (r + 1)
    return pos.reshape(nverts, 3), n.reshape(nverts, 3), tan.reshape(nverts, 4), uv.reshape(nverts, 2)


def _assemble_planes(resolution, t, l, rgt, u, d, tile_size, height, uv_denom):
    vx_f, vz_f, step = _vertex_coords(resolution, tile_size)
    return jnp.stack(
        vertex_plane_list(t, l, rgt, u, d, vx_f, vz_f, step, height, uv_denom),
        0,
    )


def _interp_edge(a, b):
    """InterpolateEdge (SquareGridHeightMap.cs:36-38): a − (b − a)."""
    return a - (b - a)


def _squaregrid_taps(heights, r: int, off: int):
    """SquareGridHeightMap tap assembly: center-crop + edge-extrapolated
    neighbor taps.

    Neighbor taps are slices of an edge-padded window (gather-free: slices
    are plain strided copies, fancy indexing would be a gather).
    The taps that would need clamping only feed lanes replaced by the
    InterpolateEdge branch below, so pad values never leak through."""
    t, l_in, r_in, u_in, d_in = _tap_slices(heights, r, off)
    x = jnp.arange(r + 1)
    z = jnp.arange(r + 1)
    xg, zg = jnp.meshgrid(x, z, indexing="xy")
    l = jnp.where(xg > 0, l_in, _interp_edge(t, r_in))
    rgt = jnp.where(xg < r - 1, r_in, _interp_edge(t, l_in))
    u = jnp.where(zg > 0, u_in, _interp_edge(d_in, t))
    d = jnp.where(zg < r - 1, d_in, _interp_edge(u_in, t))
    return t, l, rgt, u, d


@partial(jax.jit, static_argnames=("resolution", "input_resolution"))
def heightmap_mesh(
    heights,
    resolution: int,
    input_resolution: int,
    height,
    tile_size,
):
    """SquareGridHeightMap: center-crop + edge-extrapolated normals.

    ``heights``: f32[input_resolution, input_resolution] (flat z·res+x grid
    in the reference).  Returns MeshArrays of (resolution+1)² vertices.
    """
    r = resolution
    off = (input_resolution - r) // 2  # PixOffset (SquareGridHeightMap.cs:33)
    t, l, rgt, u, d = _squaregrid_taps(heights, r, off)
    pos, n, tan, uv = _assemble(r, t, l, rgt, u, d, tile_size, height, float(r + 1))
    return MeshArrays(pos, n, tan, uv, jnp.asarray(grid_indices(r)))


@partial(jax.jit, static_argnames=("resolution", "input_resolution"))
def heightmap_mesh_planes(
    heights,
    resolution: int,
    input_resolution: int,
    height,
    tile_size,
):
    """``heightmap_mesh`` in the component-major ``MeshPlanes`` layout
    (same math; normals agree to a few ulp — see ``vertex_plane_list``)."""
    r = resolution
    off = (input_resolution - r) // 2
    t, l, rgt, u, d = _squaregrid_taps(heights, r, off)
    planes = _assemble_planes(r, t, l, rgt, u, d, tile_size, height,
                              float(r + 1))
    return MeshPlanes(planes, jnp.asarray(grid_indices(r)))


def _tap_slices(heights, r: int, off: int):
    """(center, left, right, up, down) height taps over the (r+1)² vertex
    grid as slices of a pad-by-2 edge-extended input."""
    ext = jnp.pad(heights, 2, mode="edge")
    b = off + 2
    t = ext[b:b + r + 1, b:b + r + 1]
    l_in = ext[b:b + r + 1, b - 1:b + r]
    r_in = ext[b:b + r + 1, b + 1:b + r + 2]
    u_in = ext[b - 1:b + r, b:b + r + 1]
    d_in = ext[b + 1:b + r + 2, b:b + r + 1]
    return t, l_in, r_in, u_in, d_in


@partial(jax.jit, static_argnames=("resolution", "input_resolution"))
def heightmap_mesh_overshoot(
    heights,
    resolution: int,
    input_resolution: int,
    height,
    tile_size,
):
    """OvershootSquareGridHeightMap: reads real margin samples for the
    neighbor taps instead of extrapolating (OvershootSquareGridHeightMap.cs).
    Used by the live-erosion mesher (LiveErosion.cs:305)."""
    r = resolution
    off = (input_resolution - r) // 2
    # taps read real margin samples; ±1 reaches outside the input only when
    # off == 0, where the clamp == edge replication the padding provides
    t, l, rgt, u, d = _tap_slices(heights, r, off)
    pos, n, tan, uv = _assemble(r, t, l, rgt, u, d, tile_size, height, float(r) - 0.5)
    return MeshArrays(pos, n, tan, uv, jnp.asarray(grid_indices(r)))


@partial(jax.jit, static_argnames=("resolution", "input_resolution"))
def heightmap_mesh_overshoot_planes(
    heights,
    resolution: int,
    input_resolution: int,
    height,
    tile_size,
):
    """``heightmap_mesh_overshoot`` in the component-major ``MeshPlanes``
    layout (same math; normals agree to a few ulp — see
    ``vertex_plane_list``).  The tile-batch serving path emits this
    layout — see MeshPlanes."""
    r = resolution
    off = (input_resolution - r) // 2
    t, l, rgt, u, d = _tap_slices(heights, r, off)
    planes = _assemble_planes(r, t, l, rgt, u, d, tile_size, height,
                              float(r) - 0.5)
    return MeshPlanes(planes, jnp.asarray(grid_indices(r)))


def flat_water_mesh(resolution: int):
    """SharedSquareGridPosition (water plane) + MeshHelper.SquarePlanarMesh
    cache semantics live in noize_tpu.app; this emits the unit plane."""
    r = resolution
    xs = jnp.arange(r + 1, dtype=_F32) / r - 0.5
    xs = xs.at[0].set(-0.5)
    zs = jnp.arange(r + 1, dtype=_F32) / r - 0.5
    pos = jnp.stack(
        [
            jnp.broadcast_to(xs[None, :], (r + 1, r + 1)),
            jnp.zeros((r + 1, r + 1), _F32),
            jnp.broadcast_to(zs[:, None], (r + 1, r + 1)),
        ],
        -1,
    ).reshape(-1, 3)
    n = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]], _F32), (pos.shape[0], 1))
    tan = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0, -1.0]], _F32), (pos.shape[0], 1))
    iu = jnp.arange(r + 1, dtype=_F32) / (r + 1)
    uv = jnp.stack(
        [
            jnp.broadcast_to(iu[None, :], (r + 1, r + 1)),
            jnp.broadcast_to(iu[:, None], (r + 1, r + 1)),
        ],
        -1,
    ).reshape(-1, 2)
    return MeshArrays(pos, n, tan, uv, jnp.asarray(grid_indices(r)))


_WATER_MESH_CACHE = {}


def square_planar_mesh(resolution: int):
    """MeshHelper.SquarePlanarMesh per-resolution cache (Helper.cs:63-69)."""
    if resolution not in _WATER_MESH_CACHE:
        _WATER_MESH_CACHE[resolution] = flat_water_mesh(resolution)
    return _WATER_MESH_CACHE[resolution]
