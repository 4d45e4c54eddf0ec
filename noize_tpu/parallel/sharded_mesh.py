"""Spatially-sharded mesh emission — per-shard vertex blocks with global
index offsets.

Reference: the per-cycle loop ends with mesh regeneration
(/root/reference/Geologic/ParticleErosion/Component/LiveErosion.cs:302-315)
through the grid generators
(/root/reference/Mesh/Generators/SquareGridHeightMap.cs:12-106,
OvershootSquareGridHeightMap.cs).  On the sharded path the height field
lives partitioned P('x','y') across the device mesh, so the mesh must be
emitted in place: each shard computes a block of vertices from ONE halo
exchange wide enough for the crop offset plus the finite-difference
normal/tangent stencil, and its triangles reference either its own block
(local ids — directly renderable) or the global vertex grid (uint32).

Layout: shard (i, j) of an (nx, ny) mesh over an R² field (local block
lr = R/nx rows) emits the (lr+1, lc+1) vertex block covering vertices
[i·lr, i·lr+lr] × [j·lc, j·lc+lc] of the global (r+1)² grid — one
row/col of OVERLAP with the next shard, so the block self-contains every
vertex its own triangle cells need (cells (vz, vx) with
vz ∈ (i·lr, i·lr+lr]).  Overlapping vertices are computed identically on
both owners (same global taps).  Vertex (vz, vx) anchors at height cell
(off + vz, off + vx), off = (input_res − r)/2; the taps ride one
clamp-border halo exchange of width off + 2 — exchange ghosts replicate
the border row at every depth, exactly the single-device depth-2 edge
padding that the (r+1)-th vertex line reads when off ∈ {0, 1}.

Channels: positions (…, 3), normals (…, 3), tangents (…, 4), uvs (…, 2)
stacked per-shard into global arrays of shape (R + nx, R + ny, C)
sharded P('x','y', None); vertices beyond the (r+1)² grid are zero.
``mesh_arrays_from_fields`` reassembles a single-device
``ops.mesh.MeshArrays`` (bit-exact with ``heightmap_mesh`` /
``heightmap_mesh_overshoot`` — shared ``ops.mesh.vertex_fields``
elementwise core; tested in tests/test_parallel.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import mesh as _mesh
from .halo import exchange_2d, shard_map

_F32 = jnp.float32
_SPEC = P("x", "y")


def sharded_heightmap_mesh(mesh: Mesh, heights, resolution: int,
                           input_resolution: int, height, tile_size,
                           variant: str = "overshoot",
                           layout: str = "arrays"):
    """Emit per-shard (lr+1, lc+1) vertex blocks for the whole mesh (see
    module layout note).

    ``variant``: "overshoot" reads real margin samples for the neighbor
    taps (OvershootSquareGridHeightMap — the live-erosion mesher);
    "square" uses SquareGridHeightMap's InterpolateEdge extrapolation at
    the vertex-grid border.

    ``layout``: "arrays" returns {"positions", "normals", "tangents",
    "uvs"} global arrays of shape (R + nx, R + ny, C) sharded
    P('x','y', None) — bit-exact with the single-device MeshArrays path;
    "planes" returns {"planes": f32[12, R + nx, R + ny]} sharded
    P(None, 'x', 'y') — the component-major emission layout (the vertex
    grid stays on the minor dims; see ops.mesh.MeshPlanes),
    values within a few ulp of "arrays" (ops.mesh.vertex_plane_list)."""
    r = resolution
    off = (input_resolution - r) // 2
    if variant not in ("overshoot", "square"):
        raise ValueError(f"unknown mesh variant {variant!r}")
    if layout not in ("arrays", "planes"):
        raise ValueError(f"unknown mesh layout {layout!r}")
    halo = off + 2
    step = tile_size / r
    uv_denom = float(r) - 0.5 if variant == "overshoot" else float(r + 1)

    if layout == "planes":
        out_specs = {"planes": P(None, "x", "y")}
    else:
        out_specs = {k: P("x", "y", None)
                     for k in ("positions", "normals", "tangents", "uvs")}

    @partial(shard_map, mesh=mesh, in_specs=(_SPEC,), out_specs=out_specs,
             check_vma=False)
    def body(h):
        lr, lc = h.shape
        if halo > lr or halo > lc:
            raise ValueError(
                f"mesh halo {halo} (crop offset {off} + stencil) exceeds"
                f" shard block {(lr, lc)}; use fewer shards or a smaller"
                " margin")
        row0 = lax.axis_index("x") * lr
        col0 = lax.axis_index("y") * lc
        # clamp-border exchange replicates the edge row at every halo
        # depth == ops.mesh._tap_slices' depth-2 edge padding
        ext = exchange_2d(h, halo)
        # local vertex k ∈ [0, lr] anchors at height cell off + row0 + k,
        # i.e. ext row off + halo + k; taps are ±1 slices of that window
        b = off + halo
        nr, nc = lr + 1, lc + 1
        t = ext[b:b + nr, b:b + nc]
        l_in = ext[b:b + nr, b - 1:b - 1 + nc]
        r_in = ext[b:b + nr, b + 1:b + 1 + nc]
        u_in = ext[b - 1:b - 1 + nr, b:b + nc]
        d_in = ext[b + 1:b + 1 + nr, b:b + nc]

        vz = lax.broadcasted_iota(jnp.int32, (nr, nc), 0) + row0
        vx = lax.broadcasted_iota(jnp.int32, (nr, nc), 1) + col0
        if variant == "square":
            # SquareGridHeightMap.cs:70-73 — the exact call asymmetry:
            # the right/down branches switch at r−1, not r
            l = jnp.where(vx > 0, l_in, _mesh._interp_edge(t, r_in))
            rgt = jnp.where(vx < r - 1, r_in, _mesh._interp_edge(t, l_in))
            u = jnp.where(vz > 0, u_in, _mesh._interp_edge(d_in, t))
            d = jnp.where(vz < r - 1, d_in, _mesh._interp_edge(u_in, t))
        else:
            l, rgt, u, d = l_in, r_in, u_in, d_in

        if layout == "planes":
            planes = jnp.stack(_mesh.vertex_plane_list(
                t, l, rgt, u, d, vx.astype(_F32), vz.astype(_F32),
                step, height, uv_denom,
            ), 0)
            valid = ((vz <= r) & (vx <= r))[None]
            return {"planes": jnp.where(valid, planes, 0.0)}
        pos, n, tan, uv = _mesh.vertex_fields(
            t, l, rgt, u, d, vx.astype(_F32), vz.astype(_F32),
            step, height, uv_denom,
        )
        valid = ((vz <= r) & (vx <= r))[..., None]
        return {
            "positions": jnp.where(valid, pos, 0.0),
            "normals": jnp.where(valid, n, 0.0),
            "tangents": jnp.where(valid, tan, 0.0),
            "uvs": jnp.where(valid, uv, 0.0),
        }

    return body(heights)


def shard_vertex_window(resolution: int, input_resolution: int,
                        mesh_shape, shard_rc):
    """The slice of shard (i, j)'s (lr+1, lc+1) block holding REAL
    vertices (≤ r), plus the global (vz0, vx0) of its first vertex.
    Returns ((row_slice, col_slice), (vz0, vx0))."""
    r = resolution
    nx, ny = mesh_shape
    i, j = shard_rc
    lr = input_resolution // nx
    lc = input_resolution // ny
    vz0, vx0 = i * lr, j * lc
    rs = slice(0, max(min(lr + 1, r + 1 - vz0), 0))
    cs = slice(0, max(min(lc + 1, r + 1 - vx0), 0))
    return (rs, cs), (vz0, vx0)


def shard_mesh_indices(resolution: int, input_resolution: int, mesh_shape,
                       local: bool = False):
    """Per-shard triangle lists (uint32).

    Shard (i, j) owns the mesh cells (vz, vx) with vz ∈ (i·lr, i·lr+lr]
    and vx ∈ (j·lc, j·lc+lc] (∩ [1, r]) — every vertex those cells touch
    lives in its own (lr+1, lc+1) block.  ``local=False`` emits indices
    into the global (r+1)² vertex grid (global offsets per shard);
    ``local=True`` emits indices into the shard's own block, directly
    renderable against its vertex buffer.  The global lists concatenate
    to a permutation of ``ops.mesh.grid_indices``'s triangles (tested);
    winding per SquareGridHeightMap.cs:96-103."""
    r = resolution
    nx, ny = mesh_shape
    lr = input_resolution // nx
    lc = input_resolution // ny
    out = {}
    for i in range(nx):
        for j in range(ny):
            z_lo = max(i * lr + 1, 1)
            z_hi = min((i + 1) * lr, r) + 1
            x_lo = max(j * lc + 1, 1)
            x_hi = min((j + 1) * lc, r) + 1
            if z_hi <= z_lo or x_hi <= x_lo:
                out[(i, j)] = np.zeros((0,), np.uint32)
                continue
            z, x = np.meshgrid(np.arange(z_lo, z_hi),
                               np.arange(x_lo, x_hi), indexing="ij")
            if local:
                stride = lc + 1
                vi = (z - i * lr) * stride + (x - j * lc)
            else:
                stride = r + 1
                vi = z * stride + x
            t0 = np.stack([vi - stride - 1, vi - 1, vi - stride], -1)
            t1 = np.stack([vi - stride, vi - 1, vi], -1)
            out[(i, j)] = np.stack([t0, t1], -2).reshape(-1).astype(np.uint32)
    return out


def _reassemble_blocks(arr, resolution: int, input_resolution: int,
                       mesh_shape, grid_axis: int):
    """Shared shard-block reassembly: place each shard's (lr+1, lc+1)
    vertex window into the full (r+1)² grid.  ``grid_axis`` is the index
    of the vertex-ROW axis in ``arr`` (0 for the arrays layout's
    (R+nx, R+ny, C), 1 for the planes layout's (12, R+nx, R+ny)).
    Overlap rows/cols are identical on both owners, so placement order is
    irrelevant."""
    r = resolution
    nx, ny = mesh_shape
    lr = input_resolution // nx
    lc = input_resolution // ny
    shape = list(arr.shape)
    shape[grid_axis] = r + 1
    shape[grid_axis + 1] = r + 1
    full = np.zeros(shape, np.float32)
    pre = (slice(None),) * grid_axis
    for i in range(nx):
        for j in range(ny):
            blk = arr[pre + (slice(i * (lr + 1), (i + 1) * (lr + 1)),
                             slice(j * (lc + 1), (j + 1) * (lc + 1)))]
            (rs, cs), (vz0, vx0) = shard_vertex_window(
                r, input_resolution, mesh_shape, (i, j))
            full[pre + (slice(vz0, vz0 + rs.stop),
                        slice(vx0, vx0 + cs.stop))] = blk[pre + (rs, cs)]
    return full


def mesh_arrays_from_fields(fields, resolution: int, input_resolution: int,
                            mesh_shape):
    """Reassemble the per-shard overlapping vertex blocks into a
    single-device ``MeshArrays`` (host/consumer bridge; also the
    equivalence-test path)."""
    r = resolution
    nverts = (r + 1) * (r + 1)

    def assemble(chan, width):
        full = _reassemble_blocks(np.asarray(chan), r, input_resolution,
                                  mesh_shape, grid_axis=0)
        return jnp.asarray(full.reshape(nverts, width))

    return _mesh.MeshArrays(
        positions=assemble(fields["positions"], 3),
        normals=assemble(fields["normals"], 3),
        tangents=assemble(fields["tangents"], 4),
        uvs=assemble(fields["uvs"], 2),
        indices=jnp.asarray(_mesh.grid_indices(r)),
    )


def mesh_planes_from_fields(fields, resolution: int, input_resolution: int,
                            mesh_shape):
    """``mesh_arrays_from_fields`` for the ``layout="planes"`` output:
    reassemble the per-shard (12, lr+1, lc+1) blocks into a single-device
    ``MeshPlanes``."""
    full = _reassemble_blocks(np.asarray(fields["planes"]), resolution,
                              input_resolution, mesh_shape, grid_axis=1)
    return _mesh.MeshPlanes(jnp.asarray(full),
                            jnp.asarray(_mesh.grid_indices(resolution)))
