"""Halo exchange for 2-D spatially sharded grids.

Replaces the reference's margin-overlap recompute (GENERATOR_RES =
TILE_RES + 2·margin — MeshTileGenerator.cs:166-169): instead of every tile
regenerating a margin band, shards exchange edge strips with
``lax.ppermute`` inside ``shard_map``.

Boundary semantics: shards at the global border replicate their own edge
strip, so a sharded stencil is *bit-identical* to the single-device op with
edge-clamped indexing (TileData.cs:72-77 semantics) — tested in
tests/test_parallel.py.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def _edge_strip(block, dim: int, take: int, from_start: bool):
    idx = [slice(None)] * block.ndim
    idx[dim] = slice(0, take) if from_start else slice(block.shape[dim] - take, None)
    return block[tuple(idx)]


def exchange_axis(block, halo: int, axis_name: str, dim: int,
                  border: str = "clamp"):
    """Extend ``block`` by ``halo`` cells on both sides of ``dim`` with
    neighbor data along mesh axis ``axis_name``.  Must run inside shard_map.

    ``border``: halo content at the GLOBAL border — "clamp" replicates the
    shard's own edge strip (gather-stencil clamp semantics), "zero" fills
    zeros (scatter/adjoint semantics — out-of-grid sources don't exist)."""
    n = lax.axis_size(axis_name)
    i = lax.axis_index(axis_name)
    send_to_next = _edge_strip(block, dim, halo, from_start=False)
    send_to_prev = _edge_strip(block, dim, halo, from_start=True)
    if n > 1:
        fwd = [(k, k + 1) for k in range(n - 1)]
        bwd = [(k, k - 1) for k in range(1, n)]
        from_prev = lax.ppermute(send_to_next, axis_name, fwd)
        from_next = lax.ppermute(send_to_prev, axis_name, bwd)
    else:
        from_prev = jnp.zeros_like(send_to_prev)
        from_next = jnp.zeros_like(send_to_next)
    if border == "clamp":
        # global-border shards replicate their own edge (clamp semantics)
        own_first = _edge_strip(block, dim, 1, from_start=True)
        own_last = _edge_strip(block, dim, 1, from_start=False)
        reps = [1] * block.ndim
        reps[dim] = halo
        from_prev = jnp.where(i == 0, jnp.tile(own_first, reps), from_prev)
        from_next = jnp.where(i == n - 1, jnp.tile(own_last, reps), from_next)
    else:
        from_prev = jnp.where(i == 0, jnp.zeros_like(from_prev), from_prev)
        from_next = jnp.where(i == n - 1, jnp.zeros_like(from_next), from_next)
    return jnp.concatenate([from_prev, block, from_next], axis=dim)


def exchange_2d(block, halo: int, axis_row: str = "x", axis_col: str = "y",
                border: str = "clamp"):
    """Full 2-D halo (rows then columns — the second pass carries the
    already-widened strips, so corners arrive correctly)."""
    block = exchange_axis(block, halo, axis_row, dim=0, border=border)
    return exchange_axis(block, halo, axis_col, dim=1, border=border)


def reclamp_ghosts(ext, grow, gcol, halo: int, lr: int, lc: int,
                   res_r: int, res_c: int):
    """Re-replicate GLOBAL-border ghost cells from their border row/col.

    Fused multi-step stencils evolve a halo-extended block without
    re-exchanging between sub-steps; clamp semantics require out-of-grid
    ghosts to track the border cell they alias, so global-border shards
    refresh them after each sub-step (a no-op on interior shards —
    ``grow``/``gcol`` are the global coordinate grids of the extended
    block)."""
    ext = jnp.where(grow < 0, ext[halo:halo + 1, :], ext)
    ext = jnp.where(grow > res_r - 1, ext[halo + lr - 1:halo + lr, :], ext)
    ext = jnp.where(gcol < 0, ext[:, halo:halo + 1], ext)
    ext = jnp.where(gcol > res_c - 1, ext[:, halo + lc - 1:halo + lc], ext)
    return ext


def split_groups(total: int, k: int):
    """[k, k, ..., remainder] covering ``total`` items."""
    groups = []
    left = total
    while left > 0:
        groups.append(min(k, left))
        left -= groups[-1]
    return groups


def fold_axis(ext, halo: int, axis_name: str, dim: int):
    """Adjoint of exchange_axis for accumulators: fold the halo strips of an
    extended block back onto the owning neighbors' cores.

    My low strip holds contributions to the PREVIOUS shard's trailing cells
    and my high strip to the NEXT shard's leading cells; global-border
    strips are dropped (callers guarantee nothing accumulates out-of-grid).
    Returns the core block with neighbor contributions added."""
    n = lax.axis_size(axis_name)
    core_len = ext.shape[dim] - 2 * halo
    idx = [slice(None)] * ext.ndim
    idx[dim] = slice(0, halo)
    low = ext[tuple(idx)]
    idx[dim] = slice(halo, halo + core_len)
    core = ext[tuple(idx)]
    idx[dim] = slice(halo + core_len, None)
    high = ext[tuple(idx)]
    if n > 1:
        # my low strip → prev shard; I receive next shard's low strip
        from_next = lax.ppermute(low, axis_name,
                                 [(k, k - 1) for k in range(1, n)])
        # my high strip → next shard; I receive prev shard's high strip
        from_prev = lax.ppermute(high, axis_name,
                                 [(k, k + 1) for k in range(n - 1)])
        tail = [slice(None)] * core.ndim
        tail[dim] = slice(core_len - halo, None)
        head = [slice(None)] * core.ndim
        head[dim] = slice(0, halo)
        core = core.at[tuple(tail)].add(from_next)
        core = core.at[tuple(head)].add(from_prev)
    return core


def fold_2d(ext, halo: int, axis_row: str = "x", axis_col: str = "y"):
    """Adjoint of exchange_2d: fold columns first, then rows, so corner
    contributions route through the column neighbor exactly like the
    widened strips of the forward exchange."""
    ext = fold_axis(ext, halo, axis_col, dim=1)
    return fold_axis(ext, halo, axis_row, dim=0)


def _crop(block, halo: int):
    return block[halo:block.shape[0] - halo, halo:block.shape[1] - halo]


def sharded_stencil(fn: Callable, halo: int, mesh: Mesh,
                    axis_row: str = "x", axis_col: str = "y"):
    """Lift a local stencil ``fn(extended_block) -> extended_block`` (edge
    semantics, receptive field ≤ halo) to a sharded field op.

    The wrapped function takes/returns a global (H, W) array sharded
    P(axis_row, axis_col).
    """
    spec = P(axis_row, axis_col)

    @partial(
        shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec,
        check_vma=False,
    )
    def wrapped(block):
        ext = exchange_2d(block, halo, axis_row, axis_col)
        out = fn(ext)
        return _crop(out, halo)

    return wrapped
