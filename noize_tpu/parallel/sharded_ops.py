"""Spatially-sharded (sp) versions of the field ops: noise, separable
filters, flow map — one logical grid split over a 2-D device mesh with halo
exchange.

Parity contract: each op here equals its single-device counterpart in
noize_tpu.ops bit-for-bit up to float reassociation (edge-replicated halos
reproduce the clamped-index boundary semantics) — tests/test_parallel.py
checks them against the local ops on a virtual 8-device CPU mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import kernels as _k
from ..ops import flow as _f
from ..ops.fractal import noise_value
from .halo import (exchange_2d, reclamp_ghosts, shard_map, split_groups,
                   _crop)


def sharded_fractal(mesh: Mesh, resolution: int, xpos, zpos, **kw):
    """Fractal noise over a sharded (resolution²) grid.

    Noise is pure position math — each shard evaluates its own world-space
    window; no communication.  Equals ops.fractal exactly.
    """
    spec = P("x", "y")
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    local_r = resolution // nx
    local_c = resolution // ny

    @partial(shard_map, mesh=mesh, in_specs=(), out_specs=spec, check_vma=False)
    def gen():
        ix = lax.axis_index("x")
        iy = lax.axis_index("y")
        # local window origin in the global tile; world offset adds on top
        row0 = ix * local_r
        col0 = iy * local_c
        col = lax.broadcasted_iota(jnp.float32, (local_r, local_c), 1) + col0
        row = lax.broadcasted_iota(jnp.float32, (local_r, local_c), 0) + row0
        inv = 1.0 / jnp.float32(kw.get("noise_size", 1000.0))
        xi = (col + xpos) * inv
        zi = (row + zpos) * inv
        g = jnp.exp2(-jnp.float32(kw.get("hurst", 0.0)))
        t = jnp.zeros((local_r, local_c), jnp.float32)
        f = jnp.float32(1.0)
        a = jnp.float32(kw.get("starting_amplitude", 1.0))
        detune = jnp.float32(0.0)
        stepdown = jnp.float32(kw.get("stepdown", 2.0))
        detune_rate = jnp.float32(kw.get("detune_rate", 0.0))
        octaves = kw.get("octaves", 1)
        kind = kw.get("noise_type", "Perlin")
        for _ in range(octaves):
            t = t + a * noise_value(kind, f * xi, f * zi)
            detune = detune + detune_rate
            f = f * (stepdown - detune)
            a = a * g
        norm = jnp.float32(0.0)
        amp = jnp.float32(1.0)
        for _ in range(octaves):
            norm = norm + amp
            amp = amp * g
        return t / norm

    # one compiled program, not an eager op-by-op trace of the octave loop
    return jax.jit(gen)()


def _sharded_iterated_stencil(mesh: Mesh, data, local, hw: int,
                              iterations: int):
    """Run ``iterations`` of a clamped stencil ``local(ext) -> ext`` (per-
    iteration receptive field ``hw`` per side) over the sharded field with
    ONE halo exchange per GROUP of iterations instead of one per
    iteration: the group rides a k·hw halo with validity shrinking hw per
    iteration, and global-border ghosts re-replicate their border cell
    after each iteration (clamp semantics — ghosts must track the border
    between fused iterations).  Within ~1 ulp of the single-device chain
    (FMA contraction differs between separately compiled programs)."""
    spec = P("x", "y")
    res_r, res_c = data.shape
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    lr = res_r // nx
    lc = res_c // ny
    if hw > min(lr, lc):
        raise ValueError(
            f"stencil receptive field {hw} exceeds shard block {(lr, lc)}; "
            "use fewer shards")
    k = max(1, min(iterations, min(lr, lc) // hw))
    H = k * hw
    groups = split_groups(iterations, k)

    @partial(shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec,
             check_vma=False)
    def run(block):
        row0 = lax.axis_index("x") * lr - H
        col0 = lax.axis_index("y") * lc - H
        shape_ext = (lr + 2 * H, lc + 2 * H)
        grow = lax.broadcasted_iota(jnp.int32, shape_ext, 0) + row0
        gcol = lax.broadcasted_iota(jnp.int32, shape_ext, 1) + col0

        def step(ext, _):
            return reclamp_ghosts(
                local(ext), grow, gcol, H, lr, lc, res_r, res_c), None

        sl = (slice(H, H + lr), slice(H, H + lc))
        for gi, g in enumerate(groups):
            ext = exchange_2d(block, H)
            ext, _ = lax.scan(step, ext, None, length=g)
            block = ext[sl]
        return block

    return jax.jit(run)(data)


def sharded_kernel_filter(mesh: Mesh, data, filter_type: str, iterations: int = 1):
    """kernel_filter over a sharded field — one halo exchange per group of
    iterations (see _sharded_iterated_stencil)."""
    if filter_type == "Sobel3_2D":
        return _sharded_iterated_stencil(
            mesh, data, _k.sobel2d, 1, iterations)
    tx, tz, factor = _k._SERIES_TABLE[filter_type]
    hw = (len(tx) - 1) // 2
    return _sharded_iterated_stencil(
        mesh, data, lambda a: _k.separable_series(a, tx, tz, factor),
        hw, iterations)


def sharded_gauss_blur(mesh: Mesh, data, width: int, sigma, iterations: int = 1):
    from ..ops import blur as _b

    width = _b.limit_width(width)
    taps = _b.gaussian_taps(_b.sigma_value(sigma), width)
    return _sharded_iterated_stencil(
        mesh, data, lambda a: _k.separable_series(a, taps, taps, 1.0),
        (width - 1) // 2, iterations)


def sharded_thermal_erosion(mesh: Mesh, data, talus, increment_ratio,
                            height_width_ratio, iterations: int = 1):
    """thermal_erosion over a sharded field: the mask/role phase variant
    (ops.thermal.thermal_phase_masked) with ONE halo-8 exchange per
    iteration covering all 4 phases (validity shrinks 2 cells/phase).
    Within ~1 ulp of the single-device op (see the in-body caveat)."""
    from ..ops import thermal as _t

    res = data.shape[0]
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    local_r = res // nx
    local_c = res // ny
    talus_rad = (talus / 90.0) * 3.14159 / 2.0
    spec = P("x", "y")

    # phases per exchange, sized to the shard block (2 cells of validity
    # per phase per side); blocks >= 8 fuse all 4 phases per iteration
    minb = min(local_r, local_c)
    if minb < 2:
        raise ValueError(f"shard block {(local_r, local_c)} too small")
    k_ph = max(1, min(4, minb // 2))
    H = 2 * k_ph
    phase_groups = split_groups(4, k_ph)

    @partial(shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    def run(block):
        max_diff = (jnp.tan(jnp.float32(talus_rad)) * height_width_ratio) / res
        row0 = lax.axis_index("x") * local_r - H
        col0 = lax.axis_index("y") * local_c - H

        # ONE halo exchange per iteration (4 phases ride an 8-cell halo
        # with shrinking validity) instead of one per phase — 4× fewer
        # collective rounds.  No ghost reclamping is needed: thermal
        # blocks are anchored strictly inside the grid, so valid cells
        # never read out-of-grid ghosts.  One phase per scan step via
        # lax.switch (unrolled multi-phase bodies explode XLA compile).
        # Caveat: XLA FMA-contracts differently-fused but mathematically
        # identical programs differently, so ~1% of cells can differ from
        # the single-device op by 1 ulp.
        branches = [
            (lambda x0, z0: lambda e: _t.thermal_phase_masked(
                e, x0, z0, row0, col0, res, max_diff, increment_ratio))(
                    x0, z0)
            for (x0, z0) in _t._PHASE_OFFSETS
        ]

        def one_iter(_, b):
            p0 = 0
            for g in phase_groups:
                ext = exchange_2d(b, H)

                def phase(e, t):
                    return lax.switch(t, branches, e), None

                ext, _ = lax.scan(
                    phase, ext, jnp.arange(p0, p0 + g, dtype=jnp.int32))
                b = _crop(ext, H)
                p0 += g
            return b

        return lax.fori_loop(0, iterations, one_iter, block)

    return jax.jit(run)(data)


def sharded_flow_map(mesh: Mesh, height, iterations: int = 5,
                     norm_min=-0.1, norm_max=0.1):
    """flow_map over a sharded field with ONE halo exchange total.

    The old formulation exchanged ~10 strips per relaxation step; here the
    height rides a (2·iterations + 1)-cell halo once, the whole relaxation
    (water/flows initialized in place) plus velocity + normalize runs on
    the extended block, validity shrinks 2 cells per iteration per side,
    and ghost cells beyond the GLOBAL border re-replicate their border
    cell after every sub-step (clamp semantics), with ghosts on all four
    sides.  Within ~1 ulp of ops.flow.flow_map (FMA-contraction
    differences between separately compiled programs); when the halo
    exceeds the shard block,
    iterations run in groups with one exchange per group."""
    spec = P("x", "y")
    res_r, res_c = height.shape
    nx, ny = mesh.shape["x"], mesh.shape["y"]
    lr = res_r // nx
    lc = res_c // ny
    # iterations per exchange group: each iteration costs 2 cells of halo
    # validity per side (+1 for the final velocity stencil); the group
    # halo must fit the shard block
    if min(lr, lc) < 3:
        raise ValueError(
            f"shard block {(lr, lc)} below the minimum halo (3); "
            "use fewer shards")
    k = max(1, min(iterations, (min(lr, lc) - 1) // 2))
    H = 2 * k + 1
    groups = split_groups(iterations, k)

    @partial(shard_map, mesh=mesh, in_specs=(spec,), out_specs=spec, check_vma=False)
    def run(hblock):
        row0 = lax.axis_index("x") * lr - H
        col0 = lax.axis_index("y") * lc - H
        h_ext = exchange_2d(hblock, H)
        grow = lax.broadcasted_iota(jnp.int32, h_ext.shape, 0) + row0
        gcol = lax.broadcasted_iota(jnp.int32, h_ext.shape, 1) + col0

        def reclamp(ext):
            return reclamp_ghosts(ext, grow, gcol, H, lr, lc, res_r, res_c)

        def step(carry, _):
            water, fw, fe, fs, fn = carry
            fw, fe, fs, fn = _f.compute_flow_step(h_ext, water, fw, fe, fs, fn)
            fw, fe, fs, fn = (reclamp(a) for a in (fw, fe, fs, fn))
            water = reclamp(_f.update_water_step(water, fw, fe, fs, fn))
            return (water, fw, fe, fs, fn), None

        sl = (slice(H, H + lr), slice(H, H + lc))
        water = jnp.full(h_ext.shape, _f.WATER_INIT, jnp.float32)
        zeros = jnp.zeros(h_ext.shape, jnp.float32)
        carry = (water, zeros, zeros, zeros, zeros)
        for gi, g in enumerate(groups):
            if gi > 0:
                # re-extend the cropped state for the next group (ghosts
                # re-replicate as part of the exchange's clamp fill)
                carry = tuple(exchange_2d(a, H) for a in carry)
            carry, _ = lax.scan(step, carry, None, length=g)
            if gi < len(groups) - 1:
                carry = tuple(a[sl] for a in carry)

        _, fw, fe, fs, fn = carry
        v = _f.velocity_field(fw, fe, fs, fn)
        rng = norm_max - norm_min
        v = jnp.where(rng < 1e-12, 0.0, v)
        v = (v - norm_min) / rng
        return v[sl]

    return jax.jit(run)(height)
