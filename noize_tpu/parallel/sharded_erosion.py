"""Spatially-sharded erosion cycle — the FULL per-cycle DAG (thermal,
spawn, particle descent, event reduce, sediment write-back, flow decay,
pool automata) on one large grid sharded P('x','y') over a device mesh.

This supersedes the reference's margin-overlap tile model
(/root/reference/Scripts/MeshTileGenerator.cs:166-177 — independent tiles
with recomputed margins): here one global field is partitioned across
devices, with halo exchange (`parallel.halo`) carrying exactly the
strips each phase needs.  SURVEY.md §2.7 ("inter-tile margin → halo
exchange") at cycle scope.

Design per phase:

* thermal — grouped-phase halo exchange (``sharded_ops.sharded_thermal_erosion``).
* spawn — fresh particles are replicated computation (same PRNG key on
  every shard).  Drain-particle conversion needs a GLOBAL top-K over the
  drain map: each shard top-Ks its block, all-gathers the (value, global
  index) candidates (K·nshards scalars — tiny), and selects the exact
  global top-K by (value desc, index asc) — identical to the single-device
  ``lax.top_k`` incl. tie-breaks.
* descent — particles live REPLICATED on every shard; each chunk of
  ``chunk`` steps, the shard whose core block contains a particle's cell
  OWNS it (cores partition the grid, so exactly one owner).  Maps are
  read-only during descent, so ONE halo exchange of width ``chunk`` before
  the loop suffices: an owned particle drifts ≤ 1 cell/step and every read
  stays inside the extended block.  After each chunk a masked ``psum``
  merges the per-owner particle states back to the replicated buffer — an
  event-sourcing exchange, no particle migration.  Events scatter-add into
  extended-block accumulators; halo strips fold back to their owning
  shards once at the end (``halo.fold_2d``).
* sediment — the clamped-scatter gaussian/tent dispersal splits into the
  zero-padded correlation (neighbor contributions ride a zero-border halo
  exchange) plus closed-form global-edge folds applied only on border
  shards — bit-exact with ``erosion.sediment._disperse_axis``.
* flow decay — elementwise (no communication).
* pool automata — ONE pool exchange per water step: all four phases run
  on an 8-cell halo with per-phase global-border ghost reclamping;
  ``_spread_phase`` takes global-coordinate masks/borders (the same
  contract halo windows use) and the exact core crops out.

Determinism note (D8, extends PARITY.md D5): per-cell float sums of
descent events reassociate across shard boundaries (each shard scatters
its owned particles' events, then halo folds add neighbor contributions),
so multi-particle collisions on one cell can differ from the single-device
scatter order by float reassociation (~1 ulp).  Everything else — spawn,
thermal, pool phases, sediment dispersal — is bit-exact; drain spawn uses
an exact two-stage global top-K (the single-device path's exact top-K).
``EXACT_PILES`` (serial global solver) runs sharded via a SPARSE
replicated micro-solve — shards gather only the ≤K pile candidates and
their O(radius²) slot-cell values (masked psum), every device replays
the identical serial solve with a commit-overlay table, and each shard
commits the records to its own block (bit-exact incl. cross-border and
chained-overlap piles; O(K·radius²) memory, no O(res²) replication —
see _sharded_write_sediment_exact).
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..erosion.params import ErosionMode, ErosionSettings
from ..erosion.particles import Particles, descend_step, spawn
from ..erosion.pool import (_border_maps, _phase_mask_from_coords,
                            _spread_phase, _PHASE_ORDER)
from ..erosion.sediment import KERNEL5, _triangle_taps
from ..erosion.sim import ErosionSim as _ErosionSimBase, SimState
from ..erosion.world import WorldState, update_flow_from_track
from ..core.tiles import TileSetMeta
from .halo import (exchange_2d, exchange_axis, fold_2d, reclamp_ghosts,
                   shard_map)

_F32 = jnp.float32
_SPEC = P("x", "y")
_REP = P()


def _origin(block_shape):
    lr, lc = block_shape
    return lax.axis_index("x") * lr, lax.axis_index("y") * lc


# --- spawn -------------------------------------------------------------------

def _sharded_spawn(mesh: Mesh, drain_water, key, n: int, res: int):
    """_spawn_with_drains (erosion.sim) over a sharded drain map.

    Returns (particles [replicated], leftover drain [sharded], next key).
    Runs the with-drains path unconditionally — with an empty drain map
    every candidate value is 0, ``has_drain`` is all-False and the result
    equals the fresh spawn, exactly as the single-device cond."""
    k1, k2 = jax.random.split(key)

    @partial(shard_map, mesh=mesh, in_specs=(_SPEC, _REP),
             out_specs=(jax.tree_util.tree_map(lambda _: _REP, Particles(
                 *[0] * 8)), _SPEC),
             check_vma=False)
    def body(drain_block, k1):
        lr, lc = drain_block.shape
        row0, col0 = _origin((lr, lc))
        fresh = spawn(k1, n, res)
        flat = drain_block.reshape(-1)
        kloc = min(n, flat.shape[0])
        vals_l, lidx = lax.top_k(flat, kloc)
        gidx_l = ((lidx // lc) + row0) * res + ((lidx % lc) + col0)
        vals_all = lax.all_gather(vals_l, "x")
        vals_all = lax.all_gather(vals_all, "y").reshape(-1)
        gidx_all = lax.all_gather(gidx_l, "x")
        gidx_all = lax.all_gather(gidx_all, "y").reshape(-1)
        # exact global top-n: value desc, global index asc on ties — the
        # tie rule lax.top_k applies on the flat global array
        order = jnp.lexsort((gidx_all, -vals_all))[:n]
        vals = jnp.take(vals_all, order)
        idxs = jnp.take(gidx_all, order)
        has_drain = vals > 0.0
        rows_i = idxs // res
        cols_i = idxs % res
        parts = Particles(
            row=jnp.where(has_drain, rows_i.astype(_F32), fresh.row),
            col=jnp.where(has_drain, cols_i.astype(_F32), fresh.col),
            heading=fresh.heading,
            vel=fresh.vel,
            water=jnp.where(has_drain, vals, fresh.water),
            sediment=fresh.sediment,
            age=fresh.age,
            alive=fresh.alive,
        )
        own = (has_drain & (rows_i >= row0) & (rows_i < row0 + lr)
               & (cols_i >= col0) & (cols_i < col0 + lc))
        li = (jnp.clip(rows_i - row0, 0, lr - 1) * lc
              + jnp.clip(cols_i - col0, 0, lc - 1))
        taken = jnp.zeros_like(flat).at[li].add(jnp.where(own, vals, 0.0))
        leftover = jnp.maximum(flat - taken, 0.0).reshape(lr, lc)
        return parts, leftover

    parts, leftover = body(drain_water, k1)
    return parts, leftover, k2


# --- descent -----------------------------------------------------------------

def _sharded_descent(mesh: Mesh, world: WorldState, parts: Particles,
                     params, height_scale, patch_res, res: int,
                     chunk: int = 8):
    """descend_all over sharded maps with replicated particles.

    Fixed ``ceil((MAXAGE+1)/chunk)`` chunks (the single-device early exit
    is a pure skip of no-op work).  Returns (particles, track, pool, sed)
    with the accumulators sharded like the maps."""
    steps = params.MAXAGE + 1
    n_chunks = -(-steps // chunk)
    H = chunk
    with_plants = getattr(params, "VEGETATION_FRICTION", 0.0) > 0.0
    p_specs = jax.tree_util.tree_map(lambda _: _REP, parts)

    @partial(shard_map, mesh=mesh,
             in_specs=(_SPEC, _SPEC, _SPEC, _SPEC, p_specs),
             out_specs=(p_specs, _SPEC, _SPEC, _SPEC),
             check_vma=False)
    def body(h, pw, fl, pl, part):
        lr, lc = h.shape
        if H > lr or H > lc:
            raise ValueError(
                f"descent halo {H} exceeds shard block {(lr, lc)}; use a"
                " smaller chunk, fewer shards, or a larger field")
        row0, col0 = _origin((lr, lc))
        er, ec = lr + 2 * H, lc + 2 * H

        wih = height_scale * (h + pw)
        all_h = wih + params.FLOW_HEIGHT_CONTRIBUTION * fl
        pieces = [exchange_2d(wih, H).reshape(-1),
                  exchange_2d(all_h, H).reshape(-1),
                  exchange_2d(fl, H).reshape(-1)]
        if with_plants:
            pieces.append(exchange_2d(pl, H).reshape(-1))
        combo = jnp.concatenate(pieces)
        origin = (row0 - H, col0 - H)

        zeros_ext = jnp.zeros(er * ec, _F32)

        def chunk_body(carry, _):
            part, at, ap, asd = carry
            row_i = jnp.clip(jnp.round(part.row).astype(jnp.int32), 0, res - 1)
            col_i = jnp.clip(jnp.round(part.col).astype(jnp.int32), 0, res - 1)
            owned = ((row_i >= row0) & (row_i < row0 + lr)
                     & (col_i >= col0) & (col_i < col0 + lc))

            def step_body(p_in, _):
                p_out, ev = descend_step(
                    p_in, None, params, height_scale, patch_res, res,
                    maps=combo, window_origin=origin,
                    window_shape=(er, ec),
                )
                li = ((ev["row"] - origin[0]) * ec
                      + (ev["col"] - origin[1])).astype(jnp.int32)
                return p_out, (
                    li,
                    jnp.where(owned, ev["d_track"], 0.0),
                    jnp.where(owned, ev["d_pool"], 0.0),
                    jnp.where(owned, ev["d_sed"], 0.0),
                )

            part, (idx, dt, dp_, ds) = lax.scan(
                step_body, part, None, length=chunk)
            idx = idx.reshape(-1)
            at = at.at[idx].add(dt.reshape(-1))
            ap = ap.at[idx].add(dp_.reshape(-1))
            asd = asd.at[idx].add(ds.reshape(-1))

            # event-sourcing merge: exactly one shard owns each particle.
            # All 8 fields pack into ONE (8, N) f32 stack so the merge is
            # a single psum per chunk instead of eight collectives; int
            # fields round-trip exactly (heading/age/alive are small ints,
            # exactly representable in f32).
            stack = jnp.stack([
                part.row, part.col, part.heading.astype(_F32), part.vel,
                part.water, part.sediment, part.age.astype(_F32),
                part.alive.astype(_F32),
            ])
            stack = lax.psum(
                jnp.where(owned[None, :], stack, 0.0), ("x", "y"))
            merged = Particles(
                row=stack[0], col=stack[1],
                heading=stack[2].astype(jnp.int32),
                vel=stack[3], water=stack[4], sediment=stack[5],
                age=stack[6].astype(jnp.int32),
                alive=stack[7] > 0.5,
            )
            return (merged, at, ap, asd), None

        (part, at, ap, asd), _ = lax.scan(
            chunk_body, (part, zeros_ext, zeros_ext, zeros_ext),
            None, length=n_chunks)

        outs = []
        for acc in (at, ap, asd):
            outs.append(fold_2d(acc.reshape(er, ec), H))
        return part, outs[0], outs[1], outs[2]

    return body(world.height, world.pool, world.flow, world.plants, parts)


# --- sediment ----------------------------------------------------------------

def _disperse_axis_sharded(s, taps, axis_name: str, dim: int):
    """erosion.sediment._disperse_axis on one shard block: zero-padded
    correlation over a zero-border halo exchange, plus the closed-form edge
    folds applied only on global-border shards.  Per-cell op order matches
    the single-device version — bit-exact."""
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    off = (k - 1) // 2
    n_dim = s.shape[dim]
    if off > n_dim:
        raise ValueError(
            f"disperse kernel half-width {off} exceeds the shard block"
            f" ({n_dim} cells along {axis_name!r}); the edge folds would"
            " need neighbor-of-neighbor strips — use fewer shards or a"
            " smaller PILING_RADIUS")
    ext = exchange_axis(s, off, axis_name, dim, border="zero")
    ext = jnp.moveaxis(ext, dim, -1)
    s_m = jnp.moveaxis(s, dim, -1)
    n = s_m.shape[-1]
    out = None
    for i in range(k):
        piece = ext[..., i:i + n] * taps[k - 1 - i]
        out = piece if out is None else out + piece
    if off > 0:
        i0 = lax.axis_index(axis_name)
        is_lo = i0 == 0
        is_hi = i0 == lax.axis_size(axis_name) - 1
        t_lo = np.cumsum(taps)
        for j in range(off):
            w_lo = float(t_lo[off - j - 1])
            out = out.at[..., 0].add(
                jnp.where(is_lo, s_m[..., j] * w_lo, 0.0))
            out = out.at[..., n - 1].add(
                jnp.where(is_hi, s_m[..., n - 1 - j] * w_lo, 0.0))
    return jnp.moveaxis(out, -1, dim)


def _sharded_write_sediment_exact(mesh: Mesh, height, sed_acc, params,
                                  height_scale, max_piles: int = 64):
    """EXACT_PILES on the sharded cycle WITHOUT O(res²) replication.

    The reference PileSolver (LiveErosionDataTypes.cs:1052-1228) is an
    inherently serial GLOBAL solver — each pile's vertex walk reads
    heights that earlier piles may have committed, and chains of
    overlapping piles propagate information arbitrarily far, so no fixed
    halo width is sound.  But the solver's working set is tiny: ≤ K piles
    (the single-device ``exact_pile_deposit`` top-K), each touching only
    its S = O(radius²) static slot cells.  So instead of gathering maps,
    gather the SOLVE:

      1. candidates — each shard top-Ks its pile block, all-gathers the
         (volume, global index) pairs, and selects the exact global top-K
         by (volume desc, index asc) — identical to single-device
         ``lax.top_k`` incl. tie-breaks (same two-stage scheme as drain
         spawn), then reorders ascending index exactly like
         ``exact_pile_deposit``.
      2. slot values — each pile's S slot cells (border-clipped, exactly
         the single-device ``height[cr, cc]`` read) are fetched with a
         masked psum: the owning shard contributes, others add zero.
         (K·S floats — ~135 KB at radius 15, vs O(res²) maps.)
      3. replicated micro-solve — every device runs the identical serial
         loop over the K piles (``sediment._solve_pile``, the exact f32
         op sequence of the single-device path).  After each pile, its
         effective commits (rank-deduped: the highest-rank modified
         duplicate per cell — ``dup_higher``) OVERLAY the cached slot
         values of all later piles whose reads touch the committed
         cells.  This reproduces the serial read-after-commit semantics
         for arbitrary overlap chains.
      4. sharded commit — each shard replays the K commit records over
         its own block in pile order (non-owned / non-effective slots
         route to a trash cell), so heights never leave their shard.

    Bit-exact with the single-device opt-in (tested, incl. cross-border
    and chained-overlap piles)."""
    from ..erosion.sediment import _pile_tables, _solve_pile

    thresh = params.PILE_THRESHOLD / height_scale
    radius = params.PILING_RADIUS
    inc = jnp.float32(params.MIN_PILE_INCREMENT / height_scale)
    t = _pile_tables(radius)
    off_r = jnp.asarray(t["off_r"])
    off_c = jnp.asarray(t["off_c"])
    dup = jnp.asarray(t["dup_higher"])
    S = int(t["off_r"].shape[0])
    K = max_piles

    @partial(shard_map, mesh=mesh, in_specs=(_SPEC, _SPEC), out_specs=_SPEC,
             check_vma=False)
    def body(h, sed):
        er, ec = h.shape
        row0, col0 = _origin((er, ec))
        res_r = er * lax.axis_size("x")
        res_c = ec * lax.axis_size("y")

        # dispersal part — identical to the default path (bit-exact with
        # kernel_disperse), then the exact mode's breaker-before-piles
        disperse_part = jnp.where(sed <= thresh, sed, 0.0)
        pile_part = jnp.where(sed > thresh, sed, 0.0)
        delta = _disperse_axis_sharded(
            _disperse_axis_sharded(disperse_part, KERNEL5, "x", 0),
            KERNEL5, "y", 1)
        new_h = h + delta
        ok = (new_h >= 0.0) & (new_h <= 1.0)
        new_h = jnp.where(ok, new_h, h)

        # 1. global top-K pile candidates (exact two-stage top-K)
        kloc = min(K, er * ec)
        lv, li = lax.top_k(pile_part.reshape(-1), kloc)
        gidx = (row0 + li // ec) * res_c + (col0 + li % ec)
        cv = lax.all_gather(lax.all_gather(lv, "y"), "x").reshape(-1)
        cg = lax.all_gather(lax.all_gather(gidx, "y"), "x").reshape(-1)
        _, sidx, svols = lax.sort((-cv, cg, cv), num_keys=2)
        svols, sidx = svols[:K], sidx[:K]
        big = jnp.int32(res_r * res_c)
        order = jnp.argsort(jnp.where(svols > 0.0, sidx, big))
        vols = jnp.take(svols, order)
        idxs = jnp.take(sidx, order)

        # 2. per-pile slot geometry + masked-psum value fetch
        rows = idxs[:, None] // res_c + off_r[None, :]
        cols = idxs[:, None] % res_c + off_c[None, :]
        valid = (rows >= 0) & (cols >= 0) & (rows < res_r) & (cols < res_c)
        cr = jnp.clip(rows, 0, res_r - 1)
        cc = jnp.clip(cols, 0, res_c - 1)
        cid = cr * res_c + cc
        owned = ((cr >= row0) & (cr < row0 + er)
                 & (cc >= col0) & (cc < col0 + ec))
        lrr = jnp.clip(cr - row0, 0, er - 1)
        lcc = jnp.clip(cc - col0, 0, ec - 1)
        vals0 = lax.psum(jnp.where(owned, new_h[lrr, lcc], 0.0), ("x", "y"))

        # 3. replicated serial micro-solve with commit overlay
        def pile_step(j, carry):
            cur_vals, com_vals, com_eff = carry
            vals, modified = _solve_pile(cur_vals[j], valid[j], vols[j],
                                         inc, radius)
            write = modified & valid[j]
            eff = write & ~jnp.any(dup & write[None, :], axis=1)
            m = eff[None, None, :] & (cid[:, :, None] == cid[j][None, None, :])
            hit = jnp.any(m, axis=-1) & (jnp.arange(K) > j)[:, None]
            newv = jnp.sum(jnp.where(m, vals[None, None, :], 0.0), axis=-1)
            cur_vals = jnp.where(hit, newv, cur_vals)
            return (cur_vals, com_vals.at[j].set(vals),
                    com_eff.at[j].set(eff))

        _, com_vals, com_eff = lax.fori_loop(
            0, K, pile_step,
            (vals0, jnp.zeros((K, S), _F32), jnp.zeros((K, S), bool)))

        # 4. sharded commit replay (pile order; trash-routed non-writes)
        live = com_eff & owned
        tr = jnp.where(live, cr - row0, er)
        tc = jnp.where(live, cc - col0, ec)
        pad = jnp.zeros((er + 1, ec + 1), h.dtype).at[:er, :ec].set(new_h)
        pad = lax.fori_loop(
            0, K, lambda j, p: p.at[tr[j], tc[j]].set(com_vals[j]), pad)
        return pad[:er, :ec]

    return body(height, sed_acc)


def _sharded_write_sediment(mesh: Mesh, height, sed_acc, params,
                            height_scale):
    """erosion.sediment.write_sediment_map over sharded blocks.  The
    default separable-tent pile profile runs fully sharded; the
    ``EXACT_PILES`` opt-in routes through the replicated global solve
    (see _sharded_write_sediment_exact)."""
    if params.EXACT_PILES:
        return _sharded_write_sediment_exact(
            mesh, height, sed_acc, params, height_scale)
    thresh = params.PILE_THRESHOLD / height_scale
    tent = _triangle_taps(params.PILING_RADIUS)

    @partial(shard_map, mesh=mesh, in_specs=(_SPEC, _SPEC), out_specs=_SPEC,
             check_vma=False)
    def body(h, sed):
        disperse_part = jnp.where(sed <= thresh, sed, 0.0)
        pile_part = jnp.where(sed > thresh, sed, 0.0)
        delta = _disperse_axis_sharded(
            _disperse_axis_sharded(disperse_part, KERNEL5, "x", 0),
            KERNEL5, "y", 1)
        # pile_deposit of an all-zero map is zero — running it
        # unconditionally equals the single-device any()-gated cond
        delta = delta + _disperse_axis_sharded(
            _disperse_axis_sharded(pile_part, tent, "x", 0), tent, "y", 1)
        new_h = h + delta
        ok = (new_h >= 0.0) & (new_h <= 1.0)
        return jnp.where(ok, new_h, h)

    return body(height, sed_acc)


# --- pool automata -----------------------------------------------------------

def _sharded_pool_automata(mesh: Mesh, height, pool, res: int,
                           iterations: int, drain_particles: bool):
    """erosion.pool.pool_automata over sharded blocks with one halo
    exchange per WATER STEP: pool (and the drain accumulator, threaded so
    the per-phase f32 add order matches the single-device path) ride an
    8-cell halo, all four checkerboard phases of the step run on the
    extended block with global-coordinate masks/borders, validity shrinks
    2 cells per phase per side, and the exact core crops out.  4× fewer
    collective rounds than a per-phase exchange.  Bit-exact with the
    single-device op (tested); the single-device dry-grid lax.cond skip is
    omitted (a dry phase is a no-op either way)."""
    H = 8  # 2 cells of validity per phase per side × 4 phases

    @partial(shard_map, mesh=mesh, in_specs=(_SPEC, _SPEC),
             out_specs=(_SPEC, _SPEC), check_vma=False)
    def body(h, p):
        lr, lc = h.shape
        if H > lr or H > lc:
            raise ValueError(
                f"pool halo {H} exceeds shard block {(lr, lc)}; use fewer"
                " shards or a larger field")
        row0, col0 = _origin((lr, lc))
        ext_h = exchange_2d(h, H)
        grow = (lax.broadcasted_iota(jnp.int32, ext_h.shape, 0)
                + row0 - H)
        gcol = (lax.broadcasted_iota(jnp.int32, ext_h.shape, 1)
                + col0 - H)
        inb = (grow >= 0) & (grow < res) & (gcol >= 0) & (gcol < res)
        border = _border_maps(ext_h.shape, grow, gcol, res)
        masks = [
            _phase_mask_from_coords(grow, gcol, xo, zo) & inb
            for xo, zo in _PHASE_ORDER
        ]

        # Ghost cells beyond the GLOBAL border must track their border
        # cell between the fused phases (clamp semantics — a border cell's
        # out-of-grid neighbor read is a self-read), exactly like the
        # fused flow/thermal kernels' per-sub-step reclamping; the drain
        # accumulator stays core-sized (its halo is never read — each
        # phase's cropped contribution adds on in phase order, preserving
        # the single-device per-cell f32 add sequence) so only the pool
        # rides the exchange.
        sl_r = slice(H, H + lr)
        sl_c = slice(H, H + lc)

        # one phase per inner step via lax.switch — an unrolled 4-phase
        # body explodes XLA compile time (see pool.pool_automata's branch
        # structure); the exchange still happens once per water step
        def make_branch(i):
            def br(c):
                ext_p, drains = c
                new_p, dm_ext = _spread_phase(
                    ext_h, ext_p, masks[i], drain_particles, border=border)
                new_p = reclamp_ghosts(new_p, grow, gcol, H, lr, lc,
                                       res, res)
                return new_p, drains + dm_ext[sl_r, sl_c]
            return br

        branches = [make_branch(i) for i in range(4)]

        def water_step(carry, _):
            p, drains = carry

            def phase(c, t):
                return lax.switch(t, branches, c), None

            (ext_p, drains), _ = lax.scan(
                phase, (exchange_2d(p, H), drains),
                jnp.arange(4, dtype=jnp.int32))
            return (ext_p[sl_r, sl_c], drains), None

        (p, drains), _ = lax.scan(
            water_step, (p, jnp.zeros_like(p)), None, length=iterations)
        return p, drains

    return body(height, pool)


# --- the cycle ---------------------------------------------------------------

@partial(
    jax.jit,
    static_argnames=("mesh", "settings", "meta", "chunk"),
)
def sharded_erosion_cycle(mesh: Mesh, state: SimState,
                          settings: ErosionSettings, meta: TileSetMeta,
                          chunk: int = 8, tuned=None) -> SimState:
    """One full erosion cycle (erosion.sim.erosion_cycle parity) on a
    P('x','y')-sharded world.  All SimState arrays must be sharded
    P('x','y') except ``key`` (replicated).

    Jitted as ONE XLA program over the mesh (the eager per-op dispatch
    path re-traced every shard_map per call — 15× slower per cycle on the
    8-device CPU mesh, and one dispatch per op on real devices).

    ``tuned``: optional dict of TUNABLE_FIELDS passed as TRACED scalars
    (see erosion.params) — shard_map closes over the traced values as
    replicated operands, so live-retuning sliders between cycles reuses
    the compiled program exactly like the single-device erosion_cycle."""
    params = settings.as_parameters()
    if tuned is not None:
        params = replace(params, **{
            k: jnp.float32(v) for k, v in tuned.items()
        })
    res = meta.generator_res
    height_scale = float(meta.height)
    patch_res = meta.patch_res
    world = state.world
    behavior = settings.BEHAVIOR

    # 1. thermal
    if settings.ENABLE_THERMAL and behavior != ErosionMode.ONLY_FLOW_WATER:
        from .sharded_ops import sharded_thermal_erosion

        new_height = sharded_thermal_erosion(
            mesh, world.height, settings.TALUS, settings.THERMAL_STEP,
            float(meta.tile_size) / float(meta.height),
            iterations=settings.THERMAL_CYCLES)
        world = replace(world, height=new_height)

    drain_water = state.drain_water
    key = state.key

    if behavior != ErosionMode.ONLY_FLOW_WATER:
        # 2. spawn (drain conversion via exact global top-K)
        parts, drain_water, key = _sharded_spawn(
            mesh, drain_water, key, settings.PARTICLES_PER_CYCLE, res)
        world = replace(world, pool=world.pool + drain_water)
        drain_water = jnp.zeros_like(drain_water)

        # 3. descent
        _, track_acc, pool_acc, sed_acc = _sharded_descent(
            mesh, world, parts, params, height_scale, patch_res, res,
            chunk=chunk)

        # 4. event reduce (elementwise — sharding propagates)
        world = replace(
            world,
            pool=world.pool + pool_acc * params.POOL_PLACEMENT_MULTIPLIER,
            track=world.track + track_acc * params.TRACK_PLACEMENT_MULTIPLIER,
        )

        # 5. sediment write-back
        world = replace(
            world,
            height=_sharded_write_sediment(
                mesh, world.height, sed_acc, params, height_scale),
        )

    # 6. track → flow decay + evaporation (elementwise)
    world = update_flow_from_track(world, params, height_scale)

    # 7. pool automata
    pool, drains = _sharded_pool_automata(
        mesh, world.height, world.pool, res, settings.WATER_STEPS,
        drain_particles=behavior != ErosionMode.ONLY_FLOW_WATER)
    world = replace(world, pool=pool)
    drain_water = drain_water + drains

    # pin output shardings: under one jit, XLA's auto propagation may pick
    # a REPLICATED layout for a map (observed: track on the 8-dev CPU
    # mesh), which both wastes a full res² copy per device and flips the
    # next call's input avals — retracing the whole cycle every step
    sh = NamedSharding(mesh, P("x", "y"))
    con = lambda a: lax.with_sharding_constraint(a, sh)
    world = replace(world, height=con(world.height), pool=con(world.pool),
                    flow=con(world.flow), track=con(world.track),
                    plants=con(world.plants))
    return SimState(
        world=world, drain_water=con(drain_water),
        key=lax.with_sharding_constraint(key, NamedSharding(mesh, P())))


def sharded_tile_step(mesh: Mesh, meta: TileSetMeta,
                      settings: ErosionSettings, xpos, zpos, key, *,
                      noise_type: str = "Simplex", octaves: int = 13,
                      hurst: float = 0.4, noise_size: float = 1700.0,
                      blur_width: int = 5, blur_sigma: float = 1.0,
                      blur_iterations: int = 17, flow_iterations: int = 8,
                      erosion_cycles: int = None, chunk: int = 8,
                      emit_mesh: bool = False,
                      mesh_layout: str = "arrays"):
    """The flagship tile step (app.flagship.make_tile_step) on ONE grid
    sharded P('x','y') over the mesh: sharded fractal noise → Gauss chain →
    flow map → N sharded erosion cycles.  Returns the final SimState plus
    the flow-velocity field, all sharded.

    This is the sp scale-out path: a 16k² world is one call on a device
    mesh, with every stage exchanging exactly its stencil halo — no margin
    recompute, no seam stitching (SURVEY.md §2.7)."""
    from ..erosion.sim import init_state
    from .sharded_ops import (sharded_flow_map, sharded_fractal,
                              sharded_gauss_blur)

    res = meta.generator_res
    cycles = settings.CYCLES if erosion_cycles is None else erosion_cycles
    h = sharded_fractal(
        mesh, res, xpos, zpos, noise_type=noise_type, octaves=octaves,
        hurst=hurst, noise_size=noise_size)
    h = sharded_gauss_blur(mesh, h, blur_width, blur_sigma,
                           iterations=blur_iterations)
    flow_v = sharded_flow_map(mesh, h, iterations=flow_iterations)
    state = init_state(h, key)
    for _ in range(cycles):
        state = sharded_erosion_cycle(mesh, state, settings, meta,
                                      chunk=chunk)
    if emit_mesh:
        # per-cycle mesh regeneration parity (LiveErosion.cs:302-315) —
        # per-shard vertex blocks, 1-cell halo for the normal stencil
        from .sharded_mesh import sharded_heightmap_mesh

        mesh_fields = sharded_heightmap_mesh(
            mesh, state.world.height, meta.tile_res, res,
            float(meta.height), float(meta.tile_size), layout=mesh_layout)
        return state, flow_v, mesh_fields
    return state, flow_v


def make_sharded_tile_step(mesh: Mesh, meta: TileSetMeta,
                           settings: ErosionSettings = None, **kwargs):
    """Build the jitted sharded flagship step: (xpos, zpos, key) → outputs —
    app.flagship.make_tile_step's sp counterpart.  The whole
    noise→blur→flow→cycles(→mesh) chain compiles to ONE XLA program over
    the mesh, so a deployment runs one dispatch per tile instead of
    per-op round trips.  ``kwargs`` pass through to sharded_tile_step."""
    settings = settings or ErosionSettings()

    @jax.jit
    def step(xpos, zpos, key):
        return sharded_tile_step(mesh, meta, settings, xpos, zpos, key,
                                 **kwargs)

    return step, meta, settings


class ShardedErosionSim(_ErosionSimBase):
    """ErosionSim's host-driver surface (erosion.sim.ErosionSim) for a
    spatially-sharded world, with all maps living sharded P('x','y') on
    the mesh.  The LiveErosion state machine (step/trigger/update), map
    views, curvature, and resets are INHERITED — only the cycle kernel
    (``_run_cycle``) and the persistence surface (extended save-alias set,
    re-sharding restore) differ."""

    def __init__(self, mesh: Mesh, height, settings: ErosionSettings = None,
                 meta: TileSetMeta = None, seed: int = 0, chunk: int = 8,
                 state_manager=None, tile_pos=(0, 0)):
        from ..erosion.sim import init_state
        from .device_mesh import field_sharding

        self.mesh = mesh
        self.chunk = chunk
        self.settings = settings or ErosionSettings()
        self.state_manager = state_manager
        self.tile_pos = tuple(tile_pos)
        res = int(height.shape[0])
        self.meta = meta or TileSetMeta(
            tile_res=res, tile_size=res, generator_res=res, height=1000,
            margin=0)
        # no super().__init__: it would run init_state on the unsharded
        # host array; shard FIRST so world-state creation lands P('x','y')
        sharded = jax.device_put(jnp.asarray(height, _F32),
                                 field_sharding(mesh))
        self.original_height = sharded
        # the key must start mesh-REPLICATED, matching the jitted cycle's
        # output sharding — a single-device committed PRNGKey would make
        # step 2 retrace the whole cycle program (one wasted compile per
        # sim); host-source it so the
        # device_put is legal on meshes spanning processes
        key = jax.device_put(np.asarray(jax.random.PRNGKey(seed)),
                             NamedSharding(mesh, P()))
        self.state = init_state(sharded, key)
        self.cycle_count = 0

    def _run_cycle(self):
        """Advance one sharded cycle — same static/traced split as the
        single-device driver: the compiled program is keyed on
        ``settings.canonical()`` and the tunable floats ride in traced, so
        live slider retunes between steps never recompile."""
        self.state = sharded_erosion_cycle(
            self.mesh, self.state, self.settings.canonical(), self.meta,
            chunk=self.chunk, tuned=self.settings.tunable_values())
        self.cycle_count += 1

    def mesh_fields(self, variant: str = "overshoot",
                    layout: str = "arrays"):
        """Per-vertex mesh channels for the current height map, sharded
        like the world (ErosionSim's mesher analog — LiveErosion.cs:302).
        ``layout="planes"`` emits the component-major MeshPlanes channels
        (see parallel.sharded_mesh.sharded_heightmap_mesh)."""
        from .sharded_mesh import sharded_heightmap_mesh

        return sharded_heightmap_mesh(
            self.mesh, self.state.world.height, self.meta.tile_res,
            self.meta.generator_res, float(self.meta.height),
            float(self.meta.tile_size), variant=variant, layout=layout)

    # --- persistence (SaveErosionState parity, LiveErosion.cs:111-116) ------

    # the reference saves height/stream/pool; the sharded production path
    # additionally persists track/plants/drain-queue so a resumed sim is
    # BIT-EXACT — the reference silently drops its in-flight drain queue
    # and track decay state on save/reload (documented extension)
    _SAVE_ALIASES = (
        ("TERRAIN_HEIGHT", ("world", "height")),
        ("PARTERO_WATERMAP_STREAM", ("world", "flow")),
        ("PARTERO_WATERMAP_POOL", ("world", "pool")),
        ("PARTERO_WATERMAP_TRACK", ("world", "track")),
        ("PARTERO_PLANTMAP", ("world", "plants")),
        ("PARTERO_DRAIN_QUEUE", ("drain_water",)),
    )

    def _buffer_name(self, alias: str) -> str:
        return self.meta.buffer_name(self.tile_pos, alias)

    def _state_arrays(self):
        for alias, path in self._SAVE_ALIASES:
            obj = self.state
            for attr in path:
                obj = getattr(obj, attr)
            yield alias, path, obj

    def _sharded_ckpt(self):
        from .sharded_checkpoint import ShardedCheckpoint

        sm = self.state_manager
        if sm is None or sm.serde is None:
            raise RuntimeError("no state manager with a save path attached")
        return ShardedCheckpoint(sm.serde.root)

    def save_erosion_state(self):
        """Checkpoint the full sim state through the state store + serde.

        Single-process, the store's serializer materializes to host (every
        shard addressable).  Multi-host, each process writes only ITS
        addressable blocks as per-shard files next to the store's save
        root (parallel.sharded_checkpoint) — no cross-host gather."""
        if self.state_manager is None:
            raise RuntimeError("no state manager attached")
        self.original_height = self.state.world.height
        if jax.process_count() > 1:
            ckpt = self._sharded_ckpt()
            for alias, _, arr in self._state_arrays():
                ckpt.save(self._buffer_name(alias), arr)
            ckpt.flush()
            return
        sm = self.state_manager
        for alias, _, arr in self._state_arrays():
            name = self._buffer_name(alias)
            sm.set_buffer(name, arr)
            sm.save_buffer_to_disk(name)

    def restore_erosion_state(self):
        """Rebuild the sim state from the store (restore-on-get pulls from
        disk when needed), re-sharding every map P('x','y') on the mesh —
        a sharded sim resumes bit-exact from a checkpoint (tested).  The
        PRNG key is NOT persisted (reference parity: the RNG stream
        restarts); set ``sim.state = replace(sim.state, key=...)`` for a
        deterministic continuation."""
        from ..erosion.sim import init_state
        from .device_mesh import field_sharding

        if self.state_manager is None:
            raise RuntimeError("no state manager attached")
        sm = self.state_manager
        sh = field_sharding(self.mesh)
        if jax.process_count() > 1:
            ckpt = self._sharded_ckpt()
            maps = {alias: ckpt.load(self._buffer_name(alias), sh)
                    for alias, _ in self._SAVE_ALIASES}
            missing = [a for a, v in maps.items() if v is None]
            if missing:
                raise IOError(f"sharded checkpoint missing maps: {missing}")
        else:
            maps = {
                alias: jax.device_put(
                    jnp.asarray(sm.get_buffer(self._buffer_name(alias)),
                                _F32), sh)
                for alias, _ in self._SAVE_ALIASES
            }
        self.original_height = maps["TERRAIN_HEIGHT"]
        self.state = init_state(self.original_height, self.state.key)
        self.state = replace(
            self.state,
            world=replace(self.state.world,
                          flow=maps["PARTERO_WATERMAP_STREAM"],
                          pool=maps["PARTERO_WATERMAP_POOL"],
                          track=maps["PARTERO_WATERMAP_TRACK"],
                          plants=maps["PARTERO_PLANTMAP"]),
            drain_water=maps["PARTERO_DRAIN_QUEUE"],
        )
