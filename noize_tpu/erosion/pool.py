"""Pool automata — cellular standing-water spread with drain detection.

Reference: ``PoolAutomataJob`` (/root/reference/Geologic/ParticleErosion/
MultiThreadErosionJob.cs:264-327) and ``WorldTile.SpreadPool``
(LiveErosionDataTypes.cs:938-1010).

The reference runs WATER_STEPS iterations x 4 offset phases; each phase
visits cells on a diagonal-checkerboard lattice (x parity alternates per
row — MultiThreadErosionJob.cs:277-283) and, per flooded cell, walks its 4
neighbors in ascending (height+pool) order: a neighbor that is dry and not
higher than the cell's *land* is a drain (all water leaves — either
committed to the neighbor or re-emitted as a drain particle); otherwise up
to 25% of the head difference equalizes in/out.

Design: the whole grid computes each phase under the lattice mask;
within a cell the 4 sorted sub-steps run as a vectorized sequential chain
(exactly the reference's per-cell serial order); cross-cell neighbor
deltas accumulate via shifted adds and apply at phase end.  The reference
commits neighbor writes immediately from concurrent worker threads with
safety checks disabled (races accepted); phase-end application is the
deterministic version of the same scheme — divergence noted.

Sort-order note: FloodedNeighbor sorts by ``current.GetHashCode()``
(LiveErosionDataTypes.cs:1035-1042) — for the non-negative floats involved,
IEEE bit patterns order identically to values, so this is an ascending sort
by height+pool; ties resolve by neighbor enumeration order here (the
reference's unstable sort leaves ties unspecified).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..ops.flow import shift_clamped
from .world import WorldState

_F32 = jnp.float32

#: Per-cell activity gate — reference parity: SpreadPool skips every
#: sub-step while ``hWater < 1E-3f`` (LiveErosionDataTypes.cs:972), so a
#: cell below this much water makes no transfers and cannot drain.
#: Consequence (used by the call-level skip gates here and in
#: erosion.sim._gated_pool): a grid where NO cell reaches this gate is a bit-exact
#: FIXED POINT of the automata — every ``can`` is false, every transfer
#: and drain is exactly 0, the pool is unchanged, and by induction every
#: later phase is a no-op too.  Particle pool deposits are
#: ``water/height_scale * POOL_PLACEMENT_MULTIPLIER`` ≈ 5e-4, so
#: cold-start pipelines stay below the gate until deposits pile up —
#: whole pool calls then skip for the cost of one reduction (the
#: reference instead scans all cells every phase, MultiThreadErosionJob
#: .cs:277-287).
MIN_WATER = 1e-3

# neighbor order in SpreadPool: up, right, down, left (as (d_row, d_col))
_DIRS = ((1, 0), (0, 1), (-1, 0), (0, -1))


def _phase_mask(res: int, xoff: int, zoff: int):
    """Active lattice for one phase (MultiThreadErosionJob.cs:275-287):
    rows z = 2·j + zoff; columns x ≡ xoff + (j mod 2) (mod 2)."""
    rows = jnp.arange(res)
    cols = jnp.arange(res)
    j = (rows - zoff) // 2
    row_active = (rows % 2) == (zoff % 2)
    col_parity = (xoff + j) % 2
    m = (cols[None, :] % 2) == col_parity[:, None]
    return m & row_active[:, None]


def _phase_mask_from_coords(grow, gcol, xoff: int, zoff: int):
    """Same lattice from (possibly shifted) global coordinate grids —
    used by halo-extended (sharded) windows."""
    j = (grow - zoff) // 2
    row_active = (grow % 2) == (zoff % 2)
    col_parity = (xoff + j) % 2
    return ((gcol % 2) == col_parity) & row_active


def _border_maps(shape, grow=None, gcol=None, res: int = None):
    """Bool maps marking cells on the GLOBAL border in each direction
    (g + d out of grid → SafeIdx self-aliasing).  Local path: coords are
    local indices."""
    if grow is None:
        grow = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        gcol = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        res_r = res_c = shape[0]
    else:
        res_r = res_c = res
    return {
        (1, 0): grow == res_r - 1,
        (-1, 0): grow == 0,
        (0, 1): gcol == res_c - 1,
        (0, -1): gcol == 0,
    }


def _spread_phase(height, pool, mask, drain_particles: bool, border=None):
    """One phase over the whole grid (masked).  Returns (new_pool,
    drain_map) where drain_map holds water volumes dropped at drain cells
    (to be re-emitted as particles when drain_particles is True).

    ``border``: global-border maps from _border_maps; None → the array IS
    the whole grid."""
    res = height.shape[0]
    if border is None:
        border = _border_maps(height.shape)

    # gather neighbor land/water (phase-start snapshot)
    n_height = [shift_clamped(height, dr, dc) for (dr, dc) in _DIRS]
    n_water = [shift_clamped(pool, dr, dc) for (dr, dc) in _DIRS]
    # Ascending rank of the 4 neighbors per cell by (current, direction) via
    # pairwise comparisons — no argsort / take_along_axis gathers, so the
    # phase stays one elementwise fusion.  See _phase_core.
    new_pool, deltas, drain_out = _phase_core(
        n_height, n_water, height, pool, mask, drain_particles
    )

    # Scatter the per-direction outflows onto the targets.  A giver g's
    # target is clamp(g + d): interior givers feed the true neighbor
    # (zero-fill reverse shift); border givers whose neighbor clamps onto
    # themselves (SafeIdx aliasing) get their own transfer back.
    drain_map = jnp.zeros_like(pool)
    for d, (dr, dc) in enumerate(_DIRS):
        new_pool = _scatter_dir(new_pool, deltas[d], dr, dc, border[(dr, dc)])
        if drain_particles:
            drain_map = _scatter_dir(drain_map, drain_out[d], dr, dc,
                                     border[(dr, dc)])
    return new_pool, drain_map


def _shift_zero(a, dz: int, dc: int):
    """out[r] = a[r + (dz, dc)] with zeros outside.  Concatenated slices,
    not jnp.pad (see ops.flow.shift_clamped)."""
    out = a
    if dz > 0:
        z = jnp.zeros((dz,) + out.shape[1:], out.dtype)
        out = jnp.concatenate([out[dz:, :], z], axis=0)
    elif dz < 0:
        z = jnp.zeros((-dz,) + out.shape[1:], out.dtype)
        out = jnp.concatenate([z, out[:dz, :]], axis=0)
    if dc > 0:
        z = jnp.zeros(out.shape[:1] + (dc,), out.dtype)
        out = jnp.concatenate([out[:, dc:], z], axis=1)
    elif dc < 0:
        z = jnp.zeros(out.shape[:1] + (-dc,), out.dtype)
        out = jnp.concatenate([z, out[:, :dc]], axis=1)
    return out


def _scatter_dir(acc, delta, dr: int, dc: int, border_map):
    """Add ``delta`` (giver-indexed transfers toward direction (dr, dc))
    onto the accumulator at the clamped target cells.  ``border_map`` marks
    givers whose target clamps onto themselves (global border)."""
    acc = acc + _shift_zero(delta, -dr, -dc)
    return acc + jnp.where(border_map, delta, 0.0)


def _halfrow_views(full, zoff: int):
    """Split (R, R) into active rows [zoff::2] and complementary rows via a
    dense reshape-slice (no sublane-strided memory ops)."""
    r = full.shape[0]
    x = full.reshape(r // 2, 2, r)
    return x[:, zoff, :], x[:, 1 - zoff, :]


def _halfrow_join(active, comp, zoff: int):
    r2, r = active.shape
    pair = (active, comp) if zoff == 0 else (comp, active)
    return jnp.stack(pair, axis=1).reshape(2 * r2, r)


def _spread_phase_halfrow(height, pool, xoff: int, zoff: int,
                          drain_particles: bool):
    """_spread_phase restricted to the phase's active rows (split/join at
    the boundary — used for testing; pool_automata threads the row pair
    through all phases instead, see _phase_pair)."""
    a_h, c_h = _halfrow_views(height, zoff)
    a_p, c_p = _halfrow_views(pool, zoff)
    new_a, new_c, da, dc = _phase_pair(
        a_h, c_h, a_p, c_p, xoff, zoff, drain_particles, height.shape[0]
    )
    new_pool = _halfrow_join(new_a, new_c, zoff)
    drain_map = _halfrow_join(da, dc, zoff)
    return new_pool, drain_map


def _phase_core(n_height, n_water, h_land, pool_snapshot, geo_mask,
                drain_particles: bool, hl_ge_nh=None):
    """The per-cell phase body shared by the pair/quad/full-grid layouts:
    rank the 4 neighbors by ascending (height+pool, direction), then run
    the 4 sequential rank-ordered sub-steps (SpreadPool's per-cell serial
    order, LiveErosionDataTypes.cs:938-1010).  Pure elementwise —
    layout-agnostic.

    ``geo_mask``: the phase's GEOMETRIC lattice mask (in-bounds active
    lattice cells); the per-cell water threshold is applied internally, so
    callers must NOT pre-and a ``pool > 0`` term (cells below threshold
    never move water either way, making the geometric mask sufficient).

    ``hl_ge_nh``: optional phase-invariant precompute of
    ``[h_land >= n_height[d]]`` — heights never change across the phases
    of a pool call, so launch/scan-level callers hoist these four compares
    (and the n_height shifts) out of the per-phase body.

    Returns (new_water, deltas[4], drain_out[4]): new_water is the cell's
    own post-sub-step water for ALL cells (inactive cells pass their
    snapshot through); deltas/drain_out are giver-indexed per-direction
    transfer volumes.

    Op-count notes (this core is the pool automata's inner loop): vs the
    earlier 4-field sorting-network form,
    this (a) ranks with 6 pairwise compares where ties resolve statically
    (for d < d', "d before d'" ⟺ key_d <= key_d'), (b) folds the
    give/take branches into one clamp — for non-drain cells the transfer
    is exactly clip(0.25·diff, -0.25·bw, 0.25·h_water), bit-equal to the
    branched form for non-negative water, and (c) routes per-direction
    outputs once after the sub-steps (each direction is visited exactly
    once, and a drain empties the cell so at most one drain fires per
    phase)."""
    if hl_ge_nh is None:
        hl_ge_nh = [h_land >= n_height[d] for d in range(4)]
    keys = [n_height[d] + n_water[d] for d in range(4)]
    # dry-drain eligibility per direction (reference: neighbor dry AND not
    # above the cell's land — LiveErosionDataTypes.cs:973-979)
    elig = [(n_water[d] <= 0.0) & hl_ge_nh[d] for d in range(4)]

    # rank_d = sub-step at which direction d is visited (ascending key,
    # ties in direction-enumeration order — matching the reference's
    # FloodedNeighbor sort with deterministic tie handling).  Computed in
    # f32: the values are exact small integers either way, and f32
    # select/add avoids an i32 cast per compare.
    one = jnp.float32(1.0)
    zero = jnp.float32(0.0)
    a01 = jnp.where(keys[0] <= keys[1], one, zero)
    a02 = jnp.where(keys[0] <= keys[2], one, zero)
    a03 = jnp.where(keys[0] <= keys[3], one, zero)
    a12 = jnp.where(keys[1] <= keys[2], one, zero)
    a13 = jnp.where(keys[1] <= keys[3], one, zero)
    a23 = jnp.where(keys[2] <= keys[3], one, zero)
    rank = [
        3.0 - a01 - a02 - a03,
        2.0 + a01 - a12 - a13,
        1.0 + a02 + a12 - a23,
        a03 + a13 + a23,
    ]
    # hits[d][e]: direction d is visited at sub-step e (a permutation —
    # exactly one d per e and one e per d); shared by the sub-step field
    # selection and the output demux
    hits = [[rank[d] == float(e) for e in range(4)] for d in range(4)]

    def pick(e, fields):
        """Select fields of the direction ranked ``e`` (nested where; the
        last direction is the else branch of the permutation)."""
        return tuple(
            jnp.where(hits[0][e], f[0],
                      jnp.where(hits[1][e], f[1],
                                jnp.where(hits[2][e], f[2], f[3])))
            for f in fields
        )

    def pick_bool(e, f):
        """Bool-field variant of pick: masked or-reduction over the
        permutation."""
        return ((hits[0][e] & f[0]) | (hits[1][e] & f[1])
                | (hits[2][e] & f[2]) | (hits[3][e] & f[3]))

    h_water = pool_snapshot
    t_height = h_land + h_water
    moved_s = []
    drain_s = []
    for e in range(4):
        key_e, bw_e = pick(e, (keys, n_water))
        elig_e = pick_bool(e, elig)
        diff_v = t_height - key_e
        can = geo_mask & (h_water >= MIN_WATER)
        # non-drain transfer: clip(0.25·diff, -0.25·bw, 0.25·h_water)
        # (positive = give to the neighbor, negative = take from it).
        # ``elig_e`` needs no can-gate: moved is can-gated below, so
        # ineligible-masked cells contribute exactly 0 to every output
        # either way (the drain demux is a per-direction select of
        # can-gated volumes, not a sum).
        clipv = jnp.minimum(
            jnp.maximum(0.25 * diff_v, -0.25 * bw_e), 0.25 * h_water
        )
        moved = jnp.where(can, jnp.where(elig_e, h_water, clipv), 0.0)
        h_water = h_water - moved
        t_height = h_land + h_water
        moved_s.append(moved)
        drain_s.append(elig_e)

    def demux(vals):
        """Route the per-sub-step volumes back to per-direction outputs."""
        return [
            jnp.where(hits[d][0], vals[0],
                      jnp.where(hits[d][1], vals[1],
                                jnp.where(hits[d][2], vals[2], vals[3])))
            for d in range(4)
        ]

    all_d = demux(moved_s)
    if drain_particles:
        # Split the drain volume off AFTER one combined demux (one demux
        # instead of two).  A drain empties the cell
        # (h_water − h_water = exactly 0 < the 1e-3 gate) and ``can`` is
        # monotone non-increasing across sub-steps (gives can only push
        # h_water below the gate, takes raise it but require can), so a
        # real drain — when one exists — fires at the FIRST eligible
        # sub-step and at most once.  Route that single cell-wide volume
        # by sub-step index and subtract it back out of the non-drain
        # deltas (x − x = +0 and x − (+0) = x exactly, so this matches
        # the two-demux form bit-for-bit; eligible-but-gated sub-steps
        # contribute exactly ±0 either way).
        drain_amt = jnp.where(drain_s[0], moved_s[0], 0.0)
        for e in range(1, 4):
            drain_amt = drain_amt + jnp.where(drain_s[e], moved_s[e], 0.0)
        f32c = jnp.float32
        drain_e = jnp.where(
            drain_s[0], f32c(0.0),
            jnp.where(drain_s[1], f32c(1.0),
                      jnp.where(drain_s[2], f32c(2.0),
                                jnp.where(drain_s[3], f32c(3.0),
                                          f32c(-1.0)))))
        drain_out = [
            jnp.where(rank[d] == drain_e, drain_amt, 0.0) for d in range(4)
        ]
        deltas = [all_d[d] - drain_out[d] for d in range(4)]
    else:
        deltas = all_d
        drain_out = [jnp.zeros_like(pool_snapshot) for _ in range(4)]
    return h_water, deltas, drain_out


def _pair_iotas(shape):
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    col = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    return j, col


def _pair_geo_mask(shape, xoff: int):
    """Geometric lattice mask for one phase on the pair layout: column
    parity per lattice row j.  Depends on ``xoff`` ONLY — both zoff
    orientations of a phase share the same mask, so callers hoist one mask
    per xoff."""
    j, col = _pair_iotas(shape)
    return (col % 2) == ((xoff + j) % 2)


def _shift_down_row(x):  # out[k] = x[k-1]; row 0 value unused (where'd out)
    return jnp.concatenate([x[:1], x[:-1]], 0)


def _shift_up_row(x):    # out[k] = x[k+1]; last row unused
    return jnp.concatenate([x[1:], x[-1:]], 0)


def _pair_pre(a_h, c_h, zoff: int, res: int):
    """Phase-invariant precompute for _phase_pair: the four neighbor-height
    maps and the ``h_land >= n_height`` drain-eligibility compares.
    Heights never change during pool automata, so callers compute this
    ONCE per pool call per lattice orientation instead of once per
    phase."""
    r2 = res // 2
    j, _ = _pair_iotas(a_h.shape)
    if zoff == 0:
        up_h = c_h                                               # z+1 = C[j]
        down_h = jnp.where(j == 0, a_h, _shift_down_row(c_h))    # z-1; j=0 self
    else:
        up_h = jnp.where(j == r2 - 1, a_h, _shift_up_row(c_h))   # z+1; last self
        down_h = c_h                                             # z-1 = C[j]
    n_height = [up_h, shift_clamped(a_h, 0, 1), down_h,
                shift_clamped(a_h, 0, -1)]
    hl_ge_nh = [a_h >= n_height[d] for d in range(4)]
    return {"n_height": n_height, "hl_ge_nh": hl_ge_nh}


def _phase_pair(a_h, c_h, a_p, c_p, xoff: int, zoff: int,
                drain_particles: bool, res: int, pre=None, geo_mask=None):
    """One phase on the (active, complement) row-lattice pair.

    ``a_*`` are the ACTIVE rows for this phase (z ≡ zoff mod 2), ``c_*``
    the complementary rows.  Returns (new_active_pool, new_comp_pool,
    drain_active, drain_comp) — no full-grid join, so consecutive phases
    chain without reshape churn (composing split→join per phase made XLA's
    simplifier blow up compile time).

    ``pre`` / ``geo_mask``: hoisted _pair_pre / _pair_geo_mask results
    (phase-invariant; recomputed here when not supplied)."""
    r2 = res // 2
    j, col = _pair_iotas(a_p.shape)
    if geo_mask is None:
        geo_mask = _pair_geo_mask(a_p.shape, xoff)
    if pre is None:
        pre = _pair_pre(a_h, c_h, zoff, res)

    # vertical water neighbors from the complementary lattice (clamped at
    # the global border by substituting the active row itself — SafeIdx
    # alias); waters change every phase so these are NOT hoistable
    if zoff == 0:
        up_p = c_p                                               # z+1 = C[j]
        down_p = jnp.where(j == 0, a_p, _shift_down_row(c_p))    # z-1; j=0 self
    else:
        up_p = jnp.where(j == r2 - 1, a_p, _shift_up_row(c_p))   # z+1; last self
        down_p = c_p                                             # z-1 = C[j]

    n_water = [up_p, shift_clamped(a_p, 0, 1), down_p, shift_clamped(a_p, 0, -1)]

    h_water, deltas, drain_out = _phase_core(
        pre["n_height"], n_water, a_h, a_p, geo_mask, drain_particles,
        hl_ge_nh=pre["hl_ge_nh"],
    )

    # global-border self-return bands on the lattice
    border_up = ((zoff == 1) & (j == r2 - 1))
    border_down = ((zoff == 0) & (j == 0))
    border_right = col == res - 1
    border_left = col == 0

    def scatter(a_acc, c_acc, dl):
        # left/right stay on the active lattice
        a_acc = a_acc + _shift_zero(dl[1], 0, -1) + jnp.where(border_right, dl[1], 0.0)
        a_acc = a_acc + _shift_zero(dl[3], 0, 1) + jnp.where(border_left, dl[3], 0.0)
        # up (d=0): zoff=0 → C[j]; zoff=1 → C[j+1] (+ border self-return)
        if zoff == 0:
            c_acc = c_acc + dl[0]
        else:
            c_acc = c_acc + _shift_zero(dl[0], -1, 0)
            a_acc = a_acc + jnp.where(border_up, dl[0], 0.0)
        # down (d=2): zoff=0 → C[j-1] (+ border); zoff=1 → C[j]
        if zoff == 0:
            c_acc = c_acc + _shift_zero(dl[2], 1, 0)
            a_acc = a_acc + jnp.where(border_down, dl[2], 0.0)
        else:
            c_acc = c_acc + dl[2]
        return a_acc, c_acc

    new_a, new_c = scatter(h_water, c_p, deltas)
    if drain_particles:
        da, dc = scatter(jnp.zeros_like(a_p), jnp.zeros_like(c_p), drain_out)
    else:
        da = jnp.zeros_like(a_p)
        dc = jnp.zeros_like(c_p)
    return new_a, new_c, da, dc


# --- quadrant (diagonal) lattice layout -------------------------------------
#
# A phase's active cells satisfy (c − j) mod 2 == xoff on its half-row
# lattice (cols x ≡ xoff + j (mod 2) ⟺ (x − j) ≡ xoff (mod 2)) — a
# *diagonal* sub-lattice selected purely by xoff.  Packing each half-row
# lattice into its two diagonal quadrants makes every phase dense: the
# sorting network and sub-steps run on res²/4 cells instead of res²/2.
# Neighbor geometry in quadrant space (derived from c = 2k + ((j+p) mod 2)):
#   up/down  → complement-ROW-lattice quads, pure row shifts (k unchanged)
#   left/right → the sibling (other-diagonal) quad of the SAME lattice,
#                direct or column-shifted depending on row parity u=(j+p)%2
# All dense reshapes/shifts — no gathers, no stride-2 lane writes.


def _quad_views(a, p: int):
    """Diagonal quadrant p of a half-row lattice: Q[j, k] = a[j, 2k+((j+p)%2)].
    Dense reshape-slice-stack (size-2 minor axes only)."""
    r2, r = a.shape
    x = a.reshape(r2 // 2, 2, r // 2, 2)
    even_rows = x[:, 0, :, p]        # rows 2J: col offset p
    odd_rows = x[:, 1, :, 1 - p]     # rows 2J+1: col offset 1-p
    return jnp.stack([even_rows, odd_rows], axis=1).reshape(r2, r // 2)


def _quad_join(d0, d1):
    """Inverse of (_quad_views(a,0), _quad_views(a,1))."""
    r2, q = d0.shape
    d0r = d0.reshape(r2 // 2, 2, q)
    d1r = d1.reshape(r2 // 2, 2, q)
    even = jnp.stack([d0r[:, 0], d1r[:, 0]], axis=-1)   # rows 2J: b=0→D0, b=1→D1
    odd = jnp.stack([d1r[:, 1], d0r[:, 1]], axis=-1)    # rows 2J+1: b=0→D1, b=1→D0
    return jnp.stack([even, odd], axis=1).reshape(r2, 2 * q)


def _rshift_col(x):
    """out[:, k] = x[:, k-1] (col 0 clamped; used only where masked off)."""
    return jnp.concatenate([x[:, :1], x[:, :-1]], axis=1)


def _lshift_col(x):
    """out[:, k] = x[:, k+1] (last col clamped)."""
    return jnp.concatenate([x[:, 1:], x[:, -1:]], axis=1)


def _phase_quad(h_act, h_side, h_c_p, h_c_q,
                p_act, p_side, p_c_p, p_c_q,
                xoff: int, zoff: int, drain_particles: bool, res: int):
    """One phase in quadrant space.

    ``*_act``: the active quad (lattice zoff, diagonal parity p=xoff);
    ``*_side``: the sibling quad (same lattice, parity p^1) — left/right
    neighbor source and target; ``*_c_p`` / ``*_c_q``: complement-lattice
    quads with parity p / p^1 — up/down sources and targets.

    Returns (new_p_act, new_p_side, new_p_c_p, new_p_c_q,
             d_act, d_side, d_c_p, d_c_q) — the last four are THIS phase's
    drain contributions (zero-based), added by the caller."""
    r2 = res // 2
    q = res // 2

    j = jax.lax.broadcasted_iota(jnp.int32, p_act.shape, 0)
    k = jax.lax.broadcasted_iota(jnp.int32, p_act.shape, 1)
    u = (j + xoff) % 2          # global col c = 2k + u
    u0 = u == 0
    u1 = u == 1
    every_cell = jnp.ones(p_act.shape, bool)  # every quad cell is active

    def shift_down_row(x):   # out[j] = x[j-1]; row 0 clamped (masked off)
        return jnp.concatenate([x[:1], x[:-1]], 0)

    def shift_up_row(x):     # out[j] = x[j+1]; last row clamped
        return jnp.concatenate([x[1:], x[-1:]], 0)

    # --- neighbor assembly (phase-start snapshots) ---------------------------
    # d=0 up (z+1), d=1 right (x+1), d=2 down (z-1), d=3 left (x-1)
    if zoff == 0:
        n0_h, n0_w = h_c_p, p_c_p                      # C[j], parity p
        b0 = None                                       # z+1 ≤ res-1 always
        n2_h = shift_down_row(h_c_q)                    # C[j-1], parity p^1
        n2_w = shift_down_row(p_c_q)
        b2 = j == 0                                     # z-1 < 0 → self-alias
    else:
        n0_h = shift_up_row(h_c_q)                      # C[j+1], parity p^1
        n0_w = shift_up_row(p_c_q)
        b0 = j == r2 - 1                                # z+1 > res-1
        n2_h, n2_w = h_c_p, p_c_p                       # C[j], parity p
        b2 = None                                       # z-1 ≥ 1 always

    n1_h = jnp.where(u0, h_side, _lshift_col(h_side))   # right: k or k+1
    n1_w = jnp.where(u0, p_side, _lshift_col(p_side))
    b1 = u1 & (k == q - 1)                              # c+1 = res
    n3_h = jnp.where(u1, h_side, _rshift_col(h_side))   # left: k or k-1
    n3_w = jnp.where(u1, p_side, _rshift_col(p_side))
    b3 = u0 & (k == 0)                                  # c-1 < 0

    def alias(nh, nw, border):
        if border is None:
            return nh, nw
        return jnp.where(border, h_act, nh), jnp.where(border, p_act, nw)

    n0_h, n0_w = alias(n0_h, n0_w, b0)
    n1_h, n1_w = alias(n1_h, n1_w, b1)
    n2_h, n2_w = alias(n2_h, n2_w, b2)
    n3_h, n3_w = alias(n3_h, n3_w, b3)

    h_water, deltas, drain_out = _phase_core(
        [n0_h, n1_h, n2_h, n3_h], [n0_w, n1_w, n2_w, n3_w],
        h_act, p_act, every_cell, drain_particles,
    )

    # --- scatter (per-cell add order mirrors _phase_pair's) -----------------
    def scatter(base_act, base_side, base_cp, base_cq, dl):
        acc_act, acc_side, acc_cp, acc_cq = base_act, base_side, base_cp, base_cq
        # right (d=1): u0 rows → same k; u1 rows → k+1 (self-return at c=res-1)
        acc_side = acc_side + (
            jnp.where(u0, dl[1], 0.0)
            + _shift_zero(jnp.where(u1 & ~b1, dl[1], 0.0), 0, -1)
        )
        acc_act = acc_act + jnp.where(b1, dl[1], 0.0)
        # left (d=3): u1 rows → same k; u0 rows → k-1 (self-return at c=0)
        acc_side = acc_side + (
            jnp.where(u1, dl[3], 0.0)
            + _shift_zero(jnp.where(u0 & ~b3, dl[3], 0.0), 0, 1)
        )
        acc_act = acc_act + jnp.where(b3, dl[3], 0.0)
        if zoff == 0:
            acc_cp = acc_cp + dl[0]                               # up → C_p[j]
            acc_cq = acc_cq + _shift_zero(jnp.where(~b2, dl[2], 0.0), 1, 0)
            acc_act = acc_act + jnp.where(b2, dl[2], 0.0)         # j=0 self
        else:
            acc_cq = acc_cq + _shift_zero(jnp.where(~b0, dl[0], 0.0), -1, 0)
            acc_act = acc_act + jnp.where(b0, dl[0], 0.0)         # j=r2-1 self
            acc_cp = acc_cp + dl[2]                               # down → C_p[j]
        return acc_act, acc_side, acc_cp, acc_cq

    new_act, new_side, new_cp, new_cq = scatter(
        h_water, p_side, p_c_p, p_c_q, deltas
    )
    if drain_particles:
        z = jnp.zeros_like(p_act)
        d_act, d_side, d_cp, d_cq = scatter(z, z, z, z, drain_out)
    else:
        z = jnp.zeros_like(p_act)
        d_act = d_side = d_cp = d_cq = z
    return new_act, new_side, new_cp, new_cq, d_act, d_side, d_cp, d_cq


# phase order (xoff, zoff) nesting parity with MultiThreadErosionJob.cs:314-324
_PHASE_ORDER = tuple((xo, zo) for xo in (0, 1) for zo in (0, 1))


def _quad_phase_step(h_quads, p_quads, xoff: int, zoff: int,
                     drain_particles: bool, res: int):
    """Apply one phase to the quad dict {(lat, parity): array} where lat is
    0 (even global rows) or 1 (odd).  Returns (new_p_quads, drain_quads)."""
    A, C = (0, 1) if zoff == 0 else (1, 0)
    p = xoff
    args = (
        h_quads[(A, p)], h_quads[(A, 1 - p)],
        h_quads[(C, p)], h_quads[(C, 1 - p)],
        p_quads[(A, p)], p_quads[(A, 1 - p)],
        p_quads[(C, p)], p_quads[(C, 1 - p)],
    )
    na, ns, ncp, ncq, da, ds, dcp, dcq = _phase_quad(
        *args, xoff, zoff, drain_particles, res
    )
    new_p = {(A, p): na, (A, 1 - p): ns, (C, p): ncp, (C, 1 - p): ncq}
    drains = {(A, p): da, (A, 1 - p): ds, (C, p): dcp, (C, 1 - p): dcq}
    return new_p, drains


def _pack_quads(full):
    """(R, R) map → quad dict {(lat, parity): (R/2, R/2)}."""
    e, o = _halfrow_views(full, 0)
    return {
        (0, 0): _quad_views(e, 0), (0, 1): _quad_views(e, 1),
        (1, 0): _quad_views(o, 0), (1, 1): _quad_views(o, 1),
    }


def _unpack_quads(quads):
    e = _quad_join(quads[(0, 0)], quads[(0, 1)])
    o = _quad_join(quads[(1, 0)], quads[(1, 1)])
    return _halfrow_join(e, o, 0)


_QKEYS = ((0, 0), (0, 1), (1, 0), (1, 1))


@partial(jax.jit, static_argnames=("iterations", "drain_particles"))
def pool_automata_quad(height, pool, iterations: int = 10,
                       drain_particles: bool = True):
    """pool_automata on the diagonal-quadrant layout.  Bit-exact with
    pool_automata — same _phase_core ops, same per-cell add order."""
    res = height.shape[0]
    h_quads = _pack_quads(height)
    p_quads = _pack_quads(pool)
    d_quads = {kk: jnp.zeros_like(v) for kk, v in p_quads.items()}

    def make_branch(xo, zo):
        def br(c):
            p_quads = dict(zip(_QKEYS, c[:4]))
            d_quads = dict(zip(_QKEYS, c[4:]))
            new_p, dr = _quad_phase_step(
                h_quads, p_quads, xo, zo, drain_particles, res
            )
            new_d = {kk: d_quads[kk] + dr[kk] for kk in _QKEYS}
            return tuple(new_p[kk] for kk in _QKEYS) + tuple(
                new_d[kk] for kk in _QKEYS
            )
        return br

    branches = [make_branch(xo, zo) for xo, zo in _PHASE_ORDER]

    def step(carry, t):
        has_water = jnp.any(
            jnp.stack([jnp.any(carry[i] > 0.0) for i in range(4)])
        )
        out = jax.lax.cond(
            has_water,
            lambda c: jax.lax.switch(t % 4, branches, c),
            lambda c: c,
            carry,
        )
        return out, None

    init = tuple(p_quads[kk] for kk in _QKEYS) + tuple(
        d_quads[kk] for kk in _QKEYS
    )
    out, _ = jax.lax.scan(
        step, init, jnp.arange(4 * iterations, dtype=jnp.int32)
    )
    pool_out = _unpack_quads(dict(zip(_QKEYS, out[:4])))
    drain_out = _unpack_quads(dict(zip(_QKEYS, out[4:])))
    return pool_out, drain_out


@partial(jax.jit, static_argnames=("iterations", "drain_particles"))
def pool_automata(height, pool, iterations: int = 10, drain_particles: bool = True):
    """PoolAutomataJob.Schedule parity: iterations × 4 phases
    (xoff, zoff) ∈ {0,1}² in that nesting order (MultiThreadErosionJob.cs:
    314-324).  Returns (pool, drain_map) — drain_map accumulates water
    volumes at drain sites across all phases for particle re-emission."""
    res = height.shape[0]
    if res % 2:
        # odd grids can't split into even/odd row lattices — use the
        # full-grid masked phases (reference grids are even-sized)
        return _pool_automata_fullgrid(height, pool, iterations, drain_particles)
    # split rows once; phases alternate which lattice is active, threading
    # the (even, odd) pair end-to-end (join only at the very end)
    h_even, h_odd = _halfrow_views(height, 0)
    p_even, p_odd = _halfrow_views(pool, 0)
    d_even = jnp.zeros_like(p_even)
    d_odd = jnp.zeros_like(p_odd)

    # phase-invariant hoists: heights never change across the scan, so the
    # neighbor-height maps / drain-eligibility compares / lattice masks are
    # computed once here and closed over by the branches
    pre_z = (_pair_pre(h_even, h_odd, 0, res),
             _pair_pre(h_odd, h_even, 1, res))
    masks = {xo: _pair_geo_mask(p_even.shape, xo) for xo in (0, 1)}

    # One phase per scan step, selected by lax.switch: XLA's optimizer cost
    # grows super-linearly when several phases are unrolled into one body
    # (the 4-phase body took minutes to compile on CPU; four 1-phase
    # branches compile in seconds).  Phase order (xoff, zoff) nesting parity
    # with MultiThreadErosionJob.cs:314-324.
    def make_branch(xoff, zoff):
        if zoff == 0:
            def br(c):
                p_even, p_odd, d_even, d_odd = c
                p_even, p_odd, da, dc = _phase_pair(
                    h_even, h_odd, p_even, p_odd, xoff, 0,
                    drain_particles, res,
                    pre=pre_z[0], geo_mask=masks[xoff])
                return (p_even, p_odd, d_even + da, d_odd + dc)
        else:
            def br(c):
                p_even, p_odd, d_even, d_odd = c
                p_odd, p_even, da, dc = _phase_pair(
                    h_odd, h_even, p_odd, p_even, xoff, 1,
                    drain_particles, res,
                    pre=pre_z[1], geo_mask=masks[xoff])
                return (p_even, p_odd, d_even + dc, d_odd + da)
        return br

    branches = [make_branch(xo, zo) for xo in (0, 1) for zo in (0, 1)]

    def step(carry, t):
        # coarse form of the reference's per-cell activity gate: a grid
        # with no cell at/above MIN_WATER is a bit-exact fixed point (see
        # the MIN_WATER note), so the phase body is skipped entirely
        has_water = (jnp.any(carry[0] >= MIN_WATER)
                     | jnp.any(carry[1] >= MIN_WATER))
        out = jax.lax.cond(
            has_water,
            lambda c: jax.lax.switch(t % 4, branches, c),
            lambda c: c,
            carry,
        )
        return out, None

    (p_even, p_odd, d_even, d_odd), _ = jax.lax.scan(
        step, (p_even, p_odd, d_even, d_odd),
        jnp.arange(4 * iterations, dtype=jnp.int32),
    )
    return (
        _halfrow_join(p_even, p_odd, 0),
        _halfrow_join(d_even, d_odd, 0),
    )


def _pool_automata_fullgrid(height, pool, iterations: int,
                            drain_particles: bool):
    """Full-grid masked fallback (odd resolutions); one phase per scan step
    via lax.switch, same compile-cost reasoning as the half-row path."""
    res = height.shape[0]
    masks = [_phase_mask(res, xo, zo) for xo in (0, 1) for zo in (0, 1)]

    def make_branch(i):
        def br(c):
            pool, drains = c
            p2, dm = _spread_phase(height, pool, masks[i], drain_particles)
            return (p2, drains + dm)
        return br

    branches = [make_branch(i) for i in range(4)]

    def step(carry, t):
        return jax.lax.switch(t % 4, branches, carry), None

    (pool, drains), _ = jax.lax.scan(
        step, (pool, jnp.zeros_like(pool)),
        jnp.arange(4 * iterations, dtype=jnp.int32),
    )
    return pool, drains
