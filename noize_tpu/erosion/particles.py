"""Beyer droplet particles — vectorized simultaneous descent.

Reference: ``BeyerParticle.DescendSimultaneous``
(/root/reference/Geologic/ParticleErosion/LiveErosionDataTypes.cs:205-434),
``NeighborhoodHelper`` (:130-203), ``Heading`` compass (:1294-1443), driven
by ``FlowMaster.BeyerSimultaneousDescentSingle`` / the job set in
``MultiThreadErosionJob.cs``.

Design (SURVEY.md §7.5): the reference runs one worker thread per
particle with a per-particle ``while !dead`` loop, each step appending an
``ErosiveEvent`` into a parallel multimap that a later job reduces per cell.
Here all N particles advance together through a ``lax.scan`` over MAXAGE
steps with an alive mask; each step's event deltas are scatter-added
(``.at[].add``) into three accumulator maps — the event-sourcing reduce,
performed eagerly.  Scatter-add is commutative, so this is the same
reduction the multimap performs, minus nondeterministic float ordering.

Faithfully preserved reference semantics:
  * neighbor heights are flow-inflated (AllHeights with
    FLOW_HEIGHT_CONTRIBUTION) and quantized to 2 decimals via int truncation
    (CollectNeighborsAllHeights, :705-727);
  * 8-heading constrained steering: the particle may only turn one compass
    step left/right per step (ChooseHeading, :182-201), with the natural
    drain (argmin over all 8, first-wins tie-break) as fallback;
  * death conditions and their exact payouts: dehydration (water < .01 →
    sediment only), old age (pool + sediment), no-drain (pool + sediment),
    slow-and-flat (θ < 3° and vel < 1 — literals, :399), out-of-bounds
    (everything lost);
  * drag, slope-resolved accel (Gravity·sinθ ± friction energy form),
    terminal-velocity soft clamp (:388-395), capacity = vel·water·CAPACITY,
    erode/deposit split (EROSION/DEPOSITION rates), evaporation.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .world import NEIGHBOR_OFFSETS, WorldState

_F32 = jnp.float32

# Compass ring in ChooseHeading order (HeadingExt.ADJACENT,
# LiveErosionDataTypes.cs:1320-1329): N, NE, E, SE, S, SW, W, NW.
# Directions as (d_row, d_col): N = +row ("up"), E = +col.
RING_DR = np.array([1, 1, 0, -1, -1, -1, 0, 1], np.int32)
RING_DC = np.array([0, 1, 1, 1, 0, -1, -1, -1], np.int32)

# ring index -> nb-array index (WTORDER order up,right,down,left,ne,se,sw,nw)
RING_TO_NB = np.array([0, 4, 1, 5, 2, 6, 3, 7], np.int32)

# nb-array index -> ring index (inverse)
NB_TO_RING = np.array([0, 2, 4, 6, 1, 3, 5, 7], np.int32)

NONE_HEADING = np.int32(-1)


class Particles(NamedTuple):
    """SoA particle state (BeyerParticle fields, :205-215)."""

    row: Any      # f32[N] — pos second-axis of reference (z)
    col: Any      # f32[N]
    heading: Any  # i32[N] ring index, -1 = NONE
    vel: Any      # f32[N]
    water: Any    # f32[N]
    sediment: Any  # f32[N]
    age: Any      # i32[N]
    alive: Any    # bool[N]


def spawn(key, n: int, res: int, water=1.0, alive=True):
    """FillBeyerQueueJob parity: uniform random integer positions, vel .01,
    water 1, no heading (MultiThreadErosionJob.cs:21-71, BeyerParticle ctor
    :226-238)."""
    kr, kc = jax.random.split(key)
    row = jax.random.randint(kr, (n,), 0, res).astype(_F32)
    col = jax.random.randint(kc, (n,), 0, res).astype(_F32)
    return Particles(
        row=row,
        col=col,
        heading=jnp.full((n,), NONE_HEADING),
        vel=jnp.full((n,), 0.01, _F32),
        water=jnp.full((n,), water, _F32),
        sediment=jnp.zeros((n,), _F32),
        age=jnp.zeros((n,), jnp.int32),
        alive=jnp.full((n,), alive),
    )


def _quantize(v):
    """int(100·v)/100 — CollectNeighbors* truncation (:684,709)."""
    return jnp.trunc(100.0 * v) / 100.0


_NB_DR = np.array([o[0] for o in NEIGHBOR_OFFSETS], np.int32)
_NB_DC = np.array([o[1] for o in NEIGHBOR_OFFSETS], np.int32)


def _gather_step_values(combo, row_i, col_i, res, with_plants=False,
                        origin=None, shape=None):
    """ALL of a step's map lookups in ONE gather: 8 all-heights neighbors +
    the particle's WIH + flow (+ plant density when the vegetation friction
    extension is on): one gather op per step instead of eleven.

    ``combo`` = concat([wih.ravel(), all_h.ravel(), flow.ravel()[,
    plants.ravel()]]).

    ``origin``/``shape``: when the maps in ``combo`` are a LOCAL window of
    the global grid (the sharded descent's halo-extended shard block),
    ``origin`` is the window's global (row, col) of entry (0, 0) and
    ``shape`` its (rows, cols); coordinates stay global (incl. the global
    edge clamp), only the flat indexing changes.  Callers guarantee every
    live particle's clipped neighborhood lies inside the window.
    Returns (nb[N,8] quantized, current_h[N], flow_here[N], plants_here)."""
    n = row_i.shape[0]
    if shape is None:
        o_r = o_c = 0
        rows_w, cols_w = res, res
    else:
        o_r, o_c = origin
        rows_w, cols_w = shape
    sz = rows_w * cols_w
    r = jnp.clip(row_i[:, None] + jnp.asarray(_NB_DR)[None, :], 0, res - 1) - o_r
    c = jnp.clip(col_i[:, None] + jnp.asarray(_NB_DC)[None, :], 0, res - 1) - o_c
    center = (row_i - o_r) * cols_w + (col_i - o_c)
    parts = [
        (r * cols_w + c).reshape(-1) + sz,   # all_h neighbors
        center,                              # wih at the particle
        center + 2 * sz,                     # flow at the particle
    ]
    if with_plants:
        parts.append(center + 3 * sz)
    vals = jnp.take(combo, jnp.concatenate(parts))
    nb = _quantize(vals[:8 * n].reshape(n, 8))
    plants_here = vals[10 * n:] if with_plants else None
    return nb, vals[8 * n:9 * n], vals[9 * n:10 * n], plants_here


def _gather_step_values_wf(combo, row_i, col_i, res, fhc, with_plants=False,
                           origin=None, shape=None):
    """_gather_step_values from a TWO-map table ``[wih, flow]`` (+plants):
    neighbor all-heights are recomputed post-gather as
    ``wih + FLOW_HEIGHT_CONTRIBUTION·flow`` — the identical elementwise f32
    ops the precomputed all_h map applies, so results are bit-exact while
    the gather's source table shrinks by a third.

    Gathers 18 (+1) values per particle: 8 neighbor wih + 8 neighbor flow
    + center wih + center flow (+ center plants)."""
    n = row_i.shape[0]
    if shape is None:
        o_r = o_c = 0
        rows_w, cols_w = res, res
    else:
        o_r, o_c = origin
        rows_w, cols_w = shape
    sz = rows_w * cols_w
    r = jnp.clip(row_i[:, None] + jnp.asarray(_NB_DR)[None, :], 0, res - 1) - o_r
    c = jnp.clip(col_i[:, None] + jnp.asarray(_NB_DC)[None, :], 0, res - 1) - o_c
    nb_flat = (r * cols_w + c).reshape(-1)
    center = (row_i - o_r) * cols_w + (col_i - o_c)
    parts = [
        nb_flat,            # wih at the 8 neighbors
        nb_flat + sz,       # flow at the 8 neighbors
        center,             # wih at the particle
        center + sz,        # flow at the particle
    ]
    if with_plants:
        parts.append(center + 2 * sz)
    vals = jnp.take(combo, jnp.concatenate(parts))
    wih_nb = vals[:8 * n].reshape(n, 8)
    flow_nb = vals[8 * n:16 * n].reshape(n, 8)
    nb = _quantize(wih_nb + fhc * flow_nb)
    plants_here = vals[18 * n:] if with_plants else None
    return nb, vals[16 * n:17 * n], vals[17 * n:18 * n], plants_here


def _gather_patches(combo, row_i, col_i, res: int, k: int):
    """Patch prefetch: one gather fetching a (2k+1)² window of all three
    maps around each particle, every k steps instead of one small gather
    per step; the in-between steps read the patch with one-hot
    contractions (no gather).  Window start is clamped so the
    patch stays in-grid; every clipped neighbor index of every position
    reachable within k-1 steps lands inside it.

    Returns (sr, sc, patches[N, 3, P, P]) with map order (wih, all_h,
    flow) matching ``combo``'s layout."""
    p = 2 * k + 1
    sz = res * res
    sr = jnp.clip(row_i - k, 0, res - p)
    sc = jnp.clip(col_i - k, 0, res - p)
    rr = sr[:, None] + jnp.arange(p, dtype=jnp.int32)
    cc = sc[:, None] + jnp.arange(p, dtype=jnp.int32)
    cell = rr[:, :, None] * res + cc[:, None, :]          # [N, P, P]
    idx = jnp.stack([cell, cell + sz, cell + 2 * sz], 1)  # [N, 3, P, P]
    patches = jnp.take(combo, idx.reshape(-1)).reshape(idx.shape)
    return sr, sc, patches


def _patch_step_values(patch_ctx, row_i, col_i, res: int):
    """The per-step map reads (nb, wih, flow — see _gather_step_values)
    served from prefetched patches: build 3-row / 3-col one-hots for the
    individually-clipped neighbor coordinates and contract the patch with
    them (exact — each sum has one 1·x term and zeros elsewhere)."""
    sr, sc, patches, k = patch_ctx
    p = 2 * k + 1
    iota = jnp.arange(p, dtype=jnp.int32)
    lr = jnp.stack(
        [jnp.clip(row_i + d, 0, res - 1) - sr for d in (-1, 0, 1)], 1
    )                                                      # [N, 3]
    lc = jnp.stack(
        [jnp.clip(col_i + d, 0, res - 1) - sc for d in (-1, 0, 1)], 1
    )
    ohr = (lr[:, :, None] == iota).astype(_F32)            # [N, 3, P]
    ohc = (lc[:, :, None] == iota).astype(_F32)
    # elementwise broadcast-multiply-sum, NOT einsum: a batched [3,P]×[P,P]
    # matmul would dispatch N tiny matrix products and could run at reduced
    # precision (TF32/bf16 breaks bit-exactness); the elementwise form
    # fuses and keeps f32 (products are exactly 0 or x)
    tmp = jnp.sum(
        ohr[:, None, :, :, None] * patches[:, :, None, :, :], axis=3
    )                                                      # [N, 3, 3, P]
    win = jnp.sum(
        tmp[:, :, :, None, :] * ohc[:, None, None, :, :], axis=4
    )                                                      # [N, 3, 3, 3]
    nb = jnp.stack(
        [
            win[:, 1, 1 + int(_NB_DR[d]), 1 + int(_NB_DC[d])]
            for d in range(8)
        ],
        axis=1,
    )
    return _quantize(nb), win[:, 0, 1, 1], win[:, 2, 1, 1]


def _select8(table_rows, idx):
    """table_rows: [N, 8]; idx: int[N] → out[N] = table_rows[i, idx[i]]
    as an 8-way select chain (take_along_axis lowers to another gather)."""
    out = table_rows[:, 0]
    for k in range(1, 8):
        out = jnp.where(idx == k, table_rows[:, k], out)
    return out


def _uphill_velocity_loss(v_diff, eff_friction, gravity, patch_res):
    """UphillVelocityLoss (:256-263) — NaN when v_diff == 0, matching the
    reference's 0/0; callers rely on NaN-compares-false."""
    theta = jnp.arctan(v_diff / patch_res)
    accel = gravity * jnp.sin(theta) + eff_friction
    return jnp.sqrt(2.0 * jnp.abs(accel) * (v_diff / jnp.sin(theta)))


def _downhill_velocity_gain(v_diff, eff_friction, gravity, patch_res):
    """DownhillVelocityGain (:265-271)."""
    theta = jnp.arctan(v_diff / patch_res)
    accel = gravity * jnp.sin(theta) - eff_friction
    return jnp.sqrt(2.0 * jnp.abs(accel) * (v_diff / jnp.sin(theta)))


def descend_step(p: Particles, state: WorldState, params, height_scale,
                 patch_res, res: int, maps=None, patch_ctx=None,
                 window_origin=None, window_shape=None,
                 table_layout: str = "waf"):
    """One DescendSimultaneous step for every particle.

    Returns (new_particles, events) where events is a dict of per-particle
    deltas + the cell (row_i, col_i) they land on, masked by participation.

    ``maps``: optional precomputed (wih_map, all_h) — the world maps are
    read-only during descent (particles only emit events), so callers
    looping over steps hoist these out (see descend_all).

    ``patch_ctx``: optional (sr, sc, patches, k) from _gather_patches —
    serve the step's map reads from prefetched windows instead of a
    gather (valid while every particle is within k-1 steps of where the
    patch was fetched).
    """
    row_i = jnp.clip(jnp.round(p.row).astype(jnp.int32), 0, res - 1)
    col_i = jnp.clip(jnp.round(p.col).astype(jnp.int32), 0, res - 1)
    was_alive = p.alive

    d_track = jnp.zeros_like(p.water)
    d_pool = jnp.zeros_like(p.water)
    d_sed = jnp.zeros_like(p.water)

    # --- death: dehydration (:284-291) -------------------------------------
    dehydrated = was_alive & (p.water < 0.01)
    d_sed = d_sed + jnp.where(dehydrated, p.sediment / height_scale, 0.0)

    # --- death: old age (:292-300) ------------------------------------------
    too_old = was_alive & ~dehydrated & (p.age >= params.MAXAGE)
    d_pool = d_pool + jnp.where(too_old, p.water / height_scale, 0.0)
    d_sed = d_sed + jnp.where(too_old, p.sediment / height_scale, 0.0)

    active = was_alive & ~dehydrated & ~too_old

    # --- neighborhood -------------------------------------------------------
    with_plants = getattr(params, "VEGETATION_FRICTION", 0.0) > 0.0
    if maps is None:
        wih_map = height_scale * (state.height + state.pool)
        all_h = wih_map + params.FLOW_HEIGHT_CONTRIBUTION * state.flow
        pieces = [wih_map.reshape(-1), all_h.reshape(-1), state.flow.reshape(-1)]
        if with_plants:
            pieces.append(state.plants.reshape(-1))
        combo = jnp.concatenate(pieces)
    else:
        combo = maps
    if patch_ctx is not None:
        nb, current_h, flow_here = _patch_step_values(
            patch_ctx, row_i, col_i, res
        )
        plants_here = None
    elif table_layout == "wf":
        nb, current_h, flow_here, plants_here = _gather_step_values_wf(
            combo, row_i, col_i, res, params.FLOW_HEIGHT_CONTRIBUTION,
            with_plants=with_plants,
            origin=window_origin, shape=window_shape,
        )
    else:
        nb, current_h, flow_here, plants_here = _gather_step_values(
            combo, row_i, col_i, res, with_plants=with_plants,
            origin=window_origin, shape=window_shape,
        )

    # natural drain: argmin (first-wins) over nb, direction via WTORDER
    drain_nb_idx = jnp.argmin(nb, axis=-1).astype(jnp.int32)  # [N]
    drain_height = jnp.min(nb, axis=-1)
    # NB_TO_RING = [0,2,4,6,1,3,5,7] arithmetically (no table gather)
    drain_ring = (drain_nb_idx % 4) * 2 + drain_nb_idx // 4

    heading = jnp.where(p.heading < 0, drain_ring, p.heading)

    eff_drag = params.DRAG * (1.0 - jnp.maximum(flow_here, 0.0))
    eff_friction = params.FRICTION * (1.0 - jnp.maximum(flow_here, 0.0))
    if with_plants and plants_here is not None:
        # beyond-parity extension (reference's vegetation is a WIP stub —
        # Vegetation.cs:61-63): rooted ground resists erosion; plant
        # density scales friction, capped at 2 stacked canopies
        eff_friction = eff_friction * (
            1.0 + params.VEGETATION_FRICTION * jnp.minimum(plants_here, 2.0)
        )

    # constrained steering (ChooseHeading, :182-201) via select chains;
    # RING_TO_NB = [0,4,1,5,2,6,3,7] arithmetically: nb = ring//2 + 4·(ring&1)
    left = (heading + 7) % 8
    right = (heading + 1) % 8
    h_left = _select8(nb, left // 2 + 4 * (left % 2))
    h_center = _select8(nb, heading // 2 + 4 * (heading % 2))
    h_right = _select8(nb, right // 2 + 4 * (right % 2))
    go_left = (h_left < h_center) & (h_left < h_right)
    go_right = (h_right < h_left) & (h_right < h_center)
    flow_ring = jnp.where(go_left, left, jnp.where(go_right, right, heading))
    heading_height = jnp.where(go_left, h_left, jnp.where(go_right, h_right, h_center))

    h_diff = heading_height - current_h
    vel = p.vel - p.vel * eff_drag  # drag applies before the branch (:324)

    loss = _uphill_velocity_loss(h_diff, eff_friction, params.GRAVITY, patch_res)
    downhill_ok = h_diff < 0.0
    uphill_ok = ~downhill_ok & (loss <= vel)      # NaN loss → False
    take_heading = downhill_ok | uphill_ok
    velocity_loss = jnp.where(uphill_ok, loss, 0.0)

    # fallback: natural drain; die if even the drain is uphill (:331-343)
    drain_h_diff = drain_height - current_h
    no_drain = active & ~take_heading & (drain_h_diff > 0.0)
    d_pool = d_pool + jnp.where(no_drain, p.water / height_scale, 0.0)
    d_sed = d_sed + jnp.where(no_drain, p.sediment / height_scale, 0.0)

    moving = active & ~no_drain
    new_ring = jnp.where(take_heading, flow_ring, drain_ring)
    h_diff = jnp.where(take_heading, h_diff, drain_h_diff)

    dr = jnp.zeros_like(p.row)
    dc = jnp.zeros_like(p.col)
    for k in range(8):
        dr = jnp.where(new_ring == k, float(RING_DR[k]), dr)
        dc = jnp.where(new_ring == k, float(RING_DC[k]), dc)
    new_row = p.row + dr
    new_col = p.col + dc

    # out-of-bounds death loses everything (:351-357)
    nri = jnp.round(new_row).astype(jnp.int32)
    nci = jnp.round(new_col).astype(jnp.int32)
    oob = moving & ((nri < 0) | (nci < 0) | (nri >= res) | (nci >= res))
    moving = moving & ~oob

    # velocity update (:358-398)
    v_diff = jnp.abs(h_diff)
    theta = jnp.arctan(v_diff / patch_res)
    theta_d = theta * 180.0 / 3.14159
    gain = _downhill_velocity_gain(v_diff, eff_friction, params.GRAVITY, patch_res)
    delta_v = jnp.where(
        v_diff > 0.0,
        jnp.where(h_diff > 0.0, -velocity_loss, gain),
        0.0,
    )
    vel = jnp.maximum(vel + delta_v, 0.0)
    over = vel - params.TERMINAL_VELOCITY
    vel = vel - jnp.maximum(
        jnp.minimum(over, jnp.maximum(eff_drag * 0.25 * over * over, 0.0)), 0.0
    )

    # slow-and-flat cull — literal 3° / 1.0 thresholds (:399-407)
    slow = moving & (theta_d < 3.0) & (vel < 1.0)
    d_pool = d_pool + jnp.where(slow, p.water / height_scale, 0.0)
    d_sed = d_sed + jnp.where(slow, p.sediment / height_scale, 0.0)
    moving = moving & ~slow

    # capacity exchange (:408-423)
    capacity = vel * p.water * params.CAPACITY
    deposition = jnp.where(
        p.sediment < capacity,
        -params.EROSION * (capacity - p.sediment),
        params.DEPOSITION * (p.sediment - capacity),
    )
    d_sed = d_sed + jnp.where(moving, deposition / height_scale, 0.0)
    new_sediment = jnp.where(moving, p.sediment - deposition, p.sediment)

    # water track + evaporation (:427-428)
    d_track = d_track + jnp.where(moving, p.water, 0.0)
    new_water = jnp.where(moving, p.water * (1.0 - params.EVAP), p.water)

    still_alive = moving
    out = Particles(
        row=jnp.where(moving, new_row, p.row),
        col=jnp.where(moving, new_col, p.col),
        heading=jnp.where(moving, new_ring, p.heading),
        vel=jnp.where(moving, vel, p.vel),
        water=new_water,
        sediment=new_sediment,
        age=jnp.where(moving, p.age + 1, p.age),
        alive=still_alive,
    )
    events = dict(row=row_i, col=col_i, d_track=d_track, d_pool=d_pool, d_sed=d_sed)
    return out, events


def descend_all(p: Particles, state: WorldState, params, height_scale,
                patch_res, res: int, max_steps: int = None,
                chunk: int = 8, patch_k: int = 0,
                table_layout: str = "waf", scatter: str = "chunk",
                compact: bool = True):
    """Run the full descent loop; returns accumulated event maps.

    The reference loop runs until every particle dies; the age cap MAXAGE
    bounds it, so ``MAXAGE + 1`` scan steps cover every trajectory (the +1
    delivers the old-age death payout).

    Structure: while_loop over ``chunk``-step scan chunks with an
    all-dead early exit (the reference's per-particle loops end on death;
    most trajectories are much shorter than MAXAGE, and dead particles
    emit nothing, so skipping trailing chunks is exact).  Events reduce
    with one scatter-add per chunk — hundreds of per-step scatters
    dominated the scan otherwise.

    ``patch_k``: steps served per patch prefetch (see _gather_patches) —
    divides ``chunk``; the per-step map reads then cost one-hot
    contractions instead of gathers.  Default 0 (one gather per step);
    the prefetch path is bit-exact and tested, and its cost on the GPU
    is not measured yet.
    """
    steps = (params.MAXAGE + 1) if max_steps is None else max_steps
    n_chunks = -(-steps // chunk)
    shape = state.height.shape
    # event accumulators start as constants but the loop bodies add
    # per-shard-varying data — carry types must agree inside shard_map
    # (tile_batch dp path); match_vma is a numerical no-op
    from ..utils.helpers import match_vma

    zeros = match_vma(jnp.zeros(shape[0] * shape[1], _F32), state.height)
    with_plants = getattr(params, "VEGETATION_FRICTION", 0.0) > 0.0
    use_patches = (patch_k > 0 and res >= 2 * patch_k + 1
                   and not with_plants)  # patches carry 3 maps only
    if use_patches and chunk % patch_k:
        raise ValueError("patch_k must divide chunk")
    # world maps are invariant across the descent — compute once, not per
    # scan step (the dominant cost at production resolutions otherwise)
    wih_map = height_scale * (state.height + state.pool)
    if patch_k > 0 and table_layout != "waf":
        raise ValueError(
            "patch prefetch serves from the 3-map ('waf') table; "
            f"got table_layout={table_layout!r} with patch_k={patch_k}")
    if table_layout == "wf":
        # two-map table: neighbor all-heights recomputed post-gather
        # (bit-exact — see _gather_step_values_wf); opt-in, not default
        pieces = [wih_map.reshape(-1), state.flow.reshape(-1)]
    else:
        all_h = wih_map + params.FLOW_HEIGHT_CONTRIBUTION * state.flow
        pieces = [wih_map.reshape(-1), all_h.reshape(-1),
                  state.flow.reshape(-1)]
    if with_plants:
        pieces.append(state.plants.reshape(-1))
    maps = jnp.concatenate(pieces)

    def step_body_gather(part, _):
        part, ev = descend_step(
            part, state, params, height_scale, patch_res, res, maps=maps,
            table_layout=table_layout,
        )
        flat = (ev["row"] * res + ev["col"]).astype(jnp.int32)
        return part, (flat, ev["d_track"], ev["d_pool"], ev["d_sed"])

    def run_span(part):
        """patch_k steps off one prefetched patch set."""
        row_i = jnp.clip(jnp.round(part.row).astype(jnp.int32), 0, res - 1)
        col_i = jnp.clip(jnp.round(part.col).astype(jnp.int32), 0, res - 1)
        sr, sc, patches = _gather_patches(maps, row_i, col_i, res, patch_k)
        ctx = (sr, sc, patches, patch_k)

        def body(part, _):
            part, ev = descend_step(
                part, state, params, height_scale, patch_res, res,
                maps=maps, patch_ctx=ctx,
            )
            flat = (ev["row"] * res + ev["col"]).astype(jnp.int32)
            return part, (flat, ev["d_track"], ev["d_pool"], ev["d_sed"])

        return jax.lax.scan(body, part, None, length=patch_k)

    def run_chunk(part):
        if use_patches:
            outs = []
            for _ in range(chunk // patch_k):
                part, out = run_span(part)
                outs.append(out)
            idx, dt, dp_, ds = (
                jnp.concatenate([o[i] for o in outs]) for i in range(4)
            )
        else:
            part, (idx, dt, dp_, ds) = jax.lax.scan(
                step_body_gather, part, None, length=chunk
            )
        return part, idx.reshape(-1), dt.reshape(-1), dp_.reshape(-1), ds.reshape(-1)

    if scatter == "end":
        # Defer all event scatters to ONE scatter-add per map after the
        # loop: per-chunk events land in preallocated (n_chunks, chunk·N)
        # slots, ordered exactly as the per-chunk scatters would apply
        # them, so duplicate-cell accumulation order (and hence f32 sums)
        # is unchanged.  Unfilled trailing chunks (early exit) keep
        # idx 0 / delta 0 — scatter-adding 0.0 is a no-op.
        n = p.row.shape[0]
        span = chunk * n

        def chunk_body(carry):
            part, bidx, bdt, bdp, bds, k = carry
            part, idx, dt, dp_, ds = run_chunk(part)
            off = k * span
            bidx = jax.lax.dynamic_update_slice(bidx, idx, (off,))
            bdt = jax.lax.dynamic_update_slice(bdt, dt, (off,))
            bdp = jax.lax.dynamic_update_slice(bdp, dp_, (off,))
            bds = jax.lax.dynamic_update_slice(bds, ds, (off,))
            return part, bidx, bdt, bdp, bds, k + 1

        def chunk_cond(carry):
            return (carry[5] < n_chunks) & jnp.any(carry[0].alive)

        zi = jnp.zeros(n_chunks * span, jnp.int32)
        zf = jnp.zeros(n_chunks * span, _F32)
        p, bidx, bdt, bdp, bds, _ = jax.lax.while_loop(
            chunk_cond, chunk_body, (p, zi, zf, zf, zf, jnp.int32(0))
        )
        track_acc = zeros.at[bidx].add(bdt)
        pool_acc = zeros.at[bidx].add(bdp)
        sed_acc = zeros.at[bidx].add(bds)
    else:
        # Alive-compaction cascade: once the live count fits a narrower
        # buffer, a stable alive-first compaction halves the per-step
        # gather (and all per-particle math).  Stability preserves the
        # relative slot order of survivors, so per-cell scatter
        # accumulation order — and therefore every f32 sum — is unchanged
        # where scatters apply in order (the CPU); on a GPU duplicate-cell
        # scatter-adds are atomics whose order varies from run to run.
        # Levels: N, N/2, N/4, N/8 (floor 64 slots).
        n0 = p.row.shape[0]
        levels = [n0]
        for _ in range(3 if compact else 0):
            nxt = levels[-1] // 2
            if nxt >= 64 and nxt * 2 == levels[-1]:
                levels.append(nxt)
            else:
                break

        def make_loop(threshold):
            def chunk_body(carry):
                part, track, pool_, sed, k = carry
                part, idx, dt, dp_, ds = run_chunk(part)
                track = track.at[idx].add(dt)
                pool_ = pool_.at[idx].add(dp_)
                sed = sed.at[idx].add(ds)
                return part, track, pool_, sed, k + 1

            def chunk_cond(carry):
                part, _, _, _, k = carry
                return (k < n_chunks) & (
                    jnp.sum(part.alive.astype(jnp.int32)) > threshold)

            return chunk_cond, chunk_body

        # final particle states return in their ORIGINAL slots: compaction
        # parks dropped (dead, hence frozen) particles' states and an
        # inverse permutation restores everything at the end
        final = Particles(*[jnp.zeros((n0,), f.dtype) for f in p])
        perm = jnp.arange(n0, dtype=jnp.int32)

        track_acc, pool_acc, sed_acc = zeros, zeros, zeros
        k = jnp.int32(0)
        for li, sz in enumerate(levels):
            last = li == len(levels) - 1
            threshold = 0 if last else levels[li + 1]
            cond, body = make_loop(threshold)
            p, track_acc, pool_acc, sed_acc, k = jax.lax.while_loop(
                cond, body, (p, track_acc, pool_acc, sed_acc, k)
            )
            if not last:
                m = levels[li + 1]
                order = jnp.argsort(~p.alive, stable=True)
                keep, drop = order[:m], order[m:]
                final = Particles(*[
                    ff.at[jnp.take(perm, drop)].set(jnp.take(f, drop))
                    for ff, f in zip(final, p)
                ])
                perm = jnp.take(perm, keep)
                p = Particles(*[jnp.take(f, keep, axis=0) for f in p])
        p = Particles(*[
            ff.at[perm].set(f) for ff, f in zip(final, p)
        ])
    return (
        p,
        track_acc.reshape(shape),
        pool_acc.reshape(shape),
        sed_acc.reshape(shape),
    )
