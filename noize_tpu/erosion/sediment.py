"""Sediment write-back: kernel dispersal + pile deposition.

Reference: ``FlowMaster.WriteSedimentMap`` / ``KernelDisperse`` / ``Place``
(/root/reference/Geologic/ParticleErosion/LiveErosionComponents.cs:98-184),
``ErodeHeightMaps`` (MultiThreadErosionJob.cs:438-480), ``PileSolver`` /
``ManhattanVertex`` (LiveErosionDataTypes.cs:1052-1228).

The reference drains a per-cell sediment-event queue *serially*: negative
or small deltas are stamped into the heightmap through a 5x5 separable
gaussian with clamped (edge-accumulating) indexing and a per-tap [0,1]
"bad build breaker" skip (LiveErosionComponents.cs:130-150); large positive
deltas go through the Manhattan-ring PileSolver.

Design: all cells disperse at once.  A clamped-scatter gaussian stamp is
exactly a full correlation whose out-of-range margins are *folded* onto the
edge rows/columns (the adjoint of edge-clamped gather), and it is separable
because SafeIdx clamps each axis independently.  The [0,1] breaker is
applied per destination cell on the summed delta (the reference applies it
per tap in queue-drain order, which is nondeterministic hash-map order —
divergence noted).

PileSolver divergence (documented; SURVEY.md §7.5 sanctions this for v1):
the exact solver raises rings serially until the volume is placed; here
each pile is deposited as a mass-conserving Manhattan cone of radius
PILING_RADIUS (peak at the pile cell, linear falloff), which preserves
total mass and bounded support but not the exact ring-fill profile.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_F32 = jnp.float32

# ErodeHeightMaps kernel5 (MultiThreadErosionJob.cs:449-455; these are
# gaussian_taps(sigma≈1.1, 5) — kept verbatim for parity with KERNEL5 in
# LiveErosionComponents.cs:49)
KERNEL5 = np.array(
    [0.12007838424321349, 0.23388075658535032, 0.29208171834287244,
     0.23388075658535032, 0.12007838424321349],
    np.float32,
)
KERNEL3 = np.array(
    [0.30780132912347, 0.38439734175306006, 0.30780132912347], np.float32
)


def _disperse_axis(s, taps, axis: int):
    """Clamped-scatter 1-D dispersal: every source cell stamps taps at
    clamp(c+d); out-of-range taps accumulate on the edge cell.

    Formulated as zero-fill shifted adds (symmetric taps ⇒ scatter ==
    correlation) plus closed-form edge folds, instead of overlapping
    dynamic-update-slice accumulation, which serializes."""
    taps = np.asarray(taps, np.float32)
    k = len(taps)
    off = (k - 1) // 2
    n = s.shape[axis]
    s = jnp.moveaxis(s, axis, -1)
    zpad = jnp.pad(s, [(0, 0)] * (s.ndim - 1) + [(off, off)])
    out = None
    for i in range(k):
        piece = zpad[..., i:i + n] * taps[k - 1 - i]
        out = piece if out is None else out + piece
    if off > 0:
        # fold: source col j (< off) sends Σ_{i<off-j} taps[i] to col 0
        t_lo = np.cumsum(taps)            # t_lo[m] = Σ_{i<=m} taps[i]
        for j in range(off):
            w_lo = float(t_lo[off - j - 1])
            out = out.at[..., 0].add(s[..., j] * w_lo)
            out = out.at[..., n - 1].add(s[..., n - 1 - j] * w_lo)
    return jnp.moveaxis(out, -1, axis)


def kernel_disperse(sed, taps=KERNEL5):
    """2-D separable clamped-scatter stamp (KernelDisperse parity for the
    sum over all cells; kernelFactor = kernel[x]·kernel[z])."""
    return _disperse_axis(_disperse_axis(sed, taps, 0), taps, 1)


def _triangle_taps(radius: int) -> np.ndarray:
    """Normalized 1-D triangle taps (radius − |d|)₊ with an emphasized
    peak — the separable factor of the pile profile."""
    d = np.arange(-radius, radius + 1)
    w = np.maximum(radius - np.abs(d), 0.0).astype(np.float64)
    w[radius] = radius
    return (w / w.sum()).astype(np.float32)


_TENT_CACHE = {}


def pile_deposit(pile_map, radius: int):
    """Deposit each cell's pile volume as a separable tent (triangle ⊗
    triangle) of radius PILING_RADIUS around it.

    ``pile_map`` holds the (positive) volumes of cells exceeding
    PILE_THRESHOLD; support is clamped at tile borders with edge folding so
    mass is conserved (the exact solver skips out-of-bounds verts instead —
    LiveErosionDataTypes.cs:1202-1207 — losing that mass; we keep it).

    Profile note (PARITY.md D3): the exact solver's serial ring fill is
    approximated by a peaked bounded-support deposit; the separable tent
    replaces an earlier Manhattan cone: two 1-D passes instead of a dense
    (2r+1)² convolution."""
    if radius not in _TENT_CACHE:
        _TENT_CACHE[radius] = _triangle_taps(radius)
    taps = _TENT_CACHE[radius]
    return _disperse_axis(_disperse_axis(pile_map, taps, 0), taps, 1)


# --------------------------------------------------------------------------
# Exact PileSolver (opt-in): serial-faithful transcription of the reference
# Manhattan-ring algorithm, including its quirks — duplicate ring vertices
# with desynchronized value caches, modified-only commits with last-write-
# wins, out-of-bounds vertices skipped.  The default tent profile
# (pile_deposit) is the fast approximation; this path exists for
# parity scrutiny (PARITY.md D3) and small/interactive runs.
# Reference: PileSolver / ManhattanVertex, LiveErosionDataTypes.cs:1052-1228.

_PILE_TABLES = {}


def _pile_tables(radius: int):
    """Static vertex/visit tables for one solver radius.

    Slots enumerate exactly as PileSolver.Init: dist 0..radius-1, dir
    (up,right),(right,down),(down,left),(left,up), i in 0..dist+1 with
    offset = dist·dirA + i·(dirB − dirA).  Visits flatten DepositSediment's
    (round, slot) iteration: round 1..radius over every slot with
    dist < round, in slot order."""
    if radius in _PILE_TABLES:
        return _PILE_TABLES[radius]
    dirs = [(1, 0), (0, 1), (-1, 0), (0, -1)]  # up, right, down, left
    pairs = [(dirs[0], dirs[1]), (dirs[1], dirs[2]),
             (dirs[2], dirs[3]), (dirs[3], dirs[0])]
    off_r, off_c, dist_l = [], [], []
    for dist in range(radius):
        for (ar, ac), (br, bc) in pairs:
            for i in range(dist + 2):
                off_r.append(dist * ar + i * (br - ar))
                off_c.append(dist * ac + i * (bc - ac))
                dist_l.append(dist)
    off_r = np.asarray(off_r, np.int32)
    off_c = np.asarray(off_c, np.int32)
    dist_l = np.asarray(dist_l, np.int32)
    s = len(off_r)
    # occurrence rank per duplicated cell (commit passes: later rank wins)
    seen = {}
    rank = np.zeros(s, np.int32)
    for k in range(s):
        cell = (int(off_r[k]), int(off_c[k]))
        rank[k] = seen.get(cell, 0)
        seen[cell] = rank[k] + 1
    visit_slot, visit_round = [], []
    for rnd in range(1, radius + 1):
        for k in range(s):
            if dist_l[k] < rnd:
                visit_slot.append(k)
                visit_round.append(rnd)
    onehot = np.zeros((len(visit_slot), s), np.float32)
    onehot[np.arange(len(visit_slot)), visit_slot] = 1.0
    # dup_higher[k, k'] — slot k' targets the same offset cell as k with a
    # higher occurrence rank; a commit from k is overridden by one from k'
    # (the rank-pass scatter's last-write-wins, expressed as a static mask)
    same = (off_r[:, None] == off_r[None, :]) & (off_c[:, None] == off_c[None, :])
    dup_higher = same & (rank[None, :] > rank[:, None])
    tables = dict(
        off_r=off_r, off_c=off_c, rank=rank, n_ranks=int(rank.max()) + 1,
        onehot=onehot, visit_round=np.asarray(visit_round, np.float32),
        dup_higher=dup_higher,
    )
    _PILE_TABLES[radius] = tables
    return tables


def _solve_pile(vals0, valid, amount, increment, radius: int):
    """The DepositSediment sweep loop for one pile, on its per-slot value
    cache: repeat the full (round, slot) visit sequence until ``amount``
    is placed.  Returns (vals, modified) — the commit inputs.

    The solver state is the per-slot value cache ``vals`` — duplicates of
    the same cell hold independent copies (the reference's desync is part
    of the algorithm).  Each visit is an elementwise one-hot update over
    the ~S slot vector; dynamic per-visit indexing would be a gather
    per step.  Shared verbatim by the single-device commit path
    (_handle_pile) and the sharded sparse solve
    (parallel.sharded_erosion._sharded_write_sediment_exact) so the f32
    op sequence is identical."""
    import jax

    t = _pile_tables(radius)
    onehot = jnp.asarray(t["onehot"])
    vrounds = jnp.asarray(t["visit_round"])
    validf = valid

    def sweep(carry):
        vals, modified, rem_total = carry
        amount_sweep = rem_total

        def visit(c, inp):
            vals, modified, deposited = c
            oh, rnd = inp
            ohb = oh > 0.0
            remaining = amount_sweep - deposited
            level = vals[0] + increment * rnd
            cur = jnp.sum(jnp.where(ohb, vals, 0.0))
            ok = jnp.any(ohb & validf) & (cur < level) & (remaining > 0.0)
            diff = jnp.where(ok, jnp.minimum(increment, remaining), 0.0)
            vals = jnp.where(ohb, vals + diff, vals)
            modified = modified | (ohb & ok)
            return (vals, modified, deposited + diff), None

        (vals, modified, deposited), _ = jax.lax.scan(
            visit, (vals, modified, jnp.float32(0.0)), (onehot, vrounds)
        )
        return vals, modified, amount_sweep - deposited

    def cond(carry):
        return carry[2] > 0.0

    vals, modified, _ = jax.lax.while_loop(
        cond, sweep,
        (vals0, jnp.zeros(vals0.shape, bool), amount),
    )
    return vals, modified


def _handle_pile(height, r0, c0, amount, increment, radius: int):
    """HandlePile (LiveErosionDataTypes.cs:1157-1166) for one pile: sweep
    DepositSediment until the volume is placed (_solve_pile), then
    commit."""
    t = _pile_tables(radius)
    res_r, res_c = height.shape
    rows = r0 + jnp.asarray(t["off_r"])
    cols = c0 + jnp.asarray(t["off_c"])
    valid = (rows >= 0) & (cols >= 0) & (rows < res_r) & (cols < res_c)
    cr = jnp.clip(rows, 0, res_r - 1)
    cc = jnp.clip(cols, 0, res_c - 1)
    vals0 = height[cr, cc]
    vals, modified = _solve_pile(vals0, valid, amount, increment, radius)

    # CommitChanges: modified & valid slots write their cached val, in slot
    # order (last write wins).  Ranks split duplicates so each scatter pass
    # has unique in-grid targets; unmodified/invalid slots route to a trash
    # row/col on a padded copy.
    padded = jnp.zeros((res_r + 1, res_c + 1), height.dtype)
    padded = padded.at[:res_r, :res_c].set(height)
    for rk in range(t["n_ranks"]):
        sel = np.where(t["rank"] == rk)[0]
        if sel.size == 0:
            continue
        sel = jnp.asarray(sel)
        m = modified[sel] & valid[sel]
        tr = jnp.where(m, rows[sel], res_r)
        tc = jnp.where(m, cols[sel], res_c)
        padded = padded.at[tr, tc].set(vals[sel])
    return padded[:res_r, :res_c]


def exact_pile_deposit(height, pile_map, params, height_scale,
                       max_piles: int = 64):
    """Apply the exact PileSolver to every pile cell, serially in ascending
    cell order (the reference drains a hash-ordered queue — order there is
    nondeterministic; ascending index is the deterministic stand-in).
    Processes up to ``max_piles`` largest piles (piles are rare — a cell
    must bank > PILE_THRESHOLD metres in one cycle)."""
    import jax

    res = height.shape[0]
    inc = jnp.float32(params.MIN_PILE_INCREMENT / height_scale)
    flat = pile_map.reshape(-1)
    vols, idxs = jax.lax.top_k(flat, max_piles)
    big = jnp.int32(res * res)
    order = jnp.argsort(jnp.where(vols > 0.0, idxs, big))
    vols = jnp.take(vols, order)
    idxs = jnp.take(idxs, order)

    def body(i, h):
        vol = vols[i]
        idx = idxs[i]
        return jax.lax.cond(
            vol > 0.0,
            lambda hh: _handle_pile(
                hh, idx // res, idx % res, vol, inc, params.PILING_RADIUS
            ),
            lambda hh: hh,
            h,
        )

    return jax.lax.fori_loop(0, max_piles, body, height)


def write_sediment_map(height, sed_acc, params, height_scale):
    """ErodeHeightMaps + WriteSedimentMap parity split:

      delta < 0            → gaussian disperse (erosion carving)
      0 ≤ delta ≤ thresh   → gaussian disperse
      delta > thresh       → pile deposit

    with thresh = PILE_THRESHOLD / HEIGHT, then the [0,1] breaker.
    """
    import jax

    thresh = params.PILE_THRESHOLD / height_scale
    disperse_part = jnp.where(sed_acc <= thresh, sed_acc, 0.0)
    pile_part = jnp.where(sed_acc > thresh, sed_acc, 0.0)
    delta = kernel_disperse(disperse_part, KERNEL5)
    if params.EXACT_PILES:
        # breaker applies to dispersal only (KernelDisperse's per-tap skip);
        # the exact solver commits heights directly, breaker-free, exactly
        # as PileSolver.CommitChanges does
        new_height = height + delta
        ok = (new_height >= 0.0) & (new_height <= 1.0)
        new_height = jnp.where(ok, new_height, height)
        return jax.lax.cond(
            jnp.any(pile_part > 0.0),
            lambda h, p: exact_pile_deposit(h, p, params, height_scale),
            lambda h, p: h,
            new_height, pile_part,
        )
    # piles are rare (a cell must accumulate > PILE_THRESHOLD metres in one
    # cycle); skip the wide cone convolution entirely when none exist
    delta = delta + jax.lax.cond(
        jnp.any(pile_part > 0.0),
        lambda p: pile_deposit(p, params.PILING_RADIUS),
        lambda p: jnp.zeros_like(p),
        pile_part,
    )
    new_height = height + delta
    # bad build breaker (LiveErosionComponents.cs:145-146)
    ok = (new_height >= 0.0) & (new_height <= 1.0)
    return jnp.where(ok, new_height, height)
