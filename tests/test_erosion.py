"""Erosion subsystem tests: per-piece oracles + whole-cycle properties."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from noize_tpu.erosion import particles as P
from noize_tpu.erosion import pool as PO
from noize_tpu.erosion import sediment as SE
from noize_tpu.erosion import world as W
from noize_tpu.erosion.params import ErosionMode, ErosionParameters, ErosionSettings
from noize_tpu.erosion.sim import ErosionSim, erosion_cycle, init_state
from noize_tpu.core.tiles import TileSetMeta

RNG = np.random.default_rng(5)


def hill(res=32, amp=0.5):
    """Smooth bump heightmap in [0, amp]."""
    x = np.linspace(-1, 1, res)
    g = np.exp(-(x[:, None] ** 2 + x[None, :] ** 2) * 3)
    return (amp * g).astype(np.float32)


class TestWorld:
    def test_wih_and_all_heights(self):
        s = W.WorldState.create(jnp.asarray(hill()))
        s = s.__class__(height=s.height, pool=s.pool + 0.1, flow=s.flow + 0.2,
                        track=s.track, plants=s.plants)
        wih = np.asarray(W.wih(s, 1000.0))
        np.testing.assert_allclose(wih, 1000.0 * (hill() + 0.1), rtol=1e-6)
        ah = np.asarray(W.all_heights(s, 1000.0, 25.0))
        np.testing.assert_allclose(ah, wih + 25.0 * 0.2, rtol=1e-5)

    def test_update_flow_from_track_oracle(self):
        res = 16
        h = RNG.uniform(0, 1, (res, res)).astype(np.float32)
        pool = RNG.uniform(0, 1e-4, (res, res)).astype(np.float32)
        pool[::3] = 0.01  # some cells with real pools
        flow = RNG.uniform(0, 1, (res, res)).astype(np.float32)
        track = RNG.uniform(0, 2, (res, res)).astype(np.float32)
        track[1::2] = 0.0
        p = ErosionParameters()
        s = W.WorldState(height=jnp.asarray(h), pool=jnp.asarray(pool),
                         flow=jnp.asarray(flow), track=jnp.asarray(track),
                         plants=jnp.zeros((res, res)))
        out = W.update_flow_from_track(s, p, 1000.0)
        # loop oracle (LiveErosionDataTypes.cs:869-886)
        want_flow = np.empty_like(flow)
        for z in range(res):
            for x in range(res):
                pv, tv, poolv = flow[z, x], track[z, x], pool[z, x]
                if poolv > W.MINFLOWPOOL:
                    want_flow[z, x] = (1 - 0.1 * p.FLOW_LOSS_RATE) * pv
                elif tv > 0:
                    want_flow[z, x] = (1 - p.FLOW_LOSS_RATE) * pv + (
                        p.FLOW_LOSS_RATE * 50 * tv) / (1 + 50 * tv)
                else:
                    want_flow[z, x] = (1 - p.FLOW_LOSS_RATE) * pv
        np.testing.assert_allclose(np.asarray(out.flow), want_flow, atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(out.pool),
            np.maximum(pool - p.SURFACE_EVAPORATION_RATE / 1000.0, 0.0),
            atol=1e-7,
        )
        assert np.all(np.asarray(out.track) == 0)

    def test_curvature_finite(self):
        c = np.asarray(W.curvature_map(jnp.asarray(hill(64)), 1000.0, 1.0))
        assert np.all(np.isfinite(c)) and c.min() >= 0


class TestParticles:
    def test_spawn_in_bounds_deterministic(self):
        k = jax.random.PRNGKey(1)
        p1 = P.spawn(k, 64, 32)
        p2 = P.spawn(k, 64, 32)
        assert np.array_equal(np.asarray(p1.row), np.asarray(p2.row))
        assert np.asarray(p1.row).min() >= 0 and np.asarray(p1.row).max() <= 31
        assert np.all(np.asarray(p1.water) == 1.0)
        assert np.all(np.asarray(p1.vel) == np.float32(0.01))

    def test_descent_conserves_water_accounting(self):
        """Every particle's water ends up as track traffic and/or pool
        deposits (scaled by 1/HEIGHT for pools); nothing is created."""
        res = 24
        h = hill(res, amp=0.3)
        state = W.WorldState.create(jnp.asarray(h))
        params = ErosionParameters(MAXAGE=16)
        parts = P.spawn(jax.random.PRNGKey(0), 50, res)
        out, track_acc, pool_acc, sed_acc = jax.jit(
            lambda p, s: P.descend_all(p, s, params, 1000.0, 1.0, res)
        )(parts, state)
        assert not bool(np.asarray(out.alive).any())  # MAXAGE+1 steps kill all
        # pool deposits are bounded by total spawned water / HEIGHT
        assert float(np.asarray(pool_acc).sum()) <= 50 * 1.0 / 1000.0 + 1e-5
        assert float(np.asarray(track_acc).sum()) >= 0.0
        assert np.all(np.isfinite(np.asarray(sed_acc)))

    def test_descent_moves_downhill(self):
        """On a slope, surviving particles trend toward lower ground."""
        res = 32
        z = np.tile(np.linspace(1.0, 0.0, res, dtype=np.float32), (res, 1))
        state = W.WorldState.create(jnp.asarray(z))
        params = ErosionParameters(MAXAGE=8)
        parts = P.spawn(jax.random.PRNGKey(2), 40, res)
        start_col = np.asarray(parts.col).copy()
        step = jax.jit(lambda p, s: P.descend_step(p, s, params, 1000.0, 1.0, res))
        for _ in range(4):
            parts, _ = step(parts, state)
        moved = np.asarray(parts.col) - start_col
        # heights decrease with col; column index should increase on average
        assert moved.mean() > 0.5

    def test_quantize_trunc(self):
        v = jnp.asarray([0.0199, 1.0051, 0.5])
        np.testing.assert_allclose(np.asarray(P._quantize(v)), [0.01, 1.00, 0.5])

    def test_patch_prefetch_matches_per_step_gather(self):
        """descend_all's patch-prefetch path (one 9×9 gather per 4 steps,
        one-hot patch reads in between) must be bit-identical to the
        one-gather-per-step path — the extraction sums one 1·x term."""
        res = 48
        rng = np.random.default_rng(11)
        h = jnp.asarray(rng.uniform(0, 1, (res, res)).astype(np.float32))
        state = W.WorldState.create(h)
        params = ErosionParameters(MAXAGE=24)
        parts = P.spawn(jax.random.PRNGKey(5), 64, res)
        f_patch = jax.jit(lambda p, s: P.descend_all(
            p, s, params, 1000.0, 1.0, res, patch_k=4))
        f_gather = jax.jit(lambda p, s: P.descend_all(
            p, s, params, 1000.0, 1.0, res, patch_k=0))
        a = f_patch(parts, state)
        b = f_gather(parts, state)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def np_spread_phase(height, pool, mask, drain_particles):
    """Loop transcription of SpreadPool over one phase with snapshot
    neighbor reads and end-of-phase delta application (matching the
    deterministic semantics documented in noize_tpu.erosion.pool)."""
    res = height.shape[0]
    new_pool = pool.copy()
    neighbor_delta = np.zeros_like(pool)
    drain_map = np.zeros_like(pool)
    dirs = [(1, 0), (0, 1), (-1, 0), (0, -1)]
    for z in range(res):
        for x in range(res):
            if not mask[z, x] or pool[z, x] <= 0:
                continue
            h_land = height[z, x]
            h_water = pool[z, x]
            t_height = h_land + h_water
            nbrs = []
            for di, (dr, dc) in enumerate(dirs):
                zz = min(max(z + dr, 0), res - 1)
                xx = min(max(x + dc, 0), res - 1)
                nbrs.append((height[zz, xx] + pool[zz, xx], di,
                             height[zz, xx], pool[zz, xx], zz, xx))
            nbrs.sort(key=lambda t: (t[0], t[1]))
            for cur, di, bh, bw, zz, xx in nbrs:
                diff_v = t_height - cur
                if h_water < 1e-3:
                    continue
                if bw <= 0 and h_land >= bh:
                    if drain_particles:
                        drain_map[zz, xx] += h_water
                    else:
                        neighbor_delta[zz, xx] += h_water
                    h_water = 0.0
                    t_height = h_land
                elif diff_v > 0:
                    fill = min(0.25 * h_water, 0.25 * diff_v)
                    h_water -= fill
                    t_height = h_land + h_water
                    neighbor_delta[zz, xx] += fill
                elif diff_v < 0:
                    if bw <= 0:
                        continue
                    fill = min(0.25 * bw, -0.25 * diff_v)
                    h_water += fill
                    t_height = h_land + h_water
                    neighbor_delta[zz, xx] -= fill
            new_pool[z, x] = h_water
    return new_pool + neighbor_delta, drain_map


class TestPoolAutomata:
    def test_phase_oracle(self):
        res = 12
        height = RNG.uniform(0, 0.5, (res, res)).astype(np.float32)
        pool = np.zeros((res, res), np.float32)
        pool[3:7, 3:7] = RNG.uniform(0.001, 0.1, (4, 4)).astype(np.float32)
        mask = np.asarray(PO._phase_mask(res, 0, 0))
        got_pool, got_drain = PO._spread_phase(
            jnp.asarray(height), jnp.asarray(pool), jnp.asarray(mask), True
        )
        want_pool, want_drain = np_spread_phase(height, pool, mask, True)
        np.testing.assert_allclose(np.asarray(got_pool), want_pool, atol=1e-6)
        np.testing.assert_allclose(np.asarray(got_drain), want_drain, atol=1e-6)

    def test_phase_oracle_no_drain_particles(self):
        res = 10
        height = RNG.uniform(0, 0.2, (res, res)).astype(np.float32)
        pool = RNG.uniform(0, 0.05, (res, res)).astype(np.float32)
        mask = np.asarray(PO._phase_mask(res, 1, 1))
        got_pool, got_drain = PO._spread_phase(
            jnp.asarray(height), jnp.asarray(pool), jnp.asarray(mask), False
        )
        want_pool, want_drain = np_spread_phase(height, pool, mask, False)
        np.testing.assert_allclose(np.asarray(got_pool), want_pool, atol=1e-6)
        assert np.asarray(got_drain).sum() == 0

    def test_mask_coverage(self):
        """The 4 phase masks partition the grid."""
        res = 16
        total = sum(np.asarray(PO._phase_mask(res, xo, zo)).astype(int)
                    for xo in (0, 1) for zo in (0, 1))
        assert np.all(total == 1)

    def test_water_conservation_without_drains(self):
        res = 16
        height = RNG.uniform(0, 0.3, (res, res)).astype(np.float32)
        pool = RNG.uniform(0, 0.02, (res, res)).astype(np.float32)
        out, drains = PO.pool_automata(
            jnp.asarray(height), jnp.asarray(pool), iterations=4,
            drain_particles=False,
        )
        total = float(np.asarray(out).sum() + np.asarray(drains).sum())
        np.testing.assert_allclose(total, pool.sum(), rtol=1e-4)

    def test_pools_settle_into_basin(self):
        # strictly convex bowl: every neighbor of the minimum is higher, so
        # the dry-drain rule can't fire and water equalizes outward
        res = 17  # odd: strict minimum at the center cell
        x = np.linspace(-1, 1, res, dtype=np.float32)
        height = 0.5 * (x[:, None] ** 2 + x[None, :] ** 2)
        pool = np.zeros((res, res), np.float32)
        pool[res // 2, res // 2] = 0.5
        out, _ = PO.pool_automata(jnp.asarray(height), jnp.asarray(pool),
                                  iterations=16, drain_particles=False)
        out = np.asarray(out)
        assert out.max() < 0.5  # spread out
        assert (out > 1e-4).sum() > 4  # over multiple cells
        np.testing.assert_allclose(out.sum(), 0.5, rtol=1e-4)

    def test_below_gate_pool_is_exact_fixed_point(self):
        """A pool with NO cell at/above MIN_WATER is a bit-exact fixed
        point of the automata (reference parity: SpreadPool's
        ``hWater < 1E-3f continue``, LiveErosionDataTypes.cs:972 — such a
        cell makes no transfers and cannot drain).  Ground truth is the
        UNGATED full-grid path returning its input bit-identically, which
        proves the property with the real phase code; the gated
        production path must then equal it (its call-level skip is
        therefore a pure optimization)."""
        res = 16
        height = RNG.uniform(0, 0.3, (res, res)).astype(np.float32)
        pool = RNG.uniform(0, PO.MIN_WATER * 0.99,
                           (res, res)).astype(np.float32)
        assert pool.max() < PO.MIN_WATER
        h, p = jnp.asarray(height), jnp.asarray(pool)
        fp, fd = PO._pool_automata_fullgrid(h, p, 10, True)
        np.testing.assert_array_equal(np.asarray(fp), pool)
        assert float(jnp.abs(fd).sum()) == 0.0
        gp, gd = PO.pool_automata(h, p, iterations=10, drain_particles=True)
        np.testing.assert_array_equal(np.asarray(gp), pool)
        assert float(jnp.abs(gd).sum()) == 0.0

    def test_gate_boundary_cell_activates(self):
        """One cell at exactly MIN_WATER must still run the automata: on
        flat land its dry neighbor is a drain, so water leaves and the
        gated production path stays bit-exact with the ungated full-grid
        path (the skip gate must not over-skip)."""
        res = 16
        height = np.zeros((res, res), np.float32)
        pool = np.zeros((res, res), np.float32)
        pool[5, 6] = np.float32(PO.MIN_WATER)
        h, p = jnp.asarray(height), jnp.asarray(pool)
        gp, gd = PO.pool_automata(h, p, iterations=1, drain_particles=True)
        fp, fd = PO._pool_automata_fullgrid(h, p, 1, True)
        np.testing.assert_array_equal(np.asarray(gp), np.asarray(fp))
        np.testing.assert_array_equal(np.asarray(gd), np.asarray(fd))
        assert float(np.asarray(gd).sum()) > 0.0  # the drain fired
        assert float(np.asarray(gp)[5, 6]) == 0.0  # cell fully drained

    def test_quad_layout_roundtrip(self):
        a = jnp.asarray(RNG.uniform(0, 1, (16, 16)).astype(np.float32))
        e, o = PO._halfrow_views(a, 0)
        for lat in (e, o):
            got = PO._quad_join(PO._quad_views(lat, 0), PO._quad_views(lat, 1))
            np.testing.assert_array_equal(np.asarray(got), np.asarray(lat))
        got = PO._unpack_quads(PO._pack_quads(a))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(a))

    def test_quad_matches_pair_exactly(self):
        """The diagonal-quadrant formulation is bit-exact with the half-row
        pair path (shared _phase_core; per-cell add order preserved)."""
        for res in (8, 16, 32):
            for dp in (True, False):
                height = RNG.uniform(0, 1, (res, res)).astype(np.float32)
                pool = (RNG.uniform(-0.3, 0.05, (res, res))).clip(0).astype(
                    np.float32)
                p1, d1 = PO.pool_automata(
                    jnp.asarray(height), jnp.asarray(pool),
                    iterations=3, drain_particles=dp)
                p2, d2 = PO.pool_automata_quad(
                    jnp.asarray(height), jnp.asarray(pool),
                    iterations=3, drain_particles=dp)
                np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
                np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))

    def test_flat_floor_drains_teleport(self):
        """On a dead-flat floor the dry-neighbor drain rule moves the whole
        pool instead of spreading it — reference SpreadPool semantics
        (LiveErosionDataTypes.cs:973-990)."""
        res = 8
        height = np.zeros((res, res), np.float32)
        pool = np.zeros((res, res), np.float32)
        pool[4, 4] = 0.5
        out, _ = PO.pool_automata(jnp.asarray(height), jnp.asarray(pool),
                                  iterations=1, drain_particles=False)
        out = np.asarray(out)
        np.testing.assert_allclose(out.sum(), 0.5, rtol=1e-5)
        assert (out > 0).sum() == 1 and out[4, 4] == 0.0


def np_kernel_disperse(sed, taps):
    """Loop transcription of KernelDisperse summed over all cells
    (LiveErosionComponents.cs:130-150, sans breaker)."""
    res = sed.shape[0]
    k = len(taps)
    off = k // 2
    out = np.zeros_like(sed)
    for z in range(res):
        for x in range(res):
            v = sed[z, x]
            if v == 0:
                continue
            for i in range(k):
                for j in range(k):
                    zz = min(max(z - off + i, 0), res - 1)
                    xx = min(max(x - off + j, 0), res - 1)
                    out[zz, xx] += v * taps[i] * taps[j]
    return out


class TestSediment:
    def test_disperse_oracle(self):
        res = 12
        sed = np.zeros((res, res), np.float32)
        sed[0, 0] = 0.3
        sed[5, 6] = -0.2
        sed[11, 11] = 0.1
        got = np.asarray(SE.kernel_disperse(jnp.asarray(sed)))
        want = np_kernel_disperse(sed, SE.KERNEL5)
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_disperse_conserves_mass(self):
        sed = RNG.normal(0, 0.01, (16, 16)).astype(np.float32)
        got = np.asarray(SE.kernel_disperse(jnp.asarray(sed)))
        np.testing.assert_allclose(got.sum(), sed.sum(), atol=1e-5)

    def test_pile_deposit_conserves_mass(self):
        pile = np.zeros((32, 32), np.float32)
        pile[10, 10] = 1.0
        got = np.asarray(SE.pile_deposit(jnp.asarray(pile), 6))
        np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-5)
        assert got[10, 10] == got.max()  # peak at the pile site

    def test_pile_deposit_border_folding(self):
        # near-border pile: out-of-grid cone support folds back in, so the
        # deposited mass is conserved (exact solver would drop it)
        pile = np.zeros((32, 32), np.float32)
        pile[30, 30] = 0.5
        got = np.asarray(SE.pile_deposit(jnp.asarray(pile), 6))
        np.testing.assert_allclose(got.sum(), 0.5, rtol=1e-5)

    def test_write_sediment_breaker(self):
        """[0,1] breaker: cells that would leave range keep the old value."""
        h = np.full((8, 8), 0.5, np.float32)
        h[4, 4] = 0.9999
        sed = np.zeros((8, 8), np.float32)
        sed[4, 4] = 0.0015  # disperses under the pile threshold
        params = ErosionParameters()
        out = np.asarray(SE.write_sediment_map(
            jnp.asarray(h), jnp.asarray(sed), params, 1000.0))
        assert out[4, 4] == np.float32(0.9999)  # would exceed 1 → kept
        assert out[4, 5] > 0.5  # neighbors still receive their share


def np_pile_solver(height, piles, radius, increment):
    """Loop transcription of PileSolver/ManhattanVertex (LiveErosionData
    Types.cs:1052-1228): per-slot value caches (duplicates desync),
    DepositSediment rounds with live verts[0].val levels, HandlePile
    sweep-until-placed, modified-only last-wins commits.  ``piles`` is
    [(row, col, amount)] in processing order."""
    height = height.copy()
    res = height.shape[0]
    dirs = [(1, 0), (0, 1), (-1, 0), (0, -1)]
    pairs = [(dirs[0], dirs[1]), (dirs[1], dirs[2]),
             (dirs[2], dirs[3]), (dirs[3], dirs[0])]
    slots = []  # (off, dist)
    for dist in range(radius):
        for (ar, ac), (br, bc) in pairs:
            for i in range(dist + 2):
                slots.append(((dist * ar + i * (br - ar),
                               dist * ac + i * (bc - ac)), dist))
    for (r0, c0, amount) in piles:
        vals, valid, modified, pos = [], [], [], []
        for (dr, dc), _ in slots:
            r, c = r0 + dr, c0 + dc
            ok = 0 <= r < res and 0 <= c < res
            valid.append(ok)
            pos.append((r, c))
            vals.append(np.float32(height[r, c]) if ok else np.float32(0))
            modified.append(False)
        remaining = np.float32(amount)
        while remaining > 0.0:
            amt = remaining
            deposited = np.float32(0.0)
            remaining = amt
            stop = False
            for rnd in range(1, radius + 1):
                if stop:
                    break
                level = vals[0] + np.float32(increment) * np.float32(rnd)
                for s, (_, dist) in enumerate(slots):
                    if dist >= rnd:
                        continue
                    if not valid[s] or not vals[s] < level:
                        continue
                    diff = np.float32(min(np.float32(increment), remaining))
                    vals[s] = np.float32(vals[s] + diff)
                    modified[s] = True
                    deposited = np.float32(deposited + diff)
                    remaining = np.float32(amt - deposited)
                    if remaining <= 0.0:
                        stop = True
                        break
                else:
                    continue
                break
            if stop:
                remaining = np.float32(0.0)
        for s in range(len(slots)):
            if valid[s] and modified[s]:
                height[pos[s]] = vals[s]
    return height


class TestExactPileSolver:
    def _height(self, res=24):
        rng = np.random.default_rng(21)
        return rng.uniform(0.1, 0.4, (res, res)).astype(np.float32)

    def test_single_pile_matches_reference_transcription(self):
        h = self._height()
        got = np.asarray(SE._handle_pile(
            jnp.asarray(h), jnp.int32(11), jnp.int32(12),
            jnp.float32(0.02), jnp.float32(0.001), 4))
        want = np_pile_solver(h, [(11, 12, 0.02)], 4, 0.001)
        np.testing.assert_array_equal(got, want)

    def test_border_pile_skips_out_of_bounds(self):
        h = self._height()
        got = np.asarray(SE._handle_pile(
            jnp.asarray(h), jnp.int32(1), jnp.int32(22),
            jnp.float32(0.015), jnp.float32(0.001), 4))
        want = np_pile_solver(h, [(1, 22, 0.015)], 4, 0.001)
        np.testing.assert_array_equal(got, want)

    def test_exact_deposit_orders_piles_by_cell_index(self):
        h = self._height()
        pile_map = np.zeros_like(h)
        pile_map[15, 4] = 0.012   # later cell index
        pile_map[6, 18] = 0.02    # earlier cell index → processed first
        params = ErosionParameters(PILING_RADIUS=4, EXACT_PILES=True,
                                   MIN_PILE_INCREMENT=1.0)
        got = np.asarray(SE.exact_pile_deposit(
            jnp.asarray(h), jnp.asarray(pile_map), params, 1000.0))
        want = np_pile_solver(
            h, [(6, 18, 0.02), (15, 4, 0.012)], 4, 1.0 / 1000.0)
        np.testing.assert_array_equal(got, want)

    def test_write_sediment_map_exact_mode(self):
        h = self._height()
        sed = np.zeros_like(h)
        sed[9, 9] = 0.004   # above PILE_THRESHOLD/HEIGHT = 0.002
        sed[3, 3] = 0.001   # dispersal path
        params = ErosionParameters(PILING_RADIUS=4, EXACT_PILES=True)
        out = np.asarray(SE.write_sediment_map(
            jnp.asarray(h), jnp.asarray(sed), params, 1000.0))
        assert out[9, 9] > h[9, 9]          # pile raised the center
        assert not np.array_equal(out, h)
        # tent-mode result differs (different profile) but both add mass
        tent = np.asarray(SE.write_sediment_map(
            jnp.asarray(h), jnp.asarray(sed),
            ErosionParameters(PILING_RADIUS=4), 1000.0))
        assert out.sum() > h.sum() and tent.sum() > h.sum()


class TestErosionCycle:
    def test_cycle_properties(self):
        res = 48
        h = hill(res, 0.6) + RNG.uniform(0, 0.05, (res, res)).astype(np.float32)
        es = ErosionSettings(PARTICLES_PER_CYCLE=128, MAXAGE=24, CYCLES=1,
                             WATER_STEPS=4, PILING_RADIUS=6)
        meta = TileSetMeta(tile_res=res, tile_size=res, generator_res=res,
                           height=1000, margin=0)
        state = init_state(jnp.asarray(h), jax.random.PRNGKey(3))
        s1 = erosion_cycle(state, es, meta)
        s2 = erosion_cycle(s1, es, meta)
        for name in ("height", "pool", "flow", "track"):
            arr = np.asarray(getattr(s2.world, name))
            assert np.all(np.isfinite(arr)), name
        assert float(np.abs(np.asarray(s2.world.height) - h).sum()) > 0
        assert float(np.asarray(s2.world.flow).sum()) > 0  # streams form
        assert np.all(np.asarray(s2.world.height) >= 0)
        assert np.all(np.asarray(s2.world.height) <= 1)

    def test_mode_only_flow_water_keeps_height(self):
        res = 32
        h = hill(res)
        es = ErosionSettings(BEHAVIOR=ErosionMode.ONLY_FLOW_WATER,
                             PARTICLES_PER_CYCLE=64, MAXAGE=8, WATER_STEPS=2)
        meta = TileSetMeta(tile_res=res, tile_size=res, generator_res=res,
                           height=1000, margin=0)
        out = erosion_cycle(init_state(jnp.asarray(h)), es, meta)
        np.testing.assert_array_equal(np.asarray(out.world.height), h)

    def test_settings_mode_gating(self):
        es = ErosionSettings(BEHAVIOR=ErosionMode.ONLY_THERMAL_EROSION)
        p = es.as_parameters()
        assert p.CAPACITY == 0.0
        assert p.POOL_PLACEMENT_MULTIPLIER == 0.0
        assert p.TERMINAL_VELOCITY == 1.0 / es.DRAG

    def test_tuned_params_match_static_and_skip_recompile(self):
        """The static/traced parameter split (params.TUNABLE_FIELDS):
        1. passing the tunables as traced scalars reproduces the static
           graph's results (same f32 ops; 1-ulp reassociation tolerated),
        2. live-tweaking any tunable float reuses the compiled cycle —
           the LiveErosion slider workflow must not recompile."""
        res = 48
        h = jnp.asarray(hill(res, 0.6)
                        + RNG.uniform(0, 0.05, (res, res)).astype(np.float32))
        meta = TileSetMeta(tile_res=res, tile_size=res, generator_res=res,
                           height=1000, margin=0)
        es = ErosionSettings(PARTICLES_PER_CYCLE=128, MAXAGE=16, CYCLES=1,
                             WATER_STEPS=4, PILING_RADIUS=4)
        st = erosion_cycle(init_state(h), es, meta)
        tu = erosion_cycle(init_state(h), es.canonical(), meta,
                           tuned=es.tunable_values())
        for name in ("height", "pool", "flow", "track"):
            np.testing.assert_allclose(
                np.asarray(getattr(st.world, name)),
                np.asarray(getattr(tu.world, name)),
                rtol=1e-6, atol=1e-9, err_msg=name)

        # sweeping tunables: same trace key, zero new compilations
        before = erosion_cycle._cache_size()
        for erosion, gravity in ((0.33, 1.7), (0.9, 0.4)):
            es2 = ErosionSettings(
                PARTICLES_PER_CYCLE=128, MAXAGE=16, CYCLES=1, WATER_STEPS=4,
                PILING_RADIUS=4, EROSION=erosion, GRAVITY=gravity,
                EVAP=0.02, DEPOSITION=0.2)
            out = erosion_cycle(init_state(h), es2.canonical(), meta,
                                tuned=es2.tunable_values())
            assert np.all(np.isfinite(np.asarray(out.world.height)))
        assert erosion_cycle._cache_size() == before
        # ...and the tweaked values actually take effect
        assert not np.array_equal(np.asarray(out.world.height),
                                  np.asarray(tu.world.height))

    def test_sim_driver_reset_and_save(self, tmp_path):
        from noize_tpu.core.store import PipelineStateManager

        res = 24
        sm = PipelineStateManager(str(tmp_path), "t", "1")
        es = ErosionSettings(PARTICLES_PER_CYCLE=32, MAXAGE=8, CYCLES=1,
                             WATER_STEPS=2, PILING_RADIUS=4)
        sim = ErosionSim(hill(res), settings=es, state_manager=sm)
        sim.step(2)
        assert sim.cycle_count == 2
        sim.save_erosion_state()
        h_saved = np.asarray(sim.height_map)
        sim.step(1)
        sim.reset_land()
        np.testing.assert_array_equal(np.asarray(sim.height_map), h_saved)
        # restore through a fresh manager
        sm2 = PipelineStateManager(str(tmp_path), "t", "1")
        restored = sm2.get_buffer(sim._buffer_name("TERRAIN_HEIGHT"))
        np.testing.assert_array_equal(np.asarray(restored), h_saved)


class TestContinuousMode:
    def test_trigger_update_state_machine(self):
        es = ErosionSettings(PARTICLES_PER_CYCLE=16, MAXAGE=4, CYCLES=1,
                             WATER_STEPS=1, PILING_RADIUS=4)
        sim = ErosionSim(hill(16), settings=es)
        assert sim.trigger() is True
        assert sim.trigger() is False  # already in flight
        # drive the frame loop until the batch lands
        import time as _t
        for _ in range(200):
            status = sim.update(continuous=False)
            if status == "completed":
                break
            _t.sleep(0.01)
        assert status == "completed"
        assert sim.cycle_count == 1
        # continuous mode immediately retriggers
        assert sim.update(continuous=True) == "triggered"
        sim._job.wait()


class TestHalfRowPhase:
    def test_matches_full_phase(self):
        res = 16
        height = RNG.uniform(0, 0.5, (res, res)).astype(np.float32)
        pool = RNG.uniform(0, 0.05, (res, res)).astype(np.float32)
        pool[pool < 0.02] = 0.0
        for xoff in (0, 1):
            for zoff in (0, 1):
                for dp in (True, False):
                    mask = PO._phase_mask(res, xoff, zoff)
                    wp, wd = PO._spread_phase(
                        jnp.asarray(height), jnp.asarray(pool), mask, dp)
                    gp, gd = PO._spread_phase_halfrow(
                        jnp.asarray(height), jnp.asarray(pool), xoff, zoff, dp)
                    np.testing.assert_allclose(
                        np.asarray(gp), np.asarray(wp), atol=1e-6,
                        err_msg=f"pool x{xoff} z{zoff} dp={dp}")
                    np.testing.assert_allclose(
                        np.asarray(gd), np.asarray(wd), atol=1e-6,
                        err_msg=f"drain x{xoff} z{zoff} dp={dp}")


def test_descend_table_layouts_bit_exact():
    """The two-map gather table ('wf': all-heights recomputed post-gather)
    must be bit-exact with the three-map layout ('waf')."""
    import dataclasses
    from noize_tpu.erosion import particles as PART
    from noize_tpu.erosion.world import WorldState
    from noize_tpu.erosion.params import ErosionSettings

    rng = np.random.default_rng(41)
    res = 48
    h = jnp.asarray(rng.uniform(0, 1, (res, res)).astype(np.float32))
    w = WorldState.create(h)
    w = dataclasses.replace(
        w,
        flow=jnp.asarray(rng.uniform(0, 1, (res, res)).astype(np.float32)),
        pool=jnp.asarray(
            (rng.uniform(-0.5, 0.2, (res, res))).clip(0).astype(np.float32)),
    )
    params = ErosionSettings(MAXAGE=24).as_parameters()
    parts = PART.spawn(jax.random.PRNGKey(1), 64, res)
    outs = {}
    for layout in ("waf", "wf"):
        p, t, pl, s = PART.descend_all(
            parts, w, params, 500.0, 1.0, res, table_layout=layout)
        outs[layout] = (np.asarray(p.row), np.asarray(p.vel), np.asarray(t),
                        np.asarray(pl), np.asarray(s))
    for a, b in zip(outs["waf"], outs["wf"]):
        np.testing.assert_array_equal(a, b)


def test_descend_scatter_modes_bit_exact():
    """Deferred single-scatter event reduction ('end') must equal the
    per-chunk scatter exactly (same per-cell f32 accumulation order)."""
    import dataclasses
    from noize_tpu.erosion import particles as PART
    from noize_tpu.erosion.world import WorldState
    from noize_tpu.erosion.params import ErosionSettings

    rng = np.random.default_rng(43)
    res = 48
    h = jnp.asarray(rng.uniform(0, 1, (res, res)).astype(np.float32))
    w = WorldState.create(h)
    w = dataclasses.replace(
        w, flow=jnp.asarray(rng.uniform(0, 1, (res, res)).astype(np.float32)))
    params = ErosionSettings(MAXAGE=24).as_parameters()
    parts = PART.spawn(jax.random.PRNGKey(3), 64, res)
    a = PART.descend_all(parts, w, params, 500.0, 1.0, res, scatter="chunk")
    b = PART.descend_all(parts, w, params, 500.0, 1.0, res, scatter="end")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_descend_compaction_bit_exact():
    """The alive-compaction cascade (N → N/2 → N/4 particle buffers) must
    be bit-exact with the fixed-width loop, including final particle
    states restored to their original slots."""
    import dataclasses
    from noize_tpu.erosion import particles as PART
    from noize_tpu.erosion.world import WorldState
    from noize_tpu.erosion.params import ErosionSettings

    rng = np.random.default_rng(47)
    res = 48
    h = jnp.asarray(rng.uniform(0, 1, (res, res)).astype(np.float32))
    w = WorldState.create(h)
    w = dataclasses.replace(
        w,
        pool=jnp.asarray(
            (rng.uniform(-0.3, 0.3, (res, res))).clip(0).astype(np.float32)),
        flow=jnp.asarray(rng.uniform(0, 1, (res, res)).astype(np.float32)),
    )
    params = ErosionSettings(MAXAGE=32).as_parameters()
    parts = PART.spawn(jax.random.PRNGKey(7), 256, res)
    a = PART.descend_all(parts, w, params, 500.0, 1.0, res, compact=False)
    b = PART.descend_all(parts, w, params, 500.0, 1.0, res, compact=True)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestGatedPoolBatchRule:
    """_gated_pool's custom_vmap rule: a batch-level wetness gate that
    skips all-dry batches bit-exactly (the vmapped serving path would
    otherwise pay the full pool kernel per cold-start tile — lax.cond
    degrades to select under vmap)."""

    def _mk(self, B=3, R=64):
        from noize_tpu.erosion.sim import _gated_pool

        k = jax.random.PRNGKey(0)
        h = jax.random.uniform(k, (B, R, R), jnp.float32)
        dry = jnp.full((B, R, R), 5e-4, jnp.float32)  # below MIN_WATER
        return _gated_pool(2, True), h, dry

    def test_unbatched_parity(self):
        vf, h, _ = self._mk()
        p = jax.random.uniform(jax.random.PRNGKey(1), h[0].shape,
                               jnp.float32) * 0.01
        a = vf(h[0], p)
        b = PO.pool_automata(h[0], p, iterations=2, drain_particles=True)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_all_dry_batch_is_identity(self):
        vf, h, dry = self._mk()
        po, dr = jax.jit(jax.vmap(vf))(h, dry)
        np.testing.assert_array_equal(np.asarray(po), np.asarray(dry))
        assert not np.any(np.asarray(dr))

    def test_mixed_batch_matches_stacked_singles(self):
        vf, h, dry = self._mk()
        wet = jax.random.uniform(jax.random.PRNGKey(1), h[0].shape,
                                 jnp.float32) * 0.01
        mixed = dry.at[1].set(wet)
        po, dr = jax.jit(jax.vmap(vf))(h, mixed)
        for i in range(h.shape[0]):
            rp, rd = PO.pool_automata(h[i], mixed[i], iterations=2,
                                      drain_particles=True)
            np.testing.assert_array_equal(np.asarray(po[i]), np.asarray(rp))
            np.testing.assert_array_equal(np.asarray(dr[i]), np.asarray(rd))

