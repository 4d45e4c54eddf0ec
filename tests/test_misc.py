"""Tests for the auxiliary surface: edge ops, vegetation, stats, tracking,
helpers."""

import logging

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from noize_tpu.ops import edge as E
from noize_tpu.ops import kernels as K
from noize_tpu.erosion import vegetation as VG
from noize_tpu.erosion.world import WorldState
from noize_tpu.utils import helpers as H
from noize_tpu.utils import stats as ST
from noize_tpu.utils import tracking as TR

RNG = np.random.default_rng(41)


class TestEdge:
    def test_sobel_matches_kernel_filter(self):
        a = jnp.asarray(RNG.uniform(0, 1, (24, 24)).astype(np.float32))
        np.testing.assert_allclose(
            np.asarray(E.edge_1d(a, "SOBEL", "HORIZONTAL")),
            np.asarray(K.kernel_filter(a, "Sobel3Horizontal")), atol=1e-7)
        np.testing.assert_allclose(
            np.asarray(E.edge_2d(a, "SOBEL")),
            np.asarray(K.sobel2d(a)), atol=1e-6)

    def test_prewitt(self):
        a = jnp.asarray(RNG.uniform(0, 1, (16, 16)).astype(np.float32))
        out = np.asarray(E.edge_2d(a, "PREWITT"))
        assert out.shape == a.shape and np.all(out >= 0)

    def test_bad_args(self):
        with pytest.raises(ValueError):
            E.edge_1d(jnp.zeros((4, 4)), "SCHARR", "HORIZONTAL")


class TestVegetation:
    def setup_method(self):
        res = 32
        x = np.linspace(-1, 1, res, dtype=np.float32)
        h = 0.3 * np.exp(-(x[:, None] ** 2 + x[None, :] ** 2))
        self.state = WorldState.create(jnp.asarray(h))

    def test_survival_gates(self):
        pt = VG.PlantType(max_pool_survival=0.01, max_stream_survival=0.5,
                          max_density=1.0, max_angle=1e9)
        ok = np.asarray(VG.can_survive(pt, self.state, 100.0, 1.0))
        assert ok.all()  # dry, no streams, zero density
        wet = WorldState(height=self.state.height,
                         pool=self.state.pool + 0.02,
                         flow=self.state.flow, track=self.state.track,
                         plants=self.state.plants)
        assert not np.asarray(VG.can_survive(pt, wet, 100.0, 1.0)).any()

    def test_root_and_splat(self):
        pt = VG.PlantType(max_angle=1e9)
        plants = VG.root_plants(jax.random.PRNGKey(0), pt, self.state, 16,
                                100.0, 1.0)
        assert bool(np.asarray(plants.alive).all())
        dens = VG.splat_density(self.state.plants, plants)
        d = np.asarray(dens)
        # total: 16 · (1 + 4·0.6 + 4·0.4) = 16·5 (minus any clamp overlaps)
        assert 16 * 4.0 <= d.sum() <= 16 * 5.0 + 1e-4
        assert d.max() >= 1.0

    def test_grow_kills_on_ground_change(self):
        pt = VG.PlantType(max_angle=1e9)
        plants = VG.root_plants(jax.random.PRNGKey(1), pt, self.state, 8,
                                100.0, 1.0)
        moved = WorldState(height=self.state.height + 0.5,
                           pool=self.state.pool, flow=self.state.flow,
                           track=self.state.track, plants=self.state.plants)
        out = VG.grow(plants, moved)
        assert not bool(np.asarray(out.alive).any())

    def _state_with(self, **kw):
        fields = dict(height=self.state.height, pool=self.state.pool,
                      flow=self.state.flow, track=self.state.track,
                      plants=self.state.plants)
        fields.update(kw)
        return WorldState(**fields)

    def test_grow_cycle_moisture_and_drought(self):
        pt = VG.PlantType(max_angle=1e9)
        plants = VG.root_plants(jax.random.PRNGKey(2), pt, self.state, 12,
                                100.0, 1.0)
        wet = self._state_with(track=jnp.ones_like(self.state.track))
        grown = VG.grow_cycle(jax.random.PRNGKey(3), plants, wet, pt,
                              100.0, 1.0)
        assert np.all(np.asarray(grown.growth)[np.asarray(grown.alive)]
                      >= np.asarray(plants.growth)[np.asarray(grown.alive)])
        # drought: growth 20 − 4/cycle → dead within 5 cycles
        dry = self.state
        p = plants
        for i in range(6):
            p = VG.grow_cycle(jax.random.PRNGKey(10 + i), p, dry, pt,
                              100.0, 1.0)
        assert not bool(np.asarray(p.alive).any())

    def test_grow_cycle_drowns_in_pools(self):
        pt = VG.PlantType(max_angle=1e9, max_pool_survival=1e-4)
        plants = VG.root_plants(jax.random.PRNGKey(4), pt, self.state, 8,
                                100.0, 1.0)
        flooded = self._state_with(pool=self.state.pool + 0.01)
        out = VG.grow_cycle(jax.random.PRNGKey(5), plants, flooded, pt,
                            100.0, 1.0)
        assert not bool(np.asarray(out.alive).any())

    def test_grow_cycle_reproduces_near_mature(self):
        pt = VG.PlantType(max_angle=1e9, spawn_range=2.0, max_density=10.0)
        plants = VG.root_plants(jax.random.PRNGKey(6), pt, self.state, 32,
                                100.0, 1.0)
        # kill half the slots, make survivors mature, keep ground moist
        alive0 = np.asarray(plants.alive).copy()
        alive0[: 16] = False
        plants = plants._replace(
            alive=jnp.asarray(alive0),
            growth=jnp.full_like(plants.growth, 90),
        )
        wet = self._state_with(track=jnp.ones_like(self.state.track))
        out = VG.grow_cycle(jax.random.PRNGKey(7), plants, wet, pt,
                            100.0, 1.0)
        n_before = int(alive0.sum())
        n_after = int(np.asarray(out.alive).sum())
        assert n_after > n_before  # seedlings rooted in freed slots
        seeded = np.asarray(out.alive) & ~alive0
        assert np.all(np.asarray(out.growth)[seeded] == 20)
        # seedlings land within spawn_range (Chebyshev) of some survivor
        sr = np.asarray(out.row)[seeded][:, None]
        sc = np.asarray(out.col)[seeded][:, None]
        pr = np.asarray(plants.row)[alive0][None, :]
        pc = np.asarray(plants.col)[alive0][None, :]
        cheb = np.maximum(np.abs(sr - pr), np.abs(sc - pc))
        assert np.all(cheb.min(axis=1) <= 2)

    def test_density_map_scales_with_growth(self):
        pt = VG.PlantType(max_angle=1e9, density_modifier=2.0)
        plants = VG.root_plants(jax.random.PRNGKey(8), pt, self.state, 4,
                                100.0, 1.0)
        full = VG.density_map((32, 32), plants._replace(
            growth=jnp.full_like(plants.growth, 100)), pt)
        half = VG.density_map((32, 32), plants._replace(
            growth=jnp.full_like(plants.growth, 50)), pt)
        np.testing.assert_allclose(np.asarray(half) * 2.0, np.asarray(full),
                                   atol=1e-6)

    def test_vegetation_friction_slows_particles(self):
        """VEGETATION_FRICTION > 0: dense cover increases effective
        friction, so particles travel less far down the same slope."""
        from noize_tpu.erosion import particles as P
        from noize_tpu.erosion.params import ErosionParameters

        res = 64
        z = np.tile(np.linspace(1.0, 0.0, res, dtype=np.float32), (res, 1))
        dense = WorldState(
            height=jnp.asarray(z), pool=jnp.zeros((res, res)),
            flow=jnp.zeros((res, res)), track=jnp.zeros((res, res)),
            plants=jnp.full((res, res), 2.0),
        )
        parts = P.spawn(jax.random.PRNGKey(9), 64, res)
        base = ErosionParameters(MAXAGE=16, FRICTION=0.05)
        veg = ErosionParameters(MAXAGE=16, FRICTION=0.05,
                                VEGETATION_FRICTION=5.0)
        out_b = P.descend_all(parts, dense, base, 1000.0, 1.0, res)
        out_v = P.descend_all(parts, dense, veg, 1000.0, 1.0, res)
        # particles advance one cell per step either way; friction acts on
        # velocity → carry capacity → erosion.  Rooted ground erodes less.
        sed_b = np.asarray(out_b[3])
        sed_v = np.asarray(out_v[3])
        eroded_b = -sed_b.clip(max=0).sum()
        eroded_v = -sed_v.clip(max=0).sum()
        assert eroded_v < eroded_b
        assert not np.array_equal(sed_v, sed_b)


class TestStats:
    def test_regression_parity(self):
        xs = jnp.asarray(RNG.uniform(1, 10, 64).astype(np.float32))
        ys = 2.0 + 3.0 * jnp.log(xs)
        b1, b2 = ST.fit_log(xs, ys)
        np.testing.assert_allclose(float(b1), 2.0, atol=1e-3)
        np.testing.assert_allclose(float(b2), 3.0, atol=1e-3)
        np.testing.assert_allclose(
            float(ST.mean_square_error(ST.predict_log(xs, b1, b2), ys)),
            0.0, atol=1e-5)

    def test_basic(self):
        a = jnp.asarray([1.0, 2.0, 3.0])
        assert float(ST.mean(a)) == 2.0
        assert float(ST.sum_square_difference(a)) == 2.0


class TestTracking:
    def test_job_handler(self):
        h = TR.StandAloneJobHandler()
        assert not h.job_complete()
        out = jax.jit(lambda x: x * 2)(jnp.arange(1000.0))
        h.track_job(out)
        jax.block_until_ready(out)
        assert h.job_complete()
        assert h.close_job()
        assert not h.is_running

    def test_array_stats(self, caplog):
        a = np.array([1.0, np.nan, 3.0])
        with caplog.at_level(logging.WARNING, logger="noize_tpu"):
            s = TR.array_stats("t", a)
        assert s["nonfinite"] == 1 and s["min"] == 1.0 and s["max"] == 3.0
        assert any("non-finite" in r.message for r in caplog.records)

    def test_stage_timer_logs(self, caplog):
        with caplog.at_level(logging.INFO, logger="noize_tpu"):
            with TR.stage_timer("demo"):
                pass
        assert any("scheduled in" in r.message for r in caplog.records)


class TestHelpers:
    def test_fill(self):
        a = np.zeros(10)
        H.fill(a, 6, 3.0)
        assert a[:6].sum() == 18.0 and a[6:].sum() == 0.0

    def test_copy_props_dataclass(self):
        from noize_tpu.erosion.params import ErosionSettings

        src = ErosionSettings(CYCLES=9, EVAP=0.5)
        dst = H.copy_props(src, ErosionSettings())
        assert dst.CYCLES == 9 and dst.EVAP == 0.5

    def test_copy_props_plain(self):
        class A:
            pass

        a, b = A(), A()
        a.x = 1
        b.x = 0
        b.y = 5
        out = H.copy_props(a, b)
        assert out.x == 1 and out.y == 5


def test_stage_cost_analysis():
    """stage_cost reports flops/bytes for a jitted stage (SURVEY §5
    tracing)."""
    import jax.numpy as jnp
    from noize_tpu.utils.tracking import stage_cost
    from noize_tpu.ops import kernels as K

    c = stage_cost(lambda a: K.sobel2d(a), jnp.ones((64, 64), jnp.float32))
    assert c["flops"] > 0
    assert c["bytes_accessed"] > 0
    assert c["arithmetic_intensity"] > 0


def test_device_trace_produces_profile(tmp_path):
    """device_trace captures a real jax.profiler trace (SURVEY §5 tracing
    row): running a small jitted pipeline inside the context must leave a
    non-empty trace directory (on the CPU backend here)."""
    import os

    outdir = str(tmp_path / "trace")
    a = jnp.asarray(RNG.uniform(0, 1, (64, 64)).astype(np.float32))
    with TR.device_trace(outdir):
        out = jax.jit(lambda x: K.sobel2d(K.value_erosion(x)))(a)
        jax.block_until_ready(out)
    files = [os.path.join(r, f) for r, _, fs in os.walk(outdir) for f in fs]
    assert files, "profiler trace directory is empty"
    assert any(f.endswith((".pb", ".json.gz", ".trace.json.gz", ".xplane.pb"))
               for f in files), files
