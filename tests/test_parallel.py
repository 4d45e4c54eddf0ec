"""Multi-device tests on the virtual 8-device CPU mesh: halo-exchange
stencils must equal their single-device counterparts exactly; tile batches
must agree at seams."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from noize_tpu.parallel import device_mesh as DM
from noize_tpu.parallel import sharded_ops as SO
from noize_tpu.parallel import tiled as TL
from noize_tpu.ops import kernels as K
from noize_tpu.ops import blur as B
from noize_tpu.ops import flow as FL
from noize_tpu.ops import fractal as FR
from noize_tpu.core.tiles import TileSetMeta

RNG = np.random.default_rng(3)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "tests require the 8-device CPU mesh"
    return DM.spatial_mesh()


def sharded_field(mesh, res=64):
    a = RNG.uniform(0, 1, (res, res)).astype(np.float32)
    return a, jax.device_put(jnp.asarray(a), DM.field_sharding(mesh))


class TestMesh:
    def test_split(self):
        assert DM._split2(8) == (4, 2)
        assert DM._split2(4) == (2, 2)
        assert DM._split2(1) == (1, 1)

    def test_spatial_mesh_axes(self, mesh):
        assert mesh.shape["x"] * mesh.shape["y"] == 8


class TestShardedStencils:
    def test_gauss_matches_local(self, mesh):
        a, ash = sharded_field(mesh)
        got = np.asarray(SO.sharded_gauss_blur(mesh, ash, 5, 1.0, iterations=3))
        want = np.asarray(B.gauss_blur(B.gauss_blur(B.gauss_blur(
            jnp.asarray(a), 5, 1.0), 5, 1.0), 5, 1.0))
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_gauss_17_iterations_multi_group(self, mesh):
        """17 iterations at small blocks force multiple halo-exchange
        groups (k iterations per exchange) — the grouped path must match
        the single-device chain."""
        a, ash = sharded_field(mesh, 32)
        got = np.asarray(SO.sharded_gauss_blur(mesh, ash, 5, 1.0,
                                               iterations=17))
        want = jnp.asarray(a)
        for _ in range(17):
            want = B.gauss_blur(want, 5, 1.0)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)

    def test_kernel_filter_matches_local(self, mesh):
        a, ash = sharded_field(mesh)
        got = np.asarray(SO.sharded_kernel_filter(mesh, ash, "Smooth3", 2))
        want = np.asarray(K.kernel_filter(jnp.asarray(a), "Smooth3", 2))
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_sobel2d_matches_local(self, mesh):
        a, ash = sharded_field(mesh)
        got = np.asarray(SO.sharded_kernel_filter(mesh, ash, "Sobel3_2D"))
        want = np.asarray(K.sobel2d(jnp.asarray(a)))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_flow_map_matches_local(self, mesh):
        a, ash = sharded_field(mesh, 32)
        got = np.asarray(SO.sharded_flow_map(mesh, ash, iterations=6))
        want = np.asarray(FL.flow_map(jnp.asarray(a), iterations=6))
        np.testing.assert_allclose(got, want, atol=1e-5)

    def test_fractal_matches_local(self, mesh):
        got = np.asarray(SO.sharded_fractal(
            mesh, 64, 128.0, 256.0,
            noise_type="Simplex", octaves=5, hurst=0.4, noise_size=170.0,
        ))
        want = np.asarray(FR.fractal(
            64, 128, 256,
            noise_type="Simplex", octaves=5, hurst=0.4, noise_size=170.0,
        ))
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestTileBatch:
    def test_batch_matches_single(self):
        meta = TileSetMeta(tile_res=24, tile_size=24, generator_res=32,
                           height=100, margin=2)
        cfg = TL.TilePipelineConfig(
            meta=meta, noise_type="Perlin", octaves=3, noise_size=100.0,
            blur_iterations=2, blur_width=5,
        )
        origins = TL.grid_origins(meta, 2, 2)
        batched = np.asarray(TL.tile_batch(cfg, origins))
        single = np.asarray(jax.jit(
            lambda: TL.generate_tile(cfg, float(origins[3, 0]),
                                     float(origins[3, 1]),
                                     jax.random.PRNGKey(0))
        )())
        np.testing.assert_allclose(batched[3], single, atol=1e-6)

    def test_sharded_batch(self):
        bmesh = DM.batch_mesh()
        meta = TileSetMeta(tile_res=16, tile_size=16, generator_res=16,
                           height=100, margin=0)
        cfg = TL.TilePipelineConfig(
            meta=meta, noise_type="Perlin", octaves=2, noise_size=50.0,
            blur_iterations=1,
        )
        origins = TL.grid_origins(meta, 4, 2)  # 8 tiles over 8 devices
        out = TL.tile_batch(cfg, origins, mesh=bmesh)
        assert out.shape == (8, 16, 16)
        got = np.asarray(out)
        want = np.asarray(TL.tile_batch(cfg, origins))  # unsharded
        np.testing.assert_allclose(got, want, atol=1e-6)

    def test_batch_mesh_emission_matches_single(self):
        """emit_mesh batches per-tile MeshPlanes vertex streams; each
        tile's planes equal the single-tile mesher on its heights."""
        from noize_tpu.ops import mesh as MH

        meta = TileSetMeta(tile_res=24, tile_size=24, generator_res=32,
                           height=100, margin=4)
        cfg = TL.TilePipelineConfig(
            meta=meta, noise_type="Perlin", octaves=3, noise_size=100.0,
            blur_iterations=1, emit_mesh=True,
        )
        origins = TL.grid_origins(meta, 2, 1)
        out = TL.tile_batch(cfg, origins)
        assert out["height"].shape == (2, 32, 32)
        assert out["mesh_planes"].shape == (2, 12, 25, 25)
        want = MH.heightmap_mesh_overshoot_planes(
            out["height"][1], 24, 32, 100.0, 24.0)
        got = np.asarray(out["mesh_planes"][1])
        np.testing.assert_allclose(got, np.asarray(want.planes), rtol=5e-7)
        # sharded batch carries the mesh channel too
        bmesh = DM.batch_mesh()
        origins8 = TL.grid_origins(meta, 4, 2)
        out8 = TL.tile_batch(cfg, origins8, mesh=bmesh)
        assert out8["mesh_planes"].shape == (8, 12, 25, 25)
        np.testing.assert_allclose(
            np.asarray(out8["mesh_planes"][1]), got, rtol=5e-7)

    def test_batch_with_erosion_matches_single(self):
        """The hybrid batch (vmapped fields + lax.map'd erosion) reproduces the solo generate_tile per tile,
        on one device and sharded over the batch mesh."""
        from noize_tpu.erosion.params import ErosionSettings

        meta = TileSetMeta(tile_res=24, tile_size=24, generator_res=32,
                           height=100, margin=2)
        es = ErosionSettings(PARTICLES_PER_CYCLE=16, MAXAGE=8,
                             WATER_STEPS=1, CYCLES=1, PILING_RADIUS=4)
        cfg = TL.TilePipelineConfig(
            meta=meta, noise_type="Perlin", octaves=2, noise_size=80.0,
            blur_iterations=1, erosion=es, erosion_cycles=1,
        )
        origins = TL.grid_origins(meta, 4, 2)
        batched = np.asarray(TL.tile_batch(cfg, origins, seed=3))
        base = jax.random.PRNGKey(3)
        for i in (0, 5):
            key = jax.random.fold_in(
                jax.random.fold_in(base, int(origins[i, 0])),
                int(origins[i, 1]))
            single = np.asarray(jax.jit(
                lambda k: TL.generate_tile(cfg, float(origins[i, 0]),
                                           float(origins[i, 1]), k)
            )(key))
            np.testing.assert_allclose(batched[i], single, atol=1e-6)
        # the sharded dp path (shard_map of the same local hybrid) agrees
        bmesh = DM.batch_mesh()
        out8 = np.asarray(TL.tile_batch(cfg, origins, mesh=bmesh, seed=3))
        np.testing.assert_allclose(out8, batched, atol=1e-6)
        # whole tiles per device: a non-divisible batch is an error
        with pytest.raises(ValueError, match="divide"):
            TL.tile_batch(cfg, origins[:3], mesh=bmesh)

    def test_tiles_seamless_with_margin(self):
        """Adjacent tiles generated independently agree on their overlap —
        the reference's margin-consistency contract."""
        meta = TileSetMeta(tile_res=32, tile_size=32, generator_res=40,
                           height=100, margin=4)
        cfg = TL.TilePipelineConfig(
            meta=meta, noise_type="Simplex", octaves=4, noise_size=90.0,
            blur_iterations=0,
        )
        origins = np.asarray([[0, 0], [32, 0]], np.int32)
        tiles = np.asarray(TL.tile_batch(cfg, origins))
        # tile B's window starts 32 cells right of tile A's: overlap is 8
        np.testing.assert_allclose(
            tiles[0][:, 32:], tiles[1][:, :8], atol=1e-6
        )


class TestShardedThermal:
    def test_masked_phase_matches_sliced(self):
        from noize_tpu.ops import thermal as T
        import jax.numpy as jnp

        res = 20
        a = RNG.uniform(0, 2, (res, res)).astype(np.float32)
        for (x0, z0) in T._PHASE_OFFSETS:
            want = np.asarray(T._phase(jnp.asarray(a), x0, z0, 0.01, 0.5))
            got = np.asarray(T.thermal_phase_masked(
                jnp.asarray(a), x0, z0, 0, 0, res, 0.01, 0.5))
            np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f"{x0},{z0}")

    def test_sharded_matches_local(self, mesh):
        from noize_tpu.ops import thermal as T
        from noize_tpu.parallel import sharded_ops as SO2
        import jax.numpy as jnp

        a, ash = sharded_field(mesh, 32)
        got = np.asarray(SO2.sharded_thermal_erosion(mesh, ash, 45.0, 0.5, 1.0,
                                                     iterations=2))
        want = np.asarray(T.thermal_erosion(jnp.asarray(a), 45.0, 0.5, 1.0,
                                            iterations=2))
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestShardedStencilLifter:
    def test_generic_stencil_matches_local(self, mesh):
        from noize_tpu.parallel.halo import sharded_stencil
        from noize_tpu.ops import kernels as K2
        import jax.numpy as jnp

        taps = K2.gaussian_taps(2.0, 9)
        fn = sharded_stencil(
            lambda ext: K2.separable_series(ext, taps, taps, 1.0),
            halo=4, mesh=mesh,
        )
        a, ash = sharded_field(mesh, 64)
        got = np.asarray(fn(ash))
        want = np.asarray(K2.separable_series(jnp.asarray(a), taps, taps, 1.0))
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestTileDeterminism:
    def test_tile_pure_function_of_origin_and_seed(self):
        """The same tile re-requested in a DIFFERENT batch (different slot,
        different companions) reproduces bit-identically — per-tile PRNG
        keys derive from world position, not batch index (ADVICE r1)."""
        from noize_tpu.erosion.params import ErosionSettings

        meta = TileSetMeta(tile_res=24, tile_size=24, generator_res=32,
                           height=100, margin=4)
        cfg = TL.TilePipelineConfig(
            meta=meta, noise_type="Perlin", octaves=3, noise_size=100.0,
            blur_iterations=1, blur_width=5,
            erosion=ErosionSettings(PARTICLES_PER_CYCLE=16, MAXAGE=4,
                                    WATER_STEPS=2, CYCLES=1,
                                    PILING_RADIUS=4),
            erosion_cycles=1,
        )
        origins = TL.grid_origins(meta, 2, 2)
        a = np.asarray(TL.tile_batch(cfg, origins, seed=7))
        # tile 3 moved to slot 0, batch now holds different companions
        reordered = np.concatenate([origins[3:4], origins[1:3]])
        b = np.asarray(TL.tile_batch(cfg, reordered, seed=7))
        np.testing.assert_array_equal(a[3], b[0])
        # different seed still changes the content
        c = np.asarray(TL.tile_batch(cfg, reordered, seed=8))
        assert not np.array_equal(b[0], c[0])

    def test_negative_origins(self):
        meta = TileSetMeta(tile_res=16, tile_size=16, generator_res=16,
                           height=100, margin=0)
        cfg = TL.TilePipelineConfig(
            meta=meta, noise_type="Perlin", octaves=2, noise_size=50.0,
            blur_iterations=1,
        )
        neg = np.asarray([[-32, -16], [16, -48]], np.int32)
        out = np.asarray(TL.tile_batch(cfg, neg, seed=3))
        assert np.isfinite(out).all()


class TestShardedErosionCycle:
    """The full sharded erosion cycle vs the single-device cycle.

    Everything except descent event sums is bit-exact; descent scatter
    reassociates across shard boundaries (documented D8), so maps compare
    with a tiny tolerance and the spawn/pool stages exactly."""

    def _setup(self, res=32, seed=6):
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.erosion.sim import init_state

        rng = np.random.default_rng(seed)
        h = rng.uniform(0.2, 0.8, (res, res)).astype(np.float32)
        settings = ErosionSettings(
            PARTICLES_PER_CYCLE=48, MAXAGE=12, WATER_STEPS=3, CYCLES=1,
            PILING_RADIUS=4,
        )
        meta = TileSetMeta(tile_res=res, tile_size=res, generator_res=res,
                           height=500, margin=0)
        state = init_state(jnp.asarray(h), jax.random.PRNGKey(9))
        return state, settings, meta

    def _shard_state(self, mesh, state):
        from noize_tpu.erosion.sim import SimState
        from dataclasses import replace as drep

        sh = DM.field_sharding(mesh)
        put = lambda a: jax.device_put(a, sh)
        w = state.world
        world = type(w)(height=put(w.height), pool=put(w.pool),
                        flow=put(w.flow), track=put(w.track),
                        plants=put(w.plants))
        return SimState(world=world, drain_water=put(state.drain_water),
                        key=state.key)

    def test_cycle_matches_single_device(self, mesh):
        from noize_tpu.erosion.sim import erosion_cycle
        from noize_tpu.parallel.sharded_erosion import sharded_erosion_cycle

        state, settings, meta = self._setup()
        want = erosion_cycle(state, settings, meta)

        got = sharded_erosion_cycle(
            mesh, self._shard_state(mesh, state), settings, meta, chunk=4)

        for name in ("height", "pool", "flow", "track"):
            g = np.asarray(getattr(got.world, name))
            w_ = np.asarray(getattr(want.world, name))
            np.testing.assert_allclose(g, w_, atol=2e-6, err_msg=name)
        np.testing.assert_allclose(
            np.asarray(got.drain_water), np.asarray(want.drain_water),
            atol=2e-6)
        # PRNG keys advance identically
        assert np.array_equal(np.asarray(got.key), np.asarray(want.key))

    def test_two_cycles_with_drain_respawn(self, mesh):
        """Cycle 2 exercises the drain top-K respawn path across shards."""
        from noize_tpu.erosion.sim import erosion_cycle
        from noize_tpu.parallel.sharded_erosion import sharded_erosion_cycle

        state, settings, meta = self._setup(seed=13)
        want = erosion_cycle(state, settings, meta)
        want = erosion_cycle(want, settings, meta)

        got = self._shard_state(mesh, state)
        got = sharded_erosion_cycle(mesh, got, settings, meta, chunk=4)
        got = sharded_erosion_cycle(mesh, got, settings, meta, chunk=4)

        for name in ("height", "pool", "flow"):
            g = np.asarray(getattr(got.world, name))
            w_ = np.asarray(getattr(want.world, name))
            np.testing.assert_allclose(g, w_, atol=5e-6, err_msg=name)

    def test_sharded_pool_automata_bit_exact(self, mesh):
        from noize_tpu.erosion import pool as PO
        from noize_tpu.parallel.sharded_erosion import _sharded_pool_automata

        res = 32
        rng = np.random.default_rng(17)
        h = rng.uniform(0, 1, (res, res)).astype(np.float32)
        p = (rng.uniform(-0.3, 0.1, (res, res))).clip(0).astype(np.float32)
        want_p, want_d = PO.pool_automata(
            jnp.asarray(h), jnp.asarray(p), iterations=3)
        sh = DM.field_sharding(mesh)
        got_p, got_d = _sharded_pool_automata(
            mesh, jax.device_put(jnp.asarray(h), sh),
            jax.device_put(jnp.asarray(p), sh), res, 3, True)
        np.testing.assert_array_equal(np.asarray(got_p), np.asarray(want_p))
        np.testing.assert_array_equal(np.asarray(got_d), np.asarray(want_d))

    def test_sharded_sediment_bit_exact(self, mesh):
        from noize_tpu.erosion.sediment import write_sediment_map
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.parallel.sharded_erosion import _sharded_write_sediment

        res = 32
        rng = np.random.default_rng(19)
        h = rng.uniform(0.3, 0.7, (res, res)).astype(np.float32)
        sed = (rng.uniform(-0.01, 0.012, (res, res))).astype(np.float32)
        sed[5, 7] = 0.5  # force a pile
        params = ErosionSettings(PILING_RADIUS=4).as_parameters()
        want = write_sediment_map(jnp.asarray(h), jnp.asarray(sed),
                                  params, 500.0)
        sh = DM.field_sharding(mesh)
        got = _sharded_write_sediment(
            mesh, jax.device_put(jnp.asarray(h), sh),
            jax.device_put(jnp.asarray(sed), sh), params, 500.0)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_sharded_tile_step_matches_flagship(self, mesh):
        """sharded_tile_step (noise→blur→flow→erosion on the sharded field)
        equals the single-device flagship composition within D8 tolerance."""
        from noize_tpu.app.flagship import make_tile_step
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.parallel.sharded_erosion import sharded_tile_step

        res = 32
        meta = TileSetMeta(tile_res=res, tile_size=res, generator_res=res,
                           height=500, margin=0)
        st = ErosionSettings(PARTICLES_PER_CYCLE=24, MAXAGE=6, WATER_STEPS=2,
                             CYCLES=1, PILING_RADIUS=4)
        state, fv = sharded_tile_step(
            mesh, meta, st, 0.0, 0.0, jax.random.PRNGKey(0),
            octaves=3, blur_iterations=2, flow_iterations=2, chunk=4)
        step, _, _ = make_tile_step(
            meta, st, octaves=3, blur_iterations=2, flow_iterations=2,
            erosion_cycles=1, emit_mesh=False)
        out = step(np.float32(0.0), np.float32(0.0), jax.random.PRNGKey(0))
        np.testing.assert_allclose(
            np.asarray(state.world.height), np.asarray(out["height"]),
            atol=5e-6)
        np.testing.assert_allclose(
            np.asarray(fv), np.asarray(out["flow_velocity"]), atol=1e-5)

    def test_sharded_sim_driver(self, mesh):
        """ShardedErosionSim mirrors the ErosionSim surface."""
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.parallel.sharded_erosion import ShardedErosionSim

        rng = np.random.default_rng(23)
        h = rng.uniform(0.2, 0.8, (32, 32)).astype(np.float32)
        sim = ShardedErosionSim(
            mesh, h,
            settings=ErosionSettings(PARTICLES_PER_CYCLE=16, MAXAGE=4,
                                     WATER_STEPS=2, CYCLES=1,
                                     PILING_RADIUS=4),
            chunk=4)
        sim.step(1)
        assert np.isfinite(np.asarray(sim.height_map)).all()
        assert sim.cycle_count == 1
        # steady-state steps AND live retunes reuse the compiled cycle —
        # input shardings (incl. the replicated key) must already match
        # the jit's output shardings after step 1
        from dataclasses import replace as drep
        from noize_tpu.parallel.sharded_erosion import sharded_erosion_cycle
        before = sharded_erosion_cycle._cache_size()
        sim.step(1)
        sim.settings = drep(sim.settings, EROSION=0.5, GRAVITY=1.3)
        sim.step(1)
        assert sharded_erosion_cycle._cache_size() == before
        sim.reset_water()
        assert float(np.asarray(sim.pool_map).sum()) == 0.0
        sim.reset_land()
        np.testing.assert_array_equal(
            np.asarray(sim.height_map), h)

    def test_tuned_params_match_static_and_skip_recompile(self, mesh):
        """The static/traced parameter split on the SHARDED cycle
        (mirrors tests/test_erosion.py's single-device version): traced
        tunables reproduce the static graph's results, and live slider
        retunes between cycles reuse the ONE compiled XLA program."""
        from dataclasses import replace as drep
        from noize_tpu.parallel.sharded_erosion import sharded_erosion_cycle

        state, settings, meta = self._setup(seed=31)
        sst = self._shard_state(mesh, state)
        st = sharded_erosion_cycle(mesh, sst, settings, meta, chunk=4)
        tu = sharded_erosion_cycle(mesh, sst, settings.canonical(), meta,
                                   chunk=4, tuned=settings.tunable_values())
        for name in ("height", "pool", "flow", "track"):
            np.testing.assert_allclose(
                np.asarray(getattr(st.world, name)),
                np.asarray(getattr(tu.world, name)),
                rtol=1e-6, atol=1e-9, err_msg=name)

        # sweeping tunables: same trace key, zero new compilations
        before = sharded_erosion_cycle._cache_size()
        for erosion, gravity in ((0.33, 1.7), (0.9, 0.4)):
            es2 = drep(settings, EROSION=erosion, GRAVITY=gravity,
                       EVAP=0.02, DEPOSITION=0.2)
            out = sharded_erosion_cycle(mesh, sst, es2.canonical(), meta,
                                        chunk=4, tuned=es2.tunable_values())
            assert np.all(np.isfinite(np.asarray(out.world.height)))
        assert sharded_erosion_cycle._cache_size() == before
        # ...and the tweaked values actually take effect
        assert not np.array_equal(np.asarray(out.world.height),
                                  np.asarray(tu.world.height))

    def test_make_sharded_tile_step_one_program(self, mesh):
        """make_sharded_tile_step compiles the whole sharded flagship
        chain (noise→blur→flow→cycle) into one jitted program whose
        outputs match the eager composition."""
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.parallel.sharded_erosion import (
            make_sharded_tile_step, sharded_tile_step)

        res = 32
        meta = TileSetMeta(tile_res=res, tile_size=res, generator_res=res,
                           height=500, margin=0)
        st = ErosionSettings(PARTICLES_PER_CYCLE=24, MAXAGE=6, WATER_STEPS=2,
                             CYCLES=1, PILING_RADIUS=4)
        kwargs = dict(octaves=3, blur_iterations=2, flow_iterations=2,
                      chunk=4)
        step, _, _ = make_sharded_tile_step(mesh, meta, st, **kwargs)
        state, fv = step(np.float32(0.0), np.float32(0.0),
                         jax.random.PRNGKey(0))
        want_state, want_fv = sharded_tile_step(
            mesh, meta, st, 0.0, 0.0, jax.random.PRNGKey(0), **kwargs)
        np.testing.assert_allclose(
            np.asarray(state.world.height),
            np.asarray(want_state.world.height), atol=5e-6)
        np.testing.assert_allclose(np.asarray(fv), np.asarray(want_fv),
                                   atol=1e-5)


class TestShardedCheckpointFormat:
    def test_roundtrip_layout_and_replicated(self, mesh, tmp_path):
        """Per-shard checkpoint format: one .data file per distinct global
        block, bit-exact round-trip for both P('x','y') fields and
        replicated arrays (parallel.sharded_checkpoint)."""
        import os
        from jax.sharding import NamedSharding, PartitionSpec as P
        from noize_tpu.parallel.sharded_checkpoint import ShardedCheckpoint

        a = RNG.uniform(0, 1, (32, 32)).astype(np.float32)
        sh = DM.field_sharding(mesh)
        arr = jax.device_put(jnp.asarray(a), sh)
        ck = ShardedCheckpoint(str(tmp_path))
        ck.save("0_0__32__TERRAIN_HEIGHT", arr)
        ck.flush()
        assert ck.exists("0_0__32__TERRAIN_HEIGHT")
        back = ck.load("0_0__32__TERRAIN_HEIGHT", sh)
        np.testing.assert_array_equal(np.asarray(back), a)
        assert back.sharding.is_equivalent_to(sh, 2)
        datadir = os.path.join(str(tmp_path), "save__proc0_0", "data")
        files = [f for f in os.listdir(datadir) if f.endswith(".data")]
        assert len(files) == 8  # one block per device on the 8-dev mesh

        rep = NamedSharding(mesh, P())
        k = jax.device_put(np.arange(4, dtype=np.uint32), rep)
        ck.save("key", k)
        kb = ck.load("key", rep)
        np.testing.assert_array_equal(
            np.asarray(kb), np.arange(4, dtype=np.uint32))
        # replicated array = ONE distinct block on disk
        kfiles = [f for f in os.listdir(datadir) if f.startswith("key")]
        assert len(kfiles) == 1

    def test_topology_mismatch_raises(self, mesh, tmp_path):
        from jax.sharding import NamedSharding, PartitionSpec as P
        from noize_tpu.parallel.sharded_checkpoint import ShardedCheckpoint

        a = RNG.uniform(0, 1, (32, 32)).astype(np.float32)
        ck = ShardedCheckpoint(str(tmp_path))
        ck.save("m", jax.device_put(jnp.asarray(a), DM.field_sharding(mesh)))
        row_sh = NamedSharding(mesh, P(("x", "y"), None))  # different blocks
        with pytest.raises(IOError, match="topology"):
            ck.load("m", row_sh)


class TestShardedMesh:
    @pytest.mark.parametrize("margin", [0, 8])
    @pytest.mark.parametrize("variant", ["overshoot", "square"])
    def test_vertices_bit_exact(self, mesh, margin, variant):
        """Sharded per-shard mesh emission equals the single-device grid
        generators bit-for-bit (shared vertex_fields elementwise core +
        halo-clamp == edge-pad taps)."""
        from noize_tpu.ops import mesh as MH
        from noize_tpu.parallel import sharded_mesh as SM

        inp = 64
        r = inp - 2 * margin
        a, ash = sharded_field(mesh, inp)
        fields = SM.sharded_heightmap_mesh(
            mesh, ash, r, inp, 500.0, float(r), variant=variant)
        got = SM.mesh_arrays_from_fields(
            fields, r, inp, (mesh.shape["x"], mesh.shape["y"]))
        fn = (MH.heightmap_mesh_overshoot if variant == "overshoot"
              else MH.heightmap_mesh)
        want = fn(jnp.asarray(a), r, inp, 500.0, float(r))
        for name in ("positions", "normals", "tangents", "uvs"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)),
                np.asarray(getattr(want, name)), err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(got.indices), np.asarray(want.indices))

    @pytest.mark.parametrize("margin", [0, 8])
    def test_planes_layout_matches_single_device(self, mesh, margin):
        """layout='planes' sharded emission matches the single-device
        MeshPlanes path (exact except the normals' sqrt/divide chain —
        a few ulp per-program fusion, same caveat as the single-device
        layouts)."""
        from noize_tpu.ops import mesh as MH
        from noize_tpu.parallel import sharded_mesh as SM

        inp = 64
        r = inp - 2 * margin
        a, ash = sharded_field(mesh, inp)
        fields = SM.sharded_heightmap_mesh(
            mesh, ash, r, inp, 500.0, float(r), layout="planes")
        got = SM.mesh_planes_from_fields(
            fields, r, inp, (mesh.shape["x"], mesh.shape["y"]))
        want = MH.heightmap_mesh_overshoot_planes(
            jnp.asarray(a), r, inp, 500.0, float(r))
        gp, wp = np.asarray(got.planes), np.asarray(want.planes)
        np.testing.assert_array_equal(gp[:3], wp[:3], err_msg="positions")
        np.testing.assert_allclose(gp[3:6], wp[3:6], rtol=5e-7,
                                   err_msg="normals")
        np.testing.assert_array_equal(gp[6:], wp[6:], err_msg="tan/uv")
        np.testing.assert_array_equal(np.asarray(got.indices),
                                      np.asarray(want.indices))

    @pytest.mark.parametrize("margin", [0, 8])
    def test_shard_indices_partition_global_triangles(self, margin):
        """Per-shard uint32 triangle lists (global vertex ids) are a
        partition of grid_indices' triangles."""
        from noize_tpu.ops.mesh import grid_indices
        from noize_tpu.parallel.sharded_mesh import shard_mesh_indices

        inp = 64
        r = inp - 2 * margin
        per = shard_mesh_indices(r, inp, (4, 2))
        tris = np.concatenate([v.reshape(-1, 3)
                               for v in per.values() if v.size])
        want = grid_indices(r).astype(np.uint32).reshape(-1, 3)
        assert tris.shape == want.shape
        order = np.lexsort(tris.T[::-1])
        worder = np.lexsort(want.T[::-1])
        np.testing.assert_array_equal(tris[order], want[worder])
        assert all(v.dtype == np.uint32 for v in per.values())

    @pytest.mark.parametrize("margin", [0, 8])
    def test_shard_vertex_window_covers_grid(self, margin):
        """The per-shard real-vertex windows (one row/col overlap) cover
        the whole (r+1)² grid and never exceed it."""
        from noize_tpu.parallel.sharded_mesh import shard_vertex_window

        inp = 64
        r = inp - 2 * margin
        covered = np.zeros((r + 1, r + 1), bool)
        for i in range(4):
            for j in range(2):
                (rs, cs), (vz0, vx0) = shard_vertex_window(
                    r, inp, (4, 2), (i, j))
                assert vz0 + rs.stop <= r + 1 and vx0 + cs.stop <= r + 1
                covered[vz0:vz0 + rs.stop, vx0:vx0 + cs.stop] = True
        assert covered.all()

    def test_local_indices_match_global(self):
        """Per-shard LOCAL triangle ids address the same vertices as the
        global ids through the shard's block layout."""
        from noize_tpu.parallel.sharded_mesh import shard_mesh_indices

        inp, margin = 64, 8
        r = inp - 2 * margin
        lr, lc = inp // 4, inp // 2
        glob = shard_mesh_indices(r, inp, (4, 2), local=False)
        loc = shard_mesh_indices(r, inp, (4, 2), local=True)
        for (i, j), g in glob.items():
            lo = loc[(i, j)]
            assert lo.shape == g.shape
            if g.size == 0:
                continue
            gz, gx = g // (r + 1), g % (r + 1)
            want_local = (gz - i * lr) * (lc + 1) + (gx - j * lc)
            np.testing.assert_array_equal(lo, want_local.astype(np.uint32))

    def test_sim_mesh_fields(self, mesh):
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.parallel.sharded_erosion import ShardedErosionSim

        rng = np.random.default_rng(29)
        h = rng.uniform(0.2, 0.8, (32, 32)).astype(np.float32)
        sim = ShardedErosionSim(
            mesh, h,
            settings=ErosionSettings(PARTICLES_PER_CYCLE=8, MAXAGE=4,
                                     WATER_STEPS=1, CYCLES=1,
                                     PILING_RADIUS=4),
            chunk=4)
        f = sim.mesh_fields()
        nx, ny = mesh.shape["x"], mesh.shape["y"]
        assert f["positions"].shape == (32 + nx, 32 + ny, 3)
        assert np.isfinite(np.asarray(f["normals"])).all()
        fp = sim.mesh_fields(layout="planes")
        assert fp["planes"].shape == (12, 32 + nx, 32 + ny)
        assert np.isfinite(np.asarray(fp["planes"])).all()


class TestShardedCheckpoint:
    def test_save_and_resume_bit_exact(self, mesh, tmp_path):
        """A sharded sim checkpoints through the store/serde and a FRESH
        sharded sim resumes bit-exact (same maps + same key ⇒ identical
        next cycle)."""
        from noize_tpu.core.store import PipelineStateManager
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.parallel.sharded_erosion import ShardedErosionSim

        rng = np.random.default_rng(31)
        h = rng.uniform(0.2, 0.8, (32, 32)).astype(np.float32)
        st = ErosionSettings(PARTICLES_PER_CYCLE=16, MAXAGE=4,
                             WATER_STEPS=2, CYCLES=1, PILING_RADIUS=4)
        sm = PipelineStateManager(str(tmp_path / "store"))
        a = ShardedErosionSim(mesh, h, settings=st, chunk=4,
                              state_manager=sm)
        a.step(1)
        a.save_erosion_state()
        key_at_save = a.state.key

        # fresh manager over the same dir: restore-on-get pulls from disk
        sm2 = PipelineStateManager(str(tmp_path / "store"))
        b = ShardedErosionSim(mesh, np.zeros_like(h), settings=st, chunk=4,
                              state_manager=sm2)
        b.restore_erosion_state()
        from dataclasses import replace as _replace

        b.state = _replace(b.state, key=key_at_save)
        for name in ("height", "pool", "flow", "track", "plants"):
            np.testing.assert_array_equal(
                np.asarray(getattr(b.state.world, name)),
                np.asarray(getattr(a.state.world, name)), err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(b.state.drain_water), np.asarray(a.state.drain_water))

        a.step(1)
        b.step(1)
        for name in ("height", "pool", "flow", "track"):
            np.testing.assert_array_equal(
                np.asarray(getattr(b.state.world, name)),
                np.asarray(getattr(a.state.world, name)), err_msg=name)

    def test_save_requires_manager(self, mesh):
        from noize_tpu.parallel.sharded_erosion import ShardedErosionSim

        sim = ShardedErosionSim(mesh, np.zeros((16, 16), np.float32))
        with pytest.raises(RuntimeError):
            sim.save_erosion_state()


def test_sharded_sim_async_surface(mesh):
    """trigger/update/curvature/plant_map parity with ErosionSim."""
    from noize_tpu.erosion.params import ErosionSettings
    from noize_tpu.parallel.sharded_erosion import ShardedErosionSim

    rng = np.random.default_rng(37)
    h = rng.uniform(0.2, 0.8, (32, 32)).astype(np.float32)
    sim = ShardedErosionSim(
        mesh, h,
        settings=ErosionSettings(PARTICLES_PER_CYCLE=8, MAXAGE=4,
                                 WATER_STEPS=1, CYCLES=1, PILING_RADIUS=4),
        chunk=4)
    assert sim.update() == "triggered"
    status = sim.update(continuous=False)
    assert status in ("running", "completed")
    while sim.update(continuous=False) == "running":
        pass
    assert sim.cycle_count == 1
    assert np.isfinite(np.asarray(sim.curvature())).all()
    assert sim.plant_map.shape == (32, 32)


@pytest.mark.parametrize("case", ["scattered", "chained", "border_clip",
                                  "overflow"])
def test_sharded_exact_piles_bit_exact(mesh, case):
    """EXACT_PILES routes through the sparse replicated micro-solve
    (candidates + slot values gathered, commits replayed per shard — no
    O(res²) all-gather) and equals the single-device opt-in bit-for-bit.

    ``chained`` places three piles whose supports overlap pairwise ACROSS
    shard borders — pile 2 reads cells committed by pile 1, pile 3 by
    pile 2 — exercising the commit-overlay that no fixed halo width could
    reproduce.  ``border_clip`` puts a pile at the global corner so the
    clipped out-of-bounds slot reads (live in the solver's deposit
    accounting) cross the ownership psum."""
    from noize_tpu.erosion.sediment import write_sediment_map
    from noize_tpu.erosion.params import ErosionSettings
    from noize_tpu.parallel.sharded_erosion import _sharded_write_sediment

    res = 32
    rng = np.random.default_rng(43)
    h = rng.uniform(0.3, 0.7, (res, res)).astype(np.float32)
    sed = rng.uniform(-0.01, 0.012, (res, res)).astype(np.float32)
    if case == "scattered":
        sed[5, 7] = 0.5
        sed[20, 25] = 0.4
    elif case == "chained":
        # blocks are 8 or 16 wide on the 8-device meshes: supports span
        # the row-8/row-16 and col-16 borders and overlap in a chain
        sed[14, 14] = 0.6
        sed[17, 17] = 0.5
        sed[20, 14] = 0.45
        sed[15, 18] = 0.3
    elif case == "border_clip":
        sed[0, 0] = 0.5
        sed[2, 31] = 0.4
        sed[31, 16] = 0.35
    else:
        # more piles than the solver's max_piles=64: the sharded
        # two-stage top-K must select the same 64 (by volume desc, index
        # asc) as the single-device lax.top_k over the full map
        rr = np.random.default_rng(7)
        cells = rr.choice(res * res, size=100, replace=False)
        sed.reshape(-1)[cells] = rr.uniform(0.2, 0.9, 100).astype(np.float32)
    params = ErosionSettings(PILING_RADIUS=4, EXACT_PILES=True).as_parameters()
    want = write_sediment_map(jnp.asarray(h), jnp.asarray(sed), params, 500.0)
    sh = DM.field_sharding(mesh)
    got = _sharded_write_sediment(
        mesh, jax.device_put(jnp.asarray(h), sh),
        jax.device_put(jnp.asarray(sed), sh), params, 500.0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
