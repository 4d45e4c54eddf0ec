"""On-card smoke test: drive the terrain engine's main paths once on an
NVIDIA GPU at production sizes, through the public entry points, and
check them against the same work on the host CPU.

    python chip_smoke.py           # one card: phases 1-6 below
    python chip_smoke.py --four    # four cards: the sharded sp and dp paths only

One card:
  1. flagship   app.flagship tile step at 2048² (Simplex 13 octaves,
                Gauss-5 x17, flow x8, 3 erosion cycles of 1000 particles,
                mesh), run twice with one key: are the outputs bit-identical?
  2. stages     the README quickstart pipeline at 2048², then a mesh from
                the stored context
  3. editor     ErosionSim at 1024²: steps, a live retune that must not
                recompile, a checkpoint read back bit-exact
  4. serving    TileServer, batch 4, 1024² tiles with erosion and mesh,
                two waves of 8 requests
  5. parity     each phase at 2048² on the GPU against the same jitted
                function on the CPU, within stated tolerances; particle
                descent and one erosion cycle by invariants and statistics
  6. wet_pool   pool automata x10 on a wet 2048² grid: time and CPU parity

Four cards (--four): sharded fractal, Gauss chain and flow map plus one
sharded erosion cycle on a 2x2 mesh at 4096², and a dp tile batch of 8
tiles over four cards, each against the same work on one card.

The script exits non-zero, printing no result line, when JAX finds no GPU
or when any phase fails.  On success the last line of standard output is
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
It writes only under chiprun_out/chip_smoke/ (removed again at the end)
and the compile cache (noize_tpu.utils.compile_cache).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")

# Production sizes (the flagship tile, the editor and serving tiles, the
# sharded field).  Module constants so a CPU rehearsal can shrink them.
FLAG_RES = 2048
EDITOR_RES = 1024
SERVE_RES = 1024
SERVE_MARGIN = 32
FIELD_RES = 4096

# GPU-vs-CPU tolerances on identical inputs (max |gpu - cpu|), each with
# the reason for its size.  Fields are float32; ulp(1.0) = 1.2e-7.
TOLERANCES = {
    # 13 octaves of gradient noise, each a few ulps apart where the GPU
    # contracts multiply-adds (FMA) or rounds exp2/floor inputs
    # differently; amplitudes sum to ~2.6, so 13 x ~4 ulp x 2.6
    "noise": 2e-5,
    # 17 iterations of a 5-tap convex filter: at most ~2 ulp per pass
    "blur_x17": 5e-6,
    # 8 pipe-model steps plus a sqrt and the static normalisation, which
    # divides by 0.2 (x5 on every error)
    "flow_x8": 1e-5,
    # one thermal iteration: subtract / compare / multiply, continuous in
    # its inputs, with tan() of the talus computed on each device
    "thermal": 1e-6,
    # ten water steps on pools of ~1e-3: 0.1% of the activity gate
    "pool_x10": 1e-6,
    "drains_x10": 1e-6,
    # linear 5x5 dispersal of the event map onto heights
    "sediment_write": 1e-6,
    # positions are heights x 1000 (ulp(1000) = 6e-5) plus exact grid
    # coordinates; normals are unit vectors from finite differences
    "mesh_positions": 2e-4,
    "mesh_normals": 1e-5,
}

# Particle descent is chaotic: one ulp can send a particle to another cell,
# so it is compared by totals and statistics, not cell by cell.
#  - each event-map total within 1% (one diverging particle of 1000 moves
#    a total by ~0.1%: the bound allows ~10 diverging trajectories);
#  - per device, height plus suspended sediment (the event map not yet
#    written back) is conserved by the write-back to 1e-5 of the sediment
#    it moved, unless the [0, 1] breaker dropped a cell's update;
#  - after one whole erosion cycle, >= 99% of cells within 1e-5 and the
#    height totals within 1% of the mass the cycle moved.
DESCENT_TOTAL_RTOL = 1e-2
WRITEBACK_MASS_RTOL = 1e-5
CYCLE_CELL_ATOL = 1e-5
CYCLE_CELL_FRACTION = 0.99
CYCLE_MASS_RTOL = 1e-2

# sharded (psum merge, PARITY D8) against one card, at 4096²
# (integer cell offsets are exact in float32, so only per-program fusion
# and FMA choices differ; halos are exchanged edge-replicated)
SHARDED_TOLERANCES = {"noise": 1e-6, "blur_x17": 5e-6, "flow_x8": 1e-5}


class PhaseError(AssertionError):
    """A phase's output failed its check."""


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_info() -> str:
    """Card name and power limit as nvidia-smi reports them, read by a
    child process that never imports JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def ok_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def max_err(got, want):
    """(max |got - want|, that over max |want|) in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    check(got.shape == want.shape, f"shape {got.shape} != {want.shape}")
    check(np.isfinite(got).all(), "non-finite values")
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    return err, err / scale if scale else err


def compare(name, got, want, tol):
    err, rel = max_err(got, want)
    print(f"  {name:16s} max abs {err:.3e}  max rel {rel:.3e}  "
          f"(tolerance {tol:.1e})", flush=True)
    check(err <= tol, f"{name}: max abs error {err:.3e} > {tol:.1e}")


def to_host(tree):
    import jax

    return jax.tree.map(np.asarray, jax.block_until_ready(tree))


def wall_ms(fn, *args, reps: int = 5):
    """Median host-clock ms of warm calls, each ending in
    block_until_ready (the first call compiles and is not counted)."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


class Smoke:
    """The phases, sharing the devices and the card's description."""

    def __init__(self, devices, card: str = ""):
        import jax

        self.devices = list(devices)
        self.gpu = self.devices[0]
        self.card = card
        self.cpu = jax.devices("cpu")[0]  # the reference device

    def on(self, device, fn, *args):
        """Run ``jax.jit(fn)`` on ``device`` with ``args`` placed there;
        returns host arrays."""
        import jax

        with jax.default_device(device):
            placed = jax.device_put(args, device)
            return to_host(jax.jit(fn)(*placed))

    def timed_on_gpu(self, name, fn, args, bytes_model):
        """Warm GPU time of ``jax.jit(fn)`` with the bytes it must move."""
        import jax

        f = jax.jit(fn)
        placed = jax.device_put(args, self.gpu)
        ms = wall_ms(f, *placed)
        print(f"  {name:16s} {ms:.3f} ms on {self.card}  "
              f"[{bytes_model}]", flush=True)

    # --- 1. flagship -----------------------------------------------------

    def flagship(self):
        import jax

        from noize_tpu.app.flagship import (default_meta, default_settings,
                                            make_tile_step)

        step, meta, _ = make_tile_step(
            default_meta(FLAG_RES), default_settings(), erosion_cycles=3)
        args = (np.float32(0.0), np.float32(0.0), jax.random.PRNGKey(0))
        t0 = time.perf_counter()
        compiled = step.lower(*args).compile()
        print(f"  compile {time.perf_counter() - t0:.1f} s; "
              f"memory_analysis: {compiled.memory_analysis()}", flush=True)
        out1 = to_host(compiled(*args))
        out2 = to_host(compiled(*args))
        res, tr = meta.generator_res, meta.tile_res
        for name in ("height", "flow_velocity", "pool", "stream"):
            check(out1[name].shape == (res, res), f"{name} shape")
            check(np.isfinite(out1[name]).all(), f"{name} not finite")
        m = out1["mesh"]
        check(m.positions.shape == ((tr + 1) ** 2, 3), "mesh positions shape")
        check(np.isfinite(m.positions).all(), "mesh positions not finite")
        norms = np.linalg.norm(m.normals, axis=-1)
        check(np.allclose(norms, 1.0, atol=1e-4), "mesh normals not unit")
        flat1, _ = jax.tree_util.tree_flatten_with_path(out1)
        diffs = [(path, a, b) for (path, a), b
                 in zip(flat1, jax.tree.leaves(out2))
                 if not np.array_equal(a, b)]
        print(f"  run-to-run bit-identical (same key, same process): "
              f"{not diffs}", flush=True)
        for path, a, b in diffs:
            print(f"    {jax.tree_util.keystr(path)}: max abs "
                  f"{max_err(a, b)[0]:.3e}, {float(np.mean(a != b)):.2e} of "
                  f"entries differ", flush=True)
        ms = wall_ms(compiled, *args, reps=3)
        print(f"  warm step {ms:.2f} ms on {self.card} (host clock, "
              f"median of 3; not a benchmark)", flush=True)

    # --- 2. stage pipeline ---------------------------------------------------

    def stages(self):
        from noize_tpu.core.stageio import GeneratorData, MeshStageData
        from noize_tpu.core.store import PipelineStateManager
        from noize_tpu.pipeline.driver import Pipeline
        from noize_tpu.pipeline.stages import (FlowMapStage,
                                               MeshTileReferenceDataStage,
                                               NoiseStage, StageGaussianBlur,
                                               StageThermalErosion,
                                               WriteGeneratorContextStage)

        sm = PipelineStateManager(os.path.join(OUT_DIR, "stages"), "world",
                                  "v1")
        pipe = Pipeline([
            NoiseStage(noiseType="Simplex", hurst=0.4, octaves=13,
                       noiseSize=1700),
            StageGaussianBlur(sigma="s1d00", width=5, iterations=17),
            FlowMapStage(iterations=8),
            StageThermalErosion(),
            WriteGeneratorContextStage(contextAlias="TERRAIN_HEIGHT"),
        ], state_manager=sm)
        res = FLAG_RES
        out = pipe.run(GeneratorData(uuid="t00", resolution=res, xpos=0,
                                     zpos=0))
        h = np.asarray(out.data)
        check(h.shape == (res, res) and np.isfinite(h).all(),
              "pipeline output")
        margin = 16
        tile = res - 2 * margin
        mesher = Pipeline([MeshTileReferenceDataStage(
            contextAlias="TERRAIN_HEIGHT")], state_manager=sm)
        md = mesher.run(MeshStageData(
            uuid="t00", resolution=tile, inputResolution=res,
            marginPix=margin, tileHeight=1000, tileSize=float(tile),
            xpos=0, zpos=0))
        mesh = to_host(md.mesh)
        check(mesh.positions.shape == ((tile + 1) ** 2, 3), "mesh shape")
        check(np.isfinite(mesh.positions).all(), "mesh not finite")
        check(np.allclose(np.linalg.norm(mesh.normals, axis=-1), 1.0,
                          atol=1e-4), "mesh normals not unit")
        print(f"  {res}² pipeline and {tile}² context mesh ok", flush=True)

    # --- 3. interactive editor -------------------------------------------

    def editor(self):
        from dataclasses import replace

        from noize_tpu.core.store import PipelineStateManager
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.erosion.sim import ErosionSim, erosion_cycle
        from noize_tpu.ops.fractal import fractal

        res = EDITOR_RES
        h0 = fractal(res, 0.0, 0.0, noise_type="Simplex", octaves=13,
                     hurst=0.4, noise_size=1700.0)
        save_dir = os.path.join(OUT_DIR, "editor")
        sim = ErosionSim(h0, settings=ErosionSettings(),
                         state_manager=PipelineStateManager(save_dir, "w",
                                                            "v1"))
        sim.step()
        sim.step()
        to_host(sim.state)
        compiled = erosion_cycle._cache_size()
        sim.settings = replace(sim.settings, EROSION=0.37)
        sim.step()
        h = np.asarray(sim.height_map)
        check(np.isfinite(h).all(), "height not finite")
        check(not np.array_equal(h, np.asarray(h0)), "erosion changed nothing")
        check(erosion_cycle._cache_size() == compiled,
              "live retune recompiled the cycle")
        sim.save_erosion_state()
        fresh = PipelineStateManager(save_dir, "w", "v1")
        for alias, arr in (("TERRAIN_HEIGHT", sim.state.world.height),
                           ("PARTERO_WATERMAP_STREAM", sim.state.world.flow),
                           ("PARTERO_WATERMAP_POOL", sim.state.world.pool)):
            back = np.asarray(fresh.get_buffer(sim._buffer_name(alias)))
            check(np.array_equal(back, np.asarray(arr)),
                  f"checkpoint {alias} differs")
        print(f"  {sim.cycle_count} cycles at {res}², retune without "
              f"recompile, checkpoint read back bit-exact", flush=True)

    # --- 4. serving ------------------------------------------------------------

    def serving(self):
        import threading

        from noize_tpu.app.server import TileServer
        from noize_tpu.core.tiles import TileSetMeta
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.parallel.tiled import TilePipelineConfig

        tile = SERVE_RES - 2 * SERVE_MARGIN
        meta = TileSetMeta(tile_res=tile, tile_size=tile,
                           generator_res=SERVE_RES, height=1000,
                           margin=SERVE_MARGIN).validate()
        cfg = TilePipelineConfig(meta=meta, octaves=13, noise_size=1700.0,
                                 blur_iterations=17,
                                 erosion=ErosionSettings(), erosion_cycles=1,
                                 emit_mesh=True)
        done, lock = [], threading.Lock()

        def collect(tile_result):
            with lock:
                done.append(tile_result)

        server = TileServer(cfg, batch_size=4).start()
        try:
            for wave in range(2):
                t0 = time.perf_counter()
                for i in range(8):
                    server.submit(f"w{wave}-{i}", (i % 4, 2 * wave + i // 4),
                                  on_complete=collect)
                check(server.drain(timeout=900), f"wave {wave} not drained")
                print(f"  wave {wave}: 8 tiles in "
                      f"{time.perf_counter() - t0:.2f} s "
                      f"({'with' if wave == 0 else 'no'} compile)",
                      flush=True)
        finally:
            server.stop()
        check(not server.errors, f"server errors: {server.errors[:1]}")
        check(len(done) == 16, f"{len(done)} of 16 tiles served")
        for t in done:
            check(t.error is None, f"tile {t.request.pos}: {t.error}")
            hh = np.asarray(t.heights)
            mp = np.asarray(t.mesh_planes)
            check(hh.shape == (SERVE_RES, SERVE_RES)
                  and np.isfinite(hh).all(), "tile heights")
            check(mp.shape == (12, tile + 1, tile + 1)
                  and np.isfinite(mp).all(), "tile mesh planes")
        lat = sorted(t.latency_ms for t in done)
        print(f"  16 tiles served, batch latency {lat[0]:.1f}-{lat[-1]:.1f} "
              f"ms on {self.card}", flush=True)

    # --- 5. parity -----------------------------------------------------------

    def parity(self):
        import jax

        from noize_tpu.app.flagship import _blur_chain, default_meta
        from noize_tpu.erosion import particles as PA
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.erosion.pool import pool_automata
        from noize_tpu.erosion.sediment import write_sediment_map
        from noize_tpu.erosion.sim import erosion_cycle, init_state
        from noize_tpu.erosion.world import WorldState
        from noize_tpu.ops.flow import flow_map
        from noize_tpu.ops.fractal import fractal
        from noize_tpu.ops.mesh import heightmap_mesh_overshoot
        from noize_tpu.ops.thermal import thermal_erosion

        res = FLAG_RES
        meta = default_meta(res)
        es = ErosionSettings()
        params = es.as_parameters()
        hs = float(meta.height)
        field = res * res * 4
        mb = field / 1e6
        print(f"  {res}², float32 ({mb:.1f} MB per field), under "
              f"jax.default_matmul_precision('highest')", flush=True)

        with jax.default_matmul_precision("highest"):
            def noise():
                return fractal(res, 0.0, 0.0, noise_type="Simplex",
                               octaves=13, hurst=0.4, noise_size=1700.0)

            n_cpu = self.on(self.cpu, noise)
            compare("noise", self.on(self.gpu, noise), n_cpu,
                    TOLERANCES["noise"])

            def blur(h):
                return _blur_chain(h, 5, 1.0, 17)

            b_cpu = self.on(self.cpu, blur, n_cpu)
            compare("blur_x17", self.on(self.gpu, blur, n_cpu), b_cpu,
                    TOLERANCES["blur_x17"])
            self.timed_on_gpu(
                "blur_x17", blur, (n_cpu,),
                f"fused floor 2 fields {2 * mb:.0f} MB; one round trip per "
                f"iteration 17x2 fields {34 * mb:.0f} MB")

            def flow(h):
                return flow_map(h, iterations=8)

            compare("flow_x8", self.on(self.gpu, flow, b_cpu),
                    self.on(self.cpu, flow, b_cpu), TOLERANCES["flow_x8"])
            self.timed_on_gpu(
                "flow_x8", flow, (b_cpu,),
                f"fused floor 2 fields {2 * mb:.0f} MB; per step read h, "
                f"water, 4 flows and write 5 = 8x11+5 fields "
                f"{93 * mb:.0f} MB")

            ratio = float(meta.tile_size) / float(meta.height)

            def thermal(h):
                return thermal_erosion(h, es.TALUS, es.THERMAL_STEP, ratio,
                                       iterations=es.THERMAL_CYCLES)

            compare("thermal", self.on(self.gpu, thermal, b_cpu),
                    self.on(self.cpu, thermal, b_cpu), TOLERANCES["thermal"])
            k = 4 * es.THERMAL_CYCLES
            self.timed_on_gpu(
                "thermal", thermal, (b_cpu,),
                f"fused floor 2 fields {2 * mb:.0f} MB; one round trip per "
                f"phase {k}x2 fields {2 * k * mb:.0f} MB")

            # the blurred noise is the flagship's height field (in [0, 1])
            h01 = b_cpu
            self.wet_pool_parity(h01, es.WATER_STEPS, timed=False)

            # identical particles and world for descent on both devices
            parts = to_host(PA.spawn(jax.random.PRNGKey(7),
                                     es.PARTICLES_PER_CYCLE, res))

            def descend(h, pp):
                w = WorldState.create(h)
                _, tr, po, se = PA.descend_all(
                    PA.Particles(*pp), w, params, hs, meta.patch_res, res)
                return tr, po, se

            ev_cpu = self.on(self.cpu, descend, h01, tuple(parts))
            ev_gpu = self.on(self.gpu, descend, h01, tuple(parts))
            for name, g, c in zip(("track", "pool", "sediment"), ev_gpu,
                                  ev_cpu):
                gt, ct = float(np.sum(g, dtype=np.float64)), float(
                    np.sum(c, dtype=np.float64))
                rel = abs(gt - ct) / max(abs(ct), 1e-30)
                same = float(np.mean(g == c))
                print(f"  descent {name:9s} total gpu {gt:.6e} cpu {ct:.6e} "
                      f"rel {rel:.2e} (bound {DESCENT_TOTAL_RTOL:.0e}); "
                      f"{same:.6f} of cells identical", flush=True)
                check(rel <= DESCENT_TOTAL_RTOL, f"descent {name} total")

            sed_cpu = ev_cpu[2]

            def writeback(h, sed):
                return write_sediment_map(h, sed, params, hs)

            wb_gpu = self.on(self.gpu, writeback, h01, sed_cpu)
            wb_cpu = self.on(self.cpu, writeback, h01, sed_cpu)
            compare("sediment_write", wb_gpu, wb_cpu,
                    TOLERANCES["sediment_write"])
            for dev_name, wb, sed in (("gpu", wb_gpu, ev_gpu[2]),
                                      ("cpu", wb_cpu, sed_cpu)):
                before = (np.sum(h01, dtype=np.float64)
                          + np.sum(sed, dtype=np.float64))
                after = np.sum(wb, dtype=np.float64)
                moved = float(np.sum(np.abs(sed), dtype=np.float64))
                rel = abs(after - before) / max(moved, 1e-30)
                print(f"  {dev_name} height+suspended sediment before "
                      f"{before:.9e} after {after:.9e}: {rel:.2e} of the "
                      f"{moved:.3e} moved (bound {WRITEBACK_MASS_RTOL:.0e})",
                      flush=True)
                check(rel <= WRITEBACK_MASS_RTOL,
                      f"{dev_name} write-back mass balance")

            def mesh(h):
                m = heightmap_mesh_overshoot(h, meta.tile_res, res, hs,
                                             float(meta.tile_size))
                return m.positions, m.normals

            mg, mc = self.on(self.gpu, mesh, wb_cpu), self.on(self.cpu, mesh,
                                                             wb_cpu)
            compare("mesh_positions", mg[0], mc[0],
                    TOLERANCES["mesh_positions"])
            compare("mesh_normals", mg[1], mc[1], TOLERANCES["mesh_normals"])

            # one whole erosion cycle from one state and one key
            def cycle(h, key):
                out = erosion_cycle(init_state(h, key), es, meta)
                return out.world.height, out.world.pool, out.world.flow

            key = np.asarray(jax.random.PRNGKey(3))
            cg = self.on(self.gpu, cycle, h01, key)
            cc = self.on(self.cpu, cycle, h01, key)
            near = float(np.mean(np.abs(cg[0] - cc[0]) <= CYCLE_CELL_ATOL))
            moved = float(np.sum(np.abs(cc[0] - h01), dtype=np.float64))
            dmass = abs(float(np.sum(cg[0], dtype=np.float64)
                              - np.sum(cc[0], dtype=np.float64)))
            print(f"  erosion cycle: {near:.6f} of cells within "
                  f"{CYCLE_CELL_ATOL:.0e} (bound {CYCLE_CELL_FRACTION}); "
                  f"height totals differ by {dmass:.3e} = "
                  f"{dmass / max(moved, 1e-30):.2e} of the {moved:.3e} moved "
                  f"(bound {CYCLE_MASS_RTOL:.0e}); pool totals gpu "
                  f"{np.sum(cg[1], dtype=np.float64):.6e} cpu "
                  f"{np.sum(cc[1], dtype=np.float64):.6e}; stream totals gpu "
                  f"{np.sum(cg[2], dtype=np.float64):.6e} cpu "
                  f"{np.sum(cc[2], dtype=np.float64):.6e}", flush=True)
            check(near >= CYCLE_CELL_FRACTION, "erosion cycle cell agreement")
            check(dmass <= CYCLE_MASS_RTOL * moved, "erosion cycle mass")

    def wet_pool_parity(self, h01, steps: int, timed: bool):
        """Pool automata on a grid wet to the activity gate everywhere
        (pool.MIN_WATER), as bench.py's standalone pool entry does."""
        from noize_tpu.erosion.pool import MIN_WATER, pool_automata

        res = h01.shape[0]
        pool0 = np.full((res, res), MIN_WATER, np.float32)

        def pool(h, p):
            return pool_automata(h, p, iterations=steps,
                                 drain_particles=True)

        pg = self.on(self.gpu, pool, h01, pool0)
        pc = self.on(self.cpu, pool, h01, pool0)
        compare("pool_x10", pg[0], pc[0], TOLERANCES["pool_x10"])
        compare("drains_x10", pg[1], pc[1], TOLERANCES["drains_x10"])
        check(not np.array_equal(pg[0], pool0), "wet pool did not move")
        if timed:
            mb = res * res * 4 / 1e6
            self.timed_on_gpu(
                "pool_x10", pool, (h01, pool0),
                f"{4 * steps} phases; per phase read pool, drains and "
                f"heights, write pool and drains = 5 fields: "
                f"{4 * steps * 5 * mb:.0f} MB")

    # --- 6. wet pool, timed ---------------------------------------------------

    def wet_pool(self):
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.ops.fractal import fractal

        h = np.asarray(fractal(FLAG_RES, 0.0, 0.0, noise_type="Simplex",
                               octaves=13, hurst=0.4, noise_size=1700.0))
        self.wet_pool_parity(h, ErosionSettings().WATER_STEPS, timed=True)

    # --- four cards ---------------------------------------------------------

    def four_mesh(self):
        from noize_tpu.parallel import device_mesh as DM

        mesh = DM.spatial_mesh(self.devices[:4])
        check(dict(mesh.shape) == {"x": 2, "y": 2}, f"mesh {mesh.shape}")
        return mesh

    def spread(self, arr, name):
        devs = {d.id for d in arr.sharding.device_set}
        check(devs == {d.id for d in self.devices[:4]},
              f"{name} lives on devices {sorted(devs)}, not all four")

    def sp_field_ops(self):
        import jax

        from noize_tpu.app.flagship import _blur_chain
        from noize_tpu.ops.flow import flow_map
        from noize_tpu.ops.fractal import fractal
        from noize_tpu.parallel import device_mesh as DM
        from noize_tpu.parallel import sharded_ops as SO

        mesh = self.four_mesh()
        res = FIELD_RES
        kw = dict(noise_type="Simplex", octaves=13, hurst=0.4,
                  noise_size=1700.0)
        n_sp = SO.sharded_fractal(mesh, res, 0.0, 0.0, **kw)
        self.spread(n_sp, "sharded_fractal")
        n_one = self.on(self.gpu, lambda: fractal(res, 0.0, 0.0, **kw))
        compare("sp noise", to_host(n_sp), n_one,
                SHARDED_TOLERANCES["noise"])
        sh = DM.field_sharding(mesh)
        b_sp = SO.sharded_gauss_blur(mesh, jax.device_put(n_one, sh), 5,
                                     1.0, iterations=17)
        self.spread(b_sp, "sharded_gauss_blur")
        b_one = self.on(self.gpu, lambda h: _blur_chain(h, 5, 1.0, 17), n_one)
        compare("sp blur_x17", to_host(b_sp), b_one,
                SHARDED_TOLERANCES["blur_x17"])
        f_sp = SO.sharded_flow_map(mesh, jax.device_put(b_one, sh),
                                   iterations=8)
        self.spread(f_sp, "sharded_flow_map")
        f_one = self.on(self.gpu, lambda h: flow_map(h, iterations=8), b_one)
        compare("sp flow_x8", to_host(f_sp), f_one,
                SHARDED_TOLERANCES["flow_x8"])
        self.field = b_one

    def sp_erosion_cycle(self):
        import jax

        from noize_tpu.core.tiles import TileSetMeta
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.erosion.sim import SimState, erosion_cycle, init_state
        from noize_tpu.erosion.world import WorldState
        from noize_tpu.parallel import device_mesh as DM
        from noize_tpu.parallel.sharded_erosion import sharded_erosion_cycle

        mesh = self.four_mesh()
        res = FIELD_RES
        b = getattr(self, "field", None)
        if b is None:
            from noize_tpu.ops.fractal import fractal

            b = np.asarray(fractal(res, 0.0, 0.0, noise_type="Simplex",
                                   octaves=13, hurst=0.4, noise_size=1700.0))
        h01 = b
        meta = TileSetMeta(tile_res=res, tile_size=res, generator_res=res,
                           height=1000, margin=0)
        es = ErosionSettings()
        key = jax.random.PRNGKey(3)

        def one(h, k):
            out = erosion_cycle(init_state(h, k), es, meta)
            return out.world.height, out.world.pool

        want = self.on(self.gpu, one, h01, np.asarray(key))
        sh = DM.field_sharding(mesh)
        put = lambda a: jax.device_put(a, sh)
        st = init_state(jax.numpy.asarray(h01), key)
        w = st.world
        st = SimState(world=WorldState(height=put(w.height), pool=put(w.pool),
                                       flow=put(w.flow), track=put(w.track),
                                       plants=put(w.plants)),
                      drain_water=put(st.drain_water), key=key)
        got = sharded_erosion_cycle(mesh, st, es, meta)
        self.spread(got.world.height, "sharded_erosion_cycle height")
        gh, gp = to_host((got.world.height, got.world.pool))
        near = float(np.mean(np.abs(gh - want[0]) <= CYCLE_CELL_ATOL))
        moved = float(np.sum(np.abs(want[0] - h01), dtype=np.float64))
        dmass = abs(float(np.sum(gh, dtype=np.float64)
                          - np.sum(want[0], dtype=np.float64)))
        print(f"  sp erosion cycle {res}²: {near:.6f} of cells within "
              f"{CYCLE_CELL_ATOL:.0e} (bound {CYCLE_CELL_FRACTION}); height "
              f"totals differ by {dmass / max(moved, 1e-30):.2e} of the "
              f"{moved:.3e} moved (bound {CYCLE_MASS_RTOL:.0e}); pool totals "
              f"{np.sum(gp, dtype=np.float64):.6e} vs "
              f"{np.sum(want[1], dtype=np.float64):.6e}", flush=True)
        check(near >= CYCLE_CELL_FRACTION, "sp cycle cell agreement")
        check(dmass <= CYCLE_MASS_RTOL * moved, "sp cycle mass")

    def dp_tile_batch(self):
        import jax

        from noize_tpu.core.tiles import TileSetMeta
        from noize_tpu.erosion.params import ErosionSettings
        from noize_tpu.parallel import device_mesh as DM
        from noize_tpu.parallel import tiled as TL

        tile = SERVE_RES - 2 * SERVE_MARGIN
        meta = TileSetMeta(tile_res=tile, tile_size=tile,
                           generator_res=SERVE_RES, height=1000,
                           margin=SERVE_MARGIN).validate()
        cfg = TL.TilePipelineConfig(meta=meta, octaves=13, noise_size=1700.0,
                                    blur_iterations=17,
                                    erosion=ErosionSettings(),
                                    erosion_cycles=1, emit_mesh=True)
        origins = TL.grid_origins(meta, 4, 2)
        with jax.default_device(self.gpu):
            one = to_host(TL.tile_batch(cfg, origins))
        out = TL.tile_batch(cfg, origins, mesh=DM.batch_mesh(self.devices[:4]))
        self.spread(out["height"], "dp tile_batch heights")
        four = to_host(out)
        for name, tol in (("height", CYCLE_CELL_ATOL),
                          ("mesh_planes", CYCLE_CELL_ATOL * 1000)):
            g, w = four[name], one[name]
            check(g.shape == w.shape and np.isfinite(g).all(), name)
            near = float(np.mean(np.abs(g - w) <= tol))
            err, _ = max_err(g, w)
            print(f"  dp {name}: {near:.6f} of entries within {tol:.0e}, "
                  f"max abs {err:.3e}", flush=True)
            check(near >= CYCLE_CELL_FRACTION, f"dp {name} agreement")


ONE_CARD = ("flagship", "stages", "editor", "serving", "parity", "wet_pool")
FOUR_CARDS = ("sp_field_ops", "sp_erosion_cycle", "dp_tile_batch")


def select_phases(four: bool):
    return FOUR_CARDS if four else ONE_CARD


def run(smoke, names) -> int:
    """Run the named phases of ``smoke``; print the result line and return
    0 only when every phase passed."""
    failed = []
    for name in names:
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            getattr(smoke, name)()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s",
                  flush=True)
        else:
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(ok_line(smoke.devices))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phases")
    args = ap.parse_args(argv)

    # the CPU is the reference device: keep its backend next to the GPU's
    # when the platform list is pinned (e.g. JAX_PLATFORMS=cuda)
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r}); nothing was run", file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs four GPUs, JAX found "
              f"{len(devices)}", file=sys.stderr)
        return 2

    from noize_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    card = card_info()
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}: {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)
    try:
        return run(Smoke(devices, card.splitlines()[0]),
                   select_phases(args.four))
    finally:
        shutil.rmtree(OUT_DIR, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
