"""Production tile serving — TileServer batching with in-batch mesh
emission and file export.

Don't generate tiles one-by-one (the reference's one-tile-per-frame
queue); batch them.
This example stands up a TileServer whose config erodes every tile and
emits component-major vertex planes, submits a ring of requests, and
exports one served tile as OBJ.

Run (CPU, 8 virtual devices for the dp batch axis):
  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/serving_tiles.py [outdir]
"""

import os
import sys
import time

import numpy as np

# NOIZE_EXAMPLE_FAST=1 shrinks every size so the example doubles as a
# CPU smoke test (tests/test_examples.py) without changing its structure
FAST = os.environ.get("NOIZE_EXAMPLE_FAST") not in (None, "", "0")

# Persistent compile cache (noize_tpu.utils.compile_cache): without it
# every example invocation re-pays its compiles
from noize_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from noize_tpu.app import mesh_export
from noize_tpu.app.server import TileServer
from noize_tpu.core.tiles import TileSetMeta
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.ops.mesh import MeshPlanes, grid_indices
from noize_tpu.parallel import device_mesh as DM
from noize_tpu.parallel import tiled as TL


def main(outdir="out/serving"):
    os.makedirs(outdir, exist_ok=True)
    if FAST:
        meta = TileSetMeta(tile_res=48, tile_size=48, generator_res=64,
                           height=1000, margin=8).validate()
        es = ErosionSettings(PARTICLES_PER_CYCLE=64, MAXAGE=8,
                             WATER_STEPS=2, CYCLES=1, PILING_RADIUS=4)
        octaves, blur_iters = 4, 2
    else:
        meta = TileSetMeta(tile_res=192, tile_size=192, generator_res=256,
                           height=1000, margin=32).validate()
        es = ErosionSettings(PARTICLES_PER_CYCLE=300, MAXAGE=32,
                             WATER_STEPS=4, CYCLES=1, PILING_RADIUS=8)
        octaves, blur_iters = 8, 5
    cfg = TL.TilePipelineConfig(
        meta=meta, octaves=octaves, noise_size=900.0,
        blur_iterations=blur_iters, erosion=es,
        erosion_cycles=1,
        emit_mesh=True,
    )
    # dp scale-out: shard the batch axis over all devices when >1 present
    import jax

    mesh = DM.batch_mesh() if len(jax.devices()) > 1 else None
    srv = TileServer(cfg, batch_size=8, mesh=mesh, max_wait_ms=20.0).start()

    # Two waves: the first pays the one-time batch-program cost (trace +
    # compile, kept across runs by the persistent cache configured above);
    # the second is the steady-state serving number.
    done = []
    for wave in ("cold", "warm"):
        wave_done = []
        t0 = time.perf_counter()
        for z in range(2):
            for x in range(4):
                srv.submit(f"tile_{x}_{z}_{wave}", (x, z),
                           on_complete=wave_done.append)
        assert srv.drain(timeout=600)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"{wave}: served {len(wave_done)} tiles in {dt:.0f} ms "
              f"({dt / len(wave_done):.1f} ms/tile incl. erosion + mesh, "
              f"batches={srv.batches})")
        done.extend(wave_done)
    srv.stop()

    st = next(s for s in done if s.request.uuid == "tile_1_0_warm")
    planes = MeshPlanes(np.asarray(st.mesh_planes),
                        grid_indices(meta.tile_res))
    obj = os.path.join(outdir, "tile_1_0.obj")
    mesh_export.to_obj(obj, planes)
    print("exported", obj, f"({planes.vertex_count} verts,"
          f" {planes.index_count // 3} tris)")


if __name__ == "__main__":
    main(*sys.argv[1:2])
