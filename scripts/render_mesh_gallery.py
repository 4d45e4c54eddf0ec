"""Render a shaded 3-D view of an eroded-tile mesh for the docs gallery —
the full chain noise → blur → erosion → mesh emission → normals-lit render.

Run (CPU): JAX_PLATFORMS=cpu python scripts/render_mesh_gallery.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
from matplotlib.colors import LightSource

import jax
import jax.numpy as jnp

from noize_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.erosion.sim import ErosionSim
from noize_tpu.ops.fractal import fractal
from noize_tpu.ops import blur as B
from noize_tpu.ops.mesh import heightmap_mesh_overshoot_planes


def main(out="docs/mesh_render.png", res=512, cycles=12):
    h = jax.jit(lambda: fractal(res, 7, 0, noise_type="Simplex", octaves=13,
                                hurst=0.4, noise_size=1700.0))()
    for _ in range(5):
        h = B.gauss_blur(h, 5, 1.0)
    sim = ErosionSim(h, settings=ErosionSettings(
        PARTICLES_PER_CYCLE=800, MAXAGE=64, CYCLES=1))
    sim.step(cycles)
    tile = res - 32
    planes = heightmap_mesh_overshoot_planes(
        sim.height_map, tile, res, 120.0, float(tile))
    p = np.asarray(planes.planes)
    # height plane + emitted normals drive a hillshade render
    y = p[1].astype(np.float64)
    ls = LightSource(azdeg=315, altdeg=40)
    rgb = ls.shade(y, cmap=plt.cm.gist_earth, vert_exag=2.0,
                   blend_mode="soft")
    fig, ax = plt.subplots(figsize=(7, 7), dpi=110)
    ax.imshow(rgb, origin="lower")
    ax.set_axis_off()
    ax.set_title("eroded 512² tile — emitted mesh height plane, hillshaded "
                 f"({cycles} cycles)", fontsize=9)
    fig.tight_layout()
    fig.savefig(out, bbox_inches="tight")
    print("wrote", out)


if __name__ == "__main__":
    main(*sys.argv[1:2])
