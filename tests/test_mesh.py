"""Mesh emission tests vs direct loop transcriptions of the generators."""

import numpy as np
import pytest
import jax.numpy as jnp

from noize_tpu.ops import mesh as M

RNG = np.random.default_rng(9)


def np_square_grid(heights, r, input_r, height, tile_size, overshoot):
    """Loop oracle of SquareGridHeightMap / OvershootSquareGridHeightMap
    (SetVertexValues + Execute)."""
    off = (input_r - r) // 2
    ns = 8.0
    n_verts = (r + 1) ** 2
    pos = np.zeros((n_verts, 3), np.float32)
    nrm = np.zeros((n_verts, 3), np.float32)
    tan = np.zeros((n_verts, 4), np.float32)
    uv = np.zeros((n_verts, 2), np.float32)

    def idx_clamped(x, z):
        if overshoot:
            x = min(max(x, -off), r + off)
            z = min(max(z, -off), r + off)
        else:
            x = min(max(x, 0), r + 1)
            z = min(max(z, 0), r + 1)
        return heights[z + off, x + off]

    def interp(a, b):
        return a - (b - a)

    for z in range(r + 1):
        for x in range(r + 1):
            vi = (r + 1) * z + x
            t = idx_clamped(x, z)
            if overshoot:
                l = idx_clamped(x - 1, z)
                rr = idx_clamped(x + 1, z)
                u = idx_clamped(x, z - 1)
                d = idx_clamped(x, z + 1)
                uv_den = r - 0.5
            else:
                l = idx_clamped(x - 1, z) if x > 0 else interp(t, idx_clamped(x + 1, z))
                rr = idx_clamped(x + 1, z) if x < r - 1 else interp(t, idx_clamped(x - 1, z))
                u = idx_clamped(x, z - 1) if z > 0 else interp(idx_clamped(x, z + 1), t)
                d = idx_clamped(x, z + 1) if z < r - 1 else interp(idx_clamped(x, z - 1), t)
                uv_den = r + 1
            px = -(0.5 * tile_size / r) if x == 0 else x * tile_size / r - 0.5
            pz = z * tile_size / r - 0.5
            pos[vi] = (px, t * height, pz)
            dx = (rr - l) / 2
            dz = (u - d) / 2
            tan[vi] = (-4 * dx, 16.0, -4 * dz, 0.0)
            n = np.array([(l - rr) / 2 * ns, 2.0 / height, dz * ns])
            nrm[vi] = n / np.linalg.norm(n)
            uv[vi] = (x / uv_den, z / uv_den)
    return pos, nrm, tan, uv


class TestHeightmapMesh:
    @pytest.mark.parametrize("overshoot", [False, True])
    def test_vertex_oracle(self, overshoot):
        r, input_r = 8, 12
        h = RNG.uniform(0, 1, (input_r, input_r)).astype(np.float32)
        fn = M.heightmap_mesh_overshoot if overshoot else M.heightmap_mesh
        mesh = fn(jnp.asarray(h), r, input_r, 100.0, 50.0)
        pos, nrm, tan, uv = np_square_grid(h, r, input_r, 100.0, 50.0, overshoot)
        np.testing.assert_allclose(np.asarray(mesh.positions), pos, atol=1e-4)
        np.testing.assert_allclose(np.asarray(mesh.normals), nrm, atol=1e-5)
        np.testing.assert_allclose(np.asarray(mesh.tangents), tan, atol=1e-4)
        np.testing.assert_allclose(np.asarray(mesh.uvs), uv, atol=1e-6)

    def test_triangle_indices(self):
        idx = M.grid_indices(2)
        assert idx.shape == (24,)  # 6 * 2 * 2
        tris = idx.reshape(-1, 3)
        # first cell (z=1, x=1): vi = 3*1+1 = 4
        np.testing.assert_array_equal(tris[0], [4 - 4, 4 - 1, 4 - 3])
        np.testing.assert_array_equal(tris[1], [4 - 3, 4 - 1, 4])
        # every index valid
        assert tris.max() == 8 and tris.min() == 0

    def test_index_dtype_switch(self):
        assert M.grid_indices(255).dtype == np.uint16
        assert M.grid_indices(256).dtype == np.uint32  # 257² > 65536

    def test_counts(self):
        r = 16
        mesh = M.heightmap_mesh(jnp.zeros((20, 20)), r, 20, 10.0, 10.0)
        assert mesh.vertex_count == (r + 1) ** 2
        assert mesh.index_count == 6 * r * r

    @pytest.mark.parametrize("overshoot", [False, True])
    def test_planes_layout_bit_equal(self, overshoot):
        """MeshPlanes (component-major, the tile-batch emission layout) must be
        bit-identical to the MeshArrays trailing-dim layout — both stack
        vertex_plane_list."""
        r, input_r = 8, 12
        h = jnp.asarray(RNG.uniform(0, 1, (input_r, input_r)).astype(np.float32))
        if overshoot:
            a = M.heightmap_mesh_overshoot(h, r, input_r, 100.0, 50.0)
            p = M.heightmap_mesh_overshoot_planes(h, r, input_r, 100.0, 50.0)
        else:
            a = M.heightmap_mesh(h, r, input_r, 100.0, 50.0)
            p = M.heightmap_mesh_planes(h, r, input_r, 100.0, 50.0)
        assert p.planes.shape == (12, r + 1, r + 1)
        assert p.vertex_count == a.vertex_count
        for f in ("positions", "tangents", "uvs", "indices"):
            np.testing.assert_array_equal(
                np.asarray(getattr(p, f)), np.asarray(getattr(a, f)), err_msg=f
            )
        # normals carry a sqrt+reciprocal chain XLA fuses differently per
        # program — identical source math, a-few-ulp divergence
        np.testing.assert_allclose(np.asarray(p.normals),
                                   np.asarray(a.normals), rtol=5e-7)
        b = p.to_arrays()
        np.testing.assert_array_equal(np.asarray(b.positions),
                                      np.asarray(a.positions))

    def test_flat_input_flat_mesh(self):
        mesh = M.heightmap_mesh(jnp.full((12, 12), 0.5), 8, 12, 100.0, 10.0)
        np.testing.assert_allclose(np.asarray(mesh.positions)[:, 1], 50.0, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(mesh.normals), np.tile([0, 1, 0], (81, 1)), atol=1e-6
        )


class TestWaterMesh:
    def test_plane(self):
        mesh = M.flat_water_mesh(4)
        pos = np.asarray(mesh.positions)
        assert pos.shape == (25, 3)
        assert np.all(pos[:, 1] == 0)
        assert mesh.indices.shape == (96,)

    def test_cache(self):
        a = M.square_planar_mesh(6)
        b = M.square_planar_mesh(6)
        assert a is b
