"""The XLA paths that run on every platform, checked on the fields and
iteration counts that production uses: the flagship's blur chain, the
flow map, thermal erosion and the pool automata, each against its loop
oracle, its iterated single step or its full-grid reference, plus the
batch-level pool gate under ``vmap``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from noize_tpu.app.flagship import _blur_chain
from noize_tpu.erosion import pool as PO
from noize_tpu.ops import flow as FL
from noize_tpu.ops import kernels as K
from noize_tpu.ops import thermal as T

from test_filters import np_thermal
from test_flow import np_flow_map

RES = 128


def _field(kind: str, res: int = RES) -> np.ndarray:
    """``random``: uniform heights; ``border``: strong gradients on the
    edges, where per-iteration clamping matters."""
    if kind == "random":
        return np.random.default_rng(53).uniform(
            0, 1, (res, res)).astype(np.float32)
    a = np.zeros((res, res), np.float32)
    a[0, :] = 5.0
    a[:, -1] = -3.0
    a[40:60, 40:60] = 2.0
    return a


FIELDS = ("random", "border")


def _iterated_series(a, taps, iterations):
    for _ in range(iterations):
        a = K.separable_series(a, taps, taps, 1.0)
    return a


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("iterations", [1, 3, 17])
def test_blur_chain_matches_iterated_series(iterations, field):
    a = jnp.asarray(_field(field))
    got = np.asarray(_blur_chain(a, 5, 1.0, iterations))
    want = np.asarray(_iterated_series(a, K.gaussian_taps(1.0, 5),
                                       iterations))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_blur_chain_wide_taps_on_border_field():
    a = jnp.asarray(_field("border"))
    got = np.asarray(_blur_chain(a, 9, 2.0, 2))
    want = np.asarray(_iterated_series(a, K.gaussian_taps(2.0, 9), 2))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("iterations", [1, 3, 8])
def test_flow_map_matches_oracle(iterations, field):
    h = _field(field)
    got = np.asarray(FL.flow_map(jnp.asarray(h), iterations=iterations))
    np.testing.assert_allclose(got, np_flow_map(h, iterations), atol=1e-5)


@pytest.mark.parametrize("field", FIELDS)
def test_thermal_one_iteration_matches_oracle(field):
    a = _field(field)
    got = np.asarray(T.thermal_erosion(jnp.asarray(a), 55.0, 0.6, 2.0,
                                       iterations=1))
    np.testing.assert_allclose(got, np_thermal(a, 55.0, 0.6, 2.0, 1),
                               atol=1e-5)


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("iterations", [3, 8])
def test_thermal_loop_matches_iterated_single_step(iterations, field):
    """The fori_loop body equals ``iterations`` separate one-iteration
    calls (1-ulp tolerance: XLA:CPU contracts multiply-adds differently
    inside and outside the loop body)."""
    a = jnp.asarray(_field(field))
    got = np.asarray(T.thermal_erosion(a, 55.0, 0.6, 2.0,
                                       iterations=iterations))
    want = a
    for _ in range(iterations):
        want = T.thermal_erosion(want, 55.0, 0.6, 2.0, iterations=1)
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-6)


def _pool_case(kind: str, res: int = 64):
    rng = np.random.default_rng(9)
    h = rng.uniform(0, 0.5, (res, res)).astype(np.float32)
    if kind == "dense":
        p = rng.uniform(0, 0.05, (res, res)).astype(np.float32)
    elif kind == "sparse":  # pools sit in a band, the rest is dry
        p = np.zeros((res, res), np.float32)
        p[40:48, :] = rng.uniform(0, 0.05, (8, res)).astype(np.float32)
    else:  # strictly below the activity gate everywhere
        p = rng.uniform(0, PO.MIN_WATER * 0.99,
                        (res, res)).astype(np.float32)
        if kind == "one_at_gate":
            p[11, 13] = np.float32(PO.MIN_WATER)
    return jnp.asarray(h), jnp.asarray(p)


@pytest.mark.parametrize("drain_particles", [True, False])
@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("kind",
                         ["dense", "sparse", "one_at_gate", "below_gate"])
def test_pool_automata_matches_fullgrid(kind, iterations, drain_particles):
    """The half-row production path is bit-exact with the full-grid
    masked reference, pools and drains, for every wetness shape."""
    h, p = _pool_case(kind)
    gp, gd = PO.pool_automata(h, p, iterations=iterations,
                              drain_particles=drain_particles)
    wp, wd = PO._pool_automata_fullgrid(h, p, iterations, drain_particles)
    np.testing.assert_array_equal(np.asarray(gp), np.asarray(wp))
    np.testing.assert_array_equal(np.asarray(gd), np.asarray(wd))
    if kind == "below_gate":  # a fixed point: nothing moves, nothing drains
        np.testing.assert_array_equal(np.asarray(gp), np.asarray(p))
        assert not np.any(np.asarray(gd))
    else:
        assert not np.array_equal(np.asarray(gp), np.asarray(p))


@pytest.mark.parametrize("wet", [False, True])
@pytest.mark.parametrize("in_axes", [(None, 0), (0, None)])
def test_gated_pool_vmap_with_one_operand_unbatched(in_axes, wet):
    """The custom_vmap gate with a shared height map (or a shared pool)
    across the batch equals per-tile pool_automata calls."""
    from noize_tpu.erosion.sim import _gated_pool

    B, R = 3, 32
    hb = jax.random.uniform(jax.random.PRNGKey(0), (B, R, R), jnp.float32)
    pb = jnp.full((B, R, R), 5e-4, jnp.float32)  # below the gate
    if wet:
        pb = pb.at[1].set(jax.random.uniform(jax.random.PRNGKey(1), (R, R),
                                             jnp.float32) * 0.01)
    h = hb[0] if in_axes[0] is None else hb
    p = pb[1] if in_axes[1] is None else pb
    po, dr = jax.jit(jax.vmap(_gated_pool(2, True), in_axes=in_axes))(h, p)
    assert po.shape == dr.shape == (B, R, R)
    for i in range(B):
        hi = h if in_axes[0] is None else h[i]
        pi = p if in_axes[1] is None else p[i]
        rp, rd = PO.pool_automata(hi, pi, iterations=2, drain_particles=True)
        np.testing.assert_array_equal(np.asarray(po[i]), np.asarray(rp))
        np.testing.assert_array_equal(np.asarray(dr[i]), np.asarray(rd))
