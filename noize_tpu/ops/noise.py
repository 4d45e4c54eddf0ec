"""Gradient/cellular noise primitives, vectorized with JAX/XLA.

The reference (xshazwar/noize-job) consumes ``Unity.Mathematics.noise``
primitives — ``cnoise`` (classic Perlin 2D/3D), ``snoise`` (simplex 2D/3D),
``psrnoise`` (periodic simplex w/ rotating gradients, 2D) and ``cellular``
(Worley 2D) — see ``/root/reference/Noise/Fractal/Fractal.cs:141-278``.
Those are ports of the public-domain/MIT "webgl-noise" algorithms (Ashima
Arts / Stefan Gustavson).  Here we implement the same published algorithms
directly in jnp, element-wise over whole grids, so a single XLA fusion
evaluates the entire tile in one kernel (the grid itself is the parallel axis;
there is no per-row job dispatch as in Burst — SURVEY.md §2.7).

All functions take/return float32 arrays of identical shape and are safe to
`jax.jit`/`vmap`/`shard_map`.  The integer-lattice hashing relies on exact
small-integer float arithmetic, which float32 provides for |x| < 2^24; do
NOT run these in bfloat16.
"""

from __future__ import annotations

import jax.numpy as jnp

_F32 = jnp.float32


# ---------------------------------------------------------------------------
# shared helpers (webgl-noise "common" block)
# ---------------------------------------------------------------------------

def _mod289(x):
    return x - jnp.floor(x * (1.0 / 289.0)) * 289.0


def _mod7(x):
    return x - jnp.floor(x * (1.0 / 7.0)) * 7.0


def _permute(x):
    """Ashima permutation polynomial: mod289((34 x + 1) x)."""
    return _mod289((34.0 * x + 1.0) * x)


def _taylor_inv_sqrt(r):
    return 1.79284291400159 - 0.85373472095314 * r


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _frac(x):
    return x - jnp.floor(x)


# ---------------------------------------------------------------------------
# classic Perlin noise (cnoise) — 2D
# ---------------------------------------------------------------------------

def cnoise2(x, y):
    """Classic Perlin noise, 2D; parity with Unity.Mathematics noise.cnoise(float2).

    Reference consumer: ``PerlinGetter`` (Fractal.cs:141-154).
    Output approximately in [-1, 1].
    """
    x = jnp.asarray(x, _F32)
    y = jnp.asarray(y, _F32)
    ix0 = jnp.floor(x)
    iy0 = jnp.floor(y)
    fx0 = x - ix0
    fy0 = y - iy0
    fx1 = fx0 - 1.0
    fy1 = fy0 - 1.0
    ix0 = _mod289(ix0)
    iy0 = _mod289(iy0)
    ix1 = _mod289(ix0 + 1.0)
    iy1 = _mod289(iy0 + 1.0)

    # corner order: 00, 10, 01, 11  (matches Pi.xzxz / Pi.yyww layout)
    def grad(ix, iy, fx, fy):
        i = _permute(_permute(ix) + iy)
        gx = _frac(i * (1.0 / 41.0)) * 2.0 - 1.0
        gy = jnp.abs(gx) - 0.5
        tx = jnp.floor(gx + 0.5)
        gx = gx - tx
        norm = _taylor_inv_sqrt(gx * gx + gy * gy)
        return norm * (gx * fx + gy * fy)

    n00 = grad(ix0, iy0, fx0, fy0)
    n10 = grad(ix1, iy0, fx1, fy0)
    n01 = grad(ix0, iy1, fx0, fy1)
    n11 = grad(ix1, iy1, fx1, fy1)

    fx = _fade(fx0)
    fy = _fade(fy0)
    nx0 = n00 + fx * (n10 - n00)
    nx1 = n01 + fx * (n11 - n01)
    return 2.3 * (nx0 + fy * (nx1 - nx0))


# ---------------------------------------------------------------------------
# classic Perlin noise (cnoise) — 3D
# ---------------------------------------------------------------------------

def cnoise3(x, y, z):
    """Classic Perlin noise, 3D; parity with noise.cnoise(float3).

    Reference consumer: ``PerlinGetterDomainRotated`` (Fractal.cs:156-174).
    """
    x = jnp.asarray(x, _F32)
    y = jnp.asarray(y, _F32)
    z = jnp.asarray(z, _F32)
    ix0 = _mod289(jnp.floor(x))
    iy0 = _mod289(jnp.floor(y))
    iz0 = _mod289(jnp.floor(z))
    ix1 = _mod289(ix0 + 1.0)
    iy1 = _mod289(iy0 + 1.0)
    iz1 = _mod289(iz0 + 1.0)
    fx0 = _frac(x)
    fy0 = _frac(y)
    fz0 = _frac(z)
    fx1 = fx0 - 1.0
    fy1 = fy0 - 1.0
    fz1 = fz0 - 1.0

    def grad(ix, iy, iz, fx, fy, fz):
        # The published code derives the gradient from frac/floor of i/7 and
        # branches on gz <= 0.  For ~16% of hash values gz is *exactly* 0 in
        # exact arithmetic, so float rounding of i/7 flips the branch
        # pseudo-randomly per compiler.  We instead extract the two base-7
        # digits (k, m) of the hash exactly (hashes are exact small integers
        # in f32) and decide the branch with the exact integer predicate
        # 2k + |2m - 7| >= 7 — deterministic, and equal to the
        # exact-arithmetic ideal of the Ashima formula.
        i = _permute(_permute(_permute(ix) + iy) + iz)
        q = jnp.floor(i * (1.0 / 7.0))
        k = i - 7.0 * q               # i mod 7, exact
        m = q - 7.0 * jnp.floor(q * (1.0 / 7.0))  # (i div 7) mod 7, exact
        gx = k * (1.0 / 7.0)
        gy = m * (1.0 / 7.0) - 0.5
        gz = 0.5 - gx - jnp.abs(gy)   # gx >= 0 always
        sz = jnp.where(2.0 * k + jnp.abs(2.0 * m - 7.0) >= 7.0, 1.0, 0.0)
        gx = gx - sz * 0.5            # step(0, gx) == 1 since gx >= 0
        gy = gy - sz * (jnp.where(m >= 4.0, 1.0, 0.0) - 0.5)
        norm = _taylor_inv_sqrt(gx * gx + gy * gy + gz * gz)
        return norm * (gx * fx + gy * fy + gz * fz)

    n000 = grad(ix0, iy0, iz0, fx0, fy0, fz0)
    n100 = grad(ix1, iy0, iz0, fx1, fy0, fz0)
    n010 = grad(ix0, iy1, iz0, fx0, fy1, fz0)
    n110 = grad(ix1, iy1, iz0, fx1, fy1, fz0)
    n001 = grad(ix0, iy0, iz1, fx0, fy0, fz1)
    n101 = grad(ix1, iy0, iz1, fx1, fy0, fz1)
    n011 = grad(ix0, iy1, iz1, fx0, fy1, fz1)
    n111 = grad(ix1, iy1, iz1, fx1, fy1, fz1)

    fx = _fade(fx0)
    fy = _fade(fy0)
    fz = _fade(fz0)
    nz00 = n000 + fz * (n001 - n000)
    nz10 = n100 + fz * (n101 - n100)
    nz01 = n010 + fz * (n011 - n010)
    nz11 = n110 + fz * (n111 - n110)
    ny0 = nz00 + fy * (nz01 - nz00)
    ny1 = nz10 + fy * (nz11 - nz10)
    return 2.2 * (ny0 + fx * (ny1 - ny0))


# ---------------------------------------------------------------------------
# simplex noise (snoise) — 2D
# ---------------------------------------------------------------------------

def snoise2(x, y):
    """Simplex noise, 2D; parity with noise.snoise(float2).

    Reference consumer: ``SimplexGetter`` (Fractal.cs:227-241).
    """
    x = jnp.asarray(x, _F32)
    y = jnp.asarray(y, _F32)
    C_x = 0.211324865405187  # (3 - sqrt(3)) / 6
    C_y = 0.366025403784439  # 0.5 * (sqrt(3) - 1)
    C_z = -0.577350269189626  # -1 + 2 * C_x
    C_w = 0.024390243902439  # 1 / 41

    s = (x + y) * C_y
    i = jnp.floor(x + s)
    j = jnp.floor(y + s)
    t = (i + j) * C_x
    x0 = x - i + t
    y0 = y - j + t

    i1 = jnp.where(x0 > y0, 1.0, 0.0)
    j1 = 1.0 - i1
    x1 = x0 + C_x - i1
    y1 = y0 + C_x - j1
    x2 = x0 + C_z
    y2 = y0 + C_z

    i = _mod289(i)
    j = _mod289(j)
    p0 = _permute(_permute(j) + i)
    p1 = _permute(_permute(j + j1) + i + i1)
    p2 = _permute(_permute(j + 1.0) + i + 1.0)

    def surflet(p, xd, yd):
        m = jnp.maximum(0.5 - (xd * xd + yd * yd), 0.0)
        m = m * m
        m = m * m
        gx = 2.0 * _frac(p * C_w) - 1.0
        h = jnp.abs(gx) - 0.5
        ox = jnp.floor(gx + 0.5)
        a0 = gx - ox
        m = m * (1.79284291400159 - 0.85373472095314 * (a0 * a0 + h * h))
        return m * (a0 * xd + h * yd)

    n = surflet(p0, x0, y0) + surflet(p1, x1, y1) + surflet(p2, x2, y2)
    return 130.0 * n


# ---------------------------------------------------------------------------
# simplex noise (snoise) — 3D
# ---------------------------------------------------------------------------

def snoise3(x, y, z):
    """Simplex noise, 3D; parity with noise.snoise(float3).

    Reference consumer: ``SimplexGetterDomainRotated`` (Fractal.cs:243-261).
    """
    x = jnp.asarray(x, _F32)
    y = jnp.asarray(y, _F32)
    z = jnp.asarray(z, _F32)
    C_x = 1.0 / 6.0
    C_y = 1.0 / 3.0

    s = (x + y + z) * C_y
    i = jnp.floor(x + s)
    j = jnp.floor(y + s)
    k = jnp.floor(z + s)
    t = (i + j + k) * C_x
    x0 = x - i + t
    y0 = y - j + t
    z0 = z - k + t

    # rank the components to pick simplex traversal order
    gx = jnp.where(x0 >= y0, 1.0, 0.0)
    gy = jnp.where(y0 >= z0, 1.0, 0.0)
    gz = jnp.where(z0 >= x0, 1.0, 0.0)
    lx = 1.0 - gx
    ly = 1.0 - gy
    lz = 1.0 - gz
    i1 = jnp.minimum(gx, lz)
    j1 = jnp.minimum(gy, lx)
    k1 = jnp.minimum(gz, ly)
    i2 = jnp.maximum(gx, lz)
    j2 = jnp.maximum(gy, lx)
    k2 = jnp.maximum(gz, ly)

    x1 = x0 - i1 + C_x
    y1 = y0 - j1 + C_x
    z1 = z0 - k1 + C_x
    x2 = x0 - i2 + C_y
    y2 = y0 - j2 + C_y
    z2 = z0 - k2 + C_y
    x3 = x0 - 0.5
    y3 = y0 - 0.5
    z3 = z0 - 0.5

    i = _mod289(i)
    j = _mod289(j)
    k = _mod289(k)
    p0 = _permute(_permute(_permute(k) + j) + i)
    p1 = _permute(_permute(_permute(k + k1) + j + j1) + i + i1)
    p2 = _permute(_permute(_permute(k + k2) + j + j2) + i + i2)
    p3 = _permute(_permute(_permute(k + 1.0) + j + 1.0) + i + 1.0)

    ns_x = 2.0 / 7.0
    ns_y = 0.5 / 7.0 - 1.0
    ns_z = 1.0 / 7.0

    def gradp(p):
        # Same exact-integer branch treatment as cnoise3: h is exactly 0 in
        # exact arithmetic for many hash digits (|4x-13| + |4y-13| == 14),
        # so the h <= 0 branch is decided on the exact integer predicate
        # rather than float rounding of 2/7-based arithmetic.
        jv = p - 49.0 * jnp.floor(p * (ns_z * ns_z))  # p mod 49, exact
        x_ = jnp.floor(jv * ns_z)                     # jv div 7, exact
        y_ = jv - 7.0 * x_                            # jv mod 7, exact
        gx = x_ * ns_x + ns_y                         # (4x - 13) / 14
        gy = y_ * ns_x + ns_y
        h = 1.0 - jnp.abs(gx) - jnp.abs(gy)
        sx = jnp.where(x_ <= 3.0, -1.0, 1.0)          # sign(gx), exact
        sy = jnp.where(y_ <= 3.0, -1.0, 1.0)
        a_ = jnp.abs(4.0 * x_ - 13.0)
        b_ = jnp.abs(4.0 * y_ - 13.0)
        sh = -jnp.where(a_ + b_ >= 14.0, 1.0, 0.0)    # h <= 0, exact
        gx = gx + sx * sh
        gy = gy + sy * sh
        return gx, gy, h

    def surflet(p, xd, yd, zd):
        gx, gy, gz = gradp(p)
        norm = _taylor_inv_sqrt(gx * gx + gy * gy + gz * gz)
        gx = gx * norm
        gy = gy * norm
        gz = gz * norm
        m = jnp.maximum(0.6 - (xd * xd + yd * yd + zd * zd), 0.0)
        m = m * m
        return m * m * (gx * xd + gy * yd + gz * zd)

    n = (surflet(p0, x0, y0, z0) + surflet(p1, x1, y1, z1)
         + surflet(p2, x2, y2, z2) + surflet(p3, x3, y3, z3))
    return 42.0 * n


# ---------------------------------------------------------------------------
# periodic simplex noise with rotating gradients (psrnoise) — 2D
# ---------------------------------------------------------------------------

def _rgrad2(px, py, rot):
    u = _permute(_permute(px) + py) * 0.0243902439 + rot  # 1/41 shift rotate
    u = _frac(u) * 6.28318530718
    return jnp.cos(u), jnp.sin(u)


def psrnoise2(x, y, per_x, per_y, rot=0.0):
    """Periodic simplex noise with rotating gradients (Gustavson psrdnoise2D).

    Parity with Unity.Mathematics noise.psrnoise(float2, float2[, rot]).
    Reference consumers: ``PeriodicPerlinGetter`` (period (1010,102), rot 0,
    Fractal.cs:176-191) and ``RotatedSimplexGetter`` (rot 0.62,
    Fractal.cs:193-208).  Period wrap uses a truncated fmod, matching
    Unity's ``math.fmod`` (C# ``%``) rather than GLSL floored mod.
    """
    x = jnp.asarray(x, _F32)
    y = jnp.asarray(y, _F32)
    # hack from the published source: offset y slightly to hide artifacts
    y = y + 0.001

    # skew to hexagonal grid
    uvx = x + y * 0.5
    uvy = y
    i0x = jnp.floor(uvx)
    i0y = jnp.floor(uvy)
    f0x = uvx - i0x
    f0y = uvy - i0y
    i1x = jnp.where(f0x > f0y, 1.0, 0.0)
    i1y = 1.0 - i1x

    # unskewed grid points
    p0x = i0x - i0y * 0.5
    p0y = i0y
    p1x = p0x + i1x - i1y * 0.5
    p1y = p0y + i1y
    p2x = p0x + 0.5
    p2y = p0y + 1.0

    d0x = x - p0x
    d0y = y - p0y
    d1x = x - p1x
    d1y = y - p1y
    d2x = x - p2x
    d2y = y - p2y

    # wrap to period in (x,y), then map back to (u,v) for hashing
    def wrap(px, py):
        xw = jnp.fmod(px, per_x)
        yw = jnp.fmod(py, per_y)
        return xw + 0.5 * yw, yw

    g0x, g0y = _rgrad2(*wrap(p0x, p0y), rot)
    g1x, g1y = _rgrad2(*wrap(p1x, p1y), rot)
    g2x, g2y = _rgrad2(*wrap(p2x, p2y), rot)

    w0 = g0x * d0x + g0y * d0y
    w1 = g1x * d1x + g1y * d1y
    w2 = g2x * d2x + g2y * d2y

    def t4(dx, dy):
        t = jnp.maximum(0.8 - (dx * dx + dy * dy), 0.0)
        t = t * t
        return t * t

    n = t4(d0x, d0y) * w0 + t4(d1x, d1y) * w1 + t4(d2x, d2y) * w2
    return 11.0 * n


# ---------------------------------------------------------------------------
# cellular (Worley) noise — 2D, returns (F1, F2)
# ---------------------------------------------------------------------------

def cellular2(x, y):
    """Cellular (Worley) noise, 2D, 3x3 search; parity with noise.cellular(float2).

    Returns ``(F1, F2)`` — distances to the nearest / second-nearest feature
    points.  Reference consumer: ``CellularGetter`` (Fractal.cs:263-278).
    """
    x = jnp.asarray(x, _F32)
    y = jnp.asarray(y, _F32)
    K = 0.142857142857  # 1/7
    Ko = 0.428571428571  # 3/7
    jitter = 1.0

    Pix = _mod289(jnp.floor(x))
    Piy = _mod289(jnp.floor(y))
    Pfx = _frac(x)
    Pfy = _frac(y)

    # oi/of over the 3-neighborhood
    oi = (-1.0, 0.0, 1.0)
    of = (-0.5, 0.5, 1.5)

    px = [_permute(Pix + o) for o in oi]

    def column(pxc, dx_base):
        d = []
        for row in range(3):
            p = _permute(pxc + Piy + oi[row])
            ox = _frac(p * K) - Ko
            oy = _mod7(jnp.floor(p * K)) * K - Ko
            dx = Pfx + dx_base + jitter * ox
            dy = Pfy - of[row] + jitter * oy
            d.append(dx * dx + dy * dy)
        return d

    d1 = column(px[0], 0.5)   # column x-1 → Pf.x + 0.5
    d2 = column(px[1], -0.5)  # column x   → Pf.x - 0.5
    d3 = column(px[2], -1.5)  # column x+1 → Pf.x - 1.5

    # sort out two smallest distances, elementwise (Ashima swap network)
    d1a = [jnp.minimum(a, b) for a, b in zip(d1, d2)]
    d2_ = [jnp.maximum(a, b) for a, b in zip(d1, d2)]
    d2_ = [jnp.minimum(a, b) for a, b in zip(d2_, d3)]
    d1_ = [jnp.minimum(a, b) for a, b in zip(d1a, d2_)]
    d2_ = [jnp.maximum(a, b) for a, b in zip(d1a, d2_)]

    # d1_.xy ordered
    swap_xy = d1_[0] < d1_[1]
    d1x = jnp.where(swap_xy, d1_[0], d1_[1])
    d1y = jnp.where(swap_xy, d1_[1], d1_[0])
    # d1_.xz ordered (F1 final in x)
    swap_xz = d1x < d1_[2]
    d1z = jnp.where(swap_xz, d1_[2], d1x)
    d1x = jnp.where(swap_xz, d1x, d1_[2])
    # F2 candidates
    d1y = jnp.minimum(d1y, d2_[1])
    d1z = jnp.minimum(d1z, d2_[2])
    d1y = jnp.minimum(d1y, d1z)
    d1y = jnp.minimum(d1y, d2_[0])
    return jnp.sqrt(d1x), jnp.sqrt(d1y)
