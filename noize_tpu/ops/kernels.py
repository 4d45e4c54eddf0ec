"""Separable stencil kernels — the reference's Filter/Kernel suite.

Reference: ``GenericKernelJob`` + ``KernelSampleX/ZOperator`` +
``KernelMinX/ZOperator`` (/root/reference/Filter/Kernel/KernelJob.cs:17-72,
KernelOperators.cs:18-118) and the tap tables / dispatch in
``SeparableKernelFilter`` (KernelJob.cs:96-307).

Design: a 1-D pass is expressed as K edge-padded shifted adds, which XLA
fuses into a single elementwise loop — no per-row job scheduling, no
double-buffer copy-back (``TileHelpers.SWAP_RWTILE``) because updates are
functional.  Borders replicate the edge sample, exactly matching the
reference's clamped ``getIdx`` (TileData.cs:72-77).

Semantics quirks preserved from the reference:
  * the Z pass applies the kernel *flipped* relative to the X pass
    (KernelOperators.cs:61-63 walks k from +off down to -off while indexing
    ``Kernel[k_off - k]``) — irrelevant for symmetric taps, load-bearing for
    Sobel/Prewitt;
  * the min-filter window excludes the top tap (``k < k_off``,
    KernelOperators.cs:86,112): a 3-wide "min" looks at offsets {-1, 0}.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

_F32 = jnp.float32


def _pad_x(a, off):
    return jnp.pad(a, ((0, 0), (off, off)), mode="edge")


def _pad_z(a, off):
    return jnp.pad(a, ((off, off), (0, 0)), mode="edge")


def conv_x(a, taps, factor=1.0):
    """1-D correlation along x (columns): out[z,x] = Σ_d a[z, x+d]·taps[off+d]."""
    k = len(taps)
    off = (k - 1) // 2
    h, w = a.shape
    ap = _pad_x(a, off)
    out = jnp.zeros_like(a)
    for i in range(k):
        out = out + taps[i] * ap[:, i:i + w]
    return out * factor


def conv_z(a, taps, factor=1.0):
    """1-D pass along z (rows) with the reference's flipped indexing:
    out[z,x] = Σ_d a[z+d, x]·taps[off-d]  (KernelOperators.cs:58-65)."""
    k = len(taps)
    off = (k - 1) // 2
    h, w = a.shape
    ap = _pad_z(a, off)
    out = jnp.zeros_like(a)
    for i in range(k):
        # tap i multiplies the sample at offset d = off - i
        out = out + taps[i] * ap[2 * off - i:2 * off - i + h, :]
    return out * factor


def separable_series(a, taps_x, taps_z, factor=1.0):
    """X pass then Z pass (SeparableKernelFilter.ScheduleSeries, KernelJob.cs:165-185)."""
    return conv_z(conv_x(a, taps_x, factor), taps_z, factor)


def min_x(a, size):
    """Min filter along x over offsets [-off, off) — note the open top end
    (KernelOperators.cs:86)."""
    off = (size - 1) // 2
    h, w = a.shape
    ap = _pad_x(a, off)
    out = jnp.full_like(a, jnp.finfo(_F32).max)
    for i in range(2 * off):  # offsets -off .. off-1
        out = jnp.minimum(out, ap[:, i:i + w])
    return out


def min_z(a, size):
    off = (size - 1) // 2
    h, w = a.shape
    ap = _pad_z(a, off)
    out = jnp.full_like(a, jnp.finfo(_F32).max)
    for i in range(2 * off):
        out = jnp.minimum(out, ap[i:i + h, :])
    return out


def value_erosion(a, size=3):
    """ErosionKernelJob (KernelJob.cs:317-347): min-X pass then min-Z pass."""
    return min_z(min_x(a, size), size)


# ---------------------------------------------------------------------------
# tap tables (SeparableKernelFilter, KernelJob.cs:97-136)
# ---------------------------------------------------------------------------

def gaussian_taps(sigma: float, width: int) -> np.ndarray:
    """Normalized Gaussian taps exp(-k²/2σ²)/Σ — reproduces the reference's
    precomputed tables bit-for-bit at float32 (KernelJob.cs:97-105,
    BlurKernels.cs:46-320 are exactly these values)."""
    off = (width - 1) // 2
    k = np.arange(-off, off + 1, dtype=np.float64)
    t = np.exp(-(k * k) / (2.0 * sigma * sigma))
    return (t / t.sum()).astype(np.float32)


_SMOOTH3 = np.array([1.0, 1.0, 1.0], np.float32)
_SMOOTH3_FACTOR = 1.0 / 3.0
_SOBEL3_HX = np.array([-1.0, 0.0, 1.0], np.float32)
_SOBEL3_HZ = np.array([1.0, 2.0, 1.0], np.float32)
_SOBEL3_VX = np.array([1.0, 2.0, 1.0], np.float32)
_SOBEL3_VZ = np.array([1.0, 0.0, -1.0], np.float32)
_PREWITT3_HX = np.array([1.0, 0.0, -1.0], np.float32)
_PREWITT3_HZ = np.array([1.0, 1.0, 1.0], np.float32)
_PREWITT3_VX = np.array([1.0, 1.0, 1.0], np.float32)
_PREWITT3_VZ = np.array([-1.0, 0.0, 1.0], np.float32)

#: KernelFilterType enum parity (KernelJob.cs:79-94).
KERNEL_FILTER_TYPES = (
    "Gauss9_S1", "Gauss7_S1", "Gauss5_S1", "Gauss3_S1",
    "Gauss9_S2", "Gauss7_S2", "Gauss5_S2", "Gauss3_S2",
    "Smooth3",
    "Sobel3Horizontal", "Sobel3Vertical", "Sobel3_2D",
    "Prewitt3Horizontal", "Prewitt3Vertical",
)

_SERIES_TABLE = {
    "Gauss9_S1": (gaussian_taps(1.0, 9), gaussian_taps(1.0, 9), 1.0),
    "Gauss7_S1": (gaussian_taps(1.0, 7), gaussian_taps(1.0, 7), 1.0),
    "Gauss5_S1": (gaussian_taps(1.0, 5), gaussian_taps(1.0, 5), 1.0),
    "Gauss3_S1": (gaussian_taps(1.0, 3), gaussian_taps(1.0, 3), 1.0),
    "Gauss9_S2": (gaussian_taps(2.0, 9), gaussian_taps(2.0, 9), 1.0),
    "Gauss7_S2": (gaussian_taps(2.0, 7), gaussian_taps(2.0, 7), 1.0),
    "Gauss5_S2": (gaussian_taps(2.0, 5), gaussian_taps(2.0, 5), 1.0),
    "Gauss3_S2": (gaussian_taps(2.0, 3), gaussian_taps(2.0, 3), 1.0),
    "Smooth3": (_SMOOTH3, _SMOOTH3, _SMOOTH3_FACTOR),
    "Sobel3Horizontal": (_SOBEL3_HX, _SOBEL3_HZ, 1.0),
    "Sobel3Vertical": (_SOBEL3_VX, _SOBEL3_VZ, 1.0),
    "Prewitt3Horizontal": (_PREWITT3_HX, _PREWITT3_HZ, 1.0),
    "Prewitt3Vertical": (_PREWITT3_VX, _PREWITT3_VZ, 1.0),
}


def sobel2d(a):
    """Sobel3_2D: run H and V full separable passes on the same input, then
    combine by root-sum-squares (ScheduleReduce, KernelJob.cs:187-215).

    Note the reference's B pass reads a pre-pass *copy* of the input
    (KernelJob.cs:199-209), so both passes see the original data — the
    functional form here is the same computation without the copy.
    """
    ha = separable_series(a, _SOBEL3_HX, _SOBEL3_HZ, 1.0)
    va = separable_series(a, _SOBEL3_VX, _SOBEL3_VZ, 1.0)
    return jnp.sqrt(ha * ha + va * va)


def kernel_filter(a, filter_type: str, iterations: int = 1):
    """KernelFilterStage: apply ``filter_type`` ``iterations`` times
    (KernelFilterStage.cs:32-43)."""
    if filter_type not in KERNEL_FILTER_TYPES:
        raise ValueError(f"unknown filter {filter_type!r}")
    for _ in range(iterations):
        if filter_type == "Sobel3_2D":
            a = sobel2d(a)
        else:
            tx, tz, factor = _SERIES_TABLE[filter_type]
            a = separable_series(a, tx, tz, factor)
    return a
