"""Flow map — virtual-pipes shallow-water relaxation producing a velocity map.

Reference: ``ComputeFlowStep`` / ``UpdateWaterStep`` / ``CreateVelocityField``
/ ``NormalizeMap`` / ``FillArrayJob``
(/root/reference/Geologic/FlowMap/FlowMapComponents.cs:16-204), orchestrated
by ``FlowMapStage.ScheduleAll`` (Geologic/Stage/FlowMapStage.cs:124-195).

Design (SURVEY.md §3.4): the reference schedules ``iterations``
pairs of row-parallel jobs with explicit double-buffer swap copies; here the
whole relaxation is one ``lax.scan`` over a pure step function — the
double-buffering is implicit in functional updates and the swap copies
vanish.  Neighbor access uses edge-clamped shifts, matching the clamped
``getIdx`` reads (diff against a clamped self-neighbor is 0 at borders,
which is exactly the reference's boundary behavior).

Normalization parity: the stage normalizes with *static* args
{normMin, normMax - normMin} = {-0.1, 0.2} by default (FlowMapStage.cs:22-23,
48-51) — not a computed range.

Divergence note: the reference allocates its flow buffers with
``NativeArrayOptions.UninitializedMemory`` and reads them in the first
iteration (FlowMapStage.cs:52-62) — i.e. undefined values.  We initialize
flows to zero (the only sane semantics; typically identical in practice
since Unity usually hands back zeroed pages).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_F32 = jnp.float32
TIMESTEP = 0.2
WATER_INIT = 1e-4  # FlowMapStage.cs:129


def shift_clamped(a, dz: int, dx: int):
    """out[z, x] = a[clamp(z + dz), clamp(x + dx)] — edge-replicated shift.

    Built from concatenated slices (not jnp.pad), so the phase bodies that
    share it lower to plain slices and concatenates."""
    if dz > 0:
        rep = jnp.broadcast_to(a[-1:, :], (dz,) + a.shape[1:])
        a = jnp.concatenate([a[dz:, :], rep], axis=0)
    elif dz < 0:
        rep = jnp.broadcast_to(a[:1, :], (-dz,) + a.shape[1:])
        a = jnp.concatenate([rep, a[:dz, :]], axis=0)
    if dx > 0:
        rep = jnp.broadcast_to(a[:, -1:], a.shape[:1] + (dx,))
        a = jnp.concatenate([a[:, dx:], rep], axis=1)
    elif dx < 0:
        rep = jnp.broadcast_to(a[:, :1], a.shape[:1] + (-dx,))
        a = jnp.concatenate([rep, a[:, :dx]], axis=1)
    return a


def compute_flow_step(height, water, flow_w, flow_e, flow_s, flow_n):
    """ComputeFlowStep (FlowMapComponents.cs:20-65).

    diff_d = (h + w) - (h + w)(neighbor d); flow_d' = max(0, flow_d + diff_d),
    rescaled by K = clamp(water / (Σflow · Δt), 0, 1); all-zero when Σ == 0.
    """
    total = height + water
    diff_w = total - shift_clamped(total, 0, -1)
    diff_e = total - shift_clamped(total, 0, 1)
    diff_s = total - shift_clamped(total, -1, 0)
    diff_n = total - shift_clamped(total, 1, 0)
    fw = jnp.maximum(0.0, flow_w + diff_w)
    fe = jnp.maximum(0.0, flow_e + diff_e)
    fs = jnp.maximum(0.0, flow_s + diff_s)
    fn = jnp.maximum(0.0, flow_n + diff_n)
    s = fw + fe + fs + fn
    k = jnp.where(s > 0.0, jnp.clip(water / (s * TIMESTEP), 0.0, 1.0), 0.0)
    return fw * k, fe * k, fs * k, fn * k


def update_water_step(water, flow_w, flow_e, flow_s, flow_n):
    """UpdateWaterStep (FlowMapComponents.cs:76-113): flux divergence."""
    flow_out = flow_w + flow_e + flow_s + flow_n
    flow_in = (
        shift_clamped(flow_e, 0, -1)
        + shift_clamped(flow_w, 0, 1)
        + shift_clamped(flow_n, -1, 0)
        + shift_clamped(flow_s, 1, 0)
    )
    return jnp.maximum(0.0, water + (flow_in - flow_out) * TIMESTEP)


def velocity_field(flow_w, flow_e, flow_s, flow_n):
    """CreateVelocityField (FlowMapComponents.cs:115-148): staggered flux →
    |velocity| magnitude."""
    dl = shift_clamped(flow_e, 0, -1) - flow_w
    dr = flow_e - shift_clamped(flow_w, 0, 1)
    dt = shift_clamped(flow_s, 1, 0) - flow_n
    db = flow_s - shift_clamped(flow_n, -1, 0)
    vx = (dl + dr) * 0.5
    vy = (dt + db) * 0.5
    return jnp.sqrt(vx * vx + vy * vy)


@partial(jax.jit, static_argnames=("iterations",))
def flow_map(height, iterations: int = 5, norm_min=-0.1, norm_max=0.1):
    """FlowMapStage end-to-end: fill water, iterate (flow, water), write
    normalized |velocity| over the height slice (FlowMapStage.cs:124-195).

    Returns the normalized velocity map (same shape as ``height``).
    """
    shape = height.shape
    water0 = jnp.full(shape, WATER_INIT, _F32)
    zeros = jnp.zeros(shape, _F32)

    def step(carry, _):
        water, fw, fe, fs, fn = carry
        fw, fe, fs, fn = compute_flow_step(height, water, fw, fe, fs, fn)
        water = update_water_step(water, fw, fe, fs, fn)
        return (water, fw, fe, fs, fn), None

    (water, fw, fe, fs, fn), _ = jax.lax.scan(
        step, (water0, zeros, zeros, zeros, zeros), None, length=iterations
    )
    v = velocity_field(fw, fe, fs, fn)
    rng = norm_max - norm_min
    v = jnp.where(rng < 1e-12, 0.0, v)
    return (v - norm_min) / rng
