"""Benchmark suite — measures the BASELINE.md configs on one GPU and prints
ONE JSON line:

    {"metric": ..., "value": N, "unit": "ms", "device": {...}}

Primary metric: wall-clock ms for the flagship 2048² tile step
(noise → Gauss-5 ×17 → flow map → erosion cycles → mesh) on one card.
Every result names the device it ran on (platform, device_kind, device
count and the card's power limit); a run that finds no GPU fails.

Detailed results for all configs land in bench_results.json.

Env knobs: NOIZE_BENCH_FAST=1 shrinks sizes for smoke runs;
NOIZE_BENCH_REPS overrides repetition count.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _time_fn(fn, *args, reps: int = 5, warmup: int = 2):
    """Median per-call latency (block every call)."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def _time_fn_pipelined(fn, *args, reps: int = 5, warmup: int = 2):
    """Throughput timing: dispatch all reps asynchronously, block once.

    This is the production-streaming number — it amortizes the host↔device
    dispatch round trip, which per-call latency timing double-counts."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    outs = [fn(*args) for _ in range(reps)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) * 1e3 / reps


_RTT_F = None


def _measure_rtt(pings: int = 5):
    """Live dispatch round-trip estimate: minimum wall time of a trivial
    scalar computation (the op itself is ~µs, so min(wall) ≈ RTT).  Each
    timed entry measures its own contemporaneous RTT — a stale value
    biases the entry by (error / reps)."""
    global _RTT_F
    import jax
    import jax.numpy as jnp

    if _RTT_F is None:
        _RTT_F = jax.jit(lambda x: x + 1.0)
        float(_RTT_F(jnp.float32(0.0)))  # compile once
    walls = []
    for i in range(pings):
        t0 = time.perf_counter()
        float(_RTT_F(jnp.float32(i)))
        walls.append((time.perf_counter() - t0) * 1e3)
    return max(min(walls), 1.0)


def _chained_min_wall(body_fn, reps, n_walls=3, seed0=2):
    """Min wall over ``n_walls`` executions of a ``reps``-chained scan
    (same one-jit chained-scalar shape as `_time_chained`).  Returns
    ``(min_wall_ms, walls_ms, first_call_s)`` — ``first_call_s`` is the
    first-call wall, i.e. compile PLUS one warm execution (near zero when
    the compilation cache hits), not pure compile time."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def run(key):
        def step(carry, k):
            return carry + body_fn(k), None
        total, _ = jax.lax.scan(step, jnp.float32(0.0),
                                jax.random.split(key, reps))
        return total

    t0 = time.perf_counter()
    float(run(jax.random.PRNGKey(seed0 - 1)))
    first_call_s = time.perf_counter() - t0
    walls = []
    for seed in range(seed0, seed0 + n_walls):
        t0 = time.perf_counter()
        float(run(jax.random.PRNGKey(seed)))
        walls.append((time.perf_counter() - t0) * 1e3)
    return min(walls), walls, first_call_s


def _time_slope(body_fn, reps_list=(2, 8), n_walls=3):
    """Slope-method timing for probe A/Bs: min walls at several chain
    lengths; per-call cost = (wall(hi) − wall(lo)) / (hi − lo), which
    cancels the fixed dispatch overhead WITHOUT an RTT estimate.  Use
    when comparing two kernels whose delta is smaller than the RTT
    jitter `_time_chained` subtracts; the headline bench entries keep
    the RTT-subtract method (one long chain uses the session better).
    Returns a dict with per-reps min walls, all walls, first-call
    times, and every pairwise slope."""
    mins, walls, firsts = {}, {}, {}
    for reps in reps_list:
        m, w, f = _chained_min_wall(body_fn, reps, n_walls=n_walls)
        mins[reps], walls[reps], firsts[reps] = m, w, f
    rl = sorted(reps_list)
    slopes = {
        f"slope_{hi}_{lo}": round((mins[hi] - mins[lo]) / (hi - lo), 3)
        for i, lo in enumerate(rl) for hi in rl[i + 1:]
    }
    return {
        "min_walls_ms": {str(k): round(v, 1) for k, v in mins.items()},
        "walls_ms": {str(k): [round(x, 1) for x in v]
                     for k, v in walls.items()},
        "first_call_s": {str(k): round(v, 1) for k, v in firsts.items()},
        **slopes,
    }


def _time_chained(body_fn, reps: int = 4, rtt_ms: float = None,
                  with_cost: bool = False, with_floor: bool = False):
    """Ground-truth device timing: scan ``reps`` executions of ``body_fn``
    (key -> scalar) inside one jit, read back the 4-byte total, subtract one
    dispatch RTT.

    ``with_cost``: also return XLA's per-call cost analysis (flops / bytes
    accessed, divided by ``reps``).

    ``with_floor``: also return the entry's measurement floor — the
    chained method run on a ~zero-cost body.  Entries within ~2× of
    their floor are indistinguishable from each other and are tagged
    ``floor_bound``."""
    import jax
    import jax.numpy as jnp

    def run(key):
        def body(carry, k):
            return carry + body_fn(k), None
        total, _ = jax.lax.scan(body, jnp.float32(0.0),
                                jax.random.split(key, reps))
        return total

    compiled = jax.jit(run).lower(jax.random.PRNGKey(11)).compile()
    cost = None
    if with_cost:
        try:
            ca = compiled.cost_analysis()
            if isinstance(ca, (list, tuple)):
                ca = ca[0]
            cost = {
                "gflops_per_call": round(
                    float(ca.get("flops", 0.0)) / reps / 1e9, 3),
                "gbytes_per_call": round(
                    float(ca.get("bytes accessed", 0.0)) / reps / 1e9, 3),
            }
        except Exception as e:  # cost analysis is best-effort
            cost = {"error": f"{type(e).__name__}: {e}"[:120]}
    float(compiled(jax.random.PRNGKey(11)))  # warmup
    if rtt_ms is None:
        rtt_ms = _measure_rtt()  # contemporaneous with the timed runs
    # two timed runs, take the MIN (dispatch jitter only adds)
    walls = []
    for seed in (12, 13):
        t0 = time.perf_counter()
        float(compiled(jax.random.PRNGKey(seed)))
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = min(walls)
    ms = max(wall - rtt_ms, wall * 0.2) / reps
    extras = []
    if with_cost:
        extras.append(cost)
    if with_floor:
        extras.append({"floor_ms": _null_floor(reps),
                       "rtt_ms": round(rtt_ms, 1)})
    if extras:
        return (ms, *extras)
    return ms


_NULL_FLOORS = {}


def _null_floor(reps: int) -> float:
    """The measurement floor at ``reps``: the chained-scalar method run on
    a ~zero-cost body (one uniform sample per step).  Whatever residual
    dispatch adds beyond the ping RTT (scan/readback latency, jitter)
    lands here; a real entry within ~2× of this value is an upper bound,
    not a distinguishable measurement.  Measured once per reps value per
    bench run, contemporaneous with the entries it labels."""
    if reps not in _NULL_FLOORS:
        import jax

        _NULL_FLOORS[reps] = round(_time_chained(
            lambda k: jax.random.uniform(k, ()), reps=reps), 3)
    return _NULL_FLOORS[reps]


def _safe(results, key, fn):
    try:
        results["configs"][key] = fn()
    except Exception as e:  # record the failure, keep benching
        results["configs"][key] = {"error": f"{type(e).__name__}: {e}"[:300]}


def _card() -> str:
    """Card name and power limit from nvidia-smi (a child process that
    does not import JAX)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main():
    import jax
    import jax.numpy as jnp

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{devices[0].platform!r}")
    from noize_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices),
              "card": _card()}

    from noize_tpu.app.flagship import make_tile_step
    from noize_tpu.core.tiles import TileSetMeta
    from noize_tpu.erosion.params import ErosionSettings
    from noize_tpu.ops import kernels as K
    from noize_tpu.ops import flow as FL
    from noize_tpu.ops.fractal import fractal

    fast = os.environ.get("NOIZE_BENCH_FAST") == "1"
    reps = int(os.environ.get("NOIZE_BENCH_REPS", "3" if fast else "5"))
    res = 256 if fast else 2048
    margin = 8 if fast else 16

    results = {"device": device, "fast_mode": fast, "configs": {}}

    # --- config 1: Perlin fractal 512² (NoiseStage only) --------------------
    r1 = 128 if fast else 512
    def _c1():
        def body(k):
            x = jax.random.randint(k, (), 0, 1000).astype(jnp.float32)
            return fractal(r1, x, 0, noise_type="Perlin", octaves=13,
                           hurst=0.4, noise_size=1700.0).sum()
        ms = _time_chained(body, reps=8)
        return {"ms": ms, "gcells_per_s": r1 * r1 / ms / 1e6}
    _safe(results, "1_perlin_512", _c1)

    # --- config 2: Simplex 13-oct + Gauss5 ×17 (README example #1) ----------
    r2 = 256 if fast else 2048
    taps = jnp.asarray(K.gaussian_taps(1.0, 5))

    def _c2():
        def body(k):
            x = jax.random.randint(k, (), 0, 1000).astype(jnp.float32)
            h = fractal(r2, x, 0, noise_type="Simplex", octaves=13,
                        hurst=0.4, noise_size=1700.0)
            def it(_, a):
                return K.separable_series(a, taps, taps, 1.0)
            return jax.lax.fori_loop(0, 17, it, h).sum()
        ms = _time_chained(body, reps=4)
        return {"ms": ms, "gcells_per_s": r2 * r2 / ms / 1e6}
    _safe(results, "2_simplex_gauss5x17", _c2)

    # --- config 3: flow map on filtered 1024² -------------------------------
    r3 = 256 if fast else 1024
    h3 = jax.block_until_ready(jax.jit(
        lambda: fractal(r3, 0, 0, noise_type="Simplex", octaves=8,
                        hurst=0.4, noise_size=1000.0))())
    def _c3():
        # the production FlowMapStage path
        from noize_tpu.pipeline.stages import FlowMapStage

        stage = FlowMapStage(iterations=5)

        def body(k):
            off = jax.random.uniform(k, ()) * 1e-4
            return stage.array_fn(h3 + off).sum()
        return {"ms": _time_chained(body, reps=8)}
    _safe(results, "3_flowmap_1024", _c3)

    # --- config 4: value erosion + Sobel2D + normalize -----------------------
    from noize_tpu.ops import filters as FI

    @jax.jit
    def f4(h):
        h = K.value_erosion(h)
        h = K.sobel2d(h)
        return FI.normalize(h)

    def _c4():
        def body(k):
            off = jax.random.uniform(k, ()) * 1e-4
            return f4(h3 + off).sum()
        return {"ms": _time_chained(body, reps=4)}
    _safe(results, "4_value_erosion_sobel", _c4)

    # --- config 5: 4×4 tiled multi-tile noise→erode→mesh heights -------------
    from noize_tpu.parallel import tiled as TL

    r5 = 64 if fast else 1024
    meta5 = TileSetMeta(
        tile_res=r5 - 2 * margin, tile_size=r5 - 2 * margin,
        generator_res=r5, height=1000, margin=margin,
    )
    es5 = ErosionSettings(
        PARTICLES_PER_CYCLE=250, MAXAGE=32, WATER_STEPS=4, CYCLES=1,
        PILING_RADIUS=8,
    )
    cfg5 = TL.TilePipelineConfig(
        meta=meta5, octaves=13, noise_size=1700.0, blur_iterations=17,
        erosion=es5, erosion_cycles=1,
    )
    origins = TL.grid_origins(meta5, 4, 4)
    def _c5():
        base = jnp.asarray(origins)

        def body(k):
            off = jax.random.randint(k, (), 0, 1000)
            return TL.tile_batch(cfg5, base + off).sum()
        ms = _time_chained(body, reps=2)
        return {"ms": ms, "tiles": 16, "ms_per_tile": ms / 16}
    _safe(results, "5_multitile_4x4", _c5)

    # config 5 with in-batch vertex emission (the reference's per-tile loop
    # ends with mesh regeneration — LiveErosion.cs:302-315)
    cfg5m = TL.TilePipelineConfig(
        meta=meta5, octaves=13, noise_size=1700.0, blur_iterations=17,
        erosion=es5, erosion_cycles=1, emit_mesh=True,
    )
    def _c5m():
        base = jnp.asarray(origins)

        def body(k):
            off = jax.random.randint(k, (), 0, 1000)
            out = TL.tile_batch(cfg5m, base + off)
            return out["height"].sum() + out["mesh_planes"].sum()
        ms = _time_chained(body, reps=2)
        return {"ms": ms, "tiles": 16, "ms_per_tile": ms / 16,
                "emits": "height + 12-plane vertex streams per tile"}
    _safe(results, "5_multitile_4x4_mesh", _c5m)

    # --- phase breakdown at headline size ------------------------------------
    # Every entry uses the chained-scalar method (scan K reps in ONE jit,
    # scalar readback).  Inputs are perturbed per scan step from the key so
    # XLA can't CSE the reps.  gflops/gbytes come from XLA cost_analysis
    # (per call).
    from noize_tpu.erosion.sim import erosion_cycle, init_state

    rb = 256 if fast else 2048
    meta_b = TileSetMeta(
        tile_res=rb - 2 * margin, tile_size=rb - 2 * margin,
        generator_res=rb, height=1000, margin=margin,
    )
    es_b = ErosionSettings()
    hb = jax.block_until_ready(jax.jit(
        lambda: fractal(rb, 0, 0, noise_type="Simplex", octaves=13,
                        hurst=0.4, noise_size=1700.0))())
    phases = {}

    def _eps(k):
        return jax.random.uniform(k, (), minval=0.0, maxval=1e-9)

    def _phase(name, body, reps=8, cells=None):
        try:
            ms, cost, floor = _time_chained(body, reps=reps, with_cost=True,
                                            with_floor=True)
            entry = {"ms": round(ms, 3), "method": "chained"}
            entry.update(floor)
            if ms <= 2.0 * floor["floor_ms"]:
                # within 2× of the RTT-jitter residual: the value is an
                # upper bound, not a distinguishable measurement
                entry["floor_bound"] = True
            if cost:
                entry.update(cost)
                if "gflops_per_call" in cost and ms > 0:
                    entry["achieved_gflops_per_s"] = round(
                        cost["gflops_per_call"] / ms * 1e3, 1)
            if cells is not None:
                entry["gcells_per_s"] = round(cells / ms / 1e6, 3)
            phases[name] = entry
        except Exception as e:
            phases[name] = {"error": f"{type(e).__name__}: {e}"[:200]}

    cells_b = rb * rb

    _phase("noise", lambda k: fractal(
        rb, jax.random.randint(k, (), 0, 1000).astype(jnp.float32), 0,
        noise_type="Simplex", octaves=13, hurst=0.4,
        noise_size=1700.0).sum(), cells=cells_b)

    def f_blur(h):
        def body(_, a):
            return K.separable_series(a, taps, taps, 1.0)
        return jax.lax.fori_loop(0, 17, body, h)

    _phase("blur_x17", lambda k: f_blur(hb + _eps(k)).sum(), cells=cells_b)
    _phase("flow_x8",
           lambda k: FL.flow_map(hb + _eps(k), iterations=8).sum(),
           cells=cells_b)

    def ero_body(k):
        st = init_state(hb + _eps(k), k)
        out = erosion_cycle(st, es_b, meta_b)
        return out.world.height.sum() + out.world.pool.sum()

    _phase("erosion_cycle", ero_body, reps=4)

    # erosion sub-phases (to target optimization)
    from noize_tpu.erosion import particles as PART
    from noize_tpu.erosion import pool as POOL
    from noize_tpu.erosion.world import WorldState

    params_b = es_b.as_parameters()

    def desc_body(k):
        parts = PART.spawn(k, es_b.PARTICLES_PER_CYCLE, rb)
        w = WorldState.create(hb + _eps(k))
        _, t, p_, s = PART.descend_all(
            parts, w, params_b, float(meta_b.height), meta_b.patch_res, rb)
        return t.sum() + p_.sum() + s.sum()

    _phase("descent_scan", desc_body, reps=4)

    pool0 = jnp.zeros_like(hb) + 1e-3

    def pool_body(fn):
        def body(k):
            p, d = fn(hb + _eps(k), pool0)
            return p[0, 0] + d.sum()
        return body

    _phase("pool_automata_x10", pool_body(
        lambda h, p: POOL.pool_automata(
            h, p, iterations=es_b.WATER_STEPS, drain_particles=True)))
    from noize_tpu.ops.thermal import thermal_erosion

    _phase("thermal", lambda k: thermal_erosion(
        hb + _eps(k), es_b.TALUS, es_b.THERMAL_STEP,
        float(meta_b.tile_size) / meta_b.height,
        iterations=es_b.THERMAL_CYCLES).sum(), cells=cells_b)

    # remaining erosion sub-pieces
    from noize_tpu.erosion import sediment as SED
    from noize_tpu.erosion import sim as SIM

    sed0 = jnp.zeros_like(hb).at[100, 100].set(-0.001)
    sedp = sed0.at[200, 200].set(0.01)  # one pile > threshold

    def sed_body(sed):
        def body(k):
            return SED.write_sediment_map(
                hb + _eps(k), sed, params_b, float(meta_b.height)).sum()
        return body

    _phase("sediment_write", sed_body(sed0))
    _phase("sediment_write_with_pile", sed_body(sedp))

    def spawn_body(k):
        parts, leftover, _ = SIM._spawn_with_drains(
            k, es_b.PARTICLES_PER_CYCLE, rb, jnp.zeros_like(hb))
        return parts.row.sum() + leftover.sum()

    _phase("spawn_with_drains", spawn_body)

    from noize_tpu.erosion.world import update_flow_from_track

    def uft_body(k):
        w = WorldState.create(hb + _eps(k))
        return update_flow_from_track(
            w, params_b, float(meta_b.height)).flow.sum()

    _phase("update_flow_from_track", uft_body)

    from noize_tpu.ops import mesh as MH

    def mesh_body(k):
        m = MH.heightmap_mesh_overshoot(
            hb + _eps(k), meta_b.tile_res, rb, 1000.0,
            float(meta_b.tile_size))
        # consume EVERY stream — a positions-only scalar lets XLA DCE the
        # finite-difference normals/tangents work (the expensive part,
        # reference Mesh/Generators/SquareGridHeightMap.cs:66-81) and
        # rigs the arrays-vs-planes A/B
        return (m.positions.sum() + m.normals.sum() + m.tangents.sum()
                + m.uvs.sum())

    _phase("mesh", mesh_body)

    def mesh_planes_body(k):
        m = MH.heightmap_mesh_overshoot_planes(
            hb + _eps(k), meta_b.tile_res, rb, 1000.0,
            float(meta_b.tile_size))
        return m.planes.sum()

    _phase("mesh_planes", mesh_planes_body)
    results["phase_breakdown"] = phases

    def _got(name):
        return phases.get(name, {}).get("ms")

    # --- interactive cycle latency (ErosionSim.step granularity at the
    # editor-interactive 1024² size — BASELINE.md build target row) -------
    def _ci():
        ri = 256 if fast else 1024
        meta_i = TileSetMeta(
            tile_res=ri - 2 * margin, tile_size=ri - 2 * margin,
            generator_res=ri, height=1000, margin=margin)
        hi_ = jax.block_until_ready(jax.jit(
            lambda: fractal(ri, 7, 0, noise_type="Simplex", octaves=13,
                            hurst=0.4, noise_size=1700.0))())

        def body(k):
            st = init_state(hi_ + _eps(k), k)
            out = erosion_cycle(st, es_b, meta_i)
            return out.world.height.sum() + out.world.pool.sum()

        ms, floor = _time_chained(body, reps=4, with_floor=True)
        entry = {"ms": ms, "resolution": ri}
        entry.update(floor)
        return entry
    _safe(results, "interactive_cycle_1024", _ci)

    # --- steady-state erosion at 2048²: state CARRIED across cycles --------
    # The flagship headline is a cold-start step (its 3 pool calls gate
    # off bit-exactly below pool.MIN_WATER).  A long-running LiveErosion
    # session accumulates water, so this entry chains K cycles on ONE
    # evolving state and reports the per-cycle cost at the evolved shape,
    # plus which cycles started with a wet pool (an 8-flag readback),
    # at the flagship 2048² shape and the interactive 1024² shape.
    # Reference: LiveErosion.cs:378-436 steady operation between editor
    # commits.
    def _make_steady(res_s, h_s, meta_s):
        def _cst():
            from noize_tpu.erosion import pool as _POOL

            K = 8

            @jax.jit
            def chained(key):
                st0 = init_state(h_s, key)

                def body(carry, k):
                    st, acc = carry
                    wet = jnp.any(st.world.pool >= _POOL.MIN_WATER)
                    st = erosion_cycle(st, es_b, meta_s)
                    acc = acc + st.world.height.sum() + st.world.pool.sum()
                    return (st, acc), wet

                (st, total), wets = jax.lax.scan(
                    body, (st0, jnp.float32(0.0)), jax.random.split(key, K))
                return total, wets

            t, wets = chained(jax.random.PRNGKey(21))  # warmup
            float(t)
            wet_flags = [bool(x) for x in np.asarray(jax.device_get(wets))]
            walls = []
            for seed in (22, 23):
                t0 = time.perf_counter()
                t, _ = chained(jax.random.PRNGKey(seed))
                float(t)
                walls.append((time.perf_counter() - t0) * 1e3)
            wall = min(walls)
            rtt = _measure_rtt()
            return {
                "ms_per_cycle": round(max(wall - rtt, wall * 0.5) / K, 3),
                "cycles_chained": K,
                "wet_pool_cycles": wet_flags,
                "n_wet": int(sum(wet_flags)),
                "rtt_ms_used": round(rtt, 2),
                "resolution": res_s,
            }
        return _cst

    _safe(results, "erosion_steady_2048", _make_steady(rb, hb, meta_b))
    ri_s = 256 if fast else 1024
    meta_i_s = TileSetMeta(
        tile_res=ri_s - 2 * margin, tile_size=ri_s - 2 * margin,
        generator_res=ri_s, height=1000, margin=margin)
    hi_s = jax.block_until_ready(jax.jit(
        lambda: fractal(ri_s, 3, 0, noise_type="Simplex", octaves=13,
                        hurst=0.4, noise_size=1700.0))())
    _safe(results, "erosion_steady_1024", _make_steady(ri_s, hi_s, meta_i_s))

    # --- live-retune latency: a param tweak between steps must reuse the
    # compiled cycle (erosion/params.py TUNABLE_FIELDS split)
    def _cr():
        from dataclasses import replace as _dc_replace

        ri = 256 if fast else 1024
        meta_i = TileSetMeta(
            tile_res=ri - 2 * margin, tile_size=ri - 2 * margin,
            generator_res=ri, height=1000, margin=margin)
        hi_ = jax.block_until_ready(jax.jit(
            lambda: fractal(ri, 9, 0, noise_type="Simplex", octaves=13,
                            hurst=0.4, noise_size=1700.0))())
        st0 = init_state(hi_, jax.random.PRNGKey(5))

        def step_with(settings):
            s = erosion_cycle(st0, settings.canonical(), meta_i,
                              tuned=settings.tunable_values())
            return float((s.world.height.sum() + s.world.pool.sum()))

        step_with(es_b)  # compile once
        cache0 = erosion_cycle._cache_size()
        for tweak in ({"EROSION": 0.37}, {"GRAVITY": 1.31},
                      {"EVAP": 0.021}):
            step_with(_dc_replace(es_b, **tweak))
        recompiles = erosion_cycle._cache_size() - cache0

        # Latency via the standard chained-scalar method: every scan step
        # derives FRESH tunable values from its key — the slider-tweak
        # workload — through the same compiled fn the host-side recompile
        # check exercised above.
        canon = es_b.canonical()
        base = es_b.tunable_values()

        def body(k):
            tuned = dict(base)
            tuned["EROSION"] = base["EROSION"] * (
                0.9 + 0.2 * jax.random.uniform(k, ()))
            tuned["GRAVITY"] = base["GRAVITY"] * (
                0.9 + 0.2 * jax.random.uniform(jax.random.fold_in(k, 1), ()))
            s = erosion_cycle(st0, canon, meta_i, tuned=tuned)
            return s.world.height.sum() + s.world.pool.sum()

        ms, floor = _time_chained(body, reps=8, with_floor=True)
        entry = {
            "ms_per_retuned_step": round(ms, 3),
            "method": "chained",
            "recompiles": recompiles,
            "resolution": ri,
        }
        entry.update(floor)
        return entry
    _safe(results, "interactive_retune", _cr)

    # --- per-kernel throughput at saturating sizes (BASELINE.md Gcells/s) ---
    throughput = {}
    for rt in ([256] if fast else [2048, 4096]):
        sizes = {}
        ht = jax.block_until_ready(jax.jit(
            lambda: fractal(rt, 0, 0, noise_type="Simplex", octaves=13,
                            hurst=0.4, noise_size=1700.0))())
        cells = rt * rt

        def tp(name, body, reps=8):
            try:
                ms, cost = _time_chained(body, reps=reps, with_cost=True)
                e = {"ms": round(ms, 3),
                     "gcells_per_s": round(cells / ms / 1e6, 3)}
                if cost:
                    e.update(cost)
                    if "gflops_per_call" in cost and ms > 0:
                        e["achieved_gflops_per_s"] = round(
                            cost["gflops_per_call"] / ms * 1e3, 1)
                sizes[name] = e
            except Exception as e:
                sizes[name] = {"error": f"{type(e).__name__}: {e}"[:200]}

        tp("noise_13oct", lambda k: fractal(
            rt, jax.random.randint(k, (), 0, 1000).astype(jnp.float32), 0,
            noise_type="Simplex", octaves=13, hurst=0.4,
            noise_size=1700.0).sum())
        tp("gauss5_x1", lambda k: K.separable_series(
            ht + _eps(k), taps, taps, 1.0).sum())
        tp("sobel2d", lambda k: K.sobel2d(ht + _eps(k)).sum())
        tp("value_erosion", lambda k: K.value_erosion(ht + _eps(k)).sum())
        tp("thermal_x1", lambda k: thermal_erosion(
            ht + _eps(k), es_b.TALUS, es_b.THERMAL_STEP, 1.0,
            iterations=1).sum())
        tp("flow_step_x1", lambda k: FL.flow_map(
            ht + _eps(k), iterations=1).sum())
        throughput[f"{rt}x{rt}"] = sizes
    results["kernel_throughput"] = throughput

    # --- config 6: large-field pipeline (8192² — the sharded-path scale; on
    # one card it exercises the device-resident path; the mesh version is
    # correctness-tested on CPU in tests/test_parallel.py) ----------------
    r6 = 512 if fast else 8192

    def _c6():
        def body(k):
            x = jax.random.randint(k, (), 0, 1000).astype(jnp.float32)
            h = fractal(r6, x, 0, noise_type="Simplex", octaves=13,
                        hurst=0.4, noise_size=1700.0)

            def it(_, a):
                return K.separable_series(a, taps, taps, 1.0)

            h = jax.lax.fori_loop(0, 17, it, h)
            h = thermal_erosion(h, es_b.TALUS, es_b.THERMAL_STEP, 1.0,
                                iterations=es_b.THERMAL_CYCLES)
            return FL.flow_map(h, iterations=8).sum()
        ms = _time_chained(body, reps=2)
        return {"ms": ms, "gcells_per_s": r6 * r6 / ms / 1e6,
                "pipeline": "noise13 + gauss5x17 + thermal + flow8"}
    _safe(results, "6_large_field_8192", _c6)

    # --- headline: flagship 2048² full step ---------------------------------
    meta = TileSetMeta(
        tile_res=res - 2 * margin, tile_size=res - 2 * margin,
        generator_res=res, height=1000, margin=margin,
    ).validate()
    settings = ErosionSettings()  # reference defaults: 1000 particles, MAXAGE 100
    # Mesh layout: planes (component-major [12,R+1,R+1], see
    # ops.mesh.MeshPlanes) unless arrays measures CLEARLY faster in this
    # run, so run-to-run jitter does not flip the choice.
    mesh_arr_ms = _got("mesh")
    mesh_pl_ms = _got("mesh_planes")
    flag_layout = ("arrays" if mesh_arr_ms and mesh_pl_ms
                   and mesh_arr_ms < 0.95 * mesh_pl_ms else "planes")
    step, _, _ = make_tile_step(
        meta, settings,
        octaves=13, blur_iterations=17, flow_iterations=8,
        erosion_cycles=settings.CYCLES, emit_mesh=True,
        mesh_layout=flag_layout,
    )
    key = jax.random.PRNGKey(0)
    try:
        ms_lat, times = _time_fn(step, np.float32(0), np.float32(0), key, reps=reps)
        ms_pipe = _time_fn_pipelined(step, np.float32(0), np.float32(0), key, reps=reps)

        # K steps chained inside ONE jit with a scalar output (4-byte
        # readback): (wall - one dispatch RTT) / K.
        K = 8

        @jax.jit
        def chained(key):
            def body(carry, k):
                out = step(
                    jax.random.uniform(k, (), minval=0, maxval=1000.0),
                    jax.random.uniform(jax.random.fold_in(k, 1), (),
                                       minval=0, maxval=1000.0),
                    k,
                )
                s = out["height"].sum() + out["stream"].sum()
                if "mesh" in out:
                    m = out["mesh"]
                    if flag_layout == "planes":
                        s = s + m.planes.sum()
                    else:
                        # all four streams: see mesh_body DCE note
                        s = s + (m.positions.sum() + m.normals.sum()
                                 + m.tangents.sum() + m.uvs.sum())
                return carry + s, None
            total, _ = jax.lax.scan(body, jnp.float32(0.0),
                                    jax.random.split(key, K))
            return total

        float(chained(jax.random.PRNGKey(1)))  # warmup
        walls = []
        for seed in (2, 3, 4):
            t0 = time.perf_counter()
            float(chained(jax.random.PRNGKey(seed)))
            walls.append((time.perf_counter() - t0) * 1e3)
        wall = min(walls)
        rtt = _measure_rtt()
        ms = max(wall - rtt, wall * 0.5) / K
        # auditability: every chained wall, the live RTT subtracted, and
        # the per-step min/max implied by the wall spread
        results["flagship_2048"] = {
            "ms": ms, "chained_wall_ms": wall, "chained_steps": K,
            "chained_walls_ms": [round(w, 2) for w in walls],
            "chained_ms_min": round(max(min(walls) - rtt,
                                        min(walls) * 0.5) / K, 3),
            "chained_ms_max": round(max(max(walls) - rtt,
                                        max(walls) * 0.5) / K, 3),
            "rtt_ms_used": round(rtt, 2),
            "pipelined_ms": ms_pipe, "latency_ms": ms_lat, "all_ms": times,
            "resolution": res, "mesh_layout": flag_layout,
        }
    except Exception as e:
        results["flagship_2048"] = {"error": f"{type(e).__name__}: {e}"[:300]}
        ms = float("nan")

    # --- host-side IO: mesh export throughput -------------------------------
    # the serving hand-off is a host write (mesh_export.to_obj via
    # native/serde_native.cpp::nz_obj_write); measured here so export
    # regressions surface alongside the device numbers
    try:
        import tempfile

        from noize_tpu import native as _nat

        rng_io = np.random.default_rng(3)
        nio = 513 * 513
        posn = rng_io.uniform(-1e3, 1e3, (nio, 3)).astype(np.float32)
        nrmn = rng_io.uniform(-1, 1, (nio, 3)).astype(np.float32)
        uvn = rng_io.uniform(0, 1, (nio, 2)).astype(np.float32)
        idxn = np.arange(512 * 512 * 6, dtype=np.uint32) % nio
        with tempfile.TemporaryDirectory() as td:
            t0 = time.perf_counter()
            nbytes = _nat.obj_write(os.path.join(td, "t.obj"), "bench",
                                    posn, nrmn, uvn, idxn)
            dt = time.perf_counter() - t0
        results["host_io"] = {
            "obj_export_512sq_ms": round(dt * 1e3, 1),
            "obj_export_mb_per_s": round(nbytes / dt / 1e6, 1),
            "writer": "native",
        }
    except Exception as e:
        results["host_io"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    with open(os.path.join(os.path.dirname(__file__) or ".", "bench_results.json"), "w") as fh:
        json.dump(results, fh, indent=1)

    ok = ms == ms  # not NaN
    print(json.dumps({
        "metric": f"flagship {res}^2 tile: noise+gauss5x17+flow+erosion(3cyc)+mesh",
        "value": round(ms, 3) if ok else -1,
        "unit": "ms",
        "device": device,
    }))


if __name__ == "__main__":
    main()
