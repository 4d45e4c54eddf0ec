"""Pipeline layer tests: stages, composition, masking, fusion, driver."""

import time

import numpy as np
import pytest
import jax.numpy as jnp

from noize_tpu.core.stageio import DownsampleData, GeneratorData, MeshStageData, ReduceData
from noize_tpu.core.store import PipelineStateManager
from noize_tpu.pipeline import stages as S
from noize_tpu.pipeline.compose import (
    PipelineDefinition, ReducePipeline, StageMask, fuse, run_stages,
)
from noize_tpu.pipeline.driver import Pipeline
from noize_tpu.pipeline.stage import PipelineWorkItem, RequirementError

RNG = np.random.default_rng(13)


def gen(res=32, **kw):
    return GeneratorData(uuid=kw.pop("uuid", "t"), resolution=res,
                         xpos=kw.pop("xpos", 0), zpos=kw.pop("zpos", 0),
                         data=kw.pop("data", None))


class TestStages:
    def test_noise_stage(self):
        out = Pipeline([S.NoiseStage(noiseType="Perlin", octaves=3)]).run(gen())
        assert np.asarray(out.data).shape == (32, 32)

    def test_stage_chain_matches_ops(self):
        from noize_tpu.ops import kernels as K
        from noize_tpu.ops.fractal import fractal

        out = Pipeline([
            S.NoiseStage(noiseType="Simplex", octaves=4, noiseSize=200),
            S.KernelFilterStage(filter="Gauss5_S1", iterations=2),
        ]).run(gen())
        want = K.kernel_filter(
            fractal(32, 0, 0, noise_type="Simplex", octaves=4, noise_size=200.0),
            "Gauss5_S1", 2,
        )
        np.testing.assert_allclose(np.asarray(out.data), np.asarray(want), atol=1e-7)

    def test_smooth_blur_stage_matches_op(self):
        from noize_tpu.ops import blur as B
        from noize_tpu.ops.fractal import fractal

        out = Pipeline([
            S.NoiseStage(noiseType="Perlin", octaves=3, noiseSize=200),
            S.StageSmoothBlur(width=3, iterations=2),
        ]).run(gen())
        want = fractal(32, 0, 0, noise_type="Perlin", octaves=3,
                       noise_size=200.0)
        for _ in range(2):
            want = B.smooth_blur(want, 3)
        np.testing.assert_allclose(np.asarray(out.data), np.asarray(want),
                                   atol=1e-7)

    def test_generator_pipeline_subclass(self):
        # Scripts/GeneratorPipeline.cs:11-13 — trivial concrete pipeline;
        # behaves exactly like Pipeline
        from noize_tpu.pipeline.driver import GeneratorPipeline

        out = GeneratorPipeline(
            [S.NoiseStage(noiseType="Perlin", octaves=3)]).run(gen())
        assert np.asarray(out.data).shape == (32, 32)

    def test_requirement_error(self):
        with pytest.raises(RequirementError):
            S.KernelFilterStage().apply(PipelineWorkItem(data=ReduceData()))

    def test_reduce_stage_transforms_payload(self):
        a = jnp.asarray(RNG.uniform(0, 1, (16, 16)).astype(np.float32))
        b = jnp.asarray(RNG.uniform(0, 1, (16, 16)).astype(np.float32))
        w = S.ReduceStage(operation="SUBTRACT").apply(PipelineWorkItem(
            data=ReduceData(uuid="r", resolution=16, data=a, right_data=b)))
        assert isinstance(w.data, GeneratorData)  # TransformData parity
        np.testing.assert_allclose(np.asarray(w.data.data), np.asarray(a - b))

    def test_crop_stage(self):
        a = jnp.asarray(RNG.uniform(0, 1, (16, 16)).astype(np.float32))
        w = S.CropStage().apply(PipelineWorkItem(data=DownsampleData(
            uuid="c", resolution=8, inputResolution=16, inputData=a)))
        np.testing.assert_array_equal(np.asarray(w.data.data), np.asarray(a)[:8, :8])

    def test_curve_stage_from_function(self):
        st = S.CurveStage.from_function(lambda t: t * t, samples=64)
        assert len(st.curve) == 64
        out = Pipeline([S.NoiseStage(octaves=2), st]).run(gen())
        arr = np.asarray(out.data)
        assert arr.min() >= 0 and arr.max() <= 1

    def test_thermal_stage(self):
        a = jnp.asarray(RNG.uniform(0, 2, (24, 24)).astype(np.float32))
        w = S.StageThermalErosion(iterations=2, talus=30).apply(
            PipelineWorkItem(data=gen(24, data=a)))
        np.testing.assert_allclose(
            float(np.asarray(w.data.data).sum()), float(np.asarray(a).sum()),
            rtol=1e-5)

    def test_constant_stage(self):
        a = jnp.asarray(RNG.uniform(0, 1, (8, 8)).astype(np.float32))
        w = S.ConstantStage(operation="BINARIZE", value=0.5).apply(
            PipelineWorkItem(data=gen(8, data=a)))
        assert set(np.unique(np.asarray(w.data.data))) <= {0.0, 1.0}


class TestContextStages:
    def test_write_then_read(self):
        sm = PipelineStateManager()
        a = jnp.asarray(RNG.uniform(0, 1, (16, 16)).astype(np.float32))
        wi = PipelineWorkItem(data=gen(16, data=a, xpos=32, zpos=64),
                              state_manager=sm)
        S.WriteGeneratorContextStage(contextAlias="CTX").apply(wi)
        assert sm.buffer_exists("32_64__16__CTX")
        wi2 = PipelineWorkItem(data=gen(16, xpos=32, zpos=64), state_manager=sm)
        out = S.ReadGeneratorContextStage(contextAlias="CTX").apply(wi2)
        np.testing.assert_array_equal(np.asarray(out.data.data), np.asarray(a))

    def test_read_gate(self):
        sm = PipelineStateManager()
        st = S.ReadGeneratorContextStage(contextAlias="MISSING")
        wi = PipelineWorkItem(data=gen(8), state_manager=sm)
        assert not st.is_schedulable(wi)
        assert not st.is_schedulable(PipelineWorkItem(data=gen(8)))  # no mgr


class TestComposition:
    def test_definition_and_mask(self):
        d = PipelineDefinition("p", (S.NoiseStage(), S.KernelFilterStage(),
                                     S.FlowMapStage()))
        m = d.masked(StageMask(disabled=(1,)))
        assert len(m.stages) == 2
        assert isinstance(m.stages[1], S.FlowMapStage)

    def test_fuse_matches_run(self):
        stages = [S.NoiseStage(noiseType="Perlin", octaves=3, noiseSize=120),
                  S.StageGaussianBlur(sigma="s1d00", width=5, iterations=2)]
        f = fuse(stages, 24)
        fused = np.asarray(f(None, 0, 0))
        staged = np.asarray(Pipeline(stages).run(gen(24)).data)
        np.testing.assert_allclose(fused, staged, atol=1e-7)

    def test_reduce_pipeline(self):
        rp = ReducePipeline(
            left=[S.NoiseStage(octaves=2, noiseSize=70)],
            right=[S.NoiseStage(octaves=2, noiseSize=70),
                   S.ConstantStage(operation="MULTIPLY", value=0.5)],
            reduce_stage=S.ReduceStage(operation="SUBTRACT"),
        )
        out = rp.run(PipelineWorkItem(data=gen(16)))
        left = np.asarray(Pipeline([S.NoiseStage(octaves=2, noiseSize=70)]).run(gen(16)).data)
        np.testing.assert_allclose(np.asarray(out.data.data), left * 0.5, atol=1e-6)


class TestDriver:
    def test_async_enqueue_complete(self):
        done = []
        p = Pipeline([S.NoiseStage(octaves=2)]).start()
        for i in range(3):
            p.enqueue(gen(16, uuid=f"t{i}"), on_complete=lambda d: done.append(d.uuid))
        assert p.drain(timeout=30)
        time.sleep(0.1)
        p.stop()
        assert sorted(done) == ["t0", "t1", "t2"]

    def test_callbacks_order(self):
        events = []
        p = Pipeline([S.NoiseStage(octaves=1)])
        w = PipelineWorkItem(data=gen(8), on_scheduled=lambda d: events.append("sched"),
                             on_complete=lambda d: events.append("done"))
        run_stages(p.stages, w)
        assert events == ["sched", "done"]


class TestDriverErrors:
    def test_failed_stage_logged_not_fatal(self, caplog):
        import logging

        class Boom(S.NoiseStage):
            def apply(self, work):
                raise RuntimeError("kaboom")

        p = Pipeline([Boom()]).start()
        with caplog.at_level(logging.ERROR, logger="noize_tpu.pipeline"):
            p.enqueue(gen(8, uuid="x"))
            p.enqueue(gen(8, uuid="x2"))
            import time as _t
            _t.sleep(0.5)
        p.stop()
        assert any("stage cascade failed" in r.message for r in caplog.records)

