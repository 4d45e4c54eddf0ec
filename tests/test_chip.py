"""On-card parity of the field phases (skips without a GPU): each jitted
phase on the GPU against the same function on the CPU, within the
tolerances chip_smoke.py states and explains."""

import importlib.util
import os

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tolerances():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TOLERANCES


@pytest.mark.chip
@pytest.mark.parametrize("phase", ["noise", "blur_x17", "flow_x8", "thermal"])
def test_field_phase_matches_cpu(gpu, phase):
    from noize_tpu.app.flagship import _blur_chain
    from noize_tpu.ops.flow import flow_map
    from noize_tpu.ops.fractal import fractal
    from noize_tpu.ops.thermal import thermal_erosion

    res = 256
    with jax.default_device(jax.devices("cpu")[0]):
        noise = np.asarray(fractal(res, 0.0, 0.0, noise_type="Simplex",
                                   octaves=13, hurst=0.4, noise_size=1700.0))
    fns = {
        "noise": lambda _: fractal(res, 0.0, 0.0, noise_type="Simplex",
                                   octaves=13, hurst=0.4, noise_size=1700.0),
        "blur_x17": lambda h: _blur_chain(h, 5, 1.0, 17),
        "flow_x8": lambda h: flow_map(h, iterations=8),
        "thermal": lambda h: thermal_erosion(h, 55.0, 0.6, 2.0),
    }
    outs = []
    for dev in (gpu, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            outs.append(np.asarray(jax.jit(fns[phase])(
                jax.device_put(noise, dev))))
    err = float(np.max(np.abs(outs[0].astype(np.float64) - outs[1])))
    assert err <= _tolerances()[phase], err
