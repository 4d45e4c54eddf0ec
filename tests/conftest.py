"""Test config: a virtual 8-device CPU mesh, set before JAX initializes.

Mirrors the SURVEY.md §4 test strategy: multi-device sharding is validated
on a faked host-device mesh; numerics are validated against float32 NumPy
oracles (the Burst reference is float32), so tests run anywhere.  The
persistent compilation cache (noize_tpu.utils.compile_cache) keeps re-runs
fast.

Tests that need a GPU carry the ``chip`` marker and take the ``gpu``
fixture, which skips them when JAX finds no GPU.  Run them on the card with
    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m chip
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from noize_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

# Inner-loop subset: `pytest -m quick` runs the oracle/parity cores (noise,
# fractal, filters, flow, curves, pool/thermal/sediment oracles) in a few
# minutes.  Module-level marking keeps the list in one place.
_QUICK_MODULES = {
    "test_core", "test_noise", "test_fractal", "test_filters", "test_flow",
    "test_curves", "test_misc", "test_erosion", "test_mesh",
    "test_mesh_export",
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "quick: fast oracle/parity core (inner-loop subset)")
    config.addinivalue_line(
        "markers", "chip: needs a GPU; skips elsewhere (see the gpu fixture)")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX finds none (decided
    here, at run time, never while modules are imported)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {dev.platform}")
    return dev


def pytest_sessionstart(session):
    """Refuse to run if any test module shadows a definition.

    Python silently rebinds duplicate top-level names, so a second
    `class TestFoo` makes the first one's tests vanish from collection.
    An AST scan catches duplicate top-level
    classes/functions and duplicate methods within a class body.
    """
    import ast
    import pathlib

    problems = []
    for path in sorted(pathlib.Path(__file__).parent.glob("test_*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))

        def check(body, scope):
            seen = {}
            for node in body:
                if isinstance(node, (ast.ClassDef, ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    if node.name in seen:
                        problems.append(
                            f"{path.name}:{node.lineno} `{node.name}` "
                            f"shadows {scope}:{seen[node.name]}")
                    seen[node.name] = node.lineno
                    if isinstance(node, ast.ClassDef):
                        check(node.body, f"{path.name}::{node.name}")

        check(tree.body, path.name)
    if problems:
        raise pytest.UsageError(
            "duplicate test definitions (earlier ones never run):\n  "
            + "\n  ".join(problems))


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.module.__name__ in _QUICK_MODULES:
            item.add_marker(pytest.mark.quick)
