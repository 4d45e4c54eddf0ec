"""No code path may depend on one accelerator: nothing imports a
platform-specific Pallas dialect, and nothing branches on the backend's
platform name."""

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

TREES = {
    "package": sorted((REPO / "noize_tpu").rglob("*.py")),
    "bench": [REPO / "bench.py"],
    "chip_smoke": [REPO / "chip_smoke.py"],
    "examples": sorted((REPO / "examples").glob("*.py")),
}

# the removed kernels' dialect, and a platform test: default_backend(), or
# a platform name compared with the old one (chip_smoke's refusal of
# non-GPU devices is its contract, not a kernel choice, and is allowed)
DIALECT = "jax.experimental.pallas.tpu"
_BRANCH = re.compile(r"default_backend\s*\(|==\s*['\"]tpu['\"]|"
                     r"['\"]tpu['\"]\s*==|pltpu")


def _dialect_imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            names = [f"{mod}.{a.name}" for a in node.names] + [mod]
        else:
            continue
        for n in names:
            if n.startswith(DIALECT):
                yield node.lineno


@pytest.mark.parametrize("tree", sorted(TREES))
def test_no_platform_dialect_or_branch(tree):
    files = TREES[tree]
    assert files, f"no files found for {tree}"
    problems = []
    for path in files:
        src = path.read_text()
        rel = path.relative_to(REPO)
        for line in _dialect_imports(ast.parse(src, filename=str(path))):
            problems.append(f"{rel}:{line} imports {DIALECT}")
        for i, text in enumerate(src.splitlines(), 1):
            if _BRANCH.search(text):
                problems.append(f"{rel}:{i}: {text.strip()}")
    assert not problems, "\n".join(problems)
