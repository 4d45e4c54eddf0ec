"""chip_smoke.py's host-side contract, checked without a GPU: it refuses a
CPU device, fails alone, selects phases, and prints its result line only
when every phase passed."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Fake:
    """Stands in for chip_smoke.Smoke: fake GPU devices, scripted phases."""

    def __init__(self, count=1):
        self.devices = [SimpleNamespace(platform="gpu", device_kind="NVIDIA "
                                        "H100 80GB HBM3")] * count

    def good(self):
        print("  fine")

    def bad(self):
        raise AssertionError("wrong answer")


def test_refuses_cpu_device(capsys):
    cs = _load()
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_fails_alone_without_the_package(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_selection():
    cs = _load()
    assert cs.select_phases(True) == (
        "sp_field_ops", "sp_erosion_cycle", "dp_tile_batch")
    one = cs.select_phases(False)
    assert one == ("flagship", "stages", "editor", "serving", "parity",
                   "wet_pool")
    assert not set(one) & set(cs.select_phases(True))
    for name in one + cs.select_phases(True):
        assert callable(getattr(cs.Smoke, name))


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_is_exact(count, capsys):
    cs = _load()
    assert cs.run(_Fake(count), ("good",)) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert last == ('{"ok": true, "device": {"platform": "gpu", "kind": '
                    f'"NVIDIA H100 80GB HBM3", "count": {count}}}}}')


def test_failing_phase_exits_nonzero_without_result(capsys):
    cs = _load()
    assert cs.run(_Fake(), ("good", "bad", "good")) == 1
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "[bad] FAILED" in out.out
    assert out.out.count("[good] ok") == 2  # later phases still run
    assert "bad" in out.err


def test_tolerance_check_raises():
    cs = _load()
    cs.compare("same", [1.0, 2.0], [1.0, 2.0], 0.0)
    with pytest.raises(cs.PhaseError):
        cs.compare("off", [1.0, 2.0], [1.0, 2.5], 0.1)
    with pytest.raises(cs.PhaseError):
        cs.compare("nan", [float("nan")], [1.0], 1.0)
