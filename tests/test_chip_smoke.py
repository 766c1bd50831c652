"""``chip_smoke.py``: its phases at tiny sizes on the CPU (the same
gates it applies on the card), its refusal to run without a GPU or
outside the repository, and, on a machine with a GPU, the script
itself (``gpu`` marker)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def _assert_gates(res):
    assert res["gates"], res["name"]
    for gate in res["gates"]:
        assert gate.ok, f"{res['name']}: {gate}"
    assert "complex128" in res["dtype"]


def test_phase_cheby_step():
    _assert_gates(chip_smoke.phase_cheby_step(L=8))


def test_phase_chain():
    _assert_gates(chip_smoke.phase_chain(L=10, n_steps=4))


@pytest.mark.parametrize("method", ["newton", "expv"])
@pytest.mark.parametrize("system", ["transmon", "optomech"])
def test_phase_krylov(system, method):
    res = chip_smoke.phase_krylov(system, method)
    _assert_gates(res)
    assert res["extra"] == "precision=['native']"


def test_phase_rabi():
    _assert_gates(chip_smoke.phase_rabi(n_steps=20))


def test_phase_sharded_chain():
    _assert_gates(chip_smoke.phase_sharded_chain(L=10, n_dev=4, n_steps=2))


def test_phase_sharded_bsr():
    _assert_gates(chip_smoke.phase_sharded_bsr(rows_per_dev=64, b=8,
                                               n_dev=4))


def test_gate_fails_on_nan_and_excess():
    assert not chip_smoke.Gate("x", float("nan"), 1e-10).ok
    assert not chip_smoke.Gate("x", 2e-10, 1e-10).ok
    assert chip_smoke.Gate("x", 1e-10, 1e-10).ok


def _run_script(script: Path, cwd: Path, env: dict):
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


def test_main_refuses_cpu(tmp_path):
    """On a machine without a GPU the script exits non-zero, names the
    missing GPU and prints no result."""
    res = _run_script(REPO / "chip_smoke.py", tmp_path, _cpu_env())
    assert res.returncode != 0
    assert "no GPU" in res.stderr
    assert '"ok"' not in res.stdout


def test_script_alone_fails(tmp_path):
    """Outside the repository (no package beside it) it fails too."""
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    res = _run_script(alone, tmp_path, _cpu_env())
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.fixture
def gpu_env():
    """An environment whose JAX sees a GPU; skips when there is none.
    Decided here, at run time, by a child process: this test process is
    held to the CPU by conftest."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no NVIDIA GPU on this machine")
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; print(jax.devices()[0].platform)"],
        env=env, capture_output=True, text=True, timeout=240,
    )
    if probe.stdout.strip() != "gpu":
        pytest.skip("JAX finds no GPU on this machine")
    return env


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_env):
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, env=gpu_env, capture_output=True,
                         text=True, timeout=1200)
    assert res.returncode == 0, res.stdout[-4000:] + res.stderr[-4000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] is True
    assert last["device"]["platform"] == "gpu"
    assert last["device"]["count"] == 1

