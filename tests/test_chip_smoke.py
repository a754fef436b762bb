"""chip_smoke.py: it must refuse to run anywhere but on a GPU, and on a
machine with one it must pass (the ``gpu`` test, run there by
``python -m pytest -m gpu tests/``)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "chip_smoke.py")


def _run(script, cwd, env, timeout):
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_gpu(tmp_path, where):
    """Under JAX_PLATFORMS=cpu, and in a directory holding only the
    script, it exits non-zero and never prints the ok line."""
    script = SCRIPT
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SCRIPT, script)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = _run(script, os.path.dirname(script), env, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "FAIL" in out.stdout


@pytest.fixture
def gpu_env():
    """The environment of a child process that may use the card; skips
    where no NVIDIA GPU is visible (this suite's own process stays on the
    CPU, tests/conftest.py)."""
    try:
        found = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                               text=True, timeout=60).returncode == 0
    except (OSError, subprocess.SubprocessError):
        found = False
    if not found:
        pytest.skip("no NVIDIA GPU visible (nvidia-smi -L)")
    return {k: v for k, v in os.environ.items()
            if k not in ("JAX_PLATFORMS", "XLA_FLAGS",
                         "QWEN3_TTS_CACHE_DIR")}


@pytest.mark.gpu
def test_chip_smoke_passes_on_the_card(gpu_env):
    out = _run(SCRIPT, REPO, gpu_env, timeout=1500)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
