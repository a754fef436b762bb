"""What every entry point shares: the persistent compile cache's place
and the ``--platform`` choice of the CLI and the daemon."""

import os
import subprocess
import sys

import pytest

from qwen3_tts_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env,want", [
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache",
      "QWEN3_TTS_CACHE_DIR": "off"}, None),
])
def test_compile_cache_dir(monkeypatch, env, want):
    """The environment variable wins when set; otherwise the fixed
    <repo>/.jax_cache; QWEN3_TTS_CACHE_DIR=off turns the cache off."""
    for name in ("JAX_COMPILATION_CACHE_DIR", "QWEN3_TTS_CACHE_DIR"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert compile_cache.compile_cache_dir() == want


def test_compiled_entries_land_in_the_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, an engine-style
    enable_compile_cache() keeps the directory, and a compiled program
    is written there and not under <repo>/.jax_cache."""
    cache = tmp_path / "cache"
    env = {k: v for k, v in os.environ.items()
           if k not in ("QWEN3_TTS_CACHE_DIR", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               PYTHONPATH=REPO)
    before = set(os.listdir(compile_cache.REPO_CACHE_DIR)) if os.path.isdir(
        compile_cache.REPO_CACHE_DIR) else set()
    code = ("import jax, jax.numpy as jnp\n"
            "from qwen3_tts_tpu.utils.compile_cache import "
            "enable_compile_cache\n"
            "print(enable_compile_cache())\n"
            "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()"
            "\n")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(cache)
    assert cache.is_dir() and any(cache.iterdir())
    after = set(os.listdir(compile_cache.REPO_CACHE_DIR)) if os.path.isdir(
        compile_cache.REPO_CACHE_DIR) else set()
    assert after == before


@pytest.mark.parametrize("module", ["cli", "daemon"])
def test_platform_flag_accepts_cuda(module):
    """--platform offers the GPU by the name JAX_PLATFORMS takes."""
    if module == "cli":
        from qwen3_tts_tpu.cli import build_parser
        args = build_parser().parse_args(["hello", "--platform", "cuda"])
    else:
        from qwen3_tts_tpu.serve.daemon import build_parser
        args = build_parser().parse_args(["--platform", "cuda"])
    assert args.platform == "cuda"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--platform", "metal"])
