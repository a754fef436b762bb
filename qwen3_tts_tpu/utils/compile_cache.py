"""Persistent XLA compilation cache, one policy for every entry point.

- ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and
  nothing here points the cache anywhere else.
- Otherwise the cache lives at the fixed ``<repo>/.jax_cache``. The path
  is part of what the cache is keyed on, so a directory that moved would
  never hit.
- ``QWEN3_TTS_CACHE_DIR=off`` turns the cache off. The CPU test suite sets
  it (tests/conftest.py): loading cached XLA:CPU executables crashed late
  full-suite runs.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir() -> Optional[str]:
    """The directory the cache should use, or None when it is off."""
    if os.environ.get("QWEN3_TTS_CACHE_DIR") == "off":
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def enable_compile_cache() -> Optional[str]:
    """Point JAX's persistent cache at ``compile_cache_dir()`` (None turns
    it off, even against the environment variable); returns the dir."""
    cache = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache)
    return cache
