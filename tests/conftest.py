"""Test config: force the CPU backend with 8 virtual devices so sharding
tests run anywhere, a GPU machine included (tests marked ``gpu`` run their
card work in a child process).

Must run before any test module imports jax.

TWO hardening layers against the late-suite XLA:CPU crashes (jax
0.9.0; the r4 'scheduler segfault'). Eleven instrumented full-suite
runs this round: 6 crashed — SIGSEGV inside backend_compile_and_load
(x4, including one fully cache-less cold run) and SIGSEGV/SIGABRT
inside the compile-cache READ path (x2) — always at the run's last
first-compiles (the voice-clone paged programs, ~95% through), never in
module isolation, with clean glibc MALLOC_CHECK_/MALLOC_PERTURB_ runs.

1. NO persistent compile cache on the CPU test path
   (QWEN3_TTS_CACHE_DIR=off, honored by utils/compile_cache.py so
   engines built inside tests cannot re-enable one): removes the
   cache-READ crash class outright (cpu_aot_loader itself warns loaded
   entries "could lead to execution errors such as SIGILL", and it
   fires those warnings even for same-machine entries), and with it any
   cross-machine AOT reuse from copied working trees.
2. A 512 MiB main-thread stack rlimit (below): the surviving hypothesis
   for the compile-path SIGSEGV is native stack exhaustion at the 8 MiB
   default during deep LLVM recursion on top of a deep pytest/JAX
   Python stack — nondeterministic via layout, which matches the ~60%
   crash rate at a fixed location. Post-fix runs have been green.

machine_cache_dir remains for reference / future jaxlibs.
"""
import hashlib
import os
import platform


def machine_cache_dir(root: str) -> str:
    """Per-machine CPU compile-cache subdir (kept for reference /
    diagnostics — the suite itself runs cache-less, see the module
    docstring). Keys the dir by a fingerprint of the host CPU's feature
    flags so a copied working tree can never load a foreign machine's
    AOT code."""
    try:
        with open("/proc/cpuinfo") as f:
            src = "".join(line for line in f
                          if line.startswith(("flags", "Features",
                                              "model name")))
    except OSError:
        src = ""
    src = src or f"{platform.machine()}-{platform.processor()}"
    tag = hashlib.md5(src.encode()).hexdigest()[:10]
    return os.path.join(root, ".jax_cache_cpu", tag)


os.environ["JAX_PLATFORMS"] = "cpu"
# forbid ANY persistent compile cache in the suite (incl. engines built
# by tests — enable_compile_cache honors the "off" sentinel)
os.environ["QWEN3_TTS_CACHE_DIR"] = "off"

# Raise the main-thread stack limit (default 8 MiB): the late-suite
# XLA:CPU crashes (see the module docstring) hit DEEP native recursion —
# LLVM codegen under backend_compile, AOT deserialization — on top of a
# deep pytest/JAX Python stack, and a ~8 MiB-edge overflow would present
# exactly as the observed nondeterministic SIGSEGV/SIGABRT with clean
# malloc checks. Linux grows the main stack on demand up to the rlimit
# AT FAULT TIME, so raising it here (hard limit permitting) covers the
# whole run.
try:
    import resource
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    _want = 512 * 1024 * 1024
    if _hard == resource.RLIM_INFINITY or _hard >= _want:
        resource.setrlimit(resource.RLIMIT_STACK, (_want, _hard))
    elif _hard > _soft:
        resource.setrlimit(resource.RLIMIT_STACK, (_hard, _hard))
except (ImportError, ValueError, OSError):
    pass
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
