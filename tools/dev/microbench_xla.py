"""Device times of the plain XLA paths at the full 0.6B geometry.

Measures, on the first device, what XLA makes of:

- ``quant.matmul`` with int8 weights against a dense bf16 dot, at
  M in {1, 8, 32} and the talker's fused shapes; a stack of 28 distinct
  weights per shape keeps the weight bytes out of the 50 MB L2, and the
  optimised HLO of the int8 program goes to ``chiprun_out/`` so one can
  read whether the int8 -> bf16 convert is fused into the GEMM;
- one talker decode step (bf16 scan path; int8 fused layout through
  ``decode_step_unrolled``) at batch 1 and 8;
- one code-predictor call (groups 1..15) at batch 1 and 8, bf16 and int8;
- one paged talker decode step at batch 8 against the dense one.

Each time is the best of several runs of a jitted loop of ``N`` calls,
divided by ``N``. Run: ``python tools/dev/microbench_xla.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "chiprun_out")


def _time(fn, args, n_inner: int, reps: int = 5) -> float:
    """Best wall seconds per inner call of compiled ``fn(*args)``."""
    import jax
    compiled = jax.jit(fn).lower(*args).compile()
    jax.block_until_ready(compiled(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        best = min(best, time.perf_counter() - t0)
    return best / n_inner


TALKER_SHAPES = ((1024, 4096), (1024, 6144), (2048, 1024), (3072, 1024))


def bench_qmatmul(shapes=TALKER_SHAPES, L: int = 28) -> None:
    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.ops import quant

    for K, N in shapes:
        key = jax.random.PRNGKey(K * 7 + N)
        w = jax.random.normal(key, (L, K, N), jnp.float32) * 0.02
        wq = quant.quantize_int8(w)
        wb = w.astype(jnp.bfloat16)
        del w
        wq_list = [wq[i] for i in range(L)]
        wb_list = [wb[i] for i in range(L)]

        def chain(x, ws):
            for wl in ws:
                y = quant.matmul(x, wl)
                y = y[:, :K] if N >= K else jnp.tile(y, (1, K // N))
                x = (y * 1e-3).astype(jnp.bfloat16)
            return x

        for M in (1, 8, 32):
            x = jnp.ones((M, K), jnp.bfloat16)
            t_q = _time(chain, (x, wq_list), L)
            t_b = _time(chain, (x, wb_list), L)
            gb_q = (K * N + 4 * N) / t_q / 1e9
            gb_b = 2 * K * N / t_b / 1e9
            print(f"qmatmul M={M:2d} {K}x{N}: int8 {t_q * 1e6:7.2f} us "
                  f"({gb_q:6.0f} GB/s of weight bytes)  bf16 "
                  f"{t_b * 1e6:7.2f} us ({gb_b:6.0f} GB/s)  "
                  f"int8/bf16 {t_q / t_b:.2f}", flush=True)
        hlo = jax.jit(lambda x, w: quant.matmul(x, w)).lower(
            jnp.ones((8, K), jnp.bfloat16), wq_list[0]).compile().as_text()
        os.makedirs(OUT, exist_ok=True)
        with open(os.path.join(OUT, f"qmatmul_hlo_{K}x{N}.txt"), "w") as f:
            f.write(hlo)
        entry = hlo[hlo.find("ENTRY"):]
        ops = [ln.strip()[:160] for ln in entry.splitlines()[1:]
               if "=" in ln and ("fusion" in ln or "custom-call" in ln
                                 or "convert" in ln)]
        print(f"  int8 HLO ({K}x{N}, M=8) entry ops:", flush=True)
        for ln in ops:
            print(f"    {ln}", flush=True)


def bench_steps(cfg) -> None:
    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.io import weights as weights_io
    from qwen3_tts_tpu.models import code_predictor as cp
    from qwen3_tts_tpu.models import talker as tk
    from qwen3_tts_tpu.models import transformer as tfm
    from qwen3_tts_tpu.ops import quant

    tcfg, ccfg = cfg.talker, cfg.code_predictor
    geo = tfm.geometry_of(tcfg)
    params = weights_io.init_random_params(cfg, 0, jnp.bfloat16)
    tp_b, cp_b = params["talker"], params["code_predictor"]
    tp_q = jax.jit(quant.quantize_talker)(tp_b)
    cp_q = jax.jit(quant.quantize_code_predictor)(cp_b)
    n = 16
    H, S = tcfg.hidden_size, tcfg.max_seq_len

    def talker_loop(tp, h, kv, pos):
        def body(i, c):
            h, kv = c
            return tk.decode_step(tp, h, pos + i, kv, tcfg)
        return jax.lax.fori_loop(0, n, body, (h, kv))

    for B in (1, 8):
        h = jnp.ones((B, H), jnp.bfloat16) * 0.1
        kv = tfm.init_kv_cache(geo, B, S, dtype=jnp.bfloat16)
        pos = jnp.full((B,), 200, jnp.int32)
        for tag, tp in (("bf16", tp_b), ("int8", tp_q)):
            t = _time(talker_loop, (tp, h, kv, pos), n)
            print(f"talker decode step B={B} {tag}: {t * 1e3:.3f} ms",
                  flush=True)

    # paged against dense at batch 8: 8 pages of 64 rows per slot
    psz = min(64, S // 4)
    B, maxp = 8, S // psz
    paged = tfm.init_paged_kv(geo, B, 1 + B * maxp, psz, maxp,
                              dtype=jnp.bfloat16)
    table = 1 + np.arange(B * maxp, dtype=np.int32).reshape(B, maxp)
    paged = paged._replace(table=jnp.asarray(table),
                           capacity=jnp.full((B,), S, jnp.int32))
    h = jnp.ones((B, H), jnp.bfloat16) * 0.1
    pos = jnp.full((B,), 200, jnp.int32)
    t = _time(talker_loop, (tp_b, h, paged, pos), n)
    print(f"talker paged decode step B=8 bf16 (page {psz}): "
          f"{t * 1e3:.3f} ms",
          flush=True)

    greedy = cfg.sampling

    def cp_loop(cpp, hidden, c0e, key):
        def body(i, acc):
            hi = hidden + (acc * 1e-30).astype(hidden.dtype)
            codes = cp.predict_codes(cpp, hi, c0e, jax.random.fold_in(key, i),
                                     ccfg, greedy)
            return acc + jnp.sum(codes).astype(jnp.float32)
        return jax.lax.fori_loop(0, n, body, jnp.float32(0))

    for B in (1, 8):
        hidden = jnp.ones((B, H), jnp.bfloat16) * 0.1
        c0e = tp_b["codec_embedding"][jnp.arange(B)]
        for tag, cpp in (("bf16", cp_b), ("int8", cp_q)):
            t = _time(cp_loop, (cpp, hidden, c0e, jax.random.PRNGKey(0)), n)
            print(f"code predictor (15 groups) B={B} {tag}: "
                  f"{t * 1e3:.3f} ms", flush=True)


def main() -> int:
    import jax

    from qwen3_tts_tpu.config import TTSConfig
    from qwen3_tts_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    d = jax.devices()[0]
    if d.platform != "gpu":
        print(f"no GPU: JAX's first device is {d.platform!r}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"device: {d.device_kind} x{len(jax.devices())}; "
          f"{smi.stdout.strip().splitlines()[0]}", flush=True)
    bench_qmatmul()
    bench_steps(TTSConfig())
    return 0


if __name__ == "__main__":
    sys.exit(main())
