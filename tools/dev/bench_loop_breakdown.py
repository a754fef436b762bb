"""Decode-loop cost breakdown on the GPU: time the fused loop with
pieces swapped for stubs (same process, interleaved trials — two
processes may land on different cards).

Variants:
  full      — production body
  greedy0   — code_0 sampling stack replaced by plain argmax over the
              masked logits (isolates mask/boost/rep-pen/top-k/top-p cost)
  nocp      — predict_codes replaced by zeros (isolates the CP kernel +
              feedback gather cost)

Run: python tools/dev/bench_loop_breakdown.py [n_tokens]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import numpy as np


def main() -> int:
    n_tok = int(sys.argv[1]) if len(sys.argv) > 1 else 96

    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from functools import partial

    from qwen3_tts_tpu.config import TTSConfig
    from qwen3_tts_tpu.engine import generate as gen
    from qwen3_tts_tpu.io import weights as weights_io
    from qwen3_tts_tpu.models import talker as tk
    from qwen3_tts_tpu.ops import quant as quant_ops
    from qwen3_tts_tpu.ops import sampling as smp

    print(f"device: {jax.devices()[0]}", file=sys.stderr, flush=True)
    cfg = TTSConfig()
    params = weights_io.init_random_params(cfg, 0, jnp.bfloat16)
    params["talker"] = quant_ops.quantize_talker(params["talker"])
    params["code_predictor"] = quant_ops.quantize_code_predictor(
        params["code_predictor"])
    tp, cpp = params["talker"], params["code_predictor"]
    ids = jnp.asarray(np.arange(100, 132, dtype=np.int32))
    n_text = jnp.int32(30)

    init = jax.jit(lambda tp, ids, n, key: gen.init_state(
        tp,
        tk.build_prefix(tp, ids, n)[0][None].astype(
            tp["codec_embedding"].dtype),
        tk.build_prefix(tp, ids, n)[1][None], n[None], key, cfg))

    real_sample = smp.sample_code0
    real_predict = None

    def greedy_sample(logits, ring, step, n_text_tokens, key, scfg):
        return jnp.argmax(smp.mask_code0_logits(
            logits.astype(jnp.float32))).astype(jnp.int32)

    from qwen3_tts_tpu.models import code_predictor as cp_mod
    real_predict = cp_mod.predict_codes

    def zero_predict(p, h, c, k, ccfg, scfg):
        return jnp.zeros((h.shape[0], ccfg.num_groups), jnp.int32)

    # jax.jit traces LAZILY at first call, so each variant must be
    # invoked (compiled) while its monkeypatch is active
    s0 = init(tp, ids, n_text, jax.random.PRNGKey(0))
    variants = {}
    patches = {"full": (real_sample, real_predict),
               "greedy0": (greedy_sample, real_predict),
               "nocp": (real_sample, zero_predict)}
    for name, (sample_fn, predict_fn) in patches.items():
        smp.sample_code0 = sample_fn
        cp_mod.predict_codes = predict_fn
        fn = jax.jit(lambda tp, cpp, s: gen.run_steps(tp, cpp, s, cfg,
                                                      n_tok))
        t0 = time.perf_counter()
        s = fn(tp, cpp, s0)   # traces NOW, under the active patches
        np.asarray(jax.device_get(s.n_codes))
        print(f"compile {name}: {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)
        variants[name] = fn
    smp.sample_code0 = real_sample
    cp_mod.predict_codes = real_predict

    results = {k: [] for k in variants}
    for trial in range(4):
        for name, fn in variants.items():
            s0 = init(tp, ids, n_text, jax.random.PRNGKey(10 + trial))
            np.asarray(jax.device_get(s0.pos))  # sync before timing
            t0 = time.perf_counter()
            s = fn(tp, cpp, s0)
            n = int(np.asarray(jax.device_get(s.n_codes))[0])
            dt = time.perf_counter() - t0
            results[name].append(dt / max(n, 1) * 1000)
            print(f"trial {trial} {name}: n={n} {dt * 1000:.0f}ms "
                  f"-> {dt / max(n, 1) * 1000:.2f} ms/tok",
                  file=sys.stderr, flush=True)

    med = {k: float(np.median(v)) for k, v in results.items()}
    print(f"medians ms/tok: {med}", file=sys.stderr, flush=True)
    print(f"  code_0 sampling stack cost: "
          f"{med['full'] - med['greedy0']:.2f} ms/tok", file=sys.stderr)
    print(f"  CP + feedback cost:         "
          f"{med['full'] - med['nocp']:.2f} ms/tok", file=sys.stderr)
    import json
    print(json.dumps({"metric": "loop_breakdown_ms_per_tok", **med}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
