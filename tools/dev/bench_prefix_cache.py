"""Admission-latency A/B for the batched tier's prefix LRU
(serve/batching.py): first admission of a prompt pays the prefill
dispatch; a repeat admission
of the same prefix skips it (cache hit) and admits through the fused
assemble+insert program alone.

Method: submit each of N distinct prompts twice, SERIALLY (one request
in flight at a time, so admission latency is not confounded by decode
lockstep), alternating miss/hit. Reports p50/p95 of submit -> first
token for misses vs hits plus the batcher's own hit counters.

Run: python tools/dev/bench_prefix_cache.py [n_prompts]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import numpy as np


def main() -> int:
    n_prompts = int(sys.argv[1]) if len(sys.argv) > 1 else 6

    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTSConfig
    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.utils.compile_cache import enable_compile_cache
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    enable_compile_cache()
    cfg = TTSConfig()
    engine = TTSEngine(cfg, model_dir=None, dtype=jnp.bfloat16)
    b = ContinuousBatcher(cfg, engine.params, batch_size=4,
                          decode_chunk=32, dtype=jnp.bfloat16)

    def run_one(text: str, seed: int, cap: int = 24) -> float:
        ids, n = engine._encode_text(text)
        fut = b.submit(np.asarray(ids), int(n), seed=seed, max_tokens=cap)
        t0 = time.perf_counter()
        while not fut.done():
            b.step()
        r = fut.request
        fut.result(timeout=1)
        return (r.t_first - t0) if r.t_first else float("nan")

    run_one("warmup compile pass", seed=0)  # compile all programs

    miss, hit = [], []
    for i in range(n_prompts):
        text = f"prefix cache probe sentence number {i} with payload."
        miss.append(run_one(text, seed=100 + i))
        hit.append(run_one(text, seed=200 + i))   # same prefix, new seed

    occ = b.occupancy()["prefix_cache"]

    def pct(a, q):
        return float(np.percentile([x for x in a if x == x], q))

    print(f"prefix admission latency (submit->first-token, serial): "
          f"miss p50={pct(miss, 50):.3f}s p95={pct(miss, 95):.3f}s | "
          f"hit p50={pct(hit, 50):.3f}s p95={pct(hit, 95):.3f}s | "
          f"counters={occ}", file=sys.stderr, flush=True)
    print(json.dumps({"metric": "prefix_cache_admission",
                      "miss_p50_s": round(pct(miss, 50), 3),
                      "miss_p95_s": round(pct(miss, 95), 3),
                      "hit_p50_s": round(pct(hit, 50), 3),
                      "hit_p95_s": round(pct(hit, 95), 3),
                      "counters": occ}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
