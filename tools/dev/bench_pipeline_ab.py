"""pipeline_depth=1 vs 2: same-process alternating A/B (VERDICT r3 #5).

Two processes may land on different cards or host loads, so the two
depths interleave inside ONE process and window. Two
ContinuousBatchers (identical but for pipeline_depth) alternate rounds
of the same load; every request STREAMS, so each round yields the three
latencies depth 2 trades against throughput:

- admission -> first token (t_first, chunk granularity)
- admission -> FIRST FRAME (the streaming on_chunk callback — depth 2
  surfaces frames one speculative chunk later by design,
  serve/batching.py)
- admission -> audio done

Texts are unique per (depth, round, i) so the admission prefix LRU never
hits and admission work stays constant.

Run: python tools/dev/bench_pipeline_ab.py [rounds] [batch] [chunk]
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
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    batch = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else 32
    n_requests = batch * 3

    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTSConfig
    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.utils.compile_cache import enable_compile_cache
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    enable_compile_cache()
    print(f"device: {jax.devices()[0]} batch={batch} chunk={chunk} "
          f"rounds={rounds} requests/round={n_requests}",
          file=sys.stderr, flush=True)

    cfg = TTSConfig()
    engine = TTSEngine(cfg, model_dir=None, dtype=jnp.bfloat16)
    batchers = {
        1: ContinuousBatcher(cfg, engine.params, batch_size=batch,
                             decode_chunk=chunk, dtype=jnp.bfloat16,
                             pipeline_depth=1),
        2: ContinuousBatcher(cfg, engine.params, batch_size=batch,
                             decode_chunk=chunk, dtype=jnp.bfloat16,
                             pipeline_depth=2),
    }

    def run_round(b, tag: str):
        futs, first_frame = [], {}

        def mk(idx):
            def on_chunk(seg):
                first_frame.setdefault(idx, time.perf_counter())
            return on_chunk

        t0 = time.perf_counter()
        for i in range(n_requests):
            ids, n = engine._encode_text(
                f"depth ab {tag} request {i} payload words here.")
            futs.append(b.submit(np.asarray(ids), int(n), seed=i,
                                 on_chunk=mk(i)))
        while not all(f.done() for f in futs):
            b.step()
        wall = time.perf_counter() - t0
        audio_s = 0.0
        lat = {"ft": [], "ff": [], "aud": []}
        for i, f in enumerate(futs):
            codes, audio = f.result(timeout=1)
            audio_s += len(audio) / 24000.0
            r = f.request
            if r.t_admit is None or r.t_done is None:
                continue
            lat["aud"].append(r.t_done - r.t_admit)
            if r.t_first is not None:
                lat["ft"].append(r.t_first - r.t_admit)
            if i in first_frame:
                lat["ff"].append(first_frame[i] - r.t_admit)
        return {"throughput": audio_s / wall, "wall": wall, **lat}

    # warmup both batchers (compile insert/run/stream/vocoder programs)
    for d, b in batchers.items():
        r = run_round(b, f"warmup{d}")
        print(f"warmup depth{d}: {r['wall']:.1f}s "
              f"throughput={r['throughput']:.2f}", file=sys.stderr, flush=True)

    rows = {1: [], 2: []}
    for rnd in range(rounds):
        for d in (1, 2):
            r = run_round(batchers[d], f"r{rnd}d{d}")
            rows[d].append(r)
            print(f"round {rnd} depth{d}: throughput={r['throughput']:.2f} "
                  f"audio-s/s wall={r['wall']:.1f}s", file=sys.stderr,
                  flush=True)

    def pct(a, q):
        return round(float(np.percentile(a, q)), 3) if a else None

    out = {"metric": "pipeline_depth_ab", "batch": batch, "chunk": chunk,
           "rounds": rounds}
    for d in (1, 2):
        pool = {k: sum((r[k] for r in rows[d]), []) for k in
                ("ft", "ff", "aud")}
        out[f"depth{d}"] = {
            "throughput_median": round(float(np.median(
                [r["throughput"] for r in rows[d]])), 2),
            "first_token_p50": pct(pool["ft"], 50),
            "first_token_p95": pct(pool["ft"], 95),
            "first_frame_p50": pct(pool["ff"], 50),
            "first_frame_p95": pct(pool["ff"], 95),
            "audio_p50": pct(pool["aud"], 50),
            "audio_p95": pct(pool["aud"], 95),
        }
        print(f"depth{d}: {out[f'depth{d}']}", file=sys.stderr, flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
