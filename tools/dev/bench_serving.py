"""Serving-tier bench: continuous-batching throughput on one chip.

Submits N concurrent requests to the ContinuousBatcher (the daemon's
--batch engine) and reports aggregate throughput: generated audio seconds
per wall second (an aggregate RTF^-1), tokens/s, and per-request latency.
The single-request path optimizes latency (bench.py); this measures how
far one card goes under concurrent load ('daemon serving with
continuous batching').

Run: python tools/dev/bench_serving.py [batch]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import numpy as np


def main() -> int:
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    chunk = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    qt = "int8" in sys.argv[3:]
    paged = "paged" in sys.argv[3:]
    depth = 2 if "pipe2" in sys.argv[3:] else 1
    # "stream": submit every request with an on_chunk callback and record
    # admission -> FIRST FRAME latency (the metric pipeline_depth trades
    # against throughput: depth 2 surfaces frames one chunk later)
    stream = "stream" in sys.argv[3:]
    n_requests = batch * 3

    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTSConfig
    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.utils.compile_cache import enable_compile_cache
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    enable_compile_cache()
    print(f"device: {jax.devices()[0]}  batch={batch} chunk={chunk} "
          f"int8_talker={qt} paged={paged} depth={depth} "
          f"requests={n_requests}",
          file=sys.stderr, flush=True)

    cfg = TTSConfig()
    engine = TTSEngine(cfg, model_dir=None, dtype=jnp.bfloat16)
    qcp = "nocp" not in sys.argv
    b = ContinuousBatcher(cfg, engine.params, batch_size=batch,
                          decode_chunk=chunk, dtype=jnp.bfloat16,
                          quantize_talker=qt, quantize_cp=qcp,
                          paged=paged, pipeline_depth=depth)
    texts = [f"benchmark sentence number {i} with some words."
             for i in range(n_requests)]

    # warmup (compile insert/run/vocoder programs)
    ids, n = engine._encode_text("warmup!")
    wfut = b.submit(np.asarray(ids), int(n), seed=0)
    t0 = time.perf_counter()
    while not wfut.done():
        b.step()
        if time.perf_counter() - t0 > 3000:
            raise TimeoutError("warmup")
    print(f"warmup done: {time.perf_counter() - t0:.1f}s",
          file=sys.stderr, flush=True)

    futs = []
    first_frame_at = {}

    def mk_on_chunk(idx):
        def on_chunk(seg):
            if idx not in first_frame_at:
                first_frame_at[idx] = time.perf_counter()
        return on_chunk

    t0 = time.perf_counter()
    for i, t in enumerate(texts):
        ids, n = engine._encode_text(t)
        futs.append(b.submit(np.asarray(ids), int(n), seed=i,
                             on_chunk=mk_on_chunk(i) if stream else None))
    while not all(f.done() for f in futs):
        b.step()
    wall = time.perf_counter() - t0

    tokens = audio_s = 0
    queue_w, first_tok, first_frame, adm_audio, e2e = [], [], [], [], []
    for i, f in enumerate(futs):
        codes, audio = f.result(timeout=1)
        tokens += len(codes)
        audio_s += len(audio) / 24000.0
        r = f.request  # timing instrumentation (serve/batching._Request)
        if r.t_admit is not None and r.t_done is not None:
            queue_w.append(r.t_admit - r.t_submit)
            adm_audio.append(r.t_done - r.t_admit)
            e2e.append(r.t_done - r.t_submit)
            if r.t_first is not None:
                first_tok.append(r.t_first - r.t_admit)
            if i in first_frame_at:
                first_frame.append(first_frame_at[i] - r.t_admit)

    def pct(a, q):
        return float(np.percentile(a, q)) if a else float("nan")

    print(f"requests={n_requests} wall={wall:.2f}s tokens={tokens} "
          f"audio={audio_s:.1f}s  throughput={audio_s / wall:.2f} "
          f"audio-s/s  {tokens / wall:.0f} tok/s  "
          f"aggregate-RTF={wall / audio_s:.4f}", file=sys.stderr, flush=True)
    print(f"latency (s): queue-wait p50={pct(queue_w, 50):.2f} "
          f"p95={pct(queue_w, 95):.2f} | admission->first-token "
          f"p50={pct(first_tok, 50):.2f} p95={pct(first_tok, 95):.2f} | "
          f"admission->audio p50={pct(adm_audio, 50):.2f} "
          f"p95={pct(adm_audio, 95):.2f} | e2e p50={pct(e2e, 50):.2f} "
          f"p95={pct(e2e, 95):.2f}", file=sys.stderr, flush=True)
    if first_frame:
        print(f"admission->first-frame p50={pct(first_frame, 50):.2f} "
              f"p95={pct(first_frame, 95):.2f} "
              f"({len(first_frame)} streams)", file=sys.stderr, flush=True)
    import json
    print(json.dumps({"metric": "serving_throughput", "batch": batch,
                      "paged": paged, "pipeline_depth": depth,
                      "stream": stream,
                      "value": round(audio_s / wall, 2),
                      "unit": "audio_seconds_per_second",
                      "aggregate_rtf": round(wall / audio_s, 4),
                      "latency_s": {
                          "queue_wait_p50": round(pct(queue_w, 50), 3),
                          "first_token_p50": round(pct(first_tok, 50), 3),
                          "first_token_p95": round(pct(first_tok, 95), 3),
                          "first_frame_p50": round(pct(first_frame, 50), 3),
                          "first_frame_p95": round(pct(first_frame, 95), 3),
                          "admission_audio_p50": round(pct(adm_audio, 50), 3),
                          "admission_audio_p95": round(pct(adm_audio, 95), 3),
                          "e2e_p50": round(pct(e2e, 50), 3),
                          "e2e_p95": round(pct(e2e, 95), 3)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
