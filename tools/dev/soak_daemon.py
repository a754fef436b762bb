"""Serving soak test: sustained mixed load against the batched scheduler.

Drives the ContinuousBatcher (the daemon's --batch engine) with a random
mix of the serving tier's whole request surface — blob, streaming,
voice-cloned, budget-capped, and mid-decode-cancelled requests — for a
wall-clock duration, then asserts the scheduler ends healthy: every
future resolved, every slot free, every page back in the pool, and no
scheduler-thread failures. The per-request results are also sanity
checked (audio length == n_codes * 1920; streamed segments concat to the
blob audio).

Run (the GPU by default; CPU: --platform cpu and --tiny):
  python tools/dev/soak_daemon.py [--seconds 120] [--batch 4] [--paged]
         [--pipeline_depth 2] [--tiny]

Exit code 0 = healthy; non-zero with a report otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=120.0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--decode_chunk", type=int, default=32)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--pipeline_depth", type=int, default=2, choices=[1, 2],
                    help="matches the daemon default (2 since r4)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--platform", default="default",
                    choices=["default", "cpu", "cuda"],
                    help="force a JAX backend; 'cpu' for local runs")
    args = ap.parse_args()

    import jax

    if args.platform != "default":
        jax.config.update("jax_platforms", args.platform)
    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.utils.compile_cache import enable_compile_cache
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    enable_compile_cache()
    cfg = tiny_tts_config(max_tokens=32) if args.tiny else TTSConfig()
    dtype = jnp.float32 if args.tiny else jnp.bfloat16
    engine = TTSEngine(cfg, model_dir=None, dtype=dtype)
    b = ContinuousBatcher(cfg, engine.params, batch_size=args.batch,
                          decode_chunk=args.decode_chunk, dtype=dtype,
                          paged=args.paged,
                          pipeline_depth=args.pipeline_depth)
    free0 = len(b._free_pages) if args.paged else None
    print(f"device: {jax.devices()[0]}  batch={args.batch} "
          f"chunk={args.decode_chunk} paged={args.paged} "
          f"depth={args.pipeline_depth} seconds={args.seconds}",
          file=sys.stderr, flush=True)
    b.start()

    rng = np.random.default_rng(args.seed)
    V = cfg.code_predictor.group_vocab_size
    texts = [f"soak sentence number {i} with several words of filler."
             for i in range(16)]

    # warmup (compiles)
    ids, n = engine._encode_text(texts[0])
    b.submit(np.asarray(ids), int(n), seed=0).result(timeout=1800)
    print("warmup done", file=sys.stderr, flush=True)

    inflight = []   # (future, kind, segments-or-None)
    stats = {"ok": 0, "cancelled": 0, "errors": 0, "tokens": 0,
             "audio_s": 0.0, "submitted": 0, "stream_mismatch": 0}
    deadline = time.monotonic() + args.seconds
    i = 0
    while time.monotonic() < deadline or inflight:
        # submit while the clock runs; cap in-flight to bound memory
        while (time.monotonic() < deadline and len(inflight) <
               args.batch * 3):
            i += 1
            ids, n = engine._encode_text(texts[i % len(texts)])
            kw, kind, segs = {}, "blob", None
            r = rng.random()
            if r < 0.2:
                segs = []
                kw["on_chunk"] = segs.append
                kind = "stream"
            elif r < 0.35:
                kw["ref_codes"] = rng.integers(0, V, (12, 16))
                kw["n_target"] = max(int(n) - 2, 1)
                kind = "cloned"
            elif r < 0.5:
                kw["max_tokens"] = int(rng.integers(2, 24))
                kind = "capped"
            fut = b.submit(np.asarray(ids), int(n), seed=i, **kw)
            stats["submitted"] += 1
            if rng.random() < 0.1:   # some clients vanish mid-decode
                fut.request.cancelled = True
                kind = "cancel"
            inflight.append((fut, kind, segs))
        # drain finished
        still = []
        for fut, kind, segs in inflight:
            if not fut.done():
                still.append((fut, kind, segs))
                continue
            try:
                codes, audio = fut.result(timeout=1)
                assert len(audio) == len(codes) * 1920, (
                    len(audio), len(codes))
                if kind == "stream" and segs:
                    cat = np.concatenate(segs)
                    if not np.array_equal(cat, audio):
                        stats["stream_mismatch"] += 1
                if kind == "capped":
                    pass  # budget asserted by the scheduler itself
                stats["ok"] += 1
                stats["tokens"] += len(codes)
                stats["audio_s"] += len(audio) / 24000.0
            except RuntimeError as e:
                if "cancelled" in str(e):
                    stats["cancelled"] += 1
                else:
                    stats["errors"] += 1
                    print(f"ERROR result: {e}", file=sys.stderr)
            except Exception as e:
                stats["errors"] += 1
                print(f"ERROR result: {e}", file=sys.stderr)
        inflight = still
        time.sleep(0.01)

    b.stop()
    healthy = (stats["errors"] == 0 and stats["stream_mismatch"] == 0
               and all(r is None for r in b._slot_req)
               and b._thread is None)   # clean stop() resets it
    pages_ok = True
    if args.paged:
        pages_ok = len(b._free_pages) == free0
        healthy = healthy and pages_ok
    import json
    print(json.dumps({"metric": "soak", **stats,
                      "pages_recovered": pages_ok,
                      "healthy": bool(healthy)}))
    return 0 if healthy else 1


if __name__ == "__main__":
    sys.exit(main())
