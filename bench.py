"""Benchmark: end-to-end synthesis RTF on one GPU (full 0.6B geometry,
random weights — the compute/memory profile is identical to real weights).

Drives the product path: TTSEngine.synthesize, non-streaming (one fused
decode-program invocation, then the chained vocoder) and streaming (the
decode loop in head-scheduled chunks with vocoder windows dispatched as
they complete).

Prints ONE JSON line:
  {"metric": "rtf_e2e", "value": <RTF>, "unit": "x_realtime",
   "vs_baseline": <reference_RTF / ours>, "platform": ..., "device_kind":
   ..., "count": ..., "card": "<nvidia-smi name, power.limit>", ...}

Baseline: the reference's end-to-end RTF 2.0x on CM3588 (BASELINE.md).
vs_baseline > 1 means we are that many times faster than the reference.
Detailed per-trial numbers go to stderr. Exits 2 when JAX finds no GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main() -> int:
    import jax

    from qwen3_tts_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    devs = jax.devices()
    if devs[0].platform != "gpu":
        log(f"FATAL: no GPU (JAX's first device is {devs[0].platform!r})")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {devs[0].device_kind} x{len(devs)} ({card})")

    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTSConfig
    from qwen3_tts_tpu.engine.engine import TTSEngine

    t0 = time.perf_counter()
    quant = os.environ.get("BENCH_QUANT", "int8")
    quant = None if quant in ("", "none") else quant
    engine = TTSEngine(TTSConfig(), model_dir=None, dtype=jnp.bfloat16,
                       quantize=quant)
    log(f"engine init: {time.perf_counter() - t0:.1f}s (quant={quant})")

    # ~30-token prompts (byte-fallback tokenizer: 1 token per character),
    # all inside the 32-token pad bucket
    text = "benchmark sentence of tokens."
    warm_text = "warmup phrase for compiles!!"
    stream_text = "stream bench phrase of token"

    t0 = time.perf_counter()
    res = engine.synthesize(warm_text, language="english", streaming=True,
                            seed=0)
    engine.synthesize(warm_text + ".", language="english", streaming=False,
                      seed=0)
    # the longest trial text: the chained-vocoder window buckets by the
    # EOS-pacing bound, and the last trial crosses into the next bucket
    engine.synthesize(warm_text + "!?.!", language="english",
                      streaming=False, seed=0)
    # a repeated text takes the prefix-cache-hit streaming path
    engine.synthesize(warm_text, language="english", streaming=True, seed=1)
    log(f"compile+warmup: {time.perf_counter() - t0:.1f}s "
        f"(n={res.n_tokens})")

    # headline RTF: non-streaming. Each distinct prompt seeds a fresh
    # prefill (the prefix cache only helps repeat prompts).
    rtfs, ms_tok = [], []
    for trial in range(4):
        res = engine.synthesize(text + "?" * trial, language="english",
                                streaming=False, seed=10 + trial)
        if res.n_tokens == 0:
            continue
        rtfs.append(res.rtf)
        ms_tok.append(res.total_seconds / res.n_tokens * 1000)
        log(f"trial {trial}: n={res.n_tokens} total={res.total_seconds:.3f}s "
            f"audio={res.audio_seconds:.2f}s RTF={res.rtf:.4f}")

    first_audio, stream_rtfs = [], []
    for trial in range(3):
        res = engine.synthesize(stream_text + "!" * trial,
                                language="english", streaming=True,
                                seed=20 + trial)
        if res.first_audio_seconds is not None:
            first_audio.append(res.first_audio_seconds)
        stream_rtfs.append(res.rtf)
        log(f"stream trial {trial}: n={res.n_tokens} RTF={res.rtf:.4f} "
            f"first_audio={res.first_audio_seconds}")

    def med(xs):
        return float(np.median(xs)) if xs else None

    rtf = med(rtfs)
    log(f"median RTF={rtf}  {med(ms_tok)} ms/tok  "
        f"first_audio_p50={med(first_audio)}  (reference RTF=2.0)")
    print(json.dumps({
        "metric": "rtf_e2e",
        "value": rtf,
        "unit": "x_realtime",
        "vs_baseline": 2.0 / rtf if rtf else None,
        "ms_per_token": med(ms_tok),
        "stream_rtf_median": med(stream_rtfs),
        "first_audio_p50_s": med(first_audio),
        "quantize": quant,
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "count": len(devs),
        "card": card,
    }))
    return 0 if rtfs else 1


if __name__ == "__main__":
    sys.exit(main())
