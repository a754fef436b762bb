"""Engine streaming-path A/B (round-4 VERDICT #8): the r3 full-left-
context WINDOW emissions vs the r5 INCREMENTAL vocoder-stream emissions,
measured the only rig-valid way — ONE process, interleaved trials, both
paths compiled before timing (the path is chosen per call from the
QWEN3_TTS_ENGINE_STREAM env var, so one engine serves both).

Run: python tools/dev/bench_engine_stream_ab.py [trials]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

import numpy as np


def main() -> int:
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 6

    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTSConfig
    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(f"device: {jax.devices()[0]}", file=sys.stderr, flush=True)
    engine = TTSEngine(TTSConfig(), model_dir=None, dtype=jnp.bfloat16,
                       quantize="int8")

    text = "stream ab bench phrase of tok"   # 29 chars, bucket 32

    # compile + parity check both paths (same seed -> same codes; audio
    # must agree within the stream contract)
    results = {}
    for mode in ("window", "incremental"):
        os.environ["QWEN3_TTS_ENGINE_STREAM"] = mode
        results[mode] = engine.synthesize(text, language="english",
                                          streaming=True, seed=5)
    a, b = results["window"], results["incremental"]
    assert np.array_equal(a.codes, b.codes), "codes diverged across paths"
    wa, ia = a.audio_int16, b.audio_int16
    assert len(wa) == len(ia), (len(wa), len(ia))
    mismatch = np.mean(wa != ia)
    max_lsb = np.max(np.abs(wa.astype(np.int32) - ia.astype(np.int32))) \
        if len(wa) else 0
    print(f"audio parity: {mismatch:.6%} samples differ, max {max_lsb} LSB "
          "(contract: never > 1 LSB; sub-quantization noise)",
          file=sys.stderr, flush=True)
    assert max_lsb <= 1

    times = {"window": [], "incremental": []}
    fa = {"window": [], "incremental": []}
    for t in range(trials):
        for mode in ("window", "incremental"):
            os.environ["QWEN3_TTS_ENGINE_STREAM"] = mode
            res = engine.synthesize(text + "!" * (t % 2),
                                    language="english",
                                    streaming=True, seed=20 + t)
            times[mode].append(res.rtf)
            if res.first_audio_seconds is not None:
                fa[mode].append(res.first_audio_seconds)
    for mode in ("window", "incremental"):
        ts = np.asarray(times[mode])
        print(f"{mode}: stream RTF median {np.median(ts):.4f} "
              f"(min {ts.min():.4f}) first-audio p50 "
              f"{np.median(fa[mode]) if fa[mode] else float('nan'):.3f}s",
              file=sys.stderr, flush=True)
    d = ((np.median(times['window']) - np.median(times['incremental']))
         / np.median(times['window']) * 100)
    print(f"incremental vs window: {d:+.1f}% RTF", file=sys.stderr,
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
