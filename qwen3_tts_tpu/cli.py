"""CLI: preserves the reference client's flag surface
(dual_npu/tts_client.py:274-300) plus engine options.

Usage:
  python -m qwen3_tts_tpu.cli "Привет, как дела?"
  python -m qwen3_tts_tpu.cli --text "Привет" --language russian \
      --output output.wav --streaming
  python -m qwen3_tts_tpu.cli "..." --model_dir /path/to/hf_checkpoint
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Qwen3-TTS")
    p.add_argument("text", nargs="?", default=None)
    p.add_argument("--text", dest="text_flag", default=None)
    p.add_argument("--language", default="russian")
    p.add_argument("--output", default="output.wav")
    p.add_argument("--streaming", action="store_true",
                   help="Chunked vocoder overlapped with generation")
    p.add_argument("--model_dir", default=None,
                   help="HF checkpoint dir (model.safetensors); random "
                        "weights if omitted")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_tokens", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="Tiny geometry (CPU smoke tests)")
    p.add_argument("--platform", default="default",
                   choices=["default", "cpu", "cuda"],
                   help="Force a JAX backend: 'cuda' (NVIDIA GPU) or "
                        "'cpu'; 'default' lets JAX pick")
    p.add_argument("--quantize", default=None,
                   choices=[None, "int8", "int8-cp"],
                   help="Weight-only int8 for talker+CP ('int8') or the "
                        "code predictor only ('int8-cp'); the vocoder "
                        "stays FP32")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="Capture a jax.profiler trace (Perfetto) to DIR")
    p.add_argument("--long", action="store_true",
                   help="paragraph mode: split the text into sentences "
                        "and decode them in batched groups "
                        "(synthesize_long) instead of one bounded "
                        "request")
    p.add_argument("--prompt_dir", default=None,
                   help="Voice-cloning prompt dir (ref_codec_tokens.npy + "
                        "ref_text.txt) from tools/encode_reference_audio.py; "
                        "conditions synthesis on the reference speaker")
    p.add_argument("--tp", type=int, default=0, metavar="N",
                   help="Tensor parallelism: shard the engine over the "
                        "first N local devices (weights column/row-"
                        "parallel, KV over kv heads — parallel/mesh.py). "
                        "Cuts the HBM-bound decode step's weight "
                        "streaming N ways on a multi-chip host. "
                        "Incompatible with --quantize int8 (the fused "
                        "int8 talker layout is single-chip; int8-cp "
                        "shards fine). 0 (default) = no mesh; 1 = a "
                        "1-device mesh (same semantics as the daemon's "
                        "--tp 1)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    text = args.text or args.text_flag
    if not text:
        text = "Привет, как дела? Сегодня хорошая погода для прогулки."

    import dataclasses

    if args.platform != "default":
        import jax
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu.engine.engine import TTSEngine

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32

    preloaded = None
    if args.tiny:
        cfg = tiny_tts_config(max_tokens=32)
    elif args.model_dir:
        # geometry from the checkpoint itself so any Qwen3-TTS-family
        # size loads without a hand-written config; params.npz first
        # (load_params' precedence), then the header-only probe
        import os
        from qwen3_tts_tpu.io import weights as weights_io
        npz = os.path.join(args.model_dir, "params.npz")
        if os.path.exists(npz):
            cfg = weights_io.read_npz_config(npz)
            preloaded = weights_io.load_params(args.model_dir, TTSConfig(),
                                               dtype, args.seed)
            if cfg is None:
                cfg = weights_io.config_from_params(preloaded)
        elif os.path.exists(os.path.join(args.model_dir,
                                         "model.safetensors")):
            cfg = weights_io.detect_tts_config(args.model_dir)
        else:
            cfg = TTSConfig()
    else:
        cfg = TTSConfig()
    if args.max_tokens is not None:
        cfg = dataclasses.replace(cfg, max_tokens=args.max_tokens)
    sampling = cfg.sampling
    if args.temperature is not None:
        sampling = dataclasses.replace(sampling, temperature=args.temperature)
    if args.top_k is not None:
        sampling = dataclasses.replace(sampling, top_k=args.top_k)
    cfg = dataclasses.replace(cfg, sampling=sampling)

    print(f"Text: '{text}'")
    print(f"Language: {args.language}")
    from qwen3_tts_tpu.utils.profiling import device_trace

    mesh = None
    if args.tp > 0:
        # > 0, not > 1: the daemon treats --tp 1 as "build a (1-device)
        # mesh", and a silent no-op here also skipped the int8 check —
        # same flag, divergent semantics (round-4 ADVICE). Aligned.
        if args.quantize == "int8":
            print("error: --tp requires --quantize int8-cp or none "
                  "(the fused int8 talker layout is single-chip)",
                  file=sys.stderr)
            return 1
        from qwen3_tts_tpu.parallel.multihost import make_serving_mesh
        mesh = make_serving_mesh(tp=args.tp, dp=1)
        print(f"Mesh: tp={args.tp} over "
              f"{[d.id for d in mesh.devices.flat]}")

    engine = TTSEngine(cfg, model_dir=args.model_dir, dtype=dtype,
                       seed=args.seed, quantize=args.quantize,
                       params=preloaded, mesh=mesh)
    try:
        with device_trace(args.profile):
            if args.long:
                if args.streaming:
                    print("note: --long emits audio per finished "
                          "sentence; --streaming's intra-sentence head "
                          "schedule does not apply")
                res = engine.synthesize_long(text, language=args.language,
                                             output=args.output,
                                             seed=args.seed,
                                             prompt_dir=args.prompt_dir)
            else:
                res = engine.synthesize(text, language=args.language,
                                        output=args.output,
                                        streaming=args.streaming,
                                        seed=args.seed,
                                        prompt_dir=args.prompt_dir)
    except ValueError as e:
        # client-fixable request errors (unsupported language, cloned
        # text overflowing the prefix, bad prompt_dir): a clean message,
        # not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 1
    if res.n_tokens == 0:
        print("No tokens generated!")
        return 1
    print(f"Generated {res.n_tokens} tokens")
    stages = ", ".join(f"{k}={v:.2f}s" for k, v in res.timings.items())
    print(f"Stages: {stages}")
    if res.first_audio_seconds is not None:
        print(f"First audio: {res.first_audio_seconds:.3f}s")
    print(f"Audio: {res.audio_seconds:.2f}s, saved to {args.output}")
    print(f"Total: {res.total_seconds:.1f}s (RTF={res.rtf:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
