#!/usr/bin/env python3
"""Encode a reference WAV into [T, 16] codec tokens for voice cloning.

Native equivalent of the reference's voice-cloning prep
(scripts/encode_reference_audio.py): WAV -> speech-tokenizer encoder ->
codec tokens (+ prompt_dir with ref_text.txt), plus a decode-back
verification WAV through the vocoder.

Usage:
  python tools/encode_reference_audio.py --audio ref.wav \
      --output_dir prompt_dir --ref_text "text spoken in the audio" \
      [--model_dir /path/to/checkpoint] [--platform cpu] [--tiny]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--audio", required=True)
    p.add_argument("--output", default="ref_codec_tokens.npy")
    p.add_argument("--output_dir", default=None,
                   help="Create a prompt_dir (tokens + ref_text.txt)")
    p.add_argument("--ref_text", default=None)
    p.add_argument("--max_tokens", type=int, default=256)
    p.add_argument("--model_dir", default=None)
    p.add_argument("--platform", default="default",
                   choices=["default", "cpu", "cuda"])
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)

    if args.platform != "default":
        import jax
        jax.config.update("jax_platforms", args.platform)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from qwen3_tts_tpu.config import SAMPLE_RATE, TTSConfig, tiny_tts_config
    from qwen3_tts_tpu.io import wav as wav_io
    from qwen3_tts_tpu.io import weights as weights_io
    from qwen3_tts_tpu.models import encoder as enc
    from qwen3_tts_tpu.models import vocoder as voc

    cfg = tiny_tts_config() if args.tiny else TTSConfig()

    wav, sr = wav_io.read_wav(args.audio)
    print(f"Audio: {args.audio}  duration={len(wav) / sr:.2f}s sr={sr}")
    wav = enc.resample_linear(wav, sr, SAMPLE_RATE)
    wav = enc.pad_to_tokens(wav)

    params = weights_io.load_params(args.model_dir, cfg)
    if "encoder" not in params:
        print("WARNING: no trained encoder weights found (checkpoint has "
              "no encoder.* tensors) — the encoder is RANDOMLY INITIALIZED "
              "and the emitted ref_codec_tokens.npy will NOT carry the "
              "reference speaker's voice. Check the decode-back WAV before "
              "using this prompt_dir.", file=sys.stderr)
        params["encoder"] = enc.init_encoder_params(
            jax.random.PRNGKey(0), cfg.encoder)
    codebooks = enc.decoder_codebooks(params["vocoder"], cfg.vocoder)

    codes = np.asarray(jax.jit(
        lambda ep, cb, w: enc.encode(ep, cb, w, cfg.encoder)
    )(params["encoder"], codebooks, jnp.asarray(wav)[None]))[0]
    n_tokens = min(len(codes), args.max_tokens)
    codes = codes[:n_tokens].astype(np.int64)
    print(f"Tokens: {n_tokens}  groups: {codes.shape[1]}  "
          f"audio-from-tokens: {n_tokens / 12.5:.2f}s")

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        out_path = os.path.join(args.output_dir, "ref_codec_tokens.npy")
        np.save(out_path, codes)
        if args.ref_text:
            with open(os.path.join(args.output_dir, "ref_text.txt"), "w") as f:
                f.write(args.ref_text)
        print(f"Saved prompt_dir: {args.output_dir}")
        decoded_path = os.path.join(args.output_dir, "ref_decoded.wav")
    else:
        # np.save appends .npy when missing — name things by the REAL
        # saved path (review finding: '--output voice' printed the wrong
        # name and wrote the WAV to the tokens' path)
        out = (args.output if args.output.endswith(".npy")
               else args.output + ".npy")
        np.save(out, codes)
        print(f"Saved: {out}")
        decoded_path = os.path.splitext(out)[0] + "_decoded.wav"

    # decode-back verification through the vocoder (left-context chunking,
    # the real model's streaming-decode semantics)
    audio = voc.synthesize_chunked_context(
        jax.jit(lambda c: voc.decode(params["vocoder"], c, cfg.vocoder)),
        codes.astype(np.int32))
    wav_io.write_wav(decoded_path, voc.to_int16(audio))
    print(f"Saved decode-back verification: {decoded_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
