#!/usr/bin/env python3
"""Convert / inspect Qwen3-TTS checkpoints for this framework.

Replaces the reference's model-prep toolchain (extract_embeddings.py,
export_code_predictor_weights.py, convert_talker_gguf.py — SURVEY §2
components #12-#15): there is no GGUF/ONNX step, only

  HF model.safetensors ──► native params.npz  (single-file pytree)

with optional embedding .npy dumps for inspection/debugging parity with
the reference's extracted artifacts.

The speech tokenizer (vocoder decoder + voice-clone encoder, reference
scripts/export_vocoder_traced.py) is repacked the same way: pass
``--speech_tokenizer`` to convert ``<model_dir>/speech_tokenizer/
model.safetensors`` into a standalone ``vocoder.npz``; ``load_params``
also consumes the speech_tokenizer directory directly.

Usage:
  python tools/convert_weights.py --model_dir /path/to/hf_ckpt \
      --output params.npz [--dtype bfloat16] [--dump_embeddings DIR]
  python tools/convert_weights.py --model_dir /path/to/hf_ckpt \
      --speech_tokenizer --output vocoder.npz
  python tools/convert_weights.py --random --output params.npz  # dev
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model_dir", default=None)
    p.add_argument("--random", action="store_true",
                   help="Random weights at real geometry (development)")
    p.add_argument("--output", default="params.npz")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--speech_tokenizer", action="store_true",
                   help="Convert <model_dir>/speech_tokenizer/"
                        "model.safetensors (or model_dir itself if it "
                        "contains one) into a vocoder/encoder npz instead "
                        "of the talker checkpoint")
    p.add_argument("--list_keys", action="store_true",
                   help="Dump every tensor name/dtype/shape of the "
                        "checkpoint (header-only read, no weights) — for "
                        "model.safetensors and speech_tokenizer/"
                        "model.safetensors when present")
    p.add_argument("--check_schema", action="store_true",
                   help="With --list_keys: dry-run the strict "
                        "vocoder/encoder loaders against the "
                        "speech_tokenizer key schema (zero-filled tensors "
                        "at the declared shapes) and report exactly which "
                        "names mismatch")
    p.add_argument("--detect_config", action="store_true",
                   help="Print the geometry detected from the checkpoint "
                        "header (io/weights.detect_tts_config) as JSON "
                        "and exit")
    p.add_argument("--dump_embeddings", default=None,
                   help="Also dump text/codec embedding .npy files "
                        "(inspection parity with the reference's "
                        "extract_embeddings.py outputs)")
    p.add_argument("--quantize", default=None,
                   choices=["int8", "int8-cp"],
                   help="Write a PRE-QUANTIZED artifact (the reference "
                        "ships GGUF Q4_K_M / GGML Q4_0 the same way): "
                        "'int8' quantizes talker+CP — the fastest "
                        "ENGINE-mode artifact, ~half the load bytes; "
                        "'int8-cp' quantizes only the code predictor — "
                        "the universal artifact (the batched tier wants "
                        "a bf16 talker). TTSEngine auto-detects either; "
                        "the vocoder always stays FP32")
    p.add_argument("--platform", default="cpu",
                   choices=["default", "cpu", "cuda"])
    args = p.parse_args(argv)

    if args.platform != "default":
        import jax
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp
    import numpy as np

    from qwen3_tts_tpu.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu.io import weights as weights_io

    cfg = tiny_tts_config() if args.tiny else TTSConfig()
    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32

    if args.detect_config:
        if args.model_dir is None:
            p.error("--detect_config requires --model_dir")
        import dataclasses
        import json
        det = weights_io.detect_tts_config(args.model_dir, base=cfg)
        print(json.dumps({"talker": dataclasses.asdict(det.talker),
                          "code_predictor":
                              dataclasses.asdict(det.code_predictor)},
                         indent=2))
        return 0

    if args.list_keys:
        if args.model_dir is None:
            p.error("--list_keys requires --model_dir")
        return _list_keys(args, cfg)

    if args.speech_tokenizer:
        if args.model_dir is None:
            p.error("--speech_tokenizer requires --model_dir")
        st_dir = os.path.join(args.model_dir, "speech_tokenizer")
        if not os.path.exists(os.path.join(st_dir, "model.safetensors")):
            st_dir = args.model_dir
        print(f"Loading speech tokenizer: {st_dir}")
        st = weights_io.load_speech_tokenizer(st_dir, cfg)
        out = args.output if args.output != "params.npz" else "vocoder.npz"
        print(f"Saving: {out}")
        weights_io.save_pytree_npz(out, st["vocoder"])
        if "encoder" in st:
            enc_out = out.replace("vocoder", "encoder")
            weights_io.save_pytree_npz(enc_out, st["encoder"])
            print(f"Saving: {enc_out}")
        print(f"  {os.path.getsize(out) / 1e6:.1f} MB")
        print("Done.")
        return 0

    if args.random or args.model_dir is None:
        print("Initializing random parameters at model geometry...")
        params = weights_io.init_random_params(cfg, seed=0, dtype=dtype)
    else:
        print(f"Loading HF checkpoint: {args.model_dir}")
        if os.path.exists(os.path.join(args.model_dir, "model.safetensors")):
            # geometry from the checkpoint, not the default config
            cfg = weights_io.detect_tts_config(args.model_dir, base=cfg)
        else:
            npz = os.path.join(args.model_dir, "params.npz")
            if os.path.exists(npz):
                # round-tripping a native artifact (e.g. to quantize it):
                # its embedded __config__ is authoritative — vocoder
                # geometry is NOT shape-derivable, so falling back to the
                # default config would stamp the output with wrong
                # geometry (review finding)
                cfg = weights_io.read_npz_config(npz) or cfg
        params = weights_io.load_params(args.model_dir, cfg, dtype)

    if args.quantize:
        import jax

        from qwen3_tts_tpu.ops import quant as quant_ops
        if (quant_ops.is_quantized(params.get("talker", {}))
                or quant_ops.is_quantized(params.get("code_predictor",
                                                     {}))):
            p.error("--quantize: the input checkpoint is already "
                    "quantized (QTensor weights); re-quantizing would "
                    "compound the rounding — load the original dense "
                    "checkpoint instead")
        print(f"Quantizing ({args.quantize}; vocoder stays FP32)...")
        if args.quantize == "int8":
            params["talker"] = jax.jit(quant_ops.quantize_talker)(
                params["talker"])
        params["code_predictor"] = jax.jit(
            quant_ops.quantize_code_predictor)(params["code_predictor"])

    print(f"Saving native checkpoint: {args.output}")
    # embed the config so loaders never guess shape-underivable geometry
    weights_io.save_pytree_npz(args.output, params, config=cfg)
    sz = os.path.getsize(args.output) / 1e6
    print(f"  {sz:.1f} MB")

    if args.dump_embeddings:
        os.makedirs(args.dump_embeddings, exist_ok=True)
        tp = params["talker"]
        head = tp["codec_head"]
        if args.quantize == "int8":
            from qwen3_tts_tpu.ops.quant import dequantize
            head = dequantize(head, jnp.float32)
        dumps = {
            "text_embedding.npy": tp["text_embedding"],
            "codec_embedding.npy": tp["codec_embedding"],
            "codec_head.npy": np.asarray(head).T,  # (V, H) like ref
            "text_projection_linear_fc1_weight.npy": np.asarray(tp["proj_fc1_w"]).T,
            "text_projection_linear_fc1_bias.npy": tp["proj_fc1_b"],
            "text_projection_linear_fc2_weight.npy": np.asarray(tp["proj_fc2_w"]).T,
            "text_projection_linear_fc2_bias.npy": tp["proj_fc2_b"],
        }
        for name, arr in dumps.items():
            path = os.path.join(args.dump_embeddings, name)
            np.save(path, np.asarray(arr, np.float32))
            print(f"  {name}: {np.asarray(arr).shape}")

    print("Done.")
    return 0


def _list_keys(args, cfg) -> int:
    """Header-only key dump (+ optional loader-schema dry run)."""
    import numpy as np

    from qwen3_tts_tpu.io import weights as weights_io

    candidates = []
    st = os.path.join(args.model_dir, "model.safetensors")
    if os.path.exists(st):
        candidates.append(("model", st))
    st2 = os.path.join(args.model_dir, "speech_tokenizer",
                       "model.safetensors")
    if os.path.exists(st2):
        candidates.append(("speech_tokenizer", st2))
    if not candidates:
        print(f"no model.safetensors under {args.model_dir}",
              file=sys.stderr)
        return 1

    st_keys = None
    for label, path in candidates:
        keys = weights_io.list_safetensors_keys(path)
        print(f"# {label}: {path} ({len(keys)} tensors)")
        for k in sorted(keys):
            dt, shape = keys[k]
            print(f"{k}\t{dt}\t{list(shape)}")
        if label == "speech_tokenizer":
            st_keys = keys

    if args.check_schema:
        if st_keys is None:
            print("\n--check_schema: no speech_tokenizer checkpoint found",
                  file=sys.stderr)
            return 1
        zeros = {k: np.zeros(shape, np.float32)
                 for k, (dt, shape) in st_keys.items()}
        groups = weights_io.split_speech_tokenizer_state_dict(zeros)
        from qwen3_tts_tpu.models import encoder as enc
        checks = [("decoder (vocoder)", groups.get("decoder"),
                   lambda sd: weights_io.load_vocoder_from_state_dict(
                       sd, cfg.vocoder)),
                  ("encoder (voice clone)", groups.get("encoder"),
                   lambda sd: enc.load_encoder_from_state_dict(
                       sd, cfg.encoder))]
        rc = 0
        for label, sd, loader in checks:
            if not sd:
                print(f"\nSCHEMA {label}: NO '{label.split()[0]}.' tensors "
                      "in the checkpoint")
                rc = 1
                continue
            try:
                loader(sd)
                print(f"\nSCHEMA {label}: OK — every expected name "
                      "present, every checkpoint tensor consumed")
            except (KeyError, ValueError) as e:
                print(f"\nSCHEMA {label}: MISMATCH — {e}")
                rc = 1
        return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
