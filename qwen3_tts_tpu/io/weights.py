"""Weight loading: HF safetensors -> JAX pytrees, plus a native NPZ
checkpoint format.

Replaces the reference's entire model-prep toolchain (scripts 12-17 in
SURVEY §2: GGUF conversion, npy/npz extraction, ONNX export) with a direct
HF-checkpoint -> device-array path. Weight matrices are transposed once at
load from HF's (out, in) to our (in, out) so every hot matmul is x @ W.

Key mapping reproduces the reference extraction scripts:
- talker transformer: ``talker.model.layers.{i}.*``
  (scripts/extract_talker_as_qwen3.py:53-75)
- embedding surface: ``talker.model.text_embedding.weight``,
  ``talker.text_projection.linear_fc{1,2}.{weight,bias}``,
  ``talker.model.codec_embedding.weight``, ``talker.codec_head.weight``
  (scripts/extract_embeddings.py:47-70)
- code predictor: ``talker.code_predictor.model.layers.{i}.*``,
  ``talker.code_predictor.model.codec_embedding.{g}.weight``,
  ``talker.code_predictor.lm_head.{g}.weight``,
  ``talker.code_predictor.small_to_mtp_projection.*``
  (scripts/export_code_predictor_weights.py:51-74,
  scripts/export_code_predictor_onnx.py:38-46)
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping, Optional

import jax
import jax.numpy as jnp
import numpy as np

from qwen3_tts_tpu.config import CodePredictorConfig, TalkerConfig, TTSConfig
from qwen3_tts_tpu.ops.quant import QTensor

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Generic pytree <-> npz (native checkpoint format)
# ---------------------------------------------------------------------------

_CONFIG_KEY = "__config__"  # JSON TTSConfig embedded in params.npz


def save_pytree_npz(path: str, tree: Params,
                    config: Optional[TTSConfig] = None) -> None:
    """Flatten a param pytree into npz. ``config`` (recommended for full
    checkpoints) embeds the exact TTSConfig as JSON under __config__, so
    loading never has to guess shape-underivable geometry (vocoder head
    count, sliding window, eps/theta)."""
    flat = {}

    def rec(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                if k == "layers_list":
                    # derived view of the stacked layers (ops/quant.
                    # attach_layer_list) — rebuilt at load, never stored
                    continue
                rec(f"{prefix}/{k}" if prefix else k, v)
        elif isinstance(node, QTensor):
            # pre-quantized int8 weights (convert_weights.py --quantize):
            # two entries per tensor, reassembled by load_pytree_npz. The
            # reference ships quantized artifacts the same way (GGUF
            # Q4_K_M talker / GGML Q4_0 CP, README.md:82-90).
            flat[prefix + "::q8"] = np.asarray(node.q)
            flat[prefix + "::q8s"] = np.asarray(node.scale)
        else:
            arr = np.asarray(node)
            if arr.dtype == jnp.bfloat16:
                # np.savez stores ml_dtypes bf16 as raw void ('|V2'),
                # which nothing can load back (review finding) — store
                # the bit pattern as uint16 with a dtype tag in the key
                flat[prefix + "::bf16"] = arr.view(np.uint16)
            else:
                flat[prefix] = arr

    rec("", tree)
    if config is not None:
        import dataclasses as _dc
        import json as _json
        js = _json.dumps(_dc.asdict(config)).encode()
        flat[_CONFIG_KEY] = np.frombuffer(js, np.uint8)
    np.savez(path, **flat)


def read_npz_config(path: str) -> Optional[TTSConfig]:
    """The TTSConfig embedded by save_pytree_npz(config=...), or None for
    older checkpoints (callers fall back to config_from_params)."""
    import json as _json

    from qwen3_tts_tpu.config import (EncoderConfig, SamplingConfig,
                                      VocoderConfig)

    with np.load(path) as data:
        if _CONFIG_KEY not in data.files:
            return None
        js = data[_CONFIG_KEY].tobytes().decode()
    d = _json.loads(js)

    def mk(cls, dd):
        # JSON turns tuples into lists; frozen configs need tuples back
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in dd.items()})

    return TTSConfig(
        talker=mk(TalkerConfig, d["talker"]),
        code_predictor=mk(CodePredictorConfig, d["code_predictor"]),
        vocoder=mk(VocoderConfig, d["vocoder"]),
        encoder=mk(EncoderConfig, d["encoder"]),
        sampling=mk(SamplingConfig, d["sampling"]),
        max_tokens=d["max_tokens"],
    )


def load_pytree_npz(path: str, dtype=None) -> Params:
    tree: Params = {}
    q8: Dict[str, np.ndarray] = {}
    q8s: Dict[str, np.ndarray] = {}

    def put(name, leaf):
        parts = name.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    with np.load(path) as data:  # close the handle (multi-GB file)
        for key in data.files:
            if key == _CONFIG_KEY:
                continue  # read via read_npz_config
            arr = data[key]
            name = key
            if key.endswith("::q8"):
                q8[key[: -len("::q8")]] = arr
                continue
            if key.endswith("::q8s"):
                q8s[key[: -len("::q8s")]] = arr
                continue
            if key.endswith("::bf16"):
                name = key[: -len("::bf16")]
                arr = arr.view(jnp.bfloat16)
            if dtype is not None and jnp.issubdtype(arr.dtype, jnp.floating):
                put(name, jnp.asarray(arr, dtype))
            else:
                put(name, jnp.asarray(arr))
    # reassemble pre-quantized int8 weights; scales stay float32 by
    # contract (ops/quant.QTensor) regardless of the requested dtype
    for name, q in q8.items():
        if name not in q8s:
            raise ValueError(f"{path}: quantized tensor {name!r} has no "
                             "::q8s scale entry — truncated checkpoint?")
        put(name, QTensor(jnp.asarray(q), jnp.asarray(q8s[name],
                                                      jnp.float32)))
    return tree


# ---------------------------------------------------------------------------
# HF safetensors loading
# ---------------------------------------------------------------------------

def _load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """Load all tensors from a .safetensors file. Routed through the
    native/pure-Python reader (runtime/native.py) because real Qwen
    checkpoints store bf16, which safetensors' numpy backend rejects."""
    from qwen3_tts_tpu.runtime.native import read_safetensors
    return read_safetensors(path)


def list_safetensors_keys(path: str) -> Dict[str, tuple]:
    """Read ONLY the safetensors JSON header: tensor name -> (dtype str,
    shape tuple). No weight bytes are touched, so probing a multi-GB
    checkpoint's key schema is instant (tools/convert_weights.py
    --list_keys; round-2 VERDICT item 8 — first contact with a real
    ``speech_tokenizer`` checkpoint should be a key diff, not a debugging
    session)."""
    import json
    import struct

    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        hdr = json.loads(f.read(n).decode("utf-8"))
    hdr.pop("__metadata__", None)
    return {k: (v["dtype"], tuple(v["shape"])) for k, v in hdr.items()}


def _stack_layers(get: Callable[[str], np.ndarray], prefix: str,
                  num_layers: int, dtype) -> Params:
    """Build the stacked layer pytree from per-layer HF tensors."""
    def t(name):  # (out,in) -> (in,out), stacked over layers
        return jnp.asarray(
            np.stack([get(f"{prefix}.{i}.{name}").T for i in range(num_layers)]),
            dtype)

    def raw(name):
        return jnp.asarray(
            np.stack([get(f"{prefix}.{i}.{name}") for i in range(num_layers)]),
            dtype)

    return {
        "input_ln": raw("input_layernorm.weight"),
        "q_proj": t("self_attn.q_proj.weight"),
        "k_proj": t("self_attn.k_proj.weight"),
        "v_proj": t("self_attn.v_proj.weight"),
        "o_proj": t("self_attn.o_proj.weight"),
        "q_norm": raw("self_attn.q_norm.weight"),
        "k_norm": raw("self_attn.k_norm.weight"),
        "post_ln": raw("post_attention_layernorm.weight"),
        "gate_proj": t("mlp.gate_proj.weight"),
        "up_proj": t("mlp.up_proj.weight"),
        "down_proj": t("mlp.down_proj.weight"),
    }


def load_talker_from_hf(weights: Dict[str, np.ndarray], cfg: TalkerConfig,
                        dtype=jnp.bfloat16) -> Params:
    """Map the HF Qwen3-TTS checkpoint's talker tensors into our pytree."""
    get = lambda k: weights[k]
    return {
        "layers": _stack_layers(get, "talker.model.layers", cfg.num_layers, dtype),
        "final_norm": jnp.asarray(get("talker.model.norm.weight"), dtype),
        "text_embedding": jnp.asarray(
            get("talker.model.text_embedding.weight"), dtype),
        "proj_fc1_w": jnp.asarray(
            get("talker.text_projection.linear_fc1.weight").T, dtype),
        "proj_fc1_b": jnp.asarray(
            get("talker.text_projection.linear_fc1.bias"), dtype),
        "proj_fc2_w": jnp.asarray(
            get("talker.text_projection.linear_fc2.weight").T, dtype),
        "proj_fc2_b": jnp.asarray(
            get("talker.text_projection.linear_fc2.bias"), dtype),
        "codec_embedding": jnp.asarray(
            get("talker.model.codec_embedding.weight"), dtype),
        "codec_head": jnp.asarray(get("talker.codec_head.weight").T, dtype),
    }


def load_code_predictor_from_hf(weights: Dict[str, np.ndarray],
                                cfg: CodePredictorConfig,
                                dtype=jnp.bfloat16) -> Params:
    get = lambda k: weights[k]
    pre = "talker.code_predictor"
    mtp_w_key = f"{pre}.small_to_mtp_projection.weight"
    mtp_b_key = f"{pre}.small_to_mtp_projection.bias"
    H = cfg.hidden_size
    mtp_w = (jnp.asarray(get(mtp_w_key).T, dtype)
             if mtp_w_key in weights else jnp.eye(H, dtype=dtype))
    mtp_b = (jnp.asarray(get(mtp_b_key), dtype)
             if mtp_b_key in weights else jnp.zeros((H,), dtype))
    return {
        "layers": _stack_layers(get, f"{pre}.model.layers", cfg.num_layers,
                                dtype),
        "final_norm": jnp.asarray(get(f"{pre}.model.norm.weight"), dtype),
        "mtp_proj_w": mtp_w,
        "mtp_proj_b": mtp_b,
        "codec_embs": jnp.asarray(np.stack(
            [get(f"{pre}.model.codec_embedding.{g}.weight")
             for g in range(cfg.num_groups)]), dtype),
        "lm_heads": jnp.asarray(np.stack(
            [get(f"{pre}.lm_head.{g}.weight").T
             for g in range(cfg.num_groups)]), dtype),
    }


# ---------------------------------------------------------------------------
# Speech-tokenizer (vocoder / encoder) loading
# ---------------------------------------------------------------------------

def _conv_w(a: np.ndarray) -> jnp.ndarray:
    """torch Conv1d weight (Cout, Cin/groups, K) -> JAX WIO (K, Cin/g, Cout)."""
    return jnp.asarray(np.ascontiguousarray(a.transpose(2, 1, 0)), jnp.float32)


def _tconv_w(a: np.ndarray) -> jnp.ndarray:
    """torch ConvTranspose1d weight (Cin, Cout, K) -> pre-flipped JAX WIO
    (K, Cin, Cout) so causal_trans_conv1d runs it as an lhs-dilated conv."""
    return jnp.asarray(
        np.ascontiguousarray(a.transpose(2, 0, 1)[::-1]), jnp.float32)


def load_vocoder_from_state_dict(sd: Dict[str, np.ndarray],
                                 cfg) -> Params:
    """Map the speech-tokenizer decoder's tensors (torch state_dict naming
    of ``Qwen3OmniMoeCode2Wav`` / ``Qwen3TTSTokenizerV2Model.decoder``, with
    any ``decoder.`` prefix already stripped) into the vocoder pytree.

    Strict: raises KeyError listing every missing tensor and ValueError for
    unconsumed ones, so key-name drift in a real checkpoint fails loudly
    instead of synthesizing noise (round-1 advisor finding)."""
    used = set()

    def get(k: str) -> np.ndarray:
        if k not in sd:
            raise KeyError(f"vocoder checkpoint missing tensor: {k!r}")
        used.add(k)
        return np.asarray(sd[k], np.float32)

    L, H = cfg.num_hidden_layers, cfg.hidden_size

    def stack(fmt: str, transpose: bool) -> jnp.ndarray:
        arrs = [get(fmt.format(i=i)) for i in range(L)]
        if transpose:
            arrs = [a.T for a in arrs]
        return jnp.asarray(np.stack(arrs), jnp.float32)

    pre = "pre_transformer.layers.{i}."
    layers = {
        "input_ln": stack(pre + "input_layernorm.weight", False),
        "post_ln": stack(pre + "post_attention_layernorm.weight", False),
        "q_proj": stack(pre + "self_attn.q_proj.weight", True),
        "k_proj": stack(pre + "self_attn.k_proj.weight", True),
        "v_proj": stack(pre + "self_attn.v_proj.weight", True),
        "o_proj": stack(pre + "self_attn.o_proj.weight", True),
        "gate_proj": stack(pre + "mlp.gate_proj.weight", True),
        "up_proj": stack(pre + "mlp.up_proj.weight", True),
        "down_proj": stack(pre + "mlp.down_proj.weight", True),
        "attn_scale": stack(pre + "self_attn_layer_scale.scale", False),
        "mlp_scale": stack(pre + "mlp_layer_scale.scale", False),
    }
    p: Params = {
        "code_embedding": jnp.asarray(get("code_embedding.weight"),
                                      jnp.float32),
        "pre": {"layers": layers,
                "norm": jnp.asarray(get("pre_transformer.norm.weight"),
                                    jnp.float32)},
        "upsample": {},
    }
    for i in range(len(cfg.upsampling_ratios)):
        u = f"upsample.{i}."
        p["upsample"][str(i)] = {
            "up_w": _tconv_w(get(u + "0.conv.weight")),
            "up_b": jnp.asarray(get(u + "0.conv.bias"), jnp.float32),
            "cn_dw_w": _conv_w(get(u + "1.dwconv.conv.weight")),
            "cn_dw_b": jnp.asarray(get(u + "1.dwconv.conv.bias"), jnp.float32),
            "cn_ln_w": jnp.asarray(get(u + "1.norm.weight"), jnp.float32),
            "cn_ln_b": jnp.asarray(get(u + "1.norm.bias"), jnp.float32),
            "cn_pw1_w": jnp.asarray(get(u + "1.pwconv1.weight").T, jnp.float32),
            "cn_pw1_b": jnp.asarray(get(u + "1.pwconv1.bias"), jnp.float32),
            "cn_pw2_w": jnp.asarray(get(u + "1.pwconv2.weight").T, jnp.float32),
            "cn_pw2_b": jnp.asarray(get(u + "1.pwconv2.bias"), jnp.float32),
            "cn_gamma": jnp.asarray(get(u + "1.gamma"), jnp.float32),
        }
    p["dec_in_w"] = _conv_w(get("decoder.0.conv.weight"))
    p["dec_in_b"] = jnp.asarray(get("decoder.0.conv.bias"), jnp.float32)
    p["blocks"] = {}
    n_blocks = len(cfg.upsample_rates)
    for i in range(n_blocks):
        d = f"decoder.{i + 1}.block."
        blk = {
            "alpha": jnp.asarray(get(d + "0.alpha"), jnp.float32),
            "beta": jnp.asarray(get(d + "0.beta"), jnp.float32),
            "up_w": _tconv_w(get(d + "1.conv.weight")),
            "up_b": jnp.asarray(get(d + "1.conv.bias"), jnp.float32),
            "res": {},
        }
        for d_i in range(3):
            r = d + f"{d_i + 2}."
            blk["res"][str(d_i)] = {
                "alpha1": jnp.asarray(get(r + "act1.alpha"), jnp.float32),
                "beta1": jnp.asarray(get(r + "act1.beta"), jnp.float32),
                "conv1_w": _conv_w(get(r + "conv1.conv.weight")),
                "conv1_b": jnp.asarray(get(r + "conv1.conv.bias"), jnp.float32),
                "alpha2": jnp.asarray(get(r + "act2.alpha"), jnp.float32),
                "beta2": jnp.asarray(get(r + "act2.beta"), jnp.float32),
                "conv2_w": _conv_w(get(r + "conv2.conv.weight")),
                "conv2_b": jnp.asarray(get(r + "conv2.conv.bias"), jnp.float32),
            }
        p["blocks"][str(i)] = blk
    post = f"decoder.{n_blocks + 1}."
    p["out_alpha"] = jnp.asarray(get(post + "alpha"), jnp.float32)
    p["out_beta"] = jnp.asarray(get(post + "beta"), jnp.float32)
    p["out_w"] = _conv_w(get(f"decoder.{n_blocks + 2}.conv.weight"))
    p["out_b"] = jnp.asarray(get(f"decoder.{n_blocks + 2}.conv.bias"),
                             jnp.float32)

    unused = set(sd) - used
    if unused:
        raise ValueError(
            "vocoder checkpoint has tensors the loader did not consume "
            f"(architecture mismatch?): {sorted(unused)[:10]}"
            f"{' ...' if len(unused) > 10 else ''}")
    return p


def split_speech_tokenizer_state_dict(
    weights: Dict[str, np.ndarray],
) -> Dict[str, Dict[str, np.ndarray]]:
    """Split a speech_tokenizer checkpoint's flat tensors into per-module
    state dicts keyed by top-level prefix (``decoder.``/``encoder.``; the
    reference takes ``.decoder`` of ``Qwen3TTSTokenizerV2Model``,
    export_vocoder_traced.py:74-80). Tensors with no recognized prefix go
    under ''."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in weights.items():
        for prefix in ("decoder.", "encoder."):
            if k.startswith(prefix):
                out.setdefault(prefix[:-1], {})[k[len(prefix):]] = v
                break
        else:
            out.setdefault("", {})[k] = v
    return out


def load_speech_tokenizer(st_dir: str, cfg: TTSConfig) -> Dict[str, Params]:
    """Load vocoder (and encoder, when present) from a
    ``speech_tokenizer/`` checkpoint directory (model.safetensors)."""
    st_path = os.path.join(st_dir, "model.safetensors")
    weights = _load_safetensors(st_path)
    groups = split_speech_tokenizer_state_dict(weights)
    dec_sd = groups.get("decoder") or groups.get("")
    if not dec_sd:
        raise KeyError(f"no decoder tensors found in {st_path}")
    ignored = sorted(g for g in groups
                     if g not in ("decoder", "encoder", ""))
    if ignored or ("decoder" in groups and groups.get("")):
        # the per-group loaders are strict, but tensors OUTSIDE the
        # decoder./encoder. prefixes would vanish silently — say so
        # (review finding; first contact with a real checkpoint should
        # be a key diff, not a mystery)
        import sys
        extra = ignored + (["<unprefixed>"]
                           if "decoder" in groups and groups.get("") else [])
        print(f"warning: speech_tokenizer checkpoint has tensor groups "
              f"the loaders do not consume: {extra}", file=sys.stderr)
    out = {"vocoder": load_vocoder_from_state_dict(dec_sd, cfg.vocoder)}
    if "encoder" in groups:
        from qwen3_tts_tpu.models import encoder as enc
        out["encoder"] = enc.load_encoder_from_state_dict(
            groups["encoder"], cfg.encoder)
    return out


# ---------------------------------------------------------------------------
# Top-level loading entry points
# ---------------------------------------------------------------------------

def detect_tts_config(model_dir: str, base: Optional[TTSConfig] = None,
                      ) -> TTSConfig:
    """Derive talker + code-predictor geometry from the checkpoint itself.

    Counterpart of the reference's auto-detection of model
    params from artifact tensor shapes (LLM_Qwen3TTS.hpp:307-323,
    vocoder_server.py:45-46): reads ONLY the safetensors JSON header
    (no weight bytes), so any Qwen3-TTS-family checkpoint — a different
    layer count, width, head config, or vocab — loads without code
    edits or a hand-written config. Shape-underivable scalars
    (rms_norm_eps, rope_theta) are taken from the checkpoint's
    ``config.json`` when present (best-effort: the sub-dict whose
    ``num_hidden_layers`` matches the detected stack), else from the
    ``base`` config's defaults. Serving choices (max_seq_len=512 KV
    allocation, max_tokens cap) stay ``base``'s — they are deployment
    policy, not model geometry.

    Raises FileNotFoundError if ``model.safetensors`` is absent and
    KeyError if the header lacks the expected tensor names.
    """
    import dataclasses
    import json
    import re

    base = base or TTSConfig()
    shapes = {k: s for k, (_, s) in
              list_safetensors_keys(
                  os.path.join(model_dir, "model.safetensors")).items()}

    def n_layers(prefix: str) -> int:
        pat = re.compile(re.escape(prefix) + r"\.(\d+)\.input_layernorm")
        idx = [int(m.group(1)) for k in shapes if (m := pat.match(k))]
        if not idx:
            raise KeyError(f"no layers found under {prefix!r}")
        return max(idx) + 1

    def stack_geo(prefix: str):
        l0 = f"{prefix}.0.self_attn."
        head_dim = shapes[l0 + "q_norm.weight"][0]
        q_out, hidden = shapes[l0 + "q_proj.weight"]
        kv_out = shapes[l0 + "k_proj.weight"][0]
        inter = shapes[f"{prefix}.0.mlp.gate_proj.weight"][0]
        return dict(num_layers=n_layers(prefix), hidden_size=hidden,
                    intermediate_size=inter, head_dim=head_dim,
                    num_heads=q_out // head_dim,
                    num_kv_heads=kv_out // head_dim)

    # eps/theta from config.json (shape-underivable). Candidate
    # sub-configs are matched by (num_hidden_layers, hidden_size) and
    # disambiguated by key path ("code_predictor" in the path vs not):
    # when talker and CP share a depth/width, a first-match walk would
    # silently hand the CP the talker's scalars (review finding). Each
    # scalar is taken from the best-ranked candidate that has it.
    def json_scalars(num_layers: int, hidden: int, want_cp: bool) -> dict:
        path = os.path.join(model_dir, "config.json")
        if not os.path.exists(path):
            return {}
        try:
            with open(path) as f:
                tree = json.load(f)
        except Exception:
            return {}
        cands: list = []  # (path string, node)

        def walk(node, npath):
            if isinstance(node, dict):
                if (node.get("num_hidden_layers") == num_layers
                        and node.get("hidden_size", hidden) == hidden):
                    cands.append((npath, node))
                for k, v in node.items():
                    walk(v, f"{npath}.{k}")
            elif isinstance(node, list):
                for v in node:
                    walk(v, npath)

        walk(tree, "")
        cands.sort(key=lambda c: (("code_predictor" in c[0] or
                                   "mtp" in c[0]) == want_cp),
                   reverse=True)
        found: dict = {}
        for _, node in cands:
            for key in ("rms_norm_eps", "rope_theta"):
                if key not in found and isinstance(node.get(key),
                                                   (int, float)):
                    found[key] = float(node[key])
        return found

    tg = stack_geo("talker.model.layers")
    text_vocab, text_dim = shapes["talker.model.text_embedding.weight"]
    codec_vocab = shapes["talker.model.codec_embedding.weight"][0]
    talker = dataclasses.replace(
        base.talker, **tg, text_vocab_size=text_vocab,
        text_embed_dim=text_dim, codec_vocab_size=codec_vocab,
        **json_scalars(tg["num_layers"], tg["hidden_size"], want_cp=False))

    cg = stack_geo("talker.code_predictor.model.layers")
    pat = re.compile(r"talker\.code_predictor\.lm_head\.(\d+)\.weight")
    groups = [int(m.group(1)) for k in shapes if (m := pat.match(k))]
    if not groups:
        raise KeyError("no talker.code_predictor.lm_head.N.weight tensors")
    num_groups = max(groups) + 1
    group_vocab = shapes["talker.code_predictor.lm_head.0.weight"][0]
    cp = dataclasses.replace(
        base.code_predictor, **cg, num_groups=num_groups,
        group_vocab_size=group_vocab,
        # 2-token prefill + (num_groups - 1) decode steps
        max_seq_len=num_groups + 1,
        **json_scalars(cg["num_layers"], cg["hidden_size"], want_cp=True))

    return dataclasses.replace(base, talker=talker, code_predictor=cp)


def config_from_params(params: Dict[str, Params],
                       base: Optional[TTSConfig] = None) -> TTSConfig:
    """Derive talker + code-predictor geometry from an already-loaded
    parameter bundle (the native ``params.npz`` analog of
    detect_tts_config: a converted non-default-geometry checkpoint must
    not silently run against the default config's shapes — review
    finding). FALLBACK path for npz files without an embedded
    __config__ (read_npz_config is authoritative): scalars (eps/theta)
    and the vocoder/encoder configs stay ``base``'s — they are not
    derivable from array shapes (vocoder head count / sliding window in
    particular), so a non-default vocoder geometry needs the embedded
    config."""
    import dataclasses

    base = base or TTSConfig()

    def stack_geo(comp):
        L, H, q_dim = comp["layers"]["q_proj"].shape
        head_dim = comp["layers"]["q_norm"].shape[-1]
        kv_dim = comp["layers"]["k_proj"].shape[-1]
        inter = comp["layers"]["gate_proj"].shape[-1]
        return dict(num_layers=int(L), hidden_size=int(H),
                    intermediate_size=int(inter), head_dim=int(head_dim),
                    num_heads=int(q_dim // head_dim),
                    num_kv_heads=int(kv_dim // head_dim))

    t, c = params["talker"], params["code_predictor"]
    talker = dataclasses.replace(
        base.talker, **stack_geo(t),
        codec_vocab_size=int(t["codec_embedding"].shape[0]),
        text_vocab_size=int(t["text_embedding"].shape[0]),
        text_embed_dim=int(t["text_embedding"].shape[1]))
    G = int(c["lm_heads"].shape[0])
    cp = dataclasses.replace(
        base.code_predictor, **stack_geo(c), num_groups=G,
        group_vocab_size=int(c["lm_heads"].shape[2]), max_seq_len=G + 1)
    return dataclasses.replace(base, talker=talker, code_predictor=cp)


def load_from_hf_checkpoint(model_dir: str, cfg: TTSConfig,
                            dtype=jnp.bfloat16) -> Dict[str, Params]:
    """Load talker + code predictor from an HF Qwen3-TTS checkpoint dir
    (model.safetensors). The vocoder lives in ``speech_tokenizer/`` with its
    own architecture; it is loaded separately when present, otherwise the
    caller falls back to native-format vocoder weights."""
    st_path = os.path.join(model_dir, "model.safetensors")
    weights = _load_safetensors(st_path)
    return {
        "talker": load_talker_from_hf(weights, cfg.talker, dtype),
        "code_predictor": load_code_predictor_from_hf(
            weights, cfg.code_predictor, dtype),
    }


def init_random_params(cfg: TTSConfig, seed: int = 0,
                       dtype=jnp.bfloat16) -> Dict[str, Params]:
    """Full random-init parameter bundle (tests, benchmarks, smoke runs).
    Vocoder is always float32 regardless of ``dtype`` (FP32-only contract)."""
    from qwen3_tts_tpu.models import code_predictor as cp
    from qwen3_tts_tpu.models import talker as tk
    from qwen3_tts_tpu.models import vocoder as voc

    k = jax.random.PRNGKey(seed)
    k1, k2, k3 = jax.random.split(k, 3)
    # jit each init so it compiles to ONE program per component instead
    # of dispatching every small op on its own.
    return {
        "talker": jax.jit(tk.init_talker_params,
                          static_argnums=(1, 2))(k1, cfg.talker, dtype),
        "code_predictor": jax.jit(cp.init_cp_params,
                                  static_argnums=(1, 2))(k2, cfg.code_predictor,
                                                         dtype),
        "vocoder": jax.jit(voc.init_vocoder_params,
                           static_argnums=(1,))(k3, cfg.vocoder),
    }


def load_params(
    model_dir: Optional[str],
    cfg: TTSConfig,
    dtype=jnp.bfloat16,
    seed: int = 0,
) -> Dict[str, Params]:
    """Resolve weights: HF checkpoint dir -> native npz -> random init.

    - ``model_dir`` containing ``model.safetensors``: HF path (vocoder from
      ``vocoder.npz`` native file in the same dir if present, else random).
    - ``model_dir`` containing ``params.npz``: native checkpoint. ``dtype``
      applies to the talker/code-predictor floats (vocoder/encoder stay
      FP32 by contract), same as the HF path.
    - ``model_dir is None``: random init.
    """
    if model_dir is None:
        return init_random_params(cfg, seed, dtype)
    native = os.path.join(model_dir, "params.npz")
    if os.path.exists(native):
        params = load_pytree_npz(native)
        if dtype is not None:
            def cast(a):
                if isinstance(a, QTensor):
                    return a  # int8 q + float32 scale by contract
                return (a.astype(dtype)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a)
            for comp in ("talker", "code_predictor"):
                if comp in params:
                    params[comp] = jax.tree.map(
                        cast, params[comp],
                        is_leaf=lambda x: isinstance(x, QTensor))
        return params
    params = load_from_hf_checkpoint(model_dir, cfg, dtype)
    st_dir = os.path.join(model_dir, "speech_tokenizer")
    voc_native = os.path.join(model_dir, "vocoder.npz")
    enc_native = os.path.join(model_dir, "encoder.npz")
    if os.path.exists(os.path.join(st_dir, "model.safetensors")):
        params.update(load_speech_tokenizer(st_dir, cfg))
    elif os.path.exists(voc_native):
        params["vocoder"] = load_pytree_npz(voc_native, jnp.float32)
        if os.path.exists(enc_native):
            # convert_weights.py --speech_tokenizer writes this next to
            # vocoder.npz; without loading it the voice-clone encoder
            # silently random-inits despite trained weights sitting in
            # the directory (review finding)
            params["encoder"] = load_pytree_npz(enc_native, jnp.float32)
    else:
        import warnings
        warnings.warn(
            f"{model_dir} has neither speech_tokenizer/model.safetensors "
            "nor vocoder.npz — the vocoder is RANDOMLY INITIALIZED and "
            "synthesis will emit noise, not speech. Provide the "
            "checkpoint's speech_tokenizer/ directory or run "
            "tools/convert_weights.py --speech_tokenizer.",
            stacklevel=2)
        from qwen3_tts_tpu.models import vocoder as voc
        params["vocoder"] = voc.init_vocoder_params(
            jax.random.PRNGKey(seed), cfg.vocoder)
    return params
