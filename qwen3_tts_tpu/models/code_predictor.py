"""Code predictor: 5-layer Qwen3-style transformer that expands each talker
token (hidden, code_0) into codec groups 1..15.

Numerical contract (reference /root/reference):

- per talker token: prefill position 0 with the talker hidden, position 1
  with the *talker's* codec_embedding[code_0]
  (dual_npu/code_predictor_server.py:96-124);
- sample group 1 from ``hidden @ lm_head_0.T``; then for step 1..14 embed
  the previous code with ``codec_emb_{step-1}`` and decode one position
  (code_predictor_server.py:127-140);
- a ``small_to_mtp_projection`` is applied to every input embedding before
  the layers (scripts/export_code_predictor_onnx.py:38-46);
- sampling is plain top-k=50 at temperature 0.1
  (code_predictor_server.py:87-92).

The 15-group recursion is a single ``lax.scan`` with the
per-group embedding/head tables stacked into [15, 2048, hidden] tensors so
the whole inner loop lives inside the outer decode program — zero host
round-trips (the reference pays a socket hop per talker token here and
86% of its runtime, docs/ARCHITECTURE.md:104-107).

The reference's batched 2-token prefill is "approximate" only because of
its ONNX session plumbing; a causally-masked 2-token forward is exactly
equal to two sequential steps, so we always batch the prefill.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import CodePredictorConfig, SamplingConfig
from qwen3_tts_tpu.models import transformer as tfm
from qwen3_tts_tpu.ops import sampling as smp

Params = Dict[str, jax.Array]


def init_cp_params(key: jax.Array, cfg: CodePredictorConfig,
                   dtype=jnp.float32) -> Params:
    geo = tfm.geometry_of(cfg)
    ks = jax.random.split(key, 5)

    def w(k, shape, scale=0.02):
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(dtype)

    H, G, V = cfg.hidden_size, cfg.num_groups, cfg.group_vocab_size
    return {
        "layers": tfm.init_stack_params(ks[0], geo, dtype),
        "final_norm": jnp.ones((H,), dtype),
        # small_to_mtp_projection (export_code_predictor_onnx.py:41): a
        # linear map applied to input embeddings; stored (in, out).
        "mtp_proj_w": w(ks[1], (H, H)),
        "mtp_proj_b": jnp.zeros((H,), dtype),
        # 15 per-group embeddings / heads, stacked (export_..._weights.py:72-74)
        "codec_embs": w(ks[2], (G, V, H)),      # codec_emb_0..14
        "lm_heads": w(ks[3], (G, H, V)),        # lm_head_0..14, (hidden, vocab)
    }


def _project_in(params: Params, x: jax.Array) -> jax.Array:
    """small_to_mtp_projection applied to every layer input embedding."""
    out = jnp.dot(x, params["mtp_proj_w"],
                  preferred_element_type=jnp.float32) + params["mtp_proj_b"]
    return out.astype(x.dtype)


def predict_codes(
    params: Params,
    hidden: jax.Array,        # (B, H) talker hidden (post final norm)
    code0_embed: jax.Array,   # (B, H) talker codec_embedding[code_0]
    key: jax.Array,           # (2,) shared or (B, 2) per-element keys
    cfg: CodePredictorConfig,
    scfg: SamplingConfig,
) -> jax.Array:
    """Predict groups 1..15 for each batch element. Returns (B, 15) int32.

    Mirrors CodePredictorServer.predict (code_predictor_server.py:94-140)
    with the 14-step inner AR loop as a lax.scan.

    Randomness is PER ELEMENT: element i's draws depend only on key[i]
    (a (2,) key is broadcast), so outputs are invariant to batch size and
    slot position for a fixed per-element key.
    """
    geo = tfm.geometry_of(cfg)
    B, H = hidden.shape
    S = cfg.max_seq_len
    key = smp.batch_keys(key, B)  # (B, 2)

    kv = tfm.init_kv_cache(geo, B, S, dtype=hidden.dtype)

    # --- 2-token prefill (positions 0, 1), causally masked => exact ---
    x2 = jnp.stack([hidden, code0_embed], axis=1)          # (B, 2, H)
    x2 = _project_in(params, x2)
    positions = jnp.broadcast_to(jnp.arange(2, dtype=jnp.int32), (B, 2))
    mask = tfm.causal_mask(B, 2, jnp.full((B,), 2, jnp.int32))
    if "layers_list" in params:
        h, kv = tfm.forward_prefill_unrolled(params["layers_list"], x2,
                                             positions, mask, geo, kv)
    else:
        h, kv = tfm.forward_prefill(params["layers"], x2, positions, mask,
                                    geo, kv_cache=kv)
    h = tfm.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    h_last = h[:, -1]                                       # (B, H)

    # --- group 1 from lm_head_0 ---
    from qwen3_tts_tpu.ops import quant
    logits0 = quant.matmul(h_last, params["lm_heads"][0])   # (B, V)
    # per-element group keys: (B, num_groups, 2)
    keys = jax.vmap(lambda k: jax.random.split(k, cfg.num_groups))(key)
    tok0 = jax.vmap(
        lambda lg, kk: smp.topk_temperature_sample(
            lg, kk, scfg.cp_top_k, scfg.cp_temperature)
    )(logits0, keys[:, 0]).astype(jnp.int32)                # (B,)

    # --- steps 1..14: embed prev with codec_emb[step-1], decode pos step+1,
    #     sample from lm_head[step] ---
    def step_fn(carry, xs):
        tok, kv = carry
        step_idx, kstep = xs  # step_idx in 1..14; kstep (B, 2)
        emb = params["codec_embs"][step_idx - 1][tok]       # (B, H)
        emb = _project_in(params, emb)
        pos = jnp.full((B,), step_idx + 1, jnp.int32)
        hh, kv = tfm.decode_step(params["layers"], emb, pos, kv, geo)
        hh = tfm.rms_norm(hh, params["final_norm"], cfg.rms_norm_eps)
        logits = quant.matmul(hh, params["lm_heads"][step_idx])
        ntok = jax.vmap(
            lambda lg, kk: smp.topk_temperature_sample(
                lg, kk, scfg.cp_top_k, scfg.cp_temperature)
        )(logits, kstep).astype(jnp.int32)
        return (ntok, kv), ntok

    steps = jnp.arange(1, cfg.num_groups, dtype=jnp.int32)
    # (B, G-1, 2) -> (G-1, B, 2): scan over groups, per-element keys inside
    (_, _), toks = jax.lax.scan(step_fn, (tok0, kv),
                                (steps, jnp.swapaxes(keys[:, 1:], 0, 1)))
    # toks: (14, B) -> (B, 15) with tok0 first
    return jnp.concatenate([tok0[:, None], toks.T], axis=1)
