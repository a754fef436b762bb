"""Talker LLM: Qwen3 28-layer transformer in embedding mode + TTS embedding
surface (text_embedding + projection MLP, codec_embedding, codec_head).

Reproduces the numerical contract of the reference talker server
(/root/reference/dual_npu/llamacpp_talker_server.py):

- runs on *embedding vectors*, not token ids; the consumed output is the
  last-layer hidden state after the final RMSNorm (llama_wrapper.c:111-163);
- text-side embeddings go through the projection MLP
  Linear(2048->2048) + SiLU + Linear(2048->1024), with biases
  (llamacpp_talker_server.py:115-119);
- the dual-stream prefix sums a text-stream and a codec-stream embedding
  at each position (llamacpp_talker_server.py:121-161).

The prefix is built fully on device as a fixed-shape padded
tensor (text length is padded to a bucket; the true length rides along as
a scalar), so prefill is a single jitted program per bucket size.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import (
    ASSISTANT_TOKEN_ID,
    CODEC_BOS_ID,
    CODEC_NOTHINK_ID,
    CODEC_PAD_ID,
    CODEC_THINK_BOS_ID,
    CODEC_THINK_EOS_ID,
    IM_START_TOKEN_ID,
    NEWLINE_TOKEN_ID,
    TTS_BOS_TOKEN_ID,
    TTS_EOS_TOKEN_ID,
    TTS_PAD_TOKEN_ID,
    TalkerConfig,
)
from qwen3_tts_tpu.models import transformer as tfm

Params = Dict[str, jax.Array]

# Number of prefix positions besides the N text tokens:
# 3 role + 3 think + 1 transition + 1 tts_eos + 1 final codec_bos
PREFIX_EXTRA = 9


def init_talker_params(key: jax.Array, cfg: TalkerConfig,
                       dtype=jnp.float32) -> Params:
    """Random-init the full talker pytree (tests/bench; real weights via io)."""
    geo = tfm.geometry_of(cfg)
    ks = jax.random.split(key, 8)

    def w(k, shape, scale=0.02):
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(dtype)

    return {
        "layers": tfm.init_stack_params(ks[0], geo, dtype),
        "final_norm": jnp.ones((cfg.hidden_size,), dtype),
        # Embedding surface (extract_embeddings.py:47-70). Projection weights
        # are stored (in, out) — transposed from the HF (out, in) layout.
        "text_embedding": w(ks[1], (cfg.text_vocab_size, cfg.text_embed_dim)),
        "proj_fc1_w": w(ks[2], (cfg.text_embed_dim, cfg.text_embed_dim)),
        "proj_fc1_b": jnp.zeros((cfg.text_embed_dim,), dtype),
        "proj_fc2_w": w(ks[3], (cfg.text_embed_dim, cfg.hidden_size)),
        "proj_fc2_b": jnp.zeros((cfg.hidden_size,), dtype),
        "codec_embedding": w(ks[4], (cfg.codec_vocab_size, cfg.hidden_size)),
        # codec_head stored (hidden, vocab) so logits = hidden @ codec_head
        "codec_head": w(ks[5], (cfg.hidden_size, cfg.codec_vocab_size)),
    }


def embed_text(params: Params, token_ids: jax.Array) -> jax.Array:
    """text_embedding lookup + projection MLP (llamacpp_talker_server.py:115-119).

    token_ids: (...,) int -> (..., hidden).
    """
    e = params["text_embedding"][token_ids]
    h = jnp.dot(e, params["proj_fc1_w"],
                preferred_element_type=jnp.float32) + params["proj_fc1_b"]
    h = tfm.silu(h)
    out = jnp.dot(h.astype(e.dtype), params["proj_fc2_w"],
                  preferred_element_type=jnp.float32) + params["proj_fc2_b"]
    return out.astype(e.dtype)


def codec_logits(params: Params, hidden: jax.Array) -> jax.Array:
    """hidden (..., H) -> (..., codec_vocab). codec_head may be int8."""
    from qwen3_tts_tpu.ops import quant
    return quant.matmul(hidden, params["codec_head"])


def build_prefix(
    params: Params,
    text_token_ids: jax.Array,  # (N_pad,) int32, padded with anything
    n_text: jax.Array,          # scalar int32: true number of text tokens
) -> Tuple[jax.Array, jax.Array]:
    """Dual-stream prefix, fixed shape (N_pad + PREFIX_EXTRA, hidden).

    Port of llamacpp_talker_server.py:121-161. Layout:
      [0:3]   role: proj(text_emb([im_start, 77091, 198]))     (text only)
      [3:6]   tts_pad + codec_emb([nothink, think_bos, think_eos])
      [6]     tts_bos + codec_emb[pad]
      [7:7+N] proj(text_token_i) + codec_emb[pad]
      [7+N]   tts_eos + codec_emb[pad]
      [8+N]   tts_pad + codec_emb[bos]

    Padded variant: positions are laid out for the *padded* length; the
    three tail positions (text rows, tts_eos, final) are placed by masking
    so the result is exact for the true length. Returns
    (prefix (P_pad, H), prefix_len scalar = n_text + PREFIX_EXTRA).

    ``n_text`` is clamped to N_pad: an oversized count (a caller
    bucketing bug) would otherwise push the eos/final rows past the tail
    region and return a prefix_len pointing at zero rows — corrupt
    prefill with no error (review finding). n_text is traced, so this is
    a clamp rather than a host assert.
    """
    n_pad = text_token_ids.shape[0]
    n_text = jnp.minimum(jnp.asarray(n_text, jnp.int32), jnp.int32(n_pad))
    ce = params["codec_embedding"]

    special = embed_text(
        params,
        jnp.array([TTS_PAD_TOKEN_ID, TTS_BOS_TOKEN_ID, TTS_EOS_TOKEN_ID]),
    )
    tts_pad_e, tts_bos_e, tts_eos_e = special[0], special[1], special[2]

    role = embed_text(
        params,
        jnp.array([IM_START_TOKEN_ID, ASSISTANT_TOKEN_ID, NEWLINE_TOKEN_ID]),
    )  # (3, H)
    think = tts_pad_e[None, :] + ce[
        jnp.array([CODEC_NOTHINK_ID, CODEC_THINK_BOS_ID, CODEC_THINK_EOS_ID])
    ]  # (3, H)
    transition = (tts_bos_e + ce[CODEC_PAD_ID])[None, :]  # (1, H)

    text_e = embed_text(params, text_token_ids) + ce[CODEC_PAD_ID][None, :]  # (N_pad, H)

    # Tail rows depend on the true length: row 7+n_text is tts_eos+pad and
    # row 8+n_text is tts_pad+bos. Build a (N_pad+2, H) tail region where
    # rows < n_text are text, row == n_text is eos, row == n_text+1 is final.
    eos_row = tts_eos_e + ce[CODEC_PAD_ID]
    final_row = tts_pad_e + ce[CODEC_BOS_ID]
    tail_len = n_pad + 2
    ridx = jnp.arange(tail_len)
    text_pad2 = jnp.concatenate(
        [text_e, jnp.zeros((2, text_e.shape[1]), text_e.dtype)], axis=0)
    tail = jnp.where(
        (ridx < n_text)[:, None], text_pad2,
        jnp.where((ridx == n_text)[:, None], eos_row[None, :],
                  jnp.where((ridx == n_text + 1)[:, None], final_row[None, :],
                            jnp.zeros_like(text_pad2))))

    prefix = jnp.concatenate([role, think, transition, tail], axis=0)
    prefix_len = n_text.astype(jnp.int32) + PREFIX_EXTRA
    return prefix.astype(text_e.dtype), prefix_len


def clone_frame_embeds(params: Params, cp_codec_embs: jax.Array,
                       ref_codes: jax.Array) -> jax.Array:
    """Prefix-continuation embeddings for pre-encoded reference codec
    frames (voice cloning): the exact per-step feedback formula
    (reference dual_npu/tts_client.py:199-211) applied to [R, 16] codes —
    ``codec_embedding[c_0] + Σ_{g=1..15} cp_codec_emb[g-1][c_g] +
    tts_pad_embed`` per frame."""
    ce = params["codec_embedding"]
    tts_pad_e = embed_text(params, jnp.array([TTS_PAD_TOKEN_ID]))[0]
    c0 = ce[ref_codes[:, 0]]                               # (R, H)
    g_idx = jnp.arange(cp_codec_embs.shape[0])[None, :]    # (1, 15)
    rest = jnp.sum(cp_codec_embs[g_idx, ref_codes[:, 1:]], axis=1)
    return c0 + rest.astype(c0.dtype) + tts_pad_e[None, :]


def build_prefix_cloned(
    params: Params,
    cp_codec_embs: jax.Array,   # (15, 2048, H) CP per-group embed tables
    text_token_ids: jax.Array,  # (N_pad,) ref_text ++ target_text ids
    n_text: jax.Array,          # scalar: true total text tokens
    ref_codes: jax.Array,       # (R_pad, 16) int32 reference codec frames
    n_ref: jax.Array,           # scalar: true number of reference frames
) -> Tuple[jax.Array, jax.Array]:
    """In-context voice-cloning prefix: the standard dual-stream prefix
    over the concatenated (reference + target) text, followed by the
    reference audio's codec frames as continuation embeddings, so the
    decode loop continues the reference speaker's audio into the target
    text. Consumes the prompt_dir that scripts/encode_reference_audio.py
    produces — a capability the reference preps but never serves
    (SURVEY §0 'Voice cloning path').

    Returns (prefix (N_pad + PREFIX_EXTRA + R_pad, H),
    prefix_len = n_text + PREFIX_EXTRA + n_ref)."""
    prefix, plen = build_prefix(params, text_token_ids, n_text)
    frames = clone_frame_embeds(params, cp_codec_embs,
                                ref_codes).astype(prefix.dtype)
    R, H = frames.shape
    out = jnp.concatenate(
        [prefix, jnp.zeros((R, H), prefix.dtype)], axis=0)
    vals = jnp.where((jnp.arange(R) < n_ref)[:, None], frames,
                     jnp.zeros_like(frames))
    # rows >= plen of the base prefix are exactly zero (build_prefix masks
    # them), so scatter-add places the frames at [plen : plen + n_ref)
    out = out.at[plen + jnp.arange(R)].add(vals)
    return out, plen + n_ref.astype(jnp.int32)



def cloned_ref_limit(cap: int, text_pad: int) -> int:
    """Prefix budget (in KV rows) for a cloning request's reference
    frames: the KV allocation ``cap`` minus the padded text rows, the
    PREFIX_EXTRA special rows, and 8 rows of decode headroom. The ONE
    home for this clamp: the engine prompt path and the batched serving
    tier must produce bit-identical cloned prefills (docs/PARITY.md), so
    the formula must not fork across files."""
    return max(int(cap) - PREFIX_EXTRA - int(text_pad) - 8, 0)


def bucket_ref_frames(limit: int, ref_codes_np):
    """Host-side prep for a cloned prefix: clamp the reference codec
    frames to ``limit`` rows and zero-pad them to a shape bucket
    (16/32/64/128/256, largest clamped to the limit) so the cloned
    prefill compiles once per bucket instead of once per prompt length.
    Shared by the engine prompt path (engine/engine._prefill_cloned) and
    the batched serving tier so both produce bit-identical prefills.
    Returns (padded (b, 16) np.int32, n_ref kept)."""
    import numpy as _np

    n_ref = min(len(ref_codes_np), max(int(limit), 0))
    b = next((bk for bk in (16, 32, 64, 128, 256)
              if n_ref <= bk and bk <= limit), None)
    if b is None:
        # past the largest bucket (>20 s reference) or a tight limit:
        # a 64-aligned bucket of the KEPT length, clamped to the limit —
        # not the limit itself, which would pad the prefix to the whole
        # remaining KV budget (starving co-resident paged slots) and
        # compile one prefill per (text-bucket, cap) combination instead
        # of once per ref bucket
        b = max(min(-(-n_ref // 64) * 64, max(int(limit), 1)), 1)
    padded = _np.zeros((b, 16), _np.int32)
    padded[:n_ref] = _np.asarray(ref_codes_np, _np.int32)[:n_ref, :16]
    return padded, n_ref

def prefill(
    params: Params,
    prefix: jax.Array,      # (B, P_pad, H)
    prefix_len: jax.Array,  # (B,) true lengths
    kv_cache: jax.Array,    # (L, 2, B, S, Hkv, Dh)
    cfg: TalkerConfig,
) -> Tuple[jax.Array, jax.Array]:
    """Prefill: returns (hidden at last real position after final norm (B, H),
    updated kv_cache). Mirrors llm.get_hidden(prefix, keep_history=0)
    (llama_cpp_bindings.py:136-138 -> llama_wrapper.c:125-163)."""
    geo = tfm.geometry_of(cfg)
    B, P, _ = prefix.shape
    positions = jnp.broadcast_to(jnp.arange(P, dtype=jnp.int32), (B, P))
    mask = tfm.causal_mask(B, P, prefix_len)
    h, kv = tfm.forward_prefill(params["layers"], prefix, positions, mask,
                                geo, kv_cache)
    h = tfm.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    last = jnp.take_along_axis(
        h, (prefix_len - 1)[:, None, None].astype(jnp.int32), axis=1)[:, 0]
    return last, kv


def prefill_chunked(
    params: Params,
    prefix: jax.Array,      # (B, P_pad, H)
    prefix_len: jax.Array,  # (B,)
    kv_cache: jax.Array,
    cfg: TalkerConfig,
    chunk: int = 128,
) -> Tuple[jax.Array, jax.Array]:
    """Block-wise prefill in fixed `chunk`-token windows (the counterpart of
    the reference's 128-token chunked NPU prefill, LLM_Qwen3TTS.hpp:452-548).
    Numerically identical to the one-shot prefill (causal masking makes
    window order irrelevant); attention memory is O(chunk * S) instead of
    O(P^2). Returns (hidden at last real position, updated kv)."""
    geo = tfm.geometry_of(cfg)
    B, P, H = prefix.shape
    n_chunks = -(-P // chunk)
    S = tfm.kv_capacity(kv_cache)
    if n_chunks * chunk > S:
        # forward_window's dynamic_update_slice would CLAMP the final
        # window's write offset to S - chunk, silently overwriting real
        # prefix KV with padding rows at wrong RoPE positions (review
        # finding) — fail loudly instead; both shapes are static
        raise ValueError(
            f"chunked prefill needs n_chunks*chunk <= kv capacity: "
            f"{n_chunks}*{chunk} > {S} (prefix_pad={P})")
    pad = n_chunks * chunk - P
    if pad:
        prefix = jnp.concatenate(
            [prefix, jnp.zeros((B, pad, H), prefix.dtype)], axis=1)

    h_buf = jnp.zeros_like(prefix)

    def body(i, carry):
        h_buf, kv = carry
        x = jax.lax.dynamic_slice_in_dim(prefix, i * chunk, chunk, axis=1)
        h, kv = tfm.forward_window(params["layers"], x, i * chunk, kv, geo)
        h_buf = jax.lax.dynamic_update_slice_in_dim(h_buf, h, i * chunk,
                                                    axis=1)
        return h_buf, kv

    h_buf, kv = jax.lax.fori_loop(0, n_chunks, body, (h_buf, kv_cache))
    h_buf = tfm.rms_norm(h_buf, params["final_norm"], cfg.rms_norm_eps)
    last = jnp.take_along_axis(
        h_buf, (prefix_len - 1)[:, None, None].astype(jnp.int32), axis=1)[:, 0]
    return last, kv


def decode_step(
    params: Params,
    feedback: jax.Array,   # (B, H) feedback embedding
    pos: jax.Array,        # (B,) write positions
    kv_cache: jax.Array,
    cfg: TalkerConfig,
    mesh=None,
) -> Tuple[jax.Array, jax.Array]:
    """One talker decode step on a feedback embedding; returns final-norm
    hidden (B, H) and the updated cache. Mirrors
    llm.get_hidden(feedback, keep_history=1). ``mesh`` routes the paged
    path's write+attention through shard_map (see tfm.paged_decode_step)."""
    geo = tfm.geometry_of(cfg)
    if isinstance(kv_cache, tfm.PagedKV):
        h, kv = tfm.paged_decode_step(params["layers"], feedback, pos,
                                      kv_cache, geo, mesh=mesh)
    elif "layers_list" in params:
        h, kv = tfm.decode_step_unrolled(params["layers_list"], feedback,
                                         pos, kv_cache, geo)
    else:
        h, kv = tfm.decode_step(params["layers"], feedback, pos, kv_cache,
                                geo)
    h = tfm.rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return h, kv
