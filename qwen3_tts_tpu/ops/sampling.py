"""Jittable sampling ops reproducing the reference sampling policies.

code_0 policy (reference dual_npu/llamacpp_talker_server.py:163-206):
  1. mask logits[2048:2150] and logits[2151:] to -1e10 (audio codes 0..2047
     plus EOS 2150 only);
  2. adaptive EOS boost: expected_len = 3 * n_text_tokens; once
     progress > 0.8, add min((progress-0.8)/0.7, 1) * 15.0 to the EOS
     logit; force EOS outright at progress > 2.0;
  3. repetition penalty 1.2 over a deduplicated 30-token window;
  4. top-k=50 -> temperature 0.8 softmax -> top-p 0.95 nucleus cut ->
     categorical sample.

CP group policy (reference dual_npu/code_predictor_server.py:87-92):
  top-k=50, temperature 0.1, categorical.

Differences from the reference, by design:
  - randomness uses explicit jax.random keys (the reference uses unseeded
    np.random) — deterministic given a key;
  - the repetition window is a fixed 30-slot ring buffer (fixed shapes for
    lax.while_loop) seeded with -1 sentinels, equivalent to the reference's
    ``set(past_tokens[-30:])`` because the penalty is applied once per
    distinct vocab id via a boolean membership mask.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import (
    CODEC_EOS_ID,
    NUM_AUDIO_CODES,
    SamplingConfig,
)

NEG = -1e10

_HOST_KEY_OK = None  # lazily validated once per process


def _host_key_np(seed: int):
    import numpy as np
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def host_prng_key(seed: int):
    """``jax.random.PRNGKey(seed)`` computed on the HOST (numpy).

    Why: an eager ``PRNGKey`` costs a device dispatch and round trip per
    request — and the first prefix-cache-hit streaming request paid a
    one-off compile for the eager key broadcast in the hot path. The threefry2x32 key layout is simply
    ``[seed>>32, seed&0xffffffff]`` (uint32); we validate that against
    the real op once per process and fall back to the device op if the
    default PRNG impl ever changes."""
    import numpy as np

    global _HOST_KEY_OK
    if _HOST_KEY_OK is None:
        probe = 0x1234ABCD5678
        _HOST_KEY_OK = bool(np.array_equal(
            np.asarray(jax.random.PRNGKey(probe)), _host_key_np(probe)))
    if _HOST_KEY_OK:
        return _host_key_np(int(seed))
    return jax.random.PRNGKey(seed)


def batch_keys(key: jax.Array, B: int) -> jax.Array:
    """Normalize a PRNG key to per-element (B, 2) form.

    A single (2,) key is BROADCAST (identical per element): identical
    requests with identical keys then produce identical outputs at any
    batch size / slot position — the lockstep-parity contract the batched
    tests assert. Callers wanting independent streams pass distinct
    per-element keys (e.g. ``jax.random.split(key, B)``).

    Host numpy keys (host_prng_key) stay on the host: the broadcast is a
    numpy view, and the key enters the device only as an argument of the
    next jitted program — no eager dispatch."""
    import numpy as np

    if isinstance(key, np.ndarray) and not isinstance(key, jax.Array):
        if key.ndim == 1:
            return np.broadcast_to(key[None], (B,) + key.shape)
        assert key.shape[0] == B, (key.shape, B)
        return key
    if isinstance(key, jax.Array) and jnp.issubdtype(key.dtype,
                                                     jax.dtypes.prng_key):
        # new-style typed key (jax.random.key): 0-d — unwrap to the raw
        # uint32 (2,) layout the loop state carries (review finding: the
        # bare .shape[0] below raised an obscure IndexError for these)
        key = jax.random.key_data(key)
    key = jnp.asarray(key)
    if key.ndim == 1:
        return jnp.broadcast_to(key[None], (B,) + key.shape)
    assert key.shape[0] == B, (key.shape, B)
    return key


def mask_code0_logits(logits: jax.Array) -> jax.Array:
    """Allow audio codes 0..2047 + EOS 2150; suppress everything else.

    logits: (..., codec_vocab). Mirrors llamacpp_talker_server.py:167-170.
    """
    v = logits.shape[-1]
    idx = jnp.arange(v)
    allowed = (idx < NUM_AUDIO_CODES) | (idx == CODEC_EOS_ID)
    return jnp.where(allowed, logits, NEG)


def eos_boost(logits: jax.Array, step: jax.Array, n_text_tokens: jax.Array,
              cfg: SamplingConfig) -> Tuple[jax.Array, jax.Array]:
    """Adaptive EOS boost (llamacpp_talker_server.py:172-181).

    step: number of codes generated so far (len(past_tokens)).
    Returns (boosted logits, force_eos bool).
    """
    expected = (n_text_tokens * cfg.expected_tokens_per_text_token).astype(jnp.float32)
    progress = jnp.where(expected > 0, step.astype(jnp.float32) / expected, 0.0)
    boost = jnp.where(
        progress > cfg.eos_boost_start,
        jnp.minimum((progress - cfg.eos_boost_start) / cfg.eos_boost_ramp, 1.0)
        * cfg.eos_boost_max,
        0.0,
    )
    logits = logits.at[..., CODEC_EOS_ID].add(boost)
    force = progress > cfg.eos_force_progress
    return logits, force


def repetition_penalty(logits: jax.Array, ring: jax.Array,
                       penalty: float) -> jax.Array:
    """Penalise every vocab id present in the ring buffer once.

    logits: (V,); ring: (W,) int32 with -1 for empty slots.
    Mirrors llamacpp_talker_server.py:183-189 — positive logits divided by
    the penalty, non-positive multiplied by it.
    """
    v = logits.shape[-1]
    # membership: does vocab id i appear in ring? Broadcast compare over
    # (V, W), one vectorized op; the scatter variant (.at[ring].max)
    # can lower to W serialized dynamic-updates.
    member = jnp.any(jnp.arange(v)[:, None] == ring[None, :], axis=1)
    penalised = jnp.where(logits > 0, logits / penalty, logits * penalty)
    return jnp.where(member, penalised, logits)


def topk_softmax_topp_sample(
    logits: jax.Array, key: jax.Array, top_k: int, temperature: float,
    top_p: float,
) -> jax.Array:
    """top-k -> temperature softmax -> nucleus cut -> categorical.

    Exact order-of-operations port of llamacpp_talker_server.py:191-206:
    probabilities are computed over the top-k logits only, the nucleus cut
    keeps the smallest prefix of descending-prob entries whose cumulative
    mass reaches top_p (searchsorted-left + 1 semantics), then renormalises.
    """
    top_vals, top_idx = jax.lax.top_k(logits, top_k)  # sorted descending
    scaled = top_vals / jnp.maximum(temperature, 1e-6)
    # (the reference's exp(scaled - max)/sum IS softmax; jax.nn.softmax
    # does the max-subtraction internally)
    probs = jax.nn.softmax(scaled)
    csum = jnp.cumsum(probs)
    shifted = jnp.concatenate([jnp.zeros((1,), probs.dtype), csum[:-1]])
    keep = shifted < top_p  # position j kept iff cumsum[j-1] < top_p
    logp = jnp.where(keep, jnp.log(jnp.maximum(probs, 1e-30)), -jnp.inf)
    choice = jax.random.categorical(key, logp)
    return top_idx[choice]


def topk_temperature_sample(logits: jax.Array, key: jax.Array, top_k: int,
                            temperature: float) -> jax.Array:
    """Plain top-k + temperature categorical (code_predictor_server.py:87-92)."""
    top_vals, top_idx = jax.lax.top_k(logits, top_k)
    scaled = (top_vals - jnp.max(top_vals)) / jnp.maximum(temperature, 1e-6)
    choice = jax.random.categorical(key, scaled)
    return top_idx[choice]


def sample_code0(
    logits: jax.Array,        # (codec_vocab,) = tk.codec_logits(hidden)
    ring: jax.Array,          # (W,) last code_0s, -1 sentinel
    step: jax.Array,          # scalar int: codes generated so far
    n_text_tokens: jax.Array, # scalar int
    key: jax.Array,
    cfg: SamplingConfig,
) -> jax.Array:
    """Full code_0 policy. Returns sampled code (int32); may be EOS."""
    logits = mask_code0_logits(logits.astype(jnp.float32))
    logits, force = eos_boost(logits, step, n_text_tokens, cfg)
    logits = repetition_penalty(logits, ring, cfg.repetition_penalty)
    tok = topk_softmax_topp_sample(logits, key, cfg.top_k, cfg.temperature,
                                   cfg.top_p)
    return jnp.where(force, jnp.int32(CODEC_EOS_ID), tok.astype(jnp.int32))


def ring_push(ring: jax.Array, value: jax.Array) -> jax.Array:
    """Shift the window left and append value (newest at the end)."""
    return jnp.concatenate([ring[1:], value.astype(ring.dtype)[None]])
