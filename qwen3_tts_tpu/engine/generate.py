"""The fused decode loop — talker step + code-predictor scan + feedback,
all inside one ``lax.while_loop`` with zero host round-trips per token.

The reference pays 4 process hops per generated token (talker->client,
client->CP, CP->client, client->talker; SURVEY call stack 3.2) and 86% of
its per-token time in the code predictor (docs/ARCHITECTURE.md:104-107).
Here the whole feedback recursion is one XLA program:

    hidden ── sample code_0 ──► CP prefill(2) + scan(14) ──► codes 1..15
       ▲                                                        │
       └── talker decode step ◄── feedback = Σ 16 embeds + tts_pad

Feedback formula (reference dual_npu/tts_client.py:199-211):
    codec_embedding[code_0] + Σ_{g=1..15} cp_codec_emb[g-1][code_g]
    + tts_pad_embed.

Everything is batched (B requests decode in lockstep; finished elements
freeze) so the same program drives batch=1 CLI synthesis and the
continuous-batching daemon.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import (
    CODEC_EOS_ID,
    NUM_AUDIO_CODES,
    TTS_PAD_TOKEN_ID,
    TTSConfig,
)
from qwen3_tts_tpu.models import code_predictor as cp
from qwen3_tts_tpu.models import talker as tk
from qwen3_tts_tpu.models import transformer as tfm
from qwen3_tts_tpu.ops import sampling as smp

Params = Dict[str, jax.Array]


class GenState(NamedTuple):
    """Carry of the decode loop (a pytree; all fixed shapes)."""

    kv: jax.Array        # talker KV cache (L, 2, B, S, Hkv, Dh)
    pos: jax.Array       # (B,) next talker write position
    hidden: jax.Array    # (B, H) last talker hidden (post final-norm)
    ring: jax.Array      # (B, W) last code_0 window (-1 empty)
    n_codes: jax.Array   # (B,) codes generated per element
    done: jax.Array      # (B,) bool
    codes: jax.Array     # (B, T_max, 16) int32 output buffer
    n_text: jax.Array    # (B,) text-token counts (for EOS boost)
    step: jax.Array      # scalar: loop iterations done
    key: jax.Array       # (B, 2) uint32 PER-ELEMENT PRNG keys
    budget: jax.Array    # (B,) per-slot token budget (<= cfg.max_tokens)


batch_keys = smp.batch_keys  # re-export (see ops/sampling.batch_keys)


def init_state(
    talker_params: Params,
    prefix: jax.Array,       # (B, P_pad, H)
    prefix_len: jax.Array,   # (B,)
    n_text: jax.Array,       # (B,)
    key: jax.Array,          # (2,) broadcast or (B, 2) per-element
    cfg: TTSConfig,
    kv_dtype=None,
    budget=None,             # scalar or (B,) per-slot token budget
) -> GenState:
    """Prefill the talker and build the initial loop state.

    ``budget``: per-slot generation cap (the reference's per-request
    max_tokens, launch_qwen3_tts.sh:32). A runtime value — the loop stops
    the slot at min(budget, cfg.max_tokens) tokens, so a capped request
    in a lockstep batch frees its slot instead of decoding to the shared
    budget and trimming host-side. Defaults to cfg.max_tokens.

    Split into ``prefill_state`` (the expensive part, deterministic in
    the prefix alone — cacheable across requests) + ``assemble_state``
    (the cheap per-request tail: seed, budget, zeroed carries); the
    serving tier's prefix cache reuses the first across admissions
    (the batched analog of the reference's talker KV persistence,
    llamacpp_talker_server.py:208-246)."""
    hidden, kv = prefill_state(talker_params, prefix, prefix_len, cfg,
                               kv_dtype=kv_dtype)
    return assemble_state(hidden, kv, prefix_len, n_text, key, cfg,
                          budget=budget)


def prefill_state(
    talker_params: Params,
    prefix: jax.Array,       # (B, P_pad, H)
    prefix_len: jax.Array,   # (B,)
    cfg: TTSConfig,
    kv_dtype=None,
) -> tuple:
    """The expensive half of ``init_state``: run the talker prefill and
    return ``(hidden, kv)``. Deterministic in (params, prefix) — no seed
    or budget enters — so the result is cacheable per prefix."""
    B = prefix.shape[0]
    tcfg = cfg.talker
    geo = tfm.geometry_of(tcfg)
    kv = tfm.init_kv_cache(geo, B, tcfg.max_seq_len,
                           dtype=kv_dtype or prefix.dtype)
    hidden, kv = tk.prefill(talker_params, prefix, prefix_len, kv, tcfg)
    return hidden, kv


def assemble_state(
    hidden: jax.Array,       # (B, H) from prefill_state
    kv: jax.Array,           # from prefill_state
    prefix_len: jax.Array,   # (B,)
    n_text: jax.Array,       # (B,)
    key: jax.Array,          # (2,) broadcast or (B, 2) per-element
    cfg: TTSConfig,
    budget=None,
) -> GenState:
    """The cheap per-request half of ``init_state``: attach seed/budget
    and the zeroed loop carries to a (possibly cached) prefill result."""
    B = hidden.shape[0]
    W = cfg.sampling.repetition_window
    return GenState(
        kv=kv,
        pos=prefix_len.astype(jnp.int32),
        hidden=hidden,
        ring=jnp.full((B, W), -1, jnp.int32),
        n_codes=jnp.zeros((B,), jnp.int32),
        done=jnp.zeros((B,), jnp.bool_),
        codes=jnp.zeros((B, cfg.max_tokens, 16), jnp.int32),
        n_text=n_text.astype(jnp.int32),
        step=jnp.int32(0),
        key=batch_keys(key, B),
        budget=(jnp.full((B,), cfg.max_tokens, jnp.int32) if budget is None
                else jnp.minimum(
                    jnp.broadcast_to(jnp.asarray(budget, jnp.int32), (B,)),
                    cfg.max_tokens)),
    )


def _loop_body(state: GenState, talker_params: Params, cp_params: Params,
               tts_pad_embed: jax.Array, cfg: TTSConfig,
               mesh=None) -> GenState:
    B = state.hidden.shape[0]
    scfg = cfg.sampling
    # per-element key split: element i's stream depends only on ITS key,
    # never on batch size or slot position (exact batch-1 <-> slot-k
    # reproducibility; also gives the serving tier true per-request seeds)
    ks = jax.vmap(lambda k: jax.random.split(k, 3))(state.key)  # (B, 3, 2)
    key, c0_keys, k_cp = ks[:, 0], ks[:, 1], ks[:, 2]

    # 1. sample code_0 from the current hidden
    logits = tk.codec_logits(talker_params, state.hidden)  # (B, Vc)
    code0 = jax.vmap(
        lambda lg, rg, st, nt, kk: smp.sample_code0(lg, rg, st, nt, kk, scfg)
    )(logits, state.ring, state.n_codes, state.n_text, c0_keys)  # (B,)

    is_eos = (code0 == CODEC_EOS_ID) | (code0 >= NUM_AUDIO_CODES)
    # per-slot row bound: dense S, or the slot's allocated pages (paged)
    S = tfm.kv_capacity(state.kv)
    has_room = (state.n_codes < state.budget) & (state.pos < S - 1)
    active = ~state.done & ~is_eos & has_room  # producing a token now
    new_n_codes = state.n_codes + active.astype(jnp.int32)
    # a slot finishes on EOS, on hitting its PER-SLOT token budget, or on
    # filling its KV allocation (per-slot bounds — global step is never
    # consulted, so slots can be recycled indefinitely in the serving tier)
    new_done = (state.done | is_eos
                | (new_n_codes >= state.budget)
                | (state.pos + active.astype(jnp.int32) >= S - 1))

    # 2. code predictor: groups 1..15 (always computed; masked commit)
    code0_safe = jnp.where(active, code0, 0)
    c0_embed = talker_params["codec_embedding"][code0_safe]      # (B, H)
    groups = cp.predict_codes(cp_params, state.hidden, c0_embed, k_cp,
                              cfg.code_predictor, scfg)          # (B, 15)

    # 3. feedback embedding (row gathers)
    fb = (c0_embed
          + jnp.sum(cp_params["codec_embs"][jnp.arange(15)[None, :], groups],
                    axis=1)
          + tts_pad_embed[None, :]).astype(state.hidden.dtype)

    # 4. talker decode step (frozen elements rewrite their slot harmlessly)
    new_hidden, new_kv = tk.decode_step(talker_params, fb, state.pos,
                                        state.kv, cfg.talker, mesh=mesh)

    # 5. commit results for active elements only
    b_idx = jnp.arange(B)
    row = jnp.concatenate([code0_safe[:, None], groups], axis=1)  # (B, 16)
    write_idx = jnp.where(active, state.n_codes, cfg.max_tokens - 1)
    codes = jnp.where(
        active[:, None, None],
        state.codes.at[b_idx, write_idx].set(row),
        state.codes)

    return GenState(
        kv=new_kv,
        pos=jnp.where(active, state.pos + 1, state.pos),
        hidden=jnp.where(active[:, None], new_hidden, state.hidden),
        ring=jnp.where(active[:, None],
                       jax.vmap(smp.ring_push)(state.ring, code0_safe),
                       state.ring),
        n_codes=new_n_codes,
        done=new_done,
        codes=codes,
        n_text=state.n_text,
        step=state.step + 1,
        key=key,
        budget=state.budget,
    )


def run_steps(
    talker_params: Params,
    cp_params: Params,
    state: GenState,
    cfg: TTSConfig,
    max_steps,
    mesh=None,
) -> GenState:
    """Advance the fused loop by up to ``max_steps``; exits early once every
    batch element has hit EOS.

    ``mesh``: only needed for the PAGED multi-chip path (shard_map inside
    the paged attention; tfm.paged_decode_step) — the dense mesh path is
    pure GSPMD and needs no mesh argument here.

    ``max_steps`` may be a traced scalar — it only feeds the while_loop
    condition, so ONE compiled program serves every chunk size (head
    chunks, steady-state 64s, and whole-utterance runs), and each
    distinct program costs a full compile.
    """
    tts_pad_embed = tk.embed_text(
        talker_params, jnp.array([TTS_PAD_TOKEN_ID]))[0]
    # rebase the step counter per invocation: the serving tier carries ONE
    # GenState for the daemon's lifetime, and a cumulative int32 counter
    # would overflow after ~2^31 lockstep iterations — stop_step wraps
    # negative and every later chunk returns without progress (review
    # finding). step is only ever "iterations this run"; per-slot token
    # accounting lives in n_codes/budget.
    state = state._replace(step=jnp.int32(0))
    stop_step = jnp.asarray(max_steps, jnp.int32)

    def cond(s: GenState):
        return jnp.any(~s.done) & (s.step < stop_step)

    def body(s: GenState):
        return _loop_body(s, talker_params, cp_params, tts_pad_embed, cfg,
                          mesh=mesh)

    return jax.lax.while_loop(cond, body, state)


def generate(
    talker_params: Params,
    cp_params: Params,
    prefix: jax.Array,
    prefix_len: jax.Array,
    n_text: jax.Array,
    key: jax.Array,
    cfg: TTSConfig,
) -> Tuple[jax.Array, jax.Array]:
    """Full synthesis decode: returns (codes (B, T_max, 16), n_codes (B,)).

    Jit with ``static_argnums`` on cfg (it is hashable) or close over it.
    """
    state = init_state(talker_params, prefix, prefix_len, n_text, key, cfg)
    state = run_steps(talker_params, cp_params, state, cfg,
                      jnp.int32(cfg.max_tokens))
    return state.codes, state.n_codes
