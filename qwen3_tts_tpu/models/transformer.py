"""Pure-function Qwen3 transformer blocks (shared by talker and code predictor).

Design notes
------------
- Parameters are plain pytrees (dicts of jnp arrays) with all per-layer
  tensors *stacked along a leading layer axis* so the layer loop is a
  single ``lax.scan`` — one trace, one compile.
- Everything is batched: shapes carry a leading batch dim ``B`` so the
  same code serves batch=1 CLI synthesis and continuous-batching serving.
- The KV cache is a preallocated, fixed-shape array updated with
  ``lax.dynamic_update_slice`` — no dynamic shapes anywhere, so the whole
  decode loop stays inside one XLA program.
- Weight matrices are stored **(in_features, out_features)** so the hot
  path is always ``x @ W`` (HF checkpoints store (out, in); the loader
  transposes once at load time).

Numerical contract reproduced from the reference implementation
(/root/reference): Qwen3 geometry with GQA 16/8 heads, head_dim 128,
per-head QK-RMSNorm before RoPE, RoPE theta=1e6, SwiGLU MLP, RMSNorm
eps=1e-6 (scripts/extract_talker_as_qwen3.py:89-110,
scripts/export_code_predictor_weights.py:51-70).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.ops import quant

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Elementary blocks
# ---------------------------------------------------------------------------

def rms_norm(x: jax.Array, weight: jax.Array, eps: float) -> jax.Array:
    """RMSNorm, HF Qwen3RMSNorm order exactly: normalize in fp32, cast
    back to the INPUT dtype, then multiply by the weight in that dtype
    (modeling_qwen3: ``self.weight * hidden_states.to(input_dtype)``).
    Multiplying in fp32 before the cast differs by up to 1 bf16 ulp per
    element (review finding: the old order made bitwise parity with the
    reference impossible at bf16); at fp32 the two orders are identical."""
    dtype = x.dtype
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    x_hat = (xf * jax.lax.rsqrt(var + eps)).astype(dtype)
    return x_hat * weight.astype(dtype)


def silu(x: jax.Array) -> jax.Array:
    return x * jax.nn.sigmoid(x)


def rope_cos_sin(positions: jax.Array, head_dim: int, theta: float,
                 dtype=jnp.float32) -> Tuple[jax.Array, jax.Array]:
    """cos/sin tables for given positions, HF 'rotate_half' convention.

    positions: int array of any shape ``(...)``; returns cos/sin of shape
    ``(..., head_dim)`` where the two halves repeat the same frequencies.
    """
    half = head_dim // 2
    freq_idx = jnp.arange(half, dtype=jnp.float32)
    inv_freq = 1.0 / (theta ** (freq_idx / half))
    angles = positions.astype(jnp.float32)[..., None] * inv_freq  # (..., half)
    cos = jnp.cos(angles)
    sin = jnp.sin(angles)
    cos = jnp.concatenate([cos, cos], axis=-1).astype(dtype)
    sin = jnp.concatenate([sin, sin], axis=-1).astype(dtype)
    return cos, sin


def rotate_half(x: jax.Array) -> jax.Array:
    half = x.shape[-1] // 2
    return jnp.concatenate([-x[..., half:], x[..., :half]], axis=-1)


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """x: (..., heads, head_dim); cos/sin: broadcastable (..., 1, head_dim)."""
    xf = x.astype(jnp.float32)
    out = xf * cos + rotate_half(xf) * sin
    return out.astype(x.dtype)


def swiglu_mlp(x: jax.Array, gate_w, up_w, down_w,
               gateup_w=None) -> jax.Array:
    """SwiGLU: down( silu(x@gate) * (x@up) ). Weights may be int8 QTensors
    (weight-only quant; ops/quant.py) — matmul dispatches. When a fused
    gate+up weight is present (quantize_layer_stack(fuse=True)) both
    projections run as ONE matmul — same bytes, one kernel launch."""
    if gateup_w is not None:
        gu = quant.matmul(x, gateup_w)
        I = gu.shape[-1] // 2
        g, u = gu[..., :I], gu[..., I:]
    else:
        g = quant.matmul(x, gate_w)
        u = quant.matmul(x, up_w)
    h = (silu(g) * u).astype(x.dtype)
    return quant.matmul(h, down_w).astype(x.dtype)


# ---------------------------------------------------------------------------
# Geometry carrier (static)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TransformerGeometry:
    num_layers: int
    hidden_size: int
    intermediate_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rms_norm_eps: float
    rope_theta: float

    @property
    def q_groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    @classmethod
    def attention_only(cls, num_heads: int, num_kv_heads: int,
                       head_dim: int) -> "TransformerGeometry":
        """Geometry for callers that only run gqa_attention (e.g. the
        paged decode attention): the attention fields are real, the
        stack fields are deliberately impossible sentinels so any future
        gqa_attention dependence on them fails loudly instead of reading
        a plausible dummy (review finding)."""
        return cls(num_layers=0, hidden_size=num_heads * head_dim,
                   intermediate_size=0, num_heads=num_heads,
                   num_kv_heads=num_kv_heads, head_dim=head_dim,
                   rms_norm_eps=float("nan"), rope_theta=float("nan"))


def geometry_of(cfg) -> TransformerGeometry:
    """Extract the shared geometry from TalkerConfig / CodePredictorConfig."""
    return TransformerGeometry(
        num_layers=cfg.num_layers, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
    )


# ---------------------------------------------------------------------------
# Parameter initialisation (random; real weights come from io/weights.py)
# ---------------------------------------------------------------------------

def init_stack_params(key: jax.Array, geo: TransformerGeometry,
                      dtype=jnp.float32, scale: float = 0.02) -> Params:
    """Random-init a stacked layer pytree (for tests / benchmarks)."""
    L, H, I = geo.num_layers, geo.hidden_size, geo.intermediate_size
    QD, KVD, Dh = geo.num_heads * geo.head_dim, geo.num_kv_heads * geo.head_dim, geo.head_dim
    ks = jax.random.split(key, 7)

    def w(k, shape):
        return (jax.random.normal(k, shape, jnp.float32) * scale).astype(dtype)

    return {
        "input_ln": jnp.ones((L, H), dtype),
        "q_proj": w(ks[0], (L, H, QD)),
        "k_proj": w(ks[1], (L, H, KVD)),
        "v_proj": w(ks[2], (L, H, KVD)),
        "o_proj": w(ks[3], (L, QD, H)),
        "q_norm": jnp.ones((L, Dh), dtype),
        "k_norm": jnp.ones((L, Dh), dtype),
        "post_ln": jnp.ones((L, H), dtype),
        "gate_proj": w(ks[4], (L, H, I)),
        "up_proj": w(ks[5], (L, H, I)),
        "down_proj": w(ks[6], (L, I, H)),
    }


def init_kv_cache(geo: TransformerGeometry, batch: int, max_seq: int,
                  dtype=jnp.float32) -> jax.Array:
    """KV cache [L, 2, B, S, Hkv, Dh]."""
    return jnp.zeros(
        (geo.num_layers, 2, batch, max_seq, geo.num_kv_heads, geo.head_dim),
        dtype,
    )


# ---------------------------------------------------------------------------
# Block-paged KV cache (SURVEY §7 hard part 4)
# ---------------------------------------------------------------------------

class PagedKV(NamedTuple):
    """Block-paged KV: slots own pages of a shared pool via a page table.

    Memory tracks actual usage instead of ``B x worst_case``, and a slot's
    generation length is bounded by its ALLOCATED pages (grown by the
    scheduler between decode chunks), not by a dense allocation.

    pool:     (L, 2, P, page_size, Hkv, Dh)
    table:    (B, MAXP) int32 — page ids in logical order; entries beyond
              the allocation are 0 (a safe, masked page)
    capacity: (B,) int32 — allocated rows (= n_pages_allocated * page_size)
    """

    pool: jax.Array
    table: jax.Array
    capacity: jax.Array

    @property
    def page_size(self) -> int:
        return self.pool.shape[3]


def init_paged_kv(geo: TransformerGeometry, batch: int, n_pages: int,
                  page_size: int, max_pages_per_slot: int,
                  dtype=jnp.float32) -> PagedKV:
    return PagedKV(
        pool=jnp.zeros((geo.num_layers, 2, n_pages, page_size,
                        geo.num_kv_heads, geo.head_dim), dtype),
        table=jnp.zeros((batch, max_pages_per_slot), jnp.int32),
        capacity=jnp.zeros((batch,), jnp.int32),
    )


def kv_capacity(kv) -> jax.Array:
    """Rows a slot may occupy: per-slot for paged, the dense S otherwise."""
    if isinstance(kv, PagedKV):
        return kv.capacity
    return kv.shape[3]


def paged_scatter_rows(paged: PagedKV, slot, rows_kv: jax.Array,
                       start: int = 0) -> PagedKV:
    """Write ``rows_kv`` (L, 2, R, Hkv, Dh) into logical rows
    [start : start+R] of ``slot`` (used to splice a dense batch-1 prefill
    into a slot's pages)."""
    L, _, R, _, _ = rows_kv.shape
    psz = paged.page_size
    logical = start + jnp.arange(R)
    pages = paged.table[slot, logical // psz]      # (R,)
    rows = logical % psz
    pool = paged.pool.at[:, :, pages, rows].set(
        rows_kv.astype(paged.pool.dtype))
    return paged._replace(pool=pool)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _qkv(layer: Params, x: jax.Array, geo: TransformerGeometry,
         cos: jax.Array, sin: jax.Array):
    """Project + per-head QK-RMSNorm + RoPE.

    x: (B, T, H). Returns q (B, T, Hq, Dh), k/v (B, T, Hkv, Dh).
    QK-norm before RoPE matches HF Qwen3Attention.
    """
    B, T, _ = x.shape
    xf = x.reshape(B * T, -1)
    if "qkv_proj" in layer:
        QD = geo.num_heads * geo.head_dim
        KVD = geo.num_kv_heads * geo.head_dim
        qkv = quant.matmul(xf, layer["qkv_proj"])    # one fused launch
        q = qkv[:, :QD].reshape(B, T, -1)
        k = qkv[:, QD:QD + KVD].reshape(B, T, -1)
        v = qkv[:, QD + KVD:].reshape(B, T, -1)
    else:
        q = quant.matmul(xf, layer["q_proj"]).reshape(B, T, -1)
        k = quant.matmul(xf, layer["k_proj"]).reshape(B, T, -1)
        v = quant.matmul(xf, layer["v_proj"]).reshape(B, T, -1)
    q = q.astype(x.dtype).reshape(B, T, geo.num_heads, geo.head_dim)
    k = k.astype(x.dtype).reshape(B, T, geo.num_kv_heads, geo.head_dim)
    v = v.astype(x.dtype).reshape(B, T, geo.num_kv_heads, geo.head_dim)
    q = rms_norm(q, layer["q_norm"], geo.rms_norm_eps)
    k = rms_norm(k, layer["k_norm"], geo.rms_norm_eps)
    # cos/sin: (B, T, Dh) -> broadcast over heads
    q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :])
    k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :])
    return q, k, v


def gqa_attention(q: jax.Array, k: jax.Array, v: jax.Array,
                  mask: jax.Array, geo: TransformerGeometry) -> jax.Array:
    """Grouped-query attention.

    q: (B, Tq, Hq, Dh); k/v: (B, Tk, Hkv, Dh);
    mask: (B, Tq, Tk) bool (True = attend). Returns (B, Tq, Hq*Dh).
    """
    B, Tq = q.shape[0], q.shape[1]
    Tk = k.shape[1]
    G = geo.q_groups
    qg = q.reshape(B, Tq, geo.num_kv_heads, G, geo.head_dim)
    scores = jnp.einsum(
        "bqhgd,bkhd->bhgqk", qg, k, preferred_element_type=jnp.float32
    ) / jnp.sqrt(geo.head_dim).astype(jnp.float32)
    scores = jnp.where(mask[:, None, None, :, :], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1).astype(v.dtype)
    out = jnp.einsum("bhgqk,bkhd->bqhgd", probs, v,
                     preferred_element_type=jnp.float32).astype(v.dtype)
    return out.reshape(B, Tq, geo.num_heads * geo.head_dim)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill) — scan over layers
# ---------------------------------------------------------------------------

def forward_prefill(
    params: Params,
    x: jax.Array,                # (B, P, H) input embeddings
    positions: jax.Array,        # (B, P) int32
    attn_mask: jax.Array,        # (B, P, P) bool
    geo: TransformerGeometry,
    kv_cache: Optional[jax.Array] = None,  # (L, 2, B, S, Hkv, Dh)
) -> Tuple[jax.Array, Optional[jax.Array]]:
    """Run all layers over a full (padded) sequence, filling kv_cache[:, :, :, :P].

    Returns (hidden (B, P, H) after all layers but BEFORE the final norm,
    updated kv_cache).
    """
    cos, sin = rope_cos_sin(positions, geo.head_dim, geo.rope_theta)
    P = x.shape[1]

    def layer_fn(h, xs):
        layer, kv_l = xs
        hn = rms_norm(h, layer["input_ln"], geo.rms_norm_eps)
        q, k, v = _qkv(layer, hn, geo, cos, sin)
        attn = gqa_attention(q, k, v, attn_mask, geo)
        B_, T_ = attn.shape[0], attn.shape[1]
        attn = quant.matmul(attn.reshape(B_ * T_, -1),
                            layer["o_proj"]).reshape(B_, T_, -1).astype(h.dtype)
        h = h + attn
        hn = rms_norm(h, layer["post_ln"], geo.rms_norm_eps)
        h = h + swiglu_mlp(hn, layer.get("gate_proj"),
                           layer.get("up_proj"), layer["down_proj"],
                           gateup_w=layer.get("gateup_proj"))
        if kv_l is not None:
            kv_l = jax.lax.dynamic_update_slice(
                kv_l, jnp.stack([k, v]).astype(kv_l.dtype), (0, 0, 0, 0, 0))
            # kv_l: (2, B, S, Hkv, Dh); new k/v occupy [:, :, :P]
        return h, kv_l

    if kv_cache is not None:
        h, new_kv = jax.lax.scan(layer_fn, x, (params, kv_cache))
        return h, new_kv
    h, _ = jax.lax.scan(lambda c, l: layer_fn(c, (l, None)), x, params)
    return h, None


def forward_prefill_unrolled(
    layers_list,                 # list of per-layer weight dicts
    x: jax.Array,                # (B, P, H)
    positions: jax.Array,        # (B, P)
    attn_mask: jax.Array,        # (B, P, P)
    geo: TransformerGeometry,
    kv_cache: jax.Array,         # (L, 2, B, S, Hkv, Dh)
) -> Tuple[jax.Array, jax.Array]:
    """forward_prefill over per-layer weight ARRAYS instead of a scanned
    stack: lax.scan can materialize a copy of each layer's weights
    before the matmuls read them (the same copy traffic that
    motivated decode_step_unrolled) — for short prefills (the code
    predictor's 2-token prefill runs once per talker token) the unrolled
    form reads each weight exactly once."""
    cos, sin = rope_cos_sin(positions, geo.head_dim, geo.rope_theta)
    h = x
    for li, layer in enumerate(layers_list):
        hn = rms_norm(h, layer["input_ln"], geo.rms_norm_eps)
        q, k, v = _qkv(layer, hn, geo, cos, sin)
        attn = gqa_attention(q, k, v, attn_mask, geo)
        B_, T_ = attn.shape[0], attn.shape[1]
        attn = quant.matmul(attn.reshape(B_ * T_, -1),
                            layer["o_proj"]).reshape(B_, T_, -1).astype(
                                h.dtype)
        h = h + attn
        hn = rms_norm(h, layer["post_ln"], geo.rms_norm_eps)
        h = h + swiglu_mlp(hn, layer.get("gate_proj"),
                           layer.get("up_proj"), layer["down_proj"],
                           gateup_w=layer.get("gateup_proj"))
        kv_cache = jax.lax.dynamic_update_slice(
            kv_cache,
            jnp.stack([k, v]).astype(kv_cache.dtype)[None],
            (li, 0, 0, 0, 0, 0))
    return h, kv_cache


def causal_mask(batch: int, seq_len: int, lengths: jax.Array) -> jax.Array:
    """(B, P, P) bool: causal AND key-position < length (padding masked)."""
    i = jnp.arange(seq_len)[:, None]
    j = jnp.arange(seq_len)[None, :]
    causal = j <= i                                    # (P, P)
    valid = jnp.arange(seq_len)[None, :] < lengths[:, None]  # (B, P)
    return causal[None, :, :] & valid[:, None, :]


# ---------------------------------------------------------------------------
# Windowed forward: C tokens at a global offset against the KV cache.
# The block-wise prefill primitive (the counterpart of the reference's
# chunked 128-token NPU prefill with incrementally-built causal masks,
# LLM_Qwen3TTS.hpp:452-548): attention cost O(C*S) per window instead of
# O(P^2), and the same path serves speculative/multi-token decode later.
# ---------------------------------------------------------------------------

def forward_window(
    params: Params,
    x: jax.Array,          # (B, C, H) window of input embeddings
    offset: jax.Array,     # scalar int32: global position of window start
    kv_cache: jax.Array,   # (L, 2, B, S, Hkv, Dh)
    geo: TransformerGeometry,
) -> Tuple[jax.Array, jax.Array]:
    """Run all layers over a C-token window, writing K/V at
    [offset : offset+C] and attending causally over [0 : offset+C].
    Returns (hidden (B, C, H) pre-final-norm, updated kv)."""
    B, C, _ = x.shape
    S = kv_cache.shape[3]
    positions = offset + jnp.arange(C, dtype=jnp.int32)          # (C,)
    cos, sin = rope_cos_sin(jnp.broadcast_to(positions, (B, C)),
                            geo.head_dim, geo.rope_theta)
    j = jnp.arange(S)[None, :]
    mask = j <= (offset + jnp.arange(C, dtype=jnp.int32))[:, None]  # (C, S)
    mask = jnp.broadcast_to(mask[None], (B, C, S))

    def layer_fn(h, xs):
        layer, kv_l = xs
        hn = rms_norm(h, layer["input_ln"], geo.rms_norm_eps)
        q, k, v = _qkv(layer, hn, geo, cos, sin)
        new_kv = jnp.stack([k, v]).astype(kv_l.dtype)  # (2, B, C, Hkv, Dh)
        kv_l = jax.lax.dynamic_update_slice(
            kv_l, new_kv, (0, 0, offset, 0, 0))
        attn = gqa_attention(q, kv_l[0], kv_l[1], mask, geo)
        attn = quant.matmul(attn.reshape(B * C, -1),
                            layer["o_proj"]).reshape(B, C, -1).astype(h.dtype)
        h = h + attn
        hn = rms_norm(h, layer["post_ln"], geo.rms_norm_eps)
        h = h + swiglu_mlp(hn, layer.get("gate_proj"),
                           layer.get("up_proj"), layer["down_proj"],
                           gateup_w=layer.get("gateup_proj"))
        return h, kv_l

    h, new_kv = jax.lax.scan(layer_fn, x, (params, kv_cache))
    return h, new_kv


# ---------------------------------------------------------------------------
# Single-token decode step — scan over layers, KV-cache read/write
# ---------------------------------------------------------------------------

def decode_step_unrolled(
    layers_list,           # list of L per-layer param dicts (NOT stacked)
    x: jax.Array,          # (B, H) new-token embedding
    pos: jax.Array,        # (B,) int32 write position
    kv_cache: jax.Array,   # (L, 2, B, S, Hkv, Dh)
    geo: TransformerGeometry,
) -> Tuple[jax.Array, jax.Array]:
    """decode_step with a Python-unrolled layer loop over per-layer weight
    arrays. Identical math to decode_step; exists because lax.scan over a
    stacked weight pytree can lower the per-iteration slice to a
    dynamic-slice that XLA materializes in device memory before each
    matmul — pure copy traffic. With per-layer arrays the matmuls read
    the weights directly. Costs a bigger HLO (L x the body), which only
    the int8 engine decode path pays."""
    B = x.shape[0]
    S = kv_cache.shape[3]
    cos, sin = rope_cos_sin(pos[:, None], geo.head_dim, geo.rope_theta)
    key_valid = jnp.arange(S)[None, :] <= pos[:, None]
    mask = key_valid[:, None, :]
    b_idx = jnp.arange(B)

    h = x
    for l, layer in enumerate(layers_list):
        hn = rms_norm(h, layer["input_ln"], geo.rms_norm_eps)
        q, k, v = _qkv(layer, hn[:, None, :], geo, cos, sin)  # T=1
        # (B, 2, Hkv, Dh): mixed basic/advanced indexing puts the advanced
        # (batch) dims first in the indexed result
        new_kv = jnp.stack([k[:, 0], v[:, 0]], axis=1).astype(kv_cache.dtype)
        # in-place scatter into the full cache (no per-layer slice copy /
        # re-stack: the slice reads below fuse into the attention ops)
        kv_cache = kv_cache.at[l, :, b_idx, pos].set(new_kv)
        k_all, v_all = kv_cache[l, 0], kv_cache[l, 1]
        attn1 = gqa_attention(q, k_all, v_all, mask, geo)[:, 0]
        attn = quant.matmul(attn1, layer["o_proj"]).astype(h.dtype)
        h = h + attn
        hn = rms_norm(h, layer["post_ln"], geo.rms_norm_eps)
        h = h + swiglu_mlp(hn, layer.get("gate_proj"),
                           layer.get("up_proj"), layer["down_proj"],
                           gateup_w=layer.get("gateup_proj"))
    return h, kv_cache


def paged_gather_kv(pool: jax.Array, table: jax.Array) -> jax.Array:
    """Materialize each slot's logical KV view.

    pool: (2, P, psz, Hkv, Dh); table: (B, MAXP) int32 (0-filled beyond
    the allocated pages — masked by position downstream).
    Returns (2, B, MAXP*psz, Hkv, Dh)."""
    g = pool[:, table]                # (2, B, MAXP, psz, Hkv, Dh)
    two, B, MAXP, psz, Hkv, Dh = g.shape
    return g.reshape(two, B, MAXP * psz, Hkv, Dh)


def paged_decode_attention(
    q: jax.Array,        # (B, Hq, Dh)
    pool: jax.Array,     # (2, P, psz, Hkv, Dh) — one layer's K/V pool
    table: jax.Array,    # (B, MAXP) int32
    pos: jax.Array,      # (B,) int32 — attend to rows [0 .. pos]
) -> jax.Array:
    """One query token per slot attends over its pages: gather the
    slot's logical KV view, then plain GQA attention masked by position.
    Returns (B, Hq*Dh) in q.dtype."""
    _, Hq, Dh = q.shape
    kv = paged_gather_kv(pool, table)         # (2, B, S_log, Hkv, Dh)
    S = kv.shape[2]
    mask = (jnp.arange(S)[None, :] <= pos[:, None])[:, None, :]  # (B,1,S)
    geo = TransformerGeometry.attention_only(
        num_heads=Hq, num_kv_heads=pool.shape[3], head_dim=Dh)
    out = gqa_attention(q[:, None], kv[0], kv[1], mask, geo)[:, 0]
    return out.astype(q.dtype)


def _paged_write_attend_local(q1: jax.Array, new_kv: jax.Array,
                              pool_l: jax.Array, table: jax.Array,
                              pos: jax.Array, *, psz: int,
                              p_local: int) -> Tuple[jax.Array, jax.Array]:
    """Per-dp-shard paged KV write + attention (runs inside shard_map;
    every array is this shard's local block: q1 (B/dp, Hq/tp, Dh), new_kv
    (2, B/dp, Hkv/tp, Dh), pool_l (2, P/dp, psz, Hkv/tp, Dh)).

    The table holds GLOBAL page ids; the batcher allocates a slot's pages
    only from its dp group's range [g*p_local, (g+1)*p_local), so attention
    is embarrassingly parallel — localize by subtracting the group's base.
    Any entry OUTSIDE the group's range — zeroed/released entries below
    it, or an out-of-range id from an allocation bug — maps to local
    page 0 (reserved per group; reads there are masked by pos, and
    frozen-slot rewrites land in it harmlessly). A plain clip sent
    above-range ids to live page p_local-1, where a buggy allocation
    would silently corrupt another slot's KV instead of the sink
    (review finding)."""
    dp_idx = jax.lax.axis_index("dp")
    local = table - dp_idx * p_local
    ltable = jnp.where((local >= 0) & (local < p_local), local, 0)
    b = jnp.arange(q1.shape[0])
    pids = ltable[b, pos // psz]
    rows = pos % psz
    pool_l = pool_l.at[:, pids, rows].set(new_kv)
    attn1 = paged_decode_attention(q1, pool_l, ltable, pos)
    return attn1, pool_l


def paged_decode_step(
    params: Params,
    x: jax.Array,          # (B, H) new-token embedding
    pos: jax.Array,        # (B,) int32 logical write position
    paged: PagedKV,
    geo: TransformerGeometry,
    mesh=None,
) -> Tuple[jax.Array, PagedKV]:
    """decode_step against the block-paged cache: K/V land in
    ``table[b, pos//psz]`` at row ``pos%psz``; attention gathers the
    slot's pages into a logical view (``paged_decode_attention``). Returns
    (hidden (B, H), updated PagedKV).

    ``mesh`` (optional dp x tp jax.sharding.Mesh): the write + attention
    run under shard_map — pages sharded over dp (each dp group owns a
    contiguous page range, allocated that way by the batcher), kv heads
    over tp — because a GSPMD gather over a dp-sharded page axis would
    materialize cross-shard collectives of the whole logical KV per step.
    Everything around it (qkv/o_proj/mlp) stays GSPMD like the dense mesh
    path (parallel/mesh.py)."""
    B = x.shape[0]
    psz = paged.page_size
    cos, sin = rope_cos_sin(pos[:, None], geo.head_dim, geo.rope_theta)
    if mesh is None:
        b_idx = jnp.arange(B)
        page_ids = paged.table[b_idx, pos // psz]   # (B,)
        rows = pos % psz
        write_attend = None
    else:
        from jax.sharding import PartitionSpec as P
        p_local = paged.pool.shape[2] // mesh.shape["dp"]
        write_attend = jax.shard_map(
            partial(_paged_write_attend_local, psz=psz, p_local=p_local),
            mesh=mesh,
            in_specs=(P("dp", "tp", None),            # q1 (B, Hq, Dh)
                      P(None, "dp", "tp", None),      # new_kv (2,B,Hkv,Dh)
                      P(None, "dp", None, "tp", None),  # pool_l
                      P("dp", None),                  # table
                      P("dp")),                       # pos
            out_specs=(P("dp", "tp"),                 # attn (B, Hq*Dh)
                       P(None, "dp", None, "tp", None)),
            check_vma=False)

    def layer_fn(h, xs):
        layer, pool_l = xs                      # pool_l: (2, P, psz, Hkv, Dh)
        hn = rms_norm(h, layer["input_ln"], geo.rms_norm_eps)
        q, k, v = _qkv(layer, hn[:, None, :], geo, cos, sin)  # T=1
        # (2, B, Hkv, Dh): basic index on axis 0 + adjacent advanced (B,)
        # indices on axes 1-2 keeps the kv axis leading in the update slot
        new_kv = jnp.stack([k[:, 0], v[:, 0]]).astype(pool_l.dtype)
        if write_attend is None:
            pool_l = pool_l.at[:, page_ids, rows].set(new_kv)
            attn1 = paged_decode_attention(q[:, 0], pool_l, paged.table, pos)
        else:
            attn1, pool_l = write_attend(q[:, 0], new_kv, pool_l,
                                         paged.table, pos)
        attn = quant.matmul(attn1, layer["o_proj"]).astype(h.dtype)
        h = h + attn
        hn = rms_norm(h, layer["post_ln"], geo.rms_norm_eps)
        h = h + swiglu_mlp(hn, layer.get("gate_proj"),
                           layer.get("up_proj"), layer["down_proj"],
                           gateup_w=layer.get("gateup_proj"))
        return h, pool_l

    h, new_pool = jax.lax.scan(layer_fn, x, (params, paged.pool))
    return h, paged._replace(pool=new_pool)


def decode_step(
    params: Params,
    x: jax.Array,          # (B, H) new-token embedding
    pos: jax.Array,        # (B,) int32 write position (== tokens so far)
    kv_cache: jax.Array,   # (L, 2, B, S, Hkv, Dh)
    geo: TransformerGeometry,
) -> Tuple[jax.Array, jax.Array]:
    """One decode step over all layers. Returns (hidden (B, H), new kv)."""
    B = x.shape[0]
    S = kv_cache.shape[3]
    cos, sin = rope_cos_sin(pos[:, None], geo.head_dim, geo.rope_theta)  # (B,1,Dh)
    key_valid = jnp.arange(S)[None, :] <= pos[:, None]      # (B, S)
    mask = key_valid[:, None, :]                            # (B, 1, S)

    def layer_fn(h, xs):
        layer, kv_l = xs
        hn = rms_norm(h, layer["input_ln"], geo.rms_norm_eps)
        q, k, v = _qkv(layer, hn[:, None, :], geo, cos, sin)  # T=1
        # write new k/v at per-batch position pos
        new_kv = jnp.stack([k[:, 0], v[:, 0]]).astype(kv_l.dtype)  # (2, B, Hkv, Dh)
        b_idx = jnp.arange(B)
        kv_l = kv_l.at[:, b_idx, pos].set(new_kv)
        k_all = kv_l[0]  # (B, S, Hkv, Dh)
        v_all = kv_l[1]
        attn1 = gqa_attention(q, k_all, v_all, mask, geo)[:, 0]
        attn = quant.matmul(attn1, layer["o_proj"]).astype(h.dtype)
        h = h + attn
        hn = rms_norm(h, layer["post_ln"], geo.rms_norm_eps)
        h = h + swiglu_mlp(hn, layer.get("gate_proj"),
                           layer.get("up_proj"), layer["down_proj"],
                           gateup_w=layer.get("gateup_proj"))
        return h, kv_l

    h, new_kv = jax.lax.scan(layer_fn, x, (params, kv_cache))
    return h, new_kv
