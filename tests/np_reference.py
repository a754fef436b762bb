"""Independent NumPy golden-reference implementation of the numerical
contracts in SURVEY.md §0 — used to validate the JAX implementation.

Deliberately written the "obvious" way (full recompute, python loops, no
KV cache) so that agreement with the fused JAX programs is meaningful.
"""

from __future__ import annotations

import numpy as np


# --- Qwen3 blocks -----------------------------------------------------------

def rms_norm(x, w, eps):
    x = x.astype(np.float64)
    var = np.mean(x * x, axis=-1, keepdims=True)
    return (x / np.sqrt(var + eps) * w).astype(np.float32)


def silu(x):
    return x / (1.0 + np.exp(-x))


def rope_cos_sin(positions, head_dim, theta):
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(half) / half))
    ang = np.asarray(positions, np.float64)[..., None] * inv_freq
    cos = np.concatenate([np.cos(ang), np.cos(ang)], axis=-1)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], axis=-1)
    return cos.astype(np.float32), sin.astype(np.float32)


def rotate_half(x):
    half = x.shape[-1] // 2
    return np.concatenate([-x[..., half:], x[..., :half]], axis=-1)


def apply_rope(x, cos, sin):
    return x * cos + rotate_half(x) * sin


def layer_forward(layer, x, positions, geo):
    """One Qwen3 layer over a full sequence. x: (T, H). Causal attention."""
    T, H = x.shape
    Hq, Hkv, Dh = geo["num_heads"], geo["num_kv_heads"], geo["head_dim"]
    eps = geo["rms_norm_eps"]

    hn = rms_norm(x, layer["input_ln"], eps)
    q = (hn @ layer["q_proj"]).reshape(T, Hq, Dh)
    k = (hn @ layer["k_proj"]).reshape(T, Hkv, Dh)
    v = (hn @ layer["v_proj"]).reshape(T, Hkv, Dh)
    q = rms_norm(q, layer["q_norm"], eps)
    k = rms_norm(k, layer["k_norm"], eps)
    cos, sin = rope_cos_sin(positions, Dh, geo["rope_theta"])
    q = apply_rope(q, cos[:, None, :], sin[:, None, :])
    k = apply_rope(k, cos[:, None, :], sin[:, None, :])

    G = Hq // Hkv
    out = np.zeros((T, Hq, Dh), np.float32)
    for h in range(Hq):
        kv_h = h // G
        scores = (q[:, h] @ k[:, kv_h].T) / np.sqrt(Dh)
        mask = np.tril(np.ones((T, T), bool))
        scores = np.where(mask, scores, -1e30)
        p = np.exp(scores - scores.max(-1, keepdims=True))
        p = p / p.sum(-1, keepdims=True)
        out[:, h] = p @ v[:, kv_h]
    attn = out.reshape(T, Hq * Dh) @ layer["o_proj"]
    x = x + attn

    hn = rms_norm(x, layer["post_ln"], eps)
    mlp = (silu(hn @ layer["gate_proj"]) * (hn @ layer["up_proj"])) @ layer["down_proj"]
    return (x + mlp).astype(np.float32)


def stack_forward(params, x, positions, geo):
    """All layers (stacked pytree) over a full sequence. x: (T, H)."""
    L = params["input_ln"].shape[0]
    for i in range(L):
        layer = {k: np.asarray(v[i]) for k, v in params.items()}
        x = layer_forward(layer, x, positions, geo)
    return x


# --- code_0 sampling (llamacpp_talker_server.py:163-206 contract) -----------

def sample_code0_probs(logits, past_tokens, n_text_tokens, cfg):
    """Everything up to (but excluding) the random draw. Returns
    (top_indices, kept_probs, keep_idx, force_eos)."""
    logits = logits.astype(np.float64).copy()
    V = logits.shape[0]
    logits[2048:2150] = -1e10
    if 2151 < V:
        logits[2151:] = -1e10

    force = False
    if past_tokens is not None and n_text_tokens > 0:
        expected = n_text_tokens * 3
        progress = len(past_tokens) / expected if expected > 0 else 0
        if progress > 0.8:
            boost = min((progress - 0.8) / 0.7, 1.0) * 15.0
            logits[2150] += boost
        if progress > 2.0:
            force = True

    if past_tokens:
        for t in set(past_tokens[-30:]):
            if 0 <= t < V:
                if logits[t] > 0:
                    logits[t] /= 1.2
                else:
                    logits[t] *= 1.2

    top_idx = np.argsort(logits)[-cfg["top_k"]:]
    top_logits = logits[top_idx]
    scaled = top_logits / max(cfg["temperature"], 1e-6)
    probs = np.exp(scaled - scaled.max())
    probs /= probs.sum()

    order = np.argsort(-probs)
    csum = np.cumsum(probs[order])
    cutoff = np.searchsorted(csum, cfg["top_p"]) + 1
    keep = order[:cutoff]
    kept = probs[keep] / probs[keep].sum()
    return top_idx, kept, keep, force
