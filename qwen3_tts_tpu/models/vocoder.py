"""FP32 codec-decoder (vocoder): [B, T, 16] int codes -> 24 kHz waveform.

Faithful JAX port of the Qwen3-TTS speech-tokenizer-v2 decoder that the
reference traces to ONNX (scripts/export_vocoder_traced.py:74-80,
``Qwen3TTSTokenizerV2Model.decoder``). The architecture is the public Qwen
codec decoder (``Qwen3OmniMoeCode2Wav``, transformers
models/qwen3_omni_moe/modeling_qwen3_omni_moe.py), whose *default* geometry
reproduces every numerical contract the reference documents for this
vocoder: 16 quantizers x 2048 codes, exactly 1920 samples per token at
24 kHz (README.md:139), Snake activation x + sin^2(ax)/b (README.md:58),
dilated Conv1D residual units with dilation up to 9 (README.md:61), causal
convolutions, FP32-only because quantization is destructive
(README.md:56-64).

Pipeline (matching the torch module tree tensor-for-tensor; golden parity
tests live in tests/test_vocoder_golden.py):

  codes (B, T, 16) -> per-quantizer embedding (offset lookup), mean over 16
  -> pre_transformer: sliding-window causal attention (window 72, RoPE
     theta 1e4, LayerScale, RMSNorm, SwiGLU), 8 layers at hidden 1024
  -> 2 ConvNeXt upsampling stages (x2 each; causal depthwise k7 + LN + MLP)
  -> waveform decoder: causal conv 1024->1536, then 4 blocks of
     [SnakeBeta, ConvTranspose(k=2r, s=r), 3 residual units (d=1,3,9)]
     halving channels (1536->...->96), SnakeBeta, causal conv -> 1 channel,
     clamp to [-1, 1].

All convs are XLA ``conv_general_dilated`` in NWC layout, transposed
convs are lhs-dilated convs over pre-flipped kernels, everything is
fixed-shape per chunk so each chunk geometry jits once, and every matmul
and conv runs at full float32 precision (``fp32_precision``). Chunked synthesis uses left-context + one-token-lookahead windows
(the model is causal with <1 token of transposed-conv lookahead); the conv
path is sample-exact against full decode, attention context is truncated to
the left context (~1e-5 — the torch ``chunked_decode`` shares this
property and additionally drops ``output_crop`` samples per chunk, which we
don't). The reference's overlap-crossfade server (vocoder_server.py:73-121)
is also provided for wire parity.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from qwen3_tts_tpu.config import (
    SAMPLES_PER_TOKEN,
    VOC_CHUNK_SIZE,
    VOC_OVERLAP,
    VocoderConfig,
)

Params = Dict[str, jax.Array]


def fp32_precision(fn):
    """Trace ``fn``'s matmuls and convolutions at full float32 precision.

    The vocoder is FP32 by contract. A GPU otherwise computes float32 dots
    and convs on TF32 operands (10-bit mantissa): on an H100 that put a
    64-token window 1.0e-3 of the output peak away from the CPU, five
    times the golden tests' rtol of 2e-4; at "highest" it is 2.8e-6."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def snake(x: jax.Array, alpha: jax.Array) -> jax.Array:
    """Plain Snake: x + sin^2(alpha*x)/alpha, per-channel alpha over
    (B, T, C). The activation family the reference pins to FP32
    (README.md:56-64); the decoder itself uses the SnakeBeta variant."""
    a = alpha[None, None, :]
    s = jnp.sin(a * x)
    return x + s * s / (a + 1e-9)


def snake_beta(x: jax.Array, alpha: jax.Array, beta: jax.Array) -> jax.Array:
    """SnakeBeta: x + sin^2(x * e^alpha) / (e^beta + 1e-9) with raw
    (log-scale) per-channel parameters, exactly as the torch SnakeBeta
    module computes it. x: (B, T, C); alpha, beta: (C,)."""
    a = jnp.exp(alpha)[None, None, :]
    b = jnp.exp(beta)[None, None, :]
    s = jnp.sin(x * a)
    return x + s * s / (b + 1e-9)


def conv1d(x: jax.Array, w: jax.Array, b: jax.Array, *,
           stride: int = 1, dilation: int = 1, padding: str = "SAME",
           groups: int = 1) -> jax.Array:
    """x: (B, T, Cin); w: (K, Cin/groups, Cout). 'SAME' symmetric padding
    (used by the encoder front-end and tests), or 'VALID'."""
    if padding == "SAME":
        k_eff = (w.shape[0] - 1) * dilation + 1
        pad_l = (k_eff - 1) // 2
        pad_r = k_eff - 1 - pad_l
        pads = [(pad_l, pad_r)]
    else:
        pads = [(0, 0)]
    out = jax.lax.conv_general_dilated(
        x, w, window_strides=(stride,), padding=pads,
        rhs_dilation=(dilation,), feature_group_count=groups,
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,
    )
    return out + b[None, None, :]


def causal_conv1d(x: jax.Array, w: jax.Array, b: jax.Array, *,
                  stride: int = 1, dilation: int = 1,
                  groups: int = 1) -> jax.Array:
    """Causal conv with the torch CausalConvNet padding contract
    (left pad = k_eff - stride, plus right padding to complete frames).
    x: (B, T, Cin); w: (K, Cin/groups, Cout)."""
    k_eff = (w.shape[0] - 1) * dilation + 1
    pad_l = k_eff - stride
    # extra right padding so every input frame is covered (static: shapes
    # are known at trace time)
    length = x.shape[1]
    n_frames = (length - k_eff + pad_l) / stride + 1
    ideal = (math.ceil(n_frames) - 1) * stride + (k_eff - pad_l)
    pad_r = ideal - length
    out = jax.lax.conv_general_dilated(
        x, w, window_strides=(stride,), padding=[(pad_l, pad_r)],
        rhs_dilation=(dilation,), feature_group_count=groups,
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,
    )
    return out + b[None, None, :]


def causal_trans_conv1d(x: jax.Array, w: jax.Array, b: jax.Array, *,
                        stride: int) -> jax.Array:
    """Causal transposed conv matching torch CausalTransConvNet: a
    ConvTranspose1d(k, s) whose output is cropped by ceil(k - s) on BOTH
    sides. Implemented as an lhs-dilated conv; ``w`` must already be
    spatially flipped and in (K, Cin, Cout) layout (see the loader).
    Output length: (T-1)*s + k - 2*crop."""
    k = w.shape[0]
    crop = max(k - stride, 0)
    out = jax.lax.conv_general_dilated(
        x, w, window_strides=(1,), padding=[(k - 1 - crop, k - 1 - crop)],
        lhs_dilation=(stride,),
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,
    )
    return out + b[None, None, :]


def rms_norm(x: jax.Array, w: jax.Array, eps: float) -> jax.Array:
    # one RMSNorm definition for the whole framework (vocoder inputs are
    # fp32, so transformer.rms_norm's fp32-weight cast is a no-op here)
    from qwen3_tts_tpu.models.transformer import rms_norm as _tfm_rms_norm
    return _tfm_rms_norm(x, w, eps)


def layer_norm(x: jax.Array, w: jax.Array, b: jax.Array,
               eps: float = 1e-6) -> jax.Array:
    mu = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * w + b


# ---------------------------------------------------------------------------
# Pre-transformer (sliding-window causal attention over code frames)
# ---------------------------------------------------------------------------

def _rope(x: jax.Array, cfg: VocoderConfig) -> jax.Array:
    """Rotary embedding over (B, T, Hh, Dh), full head_dim, positions
    0..T-1 (chunk decode is a full forward pass; no KV cache). Delegates
    to the framework's ONE RoPE implementation (transformer.rope_cos_sin
    / apply_rope — bit-identical in fp32: a*cos + (-b)*sin == a*cos -
    b*sin exactly) so the rotate_half convention cannot fork across
    files (review finding; same rationale as the shared rms_norm)."""
    from qwen3_tts_tpu.models.transformer import apply_rope, rope_cos_sin

    T = x.shape[1]
    cos, sin = rope_cos_sin(jnp.arange(T, dtype=jnp.int32), x.shape[-1],
                            cfg.rope_theta)
    return apply_rope(x, cos[None, :, None, :], sin[None, :, None, :])


def _sliding_causal_mask(T: int, window: int) -> jax.Array:
    """(T, T) bool mask: query i attends to j iff 0 <= i - j < window
    (transformers' sliding_window_overlay semantics)."""
    i = jnp.arange(T)[:, None]
    j = jnp.arange(T)[None, :]
    return (j <= i) & (i - j < window)


def pre_transformer(p: Params, x: jax.Array, cfg: VocoderConfig) -> jax.Array:
    """x: (B, T, H) fp32 -> (B, T, H). Stacked-layer scan."""
    B, T, H = x.shape
    Hh, Dh = cfg.num_attention_heads, cfg.head_dim
    mask = _sliding_causal_mask(T, cfg.sliding_window)
    scale = Dh ** -0.5
    eps = cfg.rms_norm_eps

    def layer(h, lp):
        r = h
        hn = rms_norm(h, lp["input_ln"], eps)
        q = (hn @ lp["q_proj"]).reshape(B, T, Hh, Dh)
        k = (hn @ lp["k_proj"]).reshape(B, T, Hh, Dh)
        v = (hn @ lp["v_proj"]).reshape(B, T, Hh, Dh)
        q, k = _rope(q, cfg), _rope(k, cfg)
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                            preferred_element_type=jnp.float32) * scale
        logits = jnp.where(mask[None, None], logits, -jnp.inf)
        attn = jax.nn.softmax(logits, axis=-1)
        o = jnp.einsum("bhqk,bkhd->bqhd", attn, v,
                       preferred_element_type=jnp.float32)
        o = o.reshape(B, T, H) @ lp["o_proj"]
        h = r + lp["attn_scale"] * o
        r = h
        hn = rms_norm(h, lp["post_ln"], eps)
        m = (jax.nn.silu(hn @ lp["gate_proj"]) * (hn @ lp["up_proj"])) \
            @ lp["down_proj"]
        h = r + lp["mlp_scale"] * m
        return h, None

    x, _ = jax.lax.scan(layer, x, p["layers"])
    return rms_norm(x, p["norm"], eps)


# ---------------------------------------------------------------------------
# ConvNeXt upsampling stage + waveform decoder blocks
# ---------------------------------------------------------------------------

def convnext_block(p: Params, x: jax.Array) -> jax.Array:
    """x: (B, T, C). Causal depthwise k7, LN(eps 1e-6), pw MLP with exact
    GELU, gamma scale, residual."""
    r = x
    C = x.shape[-1]
    h = causal_conv1d(x, p["cn_dw_w"], p["cn_dw_b"], groups=C)
    h = layer_norm(h, p["cn_ln_w"], p["cn_ln_b"], 1e-6)
    h = jax.nn.gelu(h @ p["cn_pw1_w"] + p["cn_pw1_b"], approximate=False)
    h = h @ p["cn_pw2_w"] + p["cn_pw2_b"]
    return r + p["cn_gamma"] * h


def residual_unit(p: Params, x: jax.Array, dilation: int) -> jax.Array:
    h = snake_beta(x, p["alpha1"], p["beta1"])
    h = causal_conv1d(h, p["conv1_w"], p["conv1_b"], dilation=dilation)
    h = snake_beta(h, p["alpha2"], p["beta2"])
    h = causal_conv1d(h, p["conv2_w"], p["conv2_b"])
    return x + h


def decoder_block(p: Params, x: jax.Array, rate: int) -> jax.Array:
    h = snake_beta(x, p["alpha"], p["beta"])
    h = causal_trans_conv1d(h, p["up_w"], p["up_b"], stride=rate)
    for d_i, dil in enumerate((1, 3, 9)):
        h = residual_unit(p["res"][str(d_i)], h, dil)
    return h


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def out_len(cfg: VocoderConfig, n_tokens: int) -> int:
    """Exact sample count of a raw decode (torch-parity length)."""
    return n_tokens * cfg.total_upsample - cfg.output_crop


@fp32_precision
def decode_raw(params: Params, codes: jax.Array,
               cfg: VocoderConfig) -> jax.Array:
    """codes: (B, T, 16) int -> waveform (B, out_len(cfg, T)) float32 in
    [-1, 1]. Bit-path-faithful to the torch forward (golden-tested)."""
    codes = codes.astype(jnp.int32)
    B, T, NQ = codes.shape
    V = cfg.codebook_size

    offsets = jnp.arange(NQ, dtype=jnp.int32)[None, None, :] * V
    emb = params["code_embedding"][codes + offsets]          # (B, T, 16, H)
    x = jnp.mean(emb.astype(jnp.float32), axis=2)            # (B, T, H)

    x = pre_transformer(params["pre"], x, cfg)

    for i, f in enumerate(cfg.upsampling_ratios):
        up = params["upsample"][str(i)]
        x = causal_trans_conv1d(x, up["up_w"], up["up_b"], stride=f)
        x = convnext_block(up, x)

    x = causal_conv1d(x, params["dec_in_w"], params["dec_in_b"])
    for i, r in enumerate(cfg.upsample_rates):
        x = decoder_block(params["blocks"][str(i)], x, r)
    x = snake_beta(x, params["out_alpha"], params["out_beta"])
    x = causal_conv1d(x, params["out_w"], params["out_b"])
    return jnp.clip(x[:, :, 0], -1.0, 1.0)


def decode(params: Params, codes: jax.Array, cfg: VocoderConfig,
           key: Optional[jax.Array] = None) -> jax.Array:
    """codes: (B, T, 16) -> (B, T*1920) float32: raw decode zero-padded to
    the reference wrapper's advertised length (export_vocoder_traced.py:
    46-52 reports lengths = T * total_upsample). ``key`` is accepted for
    API stability and ignored — the decoder is deterministic."""
    wav = decode_raw(params, codes, cfg)
    pad = codes.shape[1] * cfg.total_upsample - wav.shape[1]
    if pad > 0:
        wav = jnp.pad(wav, ((0, 0), (0, pad)))
    return wav


# ---------------------------------------------------------------------------
# Parameter init (random; real weights come via io/weights.py loaders)
# ---------------------------------------------------------------------------

def init_vocoder_params(key: jax.Array, cfg: VocoderConfig) -> Params:
    """Random init with the exact tensor shapes of the torch module (in our
    JAX layouts). All float32 — FP32-only module."""
    ks = iter(jax.random.split(key, 512))

    def w(shape, fan_in=None):
        fan = fan_in if fan_in is not None else int(np.prod(shape[:-1]))
        s = 1.0 / math.sqrt(max(fan, 1))
        return jax.random.uniform(next(ks), shape, jnp.float32, -s, s)

    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers

    layers = {
        "input_ln": jnp.ones((L, H)), "post_ln": jnp.ones((L, H)),
        "q_proj": w((L, H, H)), "k_proj": w((L, H, H)),
        "v_proj": w((L, H, H)), "o_proj": w((L, H, H)),
        "gate_proj": w((L, H, I)), "up_proj": w((L, H, I)),
        "down_proj": w((L, I, H)),
        "attn_scale": jnp.full((L, H), cfg.layer_scale_initial_scale),
        "mlp_scale": jnp.full((L, H), cfg.layer_scale_initial_scale),
    }
    p: Params = {
        "code_embedding": w((cfg.num_codebooks * cfg.codebook_size, H),
                            fan_in=H),
        "pre": {"layers": layers, "norm": jnp.ones((H,))},
        "upsample": {},
    }
    for i, f in enumerate(cfg.upsampling_ratios):
        p["upsample"][str(i)] = {
            "up_w": w((f, H, H)), "up_b": jnp.zeros((H,)),
            "cn_dw_w": w((7, 1, H)), "cn_dw_b": jnp.zeros((H,)),
            "cn_ln_w": jnp.ones((H,)), "cn_ln_b": jnp.zeros((H,)),
            "cn_pw1_w": w((H, 4 * H)), "cn_pw1_b": jnp.zeros((4 * H,)),
            "cn_pw2_w": w((4 * H, H)), "cn_pw2_b": jnp.zeros((H,)),
            "cn_gamma": jnp.full((H,), 1e-6),
        }
    D = cfg.decoder_dim
    p["dec_in_w"] = w((7, H, D))
    p["dec_in_b"] = jnp.zeros((D,))
    p["blocks"] = {}
    cin = D
    for i, r in enumerate(cfg.upsample_rates):
        cout = D // (2 ** (i + 1))
        blk = {
            "alpha": jnp.zeros((cin,)), "beta": jnp.zeros((cin,)),
            "up_w": w((2 * r, cin, cout)), "up_b": jnp.zeros((cout,)),
            "res": {},
        }
        for d_i in range(3):
            blk["res"][str(d_i)] = {
                "alpha1": jnp.zeros((cout,)), "beta1": jnp.zeros((cout,)),
                "conv1_w": w((7, cout, cout)), "conv1_b": jnp.zeros((cout,)),
                "alpha2": jnp.zeros((cout,)), "beta2": jnp.zeros((cout,)),
                "conv2_w": w((1, cout, cout)), "conv2_b": jnp.zeros((cout,)),
            }
        p["blocks"][str(i)] = blk
        cin = cout
    p["out_alpha"] = jnp.zeros((cin,))
    p["out_beta"] = jnp.zeros((cin,))
    p["out_w"] = w((7, cin, 1))
    p["out_b"] = jnp.zeros((1,))
    return p


# ---------------------------------------------------------------------------
# Chunked synthesis
# ---------------------------------------------------------------------------

# fixed-shape vocoder window buckets shared by the engine and the batcher
# (each distinct width is one compiled program)
VOC_BUCKETS = (64, 128, 192, 256, 320)


def voc_bucket(w: int) -> int:
    """Smallest vocoder-window bucket >= w (64-aligned beyond the table)."""
    for b in VOC_BUCKETS:
        if w <= b:
            return b
    return -(-w // 64) * 64


def pad_codes(codes, W: int):
    """Slice-or-zero-pad a (..., T, 16) codes array to a static W-token
    window along the token axis. The single device-side padding
    implementation behind every chained vocoder dispatch (engine
    ``_voc_pad``, batcher ``_voc_slot``) — the zero rows past the true
    count are the bucketed decode's lookahead contract."""
    T = codes.shape[-2]
    if W <= T:
        return codes[..., :W, :]
    pad = jnp.zeros(codes.shape[:-2] + (W - T, codes.shape[-1]),
                    codes.dtype)
    return jnp.concatenate([codes, pad], axis=-2)


def synthesize_exact(decode_fn, codes: np.ndarray,
                     max_single: int = 256) -> np.ndarray:
    """The high-quality decode used by every serving tier: utterances up
    to ``max_single`` tokens decode in ONE bucketed invocation (full
    attention context, no chunk boundaries; the bucket is strictly larger
    than the token count so the tail token always has >= 1 zero-code
    lookahead token — same property as the chunked path's final window);
    longer utterances fall back to conv-exact left-context chunking.

    ``decode_fn`` takes (1, W, 16) int32 for any bucketed W and returns
    (1, W*1920) samples (float32 or device-converted int16). NOTE: the
    n == 0 early-exit below returns an empty FLOAT32 array regardless of
    decode_fn's dtype — callers mixing dtypes must normalize (both
    serving tiers do: engine via voc.to_int16, batcher special-cases
    n == 0)."""
    n = len(codes)
    if n == 0:
        return np.zeros((0,), np.float32)
    if n <= max_single:
        W = voc_bucket(n + 1)
        buf = np.zeros((1, W, 16), np.int32)
        buf[0, :n] = codes[:, :16]
        return np.asarray(decode_fn(buf))[0][:n * SAMPLES_PER_TOKEN]
    return synthesize_chunked_context(decode_fn, codes, VOC_CHUNK_SIZE)


def synthesize_chunked_context(
    decode_fn,
    codes: np.ndarray,          # (T, 16) host array
    chunk_tokens: int = VOC_CHUNK_SIZE,
    context_tokens: int = 25,   # torch chunked_decode default left context
) -> np.ndarray:
    """Left-context + one-token-lookahead chunking (the high-quality path).

    ``decode_fn`` is a jitted fixed-shape decoder taking
    (1, context_tokens + chunk_tokens + 1, 16) int32 and returning
    (1, (context+chunk+1)*1920) samples (float32 or device-converted
    int16 — the assembly is dtype-agnostic). Each chunk
    re-decodes ``context_tokens`` of left context (discarded) and one token
    of lookahead. The one-token lookahead makes the conv stack's
    contribution exact against a full decode (its only lookahead is the
    transposed-conv crop, under one token); left context truncates the
    sliding-window attention's receptive field, a ~1e-5 approximation at
    the torch ``chunked_decode``'s own default (context 25 < window 72 —
    the official chunker has the same property). With ``context_tokens``
    >= sequence length the output is sample-exact. The final
    ``cfg.output_crop`` samples of the utterance decode the buffer's padded
    zero-codes as lookahead (finite and continuous). All chunks are
    dispatched before any is fetched so device work pipelines with host
    assembly."""
    n_tokens = len(codes)
    spt = SAMPLES_PER_TOKEN
    # bucket the window width: decode_fn's contract is "any bucketed W"
    # (synthesize_exact docstring), and the raw ctx+chunk+1 (90 at the
    # defaults) is not a bucket — a caller keying compiled programs by
    # VOC_BUCKETS would reject it, and a jitted fn pays a one-off
    # width-90 compile mid-request. The extra rows are zero-code
    # lookahead past la_end; the kept samples are positional
    # ([ctx*spt : (ctx+m)*spt]) and causal, so they are unchanged
    # (review finding).
    W = voc_bucket(context_tokens + chunk_tokens + 1)

    jobs = []
    for cs in range(0, n_tokens, chunk_tokens):
        ce = min(cs + chunk_tokens, n_tokens)
        ctx = min(context_tokens, cs)
        la_end = min(ce + 1, n_tokens)           # one token of lookahead
        buf = np.zeros((1, W, 16), np.int32)
        seg = codes[cs - ctx:la_end, :16]
        buf[0, :len(seg)] = seg
        jobs.append((decode_fn(buf), ctx, ce - cs))

    parts = []
    for fut, ctx, m in jobs:
        wav = np.asarray(fut)[0]
        parts.append(wav[ctx * spt:(ctx + m) * spt])
    return np.concatenate(parts) if parts else np.zeros(0, np.float32)


def synthesize_chunked(
    decode_fn,
    codes: np.ndarray,          # (T, 16) host array
    max_tokens: int = VOC_CHUNK_SIZE,
    overlap: int = VOC_OVERLAP,
) -> np.ndarray:
    """Port of the reference multi-chunk overlap-crossfade
    (dual_npu/vocoder_server.py:73-121), kept for wire-parity with the
    compat vocoder server. ``decode_fn`` takes (1, max_tokens, 16) int32
    and returns (1, max_tokens*1920) float32. Single chunk: zero-pad,
    decode, trim. Multi-chunk: advance by ``max_tokens - overlap``; linear
    fade-out/fade-in blend over the overlap region.

    WARNING — wire-parity includes a reference defect: when the final
    chunk is shorter than ``overlap`` (n_tokens mod step in
    [1, overlap-1]) its audio is appended raw (vocoder_server.py:109-117
    does the same), duplicating up to overlap-1 tokens of already-emitted
    tail audio. Every first-party path uses ``synthesize_exact`` /
    ``synthesize_chunked_context`` instead; use this ONLY where
    byte-parity with the reference's vocoder server is the contract
    (serve/compat.py)."""
    n_tokens = len(codes)
    spt = SAMPLES_PER_TOKEN

    def dispatch(chunk: np.ndarray):
        c = np.zeros((1, max_tokens, 16), np.int32)
        c[0, :len(chunk), :] = chunk[:, :16]
        return decode_fn(c), len(chunk)  # async device value

    if n_tokens <= max_tokens:
        fut, m = dispatch(codes)
        return np.asarray(fut)[0][:m * spt]

    step = max_tokens - overlap
    ov_samples = overlap * spt
    fade_out = np.linspace(1.0, 0.0, ov_samples, dtype=np.float32)
    fade_in = 1.0 - fade_out

    # dispatch every chunk before fetching any: jitted calls are async, so
    # the per-invocation dispatch latency pipelines instead of
    # serializing.
    futs = [dispatch(codes[cs:min(cs + max_tokens, n_tokens)])
            for cs in range(0, n_tokens, step)]

    result = np.array([], dtype=np.float32)
    for i, (fut, m) in enumerate(futs):
        audio_chunk = np.asarray(fut)[0][:m * spt]
        if i == 0:
            result = audio_chunk
        elif len(result) >= ov_samples and len(audio_chunk) >= ov_samples:
            blended = (result[-ov_samples:] * fade_out
                       + audio_chunk[:ov_samples] * fade_in)
            result = np.concatenate(
                [result[:-ov_samples], blended, audio_chunk[ov_samples:]])
        else:
            result = np.concatenate([result, audio_chunk])
    return result


def to_int16_device(audio):
    """On-device analog of to_int16: clip+scale inside the jitted vocoder
    program so every audio d2h transfer moves int16, not float32 (half
    the bytes; engine and batcher share this)."""
    return jnp.clip(audio * 32767.0, -32768.0, 32767.0).astype(jnp.int16)


def to_int16(audio: np.ndarray) -> np.ndarray:
    """float [-1,1] -> int16 with the reference's clip (vocoder_server.py:175).
    int16 input passes through (engine chunk programs convert on device)."""
    if audio.dtype == np.int16:
        return audio
    return np.clip(audio * 32767, -32768, 32767).astype(np.int16)
