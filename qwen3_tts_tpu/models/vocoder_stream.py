"""Incremental (stateful) streaming vocoder: O(new tokens) per emission.

The chunked paths in ``models/vocoder.py`` re-decode a full-left-context
window per streamed emission — per-window cost O(end), total ~2-3x a full
decode at the 200-token cap and ~quadratic for long paged streams.  This
module carries the decoder's *state* across emissions instead, so each
streamed chunk costs O(new tokens) regardless of position, while staying
sample-exact against ``vocoder.decode_raw`` up to GEMM reassociation
(float <= 1e-6 absolute; wire int16 NEVER more than +-1 LSB off — XLA
reassociates dot reductions across operand shapes, so attention over
[KV-window + chunk] keys differs from the full-sequence forward at
~1e-9 in the final audio; the conv path alone is bitwise on the CPU.
Every matmul and conv runs at full float32 precision
(``vocoder.fp32_precision``); < 0.01% of samples differ on the CPU,
sub-quantization noise. Contract asserted in
tests/test_vocoder_stream.py):

- **pre-transformer**: a rolling per-layer KV window of the last
  ``sliding_window - 1`` frames (rotated keys at absolute positions).
  Sliding-window causal attention depends on exactly those frames, so the
  incremental forward reproduces the full forward exactly — unlike
  re-decoding from truncated raw inputs, whose receptive field compounds
  across layers (the ~1e-5 approximation vocoder.py documents).
- **causal convs** (stride 1): the last ``(k-1)*dilation`` input frames.
  Zero-initialised tails reproduce the full decode's left zero-padding.
- **causal transposed convs** in the waveform decoder (k=2r, s=r,
  crop=r): output frame j needs input frames j//r and j//r+1, i.e. ONE
  frame of input lookahead — the stream holds the last input frame back
  and prepends it to the next chunk.  The 2x ConvNeXt upconvs (k=s=2,
  crop=0) are frame-pointwise and need no state.

The held-back frames give the stream a constant internal lag of exactly
``cfg.output_crop`` samples (555 at the deployed geometry): a *prime*
step over the first ``c`` frames emits ``c*1920 - 555`` samples, every
later step emits ``c*1920``.  A final step reading zero codes past the
utterance end flushes the lag — the same zero-code lookahead contract as
``synthesize_exact``'s bucket padding, so the flushed samples equal the
full decode's.

Numerical contract: the reference streams disjoint zero-context chunks
(vocoder_server.py:83-121 overlap-crossfade); this repo's bar is
sample-exactness against its own non-streaming decode (docs/PARITY.md),
which this module meets with O(1) per-emission work.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from qwen3_tts_tpu.config import VocoderConfig
from qwen3_tts_tpu.models import vocoder as voc
from qwen3_tts_tpu.models.transformer import apply_rope, rope_cos_sin

Params = Dict[str, jax.Array]
State = Dict[str, jax.Array]


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def init_stream_state(cfg: VocoderConfig, batch: int = 1) -> State:
    """Zero state for a new stream. Zero conv tails reproduce the full
    decode's causal left zero-padding bit-for-bit; the KV window starts
    empty (masked invalid via ``pos``); transposed-conv hold-backs are
    unused until the stream is primed."""
    H = cfg.hidden_size
    L = cfg.num_hidden_layers
    Hh, Dh = cfg.num_attention_heads, cfg.head_dim
    Wc = cfg.sliding_window - 1
    D = cfg.decoder_dim
    z = lambda *s: jnp.zeros(s, jnp.float32)

    state: State = {
        "pos": jnp.int32(0),
        # rotated K and V of the last Wc frames, per layer
        "pre_kv": z(L, 2, batch, Wc, Hh, Dh),
        "up": {str(i): {"dw_tail": z(batch, 6, H)}
               for i in range(len(cfg.upsampling_ratios))},
        "dec_in_tail": z(batch, 6, H),
        "blocks": {},
    }
    cin = D
    for i, _r in enumerate(cfg.upsample_rates):
        cout = D // (2 ** (i + 1))
        state["blocks"][str(i)] = {
            "held": z(batch, 1, cin),
            "res": {str(d_i): {"t1": z(batch, 6 * dil, cout),
                               }
                    for d_i, dil in enumerate((1, 3, 9))},
        }
        cin = cout
    state["out_tail"] = z(batch, 6, cin)
    return state


# ---------------------------------------------------------------------------
# Streaming primitives
# ---------------------------------------------------------------------------

def _conv_stream(x: jax.Array, tail: jax.Array, w: jax.Array, b: jax.Array,
                 *, dilation: int = 1,
                 groups: int = 1) -> Tuple[jax.Array, jax.Array]:
    """Stride-1 causal conv continuation: conv over [tail, x] with VALID
    padding — identical dot products to the full causal conv's outputs at
    these positions (same kernel-size reductions). tail: (B, (k-1)*d, C)."""
    k = w.shape[0]
    if k == 1:
        return voc.conv1d(x, w, b, padding="VALID", groups=groups), tail
    inp = jnp.concatenate([tail, x], axis=1)
    out = jax.lax.conv_general_dilated(
        inp, w, window_strides=(1,), padding=[(0, 0)],
        rhs_dilation=(dilation,), feature_group_count=groups,
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,
    ) + b[None, None, :]
    return out, inp[:, -(k - 1) * dilation:]


def _trans_conv_stream(x: jax.Array, held: jax.Array, w: jax.Array,
                       b: jax.Array, *, stride: int,
                       primed: bool) -> Tuple[jax.Array, jax.Array]:
    """Causal transposed conv continuation (k=2r, s=r, crop=r): with the
    previous chunk's last input frame prepended, the same
    ``causal_trans_conv1d`` program emits exactly the next m*r output
    frames. Unprimed (first chunk): no frame to prepend — emits
    (m-1)*r, holding the last frame back."""
    inp = jnp.concatenate([held, x], axis=1) if primed else x
    out = voc.causal_trans_conv1d(inp, w, b, stride=stride)
    return out, inp[:, -1:]


def _pre_transformer_stream(p: Params, x: jax.Array, kv: jax.Array,
                            pos: jax.Array,
                            cfg: VocoderConfig) -> Tuple[jax.Array, jax.Array]:
    """Incremental sliding-window attention. x: (B, c, H) new frames at
    absolute positions [pos, pos+c); kv: (L, 2, B, Wc, Hh, Dh) rotated
    keys/values of frames [pos-Wc, pos) (slots below absolute 0 invalid).
    Exact: each query attends to precisely the window the full forward's
    mask admits, with keys in the same order."""
    B, c, H = x.shape
    Hh, Dh = cfg.num_attention_heads, cfg.head_dim
    Wc = cfg.sliding_window - 1
    scale = Dh ** -0.5
    eps = cfg.rms_norm_eps

    qpos = pos + jnp.arange(c, dtype=jnp.int32)              # (c,)
    kpos = jnp.concatenate(
        [pos - Wc + jnp.arange(Wc, dtype=jnp.int32), qpos])  # (Wc+c,)
    # window semantics of vocoder._sliding_causal_mask: 0 <= i-j < window
    mask = ((kpos[None, :] >= 0) & (kpos[None, :] <= qpos[:, None])
            & (qpos[:, None] - kpos[None, :] < cfg.sliding_window))
    cos_q, sin_q = rope_cos_sin(qpos, Dh, cfg.rope_theta)

    def layer(h, lp_kv):
        lp, kv_l = lp_kv
        r = h
        hn = voc.rms_norm(h, lp["input_ln"], eps)
        q = (hn @ lp["q_proj"]).reshape(B, c, Hh, Dh)
        k = (hn @ lp["k_proj"]).reshape(B, c, Hh, Dh)
        v = (hn @ lp["v_proj"]).reshape(B, c, Hh, Dh)
        q = apply_rope(q, cos_q[None, :, None, :], sin_q[None, :, None, :])
        k = apply_rope(k, cos_q[None, :, None, :], sin_q[None, :, None, :])
        k_all = jnp.concatenate([kv_l[0], k], axis=1)        # (B, Wc+c, ...)
        v_all = jnp.concatenate([kv_l[1], v], axis=1)
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, k_all,
                            preferred_element_type=jnp.float32) * scale
        logits = jnp.where(mask[None, None], logits, -jnp.inf)
        attn = jax.nn.softmax(logits, axis=-1)
        o = jnp.einsum("bhqk,bkhd->bqhd", attn, v_all,
                       preferred_element_type=jnp.float32)
        o = o.reshape(B, c, H) @ lp["o_proj"]
        h = r + lp["attn_scale"] * o
        r = h
        hn = voc.rms_norm(h, lp["post_ln"], eps)
        m = (jax.nn.silu(hn @ lp["gate_proj"]) * (hn @ lp["up_proj"])) \
            @ lp["down_proj"]
        h = r + lp["mlp_scale"] * m
        new_kv = jnp.stack([k_all[:, -Wc:], v_all[:, -Wc:]])
        return h, new_kv

    x, new_kv = jax.lax.scan(layer, x, (p["layers"], kv))
    return voc.rms_norm(x, p["norm"], eps), new_kv


# ---------------------------------------------------------------------------
# The streaming step
# ---------------------------------------------------------------------------

@voc.fp32_precision
def stream_step(params: Params, state: State, codes: jax.Array,
                cfg: VocoderConfig, *,
                primed: bool) -> Tuple[jax.Array, State]:
    """Advance the stream by ``codes`` (B, c, 16) int frames.

    Returns (audio, new_state) where audio is (B, c*total_upsample) when
    ``primed`` and (B, c*total_upsample - output_crop) on the first
    (unprimed) call — the constant hold-back lag.  Feed one chunk of
    zero codes after the last real frame to flush the lag (zero-code
    lookahead, the ``synthesize_exact`` contract); trim the concatenated
    stream to n_real * total_upsample samples."""
    codes = codes.astype(jnp.int32)
    B, c, NQ = codes.shape
    V = cfg.codebook_size
    ns = dict(state)

    offsets = jnp.arange(NQ, dtype=jnp.int32)[None, None, :] * V
    emb = params["code_embedding"][codes + offsets]
    x = jnp.mean(emb.astype(jnp.float32), axis=2)

    x, ns["pre_kv"] = _pre_transformer_stream(
        params["pre"], x, state["pre_kv"], state["pos"], cfg)
    ns["pos"] = state["pos"] + c

    ns["up"] = {}
    for i, f in enumerate(cfg.upsampling_ratios):
        up = params["upsample"][str(i)]
        # k=s=f=2, crop 0: frame-pointwise, stateless
        x = voc.causal_trans_conv1d(x, up["up_w"], up["up_b"], stride=f)
        r = x
        C = x.shape[-1]
        h, dw_tail = _conv_stream(x, state["up"][str(i)]["dw_tail"],
                                  up["cn_dw_w"], up["cn_dw_b"], groups=C)
        h = voc.layer_norm(h, up["cn_ln_w"], up["cn_ln_b"], 1e-6)
        h = jax.nn.gelu(h @ up["cn_pw1_w"] + up["cn_pw1_b"],
                        approximate=False)
        h = h @ up["cn_pw2_w"] + up["cn_pw2_b"]
        x = r + up["cn_gamma"] * h
        ns["up"][str(i)] = {"dw_tail": dw_tail}

    x, ns["dec_in_tail"] = _conv_stream(x, state["dec_in_tail"],
                                        params["dec_in_w"],
                                        params["dec_in_b"])

    ns["blocks"] = {}
    for i, rate in enumerate(cfg.upsample_rates):
        bp = params["blocks"][str(i)]
        bs = state["blocks"][str(i)]
        nbs: State = {"res": {}}
        h = voc.snake_beta(x, bp["alpha"], bp["beta"])
        h, nbs["held"] = _trans_conv_stream(h, bs["held"], bp["up_w"],
                                            bp["up_b"], stride=rate,
                                            primed=primed)
        for d_i, dil in enumerate((1, 3, 9)):
            rp = bp["res"][str(d_i)]
            rs = bs["res"][str(d_i)]
            u = voc.snake_beta(h, rp["alpha1"], rp["beta1"])
            u, t1 = _conv_stream(u, rs["t1"], rp["conv1_w"], rp["conv1_b"],
                                 dilation=dil)
            u = voc.snake_beta(u, rp["alpha2"], rp["beta2"])
            u, _ = _conv_stream(u, u[:, :0], rp["conv2_w"], rp["conv2_b"])
            h = h + u
            nbs["res"][str(d_i)] = {"t1": t1}
        x = h
        ns["blocks"][str(i)] = nbs

    x = voc.snake_beta(x, params["out_alpha"], params["out_beta"])
    x, ns["out_tail"] = _conv_stream(x, state["out_tail"],
                                     params["out_w"], params["out_b"])
    return jnp.clip(x[:, :, 0], -1.0, 1.0), ns


# ---------------------------------------------------------------------------
# Shared serving-tier step programs
# ---------------------------------------------------------------------------

class StreamStepper:
    """Jitted fixed-size incremental-stream steps, shared by the serving
    tiers (the batcher's streaming emissions and, since r5, the engine's
    streaming path — VERDICT r4 #8 unification).

    Arbitrary emission extents decompose into ``SIZES`` quanta so one
    process compiles at most ``len(SIZES) * 2`` step programs per
    geometry. Each step slices ``c`` code frames from a slot's codes row
    at a runtime ``start`` (the row is zero-extended first, so a flush
    step may read past the utterance end — the zero-code lookahead
    contract of ``synthesize_exact``), advances the stream state, and
    returns int16 samples (converted ON DEVICE — halves the d2h)."""

    SIZES = (64, 32, 16, 8)

    def __init__(self, cfg_v: VocoderConfig):
        self.cfg = cfg_v
        self._fns = {}

    def step_fn(self, c: int, primed: bool):
        key = (c, primed)
        fn = self._fns.get(key)
        if fn is None:
            cfg_v = self.cfg
            pad = max(self.SIZES)

            def step(vp, codes_row, start, st):
                padded = jnp.concatenate(
                    [codes_row.astype(jnp.int32),
                     jnp.zeros((pad, codes_row.shape[-1]), jnp.int32)])
                chunk = jax.lax.dynamic_slice_in_dim(padded, start, c,
                                                     axis=0)[None]
                audio, st2 = stream_step(vp, st, chunk, cfg_v,
                                         primed=primed)
                return voc.to_int16_device(audio), st2

            fn = self._fns[key] = jax.jit(step)
        return fn

    def plan_quanta(self, n_frames: int, overshoot: bool):
        """Quanta covering ``n_frames``: with ``overshoot`` the last
        quantum may read past the end (zero rows — used for the final
        flush of a finished utterance); without it the sub-quantum
        remainder is deferred until more frames are final."""
        plan = []
        if overshoot:
            need = n_frames
            while need > 0:
                s = min((s for s in self.SIZES if s >= need),
                        default=max(self.SIZES))
                plan.append(s)
                need -= s
        else:
            avail = n_frames
            floor = min(self.SIZES)
            while avail >= floor:
                s = max(s for s in self.SIZES if s <= avail)
                plan.append(s)
                avail -= s
        return plan
