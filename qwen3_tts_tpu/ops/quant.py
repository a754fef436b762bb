"""Weight-only int8 quantization for the talker / code-predictor matmuls.

The reference deploys quantized transformer weights (talker GGUF Q4_K_M,
code predictor GGML Q4_0 — its fastest CP backend, README.md:82-90) and
keeps the vocoder FP32. Here: symmetric per-output-channel int8 weights,
half the bf16 bytes — small-batch decode is bound by weight bytes, so
fewer bytes can mean a shorter step.

The vocoder is never quantized (README.md:56-64: every quantized vocoder
variant fails audibly).
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp


@jax.tree_util.register_pytree_node_class
class QTensor:
    """Symmetric per-out-channel int8 weight: w ≈ q * scale.

    q: int8, shape (..., K, N); scale: float32, shape (..., N) — scales
    broadcast over the contraction (K) dim; leading dims are layer stacks.
    """

    __slots__ = ("q", "scale")

    def __init__(self, q: jax.Array, scale: jax.Array):
        self.q = q
        self.scale = scale

    def tree_flatten(self):
        return (self.q, self.scale), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def __getitem__(self, idx):
        """Index leading (layer/group) dims; scales share those dims."""
        return QTensor(self.q[idx], self.scale[idx])

    def __repr__(self):
        return f"QTensor(int8 {self.q.shape}, scale {self.scale.shape})"


def quantize_int8(w: jax.Array) -> QTensor:
    """Quantize (..., K, N) weights to int8 with per-(..., N) scales."""
    wf = w.astype(jnp.float32)
    amax = jnp.max(jnp.abs(wf), axis=-2)  # (..., N)
    scale = jnp.where(amax > 0, amax / 127.0, 1.0)
    q = jnp.clip(jnp.round(wf / scale[..., None, :]), -127, 127).astype(jnp.int8)
    return QTensor(q, scale.astype(jnp.float32))


def dequantize(w: QTensor, dtype=jnp.bfloat16) -> jax.Array:
    return (w.q.astype(jnp.float32) * w.scale[..., None, :]).astype(dtype)


MaybeQuant = Union[jax.Array, QTensor]


def matmul(x: jax.Array, w: MaybeQuant) -> jax.Array:
    """x @ w with quant-aware dispatch. Always accumulates in float32.

    x: (..., K); w: (K, N) dense or QTensor. Returns float32 (callers cast).
    The int8 operand feeds the dot through a convert to bf16 and the
    per-channel scale applies to the float32 result.
    """
    if not isinstance(w, QTensor):
        return jnp.dot(x, w, preferred_element_type=jnp.float32)
    out = jnp.dot(x.astype(jnp.bfloat16), w.q.astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    return out * w.scale


def quantize_layer_stack(layers: dict, fuse: bool = False) -> dict:
    """Quantize the seven projection matrices of a stacked layer pytree;
    norms stay dense.

    ``fuse=True`` additionally stores concatenated qkv / gate+up weights
    ("qkv_proj", "gateup_proj"): q/k/v and gate/up share their input, so
    one int8 matmul covers what would be 3 (resp. 2) — same bytes, fewer
    fixed costs per decode step. Per-channel scales concatenate losslessly
    along the output axis."""
    out = dict(layers)
    # with fuse=True the five input-sharing projections are only ever read
    # through their fused concats — quantizing them individually would be
    # five abs-max/round passes over never-read results (review finding)
    solo = (("o_proj", "down_proj") if fuse else
            ("q_proj", "k_proj", "v_proj", "o_proj",
             "gate_proj", "up_proj", "down_proj"))
    for name in solo:
        out[name] = quantize_int8(layers[name])
    if fuse:
        qkv = jnp.concatenate(
            [layers["q_proj"], layers["k_proj"], layers["v_proj"]], axis=-1)
        gu = jnp.concatenate(
            [layers["gate_proj"], layers["up_proj"]], axis=-1)
        out["qkv_proj"] = quantize_int8(qkv)
        out["gateup_proj"] = quantize_int8(gu)
        # the separate projections are dead once fused variants exist
        # (_qkv / swiglu_mlp prefer the fused weights)
        for name in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
            del out[name]
    return out


def attach_layer_list(component: dict) -> dict:
    """Attach the per-layer (unstacked) weight list the decode hot paths
    use: a lax.scan over the stacked pytree can materialize a copy of each
    layer's weights every step before the matmuls read them; separate
    arrays avoid the slice entirely. Only the decode paths use these;
    prefill scans the stack.

    Idempotent; jit it (un-jitted, the per-layer slicing is ~L x 9 small
    dispatches)."""
    if "layers_list" in component:
        return component
    out = dict(component)
    L = component["layers"]["input_ln"].shape[0]
    out["layers_list"] = [
        {k: v[l] for k, v in component["layers"].items()} for l in range(L)]
    return out


def is_quantized(component: dict) -> bool:
    """True if the component's layer stack holds QTensor weights (a
    pre-quantized checkpoint from convert_weights.py --quantize, or a
    runtime-quantized param tree)."""
    return any(isinstance(v, QTensor)
               for v in component.get("layers", {}).values())


def quantize_talker(params: dict) -> dict:
    out = dict(params)
    out["layers"] = quantize_layer_stack(params["layers"], fuse=True)
    out["codec_head"] = quantize_int8(params["codec_head"])
    # text projection / embeddings stay dense: used in prefill only
    return attach_layer_list(out)


def quantize_code_predictor(params: dict) -> dict:
    out = dict(params)
    out["layers"] = quantize_layer_stack(params["layers"])
    out["lm_heads"] = quantize_int8(params["lm_heads"])
    return attach_layer_list(out)


def dequantize_talker(params: dict, dtype=jnp.bfloat16) -> dict:
    """Inverse of quantize_talker: rebuild the standard dense layout
    (separate q/k/v and gate/up projections) from the fused-int8 one.

    The batched serving tier wants a bf16 talker — batching amortizes the
    weight bytes int8 saves, and the fused layout has no mesh sharding
    specs — so a pre-quantized engine-mode
    artifact (convert_weights.py --quantize int8) is dequantized on the
    way into ContinuousBatcher. Values equal what the int8 engine
    computes with (q * scale), not the original bf16 checkpoint."""
    layers = dict(params["layers"])
    qkv = dequantize(layers.pop("qkv_proj"), dtype)      # (L, H, QD+2KVD)
    gu = dequantize(layers.pop("gateup_proj"), dtype)    # (L, H, 2I)
    o = layers["o_proj"]
    QD = o.q.shape[1] if isinstance(o, QTensor) else o.shape[1]
    KVD = (qkv.shape[-1] - QD) // 2
    layers["q_proj"] = qkv[..., :QD]
    layers["k_proj"] = qkv[..., QD:QD + KVD]
    layers["v_proj"] = qkv[..., QD + KVD:]
    I = gu.shape[-1] // 2
    layers["gate_proj"] = gu[..., :I]
    layers["up_proj"] = gu[..., I:]
    for name in ("o_proj", "down_proj"):
        if isinstance(layers[name], QTensor):
            layers[name] = dequantize(layers[name], dtype)
    out = dict(params)
    out.pop("layers_list", None)
    out["layers"] = layers
    if isinstance(out.get("codec_head"), QTensor):
        out["codec_head"] = dequantize(out["codec_head"], dtype)
    return out
