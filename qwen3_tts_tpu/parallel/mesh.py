"""Device mesh + sharding rules for multi-chip serving.

The reference is a single-device, single-request system (SURVEY §2,
parallelism table). This build adds first-class data/tensor parallelism
for the daemon-serving config: requests are batch-sharded over ``dp`` and
the talker/CP weights are Megatron-style tensor-sharded over ``tp``; the
per-step collectives (an all-reduce after o_proj and down_proj) are
inserted by XLA from the shardings and run over the cards' links. The
mesh is a plain dp x tp grid: every card reaches every other at the
same rate, so nothing in it follows a physical topology.

Everything is expressed as ``PartitionSpec`` trees consumed by ``jax.jit``
``in_shardings`` — no hand-written collectives; GSPMD propagates.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from qwen3_tts_tpu.config import TTSConfig

DP, TP = "dp", "tp"


def make_mesh(dp: int, tp: int,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devs = list(devices) if devices is not None else jax.devices()
    if len(devs) < dp * tp:
        raise ValueError(f"need {dp * tp} devices, have {len(devs)}")
    grid = np.asarray(devs[: dp * tp]).reshape(dp, tp)
    return Mesh(grid, (DP, TP))


# ---------------------------------------------------------------------------
# Parameter shardings
# ---------------------------------------------------------------------------

def layer_stack_spec() -> Dict[str, P]:
    """Specs for the stacked transformer layer pytree (leading dim = layer).

    Column-parallel (out-dim sharded): q/k/v, gate/up.
    Row-parallel (in-dim sharded):     o_proj, down_proj.
    Norm vectors replicated.
    """
    return {
        "input_ln": P(),
        "q_proj": P(None, None, TP),
        "k_proj": P(None, None, TP),
        "v_proj": P(None, None, TP),
        "o_proj": P(None, TP, None),
        "q_norm": P(),
        "k_norm": P(),
        "post_ln": P(),
        "gate_proj": P(None, None, TP),
        "up_proj": P(None, None, TP),
        "down_proj": P(None, TP, None),
    }


def talker_param_spec() -> Dict:
    return {
        "layers": layer_stack_spec(),
        "final_norm": P(),
        "text_embedding": P(TP, None),   # vocab-sharded (1.2 GB table)
        "proj_fc1_w": P(None, TP),
        "proj_fc1_b": P(TP),
        "proj_fc2_w": P(TP, None),
        "proj_fc2_b": P(),
        "codec_embedding": P(),          # small; replicated for gathers
        "codec_head": P(None, TP),       # vocab-sharded logits
    }


def cp_param_spec() -> Dict:
    return {
        "layers": layer_stack_spec(),
        "final_norm": P(),
        "mtp_proj_w": P(None, TP),
        "mtp_proj_b": P(TP),
        "codec_embs": P(),               # gathered per sampled token
        "lm_heads": P(None, None, TP),   # per-group vocab-sharded
    }


def vocoder_param_spec(params) -> Dict:
    """Vocoder weights are small (~100 MB fp32): replicate everything."""
    return jax.tree.map(lambda _: P(), params)


def _scale_spec(p: P) -> P:
    """Spec for a QTensor's per-out-channel scales (..., N) given the
    dense weight's spec (..., K, N): drop the contraction axis."""
    parts = tuple(p)
    if len(parts) >= 2:
        return P(*(parts[:-2] + parts[-1:]))
    return P()


def adapt_spec_to_params(spec, params):
    """Adapt a dense PartitionSpec tree to a params tree that may hold
    weight-only-int8 ``QTensor`` leaves (ops/quant.py): the int8 payload
    keeps the dense weight's spec; the scales drop the contraction axis.

    Covers the non-fused int8 layouts (quantize_code_predictor, and
    quantize_layer_stack(fuse=False)). The FUSED talker layout
    (qkv/gateup concat + unstacked layers_list) stays single-device:
    batching amortizes the weight bytes int8 saves, so the mesh tier
    serves bf16 talker + optional int8 CP."""
    from qwen3_tts_tpu.ops.quant import QTensor

    if isinstance(params, QTensor):
        assert isinstance(spec, P), spec
        return QTensor(spec, _scale_spec(spec))
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k == "layers_list" and "layers" in spec:
                # per-layer (unstacked) duplicates of the stacked weights
                # (quantize_talker / quantize_code_predictor): each entry
                # gets the stacked spec minus its leading layer axis
                per = {kk: P(*tuple(sp)[1:])
                       for kk, sp in spec["layers"].items()}
                out[k] = [adapt_spec_to_params(per, lyr) for lyr in v]
                continue
            if k not in spec:
                raise KeyError(
                    f"no sharding spec for param {k!r} (fused int8 layouts "
                    "are single-chip; quantize with fuse=False for the mesh)")
            out[k] = adapt_spec_to_params(spec[k], v)
        return out
    return spec


def param_shardings(mesh: Mesh, params: Dict) -> Dict:
    """NamedShardings for the full parameter bundle (dense or int8)."""
    specs = {}
    if "talker" in params:
        specs["talker"] = adapt_spec_to_params(talker_param_spec(),
                                               params["talker"])
    if "code_predictor" in params:
        specs["code_predictor"] = adapt_spec_to_params(
            cp_param_spec(), params["code_predictor"])
    if "vocoder" in params:
        specs["vocoder"] = vocoder_param_spec(params["vocoder"])
    return jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                        is_leaf=lambda x: isinstance(x, P))


# ---------------------------------------------------------------------------
# Activation / state shardings
# ---------------------------------------------------------------------------

def kv_cache_spec() -> P:
    """(L, 2, B, S, Hkv, Dh): batch over dp, kv heads over tp."""
    return P(None, None, DP, None, TP, None)


def paged_kv_spec():
    """Specs for the block-paged KV (models/transformer.PagedKV).

    pool (L, 2, P, psz, Hkv, Dh): pages over dp (each dp group owns a
    contiguous page range — the batcher allocates per group so the
    shard_map'd paged attention never crosses dp shards), kv heads over
    tp. table/capacity ride with their batch shard."""
    from qwen3_tts_tpu.models.transformer import PagedKV
    return PagedKV(
        pool=P(None, None, DP, None, TP, None),
        table=P(DP, None),
        capacity=P(DP),
    )


def gen_state_spec(cfg: TTSConfig, paged: bool = False):
    """PartitionSpec tree matching engine.generate.GenState."""
    from qwen3_tts_tpu.engine.generate import GenState
    return GenState(
        kv=paged_kv_spec() if paged else kv_cache_spec(),
        pos=P(DP),
        hidden=P(DP, None),
        ring=P(DP, None),
        n_codes=P(DP),
        done=P(DP),
        codes=P(DP, None, None),
        n_text=P(DP),
        step=P(),
        key=P(DP, None),   # per-element keys ride with their batch shard
        budget=P(DP),
    )


def shard_params(mesh: Mesh, params: Dict) -> Dict:
    """Device-put the parameter bundle with its shardings."""
    sh = param_shardings(mesh, params)
    return jax.tree.map(jax.device_put, params, sh)
