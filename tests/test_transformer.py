"""Parity tests: JAX Qwen3 blocks vs the independent NumPy golden reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qwen3_tts_tpu.models import transformer as tfm

import np_reference as ref

GEO = tfm.TransformerGeometry(
    num_layers=3, hidden_size=64, intermediate_size=96,
    num_heads=4, num_kv_heads=2, head_dim=16,
    rms_norm_eps=1e-6, rope_theta=1_000_000.0,
)


@pytest.fixture(scope="module")
def params():
    return tfm.init_stack_params(jax.random.PRNGKey(0), GEO, jnp.float32)


def np_params(params):
    return {k: np.asarray(v) for k, v in params.items()}


def test_rms_norm_matches():
    x = np.random.default_rng(0).normal(size=(5, 64)).astype(np.float32)
    w = np.random.default_rng(1).normal(size=(64,)).astype(np.float32) + 1.0
    got = np.asarray(tfm.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    want = ref.rms_norm(x, w, 1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rope_matches():
    pos = np.array([0, 1, 5, 100])
    cj, sj = tfm.rope_cos_sin(jnp.asarray(pos), 16, 1e6)
    cn, sn = ref.rope_cos_sin(pos, 16, 1e6)
    np.testing.assert_allclose(np.asarray(cj), cn, rtol=1e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(sj), sn, rtol=1e-4, atol=2e-5)


def test_prefill_matches_numpy_full_forward(params):
    T = 7
    rng = np.random.default_rng(42)
    x = rng.normal(size=(T, 64), scale=0.5).astype(np.float32)
    positions = np.arange(T)

    geo_d = dict(num_heads=4, num_kv_heads=2, head_dim=16,
                 rms_norm_eps=1e-6, rope_theta=1e6)
    want = ref.stack_forward(np_params(params), x, positions, geo_d)

    xb = jnp.asarray(x)[None]  # B=1
    mask = tfm.causal_mask(1, T, jnp.array([T]))
    got, _ = tfm.forward_prefill(params, xb, jnp.asarray(positions)[None],
                                 mask, GEO, kv_cache=None)
    np.testing.assert_allclose(np.asarray(got[0]), want, rtol=2e-4, atol=2e-4)


def test_prefill_padding_invariance(params):
    """Padded prefill must produce the same hidden at the last real position."""
    T, PAD = 6, 11
    rng = np.random.default_rng(7)
    x = rng.normal(size=(T, 64), scale=0.5).astype(np.float32)
    xp = np.concatenate([x, rng.normal(size=(PAD - T, 64)).astype(np.float32)])

    mask_t = tfm.causal_mask(1, T, jnp.array([T]))
    got_t, _ = tfm.forward_prefill(
        params, jnp.asarray(x)[None],
        jnp.broadcast_to(jnp.arange(T), (1, T)), mask_t, GEO)

    mask_p = tfm.causal_mask(1, PAD, jnp.array([T]))
    got_p, _ = tfm.forward_prefill(
        params, jnp.asarray(xp)[None],
        jnp.broadcast_to(jnp.arange(PAD), (1, PAD)), mask_p, GEO)

    np.testing.assert_allclose(
        np.asarray(got_t[0, T - 1]), np.asarray(got_p[0, T - 1]),
        rtol=1e-5, atol=1e-5)


def test_decode_steps_match_full_forward(params):
    """Prefill P tokens then decode D more; the decode hiddens must equal a
    full-sequence forward at those positions."""
    P, D, S = 5, 4, 32
    rng = np.random.default_rng(3)
    x_all = rng.normal(size=(P + D, 64), scale=0.5).astype(np.float32)

    geo_d = dict(num_heads=4, num_kv_heads=2, head_dim=16,
                 rms_norm_eps=1e-6, rope_theta=1e6)
    want = ref.stack_forward(np_params(params), x_all, np.arange(P + D), geo_d)

    kv = tfm.init_kv_cache(GEO, 1, S)
    mask = tfm.causal_mask(1, P, jnp.array([P]))
    h, kv = tfm.forward_prefill(params, jnp.asarray(x_all[:P])[None],
                                jnp.broadcast_to(jnp.arange(P), (1, P)),
                                mask, GEO, kv_cache=kv)
    np.testing.assert_allclose(np.asarray(h[0]), want[:P], rtol=2e-4, atol=2e-4)

    for t in range(D):
        h1, kv = tfm.decode_step(params, jnp.asarray(x_all[P + t])[None],
                                 jnp.array([P + t]), kv, GEO)
        np.testing.assert_allclose(np.asarray(h1[0]), want[P + t],
                                   rtol=3e-4, atol=3e-4,
                                   err_msg=f"decode step {t}")


def test_decode_batched_positions(params):
    """Per-batch-element positions: two sequences at different depths must
    each match their own single-batch decode."""
    S = 16
    rng = np.random.default_rng(11)
    xa = rng.normal(size=(3, 64), scale=0.5).astype(np.float32)
    xb = rng.normal(size=(5, 64), scale=0.5).astype(np.float32)

    def run_single(x_seq):
        kv = tfm.init_kv_cache(GEO, 1, S)
        P = len(x_seq) - 1
        mask = tfm.causal_mask(1, P, jnp.array([P]))
        _, kv = tfm.forward_prefill(params, jnp.asarray(x_seq[:P])[None],
                                    jnp.broadcast_to(jnp.arange(P), (1, P)),
                                    mask, GEO, kv_cache=kv)
        h, _ = tfm.decode_step(params, jnp.asarray(x_seq[P])[None],
                               jnp.array([P]), kv, GEO)
        return np.asarray(h[0])

    ha = run_single(xa)
    hb = run_single(xb)

    # batched: element 0 at pos 2, element 1 at pos 4
    kv = tfm.init_kv_cache(GEO, 2, S)
    PA, PB = 2, 4
    pad = np.zeros((PB, 64), np.float32)
    pad_a = np.concatenate([xa[:PA], np.zeros((PB - PA, 64), np.float32)])
    xs = np.stack([pad_a, xb[:PB]])
    mask = tfm.causal_mask(2, PB, jnp.array([PA, PB]))
    _, kv = tfm.forward_prefill(params, jnp.asarray(xs),
                                jnp.broadcast_to(jnp.arange(PB), (2, PB)),
                                mask, GEO, kv_cache=kv)
    h, _ = tfm.decode_step(params, jnp.asarray(np.stack([xa[PA], xb[PB]])),
                           jnp.array([PA, PB]), kv, GEO)
    np.testing.assert_allclose(np.asarray(h[0]), ha, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(np.asarray(h[1]), hb, rtol=3e-4, atol=3e-4)


def _fused_int8_layers(params):
    from qwen3_tts_tpu.ops import quant
    layers = quant.quantize_layer_stack(params, fuse=True)
    return layers, quant.attach_layer_list({"layers": layers})["layers_list"]


def test_decode_step_unrolled_fused_int8_matches_scan(params):
    """The int8 engine's decode path (per-layer weight list over the fused
    qkv/gate+up layout) computes what the stacked scan computes on the
    same fused int8 weights: hidden state and every cache row."""
    layers, layers_list = _fused_int8_layers(params)
    assert "qkv_proj" in layers_list[0] and "q_proj" not in layers_list[0]
    rng = np.random.default_rng(12)
    B, S = 2, 16
    x = jnp.asarray(rng.normal(size=(B, 64), scale=0.5), jnp.float32)
    kv = jnp.asarray(rng.normal(size=(GEO.num_layers, 2, B, S, 2, 16),
                                scale=0.3), jnp.float32)
    pos = jnp.array([3, 9], jnp.int32)
    want_h, want_kv = tfm.decode_step(layers, x, pos, kv, GEO)
    got_h, got_kv = tfm.decode_step_unrolled(layers_list, x, pos, kv, GEO)
    np.testing.assert_allclose(np.asarray(got_h), np.asarray(want_h),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got_kv), np.asarray(want_kv),
                               rtol=1e-6, atol=1e-6)


def test_decode_step_unrolled_position_isolation(params):
    """A step writes exactly row pos[b] of slot b in every layer, leaves
    every other cache row as it was, and each slot's hidden state equals
    a batch-1 step on that slot alone."""
    _, layers_list = _fused_int8_layers(params)
    rng = np.random.default_rng(13)
    B, S = 3, 16
    x = jnp.asarray(rng.normal(size=(B, 64), scale=0.5), jnp.float32)
    kv = jnp.asarray(rng.normal(size=(GEO.num_layers, 2, B, S, 2, 16),
                                scale=0.3), jnp.float32)
    pos = np.array([0, 7, 15], np.int32)
    h, new_kv = tfm.decode_step_unrolled(layers_list, x, jnp.asarray(pos),
                                         kv, GEO)
    changed = np.any(np.asarray(new_kv) != np.asarray(kv), axis=(0, 1, 4, 5))
    want = np.zeros((B, S), bool)
    want[np.arange(B), pos] = True
    np.testing.assert_array_equal(changed, want)
    for b in range(B):
        h1, _ = tfm.decode_step_unrolled(layers_list, x[b:b + 1],
                                         jnp.asarray(pos[b:b + 1]),
                                         kv[:, :, b:b + 1], GEO)
        np.testing.assert_allclose(np.asarray(h[b]), np.asarray(h1[0]),
                                   rtol=1e-5, atol=1e-5)
