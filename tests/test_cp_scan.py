"""The code predictor's scan path (models/code_predictor.predict_codes),
the one implementation of groups 1..15 on every backend: greedy parity
at the full 0.6B CP geometry against a float64 NumPy re-execution, batch
invariance per row, seed determinism, and in-range sampled codes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3_tts_tpu import config as C
from qwen3_tts_tpu.models import code_predictor as cp
from qwen3_tts_tpu.ops import quant

import np_reference as ref

FULL = C.CodePredictorConfig()
TINY = C.tiny_tts_config().code_predictor


@pytest.fixture(scope="module")
def full_params():
    return jax.jit(lambda k: cp.init_cp_params(k, FULL, jnp.float32))(
        jax.random.PRNGKey(0))


def _np_forward(params, inputs, cfg):
    """mtp_proj -> layers -> final norm over the whole sequence, float64."""
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    x = np.asarray(inputs, np.float64) @ p["mtp_proj_w"] + p["mtp_proj_b"]
    geo = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
               head_dim=cfg.head_dim, rms_norm_eps=cfg.rms_norm_eps,
               rope_theta=cfg.rope_theta)
    h = ref.stack_forward(p["layers"], x, np.arange(len(x)), geo)
    return ref.rms_norm(h, p["final_norm"], cfg.rms_norm_eps), p


def test_greedy_parity_full_geometry(full_params):
    """Temperature 0 at the full CP geometry: every group's code is the
    argmax of a float64 NumPy forward fed the same previous codes
    (teacher forcing). Groups whose top-2 logits lie within 1e-4 of each
    other are float ties and are not compared."""
    params = full_params
    rng = np.random.default_rng(0)
    hidden = rng.normal(size=(1, FULL.hidden_size)).astype(np.float32)
    c0e = rng.normal(size=(1, FULL.hidden_size)).astype(np.float32)
    greedy = C.SamplingConfig(cp_temperature=0.0)
    with jax.default_matmul_precision("highest"):
        codes = np.asarray(jax.jit(
            lambda p, h, c: cp.predict_codes(p, h, c, jax.random.PRNGKey(1),
                                             FULL, greedy))(
            params, jnp.asarray(hidden), jnp.asarray(c0e)))[0]

    inputs = [hidden[0], c0e[0]]
    embs = np.asarray(params["codec_embs"])
    for g in range(1, FULL.num_groups):
        inputs.append(embs[g - 1][codes[g - 1]])
    h, p = _np_forward(params, np.stack(inputs), FULL)
    compared = 0
    for g in range(FULL.num_groups):
        logits = h[g + 1] @ p["lm_heads"][g]
        top2 = np.sort(logits)[-2:]
        if top2[1] - top2[0] < 1e-4:
            continue
        compared += 1
        assert codes[g] == int(np.argmax(logits)), f"group {g + 1}"
    assert compared >= 12


def test_batched_rows_equal_single_rows():
    """Row i of a batch of 3 equals a batch-1 call on row i's inputs and
    key, sampled at the reference temperature on int8 weights: a slot's
    codes do not depend on its neighbours or its position."""
    params = quant.quantize_code_predictor(
        cp.init_cp_params(jax.random.PRNGKey(2), TINY))
    scfg = C.SamplingConfig()
    B = 3
    hidden = jax.random.normal(jax.random.PRNGKey(3), (B, TINY.hidden_size))
    c0e = jax.random.normal(jax.random.PRNGKey(4), (B, TINY.hidden_size))
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    run = jax.jit(lambda h, c, k: cp.predict_codes(params, h, c, k, TINY,
                                                   scfg))
    batched = np.asarray(run(hidden, c0e, keys))
    for i in range(B):
        single = np.asarray(run(hidden[i:i + 1], c0e[i:i + 1],
                                keys[i:i + 1]))
        np.testing.assert_array_equal(batched[i], single[0])


def test_seed_determinism():
    """Same key, same codes; another key reaches the sampler and changes
    the trajectory somewhere."""
    params = cp.init_cp_params(jax.random.PRNGKey(6), TINY)
    scfg = C.SamplingConfig(cp_temperature=0.8)
    hidden = jax.random.normal(jax.random.PRNGKey(7), (2, TINY.hidden_size))
    c0e = jax.random.normal(jax.random.PRNGKey(8), (2, TINY.hidden_size))
    run = jax.jit(lambda k: cp.predict_codes(params, hidden, c0e, k, TINY,
                                             scfg))
    a = np.asarray(run(jax.random.PRNGKey(9)))
    np.testing.assert_array_equal(a, np.asarray(run(jax.random.PRNGKey(9))))
    assert not np.array_equal(a, np.asarray(run(jax.random.PRNGKey(10))))


def test_sampled_codes_in_range_full_geometry(full_params):
    """Sampled int8 CP at the full geometry: every code lies in
    [0, group_vocab); at temperature 1e-5 the scaled logit gaps dwarf the
    Gumbel noise, so the draws collapse onto the greedy codes."""
    params = jax.jit(quant.quantize_code_predictor)(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), full_params))
    hidden = jax.random.normal(jax.random.PRNGKey(11),
                               (2, FULL.hidden_size), jnp.bfloat16)
    c0e = jax.random.normal(jax.random.PRNGKey(12), (2, FULL.hidden_size),
                            jnp.bfloat16)

    def run(temperature):
        scfg = C.SamplingConfig(cp_temperature=temperature)
        return np.asarray(jax.jit(
            lambda p: cp.predict_codes(p, hidden, c0e,
                                       jax.random.PRNGKey(13), FULL, scfg))(
            params))

    sampled = run(0.1)
    assert sampled.shape == (2, FULL.num_groups)
    assert (sampled >= 0).all() and (sampled < FULL.group_vocab_size).all()
    assert (run(1e-5) == run(0.0)).mean() > 0.9
