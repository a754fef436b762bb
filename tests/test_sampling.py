"""Sampling-policy parity vs the NumPy golden reference."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qwen3_tts_tpu.config import CODEC_EOS_ID, SamplingConfig
from qwen3_tts_tpu.ops import sampling as smp

import np_reference as ref

CFG = SamplingConfig()
REF_CFG = {"top_k": 50, "temperature": 0.8, "top_p": 0.95}


def _ref_masked_boosted_penalised(logits, past, n_text):
    """Reference pipeline up to the top-k step, as float64 numpy."""
    lg = logits.astype(np.float64).copy()
    lg[2048:2150] = -1e10
    lg[2151:] = -1e10
    force = False
    if past is not None and n_text > 0:
        expected = n_text * 3
        progress = len(past) / expected
        if progress > 0.8:
            lg[2150] += min((progress - 0.8) / 0.7, 1.0) * 15.0
        if progress > 2.0:
            force = True
    if past:
        for t in set(past[-30:]):
            if lg[t] > 0:
                lg[t] /= 1.2
            else:
                lg[t] *= 1.2
    return lg, force


def test_mask_allows_audio_and_eos_only():
    logits = np.zeros(3072, np.float32)
    got = np.asarray(smp.mask_code0_logits(jnp.asarray(logits)))
    assert (got[:2048] == 0).all()
    assert got[2150] == 0
    assert (got[2048:2150] <= -1e9).all()
    assert (got[2151:] <= -1e9).all()


def test_eos_boost_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=3072).astype(np.float32)
    n_text = 10
    for n_past in [0, 5, 24, 25, 30, 45, 59, 61, 70]:
        past = list(range(n_past))  # distinct small ids
        want, want_force = _ref_masked_boosted_penalised(logits, past, n_text)

        lg = smp.mask_code0_logits(jnp.asarray(logits).astype(jnp.float32))
        lg, force = smp.eos_boost(lg, jnp.int32(n_past), jnp.int32(n_text), CFG)
        ring = jnp.full((30,), -1, jnp.int32)
        for t in past[-30:]:
            ring = smp.ring_push(ring, jnp.int32(t))
        lg = smp.repetition_penalty(lg, ring, CFG.repetition_penalty)

        got = np.asarray(lg)
        keep = want > -1e9  # compare only unmasked entries
        np.testing.assert_allclose(got[keep], want[keep], rtol=1e-5, atol=1e-4,
                                   err_msg=f"n_past={n_past}")
        assert bool(force) == want_force, n_past


def test_repetition_penalty_deduplicated():
    """A token appearing 5x in the window must be penalised exactly once."""
    logits = np.full(3072, 2.0, np.float32)
    ring = jnp.full((30,), -1, jnp.int32)
    for _ in range(5):
        ring = smp.ring_push(ring, jnp.int32(7))
    got = np.asarray(smp.repetition_penalty(jnp.asarray(logits), ring, 1.2))
    np.testing.assert_allclose(got[7], 2.0 / 1.2, rtol=1e-6)
    assert got[8] == 2.0


def test_negative_logit_multiplied():
    logits = np.full(3072, -3.0, np.float32)
    ring = smp.ring_push(jnp.full((30,), -1, jnp.int32), jnp.int32(11))
    got = np.asarray(smp.repetition_penalty(jnp.asarray(logits), ring, 1.2))
    np.testing.assert_allclose(got[11], -3.6, rtol=1e-6)


def test_topk_topp_keep_set_matches_reference():
    """The nucleus keep-set (searchsorted-left + 1 semantics) must match."""
    rng = np.random.default_rng(3)
    for trial in range(20):
        logits = rng.normal(size=3072, scale=3.0).astype(np.float32)
        top_idx, kept, keep, _ = ref.sample_code0_probs(
            logits, [], 0, REF_CFG)
        want_tokens = set(int(top_idx[j]) for j in keep)

        # draw many samples with different keys; all must be in the keep set
        # (the reference applies the codec mask before top-k — match it)
        lg = smp.mask_code0_logits(jnp.asarray(logits))
        seen = set()
        for s in range(40):
            tok = smp.topk_softmax_topp_sample(
                lg, jax.random.PRNGKey(trial * 100 + s), 50, 0.8, 0.95)
            seen.add(int(tok))
        assert seen <= want_tokens, (trial, seen - want_tokens)


def test_force_eos():
    logits = np.zeros(3072, np.float32)
    logits[100] = 50.0  # would always sample 100
    tok = smp.sample_code0(
        jnp.asarray(logits), jnp.full((30,), -1, jnp.int32),
        step=jnp.int32(61), n_text_tokens=jnp.int32(10),
        key=jax.random.PRNGKey(0), cfg=CFG)
    assert int(tok) == CODEC_EOS_ID  # progress 61/30 > 2.0


def test_cp_sampling_temperature_sharpness():
    """At T=0.1 a 0.5-logit lead (ratio e^5) should dominate; samples must
    always come from the top-k set."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=2048).astype(np.float32)
    best = int(np.argmax(logits))
    logits[best] = logits.max() + 0.5
    topk_set = set(np.argsort(logits)[-50:].tolist())
    hits = 0
    for s in range(50):
        tok = int(smp.topk_temperature_sample(
            jnp.asarray(logits), jax.random.PRNGKey(s), 50, 0.1))
        assert tok in topk_set
        hits += tok == best
    assert hits >= 45


def test_sampling_deterministic_given_key():
    rng = np.random.default_rng(9)
    logits = jnp.asarray(rng.normal(size=3072, scale=2.0).astype(np.float32))
    ring = jnp.full((30,), -1, jnp.int32)
    a = smp.sample_code0(logits, ring, jnp.int32(3), jnp.int32(20),
                         jax.random.PRNGKey(42), CFG)
    b = smp.sample_code0(logits, ring, jnp.int32(3), jnp.int32(20),
                         jax.random.PRNGKey(42), CFG)
    assert int(a) == int(b)


def _chi2_gof(draws, probs, alpha=1e-4):
    """χ² goodness-of-fit (expected-<5 bins pooled); see test_cp_kernel."""
    from scipy.stats import chi2

    n = len(draws)
    expected = probs * n
    big = expected >= 5
    counts = np.bincount(draws, minlength=len(probs)).astype(np.float64)
    stat = float(np.sum((counts[big] - expected[big]) ** 2 / expected[big]))
    pool_e = expected[~big].sum()
    if pool_e > 0:
        stat += (counts[~big].sum() - pool_e) ** 2 / max(pool_e, 1e-12)
        df = int(big.sum())
    else:
        df = int(big.sum()) - 1
    return stat, float(chi2.ppf(1 - alpha, df))


def _oracle_topk_topp_probs(logits, top_k, temperature, top_p):
    """llamacpp_talker_server.py:191-206 as an analytic distribution:
    softmax over top-k/T, nucleus cut (keep the smallest descending
    prefix reaching top_p), renormalise."""
    V = len(logits)
    order = np.argsort(logits)[::-1][:top_k]
    z = logits[order] / temperature
    z -= z.max()
    p = np.exp(z) / np.exp(z).sum()
    csum = np.cumsum(p)
    shifted = np.concatenate([[0.0], csum[:-1]])
    keep = shifted < top_p
    p = np.where(keep, p, 0.0)
    p /= p.sum()
    probs = np.zeros(V)
    probs[order] = p
    return probs


def test_topk_topp_distribution_chi2():
    """χ² of 20k draws from the production code_0 sampler
    (topk_softmax_topp_sample at the reference's T=0.8/k=50/p=0.95)
    against the analytic top-k/temperature/nucleus distribution — catches
    a wrong temperature scale, an off-by-one nucleus cut, or a
    renormalisation bug that the keep-set test cannot (round-2 VERDICT
    Weak #4)."""
    V, N = 3072, 20000
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal(V) * 1.0).astype(np.float32)
    probs = _oracle_topk_topp_probs(logits, 50, 0.8, 0.95)

    keys = jax.random.split(jax.random.PRNGKey(0), N)
    draws = np.asarray(jax.jit(jax.vmap(
        lambda k: smp.topk_softmax_topp_sample(
            jnp.asarray(logits), k, 50, 0.8, 0.95)))(keys))
    assert probs[draws].min() > 0, "draw outside the nucleus support"
    stat, crit = _chi2_gof(draws, probs)
    assert stat < crit, f"chi2 {stat:.1f} >= {crit:.1f}: biased sampler"


def test_cp_topk_temperature_distribution_chi2():
    """Same χ² bar for the XLA-path CP sampler (topk_temperature_sample)
    at the production temperature 0.1."""
    V, N = 2048, 20000
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal(V) * 0.08).astype(np.float32)
    order = np.argsort(logits)[::-1][:50]
    z = logits[order] / 0.1
    z -= z.max()
    p = np.exp(z) / np.exp(z).sum()
    probs = np.zeros(V)
    probs[order] = p

    keys = jax.random.split(jax.random.PRNGKey(1), N)
    draws = np.asarray(jax.jit(jax.vmap(
        lambda k: smp.topk_temperature_sample(
            jnp.asarray(logits), k, 50, 0.1)))(keys))
    stat, crit = _chi2_gof(draws, probs)
    assert stat < crit, f"chi2 {stat:.1f} >= {crit:.1f}: biased sampler"


def test_batch_keys_accepts_typed_prng_keys():
    """jax.random.key (new-style 0-d typed keys) must unwrap to the raw
    (B, 2) uint32 layout, identical to the legacy PRNGKey path."""
    from qwen3_tts_tpu.ops import sampling as smp

    legacy = smp.batch_keys(jax.random.PRNGKey(7), 3)
    typed = smp.batch_keys(jax.random.key(7), 3)
    np.testing.assert_array_equal(np.asarray(typed), np.asarray(legacy))


def _cp_topk_temp_probs(logits, top_k, temperature):
    """code_predictor_server.py:87-92 as an analytic distribution:
    softmax over the top-k logits / T."""
    order = np.argsort(logits)[::-1][:top_k]
    z = logits[order] / temperature
    z -= z.max()
    p = np.exp(z) / np.exp(z).sum()
    probs = np.zeros(len(logits))
    probs[order] = p
    return probs


@pytest.mark.parametrize("temperature,spread", [(0.8, 1.0), (0.5, 0.3)])
def test_cp_sampler_distribution_chi2(temperature, spread):
    """χ² of 20k draws from topk_temperature_sample against the analytic
    top-k/temperature distribution at temperatures above the CP's 0.1,
    where the kept mass spreads over many codes: a wrong temperature
    scale or a biased draw makes the statistic explode."""
    V, N = 2048, 20000
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal(V) * spread).astype(np.float32)
    probs = _cp_topk_temp_probs(logits, 50, temperature)
    keys = jax.random.split(jax.random.PRNGKey(2), N)
    draws = np.asarray(jax.jit(jax.vmap(
        lambda k: smp.topk_temperature_sample(
            jnp.asarray(logits), k, 50, temperature)))(keys))
    assert probs[draws].min() > 0, "draw outside the top-k support"
    stat, crit = _chi2_gof(draws, probs)
    assert stat < crit, f"chi2 {stat:.1f} >= {crit:.1f}: biased sampler"


def test_cp_group_draws_are_decorrelated():
    """predict_codes draws group g with the g-th split of an element's
    key: draws of two successive groups from one key must be independent
    — the joint frequency over (group 1, group 2) factorises."""
    V, N = 256, 20000
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal(V) * 0.3).astype(np.float32)
    probs = _cp_topk_temp_probs(logits, 8, 0.5)
    kept = np.flatnonzero(probs)
    remap = -np.ones(V, np.int64)
    remap[kept] = np.arange(len(kept))

    def draw_pair(key):
        ks = jax.random.split(key, 15)
        return jnp.stack([smp.topk_temperature_sample(
            jnp.asarray(logits), ks[g], 8, 0.5) for g in (1, 2)])

    keys = jax.random.split(jax.random.PRNGKey(3), N)
    pairs = np.asarray(jax.jit(jax.vmap(draw_pair))(keys))
    joint = remap[pairs[:, 0]] * len(kept) + remap[pairs[:, 1]]
    pair_probs = np.outer(probs[kept], probs[kept]).ravel()
    stat, crit = _chi2_gof(joint, pair_probs)
    assert stat < crit, f"chi2 {stat:.1f} >= {crit:.1f}: groups correlated"
