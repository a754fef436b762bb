"""Multi-language batched synthesis: all 7
supported languages in one batched fused decode."""

import numpy as np
import jax.numpy as jnp
import pytest

from qwen3_tts_tpu.config import SUPPORTED_LANGUAGES, tiny_tts_config
from qwen3_tts_tpu.engine.engine import TTSEngine


@pytest.fixture(scope="module")
def engine():
    return TTSEngine(tiny_tts_config(max_tokens=6), model_dir=None,
                     dtype=jnp.float32)


def test_seven_languages_one_batch(engine):
    texts = [f"sample {lang}" for lang in SUPPORTED_LANGUAGES]
    results = engine.synthesize_batch(texts, list(SUPPORTED_LANGUAGES),
                                      seed=1)
    assert len(results) == 7
    for r in results:
        assert r.n_tokens >= 0
        assert len(r.audio_int16) == r.n_tokens * 1920
        if r.n_tokens:
            assert (r.codes < 2048).all()


def test_batch_rejects_bad_language(engine):
    with pytest.raises(ValueError):
        engine.synthesize_batch(["a", "b"], ["russian", "klingon"])


def test_varied_lengths_batched(engine):
    texts = ["a", "bb" * 6, "ccc"]
    results = engine.synthesize_batch(texts, ["english"] * 3, seed=2)
    assert len(results) == 3
    for r in results:
        assert len(r.audio_int16) == r.n_tokens * 1920
