"""CPU-runnable regression bound for the int8 quality dossier
(tools/quality_check.py) — the reference's quantization-quality
discipline (reference README.md:56-64 measures SNR per variant and
rejects on quality) applied to this repo's own int8 tier.

At tiny geometry with random weights, FREE-RUNNING agreement is ~0 by
construction (random logits are near-ties; any perturbation flips the
greedy argmax at the first step and feedback compounds), so the bounds
asserted here are the metrics that stay meaningful:

- teacher-forced hidden drift (tf_cos_min): int8 talker matmul error
  accumulated over a forced-identical context — the direct numeric
  regression signal for ops/quant's int8 matmul.
- int8-cp invariants: with the talker left bf16, the teacher-forced
  hidden trajectory and code_0 choices must be IDENTICAL to bf16 —
  any miss means quantize-cp leaked into the talker path.
"""

import dataclasses

import pytest

from qwen3_tts_tpu.config import tiny_tts_config


@pytest.fixture(scope="module")
def dossier():
    import jax.numpy as jnp

    from qwen3_tts_tpu.io import weights as weights_io
    from tools import quality_check as qc

    cfg = qc.greedy_config(tiny_tts_config(max_tokens=10))
    params = weights_io.load_params(None, cfg, jnp.bfloat16, seed=0)
    return qc.run_dossier(cfg, params, ["int8", "int8-cp"],
                          texts=["проверка качества quant check"],
                          seed=0, n_hidden_steps=6)


def test_int8_teacher_forced_hidden_drift_bounded(dossier):
    a = dossier["int8"]
    # per-step int8 talker drift under an identical forced context: the
    # regression bound for the quantizer + dequant matmul numerics
    assert a["tf_cos_min"] >= 0.999, a
    assert a["hidden_cos_min"] >= 0.999, a


def test_int8_cp_leaves_talker_exact(dossier):
    a = dossier["int8-cp"]
    # talker stays bf16 under int8-cp: teacher-forced hiddens and code_0
    # decisions must match the baseline exactly
    assert a["tf_cos_min"] >= 1.0 - 1e-9, a
    assert a["tf_code0_agree"] == 1.0, a


def test_greedy_config_is_deterministic(dossier):
    # greedy_config collapses sampling to argmax: both variants must
    # produce length-matched decodes independent of the PRNG stream
    assert dossier["int8"]["len_match"]
    assert dossier["int8-cp"]["len_match"]


def test_metrics_ranges(dossier):
    for v in ("int8", "int8-cp"):
        a = dossier[v]
        for k in ("tf_code0_agree", "tf_row_agree", "code0_agree",
                  "row_agree", "prefix_frac", "int16_match"):
            assert 0.0 <= a[k] <= 1.0, (v, k, a[k])


def test_snr_db_basics():
    import numpy as np

    from tools.quality_check import snr_db

    a = (np.sin(np.linspace(0, 20, 2000)) * 20000).astype(np.int16)
    assert snr_db(a, a) == float("inf")
    noisy = (a + np.random.default_rng(0)
             .integers(-200, 200, a.shape)).astype(np.int16)
    assert 30.0 < snr_db(a, noisy) < 60.0
    # length mismatch: compared over the common prefix
    assert snr_db(a, a[:500]) == float("inf")
