"""int8 quality dossier: greedy code agreement, hidden cosine similarity,
and audio SNR for the quantized tiers vs the bf16 baseline.

The reference measures SNR/correlation for every quantization variant and
rejects on quality (reference README.md:56-64: vocoder RKNN Q8 at SNR
9.5 dB and ONNX INT8 at 4.2 dB were both rejected; only FP32 shipped).
This tool applies the same discipline to this repo's OWN quantization
tier — the int8 talker/CP weights (ops/quant.py) — so the shipped
default's quality claim rests on end-to-end numbers, not per-op
tolerances alone (tests/test_quant.py covers those).

Method: decode the same prompts GREEDILY (temperature -> 0 makes the
whole pipeline deterministic, so any output difference is quantization
error, not sampling noise) under bf16 and each quantized variant, then
compare:

- **code agreement (free-running)**: % of talker code_0s and full
  16-code rows that match positionally, plus the divergence-free prefix
  fraction (once one code differs, the feedback embedding differs and
  later tokens are no longer expected to match — the prefix is the
  honest free-running metric).
- **code agreement (teacher-forced)**: the variant re-decodes the bf16
  trajectory with the bf16 codes FORCED as feedback each step, so every
  step sees the same context the baseline saw and divergence cannot
  compound. tf_code0/tf_row is the per-step greedy flip rate of the
  quantized weights — the metric that stays meaningful when free-running
  trajectories split at the first near-tie logit (with random weights
  most logits are near-ties, so the free-running numbers are a floor,
  not a quality estimate; the teacher-forced ones are the real signal).
- **hidden cos-sim**: cosine similarity of the talker hidden state at
  each step over the agreeing prefix (inputs are identical there, so
  this isolates the per-step numeric drift of the int8 matmuls).
- **audio SNR**: dB of the bf16-decoded audio vs the variant's, over the
  common length. The vocoder itself is always FP32 (reference
  README.md:56-64), so audio differences are entirely upstream codes.

Outputs one JSON line on stdout; a human table on stderr. Runs on CPU
(``--tiny``) or the real geometry on the GPU. Random weights unless
``--model_dir`` points at a checkpoint.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEFAULT_TEXTS = (
    "Привет, мир! Это проверка качества квантования.",
    "The quick brown fox jumps over the lazy dog.",
    "Синтез речи на GPU работает быстро и точно.",
)


def greedy_config(cfg):
    """Sampling config with temperature -> 0: top-k keeps the argmax with
    probability ~1 (softmax of logits/1e-6 is one-hot), the nucleus cut
    keeps exactly that entry, and the CP categorical likewise collapses
    to argmax — the decode becomes deterministic, independent of the PRNG
    key. EOS pacing/boost/repetition penalty stay at reference defaults
    (they are part of the product numerics being compared)."""
    scfg = dataclasses.replace(cfg.sampling, temperature=1e-6,
                               cp_temperature=1e-6)
    return dataclasses.replace(cfg, sampling=scfg)


def build_engine(cfg, params: dict, quantize: Optional[str]):
    from qwen3_tts_tpu.engine.engine import TTSEngine

    # dict() copy: TTSEngine replaces component entries when quantizing,
    # and each variant must start from the same bf16 tree
    return TTSEngine(cfg=cfg, params=dict(params), quantize=quantize)


def hidden_trajectory(engine, text: str, seed: int, n_steps: int):
    """Greedy-decode ``n_steps`` tokens capturing the talker hidden each
    code_0 was sampled from (step 0 = the post-prefill hidden). Returns
    (hiddens (n_steps, H) float32, codes (n_steps, 16), n_codes).

    Uses the same _loop_body as the product decode (gen.run_steps), so
    the captured numerics are the shipped path's."""
    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTS_PAD_TOKEN_ID
    from qwen3_tts_tpu.engine import generate as gen
    from qwen3_tts_tpu.models import talker as tk
    from qwen3_tts_tpu.ops import sampling as smp

    cfg = engine.cfg
    tp = engine.params["talker"]
    cpp = engine.params["code_predictor"]
    text_ids, n_text = engine._encode_text(text)

    def run(tp, cpp, ids, n, key):
        state = engine._mk_state(tp, ids, n, key)
        tts_pad = tk.embed_text(tp, jnp.array([TTS_PAD_TOKEN_ID]))[0]

        def body(s, _):
            s2 = gen._loop_body(s, tp, cpp, tts_pad, cfg)
            return s2, s.hidden[0].astype(jnp.float32)

        final, hs = jax.lax.scan(body, state, None, length=n_steps)
        return hs, final.codes[0], final.n_codes[0]

    hs, codes, n = jax.jit(run)(tp, cpp, text_ids, n_text,
                                smp.host_prng_key(seed))
    return (np.asarray(jax.device_get(hs)),
            np.asarray(jax.device_get(codes)),
            int(jax.device_get(n)))


def teacher_forced_trajectory(engine, text: str, seed: int,
                              ref_codes: np.ndarray):
    """Re-decode ``len(ref_codes)`` steps with the reference codes FORCED
    as feedback/ring context each step, recording what THIS engine would
    have greedily chosen at each step. Every step therefore sees the same
    decision context the baseline saw (up to the variant's own numeric
    drift in the hidden state), so agreement is a per-step flip rate,
    not a compounding trajectory comparison.

    Mirrors engine/generate._loop_body's call sequence (codec_logits ->
    sample_code0 -> predict_codes -> feedback -> decode_step) with the
    commit swapped for the forced row. Returns (hiddens (T, H) f32 — the
    hidden each decision was made from, comparable position-for-position
    with the baseline's — and chosen (T, 16) codes)."""
    import jax
    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTS_PAD_TOKEN_ID
    from qwen3_tts_tpu.models import talker as tk
    from qwen3_tts_tpu.models import code_predictor as cp
    from qwen3_tts_tpu.ops import sampling as smp

    cfg = engine.cfg
    scfg = cfg.sampling
    tp = engine.params["talker"]
    cpp = engine.params["code_predictor"]
    text_ids, n_text = engine._encode_text(text)

    def run(tp, cpp, ids, n, key, forced):          # forced (T, 16) i32
        state = engine._mk_state(tp, ids, n, key)
        tts_pad = tk.embed_text(tp, jnp.array([TTS_PAD_TOKEN_ID]))[0]

        def body(s, ref_row):                        # ref_row (16,) i32
            ks = jax.vmap(lambda k: jax.random.split(k, 3))(s.key)
            key, c0k, kcp = ks[:, 0], ks[:, 1], ks[:, 2]
            logits = tk.codec_logits(tp, s.hidden)
            code0_var = jax.vmap(
                lambda lg, rg, st, nt, kk: smp.sample_code0(
                    lg, rg, st, nt, kk, scfg)
            )(logits, s.ring, s.n_codes, s.n_text, c0k)      # (1,)
            ref0 = jnp.broadcast_to(ref_row[0], code0_var.shape)
            c0_embed = tp["codec_embedding"][ref0]           # forced input
            groups_var = cp.predict_codes(cpp, s.hidden, c0_embed, kcp,
                                          cfg.code_predictor, scfg)
            ref_groups = jnp.broadcast_to(ref_row[1:][None],
                                          groups_var.shape)
            fb = (c0_embed
                  + jnp.sum(cpp["codec_embs"][jnp.arange(15)[None, :],
                                              ref_groups], axis=1)
                  + tts_pad[None, :]).astype(s.hidden.dtype)
            hidden, kv = tk.decode_step(tp, fb, s.pos, s.kv, cfg.talker)
            chosen = jnp.concatenate([code0_var[:, None], groups_var],
                                     axis=1)                  # (1, 16)
            s2 = s._replace(
                kv=kv, pos=s.pos + 1, hidden=hidden,
                ring=jax.vmap(smp.ring_push)(s.ring, ref0),
                n_codes=s.n_codes + 1, key=key)
            return s2, (s.hidden[0].astype(jnp.float32), chosen[0])

        _, (hs, rows) = jax.lax.scan(body, state, forced)
        return hs, rows

    T = len(ref_codes)
    hs, rows = jax.jit(run)(tp, cpp, text_ids, n_text,
                            smp.host_prng_key(seed),
                            jnp.asarray(ref_codes[:T], jnp.int32))
    return (np.asarray(jax.device_get(hs)),
            np.asarray(jax.device_get(rows)))


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """SNR of ``test`` against ``ref`` (int16 arrays), over the common
    length — the reference's vocoder-quality metric (README.md:58-64)."""
    m = min(len(ref), len(test))
    if m == 0:
        return float("inf")
    r = ref[:m].astype(np.float64)
    e = r - test[:m].astype(np.float64)
    num = float(np.sum(r * r))
    den = float(np.sum(e * e))
    if den == 0.0:
        return float("inf")
    if num == 0.0:
        return 0.0
    return 10.0 * np.log10(num / den)


def compare_variant(eng_ref, eng_var, texts: Sequence[str], seed: int,
                    n_hidden_steps: int) -> Dict:
    """Per-text greedy comparison of ``eng_var`` against ``eng_ref``;
    returns aggregated metrics (worst-case minima + means)."""
    rows: List[Dict] = []
    for ti, text in enumerate(texts):
        hs_r, codes_r, n_r = hidden_trajectory(eng_ref, text, seed,
                                               n_hidden_steps)
        hs_v, codes_v, n_v = hidden_trajectory(eng_var, text, seed,
                                               n_hidden_steps)
        m = min(n_r, n_v)
        row_eq = (codes_r[:m] == codes_v[:m]).all(axis=1)
        code0_eq = codes_r[:m, 0] == codes_v[:m, 0]
        # divergence-free prefix: tokens before the first mismatching row
        prefix = int(np.argmin(row_eq)) if not row_eq.all() else m
        # hidden cos-sim over the agreeing prefix + the first divergent
        # step (inputs identical up to and including hidden[prefix])
        k = min(prefix + 1, min(len(hs_r), len(hs_v)), m + 1)
        cos = np.ones((0,), np.float64)
        if k > 0:
            a, b = hs_r[:k].astype(np.float64), hs_v[:k].astype(np.float64)
            cos = (np.sum(a * b, axis=1)
                   / np.maximum(np.linalg.norm(a, axis=1)
                                * np.linalg.norm(b, axis=1), 1e-30))
        # teacher-forced: per-step flip rate under the baseline's context
        hs_tf, rows_tf = teacher_forced_trajectory(eng_var, text, seed,
                                                   codes_r[:n_r])
        tf_code0 = rows_tf[:, 0] == codes_r[:n_r, 0]
        tf_row = (rows_tf == codes_r[:n_r]).all(axis=1)
        kt = min(len(hs_tf), len(hs_r), n_r)
        a, b = hs_r[:kt].astype(np.float64), hs_tf[:kt].astype(np.float64)
        tf_cos = (np.sum(a * b, axis=1)
                  / np.maximum(np.linalg.norm(a, axis=1)
                               * np.linalg.norm(b, axis=1), 1e-30))
        # audio through each variant's own codes (vocoder is FP32 in both)
        audio_r = _vocode(eng_ref, codes_r[:n_r])
        audio_v = _vocode(eng_var, codes_v[:n_v])
        ma = min(len(audio_r), len(audio_v))
        rows.append({
            "text_idx": ti,
            "n_ref": n_r,
            "n_var": n_v,
            "code0_agree": float(code0_eq.mean()) if m else 1.0,
            "row_agree": float(row_eq.mean()) if m else 1.0,
            "prefix_frac": (prefix / n_r) if n_r else 1.0,
            "tf_code0_agree": float(tf_code0.mean()) if n_r else 1.0,
            "tf_row_agree": float(tf_row.mean()) if n_r else 1.0,
            "tf_cos_min": float(tf_cos.min()) if kt else 1.0,
            "hidden_cos_min": float(cos.min()) if len(cos) else 1.0,
            "hidden_cos_mean": float(cos.mean()) if len(cos) else 1.0,
            "snr_db": snr_db(audio_r, audio_v),
            "int16_match": (float((audio_r[:ma] == audio_v[:ma]).mean())
                            if ma else 1.0),
        })
    agg = {
        "code0_agree": float(np.mean([r["code0_agree"] for r in rows])),
        "row_agree": float(np.mean([r["row_agree"] for r in rows])),
        "prefix_frac": float(np.mean([r["prefix_frac"] for r in rows])),
        "tf_code0_agree": float(np.mean([r["tf_code0_agree"]
                                         for r in rows])),
        "tf_row_agree": float(np.mean([r["tf_row_agree"] for r in rows])),
        "tf_cos_min": float(min(r["tf_cos_min"] for r in rows)),
        "hidden_cos_min": float(min(r["hidden_cos_min"] for r in rows)),
        "hidden_cos_mean": float(np.mean([r["hidden_cos_mean"]
                                          for r in rows])),
        "snr_db_min": float(min(r["snr_db"] for r in rows)),
        "int16_match": float(np.mean([r["int16_match"] for r in rows])),
        "len_match": all(r["n_ref"] == r["n_var"] for r in rows),
        "texts": rows,
    }
    return agg


def _vocode(engine, codes: np.ndarray) -> np.ndarray:
    import jax.numpy as jnp

    from qwen3_tts_tpu.models import vocoder as voc

    vp = engine.params["vocoder"]
    audio = voc.synthesize_exact(
        lambda ch: engine._voc_chunk(vp, jnp.asarray(ch)), codes)
    return voc.to_int16(np.asarray(audio))


def run_dossier(cfg, params, variants: Sequence[str],
                texts: Sequence[str], seed: int,
                n_hidden_steps: int) -> Dict:
    eng_ref = build_engine(cfg, params, None)
    report: Dict[str, Dict] = {}
    for v in variants:
        eng_var = build_engine(cfg, params, v)
        report[v] = compare_variant(eng_ref, eng_var, texts, seed,
                                    n_hidden_steps)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_dir", default=None,
                    help="checkpoint dir (random weights if absent)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny geometry (CPU-runnable regression mode)")
    ap.add_argument("--variants", default="int8,int8-cp")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max_tokens", type=int, default=None)
    ap.add_argument("--hidden_steps", type=int, default=64,
                    help="greedy steps captured for the cos-sim trace")
    ap.add_argument("--texts", nargs="*", default=None)
    args = ap.parse_args(argv)

    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu.io import weights as weights_io

    if args.tiny:
        cfg = tiny_tts_config(max_tokens=args.max_tokens or 24)
    else:
        cfg = TTSConfig()
        if args.max_tokens:
            cfg = dataclasses.replace(cfg, max_tokens=args.max_tokens)
    cfg = greedy_config(cfg)
    params = weights_io.load_params(args.model_dir, cfg, jnp.bfloat16,
                                    seed=0)
    texts = args.texts or list(DEFAULT_TEXTS)
    variants = [v for v in args.variants.split(",") if v]
    n_hidden = min(args.hidden_steps, cfg.max_tokens)

    report = run_dossier(cfg, params, variants, texts, args.seed, n_hidden)

    hdr = (f"{'variant':10} {'tf_c0%':>7} {'tf_row%':>8} {'code0%':>7} "
           f"{'row%':>7} {'prefix%':>8} {'cos_min':>8} {'tf_cos':>8} "
           f"{'SNR dB':>8} {'i16%':>7}")
    print(hdr, file=sys.stderr)
    for v, a in report.items():
        snr = "inf" if np.isinf(a["snr_db_min"]) else f"{a['snr_db_min']:.1f}"
        print(f"{v:10} {100*a['tf_code0_agree']:6.1f}%"
              f" {100*a['tf_row_agree']:7.1f}%"
              f" {100*a['code0_agree']:6.1f}% {100*a['row_agree']:6.1f}%"
              f" {100*a['prefix_frac']:7.1f}% {a['hidden_cos_min']:8.5f}"
              f" {a['tf_cos_min']:8.5f} {snr:>8}"
              f" {100*a['int16_match']:6.1f}%", file=sys.stderr)

    out = {"geometry": "tiny" if args.tiny else "real",
           "weights": "checkpoint" if args.model_dir else "random",
           "seed": args.seed, "n_texts": len(texts)}
    for v, a in report.items():
        out[v] = {k: a[k] for k in
                  ("tf_code0_agree", "tf_row_agree", "tf_cos_min",
                   "code0_agree", "row_agree", "prefix_frac",
                   "hidden_cos_min", "hidden_cos_mean", "snr_db_min",
                   "int16_match", "len_match")}
    # JSON has no inf: encode as null (documented here; the table on
    # stderr shows "inf")
    print(json.dumps(out, default=str).replace("Infinity", "null"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
