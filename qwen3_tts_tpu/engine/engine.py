"""TTSEngine: the user-facing synthesis engine.

Replaces the reference's three socket servers + client orchestration
(components #1, #2, #5, #9 in SURVEY §2) with two jitted programs on one
chip:

  1. ``_generate``  — prefix build + talker prefill + the fused decode loop
                      (talker step + CP scan + feedback, engine/generate.py)
  2. ``_voc_chunk`` — fixed-shape FP32 vocoder chunk decode

plus host-side chunk orchestration (left-context chunking, the real
model's chunked-decode semantics) and WAV output.
Streaming mode dispatches vocoder chunks asynchronously (JAX async
dispatch) while the decode loop keeps running — the counterpart of the
reference's background vocoder threads (tts_client.py:189-197).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from qwen3_tts_tpu.config import (
    SAMPLE_RATE,
    SAMPLES_PER_TOKEN,
    SUPPORTED_LANGUAGES,
    VOC_CHUNK_SIZE,
    TTSConfig,
)
from qwen3_tts_tpu.engine import generate as gen
from qwen3_tts_tpu.io import wav as wav_io
from qwen3_tts_tpu.io import weights as weights_io
from qwen3_tts_tpu.io.tokenizer import load_tokenizer
from qwen3_tts_tpu.models import talker as tk
from qwen3_tts_tpu.models import vocoder as voc
from qwen3_tts_tpu.models import vocoder_stream as vstream
from qwen3_tts_tpu.ops import sampling as smp
from qwen3_tts_tpu.utils.compile_cache import enable_compile_cache
from qwen3_tts_tpu.utils.profiling import StageTimer


@dataclasses.dataclass
class SynthesisResult:
    audio_int16: np.ndarray           # mono 24 kHz
    codes: np.ndarray                 # (n_tokens, 16)
    n_tokens: int
    timings: Dict[str, float]
    total_seconds: float
    rtf: float
    first_audio_seconds: Optional[float] = None

    @property
    def audio_seconds(self) -> float:
        return len(self.audio_int16) / SAMPLE_RATE


# text-id pad buckets, shared by _bucket and _encode_text's KV-limit
# clamp (review finding: two inline copies could drift)
_TEXT_BUCKETS = (16, 32, 64, 128, 256)


def _bucket(n: int, buckets=_TEXT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _pacing_bound(budget_cap: int, n_text: int,
                  scfg: "SamplingConfig" = None) -> int:
    """Tightest known bound on generated tokens. For n_text > 0 the
    EOS-pacing force (progress > eos_force_progress, ops/sampling.py)
    guarantees n <= expected_tokens_per_text_token * eos_force_progress
    * n_text + 1 (6*n_text + 1 at the reference defaults); n_text == 0
    pins progress to 0 and disables pacing entirely, so only the budget
    bounds the decode — a 0*n+2 bound there would silently truncate
    audio. ONE definition shared by the chained non-streaming window and
    the streaming optimistic windows; the multiplier derives from the
    SamplingConfig so a non-default pacing policy cannot drift from the
    window sizing (review finding)."""
    if n_text <= 0:
        return budget_cap
    if scfg is None:
        mult = 6.0   # reference defaults: 3 tokens/text-token, force @ 2.0
    else:
        mult = (scfg.expected_tokens_per_text_token
                * scfg.eos_force_progress)
    import math
    return min(budget_cap, int(math.ceil(mult * n_text)) + 2)


def _chained_voc_window(budget_cap: int, n_text: int,
                        scfg: "SamplingConfig" = None) -> int:
    """Static vocoder window (tokens) for the chained non-streaming path:
    bucket of the pacing bound plus one zero-code lookahead token."""
    return voc.voc_bucket(_pacing_bound(budget_cap, n_text, scfg) + 1)


class TTSEngine:
    """Single-process TTS engine. ``model_dir=None`` runs with random
    weights (smoke/bench); pass an HF checkpoint dir for real synthesis."""

    def __init__(self, cfg: Optional[TTSConfig] = None,
                 model_dir: Optional[str] = None,
                 dtype=jnp.bfloat16, seed: int = 0,
                 params: Optional[Dict] = None,
                 quantize: Optional[str] = None,
                 mesh=None):
        """``mesh``: optional tensor-parallel ``jax.sharding.Mesh`` (dp
        extent must be 1 — the engine is the single-request LATENCY tier;
        dp batching belongs to ``ContinuousBatcher(mesh=...)``). Weights
        shard column/row-parallel over tp (parallel/mesh.py), the KV
        cache shards over kv heads, and the decode loop runs pure GSPMD,
        so the weight streaming that dominates the decode step splits
        across the tp devices. int8 stays available for the CP
        (``quantize='int8-cp'``, sharded int8 matmuls), while the fused
        int8 talker layout has no mesh sharding specs."""
        enable_compile_cache()
        self.mesh = mesh
        if mesh is not None:
            from qwen3_tts_tpu.parallel import mesh as pmesh
            if dict(mesh.shape).get(pmesh.DP, 1) != 1:
                raise ValueError(
                    f"TTSEngine mesh must be tensor-parallel only "
                    f"(dp=1), got {dict(mesh.shape)} — dp batching "
                    "belongs to ContinuousBatcher(mesh=...)")
            if quantize == "int8":
                raise ValueError(
                    "quantize='int8' uses the fused single-chip talker "
                    "layout (no mesh sharding specs); with a mesh use "
                    "quantize='int8-cp' or None")
        if cfg is None and model_dir is not None:
            # geometry from the checkpoint itself — any Qwen3-TTS-family
            # size loads without a hand-written config. Precedence
            # mirrors load_params: params.npz first (shapes from the
            # loaded bundle), then the safetensors header probe.
            npz = os.path.join(model_dir, "params.npz")
            if os.path.exists(npz):
                # the embedded __config__ is authoritative; older npz
                # files fall back to shape derivation (vocoder geometry
                # then assumed default)
                cfg = weights_io.read_npz_config(npz)
                if params is None:
                    params = weights_io.load_params(model_dir, TTSConfig(),
                                                    dtype, seed)
                if cfg is None:
                    cfg = weights_io.config_from_params(params)
            elif os.path.exists(os.path.join(model_dir,
                                             "model.safetensors")):
                cfg = weights_io.detect_tts_config(model_dir)
        self.cfg = cfg or TTSConfig()
        # shallow-copy caller-supplied params: quantize below REPLACES
        # component entries, and mutating the caller's dict in place would
        # silently hand other consumers the quantized weights (review
        # finding; ContinuousBatcher already copies the same way)
        self.params = (dict(params) if params is not None
                       else weights_io.load_params(model_dir, self.cfg,
                                                   dtype, seed))
        if quantize not in (None, "int8", "int8-cp"):
            raise ValueError(f"unsupported quantize={quantize!r}")
        from qwen3_tts_tpu.ops import quant as quant_ops

        # pre-quantized checkpoints (convert_weights.py --quantize) load
        # as QTensor trees: never re-quantize, just attach the per-layer
        # lists the decode hot paths index (the artifact stores only the
        # stacked arrays). Mirrors the reference's shipped-quantized
        # artifacts (GGUF Q4_K_M talker / GGML Q4_0 CP, README.md:82-90)
        # and halves the host->device weight bytes vs quantize-at-init.
        pre_t = quant_ops.is_quantized(self.params.get("talker", {}))
        pre_c = quant_ops.is_quantized(self.params.get("code_predictor",
                                                       {}))
        if pre_t or pre_c:
            if pre_t and (quantize == "int8-cp" or mesh is not None):
                # an explicit bf16-talker request (the batched/mesh tier
                # layout) against a fully-quantized artifact — or a mesh,
                # whose sharding specs don't cover the fused int8 talker
                # layout: honor it by dequantizing rather than silently
                # overriding to int8 (mirrors ContinuousBatcher's policy)
                import functools
                if mesh is not None and quantize != "int8-cp":
                    import sys as _sys
                    print("TTSEngine: pre-quantized talker -> dense "
                          f"{jnp.dtype(dtype).name} for the mesh tier "
                          "(the fused int8 layout has no mesh specs)",
                          file=_sys.stderr, flush=True)
                self.params["talker"] = jax.jit(functools.partial(
                    quant_ops.dequantize_talker, dtype=dtype))(
                        self.params["talker"])
                pre_t = False
            if pre_t:
                self.params["talker"] = jax.jit(
                    quant_ops.attach_layer_list)(self.params["talker"])
            if pre_c:
                self.params["code_predictor"] = jax.jit(
                    quant_ops.attach_layer_list)(
                        self.params["code_predictor"])
            if not pre_t and quantize == "int8":
                # CP-only artifact but the caller wants the full int8
                # engine tier: quantize the (still-bf16) talker at init
                self.params["talker"] = jax.jit(quant_ops.quantize_talker)(
                    self.params["talker"])
                pre_t = True
            if not pre_c and quantize in ("int8", "int8-cp"):
                # talker-only artifact but the caller asked for the int8
                # CP kernel tier: quantize the (still-dense) CP at init
                self.params["code_predictor"] = jax.jit(
                    quant_ops.quantize_code_predictor)(
                        self.params["code_predictor"])
                pre_c = True
            # report the ACTUAL post-init state: a talker-only artifact
            # loaded with quantize=None keeps its dense CP, and the label
            # must say so (downstream kernels key off QTensor presence,
            # but tools/operators read this field)
            quantize = ("int8" if pre_t and pre_c
                        else "int8-cp" if pre_c
                        else "int8-talker")
        elif quantize in ("int8", "int8-cp"):
            # weight-only int8 (the reference's GGUF Q4_K_M / Q4_0 tier;
            # vocoder stays FP32 — ops/quant.py). "int8-cp" quantizes only
            # the code predictor and keeps the talker bf16.

            # jit each quantizer: un-jitted, the per-tensor quantize math
            # plus the 28-layer layers_list slicing issues ~300 small
            # dispatches; jitted it is ONE compiled program per component
            # (kept by the persistent compile cache)
            if quantize == "int8":
                self.params["talker"] = jax.jit(quant_ops.quantize_talker)(
                    self.params["talker"])
            self.params["code_predictor"] = jax.jit(
                quant_ops.quantize_code_predictor)(
                    self.params["code_predictor"])
        self.quantize = quantize
        self._state_shardings = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            from qwen3_tts_tpu.parallel import mesh as pmesh
            core = {k: self.params[k]
                    for k in ("talker", "code_predictor", "vocoder")
                    if k in self.params}
            self.params.update(pmesh.shard_params(mesh, core))
            self._state_shardings = jax.tree.map(
                lambda sp: NamedSharding(mesh, sp),
                pmesh.gen_state_spec(self.cfg),
                is_leaf=lambda x: isinstance(x, PartitionSpec))
        self.tokenizer = load_tokenizer(model_dir)

        c = self.cfg

        def _voc_fn(vp, codes):
            # int16 conversion ON DEVICE: halves the audio d2h transfer
            # (0.5 MB -> 0.25 MB per 64-token window); same values as voc.to_int16 (which passes int16 through)
            return voc.to_int16_device(voc.decode(vp, codes, c.vocoder))

        self._voc_chunk = jax.jit(_voc_fn)

        # streaming emission schedule: small head chunks so first audio
        # lands fast (target < 300 ms, BASELINE.md), then steady-state
        # 64-token chunks like the reference client (tts_client.py:31,
        # 189-197). ONE compiled decode program serves every chunk size —
        # the step budget is a runtime scalar feeding only the while_loop
        # condition — so non-streaming runs whole utterances in a single
        # invocation and streaming pays no extra compiles. The vocoder
        # likewise runs a single fixed [1, 64, 16] program; short head
        # chunks are padded.
        self._init_state = jax.jit(
            lambda tp, text_ids, n_text, key: self._mk_state(
                tp, text_ids, n_text, key))
        self._init_state_cloned = jax.jit(self._mk_state_cloned)
        # (8, 56): first audio after 8 tokens (0.64 s of playout), one
        # more chunk to bank ~5 s of headroom, then phase 2 finishes the
        # utterance in a single invocation (each invocation pays a
        # dispatch and a host round trip)
        self.head_schedule = (8, 56)
        # ONE program, dynamic step budget (see gen.run_steps docstring)
        self._run_chunk = jax.jit(
            lambda tp, cpp, s, n: gen.run_steps(tp, cpp, s, c, n))

        # fused prefill+decode for cache-miss non-streaming synthesis: one
        # program invocation for the whole utterance instead of a prefill
        # invocation, a host round-trip, then a decode invocation. Also
        # returns the post-prefill state so the prefix cache still works.
        def _prefill_decode_fn(tp, cpp, text_ids, n_text, key, budget):
            st0 = self._mk_state(tp, text_ids, n_text, key)
            st1 = gen.run_steps(tp, cpp, st0, c, budget)
            return st0, st1

        # budget is a runtime scalar, so ONE compiled program serves both
        # the non-streaming whole-utterance run and streaming's first
        # head chunk
        self._prefill_decode = jax.jit(_prefill_decode_fn)

        # chained vocoder dispatch for non-streaming: right after the
        # decode program is dispatched, the vocoder is dispatched on the
        # DEVICE codes buffer (statically padded to W =
        # bucket(budget_cap+1)) — no intermediate host fetch. The decode
        # program completes first, so the (n, codes) round trip then
        # overlaps the vocoder's device execution instead of serializing
        # ahead of its dispatch. The audio d2h fetches the full static-W
        # window via copy_to_host_async in one burst with the n/codes
        # transfers (a device-side bucket(n+1) slice measured FASTER when
        # fetches were sequential, but loses to the overlapped burst,
        # which needs no slice dispatch). Causality over the zero rows
        # past n makes audio[:n] identical to a separately-sized bucketed
        # decode. A fully-fused single-program variant (vocoder inside
        # the decode jit) was measured SLOWER in a same-window A/B
        # (0.0524 vs 0.0504): one program forces the status fetch to wait
        # for the vocoder leg; the chain keeps the overlap.
        self._voc_pad = jax.jit(
            lambda vp, codes, W: _voc_fn(vp, voc.pad_codes(codes, W)),
            static_argnames=("W",))
        # incremental streaming emissions (models/vocoder_stream.py) —
        # the default engine streaming path since r5 (VERDICT r4 #8);
        # the same fixed-size step programs the batched tier uses
        self._stream_stepper = vstream.StreamStepper(c.vocoder)
        self._chained_vocode = (
            os.environ.get("QWEN3_TTS_FUSED_VOCODER", "1") != "0")

        # prefix KV cache: the counterpart of the reference's disk-persisted
        # talker KV state keyed by prefix hash
        # (llamacpp_talker_server.py:208-246) — post-prefill states are kept
        # on device, keyed by (text ids, length), LRU-bounded. Optionally
        # also persisted to disk (md5-keyed npz like the reference's
        # qwen3_kv_{hash}.bin).
        self._prefix_cache: Dict = {}
        self._prefix_cache_cap = 4
        self.kv_cache_dir: Optional[str] = None


    def _constrain(self, state):
        """On a mesh, pin the loop state to its GSPMD shardings (KV over
        kv heads/tp; batch dims trivially over the size-1 dp axis)."""
        if self._state_shardings is None:
            return state
        return jax.lax.with_sharding_constraint(state,
                                                self._state_shardings)

    def _mk_state(self, tp, text_ids, n_text, key):
        prefix, plen = tk.build_prefix(tp, text_ids, n_text)
        prefix = prefix.astype(tp["codec_embedding"].dtype)
        return self._constrain(
            gen.init_state(tp, prefix[None], plen[None], n_text[None],
                           key, self.cfg))

    def _mk_state_cloned(self, tp, cp_embs, text_ids, n_text, n_target,
                         ref_codes, n_ref, key):
        """Voice-cloning prefill: concatenated ref+target text plus the
        reference codec frames as continuation rows
        (models/talker.build_prefix_cloned). EOS pacing (n_text in the
        loop state) uses the TARGET text length only — the generated
        audio covers the target text, not the reference transcript."""
        prefix, plen = tk.build_prefix_cloned(
            tp, cp_embs, text_ids, n_text, ref_codes, n_ref)
        prefix = prefix.astype(tp["codec_embedding"].dtype)
        return self._constrain(
            gen.init_state(tp, prefix[None], plen[None], n_target[None],
                           key, self.cfg))

    def _load_prompt(self, prompt_dir: str):
        """Load a voice-cloning prompt_dir (ref_codec_tokens.npy +
        optional ref_text.txt — the format tools/encode_reference_audio.py
        writes, mirroring the reference's prep script)."""
        try:
            codes = np.load(os.path.join(prompt_dir, "ref_codec_tokens.npy"))
            codes = np.asarray(codes, np.int32)[:, :16]
        except Exception as e:
            # self-identifying message: serving tiers classify
            # "prompt_dir" errors as client-fixable (bad voice), not
            # server faults
            raise ValueError(f"invalid prompt_dir {prompt_dir!r}: {e}") from e
        txt_path = os.path.join(prompt_dir, "ref_text.txt")
        ref_text = ""
        if os.path.exists(txt_path):
            with open(txt_path) as f:
                ref_text = f.read().strip()
        return codes, ref_text

    def _prefill_cloned(self, tp, text_ids, n_text, n_target,
                        ref_codes_np, key):
        """Bucket the ref frames, clamp to the KV allocation, prefill with
        LRU reuse keyed on (text, ref codes)."""
        S = self.cfg.talker.max_seq_len
        text_pad = int(text_ids.shape[0])
        limit = tk.cloned_ref_limit(S, text_pad)
        padded, n_ref = tk.bucket_ref_frames(limit, ref_codes_np)
        if n_ref < len(ref_codes_np):
            print(f"warning: reference audio truncated to {n_ref} frames "
                  f"(max_seq_len={S})", file=sys.stderr)

        cp_embs = self.params["code_predictor"]["codec_embs"]
        # n_target is baked into the cached state's EOS pacing, so it must
        # be part of the key (same full text + ref codes with a different
        # ref/target split is a different state)
        k = (tuple(np.asarray(text_ids).tolist()), int(n_text),
             int(n_target), padded.tobytes(), int(n_ref))
        hit = self._cache_get(k, key)
        if hit is not None:
            return hit
        state = self._init_state_cloned(
            tp, cp_embs, text_ids, n_text, jnp.int32(n_target),
            jnp.asarray(padded), jnp.int32(n_ref), key)
        self._cache_put(k, state)
        return state

    # -- prefix-state LRU (shared by the plain and cloned paths) -------
    def _cache_get(self, k, key):
        hit = self._prefix_cache.pop(k, None)
        if hit is not None:
            self._prefix_cache[k] = hit  # refresh LRU order
            return hit._replace(key=gen.batch_keys(key, hit.key.shape[0]))
        return None

    def _cache_put(self, k, state) -> None:
        self._prefix_cache[k] = state
        while len(self._prefix_cache) > self._prefix_cache_cap:
            self._prefix_cache.pop(next(iter(self._prefix_cache)))

    # ------------------------------------------------------------------
    def _maybe_cached_prefill(self, tp, text_ids, n_text, key):
        """Prefill with prefix-state reuse.

        Port of the reference's KV persistence (llamacpp_talker_server.py:
        208-246: prefill state keyed by md5 of the prefix, restored on
        repeat requests). Here the post-prefill GenState lives on device,
        keyed by the exact (text_ids, n_text); LRU-bounded.
        """
        k = (tuple(np.asarray(text_ids).tolist()), int(n_text))
        hit = self._cache_get(k, key)
        if hit is not None:
            return hit
        state = None
        disk_path = None
        if self.kv_cache_dir is not None:
            import hashlib
            h = hashlib.md5(np.asarray(text_ids).tobytes()
                            + str(int(n_text)).encode()).hexdigest()[:16]
            disk_path = os.path.join(self.kv_cache_dir, f"qwen3_kv_{h}.npz")
            if os.path.exists(disk_path):
                try:
                    state = self._load_state_npz(disk_path, key)
                    disk_path = None  # no need to re-save
                except Exception:
                    state = None
        if state is None:
            state = self._init_state(tp, text_ids, n_text, key)
            if disk_path is not None:
                try:
                    self._save_state_npz(disk_path, state)
                except Exception:
                    pass
        self._cache_put(k, state)
        return state

    def _save_state_npz(self, path: str, state) -> None:
        """Persist a post-prefill GenState (reference: llama_state_save_file
        + hidden .npy, llama_wrapper.c:84-109)."""
        flat = {}
        for f in state._fields:
            a = np.asarray(jax.device_get(getattr(state, f)))
            if a.dtype.name == "bfloat16":  # npz has no bf16; round-trip f32
                a = a.astype(np.float32)
            flat[f] = a
        np.savez(path, **flat)

    def _load_state_npz(self, path: str, key):
        data = np.load(path)
        kwargs = {f: jnp.asarray(data[f]) for f in gen.GenState._fields
                  if f != "key" and f in data.files}
        if "budget" not in kwargs:  # pre-budget cache files
            B = kwargs["pos"].shape[0]
            kwargs["budget"] = jnp.full((B,), self.cfg.max_tokens, jnp.int32)
        kwargs["key"] = gen.batch_keys(key, kwargs["kv"].shape[2])
        # restore dtypes that numpy round-trips lose (bf16 saved as f32?)
        ref_dtype = self.params["talker"]["codec_embedding"].dtype
        kwargs["kv"] = kwargs["kv"].astype(ref_dtype)
        kwargs["hidden"] = kwargs["hidden"].astype(ref_dtype)
        return gen.GenState(**kwargs)

    def _decode_pipelined(self, tp, cpp, state, budget: Optional[int] = None):
        """Run the decode to completion in ONE program invocation (the
        while_loop exits on EOS; the step budget is a runtime scalar)."""
        state = self._run_chunk(
            tp, cpp, state,
            jnp.int32(self.cfg.max_tokens if budget is None else budget))
        return state

    def _encode_text(self, text: str):
        ids = self.tokenizer.encode(text, add_special_tokens=False)
        n = len(ids)
        # the padded prefix (bucket + PREFIX_EXTRA positions) must fit the
        # KV allocation; over-long text is truncated (with a warning)
        # rather than crashing prefill with a shape error
        from qwen3_tts_tpu.models.talker import PREFIX_EXTRA
        limit = self.cfg.talker.max_seq_len - PREFIX_EXTRA
        b = _bucket(n)
        if b > limit:
            fits = [bk for bk in _TEXT_BUCKETS if bk <= limit]
            b = fits[-1] if fits else max(limit, 1)
        if n > b:
            # covers both the KV-limit clamp above and the largest-bucket
            # (256) cap inside _bucket — never truncate silently
            print(f"warning: text truncated to {b} of {n} tokens "
                  f"(max_seq_len={self.cfg.talker.max_seq_len}); use "
                  f"synthesize_long / --long for paragraph-length text",
                  file=sys.stderr)
        padded = np.zeros((b,), np.int32)
        padded[:n] = ids[:b]
        return jnp.asarray(padded), jnp.int32(min(n, b))

    def _text_cap(self) -> int:
        """Largest usable text-token bucket (same clamp as _encode_text):
        the bound long-mode piece budgets must respect."""
        from qwen3_tts_tpu.models.talker import PREFIX_EXTRA
        limit = self.cfg.talker.max_seq_len - PREFIX_EXTRA
        fits = [bk for bk in _TEXT_BUCKETS if bk <= limit]
        return fits[-1] if fits else max(limit, 1)

    def _encode_cloned(self, text: str, ref_text: str):
        """Tokenize a voice-cloned request: ids over ``ref_text + ' ' +
        text`` (the in-context conditioning layout,
        models/talker.build_prefix_cloned), pacing target = the TARGET
        text's own token count. ONE implementation shared by
        engine.synthesize and both daemon batched tiers.

        Raises ValueError when the combined text overflows the prefix
        bucket: _encode_text keeps the HEAD on overflow (the ref
        transcript), so silent truncation would cut the *target* tail
        while EOS pacing still budgets for it — the request would return
        audio that never speaks most of the target with no client-visible
        signal (review finding). Returns (ids, n_text, n_target)."""
        full = (ref_text + " " + text).strip() if ref_text else text
        text_ids, n_text = self._encode_text(full)
        n_full = len(self.tokenizer.encode(full, add_special_tokens=False))
        if n_full > int(n_text):
            raise ValueError(
                f"voice-cloned text overflows the prefix: reference "
                f"transcript + target encode to {n_full} tokens but the "
                f"prefix holds {int(n_text)} "
                f"(max_seq_len={self.cfg.talker.max_seq_len}); shorten "
                f"the reference transcript or use synthesize_long/--long")
        n_target = min(len(self.tokenizer.encode(
            text, add_special_tokens=False)), int(n_text))
        return text_ids, n_text, n_target

    def _cloned_piece_budget(self, budget: int, ref_text: str) -> int:
        """Tighten a long-mode piece budget so ref transcript + piece fit
        the text bucket (margin 2: separator + BPE boundary effects; a
        residual overflow still fails loudly in _encode_cloned). Raises
        when the transcript alone leaves no room — every piece would
        fail, so fail once with the real cause."""
        n_ref = len(self.tokenizer.encode(ref_text,
                                          add_special_tokens=False))
        room = self._text_cap() - n_ref - 2
        if room < 2:
            raise ValueError(
                f"reference transcript is too long for voice cloning: "
                f"{n_ref} tokens of a {self._text_cap()}-token prefix "
                f"budget; re-encode the prompt with a shorter ref_text")
        return max(2, min(budget, room))

    def synthesize(self, text: str, language: str = "russian",
                   output: Optional[str] = None, streaming: bool = False,
                   seed: int = 0,
                   prompt_dir: Optional[str] = None,
                   max_tokens: Optional[int] = None,
                   on_chunk=None) -> SynthesisResult:
        """Full pipeline: text -> codes -> audio. Mirrors
        Qwen3TTSClient.synthesize (tts_client.py:110-271).

        ``language`` is validated against the supported set; as in the
        reference it does not alter prefix construction
        (llamacpp_talker_server.py:121 accepts-but-ignores it).

        ``prompt_dir``: voice-cloning prompt produced by
        tools/encode_reference_audio.py (ref codec tokens + transcript);
        the reference speaker's frames condition the decode in-context
        (models/talker.build_prefix_cloned).

        ``max_tokens``: per-request generation cap, clamped to the
        compiled ``cfg.max_tokens``. The step budget is a runtime scalar,
        so this reuses the same compiled programs (the reference's
        MAX_TOKENS env var, launch_qwen3_tts.sh:32, but per request).

        ``on_chunk``: streaming only — called with each np.int16 audio
        chunk as soon as it is rendered (daemon chunked-response framing;
        the reference's streaming is process-internal, tts_client.py:
        189-197, so this is a capability extension).
        """
        if language not in SUPPORTED_LANGUAGES:
            raise ValueError(
                f"unsupported language {language!r}; expected one of "
                f"{SUPPORTED_LANGUAGES}")
        budget_cap = self.cfg.max_tokens
        if max_tokens is not None:
            if max_tokens < 1:
                raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
            budget_cap = min(int(max_tokens), budget_cap)

        timer = StageTimer()
        # host-side key: no eager device dispatch per request
        key = smp.host_prng_key(seed)
        tp = self.params["talker"]
        cpp = self.params["code_predictor"]
        vp = self.params["vocoder"]

        with timer.stage("tokenize"):
            prompt = None
            if prompt_dir is not None:
                ref_codes_np, ref_text = self._load_prompt(prompt_dir)
                text_ids, n_text, n_target = self._encode_cloned(text,
                                                                 ref_text)
                prompt = (ref_codes_np, n_target)
            else:
                text_ids, n_text = self._encode_text(text)
            # host copy, fetched while the device queue is empty (a
            # device_get later in the stream path would pay a round trip
            # mid-pipeline)
            n_text_i = int(n_text)
            # the DEVICE paces EOS on the TARGET token count for cloned
            # requests (init_state_cloned gets prompt[1], not the full
            # ref+target count) — window bounds must use the same number:
            # sizing from n_text_i would under-provision when a 0-token
            # target disables pacing entirely (review finding), and
            # over-provision when the target is much shorter than the ref
            pace_n = n_text_i if prompt is None else int(prompt[1])

        def _prefill(k):
            if prompt is None:
                return self._maybe_cached_prefill(tp, text_ids, n_text, k)
            return self._prefill_cloned(tp, text_ids, n_text, prompt[1],
                                        prompt[0], k)

        def _prefill_fused(k, budget):
            """Prefill + first decode budget in ONE invocation when the
            plain-path prefix cache misses; returns (post-prefill snapshot
            or None, advanced state). Falls back to the two-step path on
            cache hits / prompts / disk-cache mode."""
            cache_key = (tuple(np.asarray(text_ids).tolist()), int(n_text))
            if (prompt is None and self.kv_cache_dir is None
                    and cache_key not in self._prefix_cache):
                st0, st = self._prefill_decode(tp, cpp, text_ids, n_text,
                                               k, budget)
                self._cache_put(cache_key, st0)
                return st0, st
            return None, _prefill(k)

        first_audio_t: Optional[float] = None
        t_start = time.perf_counter()

        # the chain is gated on the WINDOW, not the raw budget: the
        # window is bounded by the EOS-pacing cap (force at progress >
        # 2.0 guarantees n <= 6*n_text + 1), so a short text under a
        # large max_tokens config still gets the chained fast path
        # (gating on budget_cap <= 256 disabled it there — review
        # finding); windows past the largest bucket would compile a
        # fresh vocoder program per 64-aligned width, so those fall back
        # to the fetch-then-chunk path.
        chained_W = _chained_voc_window(budget_cap, pace_n,
                                        self.cfg.sampling)
        if (not streaming and self._chained_vocode
                and chained_W <= voc.VOC_BUCKETS[-1]):
            # chained dispatch (see __init__): decode program, then the
            # vocoder immediately on the device codes; the status/codes
            # round trips overlap the vocoder's execution.
            with timer.stage("decode+vocoder"):
                W = chained_W
                st0, state = _prefill_fused(key, jnp.int32(budget_cap))
                if st0 is None:  # cache hit / prompt / disk path
                    state = self._decode_pipelined(tp, cpp, state,
                                                   budget_cap)
                audio_dev = self._voc_pad(vp, state.codes, W=W)
                # start all three d2h transfers together: the n/codes
                # round trips and the full static-W audio window ride one
                # overlapped burst instead of three sequential RTTs (the
                # W-vs-bucket(n+1) overfetch is ~1 MB of int16, in place
                # of the extra round trip a device-side slice would cost)
                for arr in (state.n_codes, state.codes, audio_dev):
                    arr.copy_to_host_async()
                n = int(jax.device_get(state.n_codes)[0])
                codes_np = np.asarray(jax.device_get(state.codes))[0][:n]
                audio = np.asarray(jax.device_get(
                    audio_dev))[0][:n * SAMPLES_PER_TOKEN]
                if n > 0:
                    first_audio_t = time.perf_counter() - t_start
        elif not streaming:
            with timer.stage("decode"):
                st0, state = _prefill_fused(key, jnp.int32(budget_cap))
                if st0 is None:  # two-step path (cache hit / prompt / disk)
                    state = self._decode_pipelined(tp, cpp, state,
                                                   budget_cap)
                state.n_codes.copy_to_host_async()
                state.codes.copy_to_host_async()
                n = int(jax.device_get(state.n_codes)[0])
                codes_np = np.asarray(jax.device_get(state.codes))[0][:n]
            with timer.stage("vocoder"):
                # <= 256 tokens: ONE bucketed invocation (full attention
                # context, no chunk boundaries; bucket strictly > n so the
                # tail token always has >= 1 zero-code lookahead token —
                # round-2 advisor finding); longer utterances use
                # conv-exact left-context chunking.
                audio = voc.synthesize_exact(
                    lambda ch: self._voc_chunk(vp, jnp.asarray(ch)),
                    codes_np)
                if n > 0:
                    first_audio_t = time.perf_counter() - t_start
        elif os.environ.get("QWEN3_TTS_ENGINE_STREAM",
                            "window") == "window":
            # DEFAULT engine streaming: decode the head in small quanta,
            # then finish in one invocation; every emission decodes a
            # PREFIX window of the codes buffer ([0:W), full left
            # context) and keeps only the new samples, with one decoded
            # token held back as real conv lookahead — equal to the
            # non-streaming decode (bit for bit on the CPU; within one
            # int16 step on a GPU, whose conv algorithm differs per window
            # shape; docs/PARITY.md), at O(end) vocoder work per
            # emission. Engine utterances are bounded (<= 256 tokens), so
            # O(end) vocoder FLOPs stay cheap; the incremental-stream path
            # below (QWEN3_TTS_ENGINE_STREAM=incremental) pays more
            # dispatches per emission. Which is faster on a GPU is not
            # measured yet (tools/dev/bench_engine_stream_ab.py).
            with timer.stage("prefill"):
                # first head budget fuses with prefill on cache misses
                # (same compiled program — the budget is a runtime scalar)
                st0, state = _prefill_fused(
                    key, jnp.int32(min(self.head_schedule[0], budget_cap)))
                fused_first = st0 is not None
            pending: List[tuple] = []  # (future, start_token, size)
            chunks: List[np.ndarray] = []   # trimmed audio, in order
            rendered = 0      # tokens whose audio has been dispatched
            decoded = 0       # decode budget consumed (optimistic count)
            flushed = 0       # pending entries already fetched/emitted
            T_buf = int(state.codes.shape[1])

            def _flush(n_known: int) -> None:
                """Fetch dispatched windows in order, keep each one's new
                samples ([start, start+size) tokens, trimmed to the now
                known token count), hand them to ``on_chunk``."""
                nonlocal flushed, first_audio_t
                while flushed < len(pending):
                    fut, start, size = pending[flushed]
                    flushed += 1
                    keep = min(size, max(n_known - start, 0))
                    if keep <= 0:
                        continue
                    a = np.asarray(jax.device_get(fut))[0]
                    a = a[start * SAMPLES_PER_TOKEN:
                          (start + keep) * SAMPLES_PER_TOKEN]
                    chunks.append(a)
                    if first_audio_t is None and len(a) > 0:
                        # covers paths where no phase-1 window blocked on
                        # a fetch (e.g. max_tokens=1: the only audio
                        # arrives via the host-window remainder)
                        first_audio_t = time.perf_counter() - t_start
                    if on_chunk is not None:
                        on_chunk(voc.to_int16(a))

            with timer.stage("decode+vocoder"):
                # Phase 1 — head chunks: small budgets so the first audio
                # lands early. Each quantum costs a program invocation and
                # a host round trip, so only the head runs chunked.
                done = False
                for ci, budget in enumerate(self.head_schedule):
                    budget = min(budget, budget_cap - decoded)
                    if budget <= 0:
                        break
                    if not (ci == 0 and fused_first):
                        state = self._run_chunk(tp, cpp, state,
                                                jnp.int32(budget))
                    decoded += budget
                    # optimistic emission: dispatch the window immediately
                    # (device-value prefix slice; rows past the true token
                    # count are zero — never written). Token decoded-1 is
                    # held back as lookahead so the kept samples are exact
                    # even though the NEXT token isn't generated yet; if
                    # EOS already landed, the zero rows make the kept
                    # samples exactly the final decode's. The status fetch
                    # below then overlaps the vocoder run.
                    end = decoded - 1
                    if end > rendered:
                        W = min(voc.voc_bucket(decoded), T_buf)
                        fut = self._voc_chunk(vp, state.codes[:, :W])
                        pending.append((fut, rendered, end - rendered))
                        rendered = end
                        if first_audio_t is None:
                            np.asarray(jax.device_get(fut))
                            first_audio_t = time.perf_counter() - t_start
                    if on_chunk is not None:
                        # chunked daemon responses: emit as soon as the
                        # chunk's true extent is known (a non-done slot
                        # produced exactly its budget; trimmed to n_codes
                        # on EOS)
                        state.done.copy_to_host_async()
                        state.n_codes.copy_to_host_async()
                        done = bool(jax.device_get(state.done)[0])
                        n_now = (int(jax.device_get(state.n_codes)[0])
                                 if done else decoded)
                        _flush(min(n_now, rendered))
                        if done:
                            break
                    # with no chunk consumer, skip the blocking done-fetch
                    # entirely: the decode chain dispatches back-to-back
                    # (async), and an already-finished utterance makes the
                    # next invocation a no-op while_loop — cheaper than a
                    # host round trip per head chunk
                # Phase 2 — the head bought ~5 s of playout headroom
                # (64 tokens of audio vs ~0.5 s of decode): finish the
                # whole utterance in ONE invocation, then dispatch the
                # tail's 64-token-paced windows OPTIMISTICALLY on the
                # device codes (bounded by the EOS-pacing cap: the force
                # at progress > 2.0 guarantees n <= 6*n_text + 1), so the
                # blocking n/codes fetch overlaps the tail vocoding. The
                # flush trims each window to the true count; overshoot
                # windows are skipped without a fetch. After the slot is
                # done, rows past n are zero on device, so every kept
                # sample equals the final decode.
                if not done:
                    if decoded < budget_cap:
                        state = self._run_chunk(
                            tp, cpp, state, jnp.int32(budget_cap - decoded))
                    bound = _pacing_bound(budget_cap, pace_n,
                                          self.cfg.sampling)
                    while rendered < min(bound, T_buf) - 1:
                        end = min(rendered + VOC_CHUNK_SIZE, bound - 1,
                                  T_buf - 1)
                        W = min(voc.voc_bucket(end + 1), T_buf)
                        fut = self._voc_chunk(vp, state.codes[:, :W])
                        pending.append((fut, rendered, end - rendered))
                        rendered = end
                # start every remaining d2h transfer together (status,
                # codes, and all dispatched windows) so the fetch tail is
                # one overlapped burst, not len(pending)+2 sequential
                # round trips; overshoot windows waste a transfer but the
                # flush still skips them without blocking
                state.n_codes.copy_to_host_async()
                state.codes.copy_to_host_async()
                for fut_, _, _ in pending[flushed:]:
                    fut_.copy_to_host_async()
                n = int(jax.device_get(state.n_codes)[0])
                codes_np = np.asarray(jax.device_get(state.codes))[0][:n]
                # rare remainder (n at the optimistic bound, or EOS known
                # early in on_chunk mode): host windows with the zero-code
                # lookahead rows past the device buffer
                while rendered < n:
                    end = min(rendered + VOC_CHUNK_SIZE, n)
                    W = voc.voc_bucket(end + 1)
                    buf = np.zeros((1, W, 16), np.int32)
                    m = min(W, n)
                    buf[0, :m] = codes_np[:m]
                    fut = self._voc_chunk(vp, jnp.asarray(buf))
                    pending.append((fut, rendered, end - rendered))
                    rendered = end
                # gather + trim remaining emissions against the true count
                _flush(n)
                audio = (np.concatenate(chunks) if chunks
                         else np.zeros((0,), np.float32))
        else:
            # QWEN3_TTS_ENGINE_STREAM=incremental: decode the head in
            # small quanta so first audio lands fast, then finish in one
            # invocation — with emissions riding the INCREMENTAL vocoder
            # stream (models/vocoder_stream.py, O(new tokens) per
            # emission; round 4 built it for the batched tier, round 5
            # made the engine able to ride it — VERDICT r4 #8). The
            # internal output_crop-sample lag replaces the old
            # one-real-token window lookahead, and a finished utterance
            # flushes through >= 1 zero-code frame, so every kept sample
            # equals the non-streaming decode within the stream contract
            # (float <= 1e-6; int16 +-1 LSB on < 0.01% of samples —
            # docs/PARITY.md).
            with timer.stage("prefill"):
                st0, state = _prefill_fused(
                    key, jnp.int32(min(self.head_schedule[0], budget_cap)))
                fused_first = st0 is not None
            stepper = self._stream_stepper
            U = SAMPLES_PER_TOKEN
            crop = self.cfg.vocoder.output_crop
            sstate = vstream.init_stream_state(self.cfg.vocoder)
            primed = False
            pending: List[tuple] = []   # (future, start_sample, out_len)
            chunks: List[np.ndarray] = []
            rendered = 0        # frames fed to the stream
            planned = 0         # samples dispatched (pre-trim)
            decoded = 0
            flushed = 0
            T_buf = int(state.codes.shape[1])

            def _advance(n_frames: int, overshoot: bool) -> None:
                """Dispatch stream steps over the next ``n_frames`` new
                frames of the device codes row (steps chain on device —
                no host fetch here)."""
                nonlocal rendered, planned, primed, sstate
                row = state.codes[0]
                for c in stepper.plan_quanta(n_frames, overshoot):
                    fut, sstate = stepper.step_fn(c, primed)(
                        self.params["vocoder"], row,
                        jnp.int32(rendered), sstate)
                    out_len = c * U - (0 if primed else crop)
                    primed = True
                    pending.append((fut, planned, out_len))
                    rendered += c
                    planned += out_len

            def _flush(n_known: int) -> None:
                """Fetch dispatched steps in order, trimming each one's
                samples to the now-known token count (overshoot steps
                past the utterance end fetch but keep nothing)."""
                nonlocal flushed, first_audio_t
                while flushed < len(pending):
                    fut, start_s, out_len = pending[flushed]
                    flushed += 1
                    keep = min(out_len, max(n_known * U - start_s, 0))
                    if keep <= 0:
                        continue
                    a = np.asarray(jax.device_get(fut))[0][:keep]
                    chunks.append(a)
                    if first_audio_t is None and len(a) > 0:
                        first_audio_t = time.perf_counter() - t_start
                    if on_chunk is not None:
                        on_chunk(a)     # already int16 (device-converted)

            with timer.stage("decode+vocoder"):
                done = False
                for ci, budget in enumerate(self.head_schedule):
                    budget = min(budget, budget_cap - decoded)
                    if budget <= 0:
                        break
                    if not (ci == 0 and fused_first):
                        state = self._run_chunk(tp, cpp, state,
                                                jnp.int32(budget))
                    decoded += budget
                    if on_chunk is not None:
                        state.done.copy_to_host_async()
                        state.n_codes.copy_to_host_async()
                        done = bool(jax.device_get(state.done)[0])
                        n_now = (int(jax.device_get(state.n_codes)[0])
                                 if done else decoded)
                        if done:
                            if rendered < n_now + 1:
                                # final frames + the lag-flushing
                                # zero-code lookahead
                                _advance(n_now + 1 - rendered, True)
                            _flush(n_now)
                            break
                        if n_now - rendered >= min(stepper.SIZES):
                            _advance(n_now - rendered, False)
                            _flush(n_now)
                    else:
                        # no chunk consumer: dispatch optimistically with
                        # NO status round trips — frames <= decoded are
                        # final unless EOS fired mid-chunk, and the final
                        # _flush(n) trims those away
                        if decoded - rendered >= min(stepper.SIZES):
                            _advance(decoded - rendered, False)
                        if first_audio_t is None and pending:
                            np.asarray(jax.device_get(pending[0][0]))
                            first_audio_t = (time.perf_counter()
                                             - t_start)
                if not done:
                    if decoded < budget_cap:
                        state = self._run_chunk(
                            tp, cpp, state, jnp.int32(budget_cap - decoded))
                    # cover every possibly-final frame + 1 flush frame
                    # BEFORE the blocking n fetch (bounded by the
                    # EOS-pacing cap): the steps chain on device values,
                    # so the fetch overlaps their execution; overshoot
                    # past the true n trims at flush
                    bound = _pacing_bound(budget_cap, pace_n,
                                          self.cfg.sampling)
                    horizon = min(bound, T_buf)
                    if rendered < horizon + 1:
                        _advance(horizon + 1 - rendered, True)
                # one overlapped d2h burst for status, codes, and every
                # unfetched emission
                state.n_codes.copy_to_host_async()
                state.codes.copy_to_host_async()
                for fut_, _, _ in pending[flushed:]:
                    fut_.copy_to_host_async()
                n = int(jax.device_get(state.n_codes)[0])
                codes_np = np.asarray(jax.device_get(state.codes))[0][:n]
                if rendered < n + 1:
                    _advance(n + 1 - rendered, True)   # rare remainder
                _flush(n)
                audio = (np.concatenate(chunks) if chunks
                         else np.zeros((0,), np.int16))

        audio_i16 = voc.to_int16(audio)
        total = timer.total()
        audio_dur = len(audio_i16) / SAMPLE_RATE
        result = SynthesisResult(
            audio_int16=audio_i16,
            codes=codes_np if n > 0 else np.zeros((0, 16), np.int32),
            n_tokens=n,
            timings=dict(timer.stages),
            total_seconds=total,
            rtf=(total / audio_dur) if audio_dur > 0 else float("inf"),
            # a zero-token utterance emitted no audio even if the
            # streaming path dispatched (and timed) an optimistic first
            # window — mirror the non-streaming branches' n > 0 guard
            first_audio_seconds=first_audio_t if n > 0 else None,
        )
        if output is not None and len(audio_i16) > 0:
            wav_io.write_wav(output, audio_i16)
        return result

    def synthesize_batch(self, texts, languages=None, seed: int = 0,
                         max_tokens: Optional[int] = None):
        """Batched multi-request decode: all texts run in ONE batched fused
        loop (the multi-language batch config — e.g. one
        sentence per supported language in a single program), then the
        vocoder renders each stream. ``max_tokens`` caps every element's
        decode (runtime scalar — no recompile).

        Returns a list of SynthesisResult (shared timing fields).
        """
        if not len(texts):
            # an empty batch would otherwise surface as an obscure
            # max()-of-empty internals error (review finding)
            return []
        languages = languages or ["russian"] * len(texts)
        for lang in languages:
            if lang not in SUPPORTED_LANGUAGES:
                raise ValueError(f"unsupported language {lang!r}")
        if max_tokens is not None and max_tokens < 1:
            # same contract as synthesize(): without this, a falsy 0
            # would silently decode the FULL budget (review finding)
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")

        timer = StageTimer()
        tp = self.params["talker"]
        cpp = self.params["code_predictor"]
        vp = self.params["vocoder"]
        B = len(texts)

        with timer.stage("tokenize"):
            encoded = [self._encode_text(t) for t in texts]
            bucket = max(int(ids.shape[0]) for ids, _ in encoded)
            ids_np = np.zeros((B, bucket), np.int32)
            n_text_np = np.zeros((B,), np.int32)
            for i, (ids, n) in enumerate(encoded):
                ids_np[i, :ids.shape[0]] = np.asarray(ids)
                n_text_np[i] = int(n)

        with timer.stage("decode"):
            # distinct per-element streams (duplicate texts in one batch
            # should not produce identical audio); the host key + in-jit
            # split avoids ~2 eager dispatches per call (review
            # finding; same rationale as smp.host_prng_key)
            state = self._batch_prefill(tp, jnp.asarray(ids_np),
                                        jnp.asarray(n_text_np),
                                        smp.host_prng_key(seed))
            state = self._decode_pipelined(
                tp, cpp, state,
                budget=(min(int(max_tokens), self.cfg.max_tokens)
                        if max_tokens is not None else None))
            state.n_codes.copy_to_host_async()
            state.codes.copy_to_host_async()
            n_codes = np.asarray(jax.device_get(state.n_codes))
            codes_all = np.asarray(jax.device_get(state.codes))

        rows = []
        with timer.stage("vocoder"):
            # chain-dispatch every row's bucketed window on the DEVICE
            # codes, then drain the fetches as one overlapped burst (the
            # batcher-harvest pattern) instead of decode+fetch per row
            futs: Dict[int, object] = {}
            for i in range(B):
                n = int(n_codes[i])
                if 0 < n <= 256:
                    futs[i] = self._voc_pad(vp, state.codes[i:i + 1],
                                            W=voc.voc_bucket(n + 1))
            for f in futs.values():
                f.copy_to_host_async()
            for i in range(B):
                n = int(n_codes[i])
                codes_np = codes_all[i][:n]
                if i in futs:
                    audio = np.asarray(
                        jax.device_get(futs[i]))[0][:n * SAMPLES_PER_TOKEN]
                else:  # n == 0 or > 256 tokens: conv-exact chunked path
                    audio = voc.synthesize_exact(
                        lambda ch: self._voc_chunk(vp, jnp.asarray(ch)),
                        codes_np)
                rows.append((codes_np, n, voc.to_int16(audio)))
        # build the results AFTER the stage closes: StageTimer records a
        # stage in its finally block, so constructing inside the with
        # would drop the vocoder stage from every row's timings and
        # sample total_seconds mid-stage (rows would disagree)
        total = timer.total()
        results = []
        for codes_np, n, audio_i16 in rows:
            dur = len(audio_i16) / SAMPLE_RATE
            results.append(SynthesisResult(
                audio_int16=audio_i16, codes=codes_np, n_tokens=n,
                timings=dict(timer.stages),
                total_seconds=total,
                rtf=(total / dur) if dur > 0 else float("inf"),
            ))
        return results

    def synthesize_long(self, text: str, language: str = "russian",
                        seed: int = 0, output: Optional[str] = None,
                        max_batch: int = 4, on_chunk=None,
                        prompt_dir: Optional[str] = None,
                        max_tokens: Optional[int] = None):
        """Paragraph-length synthesis. One request is bounded by
        ``cfg.max_tokens`` codec tokens (the reference's MAX_TOKENS cap,
        llamacpp_talker_server.py:65 — its client simply truncates long
        text). Here the text splits into sentence-sized pieces
        (utils/text.split_sentences) and up to ``max_batch`` sentences
        decode together in ONE batched fused program per group
        (synthesize_batch), so a paragraph synthesizes at roughly the
        per-sentence latency times ceil(n_sentences / max_batch) — a
        capability the single-request reference has no analog of.

        ``on_chunk(audio_int16)`` fires in stream order: the FIRST
        sentence arrives as sub-sentence streaming frames (head-schedule
        latency, ~0.1 s to first audio), later sentences as one frame
        each when their group finishes.
        ``prompt_dir`` (voice cloning) applies to every piece — pieces
        then synthesize solo, since the batched prefill has no prompt
        path. ``max_tokens`` caps each piece's decode (and tightens the
        split budget accordingly). Returns one SynthesisResult with the
        stitched audio and stacked codes."""
        from qwen3_tts_tpu.utils.text import split_for_budget

        if language not in SUPPORTED_LANGUAGES:
            raise ValueError(
                f"unsupported language {language!r}; expected one of "
                f"{SUPPORTED_LANGUAGES}")
        # bound each piece by its ENCODED token count so per-request
        # truncation never engages: EOS pacing forces a stop at
        # 6*n_text+1 codec tokens, so n_text <= (cap-1)/6 guarantees an
        # un-truncated decode. Measured with the production tokenizer —
        # a char bound both over-splits BPE text (~0.4 tokens/char) and
        # under-splits multi-byte scripts under byte fallback
        if max_tokens is not None and max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        from qwen3_tts_tpu.utils.text import piece_token_budget
        budget = piece_token_budget(self.cfg.max_tokens, max_tokens)
        if prompt_dir is not None:
            # every cloned piece is prefixed by the ref transcript, so
            # the split budget must leave room for it in the text bucket
            # (otherwise each piece would overflow-fail in
            # _encode_cloned — review finding)
            _, _ref_text = self._load_prompt(prompt_dir)
            budget = self._cloned_piece_budget(budget, _ref_text)
        pieces = split_for_budget(
            text, lambda s: len(
                self.tokenizer.encode(s, add_special_tokens=False)),
            budget)
        if len(pieces) <= 1:
            res = self.synthesize(text, language=language, seed=seed,
                                  output=output, prompt_dir=prompt_dir,
                                  max_tokens=max_tokens,
                                  streaming=on_chunk is not None,
                                  on_chunk=on_chunk)
            return res

        t_start = time.perf_counter()
        first_audio_t: Optional[float] = None
        audio_parts: List[np.ndarray] = []
        codes_parts: List[np.ndarray] = []

        def emit(a16: np.ndarray) -> None:
            nonlocal first_audio_t
            if len(a16) == 0:
                return
            if first_audio_t is None:
                first_audio_t = time.perf_counter() - t_start
            if on_chunk is not None:
                on_chunk(a16)

        start = 0
        if prompt_dir is None:
            # the FIRST sentence always decodes solo: with a streaming
            # consumer it goes through the engine's streaming head
            # schedule, so the paragraph's first audio lands in ~0.1 s
            # (head-chunk latency) instead of after the first whole
            # batched group (~seconds). It decodes solo in BOTH consumer
            # modes (streamed samples are identical to the solo
            # non-streaming decode — engine streaming contract) so the
            # stitched result is byte-identical whether or not a chunk
            # consumer is attached.
            r0 = self.synthesize(pieces[0], language=language, seed=seed,
                                 streaming=on_chunk is not None,
                                 max_tokens=max_tokens,
                                 on_chunk=emit if on_chunk is not None
                                 else None)
            codes_parts.append(r0.codes)
            audio_parts.append(r0.audio_int16)
            if on_chunk is None:
                emit(r0.audio_int16)   # record first-audio only
            start = 1
        for g in range(start, len(pieces), max_batch):
            group = pieces[g:g + max_batch]
            if prompt_dir is not None:
                # voice-cloned prefix rides the solo prefill only
                rs = [self.synthesize(p, language=language, seed=seed + g + j,
                                      prompt_dir=prompt_dir,
                                      max_tokens=max_tokens)
                      for j, p in enumerate(group)]
            elif len(group) == 1:
                rs = [self.synthesize(group[0], language=language,
                                      seed=seed + g, max_tokens=max_tokens)]
            else:
                # distinct seeds per group: duplicate sentences across
                # groups should not produce identical prosody
                rs = self.synthesize_batch(
                    group, [language] * len(group), seed=seed + g,
                    max_tokens=max_tokens)
            for r in rs:
                codes_parts.append(r.codes)
                audio_parts.append(r.audio_int16)
                emit(r.audio_int16)

        audio_i16 = (np.concatenate(audio_parts) if audio_parts
                     else np.zeros((0,), np.int16))
        codes = (np.concatenate(codes_parts) if codes_parts
                 else np.zeros((0, 16), np.int32))
        total = time.perf_counter() - t_start
        dur = len(audio_i16) / SAMPLE_RATE
        result = SynthesisResult(
            audio_int16=audio_i16, codes=codes, n_tokens=int(len(codes)),
            timings={"total": total},
            total_seconds=total,
            rtf=(total / dur) if dur > 0 else float("inf"),
            first_audio_seconds=first_audio_t,
        )
        if output is not None and len(audio_i16) > 0:
            wav_io.write_wav(output, audio_i16)
        return result

    @property
    def _batch_prefill(self):
        if not hasattr(self, "_batch_prefill_fn"):
            def fn(tp, ids, n_text, key):
                keys = jax.random.split(key, ids.shape[0])
                prefix, plen = jax.vmap(
                    lambda i, n: tk.build_prefix(tp, i, n))(ids, n_text)
                prefix = prefix.astype(tp["codec_embedding"].dtype)
                return gen.init_state(tp, prefix, plen, n_text, keys,
                                      self.cfg)
            self._batch_prefill_fn = jax.jit(fn)
        return self._batch_prefill_fn
