"""Smoke run of the Qwen3-TTS main path on an NVIDIA GPU.

Drives the product path once at the full 0.6B geometry (``TTSConfig()``,
random weights from a seed, byte-fallback tokenizer) through the entry
points a user calls, and checks what comes out:

1. device  -- JAX must see a GPU; prints the card's name and power limit.
2. parity  -- talker prefill + 8 teacher-forced decode steps, the code
              predictor at temperature 0 and one 64-token vocoder window,
              float32 weights, on the card and on this process's CPU
              device, at "highest" and then at default matmul precision.
3. engine  -- ``TTSEngine`` at quantize None / int8 / int8-cp: one blob
              and one streaming synthesis each; streaming must equal blob.
4. server  -- ``TTSDaemon`` with an 8-slot ``ContinuousBatcher`` (dense,
              then paged): 8 concurrent socket requests, one HTTP
              ``POST /v1/audio/speech``.

The last stdout line is one JSON object naming the device. Any failed
check exits non-zero, and the script never falls back to the CPU.

    python chip_smoke.py             # one card, the phases above
    python chip_smoke.py --cards 4   # only the dp/tp mesh path on 4 cards
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# The parity phase needs the CPU backend beside the GPU one.
if os.environ.get("JAX_PLATFORMS") and "cpu" not in os.environ[
        "JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"
# The byte-fallback tokenizer, as documented above: it also keeps the
# optional HF tokenizer packages out of this process.
os.environ["QWEN3_TTS_TOKENIZER"] = "byte"


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)
    log(f"  ok: {what}")


def _timed_compile(fn, args):
    """(compiled, seconds) for ``jax.jit(fn)`` at ``args``' devices."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _best_run(compiled, args, reps: int):
    import jax
    out, best = None, float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        best = min(best, time.perf_counter() - t0)
    return out, best


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def phase_device(n_cards: int):
    import jax

    devs = jax.devices()
    d = devs[0]
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    if d.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's first device is {d.platform!r}")
    if len(devs) < n_cards:
        raise SmokeFailure(f"need {n_cards} GPUs, JAX sees {len(devs)}")
    # a child process that stays off JAX reads the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log("[device] nvidia-smi name, power.limit:")
    for line in smi.stdout.strip().splitlines():
        log(line)
    return d, smi.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# 2. parity: card vs this process's CPU device
# --------------------------------------------------------------------------

# max|card - cpu| / max|cpu| for the talker's hidden states: both sides
# are float32 and differ only in summation order (an H100 measured 1.9e-6
# through 28 layers); TF32 operands (10-bit mantissa) measured 1.3e-3.
TALKER_TOL = 1e-3
# The vocoder's FP32 contract, as its torch golden test holds it
# (tests/test_vocoder_golden.py): |card - cpu| <= atol + rtol * |cpu|.
# Random weights put the output peak near 2e-3, where atol alone would
# admit any error, so max|card - cpu| / max|cpu| <= rtol must hold too.
VOC_RTOL, VOC_ATOL = 2e-4, 3e-5


def parity_stages(cfg, seed: int = 0):
    """The three parity stages as (name, fn, make_args) over float32
    weights; ``make_args(device)`` places the inputs on ``device``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qwen3_tts_tpu.io import weights as weights_io
    from qwen3_tts_tpu.io.tokenizer import load_tokenizer
    from qwen3_tts_tpu.models import code_predictor as cp
    from qwen3_tts_tpu.models import talker as tk
    from qwen3_tts_tpu.models import transformer as tfm
    from qwen3_tts_tpu.models import vocoder as voc

    tcfg, ccfg = cfg.talker, cfg.code_predictor
    n_steps = 8
    params = weights_io.init_random_params(cfg, seed=seed,
                                           dtype=jnp.float32)
    rng = np.random.RandomState(seed)
    ids = load_tokenizer(None).encode("Parity of the talker on two devices.",
                                      add_special_tokens=False)
    text = np.zeros((64,), np.int32)
    text[:len(ids)] = ids
    code0 = rng.randint(0, 2048, size=(n_steps,)).astype(np.int32)
    voc_codes = rng.randint(0, cfg.vocoder.codebook_size,
                            size=(1, 64, cfg.vocoder.num_codebooks))

    def talker_fn(tp, text_ids, n_text, code0):
        prefix, plen = tk.build_prefix(tp, text_ids, n_text)
        kv = tfm.init_kv_cache(tfm.geometry_of(tcfg), 1, tcfg.max_seq_len,
                               dtype=prefix.dtype)
        h, kv = tk.prefill(tp, prefix[None], plen[None], kv, tcfg)
        # teacher forcing: fixed codec tokens feed back, nothing sampled
        feedback = tp["codec_embedding"][code0]

        def step(carry, xs):
            h, kv = carry
            i, fb = xs
            h, kv = tk.decode_step(tp, fb[None], plen[None] + i, kv, tcfg)
            return (h, kv), h[0]

        _, hs = jax.lax.scan(step, (h, kv),
                             (jnp.arange(n_steps, dtype=jnp.int32),
                              feedback))
        return jnp.concatenate([h, hs])                 # (1 + steps, H)

    greedy = dataclasses.replace(cfg.sampling, cp_temperature=0.0)

    def cp_fn(cpp, tp, hidden, code0, key):
        c0e = tp["codec_embedding"][code0]
        return cp.predict_codes(cpp, hidden, c0e, key, ccfg, greedy)

    def voc_fn(vp, codes):
        return voc.decode(vp, codes, cfg.vocoder)

    # the CP's inputs are the talker's hidden states, computed once on the
    # CPU so the CP stage is compared on identical inputs
    cpu = jax.devices("cpu")[0]
    hidden = None

    def talker_args(dev):
        return jax.device_put((params["talker"], jnp.asarray(text),
                               jnp.int32(len(ids)), jnp.asarray(code0)), dev)

    def cp_args(dev):
        nonlocal hidden
        if hidden is None:
            with jax.default_matmul_precision("highest"):
                hidden = np.asarray(jax.jit(talker_fn)(*talker_args(cpu)))
        return jax.device_put((params["code_predictor"], params["talker"],
                               jnp.asarray(hidden[:n_steps]),
                               jnp.asarray(code0),
                               jax.random.PRNGKey(seed)), dev)

    def voc_args(dev):
        return jax.device_put((params["vocoder"],
                               jnp.asarray(voc_codes, jnp.int32)), dev)

    return [("talker", talker_fn, talker_args),
            ("code_predictor", cp_fn, cp_args),
            ("vocoder", voc_fn, voc_args)]


def _compare(name: str, got, ref):
    """Error of ``got`` against ``ref``; returns (summary, within_tol)."""
    import numpy as np

    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return f"shape {got.shape} != {ref.shape}", False
    if name == "code_predictor":
        n_diff = int(np.sum(got != ref))
        return f"{n_diff} of {ref.size} codes differ (tolerance 0)", \
            n_diff == 0
    d = np.abs(got - ref)
    max_abs = float(d.max())
    max_rel = max_abs / max(float(np.abs(ref).max()), 1e-30)
    if name == "vocoder":
        worst = float((d / (VOC_ATOL + VOC_RTOL * np.abs(ref))).max())
        return (f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
                f"worst |d|/(atol+rtol|ref|)={worst:.3f} (contract "
                f"rtol={VOC_RTOL} atol={VOC_ATOL}: <= 1; max_rel <= rtol)"), \
            worst <= 1.0 and max_rel <= VOC_RTOL
    return (f"max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
            f"(tolerance max_rel <= {TALKER_TOL})"), max_rel <= TALKER_TOL


def phase_parity(cfg, device) -> None:
    import jax
    import numpy as np

    cpu = jax.devices("cpu")[0]
    for name, fn, make_args in parity_stages(cfg):
        args_dev, args_cpu = make_args(device), make_args(cpu)
        with jax.default_matmul_precision("highest"):
            c_ref, tc_ref = _timed_compile(fn, args_cpu)
            ref, tr_ref = _best_run(c_ref, args_cpu, 1)
            c_hi, tc_hi = _timed_compile(fn, args_dev)
            hi, tr_hi = _best_run(c_hi, args_dev, 3)
        c_df, tc_df = _timed_compile(fn, args_dev)
        df, tr_df = _best_run(c_df, args_dev, 3)
        out = np.asarray(hi)
        check(out.shape == np.asarray(ref).shape
              and np.all(np.isfinite(out.astype(np.float64))),
              f"{name}: finite output of shape {out.shape}")
        summ_hi, ok_hi = _compare(name, hi, ref)
        summ_df, ok_df = _compare(name, df, ref)
        log(f"[parity] {name}: cpu compile {tc_ref:.1f}s run {tr_ref:.3f}s")
        log(f"[parity] {name} highest: compile {tc_hi:.1f}s "
            f"run {tr_hi * 1e3:.2f}ms  {summ_hi}")
        log(f"[parity] {name} default: compile {tc_df:.1f}s "
            f"run {tr_df * 1e3:.2f}ms  {summ_df}"
            f"{'' if ok_df else '  (outside tolerance)'}")
        check(ok_hi, f"{name}: card matches cpu at highest precision")
        if name == "vocoder":
            check(ok_df, "vocoder: FP32 contract holds at default precision")


# --------------------------------------------------------------------------
# 3. engine
# --------------------------------------------------------------------------

def _check_audio(tag: str, n_tokens: int, audio) -> None:
    import numpy as np

    check(n_tokens > 0
          and len(audio) == n_tokens * 1920
          and bool(np.all(np.isfinite(np.asarray(audio, np.float64)))),
          f"{tag}: n_tokens={n_tokens} > 0, {len(audio)} finite samples "
          f"= n_tokens * 1920")


# Streaming decodes the vocoder in windows of other shapes than the blob
# path's single window, and the GPU picks a convolution algorithm per
# shape, so the float32 sums differ in order: a sample at a rounding
# boundary of the int16 conversion can land one step away.
STREAM_STEPS = 1


def phase_engine(cfg, params, card: str):
    """Returns the quantize=None engine, which the server phase reuses."""
    import jax.numpy as jnp
    import numpy as np

    from qwen3_tts_tpu.engine.engine import TTSEngine

    text = "The engine smoke test speaks this sentence."
    for quantize in (None, "int8", "int8-cp"):
        tag = f"engine quantize={quantize}"
        t0 = time.perf_counter()
        eng = TTSEngine(cfg, model_dir=None, dtype=jnp.bfloat16,
                        params=params, quantize=quantize)
        t_init = time.perf_counter() - t0
        # first calls compile: a text of the same bucket, both paths
        t0 = time.perf_counter()
        eng.synthesize(text.upper(), language="english", seed=0)
        eng.synthesize(text.lower(), language="english", seed=0,
                       streaming=True)
        t_warm = time.perf_counter() - t0
        blob = eng.synthesize(text, language="english", seed=1)
        frames = []
        stream = eng.synthesize(text, language="english", seed=1,
                                streaming=True, on_chunk=frames.append)
        log(f"[engine] {tag}: init {t_init:.1f}s, first calls (compile) "
            f"{t_warm:.1f}s")
        _check_audio(f"{tag} blob", blob.n_tokens, blob.audio_int16)
        _check_audio(f"{tag} stream", stream.n_tokens, stream.audio_int16)
        log(f"[engine] {tag}: blob n={blob.n_tokens} RTF={blob.rtf:.4f} "
            f"{blob.total_seconds / blob.n_tokens * 1e3:.2f} ms/token; "
            f"stream RTF={stream.rtf:.4f} first_audio="
            f"{stream.first_audio_seconds:.3f}s  [{card}]")
        streamed = (np.concatenate(frames) if frames
                    else np.zeros(0, np.int16))
        check(np.array_equal(streamed, stream.audio_int16),
              f"{tag}: streamed chunks concatenate to the stream result")
        check(np.array_equal(stream.codes, blob.codes),
              f"{tag}: streaming codes equal blob codes")
        n_diff = int(np.sum(stream.audio_int16 != blob.audio_int16))
        max_diff = int(np.max(np.abs(stream.audio_int16.astype(np.int32)
                                     - blob.audio_int16.astype(np.int32)),
                              initial=0))
        check(max_diff <= STREAM_STEPS,
              f"{tag}: streaming audio equals blob within {STREAM_STEPS} "
              f"int16 step ({n_diff} of {len(blob.audio_int16)} samples "
              f"differ, max {max_diff})")
        if quantize is None:
            dense = eng
    return dense


# --------------------------------------------------------------------------
# 4. server
# --------------------------------------------------------------------------

def _wait_for(path: str, timeout: float) -> None:
    deadline = time.time() + timeout
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.05)
    if not os.path.exists(path):
        raise SmokeFailure(f"daemon socket {path} never appeared")


def _http_speech(port: int, text: str):
    import http.client
    import io
    import wave

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = json.dumps({"input": text, "voice": "default",
                           "response_format": "wav", "language": "english",
                           "seed": 7})
        conn.request("POST", "/v1/audio/speech", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise SmokeFailure(f"HTTP speech status {resp.status}: {data[:200]!r}")
    with wave.open(io.BytesIO(data)) as w:
        return (w.getnchannels(), w.getframerate(), w.getsampwidth(),
                w.getnframes())


def run_server(engine, batcher, n_requests: int) -> None:
    """Serve ``n_requests`` concurrent socket requests (mixed streaming
    and blob) plus one HTTP speech request through a daemon thread."""
    from qwen3_tts_tpu.serve.daemon import DaemonClient, TTSDaemon
    from qwen3_tts_tpu.serve.http import serve_http

    tmp = tempfile.mkdtemp(prefix="tts_smoke_")
    sock = os.path.join(tmp, "tts.sock")
    daemon = TTSDaemon(engine, sock, batcher=batcher)
    server = threading.Thread(target=daemon.serve, daemon=True)
    server.start()
    srv = None
    try:
        _wait_for(sock, 30)
        srv = serve_http(daemon, port=0)
        client = DaemonClient(sock)
        results, errors = {}, {}

        def call(i: int) -> None:
            try:
                results[i] = client.synthesize(
                    f"concurrent request number {i}", language="english",
                    seed=i, stream=(i % 2 == 0))
            except Exception as e:  # reported below, fails the phase
                errors[i] = repr(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(n_requests)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        check(not errors and len(results) == n_requests,
              f"{len(results)} of {n_requests} concurrent requests "
              f"answered, errors={errors}")
        audio_s = 0.0
        for i, (hdr, audio) in sorted(results.items()):
            _check_audio(f"request {i} ({'stream' if i % 2 == 0 else 'blob'})",
                         int(hdr["n_tokens"]), audio)
            audio_s += len(audio) / 24000
        log(f"[server] {n_requests} requests in {wall:.2f}s wall, "
            f"{audio_s / wall:.2f} audio-s/s")
        ch, rate, width, frames = _http_speech(srv.server_address[1],
                                               "one request over HTTP")
        check(ch == 1 and rate == 24000 and width == 2 and frames > 0
              and frames % 1920 == 0,
              f"HTTP /v1/audio/speech WAV: {ch} ch, {rate} Hz, "
              f"{8 * width}-bit, {frames} frames")
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        daemon.stop()
        server.join(timeout=120)
    check(not server.is_alive(), "daemon thread stopped")


def phase_server(cfg, engine, n_requests: int = 8) -> None:
    import jax.numpy as jnp

    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    for paged in (False, True):
        t0 = time.perf_counter()
        # the daemon's own settings for --batch 8 (serve/daemon.py main)
        batcher = ContinuousBatcher(cfg, engine.params, batch_size=8,
                                    dtype=jnp.bfloat16, decode_chunk=32,
                                    paged=paged, page_size=64,
                                    pipeline_depth=2)
        batcher.start()
        # warm both the blob and the streaming programs before timing, at
        # the requests' text bucket (32 tokens)
        ids, n_text = engine._encode_text("concurrent request warmup")
        for on_chunk in (None, lambda seg: None):
            batcher.submit(ids, int(n_text), seed=0,
                           on_chunk=on_chunk).result(timeout=1800)
        log(f"[server] {'paged' if paged else 'dense'} batch 8: init + "
            f"warmup (compile) {time.perf_counter() - t0:.1f}s")
        run_server(engine, batcher, n_requests)


# --------------------------------------------------------------------------
# --cards 4: the dp/tp mesh path against one card
# --------------------------------------------------------------------------

def _distinct_shards(arr, n: int, what: str) -> None:
    devs = {s.device for s in arr.addressable_shards}
    shapes = {tuple(s.data.shape) for s in arr.addressable_shards}
    check(len(devs) == n and all(sh != tuple(arr.shape) for sh in shapes),
          f"{what}: {len(devs)} devices hold shards {sorted(shapes)} of "
          f"{tuple(arr.shape)}")


# audio from the mesh runs against one card, in int16 steps: float32 at
# "highest", where dp and tp change only which partial sums are added in
# which order -- differences far below one step, but a sample near a
# rounding boundary can land one step away
MESH_AUDIO_STEPS = 2
# max|mesh - one card| / max|one card| for the engine's post-prefill
# hidden state (float32, highest; tp reorders the reductions only)
MESH_HIDDEN_TOL = 1e-4


def phase_mesh(cfg, n_cards: int = 4) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.io import weights as weights_io
    from qwen3_tts_tpu.io.tokenizer import load_tokenizer
    from qwen3_tts_tpu.ops import sampling as smp
    from qwen3_tts_tpu.parallel import mesh as pmesh
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    params = weights_io.init_random_params(cfg, seed=0, dtype=jnp.float32)
    text = "Four cards speak this sentence together."

    # engine: tp=4 against one card
    runs = {}
    for tp_size in (1, n_cards):
        t0 = time.perf_counter()
        mesh = pmesh.make_mesh(1, tp_size) if tp_size > 1 else None
        with (mesh or contextlib.nullcontext()):
            eng = TTSEngine(cfg, model_dir=None, dtype=jnp.float32,
                            params=dict(params), mesh=mesh)
            ids, n_text = eng._encode_text(text)
            st = eng._init_state(eng.params["talker"], ids, n_text,
                                 smp.host_prng_key(3))
            res = eng.synthesize(text, language="english", seed=3)
        runs[tp_size] = (np.asarray(st.hidden), res)
        log(f"[mesh] engine tp={tp_size}: {time.perf_counter() - t0:.1f}s "
            f"(compile + run), n={res.n_tokens}")
        if mesh is not None:
            _distinct_shards(eng.params["talker"]["layers"]["q_proj"],
                             n_cards, f"engine tp={tp_size} talker q_proj")
        del eng
    (h1, r1), (h4, r4) = runs[1], runs[n_cards]
    rel = float(np.abs(h4 - h1).max() / np.abs(h1).max())
    check(rel <= MESH_HIDDEN_TOL,
          f"engine tp={n_cards} hidden max_rel={rel:.3e} "
          f"(tolerance {MESH_HIDDEN_TOL})")
    check(np.array_equal(r4.codes, r1.codes),
          f"engine tp={n_cards} codes equal one card ({r1.n_tokens} tokens)")
    steps = int(np.abs(r4.audio_int16.astype(np.int32)
                       - r1.audio_int16.astype(np.int32)).max(initial=0))
    check(steps <= MESH_AUDIO_STEPS,
          f"engine tp={n_cards} audio within {steps} int16 steps "
          f"(tolerance {MESH_AUDIO_STEPS})")

    # batcher: dp=4 and dp=2 x tp=2 against one card, 8 requests
    texts = [f"mesh request {i} of eight" for i in range(8)]

    tok = load_tokenizer(None)
    enc = [tok.encode(t, add_special_tokens=False) for t in texts]

    def serve(mesh):
        t0 = time.perf_counter()
        with (mesh or contextlib.nullcontext()):
            # a float32 CP: the int8 path rounds activations to bf16,
            # which would turn reordered float32 sums into code flips
            b = ContinuousBatcher(cfg, params, batch_size=8,
                                  dtype=jnp.float32, decode_chunk=32,
                                  mesh=mesh, quantize_cp=False)
            b.start()
            try:
                futs = [b.submit(np.asarray(e, np.int32), len(e), seed=i)
                        for i, e in enumerate(enc)]
                out = [f.result(timeout=1800) for f in futs]
            finally:
                b.stop()
        return b, out, time.perf_counter() - t0

    _, ref, t_ref = serve(None)
    log(f"[mesh] batcher one card: {t_ref:.1f}s (compile + run)")
    for dp, tp in ((n_cards, 1), (2, n_cards // 2)):
        b, got, t = serve(pmesh.make_mesh(dp, tp))
        tag = f"batcher dp={dp} x tp={tp}"
        log(f"[mesh] {tag}: {t:.1f}s (compile + run)")
        _distinct_shards(b._state.kv, n_cards, f"{tag} KV cache")
        differ = [i for i, (g, r) in enumerate(zip(got, ref))
                  if not np.array_equal(g[0], r[0])]
        check(not differ, f"{tag}: codes of all 8 requests equal one card "
              f"bit for bit (requests differing: {differ})")
        steps = max(int(np.abs(g[1].astype(np.int32)
                               - r[1].astype(np.int32)).max(initial=0))
                    for g, r in zip(got, ref))
        check(steps <= MESH_AUDIO_STEPS,
              f"{tag}: audio within {steps} int16 steps "
              f"(tolerance {MESH_AUDIO_STEPS})")


# --------------------------------------------------------------------------

def run_one_card(cfg, device, card: str) -> None:
    """Phases 2-4 on ``device``, all weights random from seed 0."""
    import jax.numpy as jnp

    from qwen3_tts_tpu.io import weights as weights_io

    t0 = time.perf_counter()
    phase_parity(cfg, device)
    log(f"[parity] phase done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    params = weights_io.init_random_params(cfg, seed=0, dtype=jnp.bfloat16)
    engine = phase_engine(cfg, params, card)
    log(f"[engine] phase done in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_server(cfg, engine)
    log(f"[server] phase done in {time.perf_counter() - t0:.1f}s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=[1, 4],
                   help="4: run only the dp/tp mesh path and its one-card "
                        "comparison, on four cards")
    args = p.parse_args(argv)

    sys.path.insert(0, REPO)
    try:
        import qwen3_tts_tpu
    except ImportError as e:
        log(f"FAIL: the qwen3_tts_tpu package is not beside this script "
            f"({e})")
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(
            qwen3_tts_tpu.__file__))) != REPO:
        log(f"FAIL: imported qwen3_tts_tpu from {qwen3_tts_tpu.__file__}, "
            f"not from {REPO}")
        return 2

    t_start = time.perf_counter()
    try:
        import jax

        from qwen3_tts_tpu.config import SamplingConfig, TTSConfig
        from qwen3_tts_tpu.utils.compile_cache import enable_compile_cache

        log(f"[setup] compile cache: {enable_compile_cache()}")
        device, card = phase_device(args.cards)
        if args.cards > 1:
            greedy = SamplingConfig(temperature=0.0, cp_temperature=0.0)
            # process-wide, not a context manager: the batcher traces its
            # programs on its own scheduler thread, and JAX's config
            # contexts are thread-local
            jax.config.update("jax_default_matmul_precision", "highest")
            phase_mesh(TTSConfig(sampling=greedy, max_tokens=64),
                       args.cards)
        else:
            run_one_card(TTSConfig(), device, card)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    devs = jax.devices()
    sys.stdout.write(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}) + "\n")
    sys.stdout.flush()
    sys.stderr.flush()
    # every thread this script started has been joined; exit without
    # waiting on library teardown so nothing can print after the JSON line
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
