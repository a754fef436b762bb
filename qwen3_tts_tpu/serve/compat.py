"""Reference-protocol compatibility servers.

Drop-in re-implementations of the reference's three Unix-socket protocols
(docs/ARCHITECTURE.md:44-64 in the reference repo), so an unmodified
reference client (dual_npu/tts_client.py) can run against this framework:

- **talker** (stateful, bidirectional per request):
    req:  [u32 len][JSON {"text", "language"}]
    per token: send [i32 code_0][f32x1024 hidden]; recv [f32x1024 feedback]
    end:  [i32 -1] done / [i32 -2] error
  (reference llamacpp_talker_server.py:13-27, 211-306)
- **code predictor** (stateless, one connection per token):
    req:  [f32x1024 hidden][i32 code_0]  ->  resp: [i32 x 15]
  (reference code_predictor_server.py:8-12, 142-197)
- **vocoder** (batch):
    req:  [i32 n][i64 n*16 codes]  ->  resp: [i32 n_samples][i16 ...]
  (reference vocoder_server.py:8-12, 123-190)

These run the same jitted model programs as the fused engine, just unfused
at the protocol boundaries — the compatibility tier, not the fast path.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import sys
import threading
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from qwen3_tts_tpu.config import (
    CODEC_EOS_ID,
    NUM_AUDIO_CODES,
    SAMPLES_PER_TOKEN,
    TTS_PAD_TOKEN_ID,
    VOC_CHUNK_SIZE,
    VOC_OVERLAP,
    TTSConfig,
)
from qwen3_tts_tpu.models import code_predictor as cp
from qwen3_tts_tpu.models import talker as tk
from qwen3_tts_tpu.models import transformer as tfm
from qwen3_tts_tpu.models import vocoder as voc
from qwen3_tts_tpu.ops import sampling as smp

SENTINEL_DONE = -1
SENTINEL_ERROR = -2


# one shared implementation of the framing-critical recv loop
from qwen3_tts_tpu.serve.daemon import _recv_exact  # noqa: E402


class _SocketServer:
    """Common accept loop with 1 s timeout polling a stop flag.

    Connections are handled inline on the accept thread (the reference
    servers are single-request too), so every accepted socket gets a
    recv/send timeout: a client that connects and then stalls would
    otherwise block the thread forever, wedging the server and making
    stop() unreachable (review finding; the native loop's SO_RCVTIMEO
    guards the same thing in ttsrt.cc)."""

    conn_timeout = 300.0  # generous: covers a full 200-token generation

    def __init__(self, socket_path: str):
        self.socket_path = socket_path
        self._stop = threading.Event()

    def stop(self):
        self._stop.set()

    def serve(self):
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.bind(self.socket_path)
        sock.listen(4)
        sock.settimeout(1.0)
        os.chmod(self.socket_path, 0o666)
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = sock.accept()
                except socket.timeout:
                    continue
                try:
                    # accept() from a listener with a timeout returns a
                    # BLOCKING socket (bpo-7995) — bound it explicitly
                    conn.settimeout(self.conn_timeout)
                    self.handle(conn)
                except Exception:
                    pass
                finally:
                    conn.close()
        finally:
            sock.close()
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)

    def handle(self, conn):  # pragma: no cover - abstract
        raise NotImplementedError


class TalkerCompatServer(_SocketServer):
    """The talker protocol against our jitted talker."""

    def __init__(self, params, cfg: TTSConfig, tokenizer,
                 socket_path: str = "/tmp/qwen3_talker.sock"):
        super().__init__(socket_path)
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        tcfg = cfg.talker
        geo = tfm.geometry_of(tcfg)

        def prefill_fn(tp, ids, n_text):
            prefix, plen = tk.build_prefix(tp, ids, n_text)
            prefix = prefix.astype(tp["codec_embedding"].dtype)
            kv = tfm.init_kv_cache(geo, 1, tcfg.max_seq_len,
                                   dtype=prefix.dtype)
            h, kv = tk.prefill(tp, prefix[None], plen[None], kv, tcfg)
            return h, kv, plen

        def step_fn(tp, feedback, pos, kv):
            return tk.decode_step(tp, feedback, pos, kv, tcfg)

        def sample_fn(tp, hidden, ring, step, n_text, key):
            logits = tk.codec_logits(tp, hidden[0])
            return smp.sample_code0(logits, ring, step, n_text, key,
                                    cfg.sampling)

        self._prefill = jax.jit(prefill_fn)
        # donate the KV cache: without it XLA preserves the input buffer,
        # copying the whole per-request cache every decode step (review
        # finding); not on CPU, which ignores donation with a warning
        donate = (3,) if jax.default_backend() != "cpu" else ()
        self._step = jax.jit(step_fn, donate_argnums=donate)
        self._sample = jax.jit(sample_fn)

    def handle(self, conn):
        raw = _recv_exact(conn, 4)
        if raw is None:
            return
        msg_len = struct.unpack("<I", raw)[0]
        if msg_len > 65536:  # reference bound (llamacpp_talker_server.py:338)
            conn.sendall(struct.pack("<i", SENTINEL_ERROR))
            return
        body = _recv_exact(conn, msg_len)
        if body is None:  # client closed mid-request
            return
        try:
            msg = json.loads(body.decode())
        except Exception:
            # the documented protocol promises [-2] on error
            # (module docstring / llamacpp_talker_server.py:358-366),
            # not an unexplained EOF (review finding)
            conn.sendall(struct.pack("<i", SENTINEL_ERROR))
            return
        try:
            self._generate(conn, msg)
        except (BrokenPipeError, ConnectionResetError, socket.timeout):
            pass
        except Exception:
            try:
                conn.sendall(struct.pack("<i", SENTINEL_ERROR))
            except OSError:
                pass

    def _generate(self, conn, msg):
        text = msg.get("text", "")

        ids = self.tokenizer.encode(text, add_special_tokens=False)
        n = len(ids)
        # clamp the padded prefix to the KV allocation (the engine path's
        # truncation semantics, engine.TTSEngine._encode_text) instead of
        # shape-erroring inside prefill on over-long texts; the reference
        # only bounds bytes (llamacpp_talker_server.py:338), we bound
        # tokens too
        from qwen3_tts_tpu.models.talker import PREFIX_EXTRA
        limit = self.cfg.talker.max_seq_len - PREFIX_EXTRA
        bucket = 16
        while bucket < n and bucket * 2 <= limit:
            bucket *= 2
        bucket = min(bucket, limit)
        if n > bucket:
            print(f"warning: text truncated to {bucket} of {n} tokens "
                  f"(max_seq_len={self.cfg.talker.max_seq_len})",
                  file=sys.stderr)
            n = bucket
        padded = np.zeros(bucket, np.int32)
        padded[:n] = ids[:n]
        tp = self.params["talker"]
        hidden, kv, plen = self._prefill(tp, jnp.asarray(padded),
                                         jnp.int32(n))
        pos = jnp.asarray([int(plen)], jnp.int32)

        ring = jnp.full((self.cfg.sampling.repetition_window,), -1, jnp.int32)
        key = smp.host_prng_key(int.from_bytes(os.urandom(4), "little"))
        out_tokens = 0
        for i in range(self.cfg.max_tokens):
            key, k1 = jax.random.split(key)
            code0 = int(self._sample(tp, hidden, ring, jnp.int32(out_tokens),
                                     jnp.int32(n), k1))
            if code0 == CODEC_EOS_ID or code0 >= NUM_AUDIO_CODES:
                break
            try:
                conn.sendall(struct.pack("<i", code0))
                conn.sendall(np.asarray(hidden[0], np.float32).tobytes())
            except (BrokenPipeError, ConnectionResetError):
                return
            out_tokens += 1
            ring = smp.ring_push(ring, jnp.int32(code0))

            fb_data = _recv_exact(conn, self.cfg.talker.hidden_size * 4)
            if fb_data is None:
                return
            feedback = jnp.asarray(
                np.frombuffer(fb_data, np.float32).copy()[None],
                hidden.dtype)
            hidden, kv = self._step(tp, feedback, pos, kv)
            pos = pos + 1

        try:
            conn.sendall(struct.pack("<i", SENTINEL_DONE))
        except (BrokenPipeError, ConnectionResetError):
            pass


class CodePredictorCompatServer(_SocketServer):
    """The CP protocol: one connection per token, [hidden][code_0] -> 15."""

    def __init__(self, params, cfg: TTSConfig,
                 socket_path: str = "/tmp/qwen3_cp.sock"):
        super().__init__(socket_path)
        self.params = params
        self.cfg = cfg

        def predict_fn(tp, cpp, hidden, code0, key):
            c0e = tp["codec_embedding"][code0][None]
            return cp.predict_codes(cpp, hidden[None], c0e, key,
                                    cfg.code_predictor, cfg.sampling)[0]

        self._predict = jax.jit(predict_fn)

    def handle(self, conn):
        H = self.cfg.talker.hidden_size
        hidden_data = _recv_exact(conn, H * 4)
        if hidden_data is None:
            return
        code_data = _recv_exact(conn, 4)
        if code_data is None:
            return
        code0 = struct.unpack("<i", code_data)[0]
        hidden = jnp.asarray(np.frombuffer(hidden_data, np.float32).copy())
        key = smp.host_prng_key(int.from_bytes(os.urandom(4), "little"))
        codes = np.asarray(self._predict(
            self.params["talker"], self.params["code_predictor"],
            hidden, jnp.int32(code0), key), np.int32)
        conn.sendall(codes[:15].tobytes())


class VocoderCompatServer(_SocketServer):
    """The vocoder protocol: [n][codes i64 n*16] -> [n_samples][i16...]."""

    def __init__(self, params, cfg: TTSConfig,
                 socket_path: str = "/tmp/qwen3_voc.sock"):
        super().__init__(socket_path)
        self.params = params
        self.cfg = cfg
        self._decode = jax.jit(
            lambda vp, codes: voc.decode(vp, codes, cfg.vocoder))

    def handle(self, conn):
        header = _recv_exact(conn, 4)
        if header is None:
            return
        n_tokens = struct.unpack("<i", header)[0]
        if n_tokens <= 0 or n_tokens > 10000:  # reference bound
            return
        data = _recv_exact(conn, n_tokens * 16 * 8)
        if data is None:
            return
        codes = np.frombuffer(data, np.int64).reshape(n_tokens, 16)
        audio = voc.synthesize_chunked(
            lambda ch: self._decode(self.params["vocoder"], jnp.asarray(ch)),
            codes.astype(np.int32), VOC_CHUNK_SIZE, VOC_OVERLAP)
        audio_i16 = voc.to_int16(audio)
        conn.sendall(struct.pack("<i", len(audio_i16)))
        conn.sendall(audio_i16.tobytes())


def launch_all(params, cfg: TTSConfig, tokenizer,
               talker_sock="/tmp/qwen3_talker.sock",
               cp_sock="/tmp/qwen3_cp.sock",
               voc_sock="/tmp/qwen3_voc.sock"):
    """Start all three compat servers on daemon threads; returns the server
    objects (call .stop() on each). The process-supervision analog of the
    reference's launch_qwen3_tts.sh."""
    servers = [
        TalkerCompatServer(params, cfg, tokenizer, talker_sock),
        CodePredictorCompatServer(params, cfg, cp_sock),
        VocoderCompatServer(params, cfg, voc_sock),
    ]
    threads = []
    for s in servers:
        t = threading.Thread(target=s.serve, daemon=True)
        t.start()
        threads.append(t)
    return servers, threads
