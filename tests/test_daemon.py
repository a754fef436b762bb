"""Daemon serving tests: request/response framing end-to-end over the real
Unix socket (both the native C++ accept loop and the Python fallback)."""

import threading
import time
import os

import numpy as np
import jax.numpy as jnp
import pytest

from qwen3_tts_tpu.config import tiny_tts_config
from qwen3_tts_tpu.engine.engine import TTSEngine
from qwen3_tts_tpu.serve.daemon import DaemonClient, TTSDaemon
from qwen3_tts_tpu.runtime import native


@pytest.fixture(scope="module")
def engine():
    return TTSEngine(tiny_tts_config(max_tokens=8), model_dir=None,
                     dtype=jnp.float32)


def _run_daemon(engine, sock_path, native_loop):
    daemon = TTSDaemon(engine, sock_path)
    t = threading.Thread(target=daemon.serve,
                         kwargs={"native_loop": native_loop}, daemon=True)
    t.start()
    deadline = time.time() + 10
    while not os.path.exists(sock_path) and time.time() < deadline:
        time.sleep(0.05)
    assert os.path.exists(sock_path), "daemon socket never appeared"
    return daemon, t


@pytest.mark.parametrize("native_loop", [False, True])
def test_daemon_roundtrip(engine, tmp_path, native_loop):
    if native_loop and not native.available():
        pytest.skip("libttsrt not built")
    sock = str(tmp_path / f"tts_{native_loop}.sock")
    daemon, t = _run_daemon(engine, sock, native_loop)
    try:
        client = DaemonClient(sock)
        header, audio = client.synthesize("hello", language="english", seed=1)
        assert header["n_tokens"] > 0
        assert header["n_samples"] == len(audio)
        assert header["n_samples"] == header["n_tokens"] * 1920
        assert audio.dtype == np.int16

        # error path: bad language -> error header, no crash
        with pytest.raises(RuntimeError):
            client.synthesize("x", language="klingon")

        # daemon still alive after the error
        header2, _ = client.synthesize("again", language="russian", seed=2)
        assert header2["n_tokens"] > 0
    finally:
        daemon.stop()
        t.join(timeout=5)


@pytest.mark.parametrize("native_loop", [False, True])
def test_daemon_chunked_streaming(engine, tmp_path, native_loop):
    """Chunked response framing (round-1 VERDICT item 7): audio frames
    must leave the daemon BEFORE the final stats frame — the first frame's
    arrival is strictly earlier than stream completion — and the
    concatenated stream must equal the blob response for the same seed."""
    if native_loop and not native.available():
        pytest.skip("libttsrt not built")
    sock = str(tmp_path / f"tts_stream_{native_loop}.sock")
    daemon, t = _run_daemon(engine, sock, native_loop)
    try:
        client = DaemonClient(sock)
        arrivals = []

        def on_chunk(header, audio):
            arrivals.append((time.perf_counter(), dict(header), len(audio)))

        hdr, audio = client.synthesize("stream me", language="english",
                                       seed=3, stream=True,
                                       on_chunk=on_chunk)
        t_done = time.perf_counter()
        assert hdr.get("done") is True
        assert hdr["n_tokens"] > 0
        # at least one audio frame arrived before the final frame
        audio_frames = [a for a in arrivals if "chunk" in a[1]]
        assert len(audio_frames) >= 1
        assert audio_frames[0][0] < t_done
        assert sum(a[2] for a in audio_frames) == len(audio)
        assert len(audio) == hdr["n_tokens"] * 1920

        # stream == blob for the same seed (same fused loop)
        hdr_blob, audio_blob = client.synthesize("stream me",
                                                 language="english", seed=3)
        np.testing.assert_array_equal(audio, audio_blob)
    finally:
        daemon.stop()
        t.join(timeout=5)


def test_daemon_honors_max_tokens(engine, tmp_path):
    """The documented per-request max_tokens field must actually bound
    generation (round-1 advisor finding)."""
    sock = str(tmp_path / "tts_mt.sock")
    daemon, t = _run_daemon(engine, sock, native_loop=False)
    try:
        client = DaemonClient(sock)
        full_hdr, _ = client.synthesize("cap me please", language="english",
                                        seed=0)
        assert full_hdr["n_tokens"] > 2  # the cap below is binding
        hdr, audio = client.synthesize("cap me please", language="english",
                                       seed=0, max_tokens=2)
        assert hdr["n_tokens"] <= 2
        assert len(audio) == hdr["n_tokens"] * 1920
    finally:
        daemon.stop()
        t.join(timeout=5)


def test_daemon_batched_concurrent(engine, tmp_path):
    """Batched daemon: concurrent clients share the decode batch."""
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    sock = str(tmp_path / "tts_batched.sock")
    batcher = ContinuousBatcher(engine.cfg, engine.params, batch_size=2,
                                decode_chunk=4, dtype=jnp.float32)
    daemon = TTSDaemon(engine, sock, batcher=batcher)
    t = threading.Thread(target=daemon.serve, daemon=True)
    t.start()
    deadline = time.time() + 10
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    assert os.path.exists(sock)
    try:
        client = DaemonClient(sock)
        results = {}

        def call(i):
            results[i] = client.synthesize(f"req {i}", language="english",
                                           seed=i)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert len(results) == 3
        for i, (hdr, audio) in results.items():
            assert hdr["n_samples"] == len(audio) == hdr["n_tokens"] * 1920
    finally:
        daemon.stop()
        t.join(timeout=10)


def test_daemon_batched_prompt_dir(engine, tmp_path):
    """Batched mode serves voice cloning: a prompt_dir request decodes
    with the cloned prefix (codes differ from the plain request, same
    seed), and a BAD prompt_dir returns an explicit client error."""
    import numpy as _np
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    d = tmp_path / "voice"
    d.mkdir()
    V = engine.cfg.code_predictor.group_vocab_size
    rng = _np.random.default_rng(5)
    _np.save(d / "ref_codec_tokens.npy",
             rng.integers(0, V, (6, 16)).astype(_np.int64))
    (d / "ref_text.txt").write_text("ref transcript")

    sock = str(tmp_path / "tts_b2.sock")
    batcher = ContinuousBatcher(engine.cfg, engine.params, batch_size=2,
                                decode_chunk=4, dtype=jnp.float32)
    daemon = TTSDaemon(engine, sock, batcher=batcher)
    t = threading.Thread(target=daemon.serve, daemon=True)
    t.start()
    deadline = time.time() + 10
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    try:
        import pytest as _pytest
        hdr_c, audio_c = DaemonClient(sock).synthesize(
            "hi", language="english", prompt_dir=str(d))
        hdr_p, audio_p = DaemonClient(sock).synthesize(
            "hi", language="english")
        assert hdr_c["n_tokens"] > 0
        assert len(audio_c) == hdr_c["n_tokens"] * 1920
        # the prompt conditions the decode
        assert (hdr_c["n_tokens"] != hdr_p["n_tokens"]
                or not _np.array_equal(audio_c, audio_p))
        with _pytest.raises(RuntimeError, match="prompt_dir"):
            DaemonClient(sock).synthesize("hi", language="english",
                                          prompt_dir="/nonexistent")
    finally:
        daemon.stop()
        t.join(timeout=10)


def test_daemon_survives_malformed_requests(engine, tmp_path):
    """Failure-detection parity (SURVEY §5): garbage bytes, truncated
    frames and non-JSON payloads must produce error responses or clean
    closes — never kill the daemon."""
    import json as _json
    import socket as _socket
    import struct as _struct

    sock = str(tmp_path / "tts_err.sock")
    daemon = TTSDaemon(engine, sock)
    t = threading.Thread(target=lambda: daemon.serve(native_loop=False),
                         daemon=True)
    t.start()
    deadline = time.time() + 10
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    try:
        # 1. non-JSON payload -> error header
        c = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        c.connect(sock)
        payload = b"\x00not json at all"
        c.sendall(_struct.pack("<I", len(payload)) + payload)
        raw = c.recv(4)
        n = _struct.unpack("<I", raw)[0]
        buf = b""
        while len(buf) < n:
            buf += c.recv(n - len(buf))
        hdr_len = _struct.unpack("<I", buf[:4])[0]
        hdr = _json.loads(buf[4:4 + hdr_len])
        assert "error" in hdr
        c.close()

        # 2. truncated frame (declared 100 bytes, send 3, hang up)
        c = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
        c.connect(sock)
        c.sendall(_struct.pack("<I", 100) + b"abc")
        c.close()

        # 3. daemon still serves real requests afterwards
        hdr, audio = DaemonClient(sock).synthesize("still alive",
                                                   language="english")
        assert hdr["n_tokens"] > 0 and len(audio) > 0
    finally:
        daemon.stop()
        t.join(timeout=10)


def test_daemon_batched_chunked_streaming(engine, tmp_path):
    """Batched daemon + "stream": true — frames arrive at decode-chunk
    cadence and concatenate to the final audio (previously rejected as
    engine-mode only)."""
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    sock = str(tmp_path / "tts_bstream.sock")
    batcher = ContinuousBatcher(engine.cfg, engine.params, batch_size=2,
                                decode_chunk=4, dtype=jnp.float32)
    daemon = TTSDaemon(engine, sock, batcher=batcher)
    t = threading.Thread(target=daemon.serve, daemon=True)
    t.start()
    deadline = time.time() + 10
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    try:
        client = DaemonClient(sock)
        frames = []
        hdr, audio = client.synthesize("stream via batch", seed=3,
                                       language="english", stream=True,
                                       on_chunk=lambda h, a: frames.append(
                                           (h, a)))
        assert hdr["done"] and hdr["n_tokens"] > 0
        assert hdr["n_samples"] == hdr["n_tokens"] * 1920
        chunk_frames = [a for h, a in frames if not h.get("done")]
        assert len(chunk_frames) >= 1
        np.testing.assert_array_equal(np.concatenate(chunk_frames), audio)
        # parity with a plain batched request, same seed
        hdr2, audio2 = client.synthesize("stream via batch", seed=3,
                                         language="english")
        np.testing.assert_array_equal(audio, audio2)
    finally:
        daemon.stop()
        t.join(timeout=10)


def test_daemon_stats_endpoint(engine, tmp_path):
    """{"cmd": "stats"} returns aggregate serving counters: request and
    error counts, token/audio totals, and latency percentiles over the
    recent window — the observability surface a resident daemon needs
    (the reference prints per-request stdout lines only, SURVEY §5)."""
    sock = str(tmp_path / "tts_stats.sock")
    daemon, t = _run_daemon(engine, sock, native_loop=False)
    try:
        client = DaemonClient(sock)
        s0 = client.stats()
        assert s0["mode"] == "engine"
        assert s0["requests"] == 0 and s0["errors"] == 0
        assert s0["rtf"] is None  # no data yet

        hdr1, _ = client.synthesize("count me", language="english", seed=1)
        hdr2, _ = client.synthesize("count me too", language="russian",
                                    seed=2)
        with pytest.raises(RuntimeError):
            client.synthesize("x", language="klingon")

        s = client.stats()
        assert s["requests"] == 2
        assert s["errors"] == 1
        assert s["tokens"] == hdr1["n_tokens"] + hdr2["n_tokens"]
        assert s["audio_seconds"] == pytest.approx(
            s["tokens"] * 1920 / 24000.0, abs=0.02)
        assert s["rtf"]["n"] == 2 and s["rtf"]["p50"] > 0
        assert s["total_seconds"]["p95"] >= s["total_seconds"]["p50"] > 0
        assert s["uptime_seconds"] >= 0
        # stats queries are not counted as requests
        assert client.stats()["requests"] == 2
    finally:
        daemon.stop()
        t.join(timeout=5)


def test_daemon_stats_batched(engine, tmp_path):
    """Batched-mode stats include scheduler occupancy."""
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    sock = str(tmp_path / "tts_stats_b.sock")
    batcher = ContinuousBatcher(engine.cfg, engine.params, batch_size=2,
                                decode_chunk=4, dtype=jnp.float32)
    daemon = TTSDaemon(engine, sock, batcher=batcher)
    t = threading.Thread(target=daemon.serve, daemon=True)
    t.start()
    deadline = time.time() + 10
    while not os.path.exists(sock) and time.time() < deadline:
        time.sleep(0.05)
    try:
        client = DaemonClient(sock)
        hdr, _ = client.synthesize("batched stats", language="english",
                                   seed=3)
        s = client.stats()
        assert s["mode"] == "batched"
        assert s["requests"] == 1
        assert s["tokens"] == hdr["n_tokens"]
        occ = s["batcher"]
        assert occ["batch_size"] == 2
        assert occ["active_slots"] == 0 and occ["queued"] == 0
        assert occ["paged"] is False
        # streamed batched requests are counted too (with first-audio)
        client.synthesize("batched stream stats", language="english",
                          seed=4, stream=True)
        s2 = client.stats()
        assert s2["requests"] == 2
        assert s2["first_audio_seconds"]["n"] >= 1
    finally:
        daemon.stop()
        t.join(timeout=10)


def test_daemon_main_sigterm_graceful(tmp_path):
    """`python -m ...daemon` shuts down cleanly on SIGTERM: exit code 0,
    socket unlinked (reference parity: launch_qwen3_tts.sh's EXIT-trap
    cleanup, :70-83 — here one process owns the socket lifecycle)."""
    import signal
    import subprocess
    import sys

    sock = str(tmp_path / "sig.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "qwen3_tts_tpu.serve.daemon",
         "--tiny", "--platform", "cpu", "--socket", sock, "--python_loop"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        # engine init + warmup synthesis: ~50 s with a warm persistent
        # compile cache, ~190 s on a cold one (first run on a machine)
        deadline = time.time() + 420
        while not os.path.exists(sock):
            assert proc.poll() is None, (
                "daemon died before listening:\n"
                + proc.stdout.read().decode(errors="replace"))
            assert time.time() < deadline, "daemon socket never appeared"
            time.sleep(0.1)
        # live round trip, then SIGTERM mid-idle
        client = DaemonClient(sock)
        header, _ = client.synthesize("signal", language="english", seed=1)
        assert header["n_tokens"] > 0
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out.decode(errors="replace")
        assert "shutting down" in out.decode(errors="replace")
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_stop_before_serve_is_sticky(engine, tmp_path):
    """A stop() that lands before serve() enters its loop must win:
    serve() returns promptly instead of erasing the stop and blocking
    forever (review finding: the native loop used to reset the stop flag
    at entry, losing a SIGTERM that raced the worker-thread startup)."""
    daemon = TTSDaemon(engine, str(tmp_path / "sticky.sock"))
    daemon.stop()
    t0 = time.time()
    daemon.serve()  # native loop when built, python loop otherwise
    assert time.time() - t0 < 5.0


def test_serve_python_bind_failure_raises(engine):
    """Socket-path failures surface as exceptions, not silent returns."""
    import pytest

    daemon = TTSDaemon(engine, "/nonexistent_dir_xyz/d.sock")
    with pytest.raises(OSError):
        daemon.serve(native_loop=False)


def test_daemon_main_exit_nonzero_on_serve_failure(tmp_path):
    """main() must exit non-zero when the serve loop dies (review
    finding: the worker-thread move made crashes exit 0, so supervisors
    with Restart=on-failure never restarted a dead daemon)."""
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-m", "qwen3_tts_tpu.serve.daemon",
         "--tiny", "--platform", "cpu", "--python_loop",
         "--socket", "/nonexistent_dir_xyz/d.sock"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=420)
    out = proc.stdout.decode(errors="replace")
    assert proc.returncode == 1, out
    assert "serve loop failed" in out


def test_daemon_main_batched_warmup_and_sigterm(tmp_path):
    """`qwen3-tts-daemon --batch N`: the warmup now runs THROUGH the
    batcher (the tier that actually serves), the daemon then serves a
    batched request, and SIGTERM still drains cleanly (exit 0, socket
    unlinked)."""
    import signal
    import subprocess
    import sys

    sock = str(tmp_path / "batched_sig.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "qwen3_tts_tpu.serve.daemon",
         "--tiny", "--platform", "cpu", "--socket", sock,
         "--batch", "2", "--decode_chunk", "4", "--python_loop"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 420
        while not os.path.exists(sock):
            assert proc.poll() is None, (
                "daemon died before listening:\n"
                + proc.stdout.read().decode(errors="replace"))
            assert time.time() < deadline, "daemon socket never appeared"
            time.sleep(0.1)
        client = DaemonClient(sock)
        header, audio = client.synthesize("batched signal", seed=2,
                                          language="english")
        assert header["n_tokens"] > 0
        assert len(audio) == header["n_tokens"] * 1920
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90)
        assert proc.returncode == 0, out.decode(errors="replace")
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_daemon_main_mesh_flags(tmp_path):
    """`qwen3-tts-daemon --batch 4 --tp 2 --dp 2`: the serving entry
    point itself runs the batched tier over a dp x tp mesh (SURVEY §7.6
    'continuous batching across a 4-device mesh' as a user-facing flag, not
    a library-only capability). The daemon must report the mesh, serve a
    request, and drain on SIGTERM."""
    import signal
    import subprocess
    import sys

    sock = str(tmp_path / "mesh.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "qwen3_tts_tpu.serve.daemon",
         "--tiny", "--platform", "cpu", "--socket", sock,
         "--batch", "4", "--decode_chunk", "4", "--tp", "2", "--dp", "2",
         "--python_loop"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 420
        while not os.path.exists(sock):
            assert proc.poll() is None, (
                "daemon died before listening:\n"
                + proc.stdout.read().decode(errors="replace"))
            assert time.time() < deadline, "daemon socket never appeared"
            time.sleep(0.1)
        client = DaemonClient(sock)
        header, audio = client.synthesize("mesh daemon", seed=3,
                                          language="english")
        assert header["n_tokens"] > 0
        assert len(audio) == header["n_tokens"] * 1920
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=90)
        text = out.decode(errors="replace")
        assert proc.returncode == 0, text
        assert "mesh dp2xtp2 over 4 device(s)" in text
        assert not os.path.exists(sock)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_daemon_mesh_flags_validation():
    """--dp/--tp misuse fails fast at argparse level (exit 2), before any
    engine build: mesh flags without --batch, and a batch size the dp
    extent can't divide."""
    import pytest

    from qwen3_tts_tpu.serve import daemon as daemon_mod

    with pytest.raises(SystemExit) as e:
        daemon_mod.main(["--tiny", "--platform", "cpu", "--tp", "2"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        daemon_mod.main(["--tiny", "--platform", "cpu", "--batch", "3",
                         "--tp", "2", "--dp", "2"])
    assert e.value.code == 2


def test_batched_stream_dead_client_cancels(engine, tmp_path):
    """A streaming send failure (dead client) must mark the in-flight
    request cancelled so the scheduler evicts it instead of decoding the
    rest of the utterance for nobody (the reference's client-disconnect
    detection, llamacpp_talker_server.py:264-268, as batched eviction)."""
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    batcher = ContinuousBatcher(engine.cfg, engine.params, batch_size=2,
                                decode_chunk=2, dtype=jnp.float32)
    batcher.start()
    daemon = TTSDaemon(engine, str(tmp_path / "unused.sock"),
                       batcher=batcher)
    sent = [0]

    def dying_send(frame: bytes) -> None:
        sent[0] += 1
        if sent[0] > 1:   # first frame OK, then the client is gone
            raise OSError("broken pipe")

    try:
        out = daemon._handle_batched(
            {"text": "stream to a dead client", "stream": True, "seed": 2},
            "stream to a dead client", None, dying_send)
        assert out is None   # stream mode always returns None
        # the handler must have withdrawn the request on the send failure
        # (either it was evicted mid-decode, or it finished first — both
        # leave no slot occupied and the scheduler healthy)
        deadline = time.time() + 30
        while any(r is not None for r in batcher._slot_req):
            assert time.time() < deadline, "dead client's slot never freed"
            time.sleep(0.05)
        # scheduler still serves
        ids = np.zeros(8, np.int32); ids[:2] = [104, 105]
        codes, audio = batcher.submit(ids, 2, seed=3).result(timeout=120)
        assert len(audio) == len(codes) * 1920
    finally:
        batcher.stop()


def test_reject_dead_stream_client_counts_one_error(engine):
    """A validation rejection whose stream client already disconnected
    must record exactly ONE error: _reject swallows the send failure
    instead of letting it re-enter handle()'s catch-all, which counted a
    second error and attempted a second done-frame (round-3 review)."""
    import json

    from qwen3_tts_tpu.serve.batching import ContinuousBatcher
    from qwen3_tts_tpu.serve.daemon import TTSDaemon

    batcher = ContinuousBatcher(engine.cfg, engine.params, batch_size=2,
                                decode_chunk=4, dtype=jnp.float32)
    daemon = TTSDaemon(engine, "/tmp/unused_reject.sock", batcher=batcher)
    sends = []

    def dead_send(frame: bytes) -> None:
        sends.append(frame)
        raise BrokenPipeError("client went away")

    before = daemon.stats.snapshot()["errors"]
    out = daemon.handle(json.dumps(
        {"text": "hi", "language": "klingon", "stream": True}).encode(),
        dead_send)
    assert out is None
    assert len(sends) == 1                       # no second done-frame
    assert daemon.stats.snapshot()["errors"] == before + 1


def test_python_loop_rejects_oversized_frame(engine, tmp_path):
    """First-party ingest bound (round-4 VERDICT Weak #4): a client
    declaring a frame length past MAX_REQUEST_BYTES gets a structured
    too_large error frame WITHOUT the daemon allocating or reading the
    body — mirroring the native loop's max_req (native/ttsrt.cc) and the
    reference's 64 KiB message bound (llamacpp_talker_server.py:337-340).
    The daemon keeps serving afterwards."""
    import socket
    import struct

    from qwen3_tts_tpu.serve.daemon import (MAX_REQUEST_BYTES,
                                            _recv_exact, decode_response)

    sock_path = str(tmp_path / "tts_big.sock")
    daemon, t = _run_daemon(engine, sock_path, native_loop=False)
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(sock_path)
            s.settimeout(30)
            s.sendall(struct.pack("<I", MAX_REQUEST_BYTES + 1))
            raw = _recv_exact(s, 4)
            assert raw is not None, "connection closed without error frame"
            n = struct.unpack("<I", raw)[0]
            payload = _recv_exact(s, n)
            header, _ = decode_response(payload)
            assert header.get("code") == "too_large", header
            assert "error" in header
        # the daemon survives and still serves real requests
        client = DaemonClient(sock_path)
        hdr, _ = client.synthesize("after big", language="english", seed=1)
        assert hdr["n_tokens"] > 0
    finally:
        daemon.stop()
        t.join(timeout=5)


def test_daemon_refuses_multiprocess_env(monkeypatch):
    """The request-driven daemon must refuse QWEN3_TTS_NUM_PROCESSES>1
    BEFORE jax.distributed.initialize (round-4 ADVICE: per-process
    request arrival violates multi-controller lockstep, and a post-init
    p.error would strand peer processes in their init barrier). Refusal
    is immediate — this test would hang on the bogus coordinator if
    init_distributed ran first."""
    import pytest

    from qwen3_tts_tpu.serve import daemon as daemon_mod

    monkeypatch.setenv("QWEN3_TTS_NUM_PROCESSES", "2")
    monkeypatch.setenv("QWEN3_TTS_COORDINATOR", "localhost:1")
    with pytest.raises(SystemExit) as e:
        daemon_mod.main(["--tiny", "--platform", "cpu",
                         "--batch", "4", "--tp", "2"])
    assert e.value.code == 2
