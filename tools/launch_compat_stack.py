#!/usr/bin/env python3
"""Launch the reference-protocol compatibility stack.

The supervisor analog of the reference's launch_qwen3_tts.sh (component
#11 in SURVEY §2): brings up the three protocol sockets (talker / code
predictor / vocoder), polls them ready, optionally runs a single-shot
synthesis through them, or stays resident in --daemon mode. The reference
needed three OS processes, taskset pinning, and a PID-cleanup trap; here
the "servers" are threads over the same in-process jitted engine, and the
env-var config surface is preserved:

  TALKER_SOCKET / CP_SOCKET / VOC_SOCKET, TEMPERATURE, TOP_K, MAX_TOKENS,
  LANGUAGE  (reference launch_qwen3_tts.sh:22-52)

Usage:
  python tools/launch_compat_stack.py "Привет, как дела?"
  python tools/launch_compat_stack.py --daemon
  python tools/launch_compat_stack.py --tiny --platform cpu "test"
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("text", nargs="?", default=None)
    p.add_argument("--daemon", action="store_true")
    p.add_argument("--model_dir", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--platform", default="default",
                   choices=["default", "cpu", "cuda"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--output", default="output.wav")
    args = p.parse_args(argv)

    if args.platform != "default":
        import jax
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp

    from qwen3_tts_tpu.config import TTSConfig, tiny_tts_config
    from qwen3_tts_tpu.io import weights as weights_io
    from qwen3_tts_tpu.io.tokenizer import load_tokenizer
    from qwen3_tts_tpu.serve import compat

    cfg = tiny_tts_config(max_tokens=32) if args.tiny else TTSConfig()
    # env-var config surface (reference launch_qwen3_tts.sh:22-52)
    sampling = dataclasses.replace(
        cfg.sampling,
        temperature=float(os.environ.get("TEMPERATURE",
                                         cfg.sampling.temperature)),
        top_k=int(os.environ.get("TOP_K", cfg.sampling.top_k)))
    cfg = dataclasses.replace(
        cfg, sampling=sampling,
        max_tokens=int(os.environ.get("MAX_TOKENS", cfg.max_tokens)))
    language = os.environ.get("LANGUAGE", "russian")

    talker_sock = os.environ.get("TALKER_SOCKET", "/tmp/qwen3_talker.sock")
    cp_sock = os.environ.get("CP_SOCKET", "/tmp/qwen3_cp.sock")
    voc_sock = os.environ.get("VOC_SOCKET", "/tmp/qwen3_voc.sock")

    dtype = jnp.bfloat16 if args.dtype == "bfloat16" else jnp.float32
    print("Loading parameters...")
    params = weights_io.load_params(args.model_dir, cfg, dtype)
    tokenizer = load_tokenizer(args.model_dir)

    print("Starting protocol servers...")
    # unlink stale socket files first: a crashed previous run's leftover
    # path would satisfy an existence poll before the new servers bind
    # (review finding)
    for sp in (talker_sock, cp_sock, voc_sock):
        if os.path.exists(sp):
            os.unlink(sp)
    servers, threads = compat.launch_all(params, cfg, tokenizer,
                                         talker_sock, cp_sock, voc_sock)

    # socket-readiness polling (reference wait_for_socket,
    # launch_qwen3_tts.sh:85-104) — probe with a real connect, not just
    # path existence
    import socket as _socket
    deadline = time.time() + 30
    for sp in (talker_sock, cp_sock, voc_sock):
        while True:
            if os.path.exists(sp):
                probe = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
                try:
                    probe.connect(sp)
                    probe.close()
                    break
                except OSError:
                    probe.close()
            if time.time() > deadline:
                print(f"ERROR: socket {sp} never became connectable")
                return 1
            time.sleep(0.1)
        print(f"  ready: {sp}")

    def cleanup(*_):
        for s in servers:
            s.stop()
        sys.exit(0)

    signal.signal(signal.SIGINT, cleanup)
    signal.signal(signal.SIGTERM, cleanup)

    if args.daemon:
        print("Daemon mode; Ctrl-C to stop.")
        # supervise: exit non-zero if a server thread dies (the reference
        # launcher's liveness checks; review finding — a dead server
        # otherwise left an apparently-healthy process refusing clients)
        while all(t.is_alive() for t in threads):
            time.sleep(1)
        print("ERROR: a protocol server thread died; exiting")
        for s in servers:
            s.stop()
        return 1

    text = args.text or "Привет, как дела? Сегодня хорошая погода для прогулки."
    print(f"Single-shot synthesis: '{text[:50]}'")
    from tools.reference_client import synthesize_via_sockets
    rc = synthesize_via_sockets(text, language, args.output, params,
                                talker_sock, cp_sock, voc_sock)
    for s in servers:
        s.stop()
    return rc


if __name__ == "__main__":
    sys.exit(main())
