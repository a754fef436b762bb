"""Weight-only int8 quantization tests: numerics, matmul shapes,
end-to-end engine smoke."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from qwen3_tts_tpu.ops import quant


def test_quantize_roundtrip_error_small():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 96), scale=0.05).astype(np.float32)
    qt = quant.quantize_int8(jnp.asarray(w))
    assert qt.q.dtype == jnp.int8
    deq = np.asarray(quant.dequantize(qt, jnp.float32))
    # per-channel int8: max error <= scale/2 per element
    scales = np.asarray(qt.scale)
    assert (np.abs(deq - w) <= scales[None, :] * 0.5 + 1e-8).all()


def test_matmul_quant_close_to_dense():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 64), scale=0.5).astype(np.float32)
    w = rng.normal(size=(64, 128), scale=0.05).astype(np.float32)
    dense = np.asarray(quant.matmul(jnp.asarray(x), jnp.asarray(w)))
    qt = quant.quantize_int8(jnp.asarray(w))
    qout = np.asarray(quant.matmul(jnp.asarray(x), qt))
    rel = np.abs(qout - dense).max() / (np.abs(dense).max() + 1e-9)
    assert rel < 0.02, rel


def test_qtensor_indexing_and_scan_slicing():
    w = jnp.ones((3, 8, 16)) * jnp.arange(1, 4)[:, None, None]
    qt = quant.quantize_int8(w)
    q1 = qt[1]
    assert q1.q.shape == (8, 16) and q1.scale.shape == (16,)
    np.testing.assert_allclose(np.asarray(quant.dequantize(q1, jnp.float32)),
                               np.asarray(w[1]), rtol=1e-2)

    # lax.scan must slice QTensor leaves along the leading axis
    def body(c, qlayer):
        return c + quant.dequantize(qlayer, jnp.float32).sum(), None

    total, _ = jax.lax.scan(body, jnp.float32(0), qt)
    np.testing.assert_allclose(float(total), float(w.sum()), rtol=1e-2)


@pytest.mark.parametrize("shape", [(1, 256), (8, 256), (32, 256),
                                   (2, 3, 256)])
def test_int8_matmul_matches_dequantized_dot(shape):
    """quant.matmul with int8 weights equals x @ (q * scale) in float32
    for decode row counts M in {1, 8, 32} and a 3-D (B, T, K) input, and
    returns float32 of shape (..., N)."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape, scale=0.5).astype(np.float32)
    w = rng.normal(size=(256, 96), scale=0.05).astype(np.float32)
    qt = quant.quantize_int8(jnp.asarray(w))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = quant.matmul(xb, qt)
    assert got.shape == shape[:-1] + (96,) and got.dtype == jnp.float32
    want = (np.asarray(xb, np.float32)
            @ np.asarray(qt.q, np.float32)) * np.asarray(qt.scale)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_quantized_decode_close_to_dense():
    """A quantized tiny talker decode step stays close to the dense one."""
    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.models import talker as tk
    from qwen3_tts_tpu.models import transformer as tfm

    cfg = tiny_tts_config().talker
    tp = tk.init_talker_params(jax.random.PRNGKey(0), cfg)
    tpq = quant.quantize_talker(tp)
    geo = tfm.geometry_of(cfg)
    kv = tfm.init_kv_cache(geo, 1, 32)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, cfg.hidden_size)) * 0.3

    hd, _ = tk.decode_step(tp, x, jnp.array([0]), kv, cfg)
    hq, _ = tk.decode_step(tpq, x, jnp.array([0]), kv, cfg)
    cos = float(jnp.sum(hd * hq) /
                (jnp.linalg.norm(hd) * jnp.linalg.norm(hq) + 1e-9))
    assert cos > 0.999, cos


def test_engine_quantized_smoke():
    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.engine.engine import TTSEngine

    eng = TTSEngine(tiny_tts_config(max_tokens=6), model_dir=None,
                    dtype=jnp.float32, quantize="int8")
    res = eng.synthesize("hi", language="english", seed=0)
    assert res.n_tokens >= 0
    if res.n_tokens:
        assert (res.codes < 2048).all()


# ---------------------------------------------------------------------------
# Pre-quantized artifacts (convert_weights.py --quantize; the reference
# ships GGUF Q4_K_M / GGML Q4_0 artifacts the same way, README.md:82-90)
# ---------------------------------------------------------------------------

def test_prequantized_npz_roundtrip(tmp_path):
    """QTensor pytrees survive save_pytree_npz/load_pytree_npz bit-exactly
    (int8 q, float32 scale); the derived layers_list is never stored."""
    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.io import weights as weights_io
    from qwen3_tts_tpu.models import talker as tk

    cfg = tiny_tts_config().talker
    tp = quant.quantize_talker(
        tk.init_talker_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    path = str(tmp_path / "params.npz")
    weights_io.save_pytree_npz(path, {"talker": tp})

    with np.load(path) as data:
        assert not any("layers_list" in k for k in data.files)
        assert any(k.endswith("::q8") for k in data.files)

    got = weights_io.load_pytree_npz(path)["talker"]
    assert "layers_list" not in got
    for name in ("qkv_proj", "gateup_proj", "o_proj", "down_proj"):
        a, b = tp["layers"][name], got["layers"][name]
        assert isinstance(b, quant.QTensor)
        np.testing.assert_array_equal(np.asarray(a.q), np.asarray(b.q))
        assert b.scale.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(a.scale),
                                      np.asarray(b.scale))
    assert isinstance(got["codec_head"], quant.QTensor)

    # the load_params dtype cast must not touch QTensor leaves (scales
    # stay float32 by contract) while still casting dense floats
    loaded = weights_io.load_params(str(tmp_path), tiny_tts_config(),
                                    dtype=jnp.bfloat16)
    qkv = loaded["talker"]["layers"]["qkv_proj"]
    assert isinstance(qkv, quant.QTensor) and qkv.scale.dtype == jnp.float32
    assert loaded["talker"]["codec_embedding"].dtype == jnp.bfloat16


def test_engine_prequantized_artifact_matches_runtime_quant(tmp_path):
    """An engine loading a pre-quantized params.npz (auto-detected, no
    quantize= argument) produces the SAME codes as one that quantizes the
    same base weights at init — the artifact is just the init-time
    quantization moved offline."""
    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.io import weights as weights_io

    cfg = tiny_tts_config(max_tokens=8)
    base = weights_io.init_random_params(cfg, seed=0, dtype=jnp.float32)

    eng_rt = TTSEngine(cfg, model_dir=None, dtype=jnp.float32,
                       params=dict(base), quantize="int8")
    assert eng_rt.quantize == "int8"

    art = dict(base)
    art["talker"] = jax.jit(quant.quantize_talker)(base["talker"])
    art["code_predictor"] = jax.jit(quant.quantize_code_predictor)(
        base["code_predictor"])
    d = tmp_path / "prequant_ckpt"
    d.mkdir()
    weights_io.save_pytree_npz(str(d / "params.npz"), art, config=cfg)

    eng_pre = TTSEngine(cfg=None, model_dir=str(d), dtype=jnp.float32)
    assert eng_pre.cfg == cfg
    assert eng_pre.quantize == "int8"  # auto-detected
    assert isinstance(eng_pre.params["talker"]["layers"]["qkv_proj"],
                      quant.QTensor)
    assert "layers_list" in eng_pre.params["talker"]

    a = eng_rt.synthesize("prequantized artifact", language="english",
                          seed=3)
    b = eng_pre.synthesize("prequantized artifact", language="english",
                           seed=3)
    assert a.n_tokens == b.n_tokens > 0
    np.testing.assert_array_equal(a.codes, b.codes)
    np.testing.assert_array_equal(a.audio_int16, b.audio_int16)


def test_engine_prequantized_cp_only_artifact(tmp_path):
    """An int8-cp artifact (bf16 talker, QTensor CP) auto-detects as the
    int8-cp tier; asking for quantize='int8' on top quantizes the talker
    at init."""
    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.io import weights as weights_io

    cfg = tiny_tts_config(max_tokens=6)
    base = weights_io.init_random_params(cfg, seed=1, dtype=jnp.float32)
    art = dict(base)
    art["code_predictor"] = jax.jit(quant.quantize_code_predictor)(
        base["code_predictor"])
    d = tmp_path / "cp_ckpt"
    d.mkdir()
    weights_io.save_pytree_npz(str(d / "params.npz"), art, config=cfg)

    eng = TTSEngine(cfg=None, model_dir=str(d), dtype=jnp.float32)
    assert eng.quantize == "int8-cp"
    assert not quant.is_quantized(eng.params["talker"])
    res = eng.synthesize("cp artifact", language="english", seed=0)
    assert res.n_tokens > 0

    eng8 = TTSEngine(cfg=None, model_dir=str(d), dtype=jnp.float32,
                     quantize="int8")
    assert eng8.quantize == "int8"
    assert quant.is_quantized(eng8.params["talker"])


def test_dequantize_talker_rebuilds_dense_layout():
    """dequantize_talker yields the standard unfused dense layout whose
    decode matches the int8 decode (same effective weights)."""
    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.models import talker as tk
    from qwen3_tts_tpu.models import transformer as tfm

    cfg = tiny_tts_config().talker
    tp = tk.init_talker_params(jax.random.PRNGKey(0), cfg,
                               dtype=jnp.float32)
    tpq = quant.quantize_talker(tp)
    tpd = quant.dequantize_talker(tpq, jnp.float32)
    lay = tpd["layers"]
    assert "qkv_proj" not in lay and "layers_list" not in tpd
    for name in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj",
                 "o_proj", "down_proj"):
        assert not isinstance(lay[name], quant.QTensor), name
        assert lay[name].shape == tp["layers"][name].shape, name
    assert not isinstance(tpd["codec_head"], quant.QTensor)

    geo = tfm.geometry_of(cfg)
    kv = tfm.init_kv_cache(geo, 1, 32, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, cfg.hidden_size)) * 0.3
    hq, _ = tk.decode_step(tpq, x, jnp.array([0]), kv, cfg)
    hd, _ = tk.decode_step(tpd, x, jnp.array([0]), kv, cfg)
    cos = float(jnp.sum(hq * hd) /
                (jnp.linalg.norm(hq) * jnp.linalg.norm(hd) + 1e-9))
    assert cos > 0.999, cos


def test_convert_tool_quantized_artifact(tmp_path):
    """convert_weights.py --quantize int8 writes an artifact the engine
    loads and serves (auto-detected int8 tier)."""
    import sys
    tools_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    sys.path.insert(0, tools_dir)
    try:
        from convert_weights import main as cw_main
    finally:
        sys.path.remove(tools_dir)

    from qwen3_tts_tpu.engine.engine import TTSEngine

    d = tmp_path / "art"
    d.mkdir()
    out = str(d / "params.npz")
    rc = cw_main(["--random", "--tiny", "--quantize", "int8",
                  "--dtype", "float32", "--output", out])
    assert rc == 0 and os.path.exists(out)

    eng = TTSEngine(cfg=None, model_dir=str(d), dtype=jnp.float32)
    assert eng.quantize == "int8"
    res = eng.synthesize("tool artifact", language="english", seed=0)
    assert len(res.audio_int16) == res.n_tokens * 1920


def test_batcher_serves_dequantized_prequant_artifact(tmp_path):
    """ContinuousBatcher itself dequantizes a pre-quantized talker to the
    tier's dtype (batching amortizes the weight bytes int8 saves); the
    CP stays QTensor and routes through the
    quantized path. The policy lives in the batcher so every caller
    (daemon, library users, dev tools) gets it."""
    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.io import weights as weights_io
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    cfg = tiny_tts_config(max_tokens=8)
    base = weights_io.init_random_params(cfg, seed=2, dtype=jnp.float32)
    art = dict(base)
    art["talker"] = jax.jit(quant.quantize_talker)(base["talker"])
    art["code_predictor"] = jax.jit(quant.quantize_code_predictor)(
        base["code_predictor"])
    d = tmp_path / "art"
    d.mkdir()
    weights_io.save_pytree_npz(str(d / "params.npz"), art, config=cfg)

    eng = TTSEngine(cfg=None, model_dir=str(d), dtype=jnp.float32)
    assert eng.quantize == "int8"
    # hand the QUANTIZED params straight to the batcher: it owns the
    # dequantize-for-serving policy and must honor the tier's dtype
    batcher = ContinuousBatcher(eng.cfg, eng.params, batch_size=2,
                                decode_chunk=4, dtype=jnp.float32)
    assert not quant.is_quantized(batcher.params["talker"])
    assert (batcher.params["talker"]["layers"]["q_proj"].dtype
            == jnp.float32)
    assert quant.is_quantized(batcher.params["code_predictor"])
    batcher.start()
    try:
        ids, n = eng._encode_text("dequantized artifact")
        codes, audio = batcher.submit(np.asarray(ids), int(n),
                                      seed=1).result(timeout=300)
        assert len(audio) == len(codes) * 1920 and len(codes) > 0
    finally:
        batcher.stop()


def test_engine_prequantized_symmetric_cases(tmp_path):
    """The prequant auto-detect handles every talker/CP combination and
    self.quantize reports the ACTUAL post-init state (review finding):

    - full int8 artifact + quantize='int8-cp' -> talker DEQUANTIZED to
      the engine dtype (the explicit bf16-talker request is honored, not
      silently overridden to 'int8');
    - talker-only artifact + quantize='int8' -> the dense CP is
      quantized at init (the int8 CP kernel tier was asked for);
    - talker-only artifact + quantize=None -> CP stays dense and the
      label says 'int8-talker', not 'int8'.
    """
    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.io import weights as weights_io

    cfg = tiny_tts_config(max_tokens=6)
    base = weights_io.init_random_params(cfg, seed=3, dtype=jnp.float32)

    full = dict(base)
    full["talker"] = jax.jit(quant.quantize_talker)(base["talker"])
    full["code_predictor"] = jax.jit(quant.quantize_code_predictor)(
        base["code_predictor"])
    d_full = tmp_path / "full"
    d_full.mkdir()
    weights_io.save_pytree_npz(str(d_full / "params.npz"), full,
                               config=cfg)

    eng = TTSEngine(cfg=None, model_dir=str(d_full), dtype=jnp.float32,
                    quantize="int8-cp")
    assert eng.quantize == "int8-cp"
    assert not quant.is_quantized(eng.params["talker"])
    assert eng.params["talker"]["layers"]["q_proj"].dtype == jnp.float32
    assert quant.is_quantized(eng.params["code_predictor"])
    res = eng.synthesize("dequantized talker", language="english", seed=0)
    assert res.n_tokens > 0

    tonly = dict(base)
    tonly["talker"] = jax.jit(quant.quantize_talker)(base["talker"])
    d_t = tmp_path / "talker_only"
    d_t.mkdir()
    weights_io.save_pytree_npz(str(d_t / "params.npz"), tonly, config=cfg)

    eng8 = TTSEngine(cfg=None, model_dir=str(d_t), dtype=jnp.float32,
                     quantize="int8")
    assert eng8.quantize == "int8"
    assert quant.is_quantized(eng8.params["code_predictor"])

    eng_none = TTSEngine(cfg=None, model_dir=str(d_t), dtype=jnp.float32)
    assert eng_none.quantize == "int8-talker"
    assert not quant.is_quantized(eng_none.params["code_predictor"])


def test_convert_tool_rejects_requantize_and_keeps_npz_config(tmp_path):
    """Round-tripping a native npz through convert_weights.py must read
    the npz's own embedded __config__ (not stamp the default geometry),
    and --quantize on an already-quantized artifact fails with a clear
    error instead of an AttributeError (review finding)."""
    import sys
    tools_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    sys.path.insert(0, tools_dir)
    try:
        from convert_weights import main as cw_main
    finally:
        sys.path.remove(tools_dir)

    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.io import weights as weights_io

    import dataclasses

    # non-default geometry so a default-config stamp would be detectable
    cfg = tiny_tts_config(max_tokens=6)
    cfg = dataclasses.replace(
        cfg, talker=dataclasses.replace(cfg.talker, num_layers=3))
    base = weights_io.init_random_params(cfg, seed=4, dtype=jnp.float32)
    d = tmp_path / "native"
    d.mkdir()
    weights_io.save_pytree_npz(str(d / "params.npz"), base, config=cfg)

    # dense npz -> quantized npz: geometry must survive the round trip
    out = str(tmp_path / "quant" / "params.npz")
    os.makedirs(os.path.dirname(out))
    rc = cw_main(["--model_dir", str(d), "--quantize", "int8",
                  "--dtype", "float32", "--output", out])
    assert rc == 0
    cfg_rt = weights_io.read_npz_config(out)
    assert cfg_rt is not None
    assert cfg_rt.talker.num_layers == 3

    # already-quantized input + --quantize: clear argparse error
    with pytest.raises(SystemExit):
        cw_main(["--model_dir", os.path.dirname(out),
                 "--quantize", "int8", "--output",
                 str(tmp_path / "again.npz")])


def test_batcher_quantize_talker_prequant_attaches_layer_list(tmp_path):
    """quantize_talker=True over an ALREADY-quantized artifact must
    rebuild layers_list (npz loading strips it): without it talker.decode
    silently falls back to the stacked-scan path and the int8-vs-bf16
    serving A/B measures the wrong implementation (review finding)."""
    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.io import weights as weights_io
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    cfg = tiny_tts_config(max_tokens=8)
    base = weights_io.init_random_params(cfg, seed=5, dtype=jnp.float32)
    art = dict(base)
    art["talker"] = jax.jit(quant.quantize_talker)(base["talker"])
    d = tmp_path / "art"
    d.mkdir()
    weights_io.save_pytree_npz(str(d / "params.npz"), art, config=cfg)

    # plain npz load: QTensor weights survive, layers_list does NOT
    loaded = weights_io.load_params(str(d), cfg, jnp.float32)
    assert quant.is_quantized(loaded["talker"])
    assert "layers_list" not in loaded["talker"]

    batcher = ContinuousBatcher(cfg, loaded, batch_size=2, decode_chunk=4,
                                dtype=jnp.float32, quantize_talker=True)
    assert quant.is_quantized(batcher.params["talker"])
    assert "layers_list" in batcher.params["talker"]
    batcher.start()
    try:
        fut = batcher.submit(np.arange(5, dtype=np.int32), 5, seed=1)
        codes, audio = fut.result(timeout=300)
        assert len(audio) == len(codes) * 1920 and len(codes) > 0
        assert audio.dtype == np.int16
    finally:
        batcher.stop()


def test_batcher_quantize_cp_past_kernel_batch(tmp_path):
    """quantize_cp must quantize the code predictor at ANY batch size,
    past 8 rows included: an earlier constructor guard silently served a
    float CP at batch > 8 (review finding)."""
    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.io import weights as weights_io
    from qwen3_tts_tpu.serve.batching import ContinuousBatcher

    cfg = tiny_tts_config(max_tokens=6)
    params = weights_io.init_random_params(cfg, seed=6, dtype=jnp.float32)
    b = ContinuousBatcher(cfg, params, batch_size=10, decode_chunk=4,
                          dtype=jnp.float32, quantize_cp=True)
    assert quant.is_quantized(b.params["code_predictor"])
    futs = [b.submit(np.arange(4, dtype=np.int32), 4, seed=i)
            for i in range(3)]
    for _ in range(400):
        if all(f.done() for f in futs):
            break
        b.step()
    for f in futs:
        codes, audio = f.result(timeout=1)
        assert len(audio) == len(codes) * 1920 and len(codes) > 0
