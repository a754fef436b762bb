"""HF-checkpoint loading tests (VERDICT round-1 item 4).

Writes a tiny-geometry ``model.safetensors`` with the EXACT production key
names the loaders expect (mirroring reference extract_talker_as_qwen3.py:
53-75, extract_embeddings.py:47-70, export_code_predictor_weights.py:51-74)
plus a ``speech_tokenizer/model.safetensors`` with the decoder's real names,
stores matrices in bf16 like the real checkpoint, and loads through the
whole production path: pure-Python/native safetensors reader ->
io/weights -> TTSEngine synthesis. A key-name or transpose drift now breaks
a test instead of breaking real-weight loading silently.
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

from qwen3_tts_tpu.config import tiny_tts_config
from qwen3_tts_tpu.io import weights as weights_io
from qwen3_tts_tpu.runtime import native

CFG = tiny_tts_config(max_tokens=6)


def _layer_tensors(prefix, i, H, I, q_dim, kv_dim, head_dim, gen):
    def w(*shape):
        return (0.02 * torch.randn(*shape, generator=gen)).to(torch.bfloat16)

    p = f"{prefix}.{i}."
    return {
        p + "input_layernorm.weight": torch.ones(H),
        p + "post_attention_layernorm.weight": torch.ones(H),
        p + "self_attn.q_proj.weight": w(q_dim, H),
        p + "self_attn.k_proj.weight": w(kv_dim, H),
        p + "self_attn.v_proj.weight": w(kv_dim, H),
        p + "self_attn.o_proj.weight": w(H, q_dim),
        p + "self_attn.q_norm.weight": torch.ones(head_dim),
        p + "self_attn.k_norm.weight": torch.ones(head_dim),
        p + "mlp.gate_proj.weight": w(I, H),
        p + "mlp.up_proj.weight": w(I, H),
        p + "mlp.down_proj.weight": w(H, I),
    }


def _talker_cp_state_dict(cfg=CFG):
    """Synthetic checkpoint at tiny geometry with production names."""
    gen = torch.Generator().manual_seed(0)

    def w(*shape):
        return (0.02 * torch.randn(*shape, generator=gen)).to(torch.bfloat16)

    t = cfg.talker
    sd = {}
    for i in range(t.num_layers):
        sd.update(_layer_tensors("talker.model.layers", i, t.hidden_size,
                                 t.intermediate_size, t.q_dim, t.kv_dim,
                                 t.head_dim, gen))
    sd["talker.model.norm.weight"] = torch.ones(t.hidden_size)
    sd["talker.model.text_embedding.weight"] = w(t.text_vocab_size,
                                                 t.text_embed_dim)
    sd["talker.text_projection.linear_fc1.weight"] = w(t.text_embed_dim,
                                                       t.text_embed_dim)
    sd["talker.text_projection.linear_fc1.bias"] = w(t.text_embed_dim)
    sd["talker.text_projection.linear_fc2.weight"] = w(t.hidden_size,
                                                       t.text_embed_dim)
    sd["talker.text_projection.linear_fc2.bias"] = w(t.hidden_size)
    sd["talker.model.codec_embedding.weight"] = w(t.codec_vocab_size,
                                                  t.hidden_size)
    sd["talker.codec_head.weight"] = w(t.codec_vocab_size, t.hidden_size)

    c = cfg.code_predictor
    pre = "talker.code_predictor"
    for i in range(c.num_layers):
        sd.update(_layer_tensors(f"{pre}.model.layers", i, c.hidden_size,
                                 c.intermediate_size, c.q_dim, c.kv_dim,
                                 c.head_dim, gen))
    sd[f"{pre}.model.norm.weight"] = torch.ones(c.hidden_size)
    sd[f"{pre}.small_to_mtp_projection.weight"] = w(c.hidden_size,
                                                    c.hidden_size)
    sd[f"{pre}.small_to_mtp_projection.bias"] = w(c.hidden_size)
    for g in range(c.num_groups):
        sd[f"{pre}.model.codec_embedding.{g}.weight"] = \
            w(c.group_vocab_size, c.hidden_size)
        sd[f"{pre}.lm_head.{g}.weight"] = w(c.group_vocab_size, c.hidden_size)
    return sd


def _voc_state_dict():
    """Synthetic speech-tokenizer decoder state dict with the torch
    module's real tensor names/shapes (see test_vocoder_golden.py for the
    from-the-actual-torch-module variant)."""
    gen = torch.Generator().manual_seed(1)

    def w(*shape):
        return 0.05 * torch.randn(*shape, generator=gen)

    v = CFG.vocoder
    H, I, L = v.hidden_size, v.intermediate_size, v.num_hidden_layers
    sd = {}
    for i in range(L):
        p = f"pre_transformer.layers.{i}."
        sd[p + "input_layernorm.weight"] = torch.ones(H)
        sd[p + "post_attention_layernorm.weight"] = torch.ones(H)
        for n, shape in (("self_attn.q_proj", (H, H)),
                         ("self_attn.k_proj", (H, H)),
                         ("self_attn.v_proj", (H, H)),
                         ("self_attn.o_proj", (H, H)),
                         ("mlp.gate_proj", (I, H)),
                         ("mlp.up_proj", (I, H)),
                         ("mlp.down_proj", (H, I))):
            sd[p + n + ".weight"] = w(*shape)
        sd[p + "self_attn_layer_scale.scale"] = w(H)
        sd[p + "mlp_layer_scale.scale"] = w(H)
    sd["pre_transformer.norm.weight"] = torch.ones(H)
    sd["code_embedding.weight"] = w(v.num_codebooks * v.codebook_size, H)
    for i, f in enumerate(v.upsampling_ratios):
        u = f"upsample.{i}."
        sd[u + "0.conv.weight"] = w(H, H, f)
        sd[u + "0.conv.bias"] = w(H)
        sd[u + "1.dwconv.conv.weight"] = w(H, 1, 7)
        sd[u + "1.dwconv.conv.bias"] = w(H)
        sd[u + "1.norm.weight"] = torch.ones(H)
        sd[u + "1.norm.bias"] = w(H)
        sd[u + "1.pwconv1.weight"] = w(4 * H, H)
        sd[u + "1.pwconv1.bias"] = w(4 * H)
        sd[u + "1.pwconv2.weight"] = w(H, 4 * H)
        sd[u + "1.pwconv2.bias"] = w(H)
        sd[u + "1.gamma"] = w(H)
    D = v.decoder_dim
    sd["decoder.0.conv.weight"] = w(D, H, 7)
    sd["decoder.0.conv.bias"] = w(D)
    cin = D
    for i, r in enumerate(v.upsample_rates):
        cout = D // (2 ** (i + 1))
        d = f"decoder.{i + 1}.block."
        sd[d + "0.alpha"] = w(cin)
        sd[d + "0.beta"] = w(cin)
        sd[d + "1.conv.weight"] = w(cin, cout, 2 * r)
        sd[d + "1.conv.bias"] = w(cout)
        for d_i in range(3):
            rr = d + f"{d_i + 2}."
            sd[rr + "act1.alpha"] = w(cout)
            sd[rr + "act1.beta"] = w(cout)
            sd[rr + "conv1.conv.weight"] = w(cout, cout, 7)
            sd[rr + "conv1.conv.bias"] = w(cout)
            sd[rr + "act2.alpha"] = w(cout)
            sd[rr + "act2.beta"] = w(cout)
            sd[rr + "conv2.conv.weight"] = w(cout, cout, 1)
            sd[rr + "conv2.conv.bias"] = w(cout)
        cin = cout
    n = len(v.upsample_rates)
    sd[f"decoder.{n + 1}.alpha"] = w(cin)
    sd[f"decoder.{n + 1}.beta"] = w(cin)
    sd[f"decoder.{n + 2}.conv.weight"] = w(1, cin, 7)
    sd[f"decoder.{n + 2}.conv.bias"] = w(1)
    return {"decoder." + k: t for k, t in sd.items()}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    from safetensors.torch import save_file

    d = tmp_path_factory.mktemp("hf_ckpt")
    sd = _talker_cp_state_dict()
    save_file(sd, str(d / "model.safetensors"))
    st = d / "speech_tokenizer"
    st.mkdir()
    save_file(_voc_state_dict(), str(st / "model.safetensors"))
    return d, sd


def test_readers_decode_bf16(ckpt_dir):
    """Both the native mmap reader and the pure-Python fallback must read
    bf16 tensors with exact bit-upcast to f32."""
    d, sd = ckpt_dir
    path = str(d / "model.safetensors")
    want = sd["talker.codec_head.weight"].float().numpy()

    got = native.read_safetensors(path)["talker.codec_head.weight"]
    np.testing.assert_array_equal(got, want)

    py = native._PySafetensors(path)
    np.testing.assert_array_equal(
        np.asarray(py.tensor("talker.codec_head.weight")), want)

    if native.available():
        f = native.SafetensorsFile(path)
        assert f._h, "native lib built but mmap open failed"
        np.testing.assert_array_equal(
            np.asarray(f.tensor("talker.codec_head.weight")), want)
        f.close()


def test_load_params_maps_and_transposes(ckpt_dir):
    d, sd = ckpt_dir
    params = weights_io.load_params(str(d), CFG, dtype=jnp.float32)

    t = CFG.talker
    tp = params["talker"]
    assert tp["codec_head"].shape == (t.hidden_size, t.codec_vocab_size)
    np.testing.assert_array_equal(
        np.asarray(tp["codec_head"]),
        sd["talker.codec_head.weight"].float().numpy().T)
    np.testing.assert_array_equal(
        np.asarray(tp["layers"]["q_proj"][1]),
        sd["talker.model.layers.1.self_attn.q_proj.weight"].float().numpy().T)

    cp = params["code_predictor"]
    assert cp["codec_embs"].shape == (15, 2048, t.hidden_size)
    np.testing.assert_array_equal(
        np.asarray(cp["lm_heads"][7]),
        sd["talker.code_predictor.lm_head.7.weight"].float().numpy().T)

    # vocoder came from speech_tokenizer/, not random init
    assert params["vocoder"]["code_embedding"].shape == (16 * 2048,
                                                         CFG.vocoder.hidden_size)


def test_missing_speech_tokenizer_warns(ckpt_dir, tmp_path):
    """ADVICE round-1 (high): random vocoder fallback must be loud."""
    import shutil

    d, _ = ckpt_dir
    bare = tmp_path / "bare_ckpt"
    bare.mkdir()
    shutil.copy(str(d / "model.safetensors"), str(bare / "model.safetensors"))
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED"):
        weights_io.load_params(str(bare), CFG, dtype=jnp.float32)


def test_engine_synthesizes_from_hf_checkpoint(ckpt_dir, tmp_path):
    """The full production path: HF dir -> engine -> WAV bytes."""
    from qwen3_tts_tpu.engine.engine import TTSEngine

    d, _ = ckpt_dir
    eng = TTSEngine(CFG, model_dir=str(d), dtype=jnp.float32)
    res = eng.synthesize("hello", language="english", seed=0)
    assert res.n_tokens >= 1
    assert len(res.audio_int16) == res.n_tokens * 1920
    assert np.isfinite(res.audio_int16).all()


def test_list_keys_and_schema_check(tmp_path):
    """tools/convert_weights.py --list_keys: header-only key dump of a
    checkpoint, and --check_schema dry-runs the strict vocoder/encoder
    loaders against the declared shapes so key-name drift in a real
    speech_tokenizer checkpoint surfaces as a diff, not a debugging
    session (round-2 VERDICT item 8)."""
    from safetensors.numpy import save_file

    from qwen3_tts_tpu.config import tiny_tts_config
    from qwen3_tts_tpu.models import vocoder as voc_mod

    cfg = tiny_tts_config()
    # a real tiny-geometry decoder state dict (exact key grammar) via the
    # random-init pytree round-tripped through torch-style names is
    # overkill here; reuse the torch module like test_vocoder_golden
    from test_vocoder_golden import _torch_model
    m = _torch_model()
    sd = {"decoder." + k: v.numpy() for k, v in m.state_dict().items()}
    st_dir = tmp_path / "speech_tokenizer"
    st_dir.mkdir()
    save_file(sd, str(st_dir / "model.safetensors"))

    # header-only listing
    keys = weights_io.list_safetensors_keys(str(st_dir / "model.safetensors"))
    assert set(keys) == set(sd)
    for k, (dt, shape) in keys.items():
        assert tuple(sd[k].shape) == shape

    # schema dry-run through the CLI tool (decoder must pass; no encoder
    # tensors -> non-zero exit with an explicit message)
    import io
    from contextlib import redirect_stdout

    from tools.convert_weights import main as cw_main

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cw_main(["--model_dir", str(tmp_path), "--tiny",
                      "--list_keys", "--check_schema"])
    out = buf.getvalue()
    assert "SCHEMA decoder (vocoder): OK" in out
    assert "NO 'encoder.' tensors" in out
    assert rc == 1  # encoder absent

    # name drift is reported, not silently absorbed
    bad = dict(sd)
    bad["decoder.sine_gen.phase"] = np.zeros((3,), np.float32)
    save_file(bad, str(st_dir / "model.safetensors"))
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cw_main(["--model_dir", str(tmp_path), "--tiny",
                      "--list_keys", "--check_schema"])
    assert "SCHEMA decoder (vocoder): MISMATCH" in buf.getvalue()
    assert rc == 1


# ---------------------------------------------------------------------------
# Geometry auto-detection (header-only): the counterpart of the
# reference's shape-driven param detection (LLM_Qwen3TTS.hpp:307-323)
# ---------------------------------------------------------------------------

def _alt_config():
    import dataclasses

    from qwen3_tts_tpu.config import CodePredictorConfig, TalkerConfig

    talker = TalkerConfig(
        num_layers=3, hidden_size=48, intermediate_size=96,
        num_heads=6, num_kv_heads=3, head_dim=8,
        text_vocab_size=512, text_embed_dim=24,
        codec_vocab_size=3072, max_seq_len=64,
    )
    cp = CodePredictorConfig(
        num_layers=2, hidden_size=48, intermediate_size=96,
        num_heads=6, num_kv_heads=3, head_dim=8,
        num_groups=15, group_vocab_size=64, max_seq_len=16,
    )
    return dataclasses.replace(tiny_tts_config(max_tokens=4),
                               talker=talker, code_predictor=cp)


def test_detect_tts_config_from_header(tmp_path):
    """detect_tts_config derives every shape-derivable field from the
    safetensors header of a checkpoint at a NON-default geometry, and
    takes eps/theta from config.json's matching sub-config."""
    import json

    from safetensors.torch import save_file

    alt = _alt_config()
    save_file(_talker_cp_state_dict(alt), str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({
        "architectures": ["Qwen3TTSForConditionalGeneration"],
        "talker_config": {
            "num_hidden_layers": 3, "hidden_size": 48,
            "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
            "code_predictor_config": {
                "num_hidden_layers": 2, "hidden_size": 48,
                "rms_norm_eps": 2e-5, "rope_theta": 10000.0,
            },
        },
    }))

    det = weights_io.detect_tts_config(str(tmp_path),
                                       base=tiny_tts_config(max_tokens=4))
    t, c = det.talker, det.code_predictor
    at, ac = alt.talker, alt.code_predictor
    assert (t.num_layers, t.hidden_size, t.intermediate_size) == (3, 48, 96)
    assert (t.num_heads, t.num_kv_heads, t.head_dim) == (6, 3, 8)
    assert (t.text_vocab_size, t.text_embed_dim) == (512, 24)
    assert t.codec_vocab_size == at.codec_vocab_size
    assert (t.rms_norm_eps, t.rope_theta) == (1e-5, 500000.0)
    assert (c.num_layers, c.hidden_size, c.intermediate_size) == (2, 48, 96)
    assert (c.num_heads, c.num_kv_heads, c.head_dim) == (6, 3, 8)
    assert (c.num_groups, c.group_vocab_size) == (15, 64)
    assert c.max_seq_len == 16
    assert (c.rms_norm_eps, c.rope_theta) == (2e-5, 10000.0)
    # serving policy stays the base's
    assert det.max_tokens == 4
    assert t.max_seq_len == tiny_tts_config().talker.max_seq_len

    # no config.json -> defaults for the scalars, shapes still detected
    (tmp_path / "config.json").unlink()
    det2 = weights_io.detect_tts_config(str(tmp_path),
                                        base=tiny_tts_config(max_tokens=4))
    assert det2.talker.rms_norm_eps == tiny_tts_config().talker.rms_norm_eps
    assert det2.talker.num_layers == 3


def test_detect_scalars_disambiguate_same_depth_stacks(tmp_path):
    """When talker and CP share (num_hidden_layers, hidden_size), the
    config.json scalar match must pick each stack's OWN sub-config by key
    path, not first-match (review finding: the CP silently inherited the
    talker's rope_theta)."""
    import dataclasses
    import json

    from safetensors.torch import save_file

    alt = _alt_config()
    # force identical depth/width on both stacks
    alt = dataclasses.replace(
        alt,
        talker=dataclasses.replace(alt.talker, num_layers=2),
        code_predictor=dataclasses.replace(alt.code_predictor, num_layers=2))
    save_file(_talker_cp_state_dict(alt), str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps({
        "talker_config": {
            "num_hidden_layers": 2, "hidden_size": 48,
            "rms_norm_eps": 1e-5, "rope_theta": 500000.0,
            "code_predictor_config": {
                "num_hidden_layers": 2, "hidden_size": 48,
                "rms_norm_eps": 2e-5, "rope_theta": 10000.0,
            },
        },
    }))
    det = weights_io.detect_tts_config(str(tmp_path),
                                       base=tiny_tts_config(max_tokens=4))
    assert (det.talker.rms_norm_eps, det.talker.rope_theta) == (1e-5, 5e5)
    assert (det.code_predictor.rms_norm_eps,
            det.code_predictor.rope_theta) == (2e-5, 1e4)


def test_engine_synthesizes_at_detected_geometry(tmp_path):
    """End-to-end: an engine built from the detected config loads the
    alt-geometry checkpoint and synthesizes (vocoder random: shapes and
    duration math are the contract under test)."""
    import warnings

    from safetensors.torch import save_file

    from qwen3_tts_tpu.engine.engine import TTSEngine

    alt = _alt_config()
    save_file(_talker_cp_state_dict(alt), str(tmp_path / "model.safetensors"))

    det = weights_io.detect_tts_config(str(tmp_path),
                                       base=tiny_tts_config(max_tokens=4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random-vocoder warning expected
        eng = TTSEngine(det, model_dir=str(tmp_path), dtype=jnp.float32)
    res = eng.synthesize("geometry probe", language="english", seed=0)
    assert res.n_tokens >= 1
    assert len(res.audio_int16) == res.n_tokens * 1920


def test_npz_roundtrip_bf16_and_native_geometry(tmp_path):
    """save/load_pytree_npz must round-trip bf16 exactly (np.savez stores
    ml_dtypes bf16 as raw void otherwise — review finding), load_params
    must honor dtype on the native path, and config_from_params must
    recover the geometry so a converted non-default checkpoint does not
    run against the default config's shapes."""
    import jax

    from qwen3_tts_tpu.models import code_predictor as cp_m
    from qwen3_tts_tpu.models import talker as tk

    alt = _alt_config()
    params = {
        "talker": tk.init_talker_params(jax.random.PRNGKey(0), alt.talker,
                                        dtype=jnp.bfloat16),
        "code_predictor": cp_m.init_cp_params(jax.random.PRNGKey(1),
                                              alt.code_predictor,
                                              dtype=jnp.bfloat16),
    }
    path = str(tmp_path / "params.npz")
    weights_io.save_pytree_npz(path, params)
    back = weights_io.load_pytree_npz(path)
    assert back["talker"]["codec_embedding"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["talker"]["codec_embedding"], np.float32),
        np.asarray(params["talker"]["codec_embedding"], np.float32))

    # load_params honors dtype for the transformers on the native path
    loaded = weights_io.load_params(str(tmp_path), alt, dtype=jnp.float32)
    assert loaded["talker"]["layers"]["q_proj"].dtype == jnp.float32

    # geometry recovered from the bundle
    det = weights_io.config_from_params(loaded, base=tiny_tts_config(
        max_tokens=4))
    assert det.talker.num_layers == alt.talker.num_layers
    assert det.talker.hidden_size == alt.talker.hidden_size
    assert det.talker.num_kv_heads == alt.talker.num_kv_heads
    assert det.code_predictor.num_groups == alt.code_predictor.num_groups
    assert det.code_predictor.group_vocab_size == \
        alt.code_predictor.group_vocab_size


def test_npz_embedded_config_roundtrip(tmp_path):
    """save_pytree_npz(config=...) embeds the exact TTSConfig (vocoder
    geometry included — NOT shape-derivable) and read_npz_config returns
    it equal; the engine then runs a non-default-vocoder npz end to end."""
    import warnings

    import jax

    from qwen3_tts_tpu.engine.engine import TTSEngine
    from qwen3_tts_tpu.models import code_predictor as cp_m
    from qwen3_tts_tpu.models import talker as tk
    from qwen3_tts_tpu.models import vocoder as voc

    alt = _alt_config()
    params = {
        "talker": tk.init_talker_params(jax.random.PRNGKey(0), alt.talker,
                                        dtype=jnp.float32),
        "code_predictor": cp_m.init_cp_params(jax.random.PRNGKey(1),
                                              alt.code_predictor,
                                              dtype=jnp.float32),
        "vocoder": voc.init_vocoder_params(jax.random.PRNGKey(2),
                                           alt.vocoder),
    }
    path = str(tmp_path / "params.npz")
    weights_io.save_pytree_npz(path, params, config=alt)
    got = weights_io.read_npz_config(path)
    assert got == alt  # frozen dataclasses: exact equality

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = TTSEngine(cfg=None, model_dir=str(tmp_path),
                        dtype=jnp.float32)
    assert eng.cfg == alt
    res = eng.synthesize("npz config probe", language="english", seed=0)
    assert len(res.audio_int16) == res.n_tokens * 1920 and res.n_tokens > 0
