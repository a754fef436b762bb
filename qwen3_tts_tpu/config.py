"""Model/geometry configuration for the Qwen3-TTS framework.

The geometry reproduces the reference deployment of
Qwen3-TTS-12Hz-0.6B-Base (see /root/reference):

- Talker: 28-layer Qwen3ForCausalLM geometry
  (reference scripts/extract_talker_as_qwen3.py:89-110).
- Code predictor: 5-layer Qwen3-style transformer with 15 per-group
  codec embeddings + lm_heads of [2048, 1024]
  (reference scripts/export_code_predictor_weights.py:49-74).
- Vocoder: decoder of the Qwen3-TTS speech tokenizer v2 — 16 codebooks,
  1920x total upsampling to 24 kHz, Snake activations, SineGen harmonic
  source (reference scripts/export_vocoder_traced.py:74-80, README.md:56-64).

Everything is a frozen dataclass so configs are hashable and can be used
as static args to jit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class TalkerConfig:
    """Qwen3 talker LLM geometry (reference extract_talker_as_qwen3.py:89-110)."""

    num_layers: int = 28
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    # Embedding surface (reference scripts/extract_embeddings.py:47-70)
    text_vocab_size: int = 151936
    text_embed_dim: int = 2048
    codec_vocab_size: int = 3072
    max_seq_len: int = 512  # reference n_ctx=512 (llamacpp_talker_server.py:104)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class CodePredictorConfig:
    """5-layer code-predictor transformer
    (reference export_code_predictor_weights.py:49-74,
    export_code_predictor_onnx.py:30-46)."""

    num_layers: int = 5
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    num_groups: int = 15          # groups 1..15 predicted per talker token
    group_vocab_size: int = 2048  # per-group codec vocab
    # seq len inside one CP call: 2 prefill + 14 decode = 16
    max_seq_len: int = 16

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class VocoderConfig:
    """FP32 codec-decoder (vocoder) geometry.

    The reference traces ``Qwen3TTSTokenizerV2Model.decoder``
    (export_vocoder_traced.py:74-80): input [1, T, 16] int64 codes,
    output 24 kHz audio, 1920 samples per token, Snake activations,
    dilated Conv1D stacks (dilation up to 9). The architecture here is the
    public Qwen codec decoder (``Qwen3OmniMoeCode2Wav`` in transformers),
    whose default geometry reproduces every one of those contracts:
    16 quantizers x 2048 codes, prod((8,5,4,3)) * prod((2,2)) = exactly
    1920x upsampling, SnakeBeta, residual units at dilation (1, 3, 9),
    causal convolutions. Quantization is documented as destructive
    (reference README.md:56-64), so the whole module is pinned to float32.
    """

    # codes surface
    num_codebooks: int = 16        # num_quantizers
    codebook_size: int = 2048
    # pre-transformer (sliding-window causal attention over code frames)
    hidden_size: int = 1024
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    intermediate_size: int = 3072
    sliding_window: int = 72
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    layer_scale_initial_scale: float = 0.01
    # ConvNeXt upsampling stages at hidden_size channels
    upsampling_ratios: Tuple[int, ...] = (2, 2)
    # waveform decoder: channel halving per block, kernel = 2*rate
    decoder_dim: int = 1536
    upsample_rates: Tuple[int, ...] = (8, 5, 4, 3)
    sample_rate: int = 24000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def total_upsample(self) -> int:
        out = 1
        for r in self.upsample_rates + self.upsampling_ratios:
            out *= r
        return out

    @property
    def output_crop(self) -> int:
        """Samples the causal transposed-conv crops remove from the tail of
        a full decode: out_len(T) = T * total_upsample - output_crop.
        Each decoder block's ConvTranspose(k=2r, s=r) loses r frames at its
        own resolution (verified against the torch implementation)."""
        loss = 0
        for r in self.upsample_rates:
            loss = loss * r + r
        return loss


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Speech-tokenizer *encoder* (voice-cloning prep; reference
    scripts/encode_reference_audio.py:60-117 uses the official encoder).

    Structural mirror of the decoder (the public checkpoint's encoder
    source is not available, so the block plan is the decoder's reversed:
    strided causal convs with residual units at dilation (1, 3, 9) and
    channel doubling, ConvNeXt downsampling stages, a sliding-window
    transformer, then 16-stage residual VQ against the decoder's
    codebooks). Tensor names mirror the decoder's under ``encoder.*`` so a
    real checkpoint with that naming loads; anything else fails loudly."""

    num_codebooks: int = 16
    codebook_size: int = 2048
    hidden_size: int = 1024
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    intermediate_size: int = 3072
    sliding_window: int = 72
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    layer_scale_initial_scale: float = 0.01
    decoder_dim: int = 1536  # mirrored channel plan
    # downsample rates applied in order (reverse of the decoder's upsampling)
    downsample_rates: Tuple[int, ...] = (3, 4, 5, 8)
    downsampling_ratios: Tuple[int, ...] = (2, 2)
    sample_rate: int = 24000

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def total_downsample(self) -> int:
        out = 1
        for r in self.downsample_rates + self.downsampling_ratios:
            out *= r
        return out


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """code_0 sampling policy (reference llamacpp_talker_server.py:163-206)
    and CP group sampling (code_predictor_server.py:87-92)."""

    temperature: float = 0.8
    top_k: int = 50
    top_p: float = 0.95
    repetition_penalty: float = 1.2
    repetition_window: int = 30
    eos_boost_start: float = 0.8   # progress threshold
    eos_boost_ramp: float = 0.7    # ramp width
    eos_boost_max: float = 15.0
    eos_force_progress: float = 2.0
    expected_tokens_per_text_token: int = 3
    # CP sampling
    cp_temperature: float = 0.1
    cp_top_k: int = 50


# Special codec token ids (reference llamacpp_talker_server.py:44-49)
CODEC_PAD_ID = 2148
CODEC_BOS_ID = 2149
CODEC_EOS_ID = 2150
CODEC_NOTHINK_ID = 2155
CODEC_THINK_BOS_ID = 2156
CODEC_THINK_EOS_ID = 2157
NUM_AUDIO_CODES = 2048  # valid audio codes are 0..2047

# Special text-vocab ids (reference llamacpp_talker_server.py:52-55, 132)
TTS_PAD_TOKEN_ID = 151671
TTS_BOS_TOKEN_ID = 151672
TTS_EOS_TOKEN_ID = 151673
IM_START_TOKEN_ID = 151644
ASSISTANT_TOKEN_ID = 77091
NEWLINE_TOKEN_ID = 198

# Audio constants (reference tts_client.py:29-31)
SAMPLE_RATE = 24000
SAMPLES_PER_TOKEN = 1920
VOC_CHUNK_SIZE = 64
VOC_OVERLAP = 16  # vocoder_server.py:84

# Supported languages (reference README.md:143-145). The reference accepts
# the field but it has no numerical effect (llamacpp_talker_server.py:121);
# we preserve the same API surface.
SUPPORTED_LANGUAGES = (
    "chinese", "english", "german", "russian", "french", "japanese", "korean",
)


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    """Top-level bundle for the whole pipeline."""

    talker: TalkerConfig = TalkerConfig()
    code_predictor: CodePredictorConfig = CodePredictorConfig()
    vocoder: VocoderConfig = VocoderConfig()
    encoder: EncoderConfig = EncoderConfig()
    sampling: SamplingConfig = SamplingConfig()
    max_tokens: int = 200  # reference llamacpp_talker_server.py:65


def tiny_tts_config(max_tokens: int = 16) -> TTSConfig:
    """A miniature geometry for CPU tests: same structure, small dims."""
    talker = TalkerConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=4, num_kv_heads=2, head_dim=16,
        text_vocab_size=151936, text_embed_dim=32,
        codec_vocab_size=3072, max_seq_len=128,
    )
    cp = CodePredictorConfig(
        num_layers=2, hidden_size=64, intermediate_size=128,
        num_heads=4, num_kv_heads=2, head_dim=16,
        num_groups=15, group_vocab_size=2048,
    )
    voc = VocoderConfig(
        num_codebooks=16, codebook_size=2048,
        hidden_size=16, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=32, sliding_window=8,
        decoder_dim=32,
    )
    enc = EncoderConfig(
        num_codebooks=16, codebook_size=2048,
        hidden_size=16, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=32, sliding_window=8,
        decoder_dim=32,
    )
    return TTSConfig(talker=talker, code_predictor=cp, vocoder=voc,
                     encoder=enc, max_tokens=max_tokens)
