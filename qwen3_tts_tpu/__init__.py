"""Qwen3-TTS framework in JAX (runs on NVIDIA GPUs; tests on the CPU).

A ground-up rebuild of the capabilities of the reference edge-inference
stack (MasterVVK/qwen3-tts-axera-russian) as a single fused program:
talker LLM -> code predictor -> FP32 vocoder, with streaming, daemon
serving, voice cloning, and multi-chip sharding.
"""

__version__ = "0.1.0"
