"""The pluggable prompt-transcription hook (counterpart of
``gsv_tts_tpu/serving/asr.py``).

When a request omits ``prompt_text``, :class:`serving.server.TTSServer`
calls its ``asr_fn`` (audio path → transcript), if it has one:

    from gsv_tts_tpu_torch.serving.asr import make_asr_fn, register_asr
    register_asr(my_transcriber)
    app = create_app(tts, asr_fn=make_asr_fn())

The JAX module's dashscope Qwen3-ASR backend is a network call and is not
ported: here the registered callable is the only backend.
"""
from __future__ import annotations

from typing import Callable, Optional

_CUSTOM: Optional[Callable[[str], str]] = None


def register_asr(fn: Callable[[str], str]):
    """Register a custom transcription callable (audio_path → text)."""
    global _CUSTOM
    _CUSTOM = fn


def make_asr_fn() -> Optional[Callable[[str], str]]:
    """The registered transcription callable, or None."""
    return _CUSTOM
