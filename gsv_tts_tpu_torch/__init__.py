"""GPT-SoVITS inference engine in PyTorch for NVIDIA Hopper (H100).

The PyTorch counterpart of ``gsv_tts_tpu``: module names mirror the JAX
package so each function has an obvious reference.  Plain tensor code is
PyTorch; the hand-written kernels are CUDA C++ under ``csrc/``, built with
``nvcc`` at first use: the whole decode step for one slot and for a wave of
slots and the decode layer stack (``ops/fused_step.py``), one decode layer
(``ops/fused_layer.py``), the decode attention (``ops/flash_decode.py``),
the prefill attention (``ops/flash_prefill.py``), and the three measurement
probes under ``tools/`` (``int4_probe``, ``mosaic_probe``,
``stream_probe``).  The host DSP library (``csrc/host/``) is built with the
host C++ compiler at first use (``utils/native.py``).  Nothing here imports
``jax`` or loads a file of ``gsv_tts_tpu``.

Public surface, as the JAX package's: ``TTS``, ``AudioClip``, ``cut_text``
and ``WaveOverloadedError``.
"""

__version__ = "0.1.0"

from .player import AudioClip  # noqa: F401
from .frontend.text_processor import cut_text  # noqa: F401


def __getattr__(name):
    # the facade pulls in every model module; keep ``import gsv_tts_tpu_torch``
    # light for callers that only need a submodule
    if name == "TTS":
        from .tts import TTS

        return TTS
    if name == "WaveOverloadedError":
        # raised by ``stream_shared`` at the ``wave_max_clients`` admission cap
        from .runtime.wave import WaveOverloadedError

        return WaveOverloadedError
    raise AttributeError(name)


__all__ = ["TTS", "AudioClip", "cut_text", "WaveOverloadedError"]
