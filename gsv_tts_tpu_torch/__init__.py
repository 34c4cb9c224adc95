"""GPT-SoVITS inference engine in PyTorch for NVIDIA Hopper (H100).

The PyTorch counterpart of ``gsv_tts_tpu``: module names mirror the JAX
package so each function has an obvious reference.  Plain tensor code is
PyTorch; the hand-written kernels are CUDA C++ under ``csrc/``, built with
``nvcc`` at first use: the whole decode step for one slot and for a wave of
slots and the decode layer stack (``ops/fused_step.py``), one decode layer
(``ops/fused_layer.py``), the decode attention (``ops/flash_decode.py``),
the prefill attention (``ops/flash_prefill.py``), and the three measurement
probes under ``tools/`` (``int4_probe``, ``mosaic_probe``,
``stream_probe``).  Nothing here imports ``jax`` or loads a file of
``gsv_tts_tpu``.
"""

__all__ = ["TTS"]


def __getattr__(name):
    # the facade pulls in every model module; keep ``import gsv_tts_tpu_torch``
    # light for callers that only need a submodule
    if name == "TTS":
        from .tts import TTS

        return TTS
    raise AttributeError(name)
