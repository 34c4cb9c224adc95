"""GPT-SoVITS inference engine in PyTorch for NVIDIA Hopper (H100).

The PyTorch counterpart of ``gsv_tts_tpu``: module names mirror the JAX
package so each function has an obvious reference.  Plain tensor code is
PyTorch; the hand-written kernels of the decode paths (the whole decode
step for one slot and for a wave of slots, ``ops/fused_step.py``, and the
decode attention, ``ops/flash_decode.py``) are CUDA C++ under ``csrc/``,
built with ``nvcc`` at first use.  Nothing here imports ``jax`` or loads a
file of ``gsv_tts_tpu``.
"""

__all__ = ["TTS"]


def __getattr__(name):
    # the facade pulls in every model module; keep ``import gsv_tts_tpu_torch``
    # light for callers that only need a submodule
    if name == "TTS":
        from .tts import TTS

        return TTS
    raise AttributeError(name)
