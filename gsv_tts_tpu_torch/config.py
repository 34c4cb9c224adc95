"""Engine configuration and device/dtype policy (counterpart of
``gsv_tts_tpu/config.py``).

The policy mirrors the JAX package: on the accelerator (here CUDA) compute is
bfloat16 with float32 accumulation; on the CPU (tests, debugging) float32.
Float32 matrix products and convolutions are pinned to full float32: PyTorch
runs cuDNN convolutions in TF32 by default, which keeps only ~3 decimal
digits, so the constructor turns TF32 off for both matmul and cuDNN.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Optional

import torch

_DTYPE_MAP = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
    "fp16": torch.float16,
}


def default_device() -> torch.device:
    """The card.  The engine never falls back to the CPU on its own: a
    caller that wants the CPU (tests, debugging) says ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available (torch.cuda.is_available() is false); "
            'pass device="cpu" to run on the CPU')
    return torch.device("cuda")


def default_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


@dataclasses.dataclass
class Config:
    """Per-engine configuration.

    ``device`` is a ``torch.device`` or a string such as ``"cuda:0"`` or
    ``"cpu"``; left ``None`` it is the card, and construction raises when
    there is none.  ``dtype`` defaults from the device.  ``gpt_cache`` is the list of
    ``(batch_size, max_seq_len)`` KV-cache buckets; ``sovits_cache`` the sorted
    frame buckets of SoVITS's flow and vocoder (empty: exact shapes); ``models_dir`` keys the
    frontend's G2P engines.  ``attn_impl`` names the t2s engine's kernels
    (``runtime/t2s_session.py``): ``"fused_step"`` (K1 / K2 whole-step
    kernels, plain prefill), ``"flash"`` (K4 prefill attention, K3b decode
    attention) or ``"fused"`` (K6, one call per layer).  ``quant_t2s``
    (``False``, ``True`` = ``"int8"``, ``"int8"`` or ``"int4"``) streams K1's
    and K2's layer weights quantized (``loader.resolve_t2s_attn_impl`` maps
    it to the engine's ``"fused_step_q8"`` / ``"fused_step_q4"``; it needs
    ``attn_impl="fused_step"``).  ``use_flash_attn=False`` takes the
    engine's ``"xla"`` implementation (plain PyTorch attention, no kernel)
    whatever ``attn_impl`` and ``quant_t2s`` say, as the JAX package's does.
    ``quant_bert`` runs the BERT featurizer's linear layers in int8;
    ``featurizer_buckets`` pads the BERT and HuBERT inputs to a ladder of
    shapes (``models/roberta.py``, ``models/hubert.py``); ``cnroberta`` is
    the loaded BERT featurizer, which the frontend calls for Chinese text.
    """

    device: Any = None
    dtype: Any = None
    gpt_cache: list = None
    sovits_cache: list = dataclasses.field(default_factory=list)
    models_dir: Optional[Path] = None
    attn_impl: str = "fused_step"
    quant_t2s: Any = False
    use_flash_attn: bool = True
    quant_bert: bool = False
    featurizer_buckets: bool = False
    cnroberta: Any = None

    def __post_init__(self):
        self.device = (default_device() if self.device is None
                       else torch.device(self.device))
        if self.dtype is None:
            self.dtype = default_dtype(self.device)
        elif isinstance(self.dtype, str):
            self.dtype = _DTYPE_MAP[self.dtype.lower()]
        # full-precision float32 on the card: TF32 would make an f32 run
        # disagree with the CPU and with the JAX reference in the 4th digit
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


class GlobalConfig:
    """Process-wide frontend singletons read by the G2P dispatcher
    (``frontend/g2p/__init__.py``): the default models directory, whether
    the Chinese engine segments with ``jieba_fast``, injected English,
    Chinese and Japanese engines, and engines built per models directory."""

    def __init__(self):
        self.models_dir: Optional[Path] = None
        self.use_jieba_fast: Optional[bool] = None
        self.english_g2p = None
        self.chinese_g2p = None
        self.japanese_g2p = None
        self._g2p_auto: dict = {}


global_config = GlobalConfig()
