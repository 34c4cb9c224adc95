"""Shared normalization math (counterpart of ``gsv_tts_tpu/ops/norms.py``)."""
import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, cast back to
    ``x``'s dtype (``g``/``b`` may be any float dtype)."""
    return F.layer_norm(x.float(), x.shape[-1:], g.float(), b.float(), eps).to(x.dtype)
