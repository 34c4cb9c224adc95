"""Frozen copy, for the benchmark's plain reference, of the float32 PyTorch
model code this file was taken from; it imports nothing of the program.

Convolution helpers with the JAX package's signatures (counterpart of
``gsv_tts_tpu/ops/convs.py``).

Torch layouts throughout: Conv1d weight [C_out, C_in/g, K], ConvTranspose1d
weight [C_in, C_out, K], x [B, C, T]; Conv2d weight [C_out, C_in, kH, kW],
x [B, C, H, W].  JAX computes these in XLA, outside any Pallas kernel, so
the port leaves them to ``torch.nn.functional``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0, dilation: int = 1,
           groups: int = 1) -> torch.Tensor:
    return F.conv1d(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation, groups=groups)


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    return F.conv_transpose1d(x, weight.to(x.dtype),
                              None if bias is None else bias.to(x.dtype),
                              stride=stride, padding=padding)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch layout weight [out, in]."""
    return F.linear(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


def fold_weight_norm(weight_v: torch.Tensor, weight_g: torch.Tensor) -> torch.Tensor:
    """Fold torch weight_norm (dim=0): w = g * v / ||v||, norm over every
    dim but 0 (the reference's load-time ``remove_weight_norm``)."""
    v = weight_v.float()
    g = weight_g.float()
    dims = tuple(range(1, v.ndim))
    norm = torch.sqrt((v * v).sum(dim=dims, keepdim=True))
    return (g * v / norm).to(weight_v.dtype)


def interpolate_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(scale_factor=2, mode='nearest') on the last axis."""
    return torch.repeat_interleave(x, 2, dim=-1)


def interpolate_nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') to ``size`` on the last axis, source
    indices computed in float64 as torch's upsample_nearest1d does."""
    t = x.shape[-1]
    idx = np.clip(np.floor(np.arange(size) * (t / size)).astype(np.int64), 0, t - 1)
    return x.index_select(-1, torch.as_tensor(idx, device=x.device))


def interpolate_linear(x: torch.Tensor, size: int) -> torch.Tensor:
    """F.interpolate(mode='linear', align_corners=False) to ``size`` on the
    last axis (the speed change, reference ``models.py:217-219``), with the
    JAX package's half-pixel arithmetic in float32 spelled out, so both
    sample the same positions for every ``size``."""
    t = x.shape[-1]
    src = (torch.arange(size, dtype=torch.float32, device=x.device) + 0.5) * (t / size) - 0.5
    src = src.clamp(0.0, t - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=t - 1)
    w = (src - lo).to(x.dtype)
    return x.index_select(-1, lo) * (1 - w) + x.index_select(-1, hi) * w


def leaky_relu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x >= 0, x, x * slope)


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def prelu(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """torch PReLU with a per-channel weight; x [B, C, T]."""
    return torch.where(x >= 0, x, x * weight.to(x.dtype)[None, :, None])


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, padding: int = 0) -> torch.Tensor:
    """``F.conv2d`` in x's dtype (JAX accumulates in float32 and casts back, as
    cuDNN does for bf16); the bias is added after, in x's dtype, as JAX adds it."""
    out = F.conv2d(x, weight.to(x.dtype), stride=stride, padding=padding)
    if bias is not None:
        out = out + bias.to(x.dtype)[None, :, None, None]
    return out


def batch_norm(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               gamma: Optional[torch.Tensor], beta: Optional[torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """Inference-mode BatchNorm over the channel axis (axis 1), computed in
    float32 and cast back to x's dtype."""
    shape = [1, -1] + [1] * (x.ndim - 2)
    out = (x.float() - mean.float().reshape(shape)) * torch.rsqrt(var.float() + eps).reshape(shape)
    if gamma is not None:
        out = out * gamma.float().reshape(shape)
    if beta is not None:
        out = out + beta.float().reshape(shape)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with float32 statistics, cast back to
    ``x``'s dtype (``g``/``b`` may be any float dtype)."""
    return F.layer_norm(x.float(), x.shape[-1:], g.float(), b.float(), eps).to(x.dtype)
