"""Token sampling for the t2s decoder (counterpart of
``gsv_tts_tpu/ops/sampling.py``; reference ``GPT/utils.py:5-59``).

Repetition penalty over a fixed-size previous-token buffer (entries ``>= V``
are empty slots), top-p on the *pre-temperature* logits, temperature, top-k
pivot (every value tied with the k-th survives), and the Gumbel draw
argmax(log p + G) with the noise supplied by the caller; ``torch.argmax``
returns the lowest index among ties, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import Optional

import torch


def apply_repetition_penalty(logits: torch.Tensor, previous_tokens: torch.Tensor,
                             repetition_penalty: float) -> torch.Tensor:
    """logits [B, V]; previous_tokens [B, P] int, idx >= V means empty."""
    V = logits.shape[-1]
    prev = previous_tokens.long()
    valid = (prev >= 0) & (prev < V)
    # empty entries land in a spare column V, so they cannot clear a real
    # token's mark (scatter keeps one of several writes to the same index)
    member = torch.zeros((logits.shape[0], V + 1), dtype=torch.bool, device=logits.device)
    member = member.scatter_(1, torch.where(valid, prev, V), True)[:, :V]
    penalized = torch.where(logits < 0, logits * repetition_penalty,
                            logits / repetition_penalty)
    return torch.where(member, penalized, logits)


def apply_top_p(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter on raw logits; keeps at least the top-1 token.  The
    descending order is a stable ascending sort reversed, so ties order
    exactly as ``jnp.argsort(...)[::-1]`` does."""
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, stable=True)
    sorted_logits = sorted_logits.flip(-1)
    sorted_idx = sorted_idx.flip(-1)
    cum = torch.cumsum(torch.softmax(sorted_logits.float(), dim=-1), dim=-1)
    remove = cum > top_p
    remove[..., 0] = False
    mask = torch.zeros_like(remove).scatter_(-1, sorted_idx, remove)
    return torch.where(mask, torch.full_like(logits, float("-inf")), logits)


def apply_top_k(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    pivot = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < pivot, torch.full_like(logits, float("-inf")), logits)


def logits_to_probs(logits: torch.Tensor,
                    previous_tokens: Optional[torch.Tensor] = None,
                    temperature: float = 1.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    repetition_penalty: float = 1.0) -> torch.Tensor:
    logits = logits.float()
    if previous_tokens is not None and repetition_penalty != 1.0:
        logits = apply_repetition_penalty(logits, previous_tokens, repetition_penalty)
    if top_p is not None and top_p < 1.0:
        logits = apply_top_p(logits, top_p)
    logits = logits / max(temperature, 1e-5)
    if top_k is not None:
        logits = apply_top_k(logits, min(top_k, logits.shape[-1]))
    return torch.softmax(logits, dim=-1)


def gumbel_argmax_with_noise(probs: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """argmax(log p + G) with caller-supplied Gumbel noise ``g``."""
    logp = torch.where(probs > 0, torch.log(probs.clamp_min(1e-38)),
                       torch.full_like(probs, float("-inf")))
    return torch.argmax(logp + g, dim=-1)


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel(0, 1) noise, float32, drawn from ``generator``."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(tiny)))
