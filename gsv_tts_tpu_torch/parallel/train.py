"""t2s training step on one card (counterpart of
``gsv_tts_tpu/parallel/train.py``, without its meshes).

Teacher-forced next-token cross-entropy over the audio block of the packed
[text | audio] prompt (the hybrid-mask forward of the prefill,
``models/t2s.py:embed_prompt_batch``), gradients from ``torch.autograd``,
and :class:`Optimizer`: ``torch.optim.AdamW`` behind optax's global-norm
clip, its learning rate a ``LambdaLR`` of an optax schedule.

The sine table ``pe`` is not trained: it is a buffer in the reference and
the export drops it.  (The JAX step differentiates it as one more leaf of
its params pytree.)
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.optim.lr_scheduler import LambdaLR
from torch.utils.checkpoint import checkpoint

from ..models import t2s as t2s_model
from ..models.t2s import LAYER_KEYS, T2SConfig

#: the t2s tensors outside the layers that training updates
T2S_TOP = ("text_emb", "audio_emb", "bert_proj_w", "bert_proj_b", "text_pos_alpha",
           "audio_pos_alpha", "predict_w")


def t2s_leaves(params) -> Dict[str, torch.Tensor]:
    """The trained tensors of t2s params by name (``"predict_w"``,
    ``"layers.3.qkv_w"``, ...): every model tensor but ``pe``."""
    out = {k: params[k] for k in T2S_TOP}
    for i, lp in enumerate(params["layers"]):
        for k, _, _ in LAYER_KEYS:
            out[f"layers.{i}.{k}"] = lp[k]
    return out


def t2s_train_params(params, device=None) -> Dict:
    """A copy of t2s params for training on ``device`` (default: where they
    are): the model tensors as leaves that require grad, in their own dtypes,
    ``pe`` as a constant; what an engine adds (its kernels' table, packed
    pages) is left out."""
    def leaf(t):
        return t.detach().to(device).clone().requires_grad_(True)

    out = {k: leaf(params[k]) for k in T2S_TOP}
    out["layers"] = [{k: leaf(lp[k]) for k, _, _ in LAYER_KEYS} for lp in params["layers"]]
    out["pe"] = params["pe"].to(device)
    return out


def t2s_loss(params, cfg: T2SConfig, x_ids, y_ids, bert, x_lens, y_lens,
             dtype=torch.bfloat16, remat: bool = False):
    """Next-semantic-token CE over the audio block (+EOS at the end).

    x_ids [B, Lx] phonemes, y_ids [B, Ly] target semantic tokens.  The
    packed row is [x | y]; position ``x_len + t`` predicts ``y[t + 1]`` and
    the last valid position predicts EOS.  Activations are in ``dtype`` with
    JAX's casts; the logits and the loss are float32.  ``remat=True``
    recomputes the transformer forward in the backward pass
    (``torch.utils.checkpoint`` around all layers, as ``jax.checkpoint``
    wraps them)."""
    B, Ly = y_ids.shape
    xy_pos, mask, _ = t2s_model.embed_prompt_batch(params, cfg, x_ids, y_ids, bert, x_lens,
                                                   y_lens, dtype)

    def layers(xy):
        return t2s_model.transformer_prefill(params, cfg, xy, mask)[0]

    h = checkpoint(layers, xy_pos, use_reentrant=False) if remat else layers(xy_pos)
    logits = F.linear(h, params["predict_w"]).float()  # [B, T, V]

    T = xy_pos.shape[1]
    pos = torch.arange(T, device=h.device)[None, :]
    xy_lens = x_lens + y_lens
    in_audio = (pos >= x_lens[:, None]) & (pos < xy_lens[:, None])
    t_in_audio = (pos - x_lens[:, None]).clamp(0, Ly - 1)
    next_t = (t_in_audio + 1).clamp(0, Ly - 1)
    y_next = torch.gather(y_ids.long(), 1, next_t)
    labels = torch.where(pos == xy_lens[:, None] - 1, cfg.eos, y_next)

    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 2, labels[:, :, None])[:, :, 0]
    total = torch.where(in_audio, nll, 0.0).sum()
    return total / in_audio.sum().clamp(min=1)


def warmup_cosine_schedule(peak_lr: float, warmup_steps: int, decay_steps: int,
                           end_lr: float) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule(0, peak, warmup, decay, end)``:
    linear from 0 (the first update has lr 0) to ``peak_lr`` over
    ``warmup_steps``, then cosine to ``end_lr`` at ``decay_steps``, which
    counts the warmup."""
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * count / warmup_steps
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
        return peak_lr * ((1 - alpha) * cosine + alpha)

    return schedule


class Optimizer:
    """``optax.chain(clip_by_global_norm(clip_norm), adamw(schedule, b1, b2,
    eps, weight_decay))`` over named tensors, in ``torch.optim``.

    * The clip is optax's: the gradients scale by ``clip_norm / norm`` when
      the global norm (float32) reaches ``clip_norm``; ``clip_grad_norm_``
      divides by ``norm + 1e-6`` instead.
    * ``torch.optim.AdamW`` has optax's update (decoupled weight decay times
      the learning rate) once its weight decay, b2 and eps are given: its own
      defaults differ (weight decay 1e-2, optax's 1e-4).
    * The learning rate of update k is ``schedule(k)``, counted from 0: a
      ``LambdaLR`` of ``schedule`` on a base rate of 1.
    * The AdamW state exists from the start (zero moments, step 0), so a
      train-state checkpoint has one layout before and after the first step.
    """

    def __init__(self, leaves: Dict[str, torch.Tensor], schedule: Callable[[int], float], *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, clip_norm: Optional[float] = 1.0):
        self.leaves = dict(leaves)
        self.params = list(self.leaves.values())
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.adamw = torch.optim.AdamW(self.params, lr=1.0, betas=(b1, b2), eps=eps,
                                       weight_decay=weight_decay)
        for p in self.params:
            self.adamw.state[p] = {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                                   "exp_avg_sq": torch.zeros_like(p)}
        self.lr = LambdaLR(self.adamw, schedule)

    def update(self, loss: torch.Tensor) -> None:
        """One optimizer update from the gradient of ``loss`` w.r.t. the leaves."""
        grads = torch.autograd.grad(loss, self.params)
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
            grads = [torch.where(norm < self.clip_norm, g, g / norm.to(g.dtype) * self.clip_norm)
                     for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adamw.step()
        self.lr.step()
        self.adamw.zero_grad(set_to_none=True)

    def state(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The AdamW state by leaf name: ``step``, ``exp_avg``, ``exp_avg_sq``."""
        return {name: self.adamw.state[p] for name, p in self.leaves.items()}

    def resume(self, step: int) -> None:
        """Continue the schedule at update ``step`` (after the state was loaded)."""
        self.lr = LambdaLR(self.adamw, self.schedule, last_epoch=step - 1)


def make_train_step(cfg: T2SConfig, optimizer: Optimizer, dtype=torch.bfloat16,
                    remat: bool = False):
    """Returns ``step(params, batch) → loss``: one :func:`t2s_loss` and one
    ``optimizer`` update of the leaves it holds (``params``' tensors, in place)."""

    def step(params, batch):
        loss = t2s_loss(params, cfg, batch["x_ids"], batch["y_ids"], batch["bert"],
                        batch["x_lens"], batch["y_lens"], dtype, remat=remat)
        optimizer.update(loss)
        return loss.detach()

    return step


def make_optimizer(leaves: Dict[str, torch.Tensor], peak_lr: float = 1e-4,
                   warmup_steps: int = 500, decay_steps: int = 50_000,
                   end_lr_scale: float = 0.1, weight_decay: float = 0.01,
                   clip_norm: float = 1.0, b1: float = 0.9, b2: float = 0.95):
    """AdamW with linear warmup → cosine decay and global-norm clipping over
    ``leaves`` (JAX's recipe and defaults).  Returns (optimizer, schedule)."""
    schedule = warmup_cosine_schedule(peak_lr, warmup_steps, decay_steps,
                                      peak_lr * end_lr_scale)
    return Optimizer(leaves, schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                     clip_norm=clip_norm), schedule


def pad_batch(cfg: T2SConfig, samples, pad_multiple: int = 32, device="cpu"):
    """Collate [(x_ids, y_ids, bert or None), ...] (numpy) into the padded
    dict the train step consumes, on ``device``; lengths round up to
    ``pad_multiple`` so the shapes stay few."""
    def rup(n):
        return max(pad_multiple, -(-n // pad_multiple) * pad_multiple)

    B = len(samples)
    Lx = rup(max(len(s[0]) for s in samples))
    Ly = rup(max(len(s[1]) for s in samples))
    x = np.zeros((B, Lx), np.int64)
    y = np.zeros((B, Ly), np.int64)
    bert = np.zeros((B, Lx, cfg.bert_dim), np.float32)
    x_lens = np.zeros((B,), np.int64)
    y_lens = np.zeros((B,), np.int64)
    for i, (xi, yi, bi) in enumerate(samples):
        x[i, :len(xi)] = xi
        y[i, :len(yi)] = yi
        if bi is not None:
            bert[i, :len(xi)] = bi
        x_lens[i], y_lens[i] = len(xi), len(yi)
    return {k: torch.as_tensor(v, device=device) for k, v in
            dict(x_ids=x, y_ids=y, bert=bert, x_lens=x_lens, y_lens=y_lens).items()}
