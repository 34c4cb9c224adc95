"""t2s training step, on one card or over a ``("dp", "tp")`` mesh
(counterpart of ``gsv_tts_tpu/parallel/train.py``).

Teacher-forced next-token cross-entropy over the audio block of the packed
[text | audio] prompt (the hybrid-mask forward of the prefill,
``models/t2s.py:embed_prompt_batch``), gradients from ``torch.autograd``,
and :class:`Optimizer`: ``torch.optim.AdamW`` behind optax's global-norm
clip, its learning rate a ``LambdaLR`` of an optax schedule.

The sine table ``pe`` is not trained: it is a buffer in the reference and
the export drops it.  (The JAX step differentiates it as one more leaf of
its params pytree.)

Over a mesh (one process per rank, ``parallel/mesh.py``) the step computes
what the single-card step computes on the whole batch, as JAX's GSPMD step
does:

  * the batch's rows split over ``dp``; the loss is the global token mean —
    each rank divides its NLL sum by the count all-reduced over dp
    (averaging per-rank means would weigh ranks with fewer tokens up);
  * ``mesh=``: params split by head over ``tp`` (``shard_t2s_params``);
  * ``seq_mesh=``: params replicated, the packed prompt's time axis split
    over ``tp``, K/V all-gathered for the attention;
  * :class:`GradSync` sums each gradient over the ranks that hold a part of
    it and takes the clip's global norm over the whole logical gradient (a
    split leaf's squares summed over its group, a replicated one counted
    once).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.optim.lr_scheduler import LambdaLR
from torch.utils.checkpoint import checkpoint

from ..models import t2s as t2s_model
from ..models.t2s import LAYER_KEYS, T2SConfig
from . import mesh as pmesh

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


def t2s_tree(leaves) -> Dict:
    """Inverse of :func:`t2s_leaves`: named leaves (of any number of layers)
    in the params' nesting, without ``pe``."""
    n = len({k.split(".")[1] for k in leaves if k.startswith("layers.")})
    return {**{k: leaves[k] for k in T2S_TOP},
            "layers": [{k: leaves[f"layers.{i}.{k}"] for k, _, _ in LAYER_KEYS}
                       for i in range(n)]}


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


def labels_and_mask(cfg: T2SConfig, y_ids, x_lens, y_lens, T: int):
    """The packed row's next-token labels [B, T] and audio-position mask:
    position ``x_len + t`` predicts ``y[t + 1]``, the last audio position
    EOS."""
    Ly = y_ids.shape[1]
    pos = torch.arange(T, device=y_ids.device)[None, :]
    xy_lens = x_lens + y_lens
    in_audio = (pos >= x_lens[:, None]) & (pos < xy_lens[:, None])
    t_in_audio = (pos - x_lens[:, None]).clamp(0, Ly - 1)
    next_t = (t_in_audio + 1).clamp(0, Ly - 1)
    y_next = torch.gather(y_ids.long(), 1, next_t)
    return torch.where(pos == xy_lens[:, None] - 1, cfg.eos, y_next), in_audio


def nll_sum(h, predict_w, labels, in_audio):
    """The float32 NLL of ``labels`` under ``h``'s logits, summed over the
    audio positions."""
    logits = F.linear(h, predict_w).float()  # [B, T, V]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 2, labels[:, :, None])[:, :, 0]
    return torch.where(in_audio, nll, 0.0).sum()


def t2s_nll(params, cfg: T2SConfig, x_ids, y_ids, bert, x_lens, y_lens,
            dtype=torch.bfloat16, remat: bool = False, seq=None):
    """``(NLL sum, token count)`` of :func:`t2s_loss` before the division.
    ``seq`` (a process group): this rank takes its slice of the packed
    prompt's time axis (the sum covers its positions; the count, all of the
    rows')."""
    xy_pos, mask, _ = t2s_model.embed_prompt_batch(params, cfg, x_ids, y_ids, bert, x_lens,
                                                   y_lens, dtype)
    labels, in_audio = labels_and_mask(cfg, y_ids, x_lens, y_lens, xy_pos.shape[1])
    count = in_audio.sum()
    if seq is not None:
        n, r = dist.get_world_size(seq), dist.get_rank(seq)
        T = xy_pos.shape[1]
        if T % n:
            raise ValueError(f"packed length {T} does not split over {n} sequence ranks")
        rows = slice(r * T // n, (r + 1) * T // n)
        xy_pos, mask = xy_pos[:, rows], mask[:, rows]
        labels, in_audio = labels[:, rows], in_audio[:, rows]

    def layers(xy):
        return t2s_model.transformer_prefill(params, cfg, xy, mask, seq=seq)[0]

    h = checkpoint(layers, xy_pos, use_reentrant=False) if remat else layers(xy_pos)
    return nll_sum(h, params["predict_w"], labels, in_audio), count


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
    total, count = t2s_nll(params, cfg, x_ids, y_ids, bert, x_lens, y_lens, dtype, remat)
    return total / count.clamp(min=1)


def all_sum(t: torch.Tensor, *groups) -> torch.Tensor:
    """``t`` summed over each process group in turn (None: skipped)."""
    for g in groups:
        if g is not None and dist.get_world_size(g) > 1:
            t = t.clone()
            dist.all_reduce(t, group=g)
    return t


class GradSync:
    """Turns a rank's gradients into those of the logical (unsharded) step.

    ``sum_over[name]``: the process groups over which the leaf's gradient is
    summed (ranks holding other rows of the batch, or the same leaf on
    other pipeline stages); ``norm_over[name]``: the group the leaf is split
    over (its squares are summed over it in the global norm), or None for a
    leaf whose every rank holds all of it (counted once).  Gradients travel
    as one float32 buffer per set of groups; groups of one rank are
    skipped."""

    def __init__(self, sum_over: Dict[str, tuple], norm_over: Dict[str, Optional[object]]):
        def live(groups):
            return tuple(g for g in groups if g is not None and dist.get_world_size(g) > 1)

        self.sum_over = {k: live(v) for k, v in sum_over.items()}
        self.norm_over = {k: (live((v,)) or (None,))[0] for k, v in norm_over.items()}

    def reduce(self, names, grads) -> list:
        grads = list(grads)
        buckets: Dict[tuple, list] = {}
        for i, name in enumerate(names):
            if self.sum_over[name]:
                buckets.setdefault(self.sum_over[name], []).append(i)
        for groups, idx in buckets.items():
            flat = torch.cat([grads[i].float().flatten() for i in idx])
            for g in groups:
                dist.all_reduce(flat, group=g)
            for i, part in zip(idx, flat.split([grads[i].numel() for i in idx])):
                grads[i] = part.view_as(grads[i]).to(grads[i].dtype)
        return grads

    def leaf_norms(self, names, norms) -> list:
        """Per-leaf float32 norms of the whole leaves (a split leaf's summed
        in square over its group)."""
        norms = list(norms)
        buckets: Dict[object, list] = {}
        for i, name in enumerate(names):
            if self.norm_over[name] is not None:
                buckets.setdefault(self.norm_over[name], []).append(i)
        for g, idx in buckets.items():
            sq = torch.stack([norms[i] ** 2 for i in idx])
            dist.all_reduce(sq, group=g)
            for i, v in zip(idx, sq.sqrt()):
                norms[i] = v
        return norms


def t2s_grad_sync(names, mesh=None, seq: bool = False, pp_mesh=None) -> Optional[GradSync]:
    """The :class:`GradSync` of t2s leaves ``names`` (``t2s_leaves``'
    names): on a ``("dp", "tp")`` ``mesh`` every gradient summed over dp and
    the tp-split layer tensors' norms over tp, or with ``seq`` (params
    replicated, time split over tp) every gradient summed over dp and tp;
    on a ``("dp", "pp")`` ``pp_mesh`` the layers' gradients summed over dp
    and their norms over pp, the replicated leaves' over dp and pp.  None
    without a mesh."""
    if pp_mesh is not None:
        dp, pp = pmesh.axis(pp_mesh, "dp")[0], pmesh.axis(pp_mesh, "pp")[0]

        def is_layer(n):
            return n.startswith("layers.")
        return GradSync({n: (dp,) if is_layer(n) else (dp, pp) for n in names},
                        {n: pp if is_layer(n) else None for n in names})
    if mesh is None:
        return None
    dp, tp = pmesh.axis(mesh, "dp")[0], pmesh.axis(mesh, "tp")[0]
    if seq:
        return GradSync({n: (dp, tp) for n in names}, {n: None for n in names})
    return GradSync({n: (dp,) for n in names},
                    {n: tp if n.split(".")[-1] in pmesh.TP_SPLIT else None for n in names})


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
                 weight_decay: float = 1e-4, clip_norm: Optional[float] = 1.0,
                 sync: Optional[GradSync] = None):
        self.leaves = dict(leaves)
        #: how the ranks' gradients combine (None: one card)
        self.sync = sync
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
        self.apply(torch.autograd.grad(loss, self.params))

    def apply(self, grads) -> None:
        """One optimizer update from this rank's gradients of the leaves (in
        their order), combined over the ranks by ``sync``."""
        names = list(self.leaves)
        if self.sync is not None:
            grads = self.sync.reduce(names, grads)
        if self.clip_norm is not None:
            norms = [torch.linalg.vector_norm(g.float()) for g in grads]
            if self.sync is not None:
                norms = self.sync.leaf_norms(names, norms)
            norm = torch.linalg.vector_norm(torch.stack(norms))
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
                    remat: bool = False, seq_mesh=None, mesh=None):
    """Returns ``step(params, batch) → loss``: one :func:`t2s_loss` and one
    ``optimizer`` update of the leaves it holds (``params``' tensors, in place).

    Over a ``("dp", "tp")`` mesh (every rank calls the step): ``mesh`` with
    params from ``mesh.shard_t2s_params``, or ``seq_mesh`` with whole params
    and the time axis split over tp; ``batch`` is the rank's rows
    (``mesh.batch_sharding``), ``optimizer`` holds the rank's leaves with
    :func:`t2s_grad_sync`'s ``sync``.  The loss returned is the whole
    batch's on every rank."""
    mesh = seq_mesh if seq_mesh is not None else mesh
    dp = pmesh.axis(mesh, "dp")[0]
    seq = pmesh.axis(seq_mesh, "tp")[0]

    def step(params, batch):
        total, count = t2s_nll(params, cfg, batch["x_ids"], batch["y_ids"], batch["bert"],
                               batch["x_lens"], batch["y_lens"], dtype, remat=remat, seq=seq)
        count = all_sum(count, dp).clamp(min=1)
        optimizer.update(total / count)
        return all_sum(total.detach(), dp, seq) / count

    return step


def make_optimizer(leaves: Dict[str, torch.Tensor], peak_lr: float = 1e-4,
                   warmup_steps: int = 500, decay_steps: int = 50_000,
                   end_lr_scale: float = 0.1, weight_decay: float = 0.01,
                   clip_norm: float = 1.0, b1: float = 0.9, b2: float = 0.95,
                   sync: Optional[GradSync] = None):
    """AdamW with linear warmup → cosine decay and global-norm clipping over
    ``leaves`` (JAX's recipe and defaults).  Returns (optimizer, schedule)."""
    schedule = warmup_cosine_schedule(peak_lr, warmup_steps, decay_steps,
                                      peak_lr * end_lr_scale)
    return Optimizer(leaves, schedule, b1=b1, b2=b2, weight_decay=weight_decay,
                     clip_norm=clip_norm, sync=sync), schedule


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
