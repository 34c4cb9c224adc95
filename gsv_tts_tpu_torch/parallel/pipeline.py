"""Pipeline-parallel t2s training: a GPipe schedule over a ``("dp", "pp")``
mesh (counterpart of ``gsv_tts_tpu/parallel/pipeline.py``).

  * Stage ``s`` of ``pp`` holds layers ``[s·L/pp, (s+1)·L/pp)``
    (:func:`shard_pp_params`); embeddings, ``predict_w`` and ``pe`` are on
    every stage (replicated), as in JAX.
  * The step runs the schedule by hand, one process per stage: every
    microbatch forward, stage to stage (``dist.batch_isend_irecv``), the
    last stage taking the labels and the loss mask of
    ``parallel/train.py``; then every microbatch backward in reverse order,
    each stage sending its input's gradient upstream.  (JAX writes the same
    schedule as a scan of ticks under ``shard_map`` and lets autodiff
    mirror it.)
  * ``dp`` composes: the batch's rows split over dp.  The loss is the
    global token mean (each microbatch's NLL sum over the count summed over
    dp), so ``n_micro`` changes the order of sums only.
  * Gradients: layer shards summed over dp, replicated leaves over dp and
    pp (the stages that do not use a leaf contribute zeros).  The
    optimizer's clip takes the norm of the whole logical gradient (layer
    norms summed over pp, replicated leaves once) — clipping each stage by
    its own norm would differ, as JAX's docstring warns.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from ..models import t2s as t2s_model
from ..models.t2s import T2SConfig
from ..ops.flash_prefill import hybrid_mask
from . import mesh as pmesh
from .train import Optimizer, all_sum, labels_and_mask, nll_sum


def factor_pp(n: int, dp: Optional[int] = None, pp: Optional[int] = None) -> Tuple[int, int]:
    """JAX's ``make_mesh_dp_pp`` rule: without sizes, the deepest pipeline
    (8, 4, 2, 1) that divides ``n`` and dp the rest; one size given, the
    other is the rest.  Raises ``ValueError`` when ``dp * pp != n``."""
    if pp is None and dp is None:
        pp = next(c for c in (8, 4, 2, 1) if n % c == 0)
        dp = n // pp
    elif pp is None:
        pp = n // dp
    elif dp is None:
        dp = n // pp
    if dp * pp != n:
        raise ValueError(f"dp({dp}) * pp({pp}) != n_devices({n})")
    return dp, pp


def make_mesh_dp_pp(n_devices: Optional[int] = None, dp: Optional[int] = None,
                    pp: Optional[int] = None, device=None):
    """A ``DeviceMesh`` over the world with dims ``("dp", "pp")``
    (:func:`factor_pp`); ``device`` as in ``mesh.make_mesh``."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = pmesh.init_world(device)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but the world has {n} ranks")
    return init_device_mesh(device_type, factor_pp(n, dp, pp), mesh_dim_names=("dp", "pp"))


def stage_layers(cfg: T2SConfig, mesh) -> range:
    """The layer indices of this rank's stage."""
    _, pp, s = pmesh.axis(mesh, "pp")
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers={cfg.num_layers} must divide pp={pp}")
    n = cfg.num_layers // pp
    return range(s * n, (s + 1) * n)


def pp_param_sharding(cfg: T2SConfig, mesh) -> Dict:
    """Which tensors this rank's stage holds: every top-level tensor
    (replicated) and ``"layers"``: the stage's layer indices."""
    top = ("text_emb", "audio_emb", "bert_proj_w", "bert_proj_b", "text_pos_alpha",
           "audio_pos_alpha", "predict_w", "pe")
    return {"top": top, "layers": stage_layers(cfg, mesh)}


def shard_pp_params(params, cfg: T2SConfig, mesh) -> Dict:
    """This stage's params: the replicated tensors and its layers."""
    sh = pp_param_sharding(cfg, mesh)
    out = {k: params[k] for k in sh["top"] if k in params}
    out["layers"] = [params["layers"][i] for i in sh["layers"]]
    return out


def gather_pp_layers(layers, mesh) -> list:
    """Every stage's layers, in order, on every rank (a collective over
    pp): ``layers`` is this stage's list of per-layer dicts."""
    group, pp, _ = pmesh.axis(mesh, "pp")
    per_stage = [[None] * len(layers) for _ in range(pp)]
    for j, lp in enumerate(layers):
        for s in range(pp):
            per_stage[s][j] = {}
        for k, t in lp.items():
            parts = [torch.empty_like(t) for _ in range(pp)]
            dist.all_gather(parts, t.contiguous(), group=group)
            for s in range(pp):
                per_stage[s][j][k] = parts[s]
    return [lp for stage in per_stage for lp in stage]


def make_pp_train_step(cfg: T2SConfig, optimizer: Optimizer, mesh, n_micro: int,
                       dtype=torch.bfloat16, remat: bool = False):
    """Returns ``step(params, batch) → loss``, the GPipe step on this rank's
    stage.  ``params``: :func:`shard_pp_params`' (leaves that require
    grad); ``batch``: this rank's dp rows (``mesh.batch_sharding``), whose
    count must divide ``n_micro``; ``optimizer``: over ``t2s_leaves(params)``
    with ``train.t2s_grad_sync(names, pp_mesh=mesh)``.  The loss returned is
    the whole batch's on every rank."""
    dp_group = pmesh.axis(mesh, "dp")[0]
    pp_group, pp, stage = pmesh.axis(mesh, "pp")
    dp_index = pmesh.axis(mesh, "dp")[2]
    ranks = mesh.mesh.reshape(-1, pp)[dp_index].tolist()
    prev_rank = ranks[stage - 1] if stage > 0 else None
    next_rank = ranks[stage + 1] if stage < pp - 1 else None
    first, last = stage == 0, stage == pp - 1

    def p2p(op, t, peer):
        for req in dist.batch_isend_irecv([dist.P2POp(op, t, peer)]):
            req.wait()

    def apply_stage(params, x, mask):
        for lp in params["layers"]:
            x, _, _ = t2s_model._block_prefill(x, lp, mask, cfg.num_heads)
        return x

    def step(params, batch):
        x_ids, y_ids, bert = batch["x_ids"], batch["y_ids"], batch["bert"]
        x_lens, y_lens = batch["x_lens"], batch["y_lens"]
        B = y_ids.shape[0]
        if B % n_micro:
            raise ValueError(f"local batch {B} (global/dp) must divide n_micro={n_micro}")
        mb = B // n_micro
        T = x_ids.shape[1] + y_ids.shape[1]
        labels, in_audio = labels_and_mask(cfg, y_ids, x_lens, y_lens, T)
        count = all_sum(in_audio.sum(), dp_group).clamp(min=1)
        mask = hybrid_mask(T, x_lens, x_lens + y_lens)
        shape = (mb, T, cfg.hidden_dim)
        dev = y_ids.device
        inputs, outputs = [], []
        nll = torch.zeros((), dtype=torch.float32, device=dev)
        for m in range(n_micro):  # forward, stage to stage
            rows = slice(m * mb, (m + 1) * mb)
            if first:
                x, _, _ = t2s_model.embed_prompt_batch(
                    params, cfg, x_ids[rows], y_ids[rows], bert[rows], x_lens[rows],
                    y_lens[rows], dtype, with_mask=False)
            else:
                x = torch.empty(shape, dtype=dtype, device=dev)
                p2p(dist.irecv, x, prev_rank)
                x.requires_grad_(True)
            out = checkpoint(apply_stage, params, x, mask[rows], use_reentrant=False) \
                if remat else apply_stage(params, x, mask[rows])
            if last:
                out = nll_sum(out, params["predict_w"], labels[rows], in_audio[rows])
                nll = nll + out.detach()
                out = out / count
            else:
                p2p(dist.isend, out.detach().contiguous(), next_rank)
            inputs.append(x)
            outputs.append(out)
        leaves = optimizer.params
        for p in leaves:
            p.grad = None
        for m in reversed(range(n_micro)):  # backward, stage to stage
            if last:
                outputs[m].backward()
            else:
                g = torch.empty(shape, dtype=dtype, device=dev)
                p2p(dist.irecv, g, next_rank)
                outputs[m].backward(g)
            if not first:
                p2p(dist.isend, inputs[m].grad.contiguous(), prev_rank)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
        for p in leaves:
            p.grad = None
        optimizer.apply(grads)
        return all_sum(nll, dp_group, pp_group) / count

    return step
