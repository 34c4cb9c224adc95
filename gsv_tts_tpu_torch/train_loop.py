"""Resumable fine-tuning loops with whole-train-state checkpoints
(counterpart of ``gsv_tts_tpu/train_loop.py``), on one card or over the
ranks of a mesh (``parallel/mesh.py``; every rank calls the loop with the
same arguments).

  * :func:`save_train_state` / :func:`load_train_state` — nested dicts and
    lists of tensors and ints (params, AdamW states, the step) as one flat
    ``.npz`` written atomically; bf16 is stored as float32 (lossless) and
    cast back to the template's dtype on load.  The keys are this package's
    own (``params.layers.0.qkv_w``, ``opt.predict_w.exp_avg``, ``step``): the
    file does not interchange with the JAX package's optax pytree.
  * :func:`finetune_t2s` — stage-1 CE loop: epoch-seeded length-bucketed
    batches, periodic checkpoints, resume that replays the same batch order
    from the saved step, a final safetensors export ``TTS.load_gpt_model``
    reads.
  * :func:`finetune_sovits` — stage-2 GAN loop (G and D params and both
    AdamW states in one checkpoint); each step draws from a
    ``torch.Generator`` seeded from ``(seed, step)``, so a resumed run draws
    the same noise and slice starts.

Over a mesh the checkpoint holds the whole model and optimizer state
(gathered, written by rank 0, read by every rank): the file is the
single-card run's, so a resume may change the mesh.  Rank 0 logs and
exports.

``examples/finetune_t2s_torch.py`` / ``finetune_sovits_torch.py`` are thin
command lines over these functions.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .config import default_device

__all__ = ["save_train_state", "load_train_state", "finetune_t2s", "finetune_sovits",
           "sovits_batches"]


# ---------------------------------------------------------------------------
# Train-state checkpoints (.npz, no pickle)
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    """[(dotted key, leaf), ...] of nested dicts / lists in their order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def _unflatten_like(template, leaves):
    if isinstance(template, dict):
        return {k: _unflatten_like(v, leaves) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return [_unflatten_like(v, leaves) for v in template]
    return next(leaves)


def save_train_state(path: str, state) -> None:
    """Write nested dicts / lists of tensors and ints to ``path`` as one flat
    ``.npz``, atomically (a temporary file, then a rename).  bf16 is widened
    to float32 (numpy has no bf16); :func:`load_train_state` casts back."""
    arrays = {}
    for key, leaf in _flatten(state):
        if torch.is_tensor(leaf):
            leaf = leaf.detach()
            leaf = (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).cpu().numpy()
        arrays[key] = np.asarray(leaf)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_train_state(path: str, template):
    """Read a state saved by :func:`save_train_state` into the structure of
    ``template``, each tensor in its template's dtype and on its device, each
    int an int.  A file whose keys or shapes differ from the template's (other
    model widths, another optimizer) raises ``ValueError`` rather than mix
    states."""
    with np.load(path) as z:
        flat = _flatten(template)
        want = [k for k, _ in flat]
        missing = [k for k in want if k not in z.files]
        extra = sorted(set(z.files) - set(want))
        if missing or extra:
            raise ValueError(f"checkpoint {path} does not match the training setup: "
                             f"missing={missing[:5]} extra={extra[:5]}")
        leaves = []
        for key, ref in flat:
            a = z[key]
            if tuple(a.shape) != tuple(np.shape(ref)):
                raise ValueError(f"checkpoint leaf {key}: shape {a.shape} != template "
                                 f"{tuple(np.shape(ref))}")
            leaves.append(torch.as_tensor(a).to(device=ref.device, dtype=ref.dtype)
                          if torch.is_tensor(ref) else type(ref)(a))
    return _unflatten_like(template, iter(leaves))


def _load_into(path: str, state) -> int:
    """Copy a saved state into ``state``'s tensors in place; returns its step."""
    loaded = load_train_state(path, state)
    with torch.no_grad():
        for (_, dst), (_, src) in zip(_flatten(state), _flatten(loaded)):
            if torch.is_tensor(dst):
                dst.copy_(src)
    return int(loaded["step"])


def _step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one step's draws, seeded from ``(seed, step)``."""
    word = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word))


def _log_every(step: int, step0: int, log_every: int) -> bool:
    return step % log_every == 0 or step == step0 + 1


def _rank0(mesh) -> bool:
    """Whether this process writes files and logs (rank 0, or no mesh)."""
    return mesh is None or dist.get_rank() == 0


def _write(mesh, path: str, state) -> None:
    """``save_train_state`` on rank 0; the other ranks wait for it."""
    if _rank0(mesh):
        save_train_state(path, state)
    if mesh is not None:
        dist.barrier()


def _opt_template(leaves):
    """Zero AdamW state of ``leaves``, in :class:`parallel.train.Optimizer`'s
    layout (the checkpoint's)."""
    return {n: {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(t),
                "exp_avg_sq": torch.zeros_like(t)} for n, t in leaves.items()}


class _T2SLayout:
    """Where the trained t2s leaves of one rank lie in the whole model:
    their names in the single-card layout (``t2s_leaves``' names), the cut
    of a whole tensor, and the gather of a rank's leaves into the whole
    model's (a collective).  No mesh: the identity; a ``("dp", "tp")``
    mesh: the layers split by head; ``pp``: the stage's layers."""

    def __init__(self, cfg, mesh=None, pp: bool = False):
        from .parallel import mesh as pmesh
        from .parallel.pipeline import stage_layers

        self.mesh, self.pp = mesh, pp
        self.stage = stage_layers(cfg, mesh) if pp else None
        self.split = pmesh.t2s_param_sharding(mesh)["layers"] if mesh is not None and not pp \
            else None

    def name(self, local_name: str) -> str:
        if self.pp and local_name.startswith("layers."):
            _, j, k = local_name.split(".")
            return f"layers.{self.stage[int(j)]}.{k}"
        return local_name

    def cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        if self.split is not None and name.startswith("layers."):
            return self.split[name.split(".")[-1]].local(t)
        return t

    def gather(self, leaves):
        """``{local name: tensor}`` of every rank → ``{name: whole tensor}``
        in the single-card order, on every rank."""
        from .parallel.pipeline import gather_pp_layers
        from .parallel.train import t2s_leaves, t2s_tree

        if self.mesh is None:
            return dict(leaves)
        tree = t2s_tree(leaves)
        if self.pp:
            tree["layers"] = gather_pp_layers(tree["layers"], self.mesh)
        else:
            tree["layers"] = [{k: self.split[k].full(t) for k, t in lp.items()}
                              for lp in tree["layers"]]
        return t2s_leaves(tree)


# ---------------------------------------------------------------------------
# Stage 1: t2s CE fine-tuning
# ---------------------------------------------------------------------------

def finetune_t2s(samples: Sequence, cfg, out_dir: str, *, total_steps: int,
                 batch_size: int = 8, init_params=None, device=None, dtype=torch.bfloat16,
                 peak_lr: float = 1e-4, warmup_steps: int = 100, remat: bool = False,
                 mesh=None, pp_n_micro: int = 2,
                 ckpt_every: int = 500, log_every: int = 50, resume: bool = True,
                 seed: int = 0, export: bool = True, export_config: Optional[dict] = None,
                 max_steps_this_run: Optional[int] = None,
                 log_fn: Callable[[str], None] = print):
    """Run (or resume) stage-1 fine-tuning to ``total_steps`` on ``device``
    (the card by default, which raises when there is none, as ``Config()``
    does).

    ``init_params`` (e.g. a loaded ``Gpt.params``) is copied to ``device``
    in its own dtypes; without it the params are drawn from ``seed`` in ``dtype``,
    which is also the activations' dtype.  ``{out_dir}/t2s_state.npz`` holds
    params, AdamW state and step; with ``resume`` an existing one is
    continued from its step with the same epoch-seeded batch order (pass the
    same ``total_steps``: it shapes the schedule).  ``max_steps_this_run``
    bounds one call without touching the schedule.

    ``mesh``: a ``("dp", "tp")`` mesh (``parallel/mesh.py:make_mesh``) runs
    ``parallel/train.py``'s sharded step; a ``("dp", "pp")`` mesh with pp > 1
    (``parallel/pipeline.py:make_mesh_dp_pp``) the GPipe step with
    ``pp_n_micro`` microbatches, whose batches must divide ``dp *
    pp_n_micro`` (the ragged last batch of an epoch is dropped).
    ``export_config`` is the exported ``config.json`` (default: ``cfg``'s).
    Returns the final params (the whole model's on every rank)."""
    from . import train_data
    from .loader import save_trained_gpt
    from .models import t2s as t2s_model
    from .parallel import mesh as pmesh
    from .parallel import train as ptrain

    if not samples:
        raise ValueError("no training samples (empty/filtered manifest?)")
    pp_mode = mesh is not None and pmesh.axis(mesh, "pp")[1] > 1
    if pp_mode:
        dp = pmesh.axis(mesh, "dp")[1]
        if batch_size % (dp * pp_n_micro) != 0:
            raise ValueError(f"batch_size={batch_size} must divide dp({dp}) * "
                             f"n_micro({pp_n_micro}) for the GPipe schedule")
        if len(samples) < batch_size:
            # the GPipe loop drops the ragged epoch tail: with no full batch it would spin
            raise ValueError(f"pipeline training needs >= one full batch "
                             f"({len(samples)} samples < batch_size={batch_size})")
    device = default_device() if device is None else torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_path = os.path.join(out_dir, "t2s_state.npz")

    if init_params is None:
        init_params = t2s_model.init_params(cfg, torch.Generator().manual_seed(seed),
                                            dtype=dtype, device=device)
    whole = ptrain.t2s_train_params(init_params, device)
    layout = _T2SLayout(cfg, mesh, pp_mode)
    step, opt_state = 0, None
    if resume and os.path.exists(ckpt_path):
        leaves = ptrain.t2s_leaves(whole)
        loaded = load_train_state(ckpt_path, {"params": leaves, "opt": _opt_template(leaves),
                                              "step": 0})
        with torch.no_grad():
            for n, t in leaves.items():
                t.copy_(loaded["params"][n])
        step, opt_state = int(loaded["step"]), loaded["opt"]
    if pp_mode:
        from .parallel import pipeline as ppl
        params = ppl.shard_pp_params(whole, cfg, mesh)
    elif mesh is not None:
        pmesh.check_tp(cfg, mesh)
        params = ptrain.t2s_train_params(pmesh.shard_t2s_params(whole, mesh))
        params["tp"] = pmesh.axis(mesh, "tp")[0]
    else:
        params = whole
    leaves = ptrain.t2s_leaves(params)
    sync = ptrain.t2s_grad_sync(list(leaves), pp_mesh=mesh) if pp_mode \
        else ptrain.t2s_grad_sync(list(leaves), mesh=mesh)
    # optax's warmup-cosine needs warmup < decay_steps (the whole schedule)
    warmup_steps = min(warmup_steps, max(total_steps - 1, 0))
    optimizer, schedule = ptrain.make_optimizer(
        leaves, peak_lr=peak_lr, warmup_steps=warmup_steps,
        decay_steps=max(total_steps, warmup_steps + 1), sync=sync)
    if opt_state is not None:
        with torch.no_grad():
            for n, st in optimizer.state().items():
                full = opt_state[layout.name(n)]
                st["step"].copy_(full["step"])
                for k in ("exp_avg", "exp_avg_sq"):
                    st[k].copy_(layout.cut(layout.name(n), full[k]))
        optimizer.resume(step)
        if _rank0(mesh):
            log_fn(f"resumed from {ckpt_path} at step {step}")
    if pp_mode:
        step_fn = ppl.make_pp_train_step(cfg, optimizer, mesh, n_micro=pp_n_micro, dtype=dtype,
                                         remat=remat)
    else:
        step_fn = ptrain.make_train_step(cfg, optimizer, dtype=dtype, remat=remat, mesh=mesh)
    rows = pmesh.batch_sharding(mesh)

    def checkpoint():
        state = optimizer.state()
        opt = {k: layout.gather({n: st[k] for n, st in state.items()})
               for k in ("exp_avg", "exp_avg_sq")}
        count = next(iter(state.values()))["step"]  # every leaf's: each update updates all
        _write(mesh, ckpt_path, {
            "params": layout.gather(optimizer.leaves),
            "opt": {n: {"step": count, "exp_avg": opt["exp_avg"][n],
                        "exp_avg_sq": opt["exp_avg_sq"][n]} for n in opt["exp_avg"]},
            "step": step})

    # GPipe needs every batch to divide dp * n_micro: drop the ragged epoch tail there
    bpe = max(1, len(samples) // batch_size) if pp_mode \
        else max(1, -(-len(samples) // batch_size))  # batches per epoch
    stop = total_steps if max_steps_this_run is None else min(total_steps,
                                                              step + max_steps_this_run)
    t0, step0 = time.time(), step
    while step < stop:
        epoch = step // bpe
        it = train_data.batches(cfg, samples, batch_size, seed=seed + epoch,
                                drop_remainder=pp_mode, device=device)
        for batch in itertools.islice(it, step % bpe, None):  # mid-epoch resume
            loss = step_fn(params, {k: rows(v) for k, v in batch.items()})
            step += 1
            if _log_every(step, step0, log_every) and _rank0(mesh):
                dt = (time.time() - t0) / max(step - step0, 1)
                log_fn(f"step {step:6d}  loss {float(loss):.4f}  lr {schedule(step):.2e}  "
                       f"{dt * 1e3:.0f} ms/step")
            if step % ckpt_every == 0:
                checkpoint()
            if step >= stop:
                break

    checkpoint()
    if mesh is not None:
        params = {**ptrain.t2s_tree(layout.gather(optimizer.leaves)), "pe": whole["pe"]}
    if export and _rank0(mesh):
        save_trained_gpt(params, cfg, out_dir, config=export_config)
        log_fn(f"exported safetensors checkpoint to {out_dir}")
    if mesh is not None:
        dist.barrier()
    return params


# ---------------------------------------------------------------------------
# Stage 2: SoVITS GAN fine-tuning
# ---------------------------------------------------------------------------

def sovits_batches(cfg, samples: Sequence, batch_size: int, hop_length: int,
                   seed: Optional[int] = 0, pad_multiple: int = 32, device="cpu"):
    """Length-bucketed padded GAN batches on ``device`` (the design and the
    order of ``train_data.batches``, by spectrogram frames)."""
    from .models.sovits_train import pad_sovits_batch
    from .train_data import bucketed_chunks

    lengths = [s[1].shape[-1] for s in samples]
    for chunk in bucketed_chunks(lengths, batch_size, seed):
        yield pad_sovits_batch(cfg, [samples[i] for i in chunk], hop_length,
                               pad_multiple=pad_multiple, device=device)


def finetune_sovits(samples: Sequence, cfg, hps, out_dir: str, *, total_steps: int,
                    batch_size: int = 4, init_params=None, device=None,
                    dtype=torch.float32, g_lr: float = 2e-4, d_lr: float = 2e-4,
                    segment_frames: Optional[int] = None, mesh=None, ckpt_every: int = 500,
                    log_every: int = 50, resume: bool = True, seed: int = 0,
                    export: bool = True, max_steps_this_run: Optional[int] = None,
                    log_fn: Callable[[str], None] = print):
    """Run (or resume) stage-2 GAN fine-tuning to ``total_steps`` on ``device``.

    ``init_params`` is a loaded SoVITS param dict, copied into ``dtype``; a
    fresh posterior encoder (from ``seed``) is added when the checkpoint has
    no ``enc_q.*``, and fresh discriminators (from ``seed + 1``) always.  The
    generator and the discriminators each have optax's ``chain(
    clip_by_global_norm(1.0), adamw(lr))`` with its defaults (b2 0.999, weight
    decay 1e-4); the frozen RVQ leaves (``sovits_train.FROZEN_PREFIXES``)
    stay out of the generator's.  ``{out_dir}/sovits_state.npz`` holds both
    params, both AdamW states and the step; each step's draws come from a
    generator seeded from ``(seed + 2, step)``, so a resumed run draws what
    the straight run drew.

    ``mesh``: batches split over its ``dp`` ranks (the draws made for the
    whole batch on every rank, each rank taking its rows), G and D
    replicated, gradients summed over dp; ``batch_size`` must divide by dp.
    Returns the final generator params."""
    from .loader import save_trained_sovits
    from .models import sovits_train as svt
    from .parallel import mesh as pmesh
    from .parallel.train import GradSync, Optimizer

    if not samples:
        raise ValueError("no training samples (empty/filtered manifest?)")
    dp_group, dp, _ = pmesh.axis(mesh, "dp")
    if batch_size % dp:
        raise ValueError(f"batch_size {batch_size} must divide by the mesh dp extent {dp}")
    rows = pmesh.batch_sharding(mesh)
    device = default_device() if device is None else torch.device(device)
    os.makedirs(out_dir, exist_ok=True)
    ckpt_path = os.path.join(out_dir, "sovits_state.npz")

    hop = int(hps.data.hop_length)
    spf = cfg.samples_per_frame
    if spf != hop:
        if spf % hop:
            raise ValueError(f"hop_length ({hop}) incompatible with the vocoder's "
                             f"samples-per-frame ({spf})")
        r = spf // hop
        samples = [(s[0][:, ::r], s[1][:, ::r], *s[2:]) for s in samples]
        hop = spf
    if segment_frames is None:
        segment_frames = max(int(hps.train.segment_size) // hop, 4)

    params = {k: v.detach().to(device=device, dtype=dtype).clone()
              for k, v in (init_params or {}).items()}
    if "enc_q.pre.weight" not in params:
        params.update(svt.init_enc_q_params(cfg, torch.Generator().manual_seed(seed),
                                            dtype=dtype, device=device))
        if _rank0(mesh):
            log_fn("posterior encoder not in checkpoint — fresh init")
    d_params = svt.init_discriminator_params(torch.Generator().manual_seed(seed + 1),
                                             dtype=dtype, device=device)
    g_leaves = {k: v.requires_grad_(True) for k, v in params.items()
                if not k.startswith(svt.FROZEN_PREFIXES)}
    for v in d_params.values():
        v.requires_grad_(True)

    def sync(leaves):
        return None if mesh is None else GradSync({k: (dp_group,) for k in leaves},
                                                  {k: None for k in leaves})

    g_opt = Optimizer(g_leaves, lambda _: g_lr, sync=sync(g_leaves))
    d_opt = Optimizer(d_params, lambda _: d_lr, sync=sync(d_params))
    state = {"g": params, "d": d_params, "g_opt": g_opt.state(), "d_opt": d_opt.state(),
             "step": 0}
    step = 0
    if resume and os.path.exists(ckpt_path):
        step = _load_into(ckpt_path, state)
        g_opt.resume(step)
        d_opt.resume(step)
        if _rank0(mesh):
            log_fn(f"resumed from {ckpt_path} at step {step}")

    step_fn = svt.make_sovits_train_step(
        cfg, g_opt, d_opt, n_fft=int(hps.data.filter_length), hop_length=hop,
        win_length=int(hps.data.win_length), sr=int(hps.data.sampling_rate),
        segment_frames=segment_frames, dp_group=dp_group)

    def checkpoint():  # every rank holds the whole state
        _write(mesh, ckpt_path, {**state, "step": step})

    bpe = max(1, -(-len(samples) // batch_size))
    stop = total_steps if max_steps_this_run is None else min(total_steps,
                                                              step + max_steps_this_run)
    t0, step0 = time.time(), step
    while step < stop:
        epoch = step // bpe
        it = sovits_batches(cfg, samples, batch_size, hop, seed=seed + epoch, device=device)
        for batch in itertools.islice(it, step % bpe, None):
            noise, u = svt.sovits_draws(cfg, batch, _step_generator(seed + 2, step, device))
            m = step_fn(params, d_params, {k: rows(v) for k, v in batch.items()}, rows(noise),
                        rows(u))
            step += 1
            if _log_every(step, step0, log_every) and _rank0(mesh):
                dt = (time.time() - t0) / max(step - step0, 1)
                log_fn(f"step {step:6d}  g {float(m['g_total']):.3f} "
                       f"(mel {float(m['mel']):.3f} kl {float(m['kl']):.3f} "
                       f"fm {float(m['fm']):.3f} adv {float(m['adv']):.3f})  "
                       f"d {float(m['d_total']):.3f}  {dt * 1e3:.0f} ms/step")
            if step % ckpt_every == 0:
                checkpoint()
            if step >= stop:
                break

    checkpoint()
    if export and _rank0(mesh):
        save_trained_sovits(params, hps, out_dir)
        log_fn(f"exported safetensors checkpoint to {out_dir}")
    if mesh is not None:
        dist.barrier()
    return params
