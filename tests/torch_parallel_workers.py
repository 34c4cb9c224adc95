"""What each rank runs in the port's multi-rank tests (``test_torch_parallel``,
``test_torch_pipeline``, ``test_torch_train_loop_mesh``): functions started
by ``gsv_tts_tpu_torch.parallel.launch.spawn`` in a gloo world on the CPU.

This module imports no JAX (a rank imports it again, with ``jax`` refused);
the JAX oracles run in the test process.  Inputs arrive as numpy arrays and
results leave as numpy arrays (rank 0's, unless a test needs every rank's).
"""
import os

import numpy as np
import torch
import torch.distributed as dist
from torch.optim.lr_scheduler import LambdaLR

from gsv_tts_tpu_torch.models import t2s as pt2s
from gsv_tts_tpu_torch.parallel import mesh as pmesh
from gsv_tts_tpu_torch.parallel import pipeline as ppl
from gsv_tts_tpu_torch.parallel import train as ptrain


def cfg_of(fields):
    return pt2s.T2SConfig(**fields)


def params_of(sd, cfg):
    """Port params from a numpy state dict in the runtime key layout."""
    return pt2s.params_from_torch_state_dict(sd, cfg)


def batch_of(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def numpy_leaves(leaves):
    return {k: v.detach().float().numpy().copy() for k, v in leaves.items()}


def sgd(optimizer):
    """The optimizer's clip, then plain SGD at rate 1 in place of AdamW: one
    update's change of a leaf is its clipped gradient (AdamW's g/(√v+ε)
    turns ±1e-8 noise near zero gradients into ±lr changes)."""
    optimizer.adamw = torch.optim.SGD(optimizer.params, lr=1.0)
    optimizer.lr = LambdaLR(optimizer.adamw, lambda _: 1.0)
    return optimizer


def rank0(value):
    return value if dist.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------

def engines(sd, fields, prompts):
    """tp=4 and dp=2×tp=2 ``T2SEngine.shard`` (``generate`` of the first
    prompt, ``generate_batched`` of all at ``[(1,128),(4,128)]``), and the
    dp=4 ``DataParallelEngine`` at ``[(1,128),(8,128)]`` greedy and sampled;
    every rank's tokens and stats (the ranks must agree)."""
    from gsv_tts_tpu_torch.parallel.shard import DataParallelEngine
    from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine

    cfg = cfg_of(fields)
    xs, ys, bs = prompts
    out = {}

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def batched(eng, **kw):
        pred, idx = eng.generate_batched(xs, ys, bs, generator=gen(0), **kw)
        return {int(i): p.tolist() for p, i in zip(pred, idx)}

    for name, dp, tp in (("tp4", 1, 4), ("dp2tp2", 2, 2)):
        mesh = pmesh.make_mesh(dp=dp, tp=tp, device="cpu")
        eng = T2SEngine(params_of(sd, cfg), cfg, [(1, 128), (4, 128)]).shard(mesh)
        one = eng.generate(xs[0], ys[0], bs[0], top_k=1, generator=gen(5)).ravel().tolist()
        out[name] = (one, batched(eng, top_k=1), eng.attn_impl,
                     tuple(eng.params["layers"][0]["qkv_w"].shape), "k1_table" in eng.params)
    mesh = pmesh.make_mesh(dp=4, tp=1, device="cpu")
    eng = DataParallelEngine(params_of(sd, cfg), cfg, [(1, 128), (8, 128)], mesh=mesh)
    out["dp4"] = (batched(eng, top_k=1), dict(eng.last_stats), eng.compactions)
    out["dp4_sampled"] = (batched(eng), dict(eng.last_stats))
    try:
        DataParallelEngine(params_of(sd, cfg), cfg, [(1, 128), (6, 128)], mesh=mesh)
        out["bad_bucket"] = None
    except ValueError as e:
        out["bad_bucket"] = str(e)
    return out


# ---------------------------------------------------------------------------
# Training steps
# ---------------------------------------------------------------------------

def _step_on(sd, cfg, batch, clip, mesh, seq=False, remat=False):
    whole = ptrain.t2s_train_params(params_of(sd, cfg))
    if seq:
        params = whole
    else:
        params = ptrain.t2s_train_params(pmesh.shard_t2s_params(whole, mesh))
        params["tp"] = pmesh.axis(mesh, "tp")[0]
    leaves = ptrain.t2s_leaves(params)
    opt = sgd(ptrain.Optimizer(leaves, lambda _: 1.0, clip_norm=clip,
                               sync=ptrain.t2s_grad_sync(list(leaves), mesh=mesh, seq=seq)))
    step = ptrain.make_train_step(cfg, opt, torch.float32, remat=remat,
                                  seq_mesh=mesh if seq else None, mesh=None if seq else mesh)
    rows = pmesh.batch_sharding(mesh)
    loss = step(params, {k: rows(v) for k, v in batch_of(batch).items()})
    full = ptrain.t2s_leaves(pmesh.gather_t2s_params(params, mesh)) if not seq else leaves
    return float(loss), numpy_leaves(full)


def train_steps(sd, fields, batch, seq_batch, clip):
    """One clipped-SGD step on a dp=2×tp=2 mesh (plain and ``remat``) and
    one ``seq_mesh`` step (time split over tp); rank 0's loss and whole
    updated leaves, and every rank's losses."""
    cfg = cfg_of(fields)
    mesh = pmesh.make_mesh(dp=2, tp=2, device="cpu")
    out = {"dp2tp2": _step_on(sd, cfg, batch, clip, mesh),
           "dp2tp2_remat": _step_on(sd, cfg, batch, clip, mesh, remat=True),
           "seq": _step_on(sd, cfg, seq_batch, clip, mesh, seq=True)}
    return {k: (v[0], rank0(v[1])) for k, v in out.items()}


def pp_steps(sd, fields, batches, cases, clip):
    """One clipped-SGD GPipe step per case ``(dp, pp, n_micro, remat,
    batch key)``: the loss and the whole updated leaves (rank 0's), and
    every rank's loss."""
    cfg = cfg_of(fields)
    out = []
    for dp, pp, n_micro, remat, key in cases:
        mesh = ppl.make_mesh_dp_pp(dp=dp, pp=pp, device="cpu")
        whole = ptrain.t2s_train_params(params_of(sd, cfg))
        params = ppl.shard_pp_params(whole, cfg, mesh)
        leaves = ptrain.t2s_leaves(params)
        opt = sgd(ptrain.Optimizer(leaves, lambda _: 1.0, clip_norm=clip,
                                   sync=ptrain.t2s_grad_sync(list(leaves), pp_mesh=mesh)))
        step = ppl.make_pp_train_step(cfg, opt, mesh, n_micro, torch.float32, remat)
        rows = pmesh.batch_sharding(mesh)
        loss = float(step(params, {k: rows(v) for k, v in batch_of(batches[key]).items()}))
        layers = ppl.gather_pp_layers(params["layers"], mesh)
        full = ptrain.t2s_leaves({**params, "layers": layers})
        out.append((loss, rank0(numpy_leaves(full))))
    return out


def parallel_world(sd, fields, prompt_set, batch, seq_batch, clip):
    """``test_torch_parallel``'s world: :func:`engines` and :func:`train_steps`."""
    return {"engines": engines(sd, fields, prompt_set),
            "train": train_steps(sd, fields, batch, seq_batch, clip)}


# ---------------------------------------------------------------------------
# Training loops
# ---------------------------------------------------------------------------

def finetune_t2s_runs(sd, fields, samples, root, kw):
    """``finetune_t2s`` on a dp=2×tp=2 mesh; on a dp=2×pp=2 mesh straight
    and interrupted at step 2 then resumed; the GPipe batch errors."""
    from gsv_tts_tpu_torch import train_loop

    cfg = cfg_of(fields)
    quiet = dict(log_fn=lambda *_: None, device="cpu", dtype=torch.float32, **kw)
    mesh = pmesh.make_mesh(dp=2, tp=2, device="cpu")
    tp_run = train_loop.finetune_t2s(samples, cfg, os.path.join(root, "tp"),
                                     init_params=params_of(sd, cfg), mesh=mesh, **quiet)
    pp = ppl.make_mesh_dp_pp(dp=2, pp=2, device="cpu")
    straight = train_loop.finetune_t2s(samples, cfg, os.path.join(root, "pp_a"),
                                       init_params=params_of(sd, cfg), mesh=pp,
                                       pp_n_micro=2, export=False, **quiet)
    train_loop.finetune_t2s(samples, cfg, os.path.join(root, "pp_b"),
                            init_params=params_of(sd, cfg), mesh=pp, pp_n_micro=2,
                            export=False, max_steps_this_run=2, **quiet)
    resumed = train_loop.finetune_t2s(samples, cfg, os.path.join(root, "pp_b"),
                                      init_params=params_of(sd, cfg), mesh=pp, pp_n_micro=2,
                                      export=False, **quiet)
    errors = []
    for bad in (dict(batch_size=6, pp_n_micro=4), dict(batch_size=len(samples) + 4)):
        try:
            train_loop.finetune_t2s(samples, cfg, os.path.join(root, "bad"), mesh=pp,
                                    **{**quiet, **bad, "total_steps": 1})
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return rank0({"tp": numpy_leaves(ptrain.t2s_leaves(tp_run)),
                  "pp_straight": numpy_leaves(ptrain.t2s_leaves(straight)),
                  "pp_resumed": numpy_leaves(ptrain.t2s_leaves(resumed)),
                  "errors": errors})


def finetune_sovits_runs(sd, cfg_fields, hps, samples, root, kw):
    """``finetune_sovits`` on a dp=2 mesh, and the batch that does not divide."""
    from gsv_tts_tpu_torch import train_loop
    from gsv_tts_tpu_torch.hparams import HParams
    from gsv_tts_tpu_torch.models.sovits import SovitsConfig

    cfg = SovitsConfig(**cfg_fields)
    mesh = pmesh.make_mesh(dp=2, tp=1, device="cpu")
    quiet = dict(log_fn=lambda *_: None, device="cpu", export=False, **kw)
    params = {k: torch.as_tensor(v) for k, v in sd.items()}
    run = train_loop.finetune_sovits(samples, cfg, HParams(hps), os.path.join(root, "dp"),
                                     init_params=params, mesh=mesh, **quiet)
    try:
        train_loop.finetune_sovits(samples, cfg, HParams(hps), os.path.join(root, "bad"),
                                   init_params=params, mesh=mesh, **{**quiet, "batch_size": 3})
        error = None
    except ValueError as e:
        error = str(e)
    return rank0({"params": numpy_leaves(run), "error": error})


# ---------------------------------------------------------------------------
# On the card: a world of one rank over NCCL
# ---------------------------------------------------------------------------

def card_world():
    """``make_mesh()`` (NCCL, ``cuda:0``, dp=1, tp=1): the sharded engine
    against the unsharded ``"xla"`` engine and ``DataParallelEngine`` against
    the plain engine with its K1 / K2 launches (bf16), a dp×tp train step, a
    ``seq_mesh`` step and a GPipe step at pp=1 against the single-card step
    (float32, no TF32)."""
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.parallel.shard import DataParallelEngine
    from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    mesh = pmesh.make_mesh()
    cfg = pt2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2)
    rng = np.random.RandomState(0)
    xs = [rng.randint(1, 700, int(rng.randint(8, 30))) for _ in range(6)]
    ys = [rng.randint(0, 1024, 20) for _ in range(6)]
    bs = [np.zeros((len(x), 1024), np.float32) for x in xs]
    cache = [(1, 256), (4, 256)]

    def params(dtype=torch.bfloat16):  # the kernels take bf16 weights
        return pt2s.init_params(cfg, torch.Generator().manual_seed(1), dtype=dtype, device=dev)

    def run(eng, **kw):
        g = torch.Generator(device=dev).manual_seed(0)
        pred, idx = eng.generate_batched(xs, ys, bs, generator=g, **kw)
        one = eng.generate(xs[0], ys[0], bs[0], top_k=1,
                           generator=torch.Generator(device=dev).manual_seed(5))
        return {int(i): p.tolist() for p, i in zip(pred, idx)}, one.ravel().tolist()

    k1, k2 = fused_step.fused_decode_step_sample, fused_step.fused_decode_step_sample_batched
    bf = torch.bfloat16
    out = {"xla": run(T2SEngine(params(), cfg, cache, dtype=bf, attn_impl="xla"), top_k=1)}
    k1.launches = k2.launches = 0
    sharded = T2SEngine(params(), cfg, cache, dtype=bf).shard(mesh)
    out["sharded"] = run(sharded, top_k=1)
    out["sharded_launches"] = (k1.launches, k2.launches)
    out["plain"] = run(T2SEngine(params(), cfg, cache, dtype=bf), top_k=1)
    dpe = DataParallelEngine(params(), cfg, cache, dtype=bf, mesh=mesh)
    k1.launches = k2.launches = 0
    pred, idx = dpe.generate_batched(xs, ys, bs, top_k=1,
                                     generator=torch.Generator(device=dev).manual_seed(0))
    out["dp"] = {int(i): p.tolist() for p, i in zip(pred, idx)}
    out["dp_launches"] = (k1.launches, k2.launches, dpe.last_stats["k1_steps"],
                          dpe.last_stats["k2_steps"])

    batch = ptrain.pad_batch(cfg, [(x, y, None) for x, y in zip(xs[:4], ys[:4])], device=dev)

    def step(kind):
        whole = ptrain.t2s_train_params(params(torch.float32))
        p, sync, fn_mesh = whole, None, {}
        if kind == "tp":
            p = ptrain.t2s_train_params(pmesh.shard_t2s_params(whole, mesh))
            p["tp"] = pmesh.axis(mesh, "tp")[0]
            sync, fn_mesh = ptrain.t2s_grad_sync(list(ptrain.t2s_leaves(p)), mesh=mesh), \
                {"mesh": mesh}
        elif kind == "seq":
            sync = ptrain.t2s_grad_sync(list(ptrain.t2s_leaves(p)), mesh=mesh, seq=True)
            fn_mesh = {"seq_mesh": mesh}
        elif kind == "pp":
            pp_mesh = ppl.make_mesh_dp_pp(device="cuda")
            p = ppl.shard_pp_params(whole, cfg, pp_mesh)
            sync = ptrain.t2s_grad_sync(list(ptrain.t2s_leaves(p)), pp_mesh=pp_mesh)
        leaves = ptrain.t2s_leaves(p)
        opt, _ = ptrain.make_optimizer(leaves, peak_lr=1e-3, warmup_steps=0, decay_steps=10,
                                       sync=sync)
        if kind == "pp":
            fn = ppl.make_pp_train_step(cfg, opt, pp_mesh, 2, torch.float32)
        else:
            fn = ptrain.make_train_step(cfg, opt, torch.float32, **fn_mesh)
        loss = fn(p, batch)
        return float(loss), {k: v.detach().cpu() for k, v in leaves.items()}

    out["steps"] = {kind: step(kind) for kind in ("single", "tp", "seq", "pp")}
    return out
