"""Device mesh and tensor-parallel layout on ``torch.distributed``
(counterpart of ``gsv_tts_tpu/parallel/mesh.py``).

JAX runs one process over a mesh of devices and lets GSPMD place the
collectives.  Here each rank is one process (``torchrun``, or
``parallel/launch.py:spawn`` in tests): a ``DeviceMesh`` with dims
``("dp", "tp")`` names the groups, and the collectives are explicit.

  * ``dp`` (data): request slots and training batches split over ranks;
  * ``tp`` (tensor): the t2s layers split by head, Megatron style — each tp
    rank holds the q, k and v rows of its ``H/tp`` heads and the matching
    ``mlp1`` rows (column-parallel), the matching columns of ``out`` and
    ``mlp2`` (row-parallel; their partial sums are all-reduced over tp and
    each bias is added once).  Embeddings, norms, ``predict_w`` and ``pe``
    are replicated.

The layout functions keep JAX's names.  Each returns the rank's local
tensors: ``t2s_param_sharding`` a tree of :class:`Replicated` /
:class:`Split` placements (``.local`` cuts a full tensor, ``.full``
gathers it back), ``shard_t2s_params`` the rank's params, which carry the
tp group under ``"tp"`` for the model's forward (``models/t2s.py``).
"""
from __future__ import annotations

import os
import socket
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

#: the t2s layer tensors a tp rank holds a slice of: (dim, parts) — dim 0
#: splits rows (the port keeps torch's ``[out, in]``), ``parts`` 3 splits q,
#: k and v each
TP_SPLIT = {"qkv_w": (0, 3), "qkv_b": (0, 3), "mlp1_w": (0, 1), "mlp1_b": (0, 1),
            "out_w": (1, 1), "mlp2_w": (1, 1)}


def factor(n: int, dp: Optional[int] = None, tp: Optional[int] = None) -> Tuple[int, int]:
    """JAX's ``make_mesh`` rule: without sizes, tp is the first of 4, 2, 1
    that divides ``n`` and dp the rest; one size given, the other is the
    rest.  Raises ``ValueError`` when ``dp * tp != n``."""
    if tp is None and dp is None:
        tp = next(c for c in (4, 2, 1) if n % c == 0)
        dp = n // tp
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != n_devices({n})")
    return dp, tp


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(device=None) -> str:
    """Start the default process group unless one exists: NCCL for
    ``cuda`` (the default), gloo for ``cpu``.  The world comes from
    ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); a process started without it is a world of one on a
    free localhost port.  On the card each rank takes ``cuda:LOCAL_RANK``.
    Returns the device type."""
    device_type = torch.device(device if device is not None else "cuda").type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device='cuda') needs a CUDA card; pass device='cpu' "
                           "for a gloo world")
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                              MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method="env://")
    return device_type


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, device=None):
    """A ``DeviceMesh`` over the world with dims ``("dp", "tp")`` (JAX's
    factorization, :func:`factor`).  ``n_devices`` must be the world size
    when given: every rank of the world is in the mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    device_type = init_world(device)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}, but the world has {n} ranks")
    return init_device_mesh(device_type, factor(n, dp, tp), mesh_dim_names=("dp", "tp"))


def axis(mesh, name: str) -> Tuple[Optional[object], int, int]:
    """``(group, size, this rank's index)`` of the mesh dim ``name``; a
    mesh without it (or no mesh) is ``(None, 1, 0)``."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None, 1, 0
    return mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)), \
        mesh.get_local_rank(name)


# ---------------------------------------------------------------------------
# Collectives with their gradients
# ---------------------------------------------------------------------------

def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order (no
    gradient)."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class _ReduceFromTP(torch.autograd.Function):
    """All-reduce (sum) forward, identity backward: the output of a
    row-parallel product.  (``torch.distributed.nn.functional.all_reduce``
    also sums in its backward, which multiplies the gradients of every
    replicated leaf upstream by tp.)"""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToTP(torch.autograd.Function):
    """Identity forward, all-reduce (sum) backward: the input of a
    column-parallel product, whose gradient each tp rank holds a part of."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim`` forward; backward the reduce-scatter (as an
    all-reduce, then this rank's slice, which gloo also runs)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


# a group of one rank runs no collective (as GSPMD inserts none for an axis of size 1)

def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if dist.get_world_size(group) == 1 else _ReduceFromTP.apply(x, group)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return x if dist.get_world_size(group) == 1 else _CopyToTP.apply(x, group)


def gather_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    return x if dist.get_world_size(group) == 1 else _GatherSeq.apply(x, group, dim)


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

class Replicated:
    """Every rank holds the whole tensor."""

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def full(self, t: torch.Tensor) -> torch.Tensor:
        return t


class Split:
    """Rank ``r`` of ``group`` holds slice ``r`` of each of ``parts`` equal
    blocks along ``dim`` (``parts=3``: the q, k and v blocks of ``qkv``, each
    cut by head)."""

    def __init__(self, group, dim: int = 0, parts: int = 1):
        self.group, self.dim, self.parts = group, dim, parts
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return torch.cat([b.chunk(self.n, self.dim)[self.rank]
                          for b in t.chunk(self.parts, self.dim)], self.dim).contiguous()

    def full(self, t: torch.Tensor) -> torch.Tensor:
        shards = all_gather_cat(t, self.group, self.dim).chunk(self.n, self.dim)
        blocks = [s.chunk(self.parts, self.dim) for s in shards]
        return torch.cat([torch.cat([b[p] for b in blocks], self.dim)
                          for p in range(self.parts)], self.dim)


def t2s_param_sharding(mesh) -> Dict:
    """The placement of every t2s tensor on ``mesh`` (JAX's tree, the
    port's per-layer list): column-parallel qkv / mlp1, row-parallel out /
    mlp2 over ``tp``, the rest replicated.  ``"layers"`` holds one dict that
    applies to every layer."""
    group, tp, _ = axis(mesh, "tp")
    rep = Replicated()
    layer = {k: rep for k in ("qkv_w", "qkv_b", "out_w", "out_b", "ln1_g", "ln1_b",
                              "mlp1_w", "mlp1_b", "mlp2_w", "mlp2_b", "ln2_g", "ln2_b")}
    if tp > 1:
        layer.update({k: Split(group, dim, parts) for k, (dim, parts) in TP_SPLIT.items()})
    top = {k: rep for k in ("text_emb", "audio_emb", "bert_proj_w", "bert_proj_b",
                            "text_pos_alpha", "audio_pos_alpha", "predict_w", "pe")}
    return {**top, "layers": layer}


def check_tp(cfg, mesh) -> None:
    """Raise unless the heads (and so D and M) split evenly over ``tp``."""
    _, tp, _ = axis(mesh, "tp")
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads={cfg.num_heads} does not divide over tp={tp}")


def shard_t2s_params(params, mesh) -> Dict:
    """The rank's t2s params: :func:`t2s_param_sharding`'s local tensors,
    and the tp group under ``"tp"``.  What an engine adds (its kernels'
    table, packed pages) is left out."""
    sh = t2s_param_sharding(mesh)
    out = {k: sh[k].local(params[k]) for k in sh if k != "layers"}
    out["layers"] = [{k: sh["layers"][k].local(lp[k]) for k in sh["layers"]}
                     for lp in params["layers"]]
    out["tp"] = axis(mesh, "tp")[0]
    return out


def gather_t2s_params(params, mesh) -> Dict:
    """Inverse of :func:`shard_t2s_params`: the full tensors on every rank
    (a collective: every rank of the mesh calls it); keys ``params`` lacks
    (``pe``) stay out."""
    sh = t2s_param_sharding(mesh)
    out = {k: sh[k].full(params[k]) for k in sh if k != "layers" and k in params}
    out["layers"] = [{k: sh["layers"][k].full(lp[k]) for k in sh["layers"]}
                     for lp in params["layers"]]
    return out


class Rows:
    """Batch placement: rank ``r`` of ``n`` holds rows ``[r·B/n, (r+1)·B/n)``
    of dim 0."""

    def __init__(self, n: int, rank: int):
        self.n, self.rank = n, rank

    def local(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[0] % self.n:
            raise ValueError(f"batch of {t.shape[0]} does not divide over dp={self.n}")
        return t.chunk(self.n, 0)[self.rank]

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return self.local(t)


def batch_sharding(mesh) -> Rows:
    """Inputs split over ``dp`` on the leading (batch) axis: a callable that
    takes the global tensor and returns the rank's rows."""
    return Rows(*axis(mesh, "dp")[1:])


def replicated(mesh) -> Replicated:
    """Every rank holds the whole tensor."""
    return Replicated()


def broadcast_seed(device=None) -> int:
    """A random 63-bit seed drawn on rank 0 and sent to every rank (for
    generators that must draw alike on every rank)."""
    seed = torch.randint(0, 2 ** 62, (1,), dtype=torch.int64)
    if dist.is_initialized() and dist.get_world_size() > 1:
        dev = device if device is not None and dist.get_backend() == "nccl" else "cpu"
        seed = seed.to(dev)
        dist.broadcast(seed, src=0)
    return int(seed.item())
