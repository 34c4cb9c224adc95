"""Stage-1 "GPT" text-to-semantic decoder (counterpart of
``gsv_tts_tpu/models/t2s.py``; reference ``GPT/t2s_model.py:13-206``).

A decoder-only post-norm transformer over a hybrid prompt: the phoneme block
attends bidirectionally to itself, the audio block causally to itself and
fully to the phonemes.  Parameters are a plain dict with one dict per layer;
matrices keep torch's ``[out, in]`` layout (the reference checkpoint's), so
loading is a key lookup and ``F.linear`` applies them.  LayerNorm affines,
the positional ``alpha`` scalars and the sine table stay float32, as in the
JAX package.

The KV cache is ``[L, B, S, H, Dh]``, the JAX layout.  The prefill's
attention is plain PyTorch or, under ``impl="flash"``, the hybrid-mask kernel
K4 (``ops/flash_prefill.py``).  The decode step here is the one the engine's
generic step calls, by implementation name as in the JAX package:
``"flash"`` (plain PyTorch products and LayerNorms around the decode
attention K3b, ``ops/flash_decode.py``), ``"fused_step"`` (K5, all layers in
one call at B=1, ``ops/fused_step.py:fused_decode_step``) and ``"fused"``
(K6, one call per layer, ``ops/fused_layer.py``) — each kernel on the card,
its twin on the CPU — and ``"xla"`` (the JAX package's path without a
kernel: plain PyTorch throughout, the attention
``ops/flash_decode.py:xla_decode_attention``).  The engine's default hot
paths for 1 and 2..8 slots are the whole-step kernels K1 and K2
(``ops/fused_step.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.flash_decode import flash_decode_attention_layered, xla_decode_attention
from ..ops.flash_prefill import flash_prefill_attention, hybrid_mask
from ..ops.fused_layer import fused_decode_layer
from ..ops.fused_step import fused_decode_step
from ..ops.norms import layer_norm
from ..parallel.mesh import copy_to_tp, gather_seq, reduce_from_tp

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class T2SConfig:
    """Hyperparameters, read from the checkpoint's embedded config."""

    hidden_dim: int = 512
    embedding_dim: int = 512
    num_heads: int = 16
    num_layers: int = 24
    vocab_size: int = 1025
    phoneme_vocab_size: int = 732
    eos: int = 1024
    bert_dim: int = 1024
    mlp_ratio: int = 4
    max_position: int = 4000
    suppressed_tokens: Tuple[int, ...] = (280, 486)

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @classmethod
    def from_checkpoint_config(cls, config: Dict[str, Any]) -> "T2SConfig":
        m = config["model"]
        return cls(hidden_dim=m["hidden_dim"], embedding_dim=m["embedding_dim"],
                   num_heads=m["head"], num_layers=m["n_layer"],
                   vocab_size=m["vocab_size"],
                   phoneme_vocab_size=m["phoneme_vocab_size"], eos=m["EOS"])

    def to_checkpoint_config(self) -> Dict[str, Any]:
        return {"model": {
            "hidden_dim": self.hidden_dim, "embedding_dim": self.embedding_dim,
            "head": self.num_heads, "n_layer": self.num_layers,
            "vocab_size": self.vocab_size,
            "phoneme_vocab_size": self.phoneme_vocab_size, "EOS": self.eos}}


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

#: per-layer (port name, state-dict suffix, stays float32)
LAYER_KEYS = (
    ("qkv_w", "qkv.weight", False), ("qkv_b", "qkv.bias", False),
    ("out_w", "out_proj.weight", False), ("out_b", "out_proj.bias", False),
    ("ln1_g", "norm1.weight", True), ("ln1_b", "norm1.bias", True),
    ("mlp1_w", "mlp.0.weight", False), ("mlp1_b", "mlp.0.bias", False),
    ("mlp2_w", "mlp.2.weight", False), ("mlp2_b", "mlp.2.bias", False),
    ("ln2_g", "norm2.weight", True), ("ln2_b", "norm2.bias", True),
)


def sine_pe_table(max_len: int, dim: int) -> np.ndarray:
    """Sinusoidal table in float32, exactly as ``embedding.py:52-69``."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32) * -(math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def params_from_torch_state_dict(state_dict: Dict[str, Any], cfg: T2SConfig,
                                 dtype=F32, device="cpu") -> Dict[str, Any]:
    """Runtime-keyed state dict (after ``loader.remap_gpt_state_dict``;
    torch tensors or numpy arrays) → port params on ``device``."""

    def get(name, f32=False):
        v = state_dict[name]
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
        return t.to(device=device, dtype=F32 if f32 else dtype).contiguous()

    pfx = "t2s_transformer.blocks.{}."
    return {
        "text_emb": get("ar_text_embedding.word_embeddings.weight"),
        "audio_emb": get("ar_audio_embedding.word_embeddings.weight"),
        "bert_proj_w": get("bert_proj.weight"),
        "bert_proj_b": get("bert_proj.bias"),
        "text_pos_alpha": get("ar_text_position.alpha", True).reshape(1),
        "audio_pos_alpha": get("ar_audio_position.alpha", True).reshape(1),
        "predict_w": get("ar_predict_layer.weight"),
        "layers": [{ours: get(pfx.format(i) + theirs, f32)
                    for ours, theirs, f32 in LAYER_KEYS}
                   for i in range(cfg.num_layers)],
        "pe": torch.as_tensor(sine_pe_table(cfg.max_position, cfg.embedding_dim),
                              device=device),
    }


def params_to_torch_state_dict(params: Dict[str, Any], cfg: T2SConfig) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`params_from_torch_state_dict`: float32 CPU tensors
    in the runtime key layout (``pe`` is derived, not stored)."""
    def c(t):
        return t.detach().to("cpu", F32).contiguous()

    sd = {
        "ar_text_embedding.word_embeddings.weight": c(params["text_emb"]),
        "ar_audio_embedding.word_embeddings.weight": c(params["audio_emb"]),
        "bert_proj.weight": c(params["bert_proj_w"]),
        "bert_proj.bias": c(params["bert_proj_b"]),
        "ar_text_position.alpha": c(params["text_pos_alpha"]).reshape(()),
        "ar_audio_position.alpha": c(params["audio_pos_alpha"]).reshape(()),
        "ar_predict_layer.weight": c(params["predict_w"]),
    }
    for i, lp in enumerate(params["layers"]):
        for ours, theirs, _ in LAYER_KEYS:
            sd[f"t2s_transformer.blocks.{i}.{theirs}"] = c(lp[ours])
    return sd


def init_params(cfg: T2SConfig, generator: torch.Generator, dtype=F32,
                device="cpu") -> Dict[str, Any]:
    """Random weights with the JAX ``init_params`` scales (normal / sqrt(fan
    in), zero biases, unit LayerNorm), drawn on the CPU from ``generator``."""
    D, E, M = cfg.hidden_dim, cfg.embedding_dim, cfg.hidden_dim * cfg.mlp_ratio

    def dense(fan_in, *shape):
        return torch.randn(shape, generator=generator) / math.sqrt(fan_in)

    sd = {
        "ar_text_embedding.word_embeddings.weight": dense(1, cfg.phoneme_vocab_size, E),
        "ar_audio_embedding.word_embeddings.weight": dense(1, cfg.vocab_size, E),
        "bert_proj.weight": dense(cfg.bert_dim, E, cfg.bert_dim),
        "bert_proj.bias": torch.zeros(E),
        "ar_text_position.alpha": torch.ones(()),
        "ar_audio_position.alpha": torch.ones(()),
        "ar_predict_layer.weight": dense(D, cfg.vocab_size, D),
    }
    shapes = {"qkv_w": (D, 3 * D, D), "out_w": (D, D, D), "mlp1_w": (D, M, D),
              "mlp2_w": (M, D, M)}
    for i in range(cfg.num_layers):
        for ours, theirs, _ in LAYER_KEYS:
            key = f"t2s_transformer.blocks.{i}.{theirs}"
            if ours in shapes:
                fan_in, *shape = shapes[ours]
                sd[key] = dense(fan_in, *shape)
            elif ours.startswith("ln") and ours.endswith("_g"):
                sd[key] = torch.ones(D)
            else:
                n = {"qkv_b": 3 * D, "mlp1_b": M}.get(ours, D)
                sd[key] = torch.zeros(n)
    return params_from_torch_state_dict(sd, cfg, dtype, device)


# ---------------------------------------------------------------------------
# Core math
# ---------------------------------------------------------------------------

def _col_in(x, tp):
    """The input of a column-parallel product (qkv, mlp1): its gradient is
    summed over the tp ranks that each hold some of the columns."""
    return x if tp is None else copy_to_tp(x, tp)


def _row_linear(x, w, b, tp):
    """A row-parallel product (out, mlp2): each tp rank's partial sum,
    all-reduced, the bias added once.  A group of one rank is the product
    without tp."""
    if tp is None or dist.get_world_size(tp) == 1:
        return F.linear(x, w, b)
    return reduce_from_tp(F.linear(x, w), tp) + b


def _split_qkv(qkv, Dh):
    """q, k, v [..., Hl, Dh] of a (possibly tp-local) fused product whose
    last dim is ``3 * Hl * Dh``."""
    Hl = qkv.shape[-1] // (3 * Dh)
    q, k, v = qkv.split(Hl * Dh, dim=-1)
    shape = qkv.shape[:-1] + (Hl, Dh)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _block_prefill(x, lp, attn_mask, num_heads, lens=None, impl="plain", tp=None, seq=None):
    """One post-norm block over the whole prompt.  x [B, T, D]; attn_mask
    [B, T, T] bool.  Returns (hidden, k, v) with k/v [B, T, H, Dh].

    ``impl="flash"`` takes the hybrid-mask kernel K4
    (``ops/flash_prefill.py``), which derives the same mask from
    ``lens=(x_lens, xy_lens)`` ([B] int32): ``attn_mask`` is ignored there
    and may be None.

    ``tp`` (a process group): ``lp`` holds this rank's heads
    (``parallel/mesh.py``), and k/v are its ``H/tp`` heads.  ``seq`` (a
    process group): ``x`` is this rank's slice of the time axis and
    ``attn_mask`` its rows; k/v are gathered over the group for the
    attention (and returned for the local rows)."""
    B, T, D = x.shape
    Dh = D // num_heads
    residual = x
    q, k, v = _split_qkv(F.linear(_col_in(x, tp), lp["qkv_w"], lp["qkv_b"]), Dh)
    H = q.shape[2]
    if impl == "flash":
        attn = flash_prefill_attention(q, k, v, lens[0], lens[1], num_heads=H)
    else:
        kf, vf = (k, v) if seq is None else (gather_seq(k, seq), gather_seq(v, seq))
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) / math.sqrt(Dh)
        scores = scores.masked_fill(~attn_mask[:, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        attn = torch.einsum("bhqk,bkhd->bqhd", probs, vf).reshape(B, T, H * Dh)
    x = residual + _row_linear(attn, lp["out_w"], lp["out_b"], tp)
    x = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    residual = x
    h = F.relu(F.linear(_col_in(x, tp), lp["mlp1_w"], lp["mlp1_b"]))
    x = residual + _row_linear(h, lp["mlp2_w"], lp["mlp2_b"], tp)
    x = layer_norm(x, lp["ln2_g"], lp["ln2_b"])
    return x, k, v


def transformer_prefill(params, cfg: T2SConfig, xy_pos: torch.Tensor,
                        attn_mask: Optional[torch.Tensor], lens=None, impl: str = "plain",
                        seq=None):
    """All layers over the packed prompt; returns final hidden states and
    stacked K/V ``[L, B, T, H, Dh]``.  ``impl``: ``"plain"`` (masked softmax
    attention in PyTorch, needs ``attn_mask``) or ``"flash"`` (K4, needs
    ``lens=(x_lens, xy_lens)``).  Params sharded by head carry their tp group
    under ``"tp"`` (``parallel/mesh.py:shard_t2s_params``); ``seq``: the
    group ``xy_pos``'s time axis is split over (``_block_prefill``)."""
    if impl not in ("plain", "flash"):
        raise ValueError(f"prefill impl {impl!r}: expected 'plain' or 'flash'")
    if impl == "flash":
        if lens is None:
            raise ValueError("impl='flash' needs lens=(x_lens, xy_lens)")
        lens = tuple(t.to(torch.int32) for t in lens)
    elif attn_mask is None:
        raise ValueError("the plain prefill needs attn_mask")
    x = xy_pos
    ks, vs = [], []
    for lp in params["layers"]:
        x, k, v = _block_prefill(x, lp, attn_mask, cfg.num_heads, lens, impl,
                                 params.get("tp"), seq)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def _block_decode(x, lp, layer_idx, k_cache, v_cache, kv_len, bidx, rows, num_heads,
                  attn_impl="flash", tp=None):
    """One token per slot through one block.  x [B, D]; caches
    [L, B, S, H, Dh] are updated IN PLACE at row ``rows[b]`` (= ``kv_len[b]``
    as int64; ``bidx`` = arange(B)) of layer ``layer_idx``.  Each slot
    attends its rows ``s <= kv_len[b]`` through
    ``flash_decode_attention_layered`` (K3b), or under ``"xla"`` through
    ``xla_decode_attention``.  ``tp``: as in :func:`_block_prefill` (the
    caches hold this rank's heads)."""
    B, D = x.shape
    Dh = D // num_heads
    residual = x
    q, k, v = _split_qkv(F.linear(_col_in(x, tp), lp["qkv_w"], lp["qkv_b"]), Dh)
    H = q.shape[1]
    k_cache[layer_idx, bidx, rows] = k.to(k_cache.dtype)
    v_cache[layer_idx, bidx, rows] = v.to(v_cache.dtype)
    if attn_impl == "xla":
        attn = xla_decode_attention(q, k_cache[layer_idx], v_cache[layer_idx],
                                    kv_len).reshape(B, H * Dh)
    else:
        attn = flash_decode_attention_layered(q.contiguous(), k_cache,
                                              v_cache, kv_len, layer_idx).reshape(B, H * Dh)
    x = residual + _row_linear(attn, lp["out_w"], lp["out_b"], tp)
    x = layer_norm(x, lp["ln1_g"], lp["ln1_b"])
    residual = x
    h = F.relu(F.linear(_col_in(x, tp), lp["mlp1_w"], lp["mlp1_b"]))
    x = residual + _row_linear(h, lp["mlp2_w"], lp["mlp2_b"], tp)
    return layer_norm(x, lp["ln2_g"], lp["ln2_b"])


#: implementation names of :func:`transformer_decode_step` and of the engine
ATTN_IMPLS = ("fused_step", "flash", "fused", "xla")


def transformer_decode_step(params, cfg: T2SConfig, x, k_cache, v_cache, kv_len,
                            attn_impl: str = "flash"):
    """One token per slot through all layers.  ``kv_len`` [B] int32: valid
    entries before this token.  Caches are updated in place and returned for
    symmetry with the JAX signature.  ``attn_impl`` as in the JAX package:

    * ``"flash"``: PyTorch products and LayerNorms around the decode
      attention K3b (``flash_decode_attention_layered``);
    * ``"fused_step"``: K5, all layers in one call, at B=1; a larger wave
      degrades to ``"flash"``;
    * ``"fused"``: K6, one call per layer;
    * ``"xla"``: plain PyTorch throughout, ``xla_decode_attention`` as the
      attention (no kernel)."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {attn_impl!r}: expected one of {ATTN_IMPLS}")
    table = params.get("k1_table")  # the owner's pointer table (CUDA parameters)
    if attn_impl == "fused_step" and x.shape[0] == 1:
        return fused_decode_step(x, params["layers"], k_cache, v_cache, kv_len, table=table)
    if attn_impl == "fused":
        for i, lp in enumerate(params["layers"]):
            x, _, _ = fused_decode_layer(x, lp, k_cache, v_cache, kv_len, i, table=table)
        return x, k_cache, v_cache
    bidx = torch.arange(x.shape[0], device=x.device)
    rows = kv_len.long()
    for i, lp in enumerate(params["layers"]):
        x = _block_decode(x, lp, i, k_cache, v_cache, kv_len, bidx, rows, cfg.num_heads,
                          "xla" if attn_impl == "xla" else "flash", params.get("tp"))
    return x, k_cache, v_cache


# ---------------------------------------------------------------------------
# Prompt building (reference ``t2s_model.py:300-383``)
# ---------------------------------------------------------------------------

def embed_prompt_single(params, cfg: T2SConfig, x_ids, y_ids, bert, dtype):
    """B=1 prompt [x text block | y audio block] and its [1, T, T] mask."""
    Lx = x_ids.shape[1]
    Ly = y_ids.shape[1]
    x = params["text_emb"][x_ids].to(dtype)
    x = x + F.linear(bert.to(dtype), params["bert_proj_w"], params["bert_proj_b"])
    x = x + (params["text_pos_alpha"] * params["pe"][:Lx]).to(dtype)
    y = params["audio_emb"][y_ids].to(dtype)
    y = y + (params["audio_pos_alpha"] * params["pe"][:Ly]).to(dtype)
    xy_pos = torch.cat([x, y], dim=1)
    T = Lx + Ly
    rows = torch.arange(T, device=x.device)[:, None]
    cols = torch.arange(T, device=x.device)[None, :]
    in_x_col = cols < Lx
    mask = torch.where(rows < Lx, in_x_col, in_x_col | (cols <= rows))
    return xy_pos, mask[None]


def embed_prompt_batch(params, cfg: T2SConfig, x_ids, y_ids, bert, x_lens, y_lens, dtype,
                       with_mask: bool = True):
    """Ragged batch packing: row b is [x_b | y_b | padding] with the
    hybrid mask ``(r < xl ? c < xl : c <= r) & c < xyl`` (None when
    ``with_mask`` is false: a prefill that derives it from the lengths
    needs no [B, T, T] tensor) and a one-hot last-token mask."""
    B, Lx = x_ids.shape
    Ly = y_ids.shape[1]
    T = Lx + Ly
    dev = x_ids.device
    # F.embedding rather than indexing: its backward sums repeated ids (the padding's)
    # in a fixed order, where indexing's accumulates with atomics (training, bit-exact resume)
    x = F.embedding(x_ids.long(), params["text_emb"]).to(dtype)
    x = x + F.linear(bert.to(dtype), params["bert_proj_w"], params["bert_proj_b"])
    x = x + (params["text_pos_alpha"] * params["pe"][:Lx]).to(dtype)
    y = F.embedding(y_ids.long(), params["audio_emb"]).to(dtype)
    y = y + (params["audio_pos_alpha"] * params["pe"][:Ly]).to(dtype)

    xy_lens = x_lens + y_lens
    pos = torch.arange(T, device=dev)[None, :]
    is_x = pos < x_lens[:, None]
    y_index = (pos - x_lens[:, None]).clamp(0, Ly - 1)
    x_index = pos.clamp(0, Lx - 1).expand(B, T)
    gx = torch.gather(x, 1, x_index[:, :, None].expand(B, T, x.shape[-1]))
    gy = torch.gather(y, 1, y_index[:, :, None].expand(B, T, y.shape[-1]))
    xy_pos = torch.where(is_x[:, :, None], gx, gy)
    xy_pos = torch.where((pos < xy_lens[:, None])[:, :, None], xy_pos,
                         torch.zeros((), dtype=dtype, device=dev))

    mask = hybrid_mask(T, x_lens, xy_lens) if with_mask else None
    last_token_mask = pos == (xy_lens[:, None] - 1)
    return xy_pos, mask, last_token_mask
