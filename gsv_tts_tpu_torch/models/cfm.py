"""GPT-SoVITS v4's conditional flow-matching decoder: the DiT and its Euler
loop (reference ``GPT_SoVITS/module/models.py:CFM`` and
``GPT_SoVITS/f5_tts/model/backbones/dit.py``, ``f5_tts/model/modules.py``).

The DiT maps a noisy mel ``x``, the prompt mel ``cond`` (zero past the
prompt) and the text features ``fea`` (``sovits_v4.decode_encp``, 100 Hz) to
a velocity: a timestep embedding (sinusoid → MLP, of ``t`` plus that of the
step size ``d``), the text embedding (``fea`` + a [cos | sin] position table,
then ConvNeXt-V2 blocks), the input embedding (one linear of the three, then a
grouped-conv position embedding), ``depth`` AdaLN-zero blocks of rotary
self-attention and a tanh-GELU feed-forward, and a final AdaLN and linear.
The rotary is applied to q and k before the head split with ``dim_head``
channels, so only the first head rotates (x_transformers' partial rotary on
the full width).  Masks are all ones at exact shapes and are left out.

:func:`cfm_chunk` is the Euler loop over one chunk with the noise given by
the caller (never drawn here), each step one call of :func:`euler_step`,
whose inputs are all tensors, through a runner the caller gives (the facade
replays one CUDA graph of the step per chunk length, ``tts.SovitsGraphs``).
What does not depend on ``x`` is computed once: every step's modulations
for the model (:func:`modulations`, in :func:`prepare_params`: the timestep
embeddings and all blocks' AdaLN linears in one batch), and once a chunk
the text embedding and the input projection of the prompt mel and text
(:func:`conditioning`).  The DiT runs in the parameters' dtype (bf16 on the
card: cuBLAS GEMMs and PyTorch's flash attention), each block in few launches (AdaLN as ``layer_norm``'s affine,
gated residuals as ``addcmul``, the rotary of q and k in place, the grouped
convs as one batched GEMM each); ``x`` accumulates in float32.
Parameters are a flat dict under ``cfm.estimator.``, the reference
state-dict names.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.convs import conv1d, linear

PFX = "cfm.estimator."


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """``DiT(dim=1024, depth=22, heads=16, ff_mult=2, text_dim=512,
    conv_layers=4)`` of ``SynthesizerTrnV3`` (``dim_head`` 64, ``mel_dim``
    100, ``freq_embed_dim`` 256: the class defaults)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 100
    text_dim: int = 512
    conv_layers: int = 4
    conv_mult: int = 2
    freq_embed_dim: int = 256
    conv_pos_kernel: int = 31
    conv_pos_groups: int = 16

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "DiTConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in (d or {}).items() if k in names})


def sinus_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """``SinusPositionEmbedding``: t [B] → [B, dim] float32, sines then cosines."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                     * -(math.log(10000) / (half - 1)))
    arg = scale * t.float()[:, None] * freq[None, :]
    return torch.cat([arg.sin(), arg.cos()], dim=-1)


def timestep_embedding(p, name: str, t: torch.Tensor, cfg: DiTConfig, dtype) -> torch.Tensor:
    """``TimestepEmbedding``: sinusoid → Linear → SiLU → Linear, [B, dim]."""
    h = sinus_embedding(t, cfg.freq_embed_dim).to(dtype)
    h = F.silu(linear(h, p[f"{PFX}{name}.time_mlp.0.weight"], p[f"{PFX}{name}.time_mlp.0.bias"]))
    return linear(h, p[f"{PFX}{name}.time_mlp.2.weight"], p[f"{PFX}{name}.time_mlp.2.bias"])


def text_positions(n: int, dim: int, device) -> torch.Tensor:
    """``precompute_freqs_cis(dim, n)``: [n, dim] float32, cosines then sines."""
    freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device,
                                            dtype=torch.float32)[: dim // 2] / dim))
    ang = torch.outer(torch.arange(n, device=device, dtype=torch.float32), freqs)
    return torch.cat([ang.cos(), ang.sin()], dim=-1)


def text_embedding(p, cfg: DiTConfig, fea: torch.Tensor) -> torch.Tensor:
    """``TextEmbedding`` with ``conv_layers`` ConvNeXt-V2 blocks: fea [B, T,
    text_dim] → [B, T, text_dim]."""
    x = fea + text_positions(fea.shape[1], cfg.text_dim, fea.device).to(fea.dtype)[None]
    for i in range(cfg.conv_layers):
        q = f"{PFX}text_embed.text_blocks.{i}."
        h = conv1d(x.transpose(1, 2), p[q + "dwconv.weight"], p[q + "dwconv.bias"],
                   padding=3, groups=cfg.text_dim).transpose(1, 2)
        h = F.layer_norm(h, h.shape[-1:], p[q + "norm.weight"].to(h.dtype),
                         p[q + "norm.bias"].to(h.dtype), 1e-6)
        h = F.gelu(linear(h, p[q + "pwconv1.weight"], p[q + "pwconv1.bias"]))
        gx = torch.linalg.vector_norm(h.float(), dim=1, keepdim=True)  # over time
        nx = (gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)).to(h.dtype)
        h = p[q + "grn.gamma"].to(h.dtype) * (h * nx) + p[q + "grn.beta"].to(h.dtype) + h
        x = x + linear(h, p[q + "pwconv2.weight"], p[q + "pwconv2.bias"])
    return x


def rotary_tables(n: int, dim_head: int, device):
    """x_transformers' ``RotaryEmbedding(dim_head)`` for :func:`rotate_qk`:
    cos and signed sin [n, dim_head] float32 (every frequency repeated for
    its pair, the sin negative on the pair's first channel) and the pair
    swap (2i ↔ 2i + 1), so that the rotation is ``x·cos + x[swap]·sin``."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim_head, 2, device=device,
                                          dtype=torch.float32) / dim_head))
    ang = torch.repeat_interleave(
        torch.outer(torch.arange(n, device=device, dtype=torch.float32), inv), 2, dim=-1)
    # made on the card: a copy from the host would wait for the work queued before it
    sign = (torch.arange(dim_head, device=device) % 2).float() * 2 - 1
    swap = torch.arange(dim_head, device=device).view(-1, 2).flip(-1).reshape(-1)
    return ang.cos(), ang.sin() * sign, swap


def rotate_qk(qkv: torch.Tensor, inner: int, cos, sin, swap):
    """``apply_rotary_pos_emb`` on q and k before the head split, in place on
    the block's q/k/v product [B, T, 3·inner]: the first ``dim_head``
    channels of q and of k (head 0) rotate in interleaved pairs, in float32
    as x_transformers rotates (autocast off), the rest pass."""
    B, T, _ = qkv.shape
    r = cos.shape[-1]
    head = qkv.view(B, T, 3, inner)[:, :, :2, :r]
    x = head.float()
    head.copy_(torch.addcmul(x * cos[:, None], x.index_select(-1, swap), sin[:, None]))


def modulations(p, cfg: DiTConfig, steps: int):
    """Every step's modulations, which read only ``t = j / steps``, ``d = 1 /
    steps`` and the parameters: the timestep embedding of each ``t`` plus
    that of ``d`` (the same at every step, as ``use_conditioner_cache``
    reuses it), then all blocks' AdaLN linears on it in one product
    (``adaln``).  Returns ``mods`` [steps, depth, 6, dim], (shift, 1 + scale,
    gate) of the attention then of the feed-forward, and ``final`` [steps, 2,
    dim], (1 + scale, shift), in the parameters' dtype."""
    w = p[PFX + "adaln.weight"]
    dt, dev, D = w.dtype, w.device, cfg.dim
    t = torch.arange(steps, device=dev, dtype=torch.float32) / steps
    d = torch.full((1,), 1.0 / steps, device=dev, dtype=torch.float32)
    act = F.silu(timestep_embedding(p, "time_embed", t, cfg, dt)
                 + timestep_embedding(p, "d_embed", d, cfg, dt))
    mods = linear(act, w, p[PFX + "adaln.bias"]).reshape(steps, cfg.depth, 6, D)
    mods[:, :, (1, 4)] += 1
    final = linear(act, p[PFX + "norm_out.linear.weight"],
                   p[PFX + "norm_out.linear.bias"]).reshape(steps, 2, D)
    final[:, 0] += 1
    return mods, final


def conditioning(p, cfg: DiTConfig, fea: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
    """What a chunk's steps share: fea [1, T, text_dim] in the model's dtype
    and cond [1, T, mel_dim] (the prompt mel, zero after it) → ``base`` [T,
    dim], the text embedding and ``cond`` through the part of
    ``input_embed.proj`` that does not read ``x``, with its bias."""
    text = text_embedding(p, cfg, fea)
    w = p[PFX + "input_embed.proj.weight"]
    return linear(torch.cat([cond.to(fea.dtype), text], dim=-1), w[:, cfg.mel_dim:],
                  p[PFX + "input_embed.proj.bias"])[0]


def _modulate(x, shift, scale1):
    """LayerNorm (no affine, eps 1e-6) · (1 + scale) + shift, as one
    ``layer_norm`` whose weight is ``1 + scale``."""
    return F.layer_norm(x, x.shape[-1:], scale1, shift, 1e-6)


def dit_block(p, cfg: DiTConfig, i: int, h, mod, rope):
    """One ``DiTBlock``: h [1, T, dim]; ``mod`` [6, dim] = (shift, 1 + scale,
    gate) of the attention, then of the feed-forward."""
    mod = mod.unbind(0)
    q = f"{PFX}transformer_blocks.{i}."
    B, T, _ = h.shape
    inner = cfg.heads * cfg.dim_head
    qkv = F.linear(_modulate(h, mod[0], mod[1]), p[q + "attn.qkv.weight"],
                   p[q + "attn.qkv.bias"])
    rotate_qk(qkv, inner, *rope)
    qh, kh, vh = (t.view(B, T, cfg.heads, cfg.dim_head).transpose(1, 2)
                  for t in qkv.split(inner, dim=-1))
    a = F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2).reshape(B, T, inner)
    h = torch.addcmul(h, mod[2], F.linear(a, p[q + "attn.to_out.0.weight"],
                                          p[q + "attn.to_out.0.bias"]))
    x = F.gelu(F.linear(_modulate(h, mod[3], mod[4]), p[q + "ff.ff.0.0.weight"],
                        p[q + "ff.ff.0.0.bias"]), approximate="tanh")
    return torch.addcmul(h, mod[5], F.linear(x, p[q + "ff.ff.2.weight"], p[q + "ff.ff.2.bias"]))


def grouped_conv(x, w, b, groups: int, kernel: int):
    """``Conv1d(groups=groups, padding=kernel // 2)`` of time-major x [T, D]
    as one batched GEMM over the groups: the padded input unfolded into
    [groups, T, D / groups · kernel] columns, times ``w`` [groups, D / groups
    · kernel, D / groups], plus ``b`` [groups, 1, D / groups]
    (:func:`prepare_params`).  Returns [T, D]."""
    T, D = x.shape
    cols = F.pad(x, (0, 0, kernel // 2, kernel // 2)).unfold(0, kernel, 1)  # [T, D, K] view
    cols = cols.reshape(T, groups, (D // groups) * kernel).transpose(0, 1)
    return torch.baddbmm(b, cols, w).transpose(0, 1).reshape(T, D)


def dit_forward(p, cfg: DiTConfig, x, base, rope, mod, fin):
    """The velocity [1, T, mel_dim] (float32): x [1, T, mel_dim], its input
    projection added to the chunk's ``base`` [T, dim] (:func:`conditioning`;
    the DiT runs in its dtype); ``rope`` :func:`rotary_tables`' three;
    ``mod`` [depth, 6, dim] and ``fin`` [2, dim] the step's modulations."""
    w = p[PFX + "input_embed.proj.weight"]
    h = torch.addmm(base, x[0].to(base.dtype), w[:, :cfg.mel_dim].t())
    g = h
    for j in (0, 2):
        q = f"{PFX}input_embed.conv_pos_embed.conv1d.{j}."
        g = F.mish(grouped_conv(g, p[q + "weight_g"], p[q + "bias_g"], cfg.conv_pos_groups,
                                cfg.conv_pos_kernel))
    h = (h + g)[None]
    for i in range(cfg.depth):
        h = dit_block(p, cfg, i, h, mod[i], rope)
    scale1, shift = fin.unbind(0)  # AdaLayerNormZero_Final: scale first, then shift
    return F.linear(_modulate(h, shift, scale1), p[PFX + "proj_out.weight"],
                    p[PFX + "proj_out.bias"]).float()


def attention_backends():
    """PyTorch's own flash kernel for the DiT's attention: cuDNN's, the
    default on the H100, costs far more host time a call, and a step makes
    ``depth`` of them (the CPU takes the math path)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    return sdpa_kernel([SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.MATH])


def euler_step(p, cfg: DiTConfig, x, keep, base, mod, fin, cos, sin, swap):
    """One Euler step: x [1, T, mel_dim] float32 → (x + DiT(x) / steps) ·
    ``keep`` ([1, T, 1]: zero over the prompt's frames, one after), ``steps``
    the length of :func:`prepare_params`' ``mods``.  Every input is a tensor,
    so one CUDA graph of the step serves every chunk of T frames."""
    v = dit_forward(p, cfg, x, base, (cos, sin, swap), mod, fin)
    return (x + v * (1.0 / p[PFX + "mods"].shape[0])) * keep


def _call(fn, *inputs) -> tuple:
    return (fn(*inputs),)


def cfm_chunk(p, cfg: DiTConfig, fea, prompt, noise, run=_call):
    """``CFM.inference`` over one chunk, no CFG, temperature 1: fea [1,
    text_dim, T], prompt [1, mel_dim, P] (normalised), noise [1, mel_dim, T]
    (standard normal, the caller's draw; never drawn here) → the mel [1,
    mel_dim, T] float32, zero over the prompt's frames.  ``x`` starts as the
    noise with the prompt's frames zero; step j is ``run(euler_step, x, ...,
    mods[j], final[j], ...)`` over :func:`prepare_params`' tables (the
    facade's ``run`` replays a CUDA graph of the step per chunk length)."""
    T, P = fea.shape[-1], prompt.shape[-1]
    keep = (torch.arange(T, device=fea.device) >= P).float()[None, :, None]
    x = noise.float().transpose(1, 2) * keep
    cond = torch.zeros_like(x)
    cond[:, :P] = prompt.float().transpose(1, 2)
    base = conditioning(p, cfg, fea.transpose(1, 2).to(p[PFX + "mods"].dtype), cond)
    rope = rotary_tables(T, cfg.dim_head, fea.device)
    step = functools.partial(euler_step, p, cfg)
    with attention_backends():
        for mod, fin in zip(p[PFX + "mods"], p[PFX + "final"]):
            x, = run(step, x, keep, base, mod, fin, *rope)
    return x.transpose(1, 2)


def prepare_params(p: Dict[str, torch.Tensor], cfg: DiTConfig,
                   steps: int) -> Dict[str, torch.Tensor]:
    """Loaded DiT parameters as :func:`cfm_chunk` takes them: each block's
    ``to_q``, ``to_k``, ``to_v`` stacked into one ``attn.qkv`` (one GEMM a
    block), every block's AdaLN linear into one ``adaln``, the position
    embedding's grouped convs as :func:`grouped_conv`'s ``weight_g`` and
    ``bias_g``, and the :func:`modulations` of ``steps`` Euler steps as
    ``mods`` and ``final``, once for the model.  The other entries pass as
    they are."""
    out = dict(p)
    G, K = cfg.conv_pos_groups, cfg.conv_pos_kernel
    C = cfg.dim // G
    for j in (0, 2):
        q = f"{PFX}input_embed.conv_pos_embed.conv1d.{j}."
        out[q + "weight_g"] = out.pop(q + "weight").reshape(G, C, C * K).transpose(1, 2) \
            .contiguous()
        out[q + "bias_g"] = out.pop(q + "bias").reshape(G, 1, C).contiguous()
    for i in range(cfg.depth):
        q = f"{PFX}transformer_blocks.{i}.attn."
        for kind in ("weight", "bias"):
            out[q + "qkv." + kind] = torch.cat(
                [out.pop(q + f"to_{n}.{kind}") for n in ("q", "k", "v")]).contiguous()
    for kind in ("weight", "bias"):
        out[PFX + "adaln." + kind] = torch.cat(
            [out.pop(f"{PFX}transformer_blocks.{i}.attn_norm.linear.{kind}")
             for i in range(cfg.depth)]).contiguous()
    out[PFX + "mods"], out[PFX + "final"] = modulations(out, cfg, steps)
    return out


def init_params(cfg: DiTConfig, generator: torch.Generator, zero_init_scale: float = 1.0,
                grn_scale: float = 0.1) -> Dict[str, torch.Tensor]:
    """Random DiT parameters under the reference names (``to_q`` / ``to_k`` /
    ``to_v`` apart, as checkpoints keep them), float32 on the CPU.  Weights
    are N(0, 1/fan_in) and biases zero, so each linear keeps unit scale.
    What training initialises to zero (every AdaLN linear, ``proj_out``,
    GRN's gamma and beta) is drawn too, or the DiT would compute nothing:
    the AdaLN linears at ``zero_init_scale`` / sqrt(fan_in), GRN at N(0,
    ``grn_scale``), ``proj_out`` at unit scale like the rest."""
    p: Dict[str, torch.Tensor] = {}
    D, Dt = cfg.dim, cfg.text_dim

    def lin(name, out_c, in_c, gain=1.0):
        p[PFX + name + ".weight"] = torch.randn((out_c, in_c), generator=generator) \
            * (gain / math.sqrt(in_c))
        p[PFX + name + ".bias"] = torch.zeros(out_c)

    def conv(name, out_c, in_per_group, k):
        p[PFX + name + ".weight"] = torch.randn((out_c, in_per_group, k), generator=generator) \
            / math.sqrt(in_per_group * k)
        p[PFX + name + ".bias"] = torch.zeros(out_c)

    for name in ("time_embed", "d_embed"):
        lin(f"{name}.time_mlp.0", D, cfg.freq_embed_dim)
        lin(f"{name}.time_mlp.2", D, D)
    inner = Dt * cfg.conv_mult
    for i in range(cfg.conv_layers):
        q = f"text_embed.text_blocks.{i}."
        conv(q + "dwconv", Dt, 1, 7)
        p[PFX + q + "norm.weight"] = torch.ones(Dt)
        p[PFX + q + "norm.bias"] = torch.zeros(Dt)
        lin(q + "pwconv1", inner, Dt)
        for g in ("gamma", "beta"):
            p[PFX + q + "grn." + g] = torch.randn((1, 1, inner), generator=generator) * grn_scale
        lin(q + "pwconv2", Dt, inner)
    lin("input_embed.proj", D, 2 * cfg.mel_dim + Dt)
    for j in (0, 2):
        conv(f"input_embed.conv_pos_embed.conv1d.{j}", D, D // cfg.conv_pos_groups,
             cfg.conv_pos_kernel)
    inner_h = cfg.heads * cfg.dim_head
    for i in range(cfg.depth):
        q = f"transformer_blocks.{i}."
        lin(q + "attn_norm.linear", 6 * D, D, zero_init_scale)
        for n in ("to_q", "to_k", "to_v"):
            lin(q + "attn." + n, inner_h, D)
        lin(q + "attn.to_out.0", D, inner_h)
        lin(q + "ff.ff.0.0", D * cfg.ff_mult, D)
        lin(q + "ff.ff.2", D, D * cfg.ff_mult)
    lin("norm_out.linear", 2 * D, D, zero_init_scale)
    lin("proj_out", cfg.mel_dim, D)
    return p
