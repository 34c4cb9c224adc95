"""Stage-2 SoVITS inference, v2 / v2Pro / v2ProPlus (counterpart of
``gsv_tts_tpu/models/sovits.py``; reference ``SoVITS/models.py:235-434`` and
``module/``).

Semantic tokens → waveform: RVQ codebook decode, the VITS relative-position
encoders, MRTE cross-attention (returning its attention matrix), the
reversed residual-coupling flow and the HiFi-GAN generator, all
channels-first ``[B, C, T]``.  v2Pro adds the speaker-verification term to
``ge`` (``sv_emb`` linear, PReLU) and feeds MRTE ``ge_to512(ge)``; the flow
and HiFi-GAN take ``ge`` as it is.  Parameters are a flat dict keyed by the
reference state-dict names with weight norm folded at load.  The JAX
package computes all of this in XLA (no Pallas), so the port is plain
PyTorch.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.convs import (conv1d, conv_transpose1d, fold_weight_norm, interpolate_linear,
                         interpolate_nearest, interpolate_nearest_2x, leaky_relu, linear, mish,
                         prelu)
from .sv import EMBED_DIM as SV_EMBED_DIM

F32 = torch.float32
LRELU_SLOPE = 0.1
V2PRO_SET = ("v2Pro", "v2ProPlus")
#: codes and phones are right-padded to a multiple of this for the padded core
STREAM_PAD_MULTIPLE = 32


@dataclasses.dataclass(frozen=True)
class SovitsConfig:
    """From the checkpoint's ``hps`` (reference ``models.py:237-282``)."""

    spec_channels: int = 1025
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Tuple[int, ...] = (10, 8, 2, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 8, 2, 2)
    gin_channels: int = 512
    ssl_dim: int = 768
    n_symbols: int = 732
    quantizer_bins: int = 1024
    quantizer_n_q: int = 1
    version: str = "v2"
    window_size: int = 4
    flow_n_flows: int = 4
    flow_kernel_size: int = 5
    flow_n_layers: int = 4
    ref_enc_in: int = 704
    ref_enc_hidden: int = 128
    ref_enc_heads: int = 2
    ref_enc_kernel: int = 5

    @property
    def is_v2pro(self) -> bool:
        return self.version in V2PRO_SET

    @property
    def is_v4(self) -> bool:
        """GPT-SoVITS v4: MRTE features → ``bridge`` → ``wns1`` → the
        flow-matching DiT and a 48 kHz vocoder (``models/sovits_v4.py``)."""
        return self.version == "v4"

    @property
    def samples_per_frame(self) -> int:
        return int(np.prod(self.upsample_rates))

    @classmethod
    def from_hps(cls, hps_model: Dict[str, Any], spec_channels: int,
                 n_symbols: int = 732) -> "SovitsConfig":
        m = dict(hps_model)
        return cls(
            spec_channels=spec_channels,
            inter_channels=m["inter_channels"], hidden_channels=m["hidden_channels"],
            filter_channels=m["filter_channels"], n_heads=m["n_heads"],
            n_layers=m["n_layers"], kernel_size=m["kernel_size"],
            p_dropout=m["p_dropout"],
            resblock_kernel_sizes=tuple(m["resblock_kernel_sizes"]),
            resblock_dilation_sizes=tuple(tuple(v) for v in m["resblock_dilation_sizes"]),
            upsample_rates=tuple(m["upsample_rates"]),
            upsample_initial_channel=m["upsample_initial_channel"],
            upsample_kernel_sizes=tuple(m["upsample_kernel_sizes"]),
            gin_channels=m["gin_channels"], n_symbols=n_symbols,
            version=m.get("version", "v2"))


# ---------------------------------------------------------------------------
# Basic blocks
# ---------------------------------------------------------------------------

def channel_layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the channel dim of [B, C, T], float32 statistics."""
    x32 = x.float()
    mean = x32.mean(1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    out = out * gamma.float()[None, :, None] + beta.float()[None, :, None]
    return out.to(x.dtype)


def _get_relative_embeddings(rel_emb, length: int, window_size: int):
    pad_length = max(length - (window_size + 1), 0)
    slice_start = max((window_size + 1) - length, 0)
    if pad_length > 0:
        rel_emb = F.pad(rel_emb, (0, 0, pad_length, pad_length))
    return rel_emb[:, slice_start: slice_start + 2 * length - 1]


def _relative_to_absolute(x):
    """[b, h, l, 2l-1] → [b, h, l, l]."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1))
    x_flat = F.pad(x.reshape(b, h, l * 2 * l), (0, l - 1))
    return x_flat.reshape(b, h, l + 1, 2 * l - 1)[:, :, :l, l - 1:]


def _absolute_to_relative(x):
    """[b, h, l, l] → [b, h, l, 2l-1]."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1))
    x_flat = F.pad(x.reshape(b, h, l * l + l * (l - 1)), (l, 0))
    return x_flat.reshape(b, h, l, 2 * l)[:, :, :, 1:]


def vits_attention(p, pfx: str, x, c, n_heads: int, attn_mask=None,
                   window_size: Optional[int] = None):
    """``attentions.MultiHeadAttention``; x, c [B, C, T].  Returns
    (out [B, C, T], attn probs [B, H, T_q, T_k] float32)."""
    q = conv1d(x, p[pfx + "conv_q.weight"], p[pfx + "conv_q.bias"])
    k = conv1d(c, p[pfx + "conv_k.weight"], p[pfx + "conv_k.bias"])
    v = conv1d(c, p[pfx + "conv_v.weight"], p[pfx + "conv_v.bias"])
    b, d, t_s = k.shape
    t_t = q.shape[2]
    k_ch = d // n_heads
    qh = q.reshape(b, n_heads, k_ch, t_t).transpose(2, 3)
    kh = k.reshape(b, n_heads, k_ch, t_s).transpose(2, 3)
    vh = v.reshape(b, n_heads, k_ch, t_s).transpose(2, 3)
    scale = 1.0 / math.sqrt(k_ch)
    qs = qh * scale
    scores = torch.matmul(qs.float(), kh.float().transpose(2, 3))
    if window_size is not None:
        rel_k = _get_relative_embeddings(p[pfx + "emb_rel_k"].float(), t_s, window_size)
        rel_logits = torch.matmul(qs.float(), rel_k[0].transpose(0, 1))
        scores = scores + _relative_to_absolute(rel_logits)
    if attn_mask is not None:
        scores = scores.masked_fill(attn_mask == 0, -1e4)
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(x.dtype), vh)
    if window_size is not None:
        rel_w = _absolute_to_relative(probs)
        rel_v = _get_relative_embeddings(p[pfx + "emb_rel_v"].float(), t_s, window_size)
        out = out + torch.matmul(rel_w, rel_v[0]).to(x.dtype)
    out = out.transpose(2, 3).reshape(b, d, t_t)
    out = conv1d(out, p[pfx + "conv_o.weight"], p[pfx + "conv_o.bias"])
    return out, probs


def ffn(p, pfx, x, x_mask, kernel_size: int):
    pad_l = (kernel_size - 1) // 2
    pad_r = kernel_size // 2

    def same_pad(t):
        return t if kernel_size == 1 else F.pad(t, (pad_l, pad_r))

    h = conv1d(same_pad(x * x_mask), p[pfx + "conv_1.weight"], p[pfx + "conv_1.bias"])
    h = torch.relu(h)
    h = conv1d(same_pad(h * x_mask), p[pfx + "conv_2.weight"], p[pfx + "conv_2.bias"])
    return h * x_mask


def vits_encoder(p, pfx, x, x_mask, n_layers: int, n_heads: int, kernel_size: int,
                 window_size: int = 4):
    attn_mask = x_mask[:, :, None, :] * x_mask[:, :, :, None]
    x = x * x_mask
    for i in range(n_layers):
        y, _ = vits_attention(p, f"{pfx}attn_layers.{i}.", x, x, n_heads, attn_mask,
                              window_size)
        x = channel_layer_norm(x + y, p[f"{pfx}norm_layers_1.{i}.gamma"],
                               p[f"{pfx}norm_layers_1.{i}.beta"])
        y = ffn(p, f"{pfx}ffn_layers.{i}.", x, x_mask, kernel_size)
        x = channel_layer_norm(x + y, p[f"{pfx}norm_layers_2.{i}.gamma"],
                               p[f"{pfx}norm_layers_2.{i}.beta"])
    return x * x_mask


def mrte(p, pfx, ssl_enc, ssl_mask, text, text_mask, ge, slice_indices=None,
         nullkey_idx=None):
    """Cross-attention fusion; returns (out, attn).  ``slice_indices`` [T, 2]
    (packed batches): frame t attends only text columns [start_t, end_t) —
    a block-diagonal mask — plus the always-attendable null key, the last
    column unless ``nullkey_idx`` names another (shape-padded text)."""
    if slice_indices is None:
        attn_mask = text_mask[:, :, None, :] * ssl_mask[:, :, :, None]
    else:
        text_range = torch.arange(text.shape[-1], device=text.device)[None, :]
        attn_mask = ((text_range >= slice_indices[:, :1]) & (text_range < slice_indices[:, 1:]))
        if nullkey_idx is None:
            attn_mask[:, -1] = True
        else:
            attn_mask = attn_mask | (text_range == nullkey_idx)
        attn_mask = attn_mask[None, None]
    ssl_h = conv1d(ssl_enc * ssl_mask, p[pfx + "c_pre.weight"], p[pfx + "c_pre.bias"])
    text_h = conv1d(text * text_mask, p[pfx + "text_pre.weight"], p[pfx + "text_pre.bias"])
    x, attn = vits_attention(p, pfx + "cross_attention.", ssl_h * ssl_mask,
                             text_h * text_mask, 4, attn_mask, None)
    x = x + ssl_h + ge
    x = conv1d(x * ssl_mask, p[pfx + "c_post.weight"], p[pfx + "c_post.bias"])
    return x, attn


def wn(p, pfx, x, x_mask, n_layers: int, hidden: int, kernel_size: int,
       dilation_rate: int, g=None):
    output = torch.zeros_like(x)
    if g is not None:
        g = conv1d(g, p[pfx + "cond_layer.weight"], p[pfx + "cond_layer.bias"])
    for i in range(n_layers):
        dilation = dilation_rate ** i
        padding = (kernel_size * dilation - dilation) // 2
        x_in = conv1d(x, p[f"{pfx}in_layers.{i}.weight"], p[f"{pfx}in_layers.{i}.bias"],
                      padding=padding, dilation=dilation)
        in_act = x_in if g is None else x_in + g[:, i * 2 * hidden:(i + 1) * 2 * hidden]
        acts = torch.tanh(in_act[:, :hidden]) * torch.sigmoid(in_act[:, hidden:])
        res_skip = conv1d(acts, p[f"{pfx}res_skip_layers.{i}.weight"],
                          p[f"{pfx}res_skip_layers.{i}.bias"])
        if i < n_layers - 1:
            x = (x + res_skip[:, :hidden]) * x_mask
            output = output + res_skip[:, hidden:]
        else:
            output = output + res_skip
    return output * x_mask


def flow_reverse(p, cfg: SovitsConfig, x, x_mask, g):
    """``ResidualCouplingBlock`` in reverse (``models.py:58-65``)."""
    half = cfg.inter_channels // 2
    for i in range(cfg.flow_n_flows - 1, -1, -1):
        x = torch.flip(x, dims=(1,))
        pfx = f"flow.flows.{i * 2}."
        x0, x1 = x[:, :half], x[:, half:]
        h = conv1d(x0, p[pfx + "pre.weight"], p[pfx + "pre.bias"]) * x_mask
        h = wn(p, pfx + "enc.", h, x_mask, cfg.flow_n_layers, cfg.hidden_channels,
               cfg.flow_kernel_size, 1, g=g)
        m = conv1d(h, p[pfx + "post.weight"], p[pfx + "post.bias"]) * x_mask
        x = torch.cat([x0, (x1 - m) * x_mask], dim=1)
    return x


def resblock1(p, pfx, x, kernel_size: int, dilations: Tuple[int, ...], keep=None):
    """``ResBlock1``; with ``keep`` [L] (1 on the valid samples, 0 after) each
    conv's output is cut to the valid samples, as :func:`generator` says."""
    for j, d in enumerate(dilations):
        xt = leaky_relu(x, LRELU_SLOPE)
        xt = conv1d(xt, p[f"{pfx}convs1.{j}.weight"], p[f"{pfx}convs1.{j}.bias"],
                    padding=(kernel_size * d - d) // 2, dilation=d)
        if keep is not None:
            xt = xt * keep
        xt = leaky_relu(xt, LRELU_SLOPE)
        xt = conv1d(xt, p[f"{pfx}convs2.{j}.weight"], p[f"{pfx}convs2.{j}.bias"],
                    padding=(kernel_size - 1) // 2)
        if keep is not None:
            xt = xt * keep
        x = xt + x
    return x


def _keep(x, frames, rate: int):
    """[L] of x's dtype: 1 on the first ``frames``·rate samples of x [B, C,
    L], 0 after (``frames`` a tensor, so a CUDA graph serves any length)."""
    return (torch.arange(x.shape[-1], device=x.device) < frames * rate).to(x.dtype)


def generator(p, cfg: SovitsConfig, x, g=None, n_stages: Optional[int] = None, frames=None):
    """HiFi-GAN vocoder (``models.py:68-128``): [B, inter, T] → [B, 1, T·Π(u)].
    ``n_stages`` stops after that many upsampling stages and returns the
    intermediate (for attributing time; it is not audio).  ``frames`` (a
    tensor [1]) cuts the input and every conv's output to the first
    ``frames`` frames at its rate, so each conv sees zeros after them as at
    that length: the first frames·Π(u) samples are the vocoder's at
    ``frames`` frames, whatever pads x after them."""
    keep = None if frames is None else _keep(x, frames, 1)
    x = x if keep is None else x * keep
    x = conv1d(x, p["dec.conv_pre.weight"], p["dec.conv_pre.bias"], padding=3)
    if g is not None:
        x = x + conv1d(g, p["dec.cond.weight"], p["dec.cond.bias"])
    x = x if keep is None else x * keep
    nk, rate = len(cfg.resblock_kernel_sizes), 1
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        if n_stages is not None and i >= n_stages:
            return x
        x = leaky_relu(x, LRELU_SLOPE)
        x = conv_transpose1d(x, p[f"dec.ups.{i}.weight"], p[f"dec.ups.{i}.bias"],
                             stride=u, padding=(k - u) // 2)
        if frames is not None:
            rate *= u
            keep = _keep(x, frames, rate)
            x = x * keep
        xs = None
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            r = resblock1(p, f"dec.resblocks.{i * nk + j}.", x, rk, rd, keep)
            xs = r if xs is None else xs + r
        x = xs / nk
    x = leaky_relu(x, 0.01)  # torch's default slope (``models.py:128``)
    x = conv1d(x, p["dec.conv_post.weight"], p.get("dec.conv_post.bias"), padding=3)
    return torch.tanh(x)


def mel_style_encoder(p, cfg: SovitsConfig, x, mask=None):
    """x [B, 704, T] → style vector [B, gin, 1] (``modules.py:367-444``).
    ``mask`` [B, 1, T] (1 valid, 0 padding) keeps a padded training batch's
    frames out of the attention and the temporal mean, which then runs in
    float32 as JAX's does; without it every frame is valid (exact shape)."""
    pfx = "ref_enc."
    key_mask = None if mask is None else mask[:, 0, :] == 0  # True = padding
    x = x.transpose(1, 2)
    x = mish(linear(x, p[pfx + "spectral.0.fc.weight"], p[pfx + "spectral.0.fc.bias"]))
    x = mish(linear(x, p[pfx + "spectral.3.fc.weight"], p[pfx + "spectral.3.fc.bias"]))
    x = x.transpose(1, 2)
    c = cfg.ref_enc_hidden
    for i in range(2):
        h = conv1d(x, p[f"{pfx}temporal.{i}.conv1.conv.weight"],
                   p[f"{pfx}temporal.{i}.conv1.conv.bias"],
                   padding=(cfg.ref_enc_kernel - 1) // 2)
        x = x + h[:, :c] * torch.sigmoid(h[:, c:])
    x = x.transpose(1, 2)
    if key_mask is not None:
        x = x.masked_fill(key_mask[:, :, None], 0.0)
    b, t, _ = x.shape
    nh = cfg.ref_enc_heads
    dk = c // nh

    def heads(w):
        y = linear(x, p[f"{pfx}slf_attn.{w}.weight"], p[f"{pfx}slf_attn.{w}.bias"])
        return y.reshape(b, t, nh, dk).permute(2, 0, 1, 3)

    q, k, v = heads("w_qs"), heads("w_ks"), heads("w_vs")
    scores = torch.matmul(q.float(), k.float().transpose(2, 3)) / math.sqrt(c)
    if key_mask is not None:
        scores = scores.masked_fill(key_mask[None, :, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).permute(1, 2, 0, 3).reshape(b, t, nh * dk)
    out = linear(out, p[pfx + "slf_attn.fc.weight"], p[pfx + "slf_attn.fc.bias"])
    x = linear(out + x, p[pfx + "fc.fc.weight"], p[pfx + "fc.fc.bias"])
    if key_mask is None:
        return x.mean(1)[:, :, None]
    lens = (~key_mask).sum(1)[:, None, None]
    w = (x.masked_fill(key_mask[:, :, None], 0.0).float() / lens).sum(1)
    return w.to(x.dtype)[:, :, None]


# ---------------------------------------------------------------------------
# RVQ
# ---------------------------------------------------------------------------

def quantizer_decode(p, codes, n_q: int = 1):
    """codes [n_q, B, T] → summed codebook vectors [B, D, T]."""
    out = None
    for q in range(n_q):
        vec = F.embedding(codes[q].long(), p[f"quantizer.vq.layers.{q}._codebook.embed"])
        out = vec if out is None else out + vec
    return out.transpose(1, 2)


def quantizer_encode(p, x, n_q: int = 1):
    """x [B, D, T] → codes [n_q, B, T] (euclidean nearest, residual)."""
    residual = x.transpose(1, 2).float()
    codes = []
    for q in range(n_q):
        embed = p[f"quantizer.vq.layers.{q}._codebook.embed"].float()
        dist = ((residual ** 2).sum(-1, keepdim=True) - 2 * residual @ embed.T
                + (embed ** 2).sum(-1)[None, None, :])
        idx = torch.argmin(dist, dim=-1)
        codes.append(idx)
        residual = residual - embed[idx]
    return torch.stack(codes)


def extract_latent(p, x):
    """50 Hz SSL features [B, 768, T] → 25 Hz RVQ codes [B, n_q, T']."""
    ssl = conv1d(x, p["ssl_proj.weight"], p["ssl_proj.bias"], stride=2)
    return quantizer_encode(p, ssl).transpose(0, 1)


# ---------------------------------------------------------------------------
# TextEncoder + synthesizer
# ---------------------------------------------------------------------------

def text_encoder_infer(p, cfg: SovitsConfig, y, text, ge, slice_indices=None, y_mask=None,
                       text_mask=None, nullkey_idx=None):
    """``TextEncoder.infer`` core (``models.py:196-224``): y [B, 768, T]
    upsampled quantized latent, text [B, N] phone ids, ge [B, 512, 1 or T]
    (v2Pro: already through :func:`ge_for_mrte`),
    ``slice_indices`` [T, 2] the per-frame text span of a packed batch and
    ``nullkey_idx`` its null key (see :func:`mrte`).  ``y_mask`` [B, 1, T] and
    ``text_mask`` [B, 1, N] mark the valid frames and phones of padded
    inputs (all ones when not given: the exact shape).  A padded frame's
    attention row is fully masked and comes out uniform, not NaN (masked
    scores are -1e4, not -inf).  Returns (y_latent [B, H, T], y_mask,
    attn [B, 4, T, N])."""
    pfx = "enc_p."
    if y_mask is None:
        y_mask = torch.ones((y.shape[0], 1, y.shape[2]), dtype=y.dtype, device=y.device)
    if text_mask is None:
        text_mask = torch.ones((text.shape[0], 1, text.shape[1]), dtype=y.dtype,
                               device=y.device)
    h = conv1d(y * y_mask, p[pfx + "ssl_proj.weight"], p[pfx + "ssl_proj.bias"]) * y_mask
    h = vits_encoder(p, pfx + "encoder_ssl.", h * y_mask, y_mask, cfg.n_layers // 2,
                     cfg.n_heads, cfg.kernel_size, cfg.window_size)
    t = F.embedding(text.long(), p[pfx + "text_embedding.weight"]).to(h.dtype).transpose(1, 2)
    t = vits_encoder(p, pfx + "encoder_text.", t * text_mask, text_mask, cfg.n_layers,
                     cfg.n_heads, cfg.kernel_size, cfg.window_size)
    h, attn = mrte(p, pfx + "mrte.", h, y_mask, t, text_mask, ge, slice_indices, nullkey_idx)
    h = vits_encoder(p, pfx + "encoder2.", h * y_mask, y_mask, cfg.n_layers // 2,
                     cfg.n_heads, cfg.kernel_size, cfg.window_size)
    return h, y_mask, attn


def project_latent(p, cfg: SovitsConfig, y_latent, y_mask):
    stats = conv1d(y_latent, p["enc_p.proj.weight"], p["enc_p.proj.bias"]) * y_mask
    return stats[:, :cfg.inter_channels], stats[:, cfg.inter_channels:]


def get_ge(p, cfg: SovitsConfig, refer, sv_emb=None, refer_mask=None):
    """Speaker conditioning [B, gin, 1] from the linear spectrogram
    (``models.py:371-378``); ``refer_mask`` [B, 1, T] marks a padded
    training batch's valid frames (:func:`mel_style_encoder`).  v2Pro /
    v2ProPlus with ``sv_emb`` [B, 20480] (``models/sv.py``'s float32
    embedding): ``prelu(ge + sv_emb·W + b)``.
    JAX computes that in the embedding's float32 and returns float32 (its
    ``linear`` casts the weight to the input's dtype), which would carry
    float32 into a bf16 flow and HiFi-GAN; the port computes it in float32
    and returns ``ge`` in the style encoder's dtype, the model's (the same
    values when the model is float32, as in training)."""
    refer = refer[:, :cfg.ref_enc_in]
    if refer_mask is not None:
        refer = refer * refer_mask
    ge = mel_style_encoder(p, cfg, refer, refer_mask)
    if cfg.is_v2pro and sv_emb is not None:
        sv = linear(sv_emb.float(), p["sv_emb.weight"], p["sv_emb.bias"])
        ge = prelu(ge.float() + sv[:, :, None], p["prelu.weight"]).to(ge.dtype)
    return ge


def ge_for_mrte(p, cfg: SovitsConfig, ge):
    """The ``ge`` MRTE takes: v2Pro routes it through ``ge_to512``
    (``models.py:394``), [B, gin, T] → [B, 512, T]; v2 takes it as it is."""
    if cfg.is_v2pro:
        return linear(ge.transpose(1, 2), p["ge_to512.weight"],
                      p["ge_to512.bias"]).transpose(1, 2)
    return ge


def flow_dec(p, cfg: SovitsConfig, z_p, y_mask, ge):
    """flow⁻¹ + vocoder (``models.py:380-383``), channels-first."""
    z = flow_reverse(p, cfg, z_p, y_mask, ge)
    return generator(p, cfg, z * y_mask, g=ge)


def decode_core(p, cfg: SovitsConfig, codes, text, ge, noise, slice_indices=None,
                y_overlap=None, valid_start_idx: int = 0, overlap_len: Optional[int] = None,
                speed: float = 1.0, y_mask=None, text_mask=None, nullkey_idx=None):
    """Latent pipeline of ``SynthesizerTrn.decode`` (``models.py:385-404``)
    up to ``z_p``.  ``codes`` [n_q, B, T], ``text`` [B, N], ``ge`` [B, gin, 1]
    or per code frame [B, gin, T] (a packed batch of several speakers;
    upsampled 2x to the latent rate here), ``noise`` [B, inter, frames kept]
    standard normal already scaled by ``noise_scale``, ``slice_indices``
    [2T, 2] each latent frame's text span in a packed batch; ``y_mask``,
    ``text_mask`` and ``nullkey_idx`` as in :func:`text_encoder_infer`.

    Streaming (``overlap_len`` given): the latent of the cumulative codes is
    cut to the frames from ``valid_start_idx`` on, its first ``overlap_len``
    frames cross-faded with ``y_overlap`` — the previous chunk's last frames
    — when there is one (``models.py:209-215``), and its own last
    ``overlap_len`` frames returned as ``new_overlap``.

    ``speed != 1`` resamples the latent linearly to ``int(frames / speed) + 1``
    frames (the mask and a frame-wise ``ge`` nearest), so ``noise`` has that
    many frames (``models.py:217-219``).

    Returns (z_p, y_mask, attn, new_overlap or None, ge for ``flow_dec``)."""
    quantized = interpolate_nearest_2x(quantizer_decode(p, codes, cfg.quantizer_n_q))
    if ge.shape[-1] != 1:
        ge = interpolate_nearest_2x(ge)
    y_latent, y_mask, attn = text_encoder_infer(p, cfg, quantized, text, ge_for_mrte(p, cfg, ge),
                                                slice_indices, y_mask, text_mask, nullkey_idx)
    new_overlap = None
    if overlap_len is not None:
        y_latent = y_latent[:, :, valid_start_idx:]
        y_mask = y_mask[:, :, valid_start_idx:]
        if y_overlap is not None:
            alpha = torch.linspace(0, 1, overlap_len, dtype=y_latent.dtype,
                                   device=y_latent.device)[None, None, :]
            head = y_overlap * (1 - alpha) + y_latent[:, :, :overlap_len] * alpha
            y_latent = torch.cat([head, y_latent[:, :, overlap_len:]], dim=2)
        new_overlap = y_latent[:, :, -overlap_len:]
    if speed != 1:
        y_latent = interpolate_linear(y_latent, int(y_latent.shape[-1] / speed) + 1)
        y_mask = interpolate_nearest(y_mask, y_latent.shape[-1])
        if ge.shape[-1] != 1:
            ge = interpolate_nearest(ge, y_latent.shape[-1])
    m, logs = project_latent(p, cfg, y_latent, y_mask)
    z_p = m + noise.to(m.dtype) * torch.exp(logs)
    return z_p, y_mask, attn, new_overlap, ge


def _take_frames(x, idx):
    """x [B, C, T], idx [B, n] device indices → [B, C, n], row b at idx[b]."""
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


def decode_core_stream_padded_batch(p, cfg: SovitsConfig, codes_pad, codes_len, text_pad,
                                    text_len, ge, noise, y_overlap, vsi, blend, *,
                                    overlap_len: int):
    """:func:`decode_core`'s streaming chunk for B rows right-padded into one
    bucket, with every length a device tensor, so one program (one CUDA
    graph) serves every chunk of the bucket.  ``codes_pad`` [B, 1, Bc],
    ``text_pad`` [B, Np], ``codes_len`` / ``text_len`` / ``vsi`` (the
    chunk's first latent frame) int64 [B], ``blend`` bool [B] (cross-fade
    with ``y_overlap`` [B, hidden, overlap_len]), ``ge`` [B, gin, 1],
    ``noise`` [B, inter, 2·Bc].  Masking makes the padding exact: a padded
    column is zero where the exact computation's convolutions see their
    zero padding, and attention masks it.  Nothing here reads the host: the
    chunk's and the overlap's offsets are gathered at device-computed
    indices, clamped as ``jax.lax.dynamic_slice`` clamps them.

    Returns (z_p [B, inter, 2·Bc], mask [B, 1, 2·Bc], attn [B, 4, 2·Bc, Np],
    new_overlap [B, hidden, overlap_len]); row b is valid over its first
    ``2·codes_len[b] - vsi[b]`` frames (reference: ``models/sovits.py:736``
    of the JAX package)."""
    Bc = codes_pad.shape[-1]
    T50 = 2 * Bc
    dev = codes_pad.device
    quantized = interpolate_nearest_2x(
        quantizer_decode(p, codes_pad.transpose(0, 1), cfg.quantizer_n_q))
    t50_valid = 2 * codes_len
    pos = torch.arange(T50, device=dev)
    y_mask = (pos[None, None, :] < t50_valid[:, None, None]).to(quantized.dtype)
    tpos = torch.arange(text_pad.shape[-1], device=dev)
    text_mask = (tpos[None, None, :] < text_len[:, None, None]).to(quantized.dtype)
    y_latent, y_mask, attn = text_encoder_infer(p, cfg, quantized, text_pad,
                                                ge_for_mrte(p, cfg, ge), y_mask=y_mask,
                                                text_mask=text_mask)
    # the chunk [vsi, vsi + T50) of rows right-extended by T50 zeros
    idx = vsi.clamp(0, T50)[:, None] + pos[None, :]
    chunk = _take_frames(F.pad(y_latent, (0, T50)), idx)
    mask_chunk = _take_frames(F.pad(y_mask, (0, T50)), idx)
    alpha = torch.linspace(0, 1, overlap_len, dtype=chunk.dtype, device=dev)[None, None, :]
    blended = y_overlap * (1 - alpha) + chunk[:, :, :overlap_len] * alpha
    head = torch.where(blend[:, None, None], blended, chunk[:, :, :overlap_len])
    chunk = torch.cat([head, chunk[:, :, overlap_len:]], dim=2)
    # the overlap carried to the next chunk: the blended chunk's valid tail
    start = (t50_valid - vsi - overlap_len).clamp(0, 2 * T50 - overlap_len)
    new_overlap = _take_frames(F.pad(chunk, (0, T50)),
                               start[:, None] + torch.arange(overlap_len, device=dev)[None, :])
    m, logs = project_latent(p, cfg, chunk, mask_chunk)
    z_p = m + noise.to(m.dtype) * torch.exp(logs)
    return z_p, mask_chunk, attn, new_overlap


def decode_core_stream_padded(p, cfg: SovitsConfig, codes_pad, codes_len, text_pad, text_len,
                              ge, noise, y_overlap, vsi, *, overlap_len: int, blend: bool):
    """One row of :func:`decode_core_stream_padded_batch`: ``codes_pad``
    [1, 1, Bc], ``text_pad`` [1, Np], ``codes_len`` / ``text_len`` / ``vsi``
    0-dim int64 device tensors, ``blend`` fixed by the caller (JAX:
    ``models/sovits.py:675``).  Returns (z_p [1, inter, 2·Bc], mask,
    attn [1, 4, 2·Bc, Np], new_overlap [1, hidden, overlap_len])."""
    blend_t = torch.full((1,), bool(blend), device=codes_pad.device)
    return decode_core_stream_padded_batch(
        p, cfg, codes_pad, codes_len.reshape(1), text_pad, text_len.reshape(1), ge, noise,
        y_overlap, vsi.reshape(1), blend_t, overlap_len=overlap_len)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def params_from_torch_state_dict(state_dict: Dict[str, Any], dtype=F32,
                                 device="cpu") -> Dict[str, torch.Tensor]:
    """Flat state dict (tensors or numpy) → port params; every weight-norm
    pair (``weight_g``/``weight_v``) is folded into ``weight``."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
          for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    consumed = set()
    for k in sorted(sd):
        if k.endswith("weight_v"):
            base = k[: -len("weight_v")]
            out[base + "weight"] = fold_weight_norm(sd[k].float(), sd[base + "weight_g"].float())
            consumed.update({k, base + "weight_g"})
    for k in sorted(set(sd) - consumed):
        out[k] = sd[k]
    return {k: v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
            .contiguous() for k, v in out.items()}


def init_params(cfg: SovitsConfig, generator: torch.Generator, dtype=F32,
                device="cpu", scale: float = 0.05) -> Dict[str, torch.Tensor]:
    """Random inference parameters with the reference keys and shapes (the
    JAX ``init_params`` layout, N(0, ``scale``) weights; v2Pro / v2ProPlus add
    ``sv_emb``, ``ge_to512`` and ``prelu``), drawn on the CPU from
    ``generator``."""
    p: Dict[str, torch.Tensor] = {}

    def nrm(*shape):
        return torch.randn(shape, generator=generator) * scale

    def conv(name, out_c, in_c, k, bias=True):
        p[name + ".weight"] = nrm(out_c, in_c, k)
        if bias:
            p[name + ".bias"] = torch.zeros(out_c)

    def lin(name, out_c, in_c):
        p[name + ".weight"] = nrm(out_c, in_c)
        p[name + ".bias"] = torch.zeros(out_c)

    C, Fc, Hn, W = cfg.hidden_channels, cfg.filter_channels, cfg.n_heads, cfg.window_size
    kch = C // Hn

    def encoder(pfx, n_layers):
        for i in range(n_layers):
            for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
                conv(f"{pfx}.attn_layers.{i}.{nm}", C, C, 1)
            p[f"{pfx}.attn_layers.{i}.emb_rel_k"] = nrm(1, 2 * W + 1, kch)
            p[f"{pfx}.attn_layers.{i}.emb_rel_v"] = nrm(1, 2 * W + 1, kch)
            for nm in ("norm_layers_1", "norm_layers_2"):
                p[f"{pfx}.{nm}.{i}.gamma"] = torch.ones(C)
                p[f"{pfx}.{nm}.{i}.beta"] = torch.zeros(C)
            conv(f"{pfx}.ffn_layers.{i}.conv_1", Fc, C, cfg.kernel_size)
            conv(f"{pfx}.ffn_layers.{i}.conv_2", C, Fc, cfg.kernel_size)

    conv("enc_p.ssl_proj", C, cfg.ssl_dim, 1)
    encoder("enc_p.encoder_ssl", cfg.n_layers // 2)
    encoder("enc_p.encoder_text", cfg.n_layers)
    p["enc_p.text_embedding.weight"] = nrm(cfg.n_symbols, C)
    for nm in ("conv_q", "conv_k", "conv_v", "conv_o"):
        conv(f"enc_p.mrte.cross_attention.{nm}", 512, 512, 1)
    conv("enc_p.mrte.c_pre", 512, C, 1)
    conv("enc_p.mrte.text_pre", 512, C, 1)
    conv("enc_p.mrte.c_post", C, 512, 1)
    encoder("enc_p.encoder2", cfg.n_layers // 2)
    conv("enc_p.proj", cfg.inter_channels * 2, C, 1)

    ch0 = cfg.upsample_initial_channel
    conv("dec.conv_pre", ch0, cfg.inter_channels, 7)
    conv("dec.cond", ch0, cfg.gin_channels, 1)
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        in_c, out_c = ch0 // (2 ** i), ch0 // (2 ** (i + 1))
        p[f"dec.ups.{i}.weight"] = nrm(in_c, out_c, k)
        p[f"dec.ups.{i}.bias"] = torch.zeros(out_c)
        for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes,
                                         cfg.resblock_dilation_sizes)):
            for m in range(len(rd)):
                conv(f"dec.resblocks.{i * nk + j}.convs1.{m}", out_c, out_c, rk)
                conv(f"dec.resblocks.{i * nk + j}.convs2.{m}", out_c, out_c, rk)
    conv("dec.conv_post", 1, ch0 // (2 ** len(cfg.upsample_rates)), 7, bias=False)

    half = cfg.inter_channels // 2
    for i in range(cfg.flow_n_flows):
        pfx = f"flow.flows.{i * 2}"
        conv(f"{pfx}.pre", C, half, 1)
        conv(f"{pfx}.enc.cond_layer", 2 * C * cfg.flow_n_layers, cfg.gin_channels, 1)
        for j in range(cfg.flow_n_layers):
            conv(f"{pfx}.enc.in_layers.{j}", 2 * C, C, cfg.flow_kernel_size)
            rs = 2 * C if j < cfg.flow_n_layers - 1 else C
            conv(f"{pfx}.enc.res_skip_layers.{j}", rs, C, 1)
        conv(f"{pfx}.post", half, C, 1)

    h = cfg.ref_enc_hidden
    lin("ref_enc.spectral.0.fc", h, cfg.ref_enc_in)
    lin("ref_enc.spectral.3.fc", h, h)
    for i in range(2):
        conv(f"ref_enc.temporal.{i}.conv1.conv", 2 * h, h, cfg.ref_enc_kernel)
    for nm in ("w_qs", "w_ks", "w_vs", "fc"):
        lin(f"ref_enc.slf_attn.{nm}", h, h)
    lin("ref_enc.fc.fc", cfg.gin_channels, h)

    p["quantizer.vq.layers.0._codebook.embed"] = torch.randn(
        (cfg.quantizer_bins, cfg.ssl_dim), generator=generator)
    conv("ssl_proj", cfg.ssl_dim, cfg.ssl_dim, 2)
    if cfg.is_v2pro:
        lin("sv_emb", cfg.gin_channels, SV_EMBED_DIM)  # takes models/sv.py's embedding
        lin("ge_to512", 512, cfg.gin_channels)
        p["prelu.weight"] = torch.full((cfg.gin_channels,), 0.25)
    return {k: v.to(device=device, dtype=dtype) for k, v in p.items()}
