"""CNHubert SSL featurizer (counterpart of ``gsv_tts_tpu/models/hubert.py``).

16 kHz waveform → 768-d 50 Hz SSL features for prompt extraction: the
HuBERT-base topology (conv feature extractor with a group-norm first layer,
feature projection, convolutional positional embedding, post-LN encoder),
driven by the Hugging Face ``config.json`` and loaded from
``model.safetensors`` without ``transformers``.  Under
``Config.featurizer_buckets`` ``CNHubert`` pads the waveform to a multiple of
``BUCKET_SAMPLES`` and runs the masked forward (group-norm statistics over
the valid frames, padded frames zeroed ahead of the positional conv and
masked as attention keys), then trims the output to the exact frames.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.convs import conv1d, linear
from ..ops.norms import layer_norm
from ..utils.safetensors import load_file
from ..utils.timing import span

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    feat_extract_norm: str = "group"
    conv_bias: bool = False
    layer_norm_eps: float = 1e-5
    do_stable_layer_norm: bool = False
    feat_proj_layer_norm: bool = True

    @classmethod
    def from_dict(cls, c: Dict[str, Any]) -> "HubertConfig":
        return cls(
            hidden_size=c["hidden_size"], num_hidden_layers=c["num_hidden_layers"],
            num_attention_heads=c["num_attention_heads"],
            intermediate_size=c["intermediate_size"], conv_dim=tuple(c["conv_dim"]),
            conv_kernel=tuple(c["conv_kernel"]), conv_stride=tuple(c["conv_stride"]),
            num_conv_pos_embeddings=c["num_conv_pos_embeddings"],
            num_conv_pos_embedding_groups=c["num_conv_pos_embedding_groups"],
            feat_extract_norm=c.get("feat_extract_norm", "group"),
            conv_bias=c.get("conv_bias", False),
            layer_norm_eps=c.get("layer_norm_eps", 1e-5),
            do_stable_layer_norm=c.get("do_stable_layer_norm", False),
            feat_proj_layer_norm=c.get("feat_proj_layer_norm", True))

    @classmethod
    def from_json(cls, path) -> "HubertConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in ("conv_dim", "conv_kernel", "conv_stride"):
            d[k] = list(d[k])
        d["model_type"] = "hubert"
        return d


def conv_out_length(length: int, cfg: HubertConfig, n_layers: Optional[int] = None) -> int:
    """Frames the first ``n_layers`` conv-extractor layers (all by default)
    make of ``length`` samples (torch's floor rule)."""
    for k, s in list(zip(cfg.conv_kernel, cfg.conv_stride))[:n_layers]:
        length = (length - k) // s + 1
    return int(length)


def _group_norm(x, g, b, num_groups, eps=1e-5, valid=None):
    """torch GroupNorm on [B, C, T], float32 statistics; ``valid`` ([B]
    int, optional) takes them over the first ``valid[b]`` steps only."""
    B, C, T = x.shape
    x32 = x.float().reshape(B, num_groups, C // num_groups, T)
    if valid is None:
        mean = x32.mean(dim=(2, 3), keepdim=True)
        var = ((x32 - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    else:
        m = (torch.arange(T, device=x.device)[None, :] < valid[:, None]).float()[:, None, None]
        cnt = (valid.float() * (C // num_groups))[:, None, None, None]
        mean = (x32 * m).sum(dim=(2, 3), keepdim=True) / cnt
        d = (x32 - mean) * m
        var = (d * d).sum(dim=(2, 3), keepdim=True) / cnt
    x32 = ((x32 - mean) * torch.rsqrt(var + eps)).reshape(B, C, T)
    return (x32 * g.float()[None, :, None] + b.float()[None, :, None]).to(x.dtype)


def _gelu(x):
    return F.gelu(x.float()).to(x.dtype)


def feature_extractor(p, cfg: HubertConfig, x, valid_l0=None):
    """waveform [B, T] → [B, C, frames]; ``valid_l0`` ([B], optional): the
    layer-0 frames whose windows lie inside the unpadded waveform, over
    which the group norm takes its statistics."""
    h = x[:, None, :]
    for i, (k, s) in enumerate(zip(cfg.conv_kernel, cfg.conv_stride)):
        h = conv1d(h, p[f"feature_extractor.conv_layers.{i}.conv.weight"],
                   p.get(f"feature_extractor.conv_layers.{i}.conv.bias"), stride=s)
        if i == 0 and cfg.feat_extract_norm == "group":
            h = _group_norm(h, p["feature_extractor.conv_layers.0.layer_norm.weight"],
                            p["feature_extractor.conv_layers.0.layer_norm.bias"],
                            num_groups=cfg.conv_dim[0], valid=valid_l0)
        elif cfg.feat_extract_norm == "layer":
            h = layer_norm(h.transpose(1, 2),
                           p[f"feature_extractor.conv_layers.{i}.layer_norm.weight"],
                           p[f"feature_extractor.conv_layers.{i}.layer_norm.bias"]).transpose(1, 2)
        h = _gelu(h)
    return h


def encoder_layer(p, pfx, x, n_heads, eps, mask_bias=None):
    B, T, D = x.shape
    Dh = D // n_heads

    def heads(name):
        y = linear(x, p[pfx + f"attention.{name}.weight"], p[pfx + f"attention.{name}.bias"])
        return y.reshape(B, T, n_heads, Dh).transpose(1, 2)

    q, k, v = heads("q_proj"), heads("k_proj"), heads("v_proj")
    scores = torch.matmul(q.float(), k.float().transpose(2, 3)) / math.sqrt(Dh)
    if mask_bias is not None:  # padded keys: -1e9, an exact 0 after the softmax
        scores = scores + mask_bias
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, D)
    attn = linear(attn, p[pfx + "attention.out_proj.weight"], p[pfx + "attention.out_proj.bias"])
    x = layer_norm(x + attn, p[pfx + "layer_norm.weight"], p[pfx + "layer_norm.bias"], eps)
    h = _gelu(linear(x, p[pfx + "feed_forward.intermediate_dense.weight"],
                     p[pfx + "feed_forward.intermediate_dense.bias"]))
    h = linear(h, p[pfx + "feed_forward.output_dense.weight"],
               p[pfx + "feed_forward.output_dense.bias"])
    return layer_norm(x + h, p[pfx + "final_layer_norm.weight"],
                      p[pfx + "final_layer_norm.bias"], eps)


def hubert_forward(p, cfg: HubertConfig, wav, n_frames=None, valid_l0=None):
    """wav [B, T] (16 kHz) → last_hidden_state [B, frames, hidden].  With
    ``n_frames`` and ``valid_l0`` ([B] int tensors) ``wav`` is zero-padded
    past its real length: the group norm takes its statistics over the first
    ``valid_l0`` layer-0 frames, the projected features past ``n_frames`` are
    zeroed and masked as attention keys, so rows below ``n_frames`` match
    the exact-shape run; the caller trims the rest."""
    with span("gsv.voice.hubert.features"):
        h = feature_extractor(p, cfg, wav, valid_l0=valid_l0).transpose(1, 2)
    if cfg.feat_proj_layer_norm:
        h = layer_norm(h, p["feature_projection.layer_norm.weight"],
                       p["feature_projection.layer_norm.bias"], cfg.layer_norm_eps)
    h = linear(h, p["feature_projection.projection.weight"],
               p["feature_projection.projection.bias"])
    mask_bias = None
    if n_frames is not None:
        fmask = torch.arange(h.shape[1], device=h.device)[None, :] < n_frames[:, None]
        h = h * fmask[:, :, None].to(h.dtype)
        mask_bias = torch.where(fmask, 0.0, -1e9).to(F32)[:, None, None, :]
    k = cfg.num_conv_pos_embeddings
    pos = conv1d(h.transpose(1, 2), p["encoder.pos_conv_embed.conv.weight"],
                 p["encoder.pos_conv_embed.conv.bias"], padding=k // 2,
                 groups=cfg.num_conv_pos_embedding_groups)
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    h = h + _gelu(pos).transpose(1, 2)
    h = layer_norm(h, p["encoder.layer_norm.weight"], p["encoder.layer_norm.bias"],
                   cfg.layer_norm_eps)
    for i in range(cfg.num_hidden_layers):
        with span("gsv.voice.hubert.layer"):
            h = encoder_layer(p, f"encoder.layers.{i}.", h, cfg.num_attention_heads,
                              cfg.layer_norm_eps, mask_bias)
    return h


def params_from_torch_state_dict(state_dict: Dict[str, Any], dtype=F32,
                                 device="cpu") -> Dict[str, torch.Tensor]:
    """HF state dict (``hubert.`` prefix stripped) → port params, with the
    positional conv's weight norm (dim=2: norm over dims 0 and 1) folded."""
    sd = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
          for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    consumed = set()
    for gk, vk in (("encoder.pos_conv_embed.conv.weight_g",
                    "encoder.pos_conv_embed.conv.weight_v"),
                   ("encoder.pos_conv_embed.conv.parametrizations.weight.original0",
                    "encoder.pos_conv_embed.conv.parametrizations.weight.original1")):
        if gk in sd:
            g, v = sd[gk].float(), sd[vk].float()
            norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
            out["encoder.pos_conv_embed.conv.weight"] = g * v / norm
            consumed.update({gk, vk})
    for k, v in sd.items():
        if k not in consumed and not k.startswith("masked_spec_embed"):
            out[k] = v
    return {k: v.to(device=device, dtype=dtype).contiguous() for k, v in out.items()}


def init_params(cfg: HubertConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random float32 CPU weights in the HF key layout (positional conv
    weight already folded; N(0, 0.02), the first conv N(0, 0.2)), for smoke
    runs without a checkpoint."""
    p: Dict[str, torch.Tensor] = {}

    def nrm(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    c_in = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        p[f"feature_extractor.conv_layers.{i}.conv.weight"] = nrm(c, c_in, k) * 10
        c_in = c
    p["feature_extractor.conv_layers.0.layer_norm.weight"] = torch.ones(cfg.conv_dim[0])
    p["feature_extractor.conv_layers.0.layer_norm.bias"] = torch.zeros(cfg.conv_dim[0])
    D, I = cfg.hidden_size, cfg.intermediate_size
    p["feature_projection.layer_norm.weight"] = torch.ones(c_in)
    p["feature_projection.layer_norm.bias"] = torch.zeros(c_in)
    p["feature_projection.projection.weight"] = nrm(D, c_in)
    p["feature_projection.projection.bias"] = torch.zeros(D)
    p["encoder.pos_conv_embed.conv.weight"] = nrm(
        D, D // cfg.num_conv_pos_embedding_groups, cfg.num_conv_pos_embeddings)
    p["encoder.pos_conv_embed.conv.bias"] = torch.zeros(D)
    p["encoder.layer_norm.weight"] = torch.ones(D)
    p["encoder.layer_norm.bias"] = torch.zeros(D)
    for i in range(cfg.num_hidden_layers):
        pfx = f"encoder.layers.{i}."
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            p[pfx + f"attention.{nm}.weight"] = nrm(D, D)
            p[pfx + f"attention.{nm}.bias"] = torch.zeros(D)
        for nm in ("layer_norm", "final_layer_norm"):
            p[pfx + f"{nm}.weight"] = torch.ones(D)
            p[pfx + f"{nm}.bias"] = torch.zeros(D)
        p[pfx + "feed_forward.intermediate_dense.weight"] = nrm(I, D)
        p[pfx + "feed_forward.intermediate_dense.bias"] = torch.zeros(I)
        p[pfx + "feed_forward.output_dense.weight"] = nrm(D, I)
        p[pfx + "feed_forward.output_dense.bias"] = torch.zeros(D)
    return p


class CNHubert:
    """Loads ``config.json`` and ``model.safetensors`` (or
    ``pytorch_model.bin`` through ``torch.load(weights_only=True)``) from
    ``base_path``; calling it maps wav [B, T] → [B, frames, hidden].  With
    ``tts_config.featurizer_buckets`` the waveform is padded to a multiple
    of ``BUCKET_SAMPLES`` (0.5 s at 16 kHz) and the masked forward runs."""

    BUCKET_SAMPLES = 8000

    def __init__(self, base_path, tts_config):
        cfg_path = os.path.join(base_path, "config.json")
        if not os.path.exists(cfg_path):
            raise FileNotFoundError(f"HuBERT config not found: {cfg_path}")
        self.cfg = HubertConfig.from_json(cfg_path)
        self.device = tts_config.device
        self.dtype = tts_config.dtype
        st_path = os.path.join(base_path, "model.safetensors")
        bin_path = os.path.join(base_path, "pytorch_model.bin")
        if os.path.exists(st_path):
            sd = load_file(st_path)
        elif os.path.exists(bin_path):
            sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        else:
            raise FileNotFoundError(f"HuBERT weights not found: {st_path} (or {bin_path})")
        sd = {k.removeprefix("hubert."): v for k, v in sd.items()}
        self.params = params_from_torch_state_dict(sd, self.dtype, self.device)
        self.buckets = bool(getattr(tts_config, "featurizer_buckets", False))

    @torch.no_grad()
    def __call__(self, wav16k: np.ndarray, normalize: bool = False) -> torch.Tensor:
        """``normalize=False`` matches the reference's prompt path, which
        feeds the raw waveform into ``HubertModel``."""
        wav = np.asarray(wav16k, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        if normalize:
            mean = wav.mean(axis=-1, keepdims=True)
            std = wav.std(axis=-1, keepdims=True)
            wav = (wav - mean) / np.sqrt(std ** 2 + 1e-7)
        if not self.buckets:
            x = torch.as_tensor(wav, device=self.device).to(self.dtype)
            return hubert_forward(self.params, self.cfg, x)
        T = wav.shape[1]
        pad_T = max(self.BUCKET_SAMPLES, -(-T // self.BUCKET_SAMPLES) * self.BUCKET_SAMPLES)
        x = torch.as_tensor(np.pad(wav, ((0, 0), (0, pad_T - T))), device=self.device)
        n_frames = conv_out_length(T, self.cfg)

        def per_row(n):
            return torch.full((x.shape[0],), n, dtype=torch.int64, device=self.device)

        out = hubert_forward(self.params, self.cfg, x.to(self.dtype), n_frames=per_row(n_frames),
                             valid_l0=per_row(conv_out_length(T, self.cfg, n_layers=1)))
        return out[:, :n_frames]
