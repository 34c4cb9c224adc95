"""Speaker-verification embedder: Kaldi fbank + ERes2NetV2 (counterpart of
``gsv_tts_tpu/models/sv.py``; reference ``GPT_SoVITS/SV``: ``sv.py``,
``ERes2NetV2.py``, ``fusion.py``).

80-bin Kaldi fbank (povey window, dither 0; host numpy, an own copy of the
JAX package's, equal to it bit for bit) → ERes2NetV2 (baseWidth 24, scale
4, expansion 4) → ``forward3``: the fused pre-pooling feature map's mean
over time, a [B, 20480] float32 embedding.  v2Pro's ``sv_emb`` linear and
``TTS.verify_speaker`` consume it.  The JAX package computes this in XLA,
outside any Pallas kernel, so the port is plain PyTorch.

Parameters are a flat dict keyed by the reference state-dict names.  The
JAX package has no ``init_params`` for them; :func:`param_shapes` is the
port's key/shape table, read off the forward pass.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.convs import batch_norm, conv2d
from ..utils.timing import span

F32 = torch.float32
#: the embedding's width at the published config: 2048 channels × 10 mel rows
#: (layer 4 is 8 × m_channels × expansion wide, the 80 mel rows halved three times)
EMBED_DIM = 20480


# ---------------------------------------------------------------------------
# Kaldi-compatible fbank (torchaudio.compliance.kaldi.fbank defaults with
# num_mel_bins=80, sample_frequency=16000, dither=0 — reference ``sv.py:19``)
# ---------------------------------------------------------------------------

def _povey_window(n: int) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))) ** 0.85


def _kaldi_mel_banks(num_bins: int, window_size: int, sr: float,
                     low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    if high_freq <= 0:
        high_freq = sr / 2 + high_freq
    num_fft_bins = window_size // 2

    def mel(f):
        return 1127.0 * np.log(1.0 + f / 700.0)

    mel_low = mel(low_freq)
    mel_high = mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    fft_bin_width = sr / window_size
    bins = np.zeros((num_bins, num_fft_bins))
    for b in range(num_bins):
        left, center, right = (mel_low + b * mel_delta,
                               mel_low + (b + 1) * mel_delta,
                               mel_low + (b + 2) * mel_delta)
        freqs = mel(fft_bin_width * np.arange(num_fft_bins))
        up = (freqs - left) / (center - left)
        down = (right - freqs) / (right - center)
        bins[b] = np.clip(np.minimum(up, down), 0, None)
    return bins.astype(np.float32)


def kaldi_fbank(wav: np.ndarray, num_mel_bins: int = 80, sr: int = 16000,
                frame_length_ms: float = 25.0, frame_shift_ms: float = 10.0,
                preemph: float = 0.97, remove_dc: bool = True) -> np.ndarray:
    """wav [T] float → [frames, num_mel_bins] log-mel (snip_edges=True)."""
    wav = np.asarray(wav, np.float32)
    win = int(sr * frame_length_ms / 1000)
    shift = int(sr * frame_shift_ms / 1000)
    padded = 1 << (win - 1).bit_length()  # round_to_power_of_two
    if len(wav) < win:
        return np.zeros((0, num_mel_bins), np.float32)
    n_frames = 1 + (len(wav) - win) // shift
    idx = np.arange(n_frames)[:, None] * shift + np.arange(win)[None, :]
    frames = wav[idx]
    if remove_dc:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if preemph:
        first = frames[:, :1]
        frames = np.concatenate([first - preemph * first,
                                 frames[:, 1:] - preemph * frames[:, :-1]], axis=1)
    frames = frames * _povey_window(win)[None, :]
    frames = np.pad(frames, [(0, 0), (0, padded - win)])
    spec = np.abs(np.fft.rfft(frames, axis=1)) ** 2  # power
    banks = _kaldi_mel_banks(num_mel_bins, padded, sr)
    banks = np.pad(banks, [(0, 0), (0, 1)])  # nyquist column is zero
    mel = spec @ banks.T
    return np.log(np.maximum(mel, np.finfo(np.float32).eps)).astype(np.float32)


# ---------------------------------------------------------------------------
# ERes2NetV2
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SVConfig:
    """ERes2NetV2's widths; the defaults are the published checkpoint's
    (``pretrained_eres2netv2w24s4ep4``: m_channels 64, blocks (3, 4, 6, 3),
    baseWidth 24, scale 4, expansion 4)."""

    num_blocks: Tuple[int, int, int, int] = (3, 4, 6, 3)
    m_channels: int = 64
    base_width: int = 24
    scale: int = 4
    expansion: int = 4


def _relu20(x):
    # reference ReLU = Hardtanh(0, 20) (``ERes2NetV2.py:9-15``)
    return torch.clamp(x, 0.0, 20.0)


def _bn(p, pfx, x):
    return batch_norm(x, p[pfx + "running_mean"], p[pfx + "running_var"],
                      p.get(pfx + "weight"), p.get(pfx + "bias"))


def _aff(p, pfx, x, ds_y):
    """Attentional feature fusion (``fusion.py:5-24``): x·(1 + tanh h) +
    y·(1 − tanh h)."""
    h = conv2d(torch.cat([x, ds_y], dim=1), p[pfx + "local_att.0.weight"],
               p[pfx + "local_att.0.bias"])
    h = _bn(p, pfx + "local_att.1.", h)
    h = F.silu(h.float()).to(h.dtype)
    h = conv2d(h, p[pfx + "local_att.3.weight"], p[pfx + "local_att.3.bias"])
    h = _bn(p, pfx + "local_att.4.", h)
    att = 1.0 + torch.tanh(h)
    return x * att + ds_y * (2.0 - att)


def _basic_block(p, pfx, x, width: int, scale: int, stride: int, use_aff: bool,
                 has_shortcut: bool):
    out = conv2d(x, p[pfx + "conv1.weight"], stride=stride)
    out = _relu20(_bn(p, pfx + "bn1.", out))
    spx = torch.split(out, width, dim=1)
    pieces = []
    sp = None
    for i in range(scale):
        if i == 0:
            sp = spx[0]
        elif use_aff:
            sp = _aff(p, f"{pfx}fuse_models.{i - 1}.", sp, spx[i])
        else:
            sp = sp + spx[i]
        sp = conv2d(sp, p[f"{pfx}convs.{i}.weight"], padding=1)
        sp = _relu20(_bn(p, f"{pfx}bns.{i}.", sp))
        pieces.append(sp)
    out = _bn(p, pfx + "bn3.", conv2d(torch.cat(pieces, dim=1), p[pfx + "conv3.weight"]))
    if has_shortcut:
        residual = _bn(p, pfx + "shortcut.1.",
                       conv2d(x, p[pfx + "shortcut.0.weight"], stride=stride))
    else:
        residual = x
    return _relu20(out + residual)


def _layers(cfg: SVConfig):
    """Per block: (prefix, in_planes, planes, width, stride, uses AFF, has a
    shortcut, ends layer 3), in the order the forward pass runs them."""
    in_planes = cfg.m_channels
    for li, (mult, n_blocks, use_aff) in enumerate(
            [(1, cfg.num_blocks[0], False), (2, cfg.num_blocks[1], False),
             (4, cfg.num_blocks[2], True), (8, cfg.num_blocks[3], True)]):
        planes = cfg.m_channels * mult
        width = int(math.floor(planes * (cfg.base_width / 64.0)))
        for bi in range(n_blocks):
            stride = (1 if li == 0 else 2) if bi == 0 else 1
            # the shortcut exists only where the stride or the width changes
            has_shortcut = stride != 1 or in_planes != cfg.expansion * planes
            yield (f"layer{li + 1}.{bi}.", in_planes, planes, width, stride, use_aff,
                   has_shortcut, li == 2 and bi == n_blocks - 1)
            in_planes = planes * cfg.expansion


def eres2netv2_features(p: Dict[str, torch.Tensor], feat: torch.Tensor,
                        cfg: SVConfig = SVConfig()) -> torch.Tensor:
    """feat [B, T, 80] → fused pre-pooling feature map [B, C, F, T']
    (``ERes2NetV2.py:230-240`` before the temporal mean)."""
    x = feat.transpose(1, 2)[:, None]  # [B, 1, F, T]
    # the stem's ReLU is unbounded; the blocks' is Hardtanh(0, 20)
    out = torch.relu(_bn(p, "bn1.", conv2d(x, p["conv1.weight"], padding=1)))
    out3 = None
    for pfx, _, _, width, stride, use_aff, has_shortcut, ends_layer3 in _layers(cfg):
        with span("gsv.voice.sv_emb.block", device=True):
            out = _basic_block(p, pfx, out, width, cfg.scale, stride, use_aff, has_shortcut)
        if ends_layer3:
            out3 = out
    with span("gsv.voice.sv_emb.fuse", device=True):
        out3_ds = conv2d(out3, p["layer3_ds.weight"], stride=2, padding=1)
        return _aff(p, "fuse34.", out, out3_ds)


def eres2netv2_forward3(p: Dict[str, torch.Tensor], feat: torch.Tensor,
                        cfg: SVConfig = SVConfig()) -> torch.Tensor:
    """feat [B, T, 80] → the fused feature map's mean over time in float32,
    flattened channel-major: [B, C·F] (``ERes2NetV2.py:230-241``)."""
    fused = eres2netv2_features(p, feat, cfg)
    return fused.float().mean(dim=-1).reshape(fused.shape[0], -1)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _aff_shapes(pfx: str, channels: int, r: int = 4) -> List[Tuple[str, tuple]]:
    inter = channels // r
    return [(pfx + "local_att.0.weight", (inter, 2 * channels, 1, 1)),
            (pfx + "local_att.0.bias", (inter,)),
            *_bn_shapes(pfx + "local_att.1.", inter),
            (pfx + "local_att.3.weight", (channels, inter, 1, 1)),
            (pfx + "local_att.3.bias", (channels,)),
            *_bn_shapes(pfx + "local_att.4.", channels)]


def _bn_shapes(pfx: str, c: int) -> List[Tuple[str, tuple]]:
    return [(pfx + k, (c,)) for k in ("weight", "bias", "running_mean", "running_var")]


def param_shapes(cfg: SVConfig = SVConfig()) -> Dict[str, tuple]:
    """The state-dict keys :func:`eres2netv2_features` reads, with their
    shapes (the reference module's, ``ERes2NetV2.py`` / ``fusion.py``)."""
    m, e = cfg.m_channels, cfg.expansion
    out = [("conv1.weight", (m, 1, 3, 3)), *_bn_shapes("bn1.", m)]
    for pfx, in_planes, planes, width, _, use_aff, has_shortcut, _ in _layers(cfg):
        ws = width * cfg.scale
        out += [(pfx + "conv1.weight", (ws, in_planes, 1, 1)), *_bn_shapes(pfx + "bn1.", ws)]
        for i in range(cfg.scale):
            out += [(f"{pfx}convs.{i}.weight", (width, width, 3, 3)),
                    *_bn_shapes(f"{pfx}bns.{i}.", width)]
        if use_aff:
            for i in range(cfg.scale - 1):
                out += _aff_shapes(f"{pfx}fuse_models.{i}.", width)
        out += [(pfx + "conv3.weight", (planes * e, ws, 1, 1)),
                *_bn_shapes(pfx + "bn3.", planes * e)]
        if has_shortcut:
            out += [(pfx + "shortcut.0.weight", (planes * e, in_planes, 1, 1)),
                    *_bn_shapes(pfx + "shortcut.1.", planes * e)]
    out += [("layer3_ds.weight", (m * 8 * e, m * 4 * e, 3, 3)),
            *_aff_shapes("fuse34.", m * 8 * e)]
    return dict(out)


def init_params(cfg: SVConfig, generator: torch.Generator, dtype=F32,
                device="cpu") -> Dict[str, torch.Tensor]:
    """Random ERes2NetV2 parameters with the reference keys and shapes, drawn
    on the CPU from ``generator``: convolutions N(0, 0.25/fan_in), AFF biases
    N(0, 0.1), BatchNorm weight U(0.5, 1.5), bias and running mean N(0, 0.1),
    running variance U(0.5, 1.5), so every statistic takes part.  (At
    N(0, 1/fan_in) the residual sums grow block by block until a quarter of
    the fused map sits on the blocks' clip at 20; at a quarter of that
    variance the embedding stays O(1).)"""
    p: Dict[str, torch.Tensor] = {}
    for k, shape in param_shapes(cfg).items():
        if len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            v = torch.randn(shape, generator=generator) * (0.5 / math.sqrt(fan_in))
        elif k.endswith(("running_var", ".weight")):
            v = 0.5 + torch.rand(shape, generator=generator)
        else:
            v = torch.randn(shape, generator=generator) * 0.1
        p[k] = v
    return {k: v.to(device=device, dtype=dtype) for k, v in p.items()}


def params_from_state_dict(sd: Dict[str, torch.Tensor], cfg: SVConfig = SVConfig(),
                           dtype=F32, device="cpu",
                           where: str = "the SV state dict") -> Dict[str, torch.Tensor]:
    """The keys :func:`eres2netv2_features` reads, cast and moved; raises
    ``KeyError`` naming the first such key that ``sd`` lacks.  Extra keys
    (the reference's pooling and embedding head, ``num_batches_tracked``)
    are dropped."""
    out = {}
    for k, shape in param_shapes(cfg).items():
        if k not in sd:
            raise KeyError(f"{where} has no {k!r} (ERes2NetV2 reads it)")
        v = torch.as_tensor(sd[k])
        if tuple(v.shape) != shape:
            raise ValueError(f"{where}: {k!r} has shape {tuple(v.shape)}, ERes2NetV2 "
                             f"reads {shape}")
        out[k] = v.to(device=device, dtype=dtype).contiguous()
    return out


class ERes2Net:
    """Facade mirroring the reference ``ERes2Net`` (``SV/sv.py``): loads a
    checkpoint (a flat state dict, through ``torch.load(weights_only=True)``)
    in the engine's device and dtype."""

    def __init__(self, sv_path, tts_config, cfg: SVConfig = SVConfig()):
        sd = torch.load(str(sv_path), map_location="cpu", weights_only=True)
        self.cfg = cfg
        self.device = torch.device(tts_config.device)
        self.dtype = tts_config.dtype
        self.params = params_from_state_dict(sd, cfg, dtype=self.dtype, device=self.device,
                                             where=str(sv_path))

    def compute_embedding3(self, wav) -> torch.Tensor:
        """wav [B, T] (or [T]) 16 kHz → [B, 20480] float32 on the engine's
        device: the fbank on the host, ERes2NetV2 in the engine's dtype, the
        temporal mean in float32."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        with span("gsv.voice.sv_emb.fbank"):
            feats = np.stack([kaldi_fbank(w) for w in wav])
            feat = torch.as_tensor(feats, device=self.device).to(self.dtype)
        with torch.no_grad():
            return eres2netv2_forward3(self.params, feat, self.cfg)
