"""Speaker-verification embedder: Kaldi fbank + ERes2NetV2 (counterpart of
``gsv_tts_tpu/models/sv.py``; reference ``GPT_SoVITS/SV``: ``sv.py``,
``ERes2NetV2.py``, ``fusion.py``).

80-bin Kaldi fbank (povey window, dither 0) → ERes2NetV2 (baseWidth 24,
scale 4, expansion 4) → ``forward3``: the fused pre-pooling feature map's
mean over time, a [B, 20480] float32 embedding.  v2Pro's ``sv_emb`` linear
and ``TTS.verify_speaker`` consume it.  The JAX package computes this in
XLA, outside any Pallas kernel, so the port is PyTorch.

:func:`kaldi_fbank` is host numpy, an own copy of the JAX package's, equal
to it bit for bit; :func:`torch_fbank` is its arithmetic in PyTorch, on the
wav's device, and is what the embedder runs.  On the card a single clip of
at most 1024 frames (10.24 s) runs as one CUDA graph of its frame-count
bucket (:data:`SV_BUCKETS`), the wav padded to the bucket and its frame
count a device tensor that masks the padding out of every 3×3 convolution
and of the temporal mean; the graphs are captured when the embedder loads.
Anything else (the CPU, a batch, a longer clip) runs the same functions
eagerly at the exact length.

Parameters are a flat dict keyed by the reference state-dict names.  The
JAX package has no ``init_params`` for them; :func:`param_shapes` is the
port's key/shape table, read off the forward pass.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.convs import batch_norm, conv2d
from ..utils.timing import span

F32 = torch.float32
#: the embedding's width at the published config: 2048 channels × 10 mel rows
#: (layer 4 is 8 × m_channels × expansion wide, the 80 mel rows halved three times)
EMBED_DIM = 20480
#: the frame counts of the embedder's CUDA graphs: clips of up to 10.24 s (the
#: reference project's 3-10 s reference audio) in steps of 128 frames
SV_BUCKETS = tuple(range(128, 1025, 128))
_WIN, _SHIFT, _NFFT = 400, 160, 512  # 25 ms, 10 ms and the FFT size at 16 kHz


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


def n_frames(n_samples: int) -> int:
    """The fbank's frame count for a clip of ``n_samples`` at 16 kHz."""
    return 0 if n_samples < _WIN else 1 + (n_samples - _WIN) // _SHIFT


def bucket_samples(frames: int) -> int:
    """The samples of a clip of exactly ``frames`` fbank frames."""
    return _WIN + _SHIFT * (frames - 1)


def sv_bucket(frames: int) -> Optional[int]:
    """The bucket of :data:`SV_BUCKETS` a clip of ``frames`` frames replays
    in, or None for a clip that runs eagerly (empty, or over 1024 frames)."""
    if not 0 < frames <= SV_BUCKETS[-1]:
        return None
    step = SV_BUCKETS[0]
    return -(-frames // step) * step


def fbank_constants(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`torch_fbank`'s povey window [400] and 80 mel banks [257, 80]
    (the Nyquist row zero), float64 on ``device``: built once, at load."""
    banks = np.pad(_kaldi_mel_banks(80, _NFFT, 16000), [(0, 0), (0, 1)])
    return (torch.as_tensor(_povey_window(_WIN), dtype=torch.float64, device=device),
            torch.as_tensor(banks.T, dtype=torch.float64, device=device))


def torch_fbank(wav: torch.Tensor, n_valid: Optional[torch.Tensor] = None,
                consts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """wav [B, T] → [B, frames, 80] float32 log-mel on wav's device:
    :func:`kaldi_fbank`'s arithmetic, float32 through the pre-emphasis and
    float64 from the window to the log, where numpy promotes it.  Frames at
    or past ``n_valid`` (valid frames, a device tensor [] or [B]) come out
    zero.  ``consts``: :func:`fbank_constants` on wav's device."""
    window, banks = fbank_constants(wav.device) if consts is None else consts
    if wav.shape[-1] < _WIN:
        return wav.new_zeros((wav.shape[0], 0, banks.shape[1]), dtype=F32)
    frames = wav.to(F32).unfold(-1, _WIN, _SHIFT)  # [B, frames, 400], snip edges
    frames = frames - frames.mean(dim=-1, keepdim=True)
    first = frames[..., :1]
    frames = torch.cat([first - 0.97 * first, frames[..., 1:] - 0.97 * frames[..., :-1]],
                       dim=-1)
    frames = F.pad(frames.double() * window, (0, _NFFT - _WIN))
    spec = torch.fft.rfft(frames, dim=-1).abs() ** 2  # power
    out = torch.log(torch.clamp_min(spec @ banks, float(np.finfo(np.float32).eps))).to(F32)
    if n_valid is not None:
        out = out * (torch.arange(out.shape[1], device=out.device)
                     < n_valid.reshape(-1, 1))[..., None]
    return out


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
                 has_shortcut: bool, mask: Optional[torch.Tensor] = None):
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
        sp = conv2d(_masked(sp, mask), p[f"{pfx}convs.{i}.weight"], padding=1)
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


def _masked(x, mask):
    return x if mask is None else x * mask


def _valid(length: torch.Tensor, stride: int) -> torch.Tensor:
    """The valid columns at ``stride``: ceil(length / stride), [B, 1, 1, 1]."""
    return (length.reshape(-1, 1, 1, 1) + stride - 1) // stride


def _time_masks(length: Optional[torch.Tensor], t: int, dtype) -> List[Optional[torch.Tensor]]:
    """Per stride 1, 2, 4, 8 (the stem and layer 1, layers 2, 3, 4): the
    [B, 1, 1, ceil(t / stride)] mask of the columns before ceil(length /
    stride), in ``dtype``; four Nones without a length."""
    if length is None:
        return [None] * 4
    return [(torch.arange(-(-t // s), device=length.device) < _valid(length, s)).to(dtype)
            for s in (1, 2, 4, 8)]


def eres2netv2_features(p: Dict[str, torch.Tensor], feat: torch.Tensor,
                        cfg: SVConfig = SVConfig(),
                        length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """feat [B, T, 80] → fused pre-pooling feature map [B, C, F, T']
    (``ERes2NetV2.py:230-240`` before the temporal mean).  With ``length``
    (valid frames, a device tensor [] or [B]) the input of every 3×3
    convolution is zeroed from ceil(length / 2^k) on, at its stage's
    resolution, so the first ceil(length / 8) columns of the map equal the
    exact-length run's: zero is what that run's convolutions read past its
    edge, and a strided 1×1 or 3×3 convolution keeps ceil(L / 2) valid
    outputs of L."""
    x = feat.transpose(1, 2)[:, None]  # [B, 1, F, T]
    masks = _time_masks(length, x.shape[-1], x.dtype)
    # the stem's ReLU is unbounded; the blocks' is Hardtanh(0, 20)
    out = torch.relu(_bn(p, "bn1.", conv2d(_masked(x, masks[0]), p["conv1.weight"],
                                           padding=1)))
    out3, stage = None, 0
    for pfx, _, _, width, stride, use_aff, has_shortcut, ends_layer3 in _layers(cfg):
        stage += stride == 2
        with span("gsv.voice.sv_emb.block", device=True):
            out = _basic_block(p, pfx, out, width, cfg.scale, stride, use_aff, has_shortcut,
                               masks[stage])
        if ends_layer3:
            out3 = out
    with span("gsv.voice.sv_emb.fuse", device=True):
        out3_ds = conv2d(_masked(out3, masks[2]), p["layer3_ds.weight"], stride=2, padding=1)
        return _aff(p, "fuse34.", out, out3_ds)


def eres2netv2_forward3(p: Dict[str, torch.Tensor], feat: torch.Tensor,
                        cfg: SVConfig = SVConfig(),
                        length: Optional[torch.Tensor] = None) -> torch.Tensor:
    """feat [B, T, 80] → the fused feature map's mean over time in float32,
    flattened channel-major: [B, C·F] (``ERes2NetV2.py:230-241``).  With
    ``length`` (see :func:`eres2netv2_features`) the mean is the masked sum
    over the valid count ceil(length / 8)."""
    fused = eres2netv2_features(p, feat, cfg, length).float()
    if length is None:
        return fused.mean(dim=-1).reshape(fused.shape[0], -1)
    n = _valid(length, 8)[..., 0]  # [B, 1, 1]
    keep = torch.arange(fused.shape[-1], device=fused.device) < n[..., None]
    return (torch.where(keep, fused, 0.0).sum(dim=-1) / n).reshape(fused.shape[0], -1)


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
    in the engine's device and dtype.  Given ``graphs`` (the facade's
    ``SovitsGraphs``) on the card, it captures one CUDA graph of the whole
    embedding per bucket of :data:`SV_BUCKETS` here, at load, so that no
    request pays a capture."""

    def __init__(self, sv_path, tts_config, cfg: SVConfig = SVConfig(), graphs=None):
        sd = torch.load(str(sv_path), map_location="cpu", weights_only=True)
        self.cfg = cfg
        self.device = torch.device(tts_config.device)
        self.dtype = tts_config.dtype
        self.params = params_from_state_dict(sd, cfg, dtype=self.dtype, device=self.device,
                                             where=str(sv_path))
        self.fbank_consts = fbank_constants(self.device)
        self.graphs = graphs if self.device.type == "cuda" else None
        if self.graphs is not None:
            with torch.no_grad():
                for frames in SV_BUCKETS:
                    self._replay(np.zeros(bucket_samples(frames), np.float32), frames)

    def _embed(self, wav: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        """One bucket's graph: wav [1, samples] → [1, 20480] float32."""
        feat = torch_fbank(wav, length, self.fbank_consts).to(self.dtype)
        return eres2netv2_forward3(self.params, feat, self.cfg, length)

    def _replay(self, wav: np.ndarray, frames: int) -> torch.Tensor:
        """wav [T] of ``frames`` frames, zero-padded (or cut past its last
        frame) to its bucket's samples, through the bucket's graph."""
        bucket = sv_bucket(frames)
        buf = np.zeros((1, bucket_samples(bucket)), np.float32)
        n = min(len(wav), buf.shape[1])
        buf[0, :n] = wav[:n]
        x = torch.from_numpy(buf).pin_memory().to(self.device, non_blocking=True)
        length = torch.full((), frames, dtype=torch.int64, device=self.device)
        return self.graphs.run(self.params, ("sv", bucket), self._embed, x, length)[0]

    def compute_embedding3(self, wav) -> torch.Tensor:
        """wav [B, T] (or [T]) 16 kHz → [B, 20480] float32 on the engine's
        device: the fbank in float32 and float64, ERes2NetV2 in the engine's
        dtype, the temporal mean in float32.  A single clip of at most 1024
        frames on the card replays its bucket's graph; anything else runs
        eagerly at the exact length."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        frames = n_frames(wav.shape[1])
        with torch.no_grad():
            if self.graphs is not None and wav.shape[0] == 1 and sv_bucket(frames):
                with span("gsv.voice.sv_emb.replay"):
                    return self._replay(wav[0], frames)
            with span("gsv.voice.sv_emb.eager"):
                with span("gsv.voice.sv_emb.fbank"):
                    feat = torch_fbank(torch.as_tensor(wav, device=self.device),
                                       consts=self.fbank_consts).to(self.dtype)
                return eres2netv2_forward3(self.params, feat, self.cfg)
