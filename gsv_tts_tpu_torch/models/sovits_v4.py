"""GPT-SoVITS v4's SoVITS stage (reference ``GPT_SoVITS/module/models.py:
SynthesizerTrnV3`` with ``version="v4"`` and ``TTS_infer_pack/TTS.py:
using_vocoder_synthesis``).

``decode_encp``: the RVQ codes upsampled ×2 to 50 Hz, v2's MRTE text
encoder (``sovits.text_encoder_infer``), ``bridge`` (Conv1d 192→512,
LeakyReLU 0.01), ×2 nearest to 100 Hz, and ``wns1`` (``pre``, an 8-layer
``WN`` of kernel 5 conditioned on ``ge``, ``proj``): the conditioning ``fea``
[1, 512, 4n] of the flow-matching decoder (``models/cfm.py``).  ``ge`` is
v2's style vector of the speaker clip's linear spectrogram.  The 48 kHz
vocoder is v2's HiFi-GAN ``generator`` at its own widths (100 mel channels
in, ``upsample_rates`` 10·6·2·2·2 = 480 samples a frame, a biased
``conv_post``), its parameters kept under ``dec.`` as v2's are.
``decode_encp`` runs at exact lengths (all masks ones); its padded twin
:func:`decode_encp_padded` runs at a bucket of :func:`encp_buckets` with the
lengths as device tensors, masked so that its valid frames are the exact
function's (the facade replays one CUDA graph of it per bucket).  The facade
vocodes at a frame bucket with every layer cut at the mel's frames
(:func:`vocode`'s ``frames``), which gives the audio of the mel's own length.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.convs import conv1d, interpolate_nearest_2x, leaky_relu
from . import cfm
from . import sovits as sovits_model
from .sovits import SovitsConfig

VERSION = "v4"
#: the vocoder ``TTS.py:init_vocoder`` builds for v4
VOCODER = {"initial_channel": 100, "resblock_kernel_sizes": [3, 7, 11],
           "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
           "upsample_rates": [10, 6, 2, 2, 2], "upsample_initial_channel": 512,
           "upsample_kernel_sizes": [20, 12, 4, 4, 4]}


def vocoder_config(voc: Dict[str, Any]) -> SovitsConfig:
    """The ``generator`` widths of a vocoder description like :data:`VOCODER`."""
    return SovitsConfig(inter_channels=voc["initial_channel"],
                        resblock_kernel_sizes=tuple(voc["resblock_kernel_sizes"]),
                        resblock_dilation_sizes=tuple(
                            tuple(d) for d in voc["resblock_dilation_sizes"]),
                        upsample_rates=tuple(voc["upsample_rates"]),
                        upsample_initial_channel=voc["upsample_initial_channel"],
                        upsample_kernel_sizes=tuple(voc["upsample_kernel_sizes"]),
                        gin_channels=0)


@dataclasses.dataclass(frozen=True)
class V4Config:
    """The v4 stage beyond v2's widths: the DiT, the vocoder, ``wns1``, the
    v4 mel of the prompt clip (``ops/stft.py:mel_v4``) and the chunking of
    ``using_vocoder_synthesis`` (``T_ref``, ``T_chunk``, ``sample_steps``)."""

    dit: cfm.DiTConfig = cfm.DiTConfig()
    vocoder: SovitsConfig = dataclasses.field(default_factory=lambda: vocoder_config(VOCODER))
    bridge_channels: int = 512
    wns1_layers: int = 8
    wns1_kernel: int = 5
    samplerate: int = 48000
    mel_rate: int = 32000
    n_fft: int = 1280
    hop: int = 320
    spec_min: float = -12.0
    spec_max: float = 2.0
    t_ref: int = 500
    t_chunk: int = 1000
    steps: int = 32

    @classmethod
    def from_hps(cls, hps: Dict[str, Any]) -> "V4Config":
        """From a v4 ``hps.json``: the published widths and chunking, or those
        its ``model.cfm`` block, ``model.t_ref``, ``model.t_chunk``,
        ``model.cfm_steps`` and top-level ``vocoder`` block name (smaller test
        models)."""
        m = hps["model"]
        dit = cfm.DiTConfig.from_dict(m.get("cfm"))
        return cls(dit=dit, vocoder=vocoder_config(dict(VOCODER, **(hps.get("vocoder") or {}))),
                   bridge_channels=dit.text_dim, t_ref=m.get("t_ref", cls.t_ref),
                   t_chunk=m.get("t_chunk", cls.t_chunk), steps=m.get("cfm_steps", cls.steps))

    def norm(self, mel):
        return (mel - self.spec_min) / (self.spec_max - self.spec_min) * 2 - 1

    def denorm(self, x):
        return (x + 1) / 2 * (self.spec_max - self.spec_min) + self.spec_min


def decode_encp(p, cfg: SovitsConfig, v4: V4Config, codes, text, ge):
    """``SynthesizerTrnV3.decode_encp`` at speed 1: codes [1, 1, n], text
    [1, N], ge [1, gin, 1] → (fea [1, bridge, 4n], MRTE attention [1, 4, 2n,
    N])."""
    quantized = interpolate_nearest_2x(sovits_model.quantizer_decode(p, codes, cfg.quantizer_n_q))
    y, _, attn = sovits_model.text_encoder_infer(p, cfg, quantized, text, ge)
    fea = leaky_relu(conv1d(y, p["bridge.0.weight"], p["bridge.0.bias"]), 0.01)
    fea = interpolate_nearest_2x(fea)
    mask = torch.ones_like(fea[:, :1])
    fea = conv1d(fea, p["wns1.pre.weight"], p["wns1.pre.bias"])
    fea = sovits_model.wn(p, "wns1.enc.", fea, mask, v4.wns1_layers, v4.bridge_channels,
                          v4.wns1_kernel, 1, g=ge)
    return conv1d(fea, p["wns1.proj.weight"], p["wns1.proj.bias"]), attn


def _wns1(p, v4: V4Config, fea, mask, ge):
    """``wns1`` (upstream's ``Encoder``) on the 100 Hz features, ``mask`` [1,
    1, T] their valid frames: ``pre``, masked before the WN's first kernel-5
    convolution reads it, the WN, ``proj``."""
    fea = conv1d(fea, p["wns1.pre.weight"], p["wns1.pre.bias"]) * mask
    fea = sovits_model.wn(p, "wns1.enc.", fea, mask, v4.wns1_layers, v4.bridge_channels,
                          v4.wns1_kernel, 1, g=ge)
    return conv1d(fea, p["wns1.proj.weight"], p["wns1.proj.bias"])


def decode_encp_padded(p, cfg: SovitsConfig, v4: V4Config, codes_pad, codes_len, text_pad,
                       text_len, ge):
    """:func:`decode_encp` on codes right-padded to ``codes_pad`` [1, 1, Bc]
    and phones to ``text_pad`` [1, Np], their lengths ``codes_len`` and
    ``text_len`` 0-dim int64 device tensors, so that one program (one CUDA
    graph) serves every length of the bucket.  v2's masked text encoder (as
    :func:`sovits.decode_core_stream_padded_batch` runs it), then the 100 Hz
    mask on ``bridge``'s output and inside ``wns1`` (:func:`_wns1`): a padded
    frame is zero wherever the exact computation's convolutions see their
    zero padding.  Returns (fea [1, bridge, 4·Bc], MRTE attention [1, 4,
    2·Bc, Np]), equal to the exact function's over the first 4·n frames and
    the first 2·n rows and N columns."""
    dev = codes_pad.device
    quantized = interpolate_nearest_2x(sovits_model.quantizer_decode(p, codes_pad,
                                                                     cfg.quantizer_n_q))
    y_mask = (torch.arange(quantized.shape[-1], device=dev) < 2 * codes_len)
    y_mask = y_mask.to(quantized.dtype)[None, None]
    text_mask = (torch.arange(text_pad.shape[-1], device=dev) < text_len)
    text_mask = text_mask.to(quantized.dtype)[None, None]
    y, _, attn = sovits_model.text_encoder_infer(p, cfg, quantized, text_pad, ge,
                                                 y_mask=y_mask, text_mask=text_mask)
    fea = leaky_relu(conv1d(y, p["bridge.0.weight"], p["bridge.0.bias"]), 0.01)
    mask = interpolate_nearest_2x(y_mask)
    fea = interpolate_nearest_2x(fea) * mask
    return _wns1(p, v4, fea, mask, ge), attn


def encp_buckets(top: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The (codes, phones) widths :func:`decode_encp_padded` runs at when no
    t2s sequence passes ``top`` tokens (a request's codes and either clip's
    phones lie inside one): codes in four equal steps up to ``top``, phones
    at the first step and at ``top``, each a multiple of 32; none for
    ``top`` 0."""
    mult = sovits_model.STREAM_PAD_MULTIPLE
    top = -(-top // mult) * mult
    if top <= 0:
        return (), ()
    step = -(-top // (4 * mult)) * mult
    return tuple(range(step, top, step)) + (top,), tuple(sorted({step, top}))


def encp_bucket(buckets, n: int, N: int) -> Optional[Tuple[int, int]]:
    """The smallest (Bc, Np) of :func:`encp_buckets`' ``buckets`` that holds
    n codes and N phones, None where none does."""
    codes, phones = buckets
    Bc = next((b for b in codes if b >= n), None)
    Np = next((b for b in phones if b >= N), None)
    return None if Bc is None or Np is None else (Bc, Np)


def vocode(vp, v4: V4Config, mel, frames=None):
    """The 48 kHz vocoder: denormalised log-mel [1, 100, F] → audio [1, 1,
    480·F]; with ``frames`` (a tensor [1]) the first 480·frames samples are
    the vocoder's of the first ``frames`` frames alone (``generator``)."""
    return sovits_model.generator(vp, v4.vocoder, mel, frames=frames)


def vocoder_params(state_dict: Dict[str, Any], dtype, device) -> Dict[str, torch.Tensor]:
    """``vocoder.pth``'s state dict (the ``Generator``'s own names, weight
    norm removed or not) under ``dec.``, as ``sovits.generator`` reads it."""
    p = sovits_model.params_from_torch_state_dict(state_dict, dtype=dtype, device=device)
    return {"dec." + k: v for k, v in p.items()}


def init_params(cfg: SovitsConfig, v4: V4Config, generator: torch.Generator,
                scale: float = 0.05) -> Dict[str, torch.Tensor]:
    """Random v4 SoVITS parameters (float32, CPU) under the checkpoint's
    names: v2's text encoder, style encoder and quantizer at
    ``sovits.init_params``' scale, ``bridge``, ``wns1``, ``linear_mel`` (kept
    by checkpoints, unused at inference) and the DiT (``cfm.init_params``)."""
    p = {k: v for k, v in sovits_model.init_params(cfg, generator, scale=scale).items()
         if not k.startswith(("dec.", "flow."))}
    C, B = cfg.hidden_channels, v4.bridge_channels

    def conv(name, out_c, in_c, k):
        p[name + ".weight"] = torch.randn((out_c, in_c, k), generator=generator) * scale
        p[name + ".bias"] = torch.zeros(out_c)

    conv("bridge.0", B, C, 1)
    conv("wns1.pre", B, B, 1)
    conv("wns1.enc.cond_layer", 2 * B * v4.wns1_layers, cfg.gin_channels, 1)
    for j in range(v4.wns1_layers):
        conv(f"wns1.enc.in_layers.{j}", 2 * B, B, v4.wns1_kernel)
        conv(f"wns1.enc.res_skip_layers.{j}", 2 * B if j < v4.wns1_layers - 1 else B, B, 1)
    conv("wns1.proj", B, B, 1)
    conv("linear_mel", v4.dit.mel_dim, B, 1)
    p.update(cfm.init_params(v4.dit, generator))
    return p


def init_vocoder(v4: V4Config, generator: torch.Generator,
                 scale: float = 0.05) -> Dict[str, torch.Tensor]:
    """Random vocoder parameters under ``vocoder.pth``'s names (no ``dec.``),
    float32 on the CPU, N(0, ``scale``) as ``sovits.init_params`` draws v2's."""
    vc = v4.vocoder
    p: Dict[str, torch.Tensor] = {}

    def conv(name, shape):
        p[name + ".weight"] = torch.randn(shape, generator=generator) * scale
        p[name + ".bias"] = torch.zeros(shape[0] if not name.startswith("ups.") else shape[1])

    ch0 = vc.upsample_initial_channel
    conv("conv_pre", (ch0, vc.inter_channels, 7))
    nk = len(vc.resblock_kernel_sizes)
    for i, k in enumerate(vc.upsample_kernel_sizes):
        c_in, c_out = ch0 // (2 ** i), ch0 // (2 ** (i + 1))
        conv(f"ups.{i}", (c_in, c_out, k))
        for j, (rk, rd) in enumerate(zip(vc.resblock_kernel_sizes, vc.resblock_dilation_sizes)):
            for m in range(len(rd)):
                conv(f"resblocks.{i * nk + j}.convs1.{m}", (c_out, c_out, rk))
                conv(f"resblocks.{i * nk + j}.convs2.{m}", (c_out, c_out, rk))
    conv("conv_post", (1, ch0 // (2 ** len(vc.upsample_rates)), 7))
    return p

