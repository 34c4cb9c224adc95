"""Plain float32 reference of GPT-SoVITS v4's SoVITS stage, written from the
equations of the upstream project (github.com/RVC-Boss/GPT-SoVITS:
``module/models.py:SynthesizerTrnV3`` with ``version="v4"`` and ``CFM``,
``f5_tts/model/backbones/dit.py``, ``f5_tts/model/modules.py``,
``TTS_infer_pack/TTS.py:using_vocoder_synthesis``).  It imports nothing of
the program; the parts v4 shares with v2 (the MRTE text encoder, ``WN``, the
style encoder, the HiFi-GAN generator) come from ``sovits_ref`` beside it.

Equations, at exact shapes with every mask ones:

* ``decode_encp``: codes → codebook vectors, ×2 nearest (50 Hz), the text
  encoder with ``ge``, ``bridge`` (1×1 conv 192→512, LeakyReLU 0.01), ×2
  nearest (100 Hz), ``wns1`` (1×1 ``pre``, an 8-layer ``WN`` of kernel 5
  conditioned on ``ge``, 1×1 ``proj``).
* the prompt mel: the 32 kHz clip reflect-padded by (1280 − 320) / 2, frames
  of 1280 every 320 under a periodic Hann window, |rfft| as sqrt(re² + im² +
  1e-6), the slaney filterbank of 100 mels, log of the product clamped at
  1e-5, then normalised to (m + 12) / 14 · 2 − 1.
* the CFM of a chunk: x = noise with its first P frames zero, ``cond`` the
  prompt mel there and zero after, d = 1 / steps; at each step j, t = j·d,
  x ← x + d·DiT(x, cond, fea, t, d), then x's first P frames zero again.
* the DiT: ``c = TE(t) + TE'(d)`` (a sinusoid of 256 at scale 1000, sines
  first, then Linear, SiLU, Linear); the text embedding ``fea + [cos | sin]``
  of base 10000 over its 512 channels, then ConvNeXt-V2 blocks (depthwise
  conv 7, LayerNorm 1e-6, Linear, exact GELU, GRN with its norm over time,
  Linear, residual); ``h = Linear(x ‖ cond ‖ text)``, ``h += Mish(Conv(Mish(
  Conv(h))))`` (kernel 31, 16 groups); each block ``[shift, scale, gate] × 2 =
  Linear(SiLU(c))``, ``h += gate·Attn(LN(h)(1 + scale) + shift)`` with q and k
  rotated in their first ``dim_head`` channels (pairs (2i, 2i + 1) at angle
  pos · 10000^(−2i / dim_head)) before the split into heads, then the
  feed-forward alike (tanh GELU); out ``Linear(LN(h)(1 + scale) + shift)``
  with (scale, shift) = ``Linear(SiLU(c))``.
* the vocoder: the HiFi-GAN generator at v4's widths on the denormalised mel
  ((x + 1) / 2 · 14 − 12).

Departures: the text embedding and ``TE'(d)`` are computed once a chunk (as
``use_conditioner_cache`` does upstream), the time embedding and every
modulation at each step; ``x`` is float32 throughout (upstream keeps it in
the model's dtype).  TF32 is off for every product here.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import sovits_ref, stft_ref
from .io import load_file
from .voice import VoiceReference, _matrices, read_wav

PFX = "cfm.estimator."
#: the published widths and chunking; a configuration's ``hps`` may name others
DIT = {"dim": 1024, "depth": 22, "heads": 16, "dim_head": 64, "ff_mult": 2, "mel_dim": 100,
       "text_dim": 512, "conv_layers": 4, "conv_mult": 2, "freq_embed_dim": 256,
       "conv_pos_kernel": 31, "conv_pos_groups": 16}
VOCODER = {"initial_channel": 100, "resblock_kernel_sizes": [3, 7, 11],
           "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
           "upsample_rates": [10, 6, 2, 2, 2], "upsample_initial_channel": 512,
           "upsample_kernel_sizes": [20, 12, 4, 4, 4]}
SPEC_MIN, SPEC_MAX = -12.0, 2.0


def strict():
    """No TF32 in any product of the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _lin(p, name, x):
    return x @ p[name + ".weight"].T + p[name + ".bias"]


def _ln(x, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps)


def _gelu_tanh(x):
    return 0.5 * x * (1 + torch.tanh(math.sqrt(2 / math.pi) * (x + 0.044715 * x ** 3)))


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def time_embedding(p, name, t: torch.Tensor, freq_dim: int) -> torch.Tensor:
    """t [B] → [B, dim]."""
    half = freq_dim // 2
    k = torch.arange(half, dtype=torch.float32, device=t.device)
    arg = 1000.0 * t[:, None] * torch.exp(-math.log(10000) * k / (half - 1))[None]
    s = torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)
    return _lin(p, f"{PFX}{name}.time_mlp.2", F.silu(_lin(p, f"{PFX}{name}.time_mlp.0", s)))


def text_embedding(p, c: dict, fea: torch.Tensor, zero_text: bool = False) -> torch.Tensor:
    """fea [1, T, text_dim] → [1, T, text_dim]."""
    T, Dt = fea.shape[1], c["text_dim"]
    if zero_text:
        fea = torch.zeros_like(fea)
    i = torch.arange(Dt // 2, dtype=torch.float32, device=fea.device)
    ang = torch.arange(T, dtype=torch.float32, device=fea.device)[:, None] * \
        (10000.0 ** (-2 * i / Dt))[None]
    x = fea + torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)[None]
    for b in range(c["conv_layers"]):
        q = f"{PFX}text_embed.text_blocks.{b}."
        h = F.conv1d(x.transpose(1, 2), p[q + "dwconv.weight"], p[q + "dwconv.bias"],
                     padding=3, groups=Dt).transpose(1, 2)
        h = _ln(h) * p[q + "norm.weight"] + p[q + "norm.bias"]
        h = F.gelu(_lin(p, q + "pwconv1", h))
        g = torch.sqrt((h ** 2).sum(dim=1, keepdim=True))
        h = p[q + "grn.gamma"] * (h * (g / (g.mean(dim=-1, keepdim=True) + 1e-6))) \
            + p[q + "grn.beta"] + h
        x = x + _lin(p, q + "pwconv2", h)
    return x


def rotate(x: torch.Tensor, n_rot: int, all_heads: bool = False, heads: int = 1):
    """x [1, T, D]: channel pairs (2i, 2i + 1) of the first ``n_rot``
    channels rotated by pos · 10000^(−2i / n_rot); ``all_heads`` rotates
    every head's channels alike (a planted departure for the tests)."""
    T = x.shape[1]
    if all_heads:
        y = x.reshape(1, T, heads, -1)
        return torch.stack([rotate(y[:, :, h], n_rot) for h in range(heads)], 2).reshape(x.shape)
    i = torch.arange(n_rot // 2, dtype=torch.float32, device=x.device)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * \
        (10000.0 ** (-2 * i / n_rot))[None]
    cos, sin = torch.cos(ang)[None], torch.sin(ang)[None]
    ev, od = x[..., 0:n_rot:2], x[..., 1:n_rot:2]
    out = x.clone()
    out[..., 0:n_rot:2] = ev * cos - od * sin
    out[..., 1:n_rot:2] = od * cos + ev * sin
    return out


def dit(p, c: dict, x, cond, text, cd, t: float, rot_all_heads: bool = False):
    """The velocity [1, T, mel_dim]: x, cond [1, T, mel_dim], text the text
    embedding, cd = TE'(d) [1, dim]."""
    D, H, dh = c["dim"], c["heads"], c["dim_head"]
    cvec = time_embedding(p, "time_embed", torch.tensor([t], device=x.device),
                          c["freq_embed_dim"]) + cd
    act = F.silu(cvec)
    h = _lin(p, PFX + "input_embed.proj", torch.cat([x, cond, text], dim=-1))
    g = h.transpose(1, 2)
    for j in (0, 2):
        q = f"{PFX}input_embed.conv_pos_embed.conv1d.{j}"
        g = _mish(F.conv1d(g, p[q + ".weight"], p[q + ".bias"],
                           padding=c["conv_pos_kernel"] // 2, groups=c["conv_pos_groups"]))
    h = h + g.transpose(1, 2)
    T = h.shape[1]
    for b in range(c["depth"]):
        q = f"{PFX}transformer_blocks.{b}."
        m = _lin(p, q + "attn_norm.linear", act)[0].reshape(6, D)
        a_in = _ln(h) * (1 + m[1]) + m[0]
        qq = rotate(_lin(p, q + "attn.to_q", a_in), dh, rot_all_heads, H)
        kk = rotate(_lin(p, q + "attn.to_k", a_in), dh, rot_all_heads, H)
        vv = _lin(p, q + "attn.to_v", a_in)
        qh, kh, vh = (z.reshape(T, H, dh).transpose(0, 1) for z in (qq, kk, vv))
        w = torch.softmax(torch.bmm(qh, kh.transpose(1, 2)) / math.sqrt(dh), dim=-1)
        att = torch.bmm(w, vh).transpose(0, 1).reshape(1, T, H * dh)
        h = h + m[2] * _lin(p, q + "attn.to_out.0", att)
        f_in = _ln(h) * (1 + m[4]) + m[3]
        h = h + m[5] * _lin(p, q + "ff.ff.2", _gelu_tanh(_lin(p, q + "ff.ff.0.0", f_in)))
    fin = _lin(p, PFX + "norm_out.linear", act)[0].reshape(2, D)
    return _lin(p, PFX + "proj_out", _ln(h) * (1 + fin[0]) + fin[1])


def cfm(p, c: dict, fea, prompt, noise, steps: int, drop_step: Optional[int] = None,
        zero_text: bool = False, rot_all_heads: bool = False) -> torch.Tensor:
    """One chunk: fea [1, text_dim, T], prompt [1, mel_dim, P], noise [1,
    mel_dim, T] → x [1, mel_dim, T].  ``drop_step``, ``zero_text`` and
    ``rot_all_heads`` plant departures for the tests."""
    strict()
    P = prompt.shape[-1]
    x = noise.float().transpose(1, 2).clone()
    x[:, :P] = 0
    cond = torch.zeros_like(x)
    cond[:, :P] = prompt.float().transpose(1, 2)
    text = text_embedding(p, c, fea.float().transpose(1, 2), zero_text)
    d = 1.0 / steps
    cd = time_embedding(p, "d_embed", torch.tensor([d], device=x.device), c["freq_embed_dim"])
    for j in range(steps):
        if j == drop_step:
            continue
        x = x + d * dit(p, c, x, cond, text, cd, j * d, rot_all_heads)
        x[:, :P] = 0
    return x.transpose(1, 2)


def prompt_mel(audio32k: np.ndarray, device) -> torch.Tensor:
    """The normalised v4 mel [1, 100, frames] of a 32 kHz clip [T]."""
    strict()
    n_fft, hop = 1280, 320
    x = torch.as_tensor(np.asarray(audio32k, np.float32), device=device)[None, None]
    x = F.pad(x, ((n_fft - hop) // 2, (n_fft - hop) // 2), mode="reflect")[0, 0]
    frames = x.unfold(0, n_fft, hop)
    win = 0.5 - 0.5 * torch.cos(2 * math.pi * torch.arange(n_fft, device=device) / n_fft)
    spec = torch.fft.rfft(frames * win, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6).T
    fb = torch.as_tensor(stft_ref.mel_filterbank(32000, n_fft, 100), device=device)
    mel = torch.log(torch.clamp(fb @ mag, min=1e-5))
    return ((mel - SPEC_MIN) / (SPEC_MAX - SPEC_MIN) * 2 - 1)[None]


def denorm(x):
    return (x + 1) / 2 * (SPEC_MAX - SPEC_MIN) + SPEC_MIN


def dit_config(hps: dict) -> dict:
    return dict(DIT, **(hps["model"].get("cfm") or {}))


def vocoder_config(hps: dict) -> sovits_ref.SovitsConfig:
    v = dict(VOCODER, **(hps.get("vocoder") or {}))
    return sovits_ref.SovitsConfig(
        inter_channels=v["initial_channel"],
        resblock_kernel_sizes=tuple(v["resblock_kernel_sizes"]),
        resblock_dilation_sizes=tuple(tuple(d) for d in v["resblock_dilation_sizes"]),
        upsample_rates=tuple(v["upsample_rates"]),
        upsample_initial_channel=v["upsample_initial_channel"],
        upsample_kernel_sizes=tuple(v["upsample_kernel_sizes"]), gin_channels=0)


def decode_encp(p, cfg: sovits_ref.SovitsConfig, n_wn: int, codes, phones, ge) -> torch.Tensor:
    """codes [n], phones [N] → fea [1, 512, 4n]."""
    strict()
    dev = ge.device
    codes = torch.as_tensor(np.asarray(codes, np.int64).reshape(1, 1, -1), device=dev)
    text = torch.as_tensor(np.asarray(phones, np.int64).reshape(1, -1), device=dev)
    q = sovits_ref.interpolate_nearest_2x(sovits_ref.quantizer_decode(p, codes, 1))
    y, _, _ = sovits_ref.text_encoder_infer(p, cfg, q, text, ge)
    fea = F.leaky_relu(F.conv1d(y, p["bridge.0.weight"], p["bridge.0.bias"]), 0.01)
    fea = torch.repeat_interleave(fea, 2, dim=-1)
    fea = F.conv1d(fea, p["wns1.pre.weight"], p["wns1.pre.bias"])
    fea = sovits_ref.wn(p, "wns1.enc.", fea, torch.ones_like(fea[:, :1]), n_wn,
                        fea.shape[1], 5, 1, g=ge)
    return F.conv1d(fea, p["wns1.proj.weight"], p["wns1.proj.bias"])


def _vocoder_state(sovits_dir: Path) -> Dict[str, torch.Tensor]:
    st = sovits_dir / "vocoder.safetensors"
    if st.exists():
        return load_file(st)
    return torch.load(str(sovits_dir / "vocoder.pth"), map_location="cpu", weights_only=True)


class V4Reference(VoiceReference):
    """The voice side (``ge``, the prompt's codes, from ``VoiceReference``),
    ``decode_encp``, the prompt mel, the CFM and the vocoder of a v4 SoVITS
    directory (``hps.json``, ``model.safetensors``, ``vocoder.pth``).
    ``weight_fn`` maps every matrix before use (the control)."""

    def __init__(self, sovits_dir, hubert_dir, device, weight_fn=None):
        strict()
        super().__init__(sovits_dir, hubert_dir, None, device, weight_fn=weight_fn)
        sovits_dir = Path(sovits_dir)
        self.dit_cfg = dit_config(self.hps)
        m = self.hps["model"]
        self.t_ref, self.t_chunk = m.get("t_ref", 500), m.get("t_chunk", 1000)
        self.steps = m.get("cfm_steps", 32)
        self.n_wn = 8
        self.voc_cfg = vocoder_config(self.hps)
        vsd = {"dec." + k: v for k, v in _vocoder_state(sovits_dir).items()}
        self.vp = _matrices(sovits_ref.params_from_torch_state_dict(vsd, device=device),
                            weight_fn)

    @torch.no_grad()
    def decode_encp(self, codes, phones, ge) -> torch.Tensor:
        return decode_encp(self.p, self.cfg, self.n_wn, codes, phones, ge.float())

    @torch.no_grad()
    def prompt_mel(self, prompt_wav) -> torch.Tensor:
        audio, sr = read_wav(prompt_wav)
        if sr != 32000:
            audio = stft_ref.resample(audio[None], sr, 32000)[0]
        return prompt_mel(audio, self.device)

    @torch.no_grad()
    def cfm(self, fea, prompt, noise, **plant) -> torch.Tensor:
        dev = self.device
        return cfm(self.p, self.dit_cfg, fea.to(dev), torch.as_tensor(prompt, device=dev),
                   torch.as_tensor(noise, device=dev), self.steps, **plant)

    @torch.no_grad()
    def vocode(self, mel) -> np.ndarray:
        """Denormalised mel [1, 100, F] → audio [480·F] float32."""
        strict()
        mel = torch.as_tensor(mel, device=self.device).float()
        return sovits_ref.generator(self.vp, self.voc_cfg, mel).reshape(-1).cpu().numpy()

    def chunking(self, fea_ref: torch.Tensor, mel0: torch.Tensor):
        """T_min and the prompt's (fea, mel) of the first chunk."""
        t_both = min(mel0.shape[-1], fea_ref.shape[-1])
        t_min = min(t_both, self.t_ref)
        return t_min, fea_ref[..., :t_both][..., -t_min:], mel0[..., :t_both][..., -t_min:]

