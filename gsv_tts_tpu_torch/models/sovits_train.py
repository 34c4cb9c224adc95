"""SoVITS (stage-2 VITS) fine-tuning: the training-only halves of the model
(counterpart of ``gsv_tts_tpu/models/sovits_train.py``).

The posterior encoder, the forward flow, the multi-period and scale
discriminators, the VITS losses and the two-optimizer GAN step, on top of
the inference stack in ``models/sovits.py`` (the same flat param dict,
torch-layout conv weights and upstream key names).  Gradients come from
``torch.autograd``; the optimizers are ``parallel/train.py:Optimizer``
(``torch.optim.AdamW`` behind optax's global-norm clip).

Training objective (upstream GPT-SoVITS s2 recipe):
  L_G = L1(mel(ŷ), mel(y))·c_mel + KL(z_p ‖ prior)·c_kl + L_fm·2 + L_adv
  L_D = LSGAN real/fake on the multi-period + scale discriminators

The RVQ codebook and its ``ssl_proj`` front stay frozen
(:data:`FROZEN_PREFIXES`): they define the semantic-token space the stage-1
GPT was trained against.  The caller keeps them out of the generator's
optimizer, which gives them zero updates, weight decay included.

Randomness is an input: the posterior noise and the uniform draws behind
the slice starts are arguments (:func:`sovits_draws` takes them from a
``torch.Generator``), so a test can hand the port JAX's own draws.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import stft as stft_ops
from ..ops.convs import conv1d, conv2d, interpolate_nearest_2x, leaky_relu
from . import sovits as sv

F32 = torch.float32
LRELU_SLOPE = 0.1

ENC_Q_LAYERS = 16  # upstream PosteriorEncoder(spec, inter, hidden, 5, 1, 16)
ENC_Q_KERNEL = 5
#: param-key prefixes excluded from fine-tune updates (see module docstring)
FROZEN_PREFIXES = ("quantizer.", "ssl_proj.")


def _leaky(x):
    return leaky_relu(x, LRELU_SLOPE)


# ---------------------------------------------------------------------------
# Posterior encoder (enc_q) — upstream ``modules.PosteriorEncoder``
# ---------------------------------------------------------------------------

def init_enc_q_params(cfg: sv.SovitsConfig, generator: torch.Generator, dtype=F32,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """Fresh ``enc_q.*`` params in upstream state-dict naming (weight norm
    folded), N(0, 1/fan_in) weights and zero biases as the JAX init draws
    them, drawn on the CPU from ``generator``."""
    H = cfg.hidden_channels

    def conv_w(out_ch, in_ch, k):
        return torch.randn((out_ch, in_ch, k), generator=generator) / math.sqrt(in_ch * k)

    p = {
        "enc_q.pre.weight": conv_w(H, cfg.spec_channels, 1),
        "enc_q.pre.bias": torch.zeros(H),
        "enc_q.proj.weight": conv_w(2 * cfg.inter_channels, H, 1),
        "enc_q.proj.bias": torch.zeros(2 * cfg.inter_channels),
        "enc_q.enc.cond_layer.weight": conv_w(2 * H * ENC_Q_LAYERS, cfg.gin_channels, 1),
        "enc_q.enc.cond_layer.bias": torch.zeros(2 * H * ENC_Q_LAYERS),
    }
    for i in range(ENC_Q_LAYERS):
        p[f"enc_q.enc.in_layers.{i}.weight"] = conv_w(2 * H, H, ENC_Q_KERNEL)
        p[f"enc_q.enc.in_layers.{i}.bias"] = torch.zeros(2 * H)
        out_ch = 2 * H if i < ENC_Q_LAYERS - 1 else H
        p[f"enc_q.enc.res_skip_layers.{i}.weight"] = conv_w(out_ch, H, 1)
        p[f"enc_q.enc.res_skip_layers.{i}.bias"] = torch.zeros(out_ch)
    return {k: v.to(device=device, dtype=dtype) for k, v in p.items()}


def posterior_encoder(p, cfg: sv.SovitsConfig, spec, spec_mask, ge, noise):
    """spec [B, spec_ch, T] → (z, m_q, logs_q); ``noise`` is standard normal
    shaped like m_q."""
    h = conv1d(spec, p["enc_q.pre.weight"], p["enc_q.pre.bias"]) * spec_mask
    h = sv.wn(p, "enc_q.enc.", h, spec_mask, ENC_Q_LAYERS, cfg.hidden_channels,
              ENC_Q_KERNEL, 1, g=ge)
    stats = conv1d(h, p["enc_q.proj.weight"], p["enc_q.proj.bias"]) * spec_mask
    m = stats[:, :cfg.inter_channels]
    logs = stats[:, cfg.inter_channels:]
    z = (m + noise * torch.exp(logs)) * spec_mask
    return z, m, logs


def flow_forward(p, cfg: sv.SovitsConfig, x, x_mask, g):
    """``ResidualCouplingBlock`` forward (z → z_p): couple then flip, flows in
    order — the inverse of ``sovits.flow_reverse`` (mean-only couplings, so
    no logdet term)."""
    half = cfg.inter_channels // 2
    for i in range(cfg.flow_n_flows):
        pfx = f"flow.flows.{i * 2}."
        x0, x1 = x[:, :half], x[:, half:]
        h = conv1d(x0, p[pfx + "pre.weight"], p[pfx + "pre.bias"]) * x_mask
        h = sv.wn(p, pfx + "enc.", h, x_mask, cfg.flow_n_layers, cfg.hidden_channels,
                  cfg.flow_kernel_size, 1, g=g)
        m = conv1d(h, p[pfx + "post.weight"], p[pfx + "post.bias"]) * x_mask
        x = torch.flip(torch.cat([x0, (m + x1) * x_mask], dim=1), dims=(1,))
    return x


# ---------------------------------------------------------------------------
# Mel loss front-end and random windows
# ---------------------------------------------------------------------------

def mel_spectrogram(audio, *, n_fft: int, hop_length: int, win_length: int, sr: int,
                    n_mels: int = 128, fmin: float = 0.0, fmax: Optional[float] = None):
    """log-mel for the reconstruction loss: magnitude STFT → slaney mel →
    log(clamp(·, 1e-5)) (upstream ``mel_processing.spectral_normalize``),
    float32."""
    spec = stft_ops.spectrogram(audio, n_fft, hop_length, win_length)
    fb = torch.as_tensor(stft_ops.mel_filterbank(sr, n_fft, n_mels, fmin, fmax),
                         device=spec.device)
    mel = torch.einsum("mf,...ft->...mt", fb, spec)
    return torch.log(torch.clamp(mel, min=1e-5))


def _windows(x, starts, size: int):
    """x [B, C, T] → [B, C, size], row b from ``starts[b]`` clamped into
    [0, T - size] as ``jax.lax.dynamic_slice`` clamps a window that runs
    past the end."""
    T = x.shape[-1]
    start = starts.clamp(0, max(T - size, 0))
    idx = start[:, None] + torch.arange(size, device=x.device)[None, :]
    return torch.gather(x, 2, idx[:, None, :].expand(-1, x.shape[1], -1))


def rand_slice_segments(x, lengths, segment_frames: int, u):
    """Per-row window of ``segment_frames`` frames from x [B, C, T]
    (upstream ``commons.rand_slice_segments``); ``u`` [B] uniform in [0, 1)
    picks the start, ``int(u · (max(len - seg, 0) + 1))`` in float32 as JAX
    computes it.  Returns (slices, ids)."""
    max_start = (lengths - segment_frames).clamp(min=0)
    ids = (u.float() * (max_start + 1).float()).to(torch.int64)
    return _windows(x, ids, segment_frames), ids


def slice_audio(wav, ids, segment_frames: int, hop_length: int):
    """Matching waveform windows [B, seg·hop] for :func:`rand_slice_segments` ids."""
    return _windows(wav[:, None], ids * hop_length, segment_frames * hop_length)[:, 0]


# ---------------------------------------------------------------------------
# Discriminators (multi-period + scale), fresh-initialized for fine-tuning
# ---------------------------------------------------------------------------

PERIODS = (2, 3, 5, 7, 11)
_P_CH = (1, 32, 128, 512, 1024, 1024)
_S_SPEC = (  # (out, in, kernel, stride, groups) per DiscriminatorS conv
    (16, 1, 15, 1, 1), (64, 16, 41, 4, 4), (256, 64, 41, 4, 16),
    (1024, 256, 41, 4, 64), (1024, 1024, 41, 4, 256), (1024, 1024, 5, 1, 1),
)


def init_discriminator_params(generator: torch.Generator, dtype=F32,
                              device="cpu") -> Dict[str, torch.Tensor]:
    """Multi-period (2, 3, 5, 7, 11) + scale discriminators, upstream
    topology, plain convs (no weight-norm parametrization), with the JAX
    init's scales, drawn on the CPU from ``generator``."""
    def w(shape, fan):
        return torch.randn(shape, generator=generator) * 0.02 / math.sqrt(max(fan / 64.0, 1.0))

    p: Dict[str, torch.Tensor] = {}
    for pi in range(len(PERIODS)):
        for i in range(5):
            cin, cout = _P_CH[i], _P_CH[i + 1]
            p[f"mpd.{pi}.convs.{i}.weight"] = w((cout, cin, 5, 1), cin * 5)
            p[f"mpd.{pi}.convs.{i}.bias"] = torch.zeros(cout)
        p[f"mpd.{pi}.post.weight"] = w((1, 1024, 3, 1), 1024 * 3)
        p[f"mpd.{pi}.post.bias"] = torch.zeros(1)
    for i, (cout, cin, k, _s, g) in enumerate(_S_SPEC):
        p[f"msd.convs.{i}.weight"] = w((cout, cin // g, k), cin * k // g)
        p[f"msd.convs.{i}.bias"] = torch.zeros(cout)
    p["msd.post.weight"] = w((1, 1024, 3), 1024 * 3)
    p["msd.post.bias"] = torch.zeros(1)
    return {k: v.to(device=device, dtype=dtype) for k, v in p.items()}


def _disc_p(p, pi: int, period: int, y):
    """DiscriminatorP forward: y [B, 1, T] → (logits, feature maps)."""
    B, _, T = y.shape
    pad = (-T) % period
    if pad:
        y = F.pad(y, (0, pad), mode="reflect")
        T = T + pad
    x = y.reshape(B, 1, T // period, period)
    fmap = []
    for i in range(5):
        stride = (3, 1) if i < 4 else (1, 1)
        x = _leaky(conv2d(x, p[f"mpd.{pi}.convs.{i}.weight"], p[f"mpd.{pi}.convs.{i}.bias"],
                          stride=stride, padding=(2, 0)))
        fmap.append(x)
    x = conv2d(x, p[f"mpd.{pi}.post.weight"], p[f"mpd.{pi}.post.bias"], padding=(1, 0))
    fmap.append(x)
    return x.reshape(B, -1), fmap


def _disc_s(p, y):
    """DiscriminatorS forward: y [B, 1, T] → (logits, feature maps)."""
    x = y
    fmap = []
    for i, (_cout, _cin, k, s, g) in enumerate(_S_SPEC):
        x = _leaky(conv1d(x, p[f"msd.convs.{i}.weight"], p[f"msd.convs.{i}.bias"],
                          stride=s, padding=k // 2, groups=g))
        fmap.append(x)
    x = conv1d(x, p["msd.post.weight"], p["msd.post.bias"], padding=1)
    fmap.append(x)
    return x.reshape(x.shape[0], -1), fmap


def discriminate(p, y):
    """All discriminators on y [B, 1, T] → (logits list, fmaps list), the
    scale discriminator first."""
    outs, fmaps = [], []
    o, f = _disc_s(p, y)
    outs.append(o)
    fmaps.append(f)
    for pi, period in enumerate(PERIODS):
        o, f = _disc_p(p, pi, period, y)
        outs.append(o)
        fmaps.append(f)
    return outs, fmaps


# ---------------------------------------------------------------------------
# Losses (upstream ``losses.py`` semantics), float32
# ---------------------------------------------------------------------------

def kl_loss(z_p, logs_q, m_p, logs_p, z_mask, frames=None):
    """Channel-summed KL averaged over valid frames (``sum(kl·mask) /
    sum(mask)`` with mask [B, 1, T]), the scale c_kl is calibrated to.
    ``frames``: the denominator in place of ``sum(mask)`` (the whole
    batch's, when this is one rank's rows)."""
    z_p, logs_q, m_p, logs_p = (t.float() for t in (z_p, logs_q, m_p, logs_p))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    frames = torch.sum(z_mask) if frames is None else frames
    return torch.sum(kl * z_mask) / torch.clamp(frames, min=1.0)


def feature_loss(fmaps_real, fmaps_fake):
    loss = 0.0
    for fr, ff in zip(fmaps_real, fmaps_fake):
        for r, f in zip(fr, ff):
            loss = loss + torch.mean(torch.abs(r.detach().float() - f.float()))
    return loss * 2.0


def generator_adv_loss(disc_fake_outs):
    return sum(torch.mean((1.0 - d.float()) ** 2) for d in disc_fake_outs)


def discriminator_loss(disc_real_outs, disc_fake_outs):
    loss = 0.0
    for dr, df in zip(disc_real_outs, disc_fake_outs):
        loss = loss + torch.mean((1.0 - dr.float()) ** 2) + torch.mean(df.float() ** 2)
    return loss


# ---------------------------------------------------------------------------
# Training forward + two-optimizer step
# ---------------------------------------------------------------------------

def train_forward(params, cfg: sv.SovitsConfig, batch, noise):
    """Upstream ``SynthesizerTrn.forward`` with a frozen RVQ: ssl → (frozen)
    codes → text encoder prior; spec → posterior z; z → flow → z_p.  ``noise``
    [B, inter, T] is the posterior's standard-normal draw.  Returns the
    pieces the losses and the generator need.

    batch (:func:`pad_sovits_batch`): ssl [B, 768, T], spec [B, spec_ch, T],
    wav [B, T·hop], text [B, N], spec_lens [B], text_lens [B], and for v2Pro
    sv_emb [B, 20480], fused into ``ge`` as inference fuses it."""
    spec = batch["spec"]
    B, _, T = spec.shape
    dev = spec.device
    y_mask = (torch.arange(T, device=dev)[None, None, :]
              < batch["spec_lens"][:, None, None]).to(spec.dtype)
    text_mask = (torch.arange(batch["text"].shape[1], device=dev)[None, None, :]
                 < batch["text_lens"][:, None, None]).to(spec.dtype)
    ge = sv.get_ge(params, cfg, spec, sv_emb=batch.get("sv_emb"), refer_mask=y_mask)

    # frozen semantic tokens: ssl → codes [B, n_q, T'] → codebook rows [B, D, T'] at 50 Hz
    with torch.no_grad():
        codes = sv.extract_latent(params, batch["ssl"])
        quantized = sv.quantizer_decode(params, codes.transpose(0, 1), cfg.quantizer_n_q)
        quantized = interpolate_nearest_2x(quantized)[:, :, :T]
        quantized = F.pad(quantized, (0, T - quantized.shape[-1]))

    y_latent, y_mask, _attn = sv.text_encoder_infer(
        params, cfg, quantized, batch["text"], sv.ge_for_mrte(params, cfg, ge),
        y_mask=y_mask, text_mask=text_mask)
    m_p, logs_p = sv.project_latent(params, cfg, y_latent, y_mask)
    z, m_q, logs_q = posterior_encoder(params, cfg, spec, y_mask, ge, noise.to(spec.dtype))
    z_p = flow_forward(params, cfg, z, y_mask, ge)
    return dict(z=z, z_p=z_p, m_p=m_p, logs_p=logs_p, m_q=m_q, logs_q=logs_q,
                y_mask=y_mask, ge=ge)


def sovits_draws(cfg: sv.SovitsConfig, batch, generator: torch.Generator):
    """One step's randomness from ``generator`` (on the batch's device): the
    posterior noise [B, inter, T], then the slice draws [B]."""
    B, _, T = batch["spec"].shape
    dev = batch["spec"].device
    noise = torch.randn((B, cfg.inter_channels, T), generator=generator, device=dev)
    u = torch.rand((B,), generator=generator, device=dev)
    return noise, u


def make_sovits_train_step(cfg: sv.SovitsConfig, g_optimizer, d_optimizer, *,
                           n_fft: int, hop_length: int, win_length: int, sr: int,
                           segment_frames: int, n_mels: int = 128,
                           c_mel: float = 45.0, c_kl: float = 1.0, dp_group=None):
    """Returns ``step(g_params, d_params, batch, noise, u) → metrics``: the D
    update on the detached ŷ, then the G update (mel + KL + feature matching +
    adversarial) against the updated D — the upstream s2 loop order.  Both
    phases share one generator forward, as JAX's two phases share one noise
    draw.  ``g_optimizer`` holds the generator's trainable leaves (the frozen
    prefixes left out), ``d_optimizer`` the discriminators'; both update the
    dicts' tensors in place.

    ``dp_group``: ``batch``, ``noise`` and ``u`` are this rank's rows of the
    whole batch (equal rows on every rank), the optimizers sum their
    gradients over the group (``parallel/train.py:GradSync``), and the
    losses are the whole batch's: each mean over equal pieces divided by the
    group's size, the KL over the frames summed over the group.  The metrics
    are the whole batch's on every rank."""
    from ..parallel.train import all_sum

    n = 1 if dp_group is None else torch.distributed.get_world_size(dp_group)

    def mel(a):
        return mel_spectrogram(a, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                               sr=sr, n_mels=n_mels)

    def step(g_params, d_params, batch, noise, u):
        out = train_forward(g_params, cfg, batch, noise)
        z_slice, ids = rand_slice_segments(out["z"], batch["spec_lens"], segment_frames, u)
        y_hat = sv.generator(g_params, cfg, z_slice, g=out["ge"])[:, 0]
        y = slice_audio(batch["wav"], ids, segment_frames, hop_length)

        real_outs, _ = discriminate(d_params, y[:, None])
        fake_outs, _ = discriminate(d_params, y_hat.detach()[:, None])
        d_loss = discriminator_loss(real_outs, fake_outs) / n
        d_optimizer.update(d_loss)

        l_mel = torch.mean(torch.abs(mel(y_hat) - mel(y))) * c_mel / n
        frames = all_sum(torch.sum(out["y_mask"]), dp_group)
        l_kl = kl_loss(out["z_p"], out["logs_q"], out["m_p"], out["logs_p"],
                       out["y_mask"], frames) * c_kl
        real_outs, real_fmaps = discriminate(d_params, y[:, None])
        fake_outs, fake_fmaps = discriminate(d_params, y_hat[:, None])
        l_fm = feature_loss(real_fmaps, fake_fmaps) / n
        l_adv = generator_adv_loss(fake_outs) / n
        g_loss = l_mel + l_kl + l_fm + l_adv
        g_optimizer.update(g_loss)
        return {k: all_sum(v.detach(), dp_group)
                for k, v in dict(mel=l_mel, kl=l_kl, fm=l_fm, adv=l_adv,
                                 g_total=g_loss, d_total=d_loss).items()}

    return step


def pad_sovits_batch(cfg: sv.SovitsConfig, samples, hop_length: int, pad_multiple: int = 32,
                     device="cpu"):
    """Collate [(ssl [768, T50], spec [spec_ch, T], wav [T·hop], text
    [, sv_emb [D]]), ...] (numpy) into the padded dict :func:`train_forward`
    consumes, on ``device``: frames padded to a multiple of ``pad_multiple``,
    phones to a multiple of 8.  v2Pro samples carry a 5th element, their own
    ERes2NetV2 embedding, which becomes ``batch["sv_emb"]``: a v2Pro batch
    without one per sample raises."""
    B = len(samples)
    T = max(s[1].shape[-1] for s in samples)
    T = -(-T // pad_multiple) * pad_multiple
    N = max(len(s[3]) for s in samples)
    N = -(-N // 8) * 8
    ssl = np.zeros((B, samples[0][0].shape[0], T), np.float32)  # 50 Hz, as spec
    spec = np.zeros((B, samples[0][1].shape[0], T), np.float32)
    wav = np.zeros((B, T * hop_length), np.float32)
    text = np.zeros((B, N), np.int64)
    spec_lens = np.zeros((B,), np.int64)
    text_lens = np.zeros((B,), np.int64)
    sv_embs = []
    for i, sample in enumerate(samples):
        s, sp, w, t = sample[:4]
        Ls = min(s.shape[-1], T)
        ssl[i, :, :Ls] = s[:, :Ls]
        spec[i, :, :sp.shape[-1]] = sp
        wav[i, :len(w)] = w[:wav.shape[-1]]
        spec_lens[i] = sp.shape[-1]
        text[i, :len(t)] = t
        text_lens[i] = len(t)
        if len(sample) > 4 and sample[4] is not None:
            sv_embs.append(np.asarray(sample[4], np.float32))
    if cfg.is_v2pro and len(sv_embs) != B:
        raise ValueError(
            "v2Pro fine-tune needs a per-sample sv_emb (featurize_sovits computes it); got "
            f"{len(sv_embs)}/{B} samples with one")
    out = {"ssl": ssl, "spec": spec, "wav": wav, "text": text, "spec_lens": spec_lens,
           "text_lens": text_lens}
    if len(sv_embs) == B:
        out["sv_emb"] = np.stack(sv_embs)
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}
