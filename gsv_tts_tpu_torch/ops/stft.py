"""Linear spectrogram, mel filterbank, the log-mel parity metric and
polyphase resampling (counterpart of ``gsv_tts_tpu/ops/stft.py``):
torchaudio ``Spectrogram(center=True, pad_mode='reflect', power=1)``
semantics, the slaney mel filterbank of the SoVITS mel loss,
``mel_spectrogram`` / ``mel_distance`` (numpy in and out, the spectrogram on
the card unless ``device="cpu"``), GPT-SoVITS v4's prompt mel
(``mel_v4``), and torchaudio-compatible windowed-sinc ``Resample`` (host
numpy)."""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def spectrogram(audio: torch.Tensor, n_fft: int, hop_length: int,
                win_length: int, power: float = 1.0) -> torch.Tensor:
    """Magnitude STFT raised to ``power``.  audio [B, T] → [B, n_fft//2+1,
    frames], float32.  Differentiable: the gradient of ``abs`` is zero at a
    zero bin, as JAX's ``jnp.abs`` of a complex zero gives it."""
    window = torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                               device=audio.device)
    spec = torch.stft(audio.float(), n_fft, hop_length=hop_length,
                      win_length=win_length, window=window, center=True,
                      pad_mode="reflect", return_complex=True)
    mag = spec.abs()
    if power != 1.0:
        mag = mag ** power
    return mag


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None) -> np.ndarray:
    """Slaney-style mel filterbank (librosa default, area-normalized),
    [n_mels, n_fft//2+1] float32."""
    fmax = fmax or sr / 2

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        return np.where(log_region,
                        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
                        mel)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    freqs = mel_to_hz(mels)
    fft_freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    fb = np.zeros((n_mels, n_fft // 2 + 1))
    for i in range(n_mels):
        lo, cen, hi = freqs[i], freqs[i + 1], freqs[i + 2]
        up = (fft_freqs - lo) / max(cen - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - cen, 1e-10)
        fb[i] = np.maximum(0, np.minimum(up, down))
        fb[i] *= 2.0 / (hi - lo)  # slaney area normalization
    return fb.astype(np.float32)


def mel_v4(audio: torch.Tensor, sr: int = 32000, n_fft: int = 1280, hop: int = 320,
           n_mels: int = 100) -> torch.Tensor:
    """GPT-SoVITS v4's mel of a prompt clip (``mel_spectrogram_torch`` with
    ``center=False``, as ``TTS.py``'s ``mel_fn_v4`` calls it): the audio
    reflect-padded by (n_fft − hop) / 2 each side, a Hann STFT, magnitudes
    sqrt(re² + im² + 1e-6), the slaney filterbank (fmax sr / 2) and the log
    of the product clamped at 1e-5.  audio [B, T] at ``sr`` → [B, n_mels,
    T // hop] float32, not yet normalised."""
    pad = (n_fft - hop) // 2
    x = F.pad(audio.float()[:, None], (pad, pad), mode="reflect")[:, 0]
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float32, device=audio.device)
    spec = torch.stft(x, n_fft, hop_length=hop, win_length=n_fft, window=window,
                      center=False, return_complex=True)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)
    fb = torch.as_tensor(mel_filterbank(sr, n_fft, n_mels), device=audio.device)
    return torch.log(torch.clamp(fb @ mag, min=1e-5))


def mel_spectrogram(audio: np.ndarray, sr: int = 32000, n_fft: int = 2048,
                    hop_length: int = 640, win_length: int = 2048, n_mels: int = 128,
                    fmin: float = 0.0, fmax: Optional[float] = None,
                    device=None) -> np.ndarray:
    """Log-mel of the mel-parity metric: audio [T] numpy → [n_mels, frames]
    numpy.  The spectrogram runs on ``device`` (the card unless ``"cpu"``),
    the filterbank product on the host."""
    x = torch.as_tensor(np.asarray(audio, np.float32)[None], device=device or "cuda")
    spec = spectrogram(x, n_fft, hop_length, win_length)[0].cpu().numpy()
    mel = mel_filterbank(sr, n_fft, n_mels, fmin, fmax) @ spec
    return np.log(np.clip(mel, 1e-5, None))


def mel_distance(a: np.ndarray, b: np.ndarray, sr: int = 32000, device=None) -> float:
    """Mean absolute log-mel distance between two waveforms, truncated to the
    shorter one (the JAX package's audio-parity metric)."""
    n = min(len(a), len(b))
    ma = mel_spectrogram(np.asarray(a[:n], np.float32), sr, device=device)
    mb = mel_spectrogram(np.asarray(b[:n], np.float32), sr, device=device)
    return float(np.mean(np.abs(ma - mb)))


@lru_cache(maxsize=32)
def _sinc_resample_kernel(orig_freq: int, new_freq: int,
                          lowpass_filter_width: int = 6, rolloff: float = 0.99):
    gcd = math.gcd(orig_freq, new_freq)
    orig = orig_freq // gcd
    new = new_freq // gcd
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    t = np.arange(0, -new, -1, dtype=np.float64)[:, None] / new + idx
    t = np.clip(t * base_freq, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = kernel * window * (base_freq / orig)
    return kernel.astype(np.float32), width, orig, new


def resample(audio: np.ndarray, orig_freq: int, new_freq: int) -> np.ndarray:
    """torchaudio.transforms.Resample equivalent.  audio [..., T] numpy."""
    if orig_freq == new_freq:
        return audio
    kernel, width, orig, new = _sinc_resample_kernel(orig_freq, new_freq)
    shape = audio.shape
    x = np.asarray(audio, np.float32).reshape(-1, shape[-1])
    target_len = int(math.ceil(new * shape[-1] / orig))
    x = np.pad(x, [(0, 0), (width, width + orig)])
    n_frames = (x.shape[-1] - kernel.shape[-1]) // orig + 1
    strides = (x.strides[0], orig * x.strides[-1], x.strides[-1])
    frames = np.lib.stride_tricks.as_strided(
        x, shape=(x.shape[0], n_frames, kernel.shape[-1]), strides=strides)
    out = np.einsum("bfk,pk->bpf", frames, kernel)
    out = out.transpose(0, 2, 1).reshape(x.shape[0], -1)[:, :target_len]
    return out.reshape(*shape[:-1], target_len)
