"""Host-side audio post-FX ("enhance") chain (counterpart of
``gsv_tts_tpu/fx.py``).  The compressor's envelope follower and the reverb's
Freeverb wet path run in the host C++ library (``utils/native.py``, built at
first use) where JAX's do, and in numpy when it is off or cannot be built.

Native re-implementation of the reference WebUI's pedalboard/pyloudnorm
enhancement (``WebUI/web.py:40-74``): 80 Hz high-pass, +2.5 dB presence peak
at 300 Hz, -3 dB de-esser peak at 7 kHz, a -18 dB / 3.5:1 compressor, a 3 %
ambience reverb, +2 dB makeup gain, then integrated-loudness normalization
to -18 LUFS.

Implemented with RBJ-cookbook biquads, exact Freeverb-style comb/allpass
sections expressed as rational transfer functions for ``scipy.signal.lfilter``
(no per-sample Python loops) for the numpy path, an attack/release envelope
follower, and ITU-R BS.1770-4 gated loudness measurement (the pyloudnorm algorithm).

Everything here is float32-in/float32-out mono at an arbitrary sample rate.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

try:
    from scipy.signal import lfilter
except ImportError:  # pragma: no cover - scipy ships in the image
    lfilter = None


# ---------------------------------------------------------------------------
# RBJ biquads
# ---------------------------------------------------------------------------

def _biquad_highpass(fc: float, sr: float, q: float = 1 / math.sqrt(2)):
    w0 = 2 * math.pi * fc / sr
    alpha = math.sin(w0) / (2 * q)
    cw = math.cos(w0)
    b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    return b / a[0], a / a[0]


def _biquad_peak(fc: float, sr: float, gain_db: float, q: float):
    A = 10 ** (gain_db / 40)
    w0 = 2 * math.pi * fc / sr
    alpha = math.sin(w0) / (2 * q)
    cw = math.cos(w0)
    b = np.array([1 + alpha * A, -2 * cw, 1 - alpha * A])
    a = np.array([1 + alpha / A, -2 * cw, 1 - alpha / A])
    return b / a[0], a / a[0]


def highpass(x: np.ndarray, sr: float, fc: float = 80.0) -> np.ndarray:
    b, a = _biquad_highpass(fc, sr)
    return lfilter(b, a, x).astype(np.float32)


def peak_filter(x: np.ndarray, sr: float, fc: float, gain_db: float,
                q: float) -> np.ndarray:
    b, a = _biquad_peak(fc, sr, gain_db, q)
    return lfilter(b, a, x).astype(np.float32)


# ---------------------------------------------------------------------------
# compressor
# ---------------------------------------------------------------------------

def _envelope_numpy(level: np.ndarray, att: float, rel: float) -> np.ndarray:
    env = np.empty_like(level)
    e = 0.0
    for i in range(len(level)):
        v = level[i]
        c = att if v > e else rel
        e = c * e + (1.0 - c) * v
        env[i] = e
    return env


def compressor(x: np.ndarray, sr: float, threshold_db: float = -18.0,
               ratio: float = 3.5, attack_ms: float = 1.0,
               release_ms: float = 100.0) -> np.ndarray:
    """Feed-forward compressor (pedalboard ``Compressor`` semantics: hard
    knee, attack/release ballistics on the level detector)."""
    x = np.asarray(x, np.float32)
    att = math.exp(-1.0 / (sr * attack_ms / 1000.0))
    rel = math.exp(-1.0 / (sr * release_ms / 1000.0))
    level = np.abs(x)
    from .utils.native import native_lib

    lib = native_lib()
    if lib is not None:
        env = lib.envelope_follow(level, att, rel)
    else:
        env = _envelope_numpy(level, att, rel)
    level_db = 20.0 * np.log10(np.maximum(env, 1e-9))
    over = np.maximum(level_db - threshold_db, 0.0)
    gain_db = -over * (1.0 - 1.0 / ratio)
    return (x * 10 ** (gain_db / 20.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# Freeverb-style mono reverb (Jezar's public tunings), via lfilter
# ---------------------------------------------------------------------------

_COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)  # @44.1 kHz
_ALLPASS_TUNINGS = (556, 441, 341, 225)


def _comb_damped(x: np.ndarray, delay: int, feedback: float,
                 damp: float) -> np.ndarray:
    """Lowpass-feedback comb: y = z^-D x + fb·LP(y)·z^-D with one-pole
    LP(z) = (1-d)/(1-d z^-1), written as one rational filter:
        (1 - d z^-1 - fb(1-d) z^-D) y = (1 - d z^-1) z^-D x
    """
    a = np.zeros(delay + 1)
    a[0] = 1.0
    # additive assembly: at delay == 1 both terms land on a[1] and must
    # SUM (a tuple assignment would silently drop the -damp term)
    a[1] += -damp
    a[delay] += -feedback * (1.0 - damp)
    b = np.zeros(delay + 2)
    b[delay], b[delay + 1] = 1.0, -damp
    return lfilter(b, a, x)


def _allpass(x: np.ndarray, delay: int, g: float = 0.5) -> np.ndarray:
    """Freeverb/JUCE 'allpass' section (NOT a textbook unity-gain
    allpass): y[n] = w[n-D] - x[n] with w[n] = x[n] + g·w[n-D], i.e.
    H(z) = ((1+g)·z^-D - 1) / (1 - g·z^-D)."""
    b = np.zeros(delay + 1)
    b[0], b[delay] = -1.0, 1.0 + g
    a = np.zeros(delay + 1)
    a[0], a[delay] = 1.0, -g
    return lfilter(b, a, x)


def reverb(x: np.ndarray, sr: float, room_size: float = 0.1,
           damping: float = 0.5, wet: float = 0.03,
           dry: float = 0.97, width: float = 1.0) -> np.ndarray:
    """juce::Reverb (what pedalboard wraps) processMono semantics,
    including the fixed output scale factors the raw ``wet``/``dry``
    levels are multiplied by: dryGain = dry·2, wetGain = 0.5·wet·3·
    (1+width) (width defaults to 1.0 as in juce::Reverb::Parameters)."""
    x = np.asarray(x, np.float32)
    feedback = room_size * 0.28 + 0.7
    damp = damping * 0.4
    scale = sr / 44100.0
    comb_delays = [max(1, int(round(d * scale))) for d in _COMB_TUNINGS]
    ap_delays = [max(1, int(round(d * scale))) for d in _ALLPASS_TUNINGS]
    wet_gain = 0.5 * (wet * 3.0) * (1.0 + width)
    dry_gain = dry * 2.0
    from .utils.native import native_lib

    lib = native_lib()
    if lib is not None:
        wet_sig = lib.freeverb(x, comb_delays, ap_delays, feedback, damp)
    else:
        wet_sig = np.zeros(len(x), np.float64)
        for d in comb_delays:
            wet_sig += _comb_damped(x, d, feedback, damp)
        wet_sig *= 0.015  # freeverb fixed input gain
        for d in ap_delays:
            wet_sig = _allpass(wet_sig, d)
    return (dry_gain * x + wet_gain * wet_sig).astype(np.float32)


def gain(x: np.ndarray, gain_db: float) -> np.ndarray:
    return (np.asarray(x, np.float32) * 10 ** (gain_db / 20.0)).astype(np.float32)


# ---------------------------------------------------------------------------
# ITU-R BS.1770-4 integrated loudness (the pyloudnorm algorithm)
# ---------------------------------------------------------------------------

def _k_weighting(sr: float) -> Tuple[Tuple[np.ndarray, np.ndarray],
                                     Tuple[np.ndarray, np.ndarray]]:
    # stage 1: +4 dB high-shelf (f0 1681.97 Hz, Q 0.7072, G 3.9998 dB)
    f0, G, Q = 1681.9744509555319, 3.99984385397, 0.7071752369554196
    K = math.tan(math.pi * f0 / sr)
    Vh = 10 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    shelf_b = np.array([(Vh + Vb * K / Q + K * K) / a0,
                        2.0 * (K * K - Vh) / a0,
                        (Vh - Vb * K / Q + K * K) / a0])
    shelf_a = np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                        (1.0 - K / Q + K * K) / a0])
    # stage 2: high-pass (f0 38.135 Hz, Q 0.5003)
    f0, Q = 38.13547087602444, 0.5003270373238773
    K = math.tan(math.pi * f0 / sr)
    d0 = 1.0 + K / Q + K * K
    hp_b = np.array([1.0, -2.0, 1.0])
    hp_a = np.array([1.0, 2.0 * (K * K - 1.0) / d0,
                     (1.0 - K / Q + K * K) / d0])
    return (shelf_b, shelf_a), (hp_b, hp_a)


def integrated_loudness(x: np.ndarray, sr: float) -> float:
    """Gated integrated loudness in LUFS (BS.1770-4, mono)."""
    x = np.asarray(x, np.float64)
    (sb, sa), (hb, ha) = _k_weighting(sr)
    y = lfilter(hb, ha, lfilter(sb, sa, x))
    block = int(round(0.400 * sr))
    hop = int(round(0.100 * sr))  # 75% overlap
    if len(y) < block:
        ms = np.array([np.mean(y ** 2)]) if len(y) else np.array([1e-12])
    else:
        n_blocks = 1 + (len(y) - block) // hop
        idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
        ms = np.mean(y[idx] ** 2, axis=1)
    lk = -0.691 + 10.0 * np.log10(np.maximum(ms, 1e-12))
    abs_gated = ms[lk > -70.0]
    if len(abs_gated) == 0:
        return -70.0
    rel_thresh = -0.691 + 10.0 * np.log10(np.mean(abs_gated)) - 10.0
    gated = ms[(lk > -70.0) & (lk > rel_thresh)]
    if len(gated) == 0:
        return -70.0
    return float(-0.691 + 10.0 * np.log10(np.mean(gated)))


def loudness_normalize(x: np.ndarray, sr: float,
                       target_lufs: float = -18.0) -> np.ndarray:
    lufs = integrated_loudness(x, sr)
    if lufs <= -70.0:
        return np.asarray(x, np.float32)
    return gain(x, target_lufs - lufs)


# ---------------------------------------------------------------------------
# the enhance chain (WebUI/web.py:40-74 parameters)
# ---------------------------------------------------------------------------

def enhance_audio(audio: np.ndarray, sr: int) -> np.ndarray:
    """Voice 'studio polish': clean lows, presence lift, de-ess, steady
    dynamics, a hint of room, then normalize to -18 LUFS (podcast level)."""
    if lfilter is None:  # pragma: no cover
        return np.asarray(audio, np.float32)
    x = np.asarray(audio, np.float32)
    x = highpass(x, sr, 80.0)
    x = peak_filter(x, sr, 300.0, 2.5, 1.0)
    x = peak_filter(x, sr, 7000.0, -3.0, 2.0)
    x = compressor(x, sr, threshold_db=-18.0, ratio=3.5)
    x = reverb(x, sr, room_size=0.1, damping=0.5, wet=0.03, dry=0.97)
    x = gain(x, 2.0)
    return loudness_normalize(x, sr, -18.0)
