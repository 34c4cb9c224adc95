"""Host-side DSP used by ``TTS.infer`` (counterpart of ``gsv_tts_tpu/dsp.py``;
the silence trims are ported — SOLA stitching and the subtitle Viterbi wait
with streaming and subtitles, ROADMAP Queue 1)."""
from __future__ import annotations

import numpy as np


def find_head_threshold_offset(audio: np.ndarray, threshold: float = 0.02,
                               frame_length: int = 512, hop_length: int = 256,
                               search_len: int = 64000, margin: int = 3200) -> int:
    """Leading-silence trim offset (reference ``TTS.py:1629-1644``)."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    head = audio[:search_len]
    if len(head) < frame_length:
        return 0
    frames = np.lib.stride_tricks.sliding_window_view(head, frame_length)[::hop_length]
    rms = np.sqrt(np.mean(frames ** 2, axis=1))
    idx = np.nonzero(rms > threshold)[0]
    if idx.size:
        return max(0, int(idx[0]) * hop_length - margin)
    return len(head)


def find_tail_threshold_offset(audio: np.ndarray, threshold: float = 0.01,
                               frame_length: int = 512, hop_length: int = 256,
                               search_len: int = 64000, margin: int = 3200) -> int:
    """Trailing-silence trim length (reference ``TTS.py:1646-1662``)."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    tail = audio[-search_len:]
    if len(tail) < frame_length:
        return 1
    frames = np.lib.stride_tricks.sliding_window_view(tail, frame_length)[::hop_length]
    rms = np.sqrt(np.mean(frames ** 2, axis=1))
    idx = np.nonzero(rms > threshold)[0]
    if idx.size:
        return max(1, len(tail) - int(idx[-1]) * hop_length - margin)
    return len(tail)
