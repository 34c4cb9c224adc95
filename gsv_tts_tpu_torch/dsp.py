"""Host-side DSP of the facade (counterpart of ``gsv_tts_tpu/dsp.py``): SOLA
chunk stitching for the streaming mode and the RMS-threshold silence trims,
in numpy.  The subtitle Viterbi waits with subtitles (ROADMAP Queue 1)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def sola_align(f1_overlap: np.ndarray, f2: np.ndarray, overlap_len: int,
               search_len: int = 320) -> Tuple[np.ndarray, int]:
    """Synchronous-overlap-add alignment (reference ``_sola_algorithm``,
    ``TTS.py:1612-1627``): find the offset in ``f2``'s head maximizing the
    normalized cross-correlation with the previous chunk's tail, then
    cross-fade.

    f1_overlap [T_ov], f2 [T2] → (aligned chunk, offset).
    """
    f1 = np.asarray(f1_overlap, np.float32).reshape(-1)
    f2 = np.asarray(f2, np.float32).reshape(-1)
    key = f2[: overlap_len + search_len]
    if len(key) < overlap_len:
        offset = 0
    else:
        windows = np.lib.stride_tricks.sliding_window_view(key, overlap_len)
        corr = windows @ f1
        energy = np.sqrt((windows ** 2).sum(axis=1) + 1e-8)
        offset = int(np.argmax(corr / energy))
    f2_aligned = f2[offset:]
    alpha = np.linspace(0, 1, overlap_len, dtype=np.float32)
    faded = f1 * (1 - alpha) + f2_aligned[:overlap_len] * alpha
    return np.concatenate([faded, f2_aligned[overlap_len:]]), offset


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
