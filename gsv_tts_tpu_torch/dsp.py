"""Host-side DSP of the facade (counterpart of ``gsv_tts_tpu/dsp.py``): SOLA
chunk stitching for the streaming mode, the RMS-threshold silence trims and
the subtitles' monotonic Viterbi alignment.  The SOLA offset search and the
Viterbi run in the host C++ library (``utils/native.py``, built at first
use) where JAX's do, and in numpy when it is off or cannot be built."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .utils.native import native_lib


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
    lib = native_lib()
    if lib is not None:
        offset = lib.sola_offset(f1, key, overlap_len)
    elif len(key) < overlap_len:
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


def viterbi_monotonic(attn: np.ndarray) -> np.ndarray:
    """Monotonic Viterbi over the averaged MRTE attention (reference
    ``_viterbi_monotonic``, ``TTS.py:1744-1797``): attn [heads, T frames,
    N phones] → frame→phone assignment [T], leading frames aligned to the
    null key (the last column) marked -1."""
    attn = np.asarray(attn, np.float32)
    _, T, N = attn.shape
    max_idx = attn.argmax(axis=-1)
    mask = max_idx != N - 1  # heads whose argmax is not the null key
    sum_attn = (attn * mask[:, :, None]).sum(axis=0)
    count = mask.sum(axis=0)[:, None]

    default = np.full((T, N), 1.0 / N, np.float32)
    default[:, N - 1] = 0.9 / N
    default[:, 1] = 1.1 / N
    default /= default.sum(axis=-1, keepdims=True)
    normal = np.where(count > 0, sum_attn / (count + 1e-9), default)

    zeros = np.nonzero(normal.argmax(axis=-1) == 0)[0]
    first_zero = int(zeros[0]) if zeros.size else 0

    lib = native_lib()
    if lib is not None:
        path = lib.viterbi_monotonic(normal)
    else:
        dp = np.zeros((T, N), np.float32)
        ptr = np.zeros((T, N), np.int64)
        dp[0] = normal[0]
        rng = np.arange(N)
        for t in range(1, T):
            prev = dp[t - 1]
            shifted = np.concatenate([[-np.inf], prev[:-1]])
            take_shift = shifted > prev
            dp[t] = normal[t] + np.where(take_shift, shifted, prev)
            ptr[t] = rng - take_shift.astype(np.int64)
        path = np.zeros(T, np.int64)
        path[-1] = int(dp[-1].argmax())
        for t in range(T - 2, -1, -1):
            path[t] = ptr[t + 1, path[t + 1]]
    path[:first_zero] = -1
    return path


def is_normal_assign(assign: np.ndarray, threshold: float = 0.5) -> bool:
    """Quality gate on the alignment (reference ``_is_normal_assign``,
    ``TTS.py:1799-1809``): too many one-frame runs mean misalignment."""
    x = assign[assign != -1]
    if len(x) == 0:
        return False
    change = np.nonzero(np.diff(x))[0]
    run_lengths = np.diff(np.concatenate([[-1], change, [len(x) - 1]]))
    return float((run_lengths == 1).sum()) / len(run_lengths) < threshold
