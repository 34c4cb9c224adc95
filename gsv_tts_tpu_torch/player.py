"""Audio playback queue and clip container (counterpart of
``gsv_tts_tpu/player.py``).

``AudioQueue`` streams float32 chunks to a persistent ``sounddevice`` output
stream on a background thread; ``sounddevice`` is imported when a queue is
made, and without it (or without an output device) the queue plays nothing
and ``wait`` returns at once.  ``AudioClip`` carries (audio, samplerate,
duration, subtitles, text) and can play or save itself (WAV natively, other
formats through ``soundfile``, imported by the call)."""
from __future__ import annotations

import json
import os
import queue
import threading
from typing import List

import numpy as np

from .utils.audio_io import save_wav


class AudioQueue:
    def __init__(self, samplerate: int):
        self.samplerate = samplerate
        self.q: "queue.Queue[np.ndarray]" = queue.Queue()
        self.t = None
        self.playback_finished = threading.Event()
        self.playback_finished.set()
        self.stream = None
        try:
            import sounddevice as sd

            self.stream = sd.OutputStream(samplerate=samplerate, channels=1, dtype="float32")
            self.stream.start()
        except Exception:  # no sounddevice, no PortAudio or no output device
            self.stream = None

    def put(self, data: np.ndarray):
        if data.ndim == 1:
            data = data.reshape(-1, 1)
        self.q.put(data)
        if self.t is None or not self.t.is_alive():
            self.playback_finished.clear()
            self.t = threading.Thread(target=self._run_playback, daemon=True)
            self.t.start()

    def _run_playback(self):
        while not self.q.empty():
            data = self.q.get()
            if self.stream:
                self.stream.write(data)
        self.playback_finished.set()

    def stop(self):
        """Immediately stop playback and clear the queue."""
        with self.q.mutex:
            self.q.queue.clear()
        if self.stream:
            self.stream.stop()
            self.stream.start()
        self.playback_finished.set()

    def wait(self):
        """Block until everything queued has played out."""
        self.playback_finished.wait()


class AudioClip:
    def __init__(self, audio_queue: AudioQueue, audio_data: np.ndarray, samplerate: int,
                 audio_len_s: float, subtitles: List[dict], orig_text: str):
        self.audio_queue = audio_queue
        self.audio_data = audio_data
        self.samplerate = samplerate
        self.audio_len_s = audio_len_s
        self.subtitles = subtitles
        self.orig_text = orig_text

    def play(self, volume: float = 1.0):
        """Queue this clip for sequential playback."""
        if volume != 1.0:
            self.audio_data = np.clip(self.audio_data * volume, -1.0, 1.0)
        self.audio_queue.put(self.audio_data)

    def save(self, save_path: str, is_save_subtitles: bool = False):
        """Save audio (and optionally a subtitle JSON beside it)."""
        if str(save_path).lower().endswith(".wav"):
            save_wav(save_path, np.asarray(self.audio_data), self.samplerate)
        else:
            import soundfile as sf

            sf.write(save_path, self.audio_data, self.samplerate)
        if is_save_subtitles:
            base, _ = os.path.splitext(save_path)
            with open(base + ".json", "w", encoding="utf-8") as f:
                json.dump({"orig_text": self.orig_text, "subtitles": self.subtitles},
                          f, indent=4, ensure_ascii=False)
