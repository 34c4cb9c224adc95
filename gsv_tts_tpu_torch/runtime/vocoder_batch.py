"""Cross-stream vocoder batching (counterpart of
``gsv_tts_tpu/runtime/vocoder_batch.py``).

The shared wave (``runtime/wave.py``) decodes N independent streams in one
t2s wave, and the streams of one wave reach their chunk boundaries on the
same decode chunk.  :class:`VocoderBatcher` collects the chunks that arrive
together and runs them as ONE :func:`stream_batch_fused` call at B > 1 (the
padded core ``models/sovits.py:decode_core_stream_padded_batch``, then flow⁻¹
and HiFi-GAN), which on the card is one CUDA graph per ``("chunk", B, Bc, Np,
bucket, overlap_len)`` in ``TTS.sovits_graphs``.  A lone chunk takes the
facade's solo path, ``TTS._sovits_decode_stream`` (``stream_batch_fused`` at
B=1).  What a batched chunk costs against solo chunks on the H100 is in
``PERF.md``.

The reference has no counterpart: its streaming callers serialize the whole
pipeline behind ``_infer_lock`` (``TTS.py:145``).
"""
from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import sovits as sovits_model

__all__ = ["VocoderBatcher", "stream_batch_fused"]


def stream_batch_fused(params, cfg, codes_pad, codes_len, text_pad, text_len, ge, noise, y_ov,
                       vsi, blend, *, overlap_len: int, bucket: int):
    """The padded core (:func:`models.sovits.decode_core_stream_padded_batch`,
    same arguments), its latent padded or cut to the flow's ``bucket``
    frames, then flow⁻¹ and HiFi-GAN.  Returns (audio [B, 1, bucket·hop],
    attn [B, 4, 2·Bc, Np], new_overlap [B, hidden, overlap_len])."""
    z_p, mask, attn, new_ov = sovits_model.decode_core_stream_padded_batch(
        params, cfg, codes_pad, codes_len, text_pad, text_len, ge, noise, y_ov, vsi, blend,
        overlap_len=overlap_len)
    pad = bucket - z_p.shape[-1]  # negative: cut
    audio = sovits_model.flow_dec(params, cfg, F.pad(z_p, (0, pad)), F.pad(mask, (0, pad)), ge)
    return audio, attn, new_ov


class _Item:
    __slots__ = ("sovits", "codes", "text", "ge", "noise_scale", "y_overlap", "vsi",
                 "overlap_len", "event", "result", "error", "picked")

    def __init__(self, sovits, codes, text, ge, noise_scale, y_overlap, vsi, overlap_len):
        self.sovits = sovits
        self.codes = np.asarray(codes, np.int64).reshape(-1)  # [n]
        self.text = np.asarray(text, np.int64).reshape(-1)    # [N]
        self.ge = ge                                          # [1, gin, 1] on the device
        self.noise_scale = float(noise_scale)
        self.y_overlap = y_overlap    # [1, hidden, overlap_len] on the device, or None
        self.vsi = int(vsi)
        self.overlap_len = int(overlap_len)
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.picked = False           # taken by the worker (in flight)


class VocoderBatcher:
    """Collect-and-run batcher of streaming vocoder chunks.

    Client threads call :meth:`decode_stream` (the contract of the bucketed
    ``TTS._sovits_decode_stream`` at ``speed == 1``); a worker thread takes
    the first queued chunk, waits up to ``window_s`` for the rest of its
    wave's burst (not when fewer than two shared streams are open), groups
    the chunks by model and overlap, and runs each group as one call.
    :meth:`decode_many` does the same on the caller's thread for a caller
    that already holds the coinciding chunks (``TTS.infer_batched_stream``)."""

    #: batch sizes of the batched programs; a group of another size is padded
    #: up with masked dummy rows
    B_BUCKETS = (2, 4, 8)

    def __init__(self, tts, max_batch: int = 4, window_s: float = 0.004):
        self.tts = tts
        self.max_batch = min(max_batch, max(self.B_BUCKETS))
        self.window_s = window_s
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue()
        self._closed = False
        self._stats_lock = threading.Lock()
        self.stats = {"batches": 0, "rows": 0, "solo_rows": 0, "max_group": 0, "windowless": 0}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="gsv-vocoder-batcher")
        self._thread.start()

    # -- client surface --------------------------------------------------

    def decode_stream(self, sovits, codes, text, ge, noise_scale, y_overlap, valid_start_idx,
                      overlap_len):
        """Blocking: returns ``(audio [1, 1, T] float32, attn [4, 2n, N],
        new_overlap [1, hidden, overlap_len] on the device)``, as the solo
        bucketed path does."""
        if self._closed:
            raise RuntimeError("VocoderBatcher is closed")
        it = _Item(sovits, codes, text, ge, noise_scale, y_overlap, valid_start_idx, overlap_len)
        self._q.put(it)
        # poll, so that a close() racing this put cannot strand the caller; an
        # item the worker already took finishes with its group unless the
        # worker itself is gone
        while not it.event.wait(1.0):
            if (self._closed and it.error is None and it.result is None
                    and (not it.picked or not self._thread.is_alive())):
                raise RuntimeError("VocoderBatcher closed mid-request")
        if it.error is not None:
            raise it.error
        return it.result

    def decode_many(self, specs) -> list:
        """Run ``specs`` — ``(sovits, codes, text, ge, noise_scale, y_overlap,
        vsi, overlap_len)`` tuples — on the caller's thread, in groups of at
        most ``max_batch``, with no window; returns their ``(audio, attn,
        new_overlap)`` in order.  Errors propagate to the caller."""
        items = [_Item(*spec) for spec in specs]
        for group in self._group(items):
            for i in range(0, len(group), self.max_batch):
                self._run_group(group[i:i + self.max_batch])
        return [it.result for it in items]

    def close(self):
        """Stop the worker and fail every chunk still queued."""
        self._closed = True
        self._q.put(None)  # wake the worker
        self._thread.join(timeout=10.0)
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                break
            if it is not None:
                it.error = RuntimeError("VocoderBatcher closed")
                it.event.set()

    def _active_clients(self) -> int:
        """Open shared streams (each holds its scheduler's client count for
        its whole life).  Unknown: assume a burst may come."""
        try:
            stats = self.tts.wave_stats()
        except Exception:  # noqa: BLE001 — a facade without schedulers
            return 2
        return sum(st.get("clients", 0) for st in stats.values() if isinstance(st, dict))

    # -- worker ----------------------------------------------------------

    def _run(self):
        torch.set_grad_enabled(False)  # grad mode is per thread
        while not self._closed:
            try:
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if first is None:
                continue
            first.picked = True
            items = [first]
            # a lone stream would wait out the window for nothing: take only
            # what is queued already
            if self._active_clients() >= 2:
                deadline = time.monotonic() + self.window_s
            else:
                deadline = time.monotonic()
                with self._stats_lock:
                    self.stats["windowless"] += 1
            while len(items) < self.max_batch:
                remaining = deadline - time.monotonic()
                try:
                    nxt = (self._q.get(timeout=remaining) if remaining > 0
                           else self._q.get_nowait())
                except queue.Empty:
                    break
                if nxt is None:
                    break
                nxt.picked = True
                items.append(nxt)
            for group in self._group(items):
                try:
                    self._run_group(group)
                except Exception as exc:  # noqa: BLE001 — raised in the callers' threads
                    for it in group:
                        it.error = exc
                        it.event.set()

    @staticmethod
    def _group(items: List[_Item]) -> List[List[_Item]]:
        groups: Dict[Tuple, List[_Item]] = {}
        for it in items:
            groups.setdefault((id(it.sovits), it.overlap_len), []).append(it)
        return list(groups.values())

    def _run_group(self, items: List[_Item]):
        with self._stats_lock:
            self.stats["batches"] += 1
            self.stats["rows"] += len(items)
            self.stats["max_group"] = max(self.stats["max_group"], len(items))
            if len(items) == 1:
                self.stats["solo_rows"] += 1
        tts = self.tts
        if len(items) == 1:
            it = items[0]
            it.result = tts._sovits_decode_stream(
                it.sovits, it.codes[None, None, :], it.text[None, :], it.ge,
                noise_scale=it.noise_scale, speed=1.0, y_overlap=it.y_overlap,
                valid_start_idx=it.vsi, overlap_len=it.overlap_len)
            it.event.set()
            return
        with tts.sovits_graphs.gate.shared():
            results = self._batched_chunk(items)
        for it, result in zip(items, results):
            it.result = result
            it.event.set()

    def _batched_chunk(self, items: List[_Item]) -> list:
        """One ``stream_batch_fused`` call over the group, padded to the next
        ``B_BUCKETS`` size with masked dummy rows (length 1, no blend, zero
        noise, the first row's ``ge``); noise is one [B, inter, 2·Bc] normal
        draw from the facade's generator, scaled by row, an input of the
        graph.  Returns each row's ``(audio, attn, new_overlap)``."""
        tts = self.tts
        sovits = items[0].sovits
        cfg, p = sovits.cfg, sovits.params
        dev, dtype = tts.device, tts.tts_config.dtype
        overlap_len = items[0].overlap_len
        mult = sovits_model.STREAM_PAD_MULTIPLE
        B = next(b for b in self.B_BUCKETS if b >= len(items))
        Bc = -(-max(max(it.codes.size for it in items), 1) // mult) * mult
        Np = -(-max(max(it.text.size for it in items), 1) // mult) * mult

        codes_pad = np.zeros((B, 1, Bc), np.int64)
        text_pad = np.zeros((B, Np), np.int64)
        codes_len = np.ones((B,), np.int64)
        text_len = np.ones((B,), np.int64)
        vsi = np.zeros((B,), np.int64)
        blend = np.zeros((B,), bool)
        scales = np.zeros((B,), np.float32)
        H = cfg.hidden_channels
        zero_ov = torch.zeros((1, H, overlap_len), dtype=dtype, device=dev)
        ge_rows, yov_rows = [], []
        for i, it in enumerate(items):
            codes_pad[i, 0, :it.codes.size] = it.codes
            text_pad[i, :it.text.size] = it.text
            codes_len[i] = it.codes.size
            text_len[i] = it.text.size
            vsi[i] = it.vsi
            blend[i] = it.y_overlap is not None
            scales[i] = it.noise_scale
            ge_rows.append(it.ge.to(dtype))
            yov_rows.append(zero_ov if it.y_overlap is None else it.y_overlap.to(dtype))
        ge_rows += [ge_rows[0]] * (B - len(items))
        yov_rows += [zero_ov] * (B - len(items))
        with tts._rng_lock:
            noise = torch.randn((B, cfg.inter_channels, 2 * Bc), generator=tts.generator,
                                device=dev, dtype=torch.float32)
        noise = (noise * torch.as_tensor(scales, device=dev)[:, None, None]).to(dtype)

        t_valid = 2 * codes_len - vsi
        bucket = tts._flow_bucket(int(t_valid[:len(items)].max()))
        chunk = functools.partial(stream_batch_fused, p, cfg, overlap_len=overlap_len,
                                  bucket=bucket)

        def on_dev(a):
            return torch.as_tensor(a, device=dev)

        audio, attn, new_ov = tts.sovits_graphs.run(
            p, ("chunk", B, Bc, Np, bucket, overlap_len), chunk, on_dev(codes_pad),
            on_dev(codes_len), on_dev(text_pad), on_dev(text_len), torch.cat(ge_rows),
            noise, torch.cat(yov_rows), on_dev(vsi), on_dev(blend))
        audio = audio.float().cpu().numpy()
        attn = attn.float().cpu().numpy()
        spf = cfg.samples_per_frame
        # the overlap stays on the device, a copy of its row: it is the next
        # chunk's input
        return [(audio[i:i + 1, :, :int(t_valid[i]) * spf],
                 attn[i][..., :2 * it.codes.size, :it.text.size],
                 new_ov[i:i + 1].clone())
                for i, it in enumerate(items)]
