"""TTS engine facade (counterpart of ``gsv_tts_tpu/tts.py``): model
registry (load, unload, list, ``to_safetensors``), speaker/prompt audio
caches, single-utterance ``infer``, streaming ``infer_stream``, batched
``infer_batched``, batched streaming ``infer_batched_stream``, the shared
wave's ``stream_shared`` (with its admission control and statistics), voice
conversion ``infer_vc``, ``verify_speaker``, ``warmup``,
``init_language_module``, ``get_timings`` and the ``*_async`` wrappers.

Pipeline: text → frontend (host: English, Chinese and Japanese G2P; for Chinese text
the CNRoberta BERT featurizer, ``models/roberta.py``, on the card) → t2s
engine (prefill, then one whole-step kernel per decode step by default: K1
for one utterance, K2 for a continuous-batched wave, the generic step with
K3b for waves above K2's limit; ``attn_impl`` selects the K4 / K3b or the K6
paths instead, ``use_flash_attn=False`` the ``"xla"`` path without a kernel)
→ SoVITS → host trim, subtitles from the MRTE attention by a monotonic
Viterbi.
v2 / v2Pro / v2ProPlus SoVITS models: a v2Pro model's speaker conditioning
adds the ERes2NetV2 embedding of the speaker clip (``models/sv.py``, the
checkpoint at ``models_dir/sv/pretrained_eres2netv2w24s4ep4.ckpt``).
GPT-SoVITS v4 models (``models/sovits_v4.py``, ``models/cfm.py``) run through
``infer`` alone: the codes' features (on the card one CUDA graph per
padded bucket, all captured at load), a flow-matching DiT over chunks of up
to ``T_chunk`` mel frames whose prompt is the previous chunk's end, and a
48 kHz vocoder; every other entry point refuses them.

SoVITS runs as the JAX facade runs it.  By default (``stream_vocoder=
"bucketed"``) ``infer`` and each ``infer_stream`` chunk take the
bucket-padded core, codes and phones padded to multiples of 32 with every
length a device tensor, and flow⁻¹ + HiFi-GAN padded to a frame bucket
(``sovits_cache``, then a ×1.5 ladder); on the card each such program is one
CUDA graph, captured the first time its shapes are seen and replayed after.
``speed != 1``, a frame-wise ``ge`` and ``stream_vocoder="exact"`` take the
exact-shape core (the packed ``infer_batched`` too, with block-diagonal MRTE
masks), whose flow still pads to the bucket ladder.  Concurrent streams
(``stream_shared``) decode in one wave (``runtime/wave.py``) and vocode their
coinciding chunks as one batched call (``runtime/vocoder_batch.py``); the
threads involved share the card through ``DeviceGate``, which keeps every
CUDA graph capture alone on it.
"""
from __future__ import annotations

import asyncio
import contextlib
import functools
import logging
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp
from .config import Config, global_config
from .frontend.lang_segment import LangSegment
from .frontend.pause import pause_map
from .frontend.text_processor import cut_text, get_phones_and_bert, sub2text_index
from .loader import (Gpt, Sovits, get_gpt_weights, get_sovits_weights, gpt_to_safetensors,
                     resolve_t2s_attn_impl, sovits_to_safetensors)
from .models import cfm as cfm_model
from .models import sovits as sovits_model
from .models import sovits_v4
from .ops import stft
from .player import AudioClip, AudioQueue
from .runtime.t2s_session import _round_up
from .runtime.vocoder_batch import stream_batch_fused
from .utils.audio_io import load_audio, save_wav
from .utils.timing import REQUEST, Timings, request_id, span

logger = logging.getLogger(__name__)

DEFAULT_MUTE_SCALE = {"…": 2.0, ".": 1.5, "。": 1.5, "?": 1.5, "？": 1.5,
                      "!": 1.5, "！": 1.5, ",": 1.0, "，": 1.0, ":": 1.0,
                      "：": 1.0, ";": 1.0, "；": 1.0, "~": 1.0, "、": 0.8,
                      "・": 0.8}


class _SegStream:
    """Incremental vocoder state of one text segment, shared by
    ``infer_stream``, ``infer_batched_stream`` and ``stream_shared`` (the JAX
    ``_SegStream``): chunked SoVITS decode over the cumulative tokens with the
    latent cross-fade (``y_overlap``), SOLA waveform stitching, head trim on
    the first chunk, the mute pad after the last, and the incremental
    subtitles (reference ``TTS.py:415-476``).  ``vocoded`` counts the tokens
    already voiced, ``done`` is set by the final pass.

    ``req_state`` threads the request's subtitle chain through its segments:
    ``{"last_end_s": float, "cur_text_l": int}``."""

    __slots__ = ("tokens", "vocoded", "done", "phones2", "ge", "text_cut", "word2ph",
                 "norm_text", "want_subtitles", "_y_overlap", "_vsi", "_last_overlap",
                 "_chunk_idx", "_head_offset", "_last_subtitles_end")

    def __init__(self, phones2, ge, text_cut, word2ph=None, norm_text=None,
                 want_subtitles: bool = False):
        self.tokens: List[int] = []
        self.vocoded = 0
        self.done = False
        self.phones2 = phones2
        self.ge = ge
        self.text_cut = text_cut
        self.word2ph = word2ph
        self.norm_text = norm_text
        self.want_subtitles = want_subtitles
        self._y_overlap = None  # the previous chunk's last latent frames
        self._vsi = 0           # latent frames already voiced
        self._last_overlap = None  # the previous chunk's last samples
        self._chunk_idx = 0
        self._head_offset = 0
        self._last_subtitles_end = 0

    def batch_eligible(self, tts: "TTS", speed: float) -> bool:
        """True when this segment's chunks can join a batched vocoder call
        (the gate of the solo bucketed path)."""
        return speed == 1 and self.ge.shape[-1] == 1 and tts.stream_vocoder == "bucketed"

    def step(self, tts: "TTS", sovits, final: bool, req_state: dict, *, noise_scale: float,
             speed: float, overlap_len: int, cut_mute: float, cut_mute_scale_map: dict,
             batcher=None, upto: Optional[int] = None, vocode_result=None):
        """One vocode pass over the cumulative tokens; returns the new audio
        (float32) and the new subtitles.  With ``batcher`` (a
        ``runtime.vocoder_batch.VocoderBatcher``) an eligible chunk joins the
        chunks of concurrent streams; ``upto`` caps the tokens taken (a caller
        that plans several vocodes before running any); ``vocode_result`` is
        a ``(audio, attn, new_overlap)`` already computed by
        ``VocoderBatcher.decode_many``, used in place of the decode."""
        overlap_samples = overlap_len * sovits.cfg.samples_per_frame
        semantic = np.asarray(self.tokens if upto is None else self.tokens[:upto], np.int64)
        subtitles = []
        if semantic.size:
            if vocode_result is not None:
                audio, attn, self._y_overlap = vocode_result
            elif batcher is not None and self.batch_eligible(tts, speed):
                audio, attn, self._y_overlap = batcher.decode_stream(
                    sovits, semantic, np.asarray(self.phones2, np.int64), self.ge, noise_scale,
                    self._y_overlap, self._vsi, overlap_len)
            else:
                audio, attn, self._y_overlap = tts._sovits_decode_stream(
                    sovits, semantic[None, None, :], np.asarray(self.phones2, np.int64)[None],
                    self.ge, noise_scale=noise_scale, speed=speed, y_overlap=self._y_overlap,
                    valid_start_idx=self._vsi, overlap_len=overlap_len)
            audio = np.asarray(audio).reshape(-1)
            if self._last_overlap is not None:
                audio, _ = dsp.sola_align(self._last_overlap, audio, overlap_samples)
            self._last_overlap = audio[-overlap_samples:].copy()
            if not final:
                audio = audio[:-overlap_samples]
                attn = attn[:, :-overlap_len, :]
                self._vsi = attn.shape[1]
            if self.want_subtitles:
                assign = dsp.viterbi_monotonic(attn)
                if dsp.is_normal_assign(assign) or final:
                    subtitles = tts._get_subtitles(self.word2ph, assign, speed,
                                                   last_end_s=req_state["last_end_s"])
            if self._chunk_idx == 0:
                self._head_offset = dsp.find_head_threshold_offset(audio)
                audio = audio[self._head_offset:]
            if subtitles:
                tts._increment_subtitle_times(subtitles, -self._head_offset / tts.samplerate)
                subtitles[0]["start_s"] = max(req_state["last_end_s"], subtitles[0]["start_s"])
            self._chunk_idx += 1
        else:
            audio = np.zeros(0, np.float32)
        if final:
            scale = tts._mute_scale(self.text_cut, cut_mute_scale_map)
            audio = np.concatenate(
                [audio, np.zeros(int(cut_mute * scale * tts.samplerate), np.float32)])
            if subtitles:
                if not tts._check_pause(subtitles[-1]["text"]):
                    subtitles.append({"text": self.word2ph["word"][-1],
                                      "start_s": subtitles[-1]["end_s"],
                                      "end_s": subtitles[-1]["end_s"]})
                subtitles[-1]["end_s"] += cut_mute * scale
                req_state["last_end_s"] = subtitles[-1]["end_s"]
        new_subtitles = []
        if subtitles:
            subtitles = sub2text_index(subtitles, self.norm_text, self.text_cut)
            tts._increment_subtitle_indices(subtitles, req_state["cur_text_l"])
            new_subtitles = subtitles[self._last_subtitles_end:]
            self._last_subtitles_end = len(subtitles) - 1
            if not final and new_subtitles:
                new_subtitles[-1]["end_s"] = None
        if final:
            req_state["cur_text_l"] += len(self.text_cut)
        self.vocoded = max(self.vocoded, len(self.tokens) if upto is None else upto)
        self.done = self.done or final
        return audio.astype(np.float32), new_subtitles


class DeviceGate:
    """Keeps a CUDA graph capture alone on the card.  Threads that share the
    card through one facade (the wave scheduler's decode thread, the vocoder
    batcher's worker, the callers' threads) do their device work inside
    :meth:`shared`, any number at a time; a capture runs inside
    :meth:`exclusive`, which waits until no other thread is inside a shared
    section and holds new ones back until it ends.  Two rules keep it free of
    deadlock: a shared section never waits on another thread (a section that
    needs :class:`SovitsGraphs`' lock steps out of the gate while it waits for
    it, :meth:`suspended`), and only the holder of that lock enters
    :meth:`exclusive`, so at most one thread does.  A thread may nest shared
    sections and may go exclusive from inside its own (its holds do not
    count against it).  On the CPU it orders nothing that needs it, at the
    cost of a lock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._held = 0          # shared holds, all threads
        self._writer = None     # the thread inside exclusive(), or waiting for it
        self._local = threading.local()

    def _mine(self) -> int:
        return getattr(self._local, "n", 0)

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cond:
            if self._mine() == 0:  # a nested hold passes
                self._cond.wait_for(lambda: self._writer in (None, me))
            self._held += 1
            self._local.n = self._mine() + 1
        try:
            yield
        finally:
            with self._cond:
                self._held -= 1
                self._local.n -= 1
                self._cond.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        with self._cond:
            if self._writer is not None:
                raise RuntimeError("DeviceGate.exclusive entered twice")
            self._writer = threading.get_ident()
            self._cond.wait_for(lambda: self._held == self._mine())
        try:
            yield
        finally:
            with self._cond:
                self._writer = None
                self._cond.notify_all()

    @contextlib.contextmanager
    def suspended(self):
        """This thread's shared holds given up for the block (while it waits
        on a lock whose holder may go exclusive), then taken back."""
        with self._cond:
            n = self._mine()
            self._held -= n
            self._local.n = 0
            self._cond.notify_all()
        try:
            yield
        finally:
            me = threading.get_ident()
            with self._cond:
                if n:
                    self._cond.wait_for(lambda: self._writer in (None, me))
                self._held += n
                self._local.n = n


class SovitsGraphs:
    """One CUDA graph per padded SoVITS program (the JAX facade's one compile
    per shape bucket; the reference captured this region too,
    ``models.py:406-425``), and one per clip-length bucket of the ERes2NetV2
    speaker embedding (``models/sv.py``, keyed ``("sv", frames)`` under the
    embedder's parameters).  :meth:`run` captures a program the first time its
    key is seen for a model's parameters — a warm eager run on a side stream,
    then the capture on that stream — and replays it after, the inputs copied into
    the graph's own buffers (v4's CFM: one graph of an Euler step per chunk
    length, replayed for every step).  The caller keys a program by every
    shape it takes; the graphs are stored under ``(kind, id(params), *shapes)`` (a
    graph holds the parameters' addresses, and its entry keeps them alive);
    every length inside must be an input tensor, since a Python number would
    be fixed at the capture's value.  A model's graphs share one memory pool
    of their own, so one replay's outputs must be copied out before another
    graph replays.  :meth:`evict` drops a model's graphs and its pool, so an
    unloaded model's memory can return to the card.  A capture that fails
    raises, and so do inputs on more than one device.  On the CPU the
    function runs eagerly.

    Any number of threads may call :meth:`run`.  One lock covers a call's
    lookup, capture, input copy, replay and output copy, so replays are
    serial and no thread sees another's buffers.  A capture (its warm run
    included) runs inside ``gate.exclusive()``: no other thread's shared
    section runs meanwhile, so nothing allocates, synchronises or launches a
    whole-card kernel beside it; it is captured in ``"thread_local"`` mode,
    so that work of a thread outside the gate cannot invalidate it either.
    A replay runs inside ``gate.shared()``."""

    def __init__(self):
        self.graphs: Dict[tuple, tuple] = {}
        self.pools: Dict[int, tuple] = {}  # id(params) → that model's pool handle
        self.stream = None  # the side stream every capture and its warm run take
        self.gate = DeviceGate()
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0  # host wall time of the captures, warm runs included

    def run(self, params, key: tuple, fn, *inputs: torch.Tensor) -> tuple:
        if len({x.device for x in inputs}) != 1:
            raise ValueError(f"the SoVITS program {key} takes inputs on one device, not on "
                             f"{sorted({str(x.device) for x in inputs})}")
        if not inputs[0].is_cuda:
            return _eager(fn, *inputs)
        key = (key[0], id(params)) + tuple(key[1:])
        with self.gate.suspended():
            self._lock.acquire()
        try:
            entry = self.graphs.get(key)
            if entry is None:
                with span("gsv.sovits.capture") as cap, self.gate.exclusive():
                    entry = self.graphs[key] = self._capture(params, key, fn, inputs)
                self.capture_s += cap.seconds
            graph, static_in, static_out, _ = entry
            with span("gsv.sovits.replay"), self.gate.shared():
                for buf, x in zip(static_in, inputs):
                    buf.copy_(x)
                graph.replay()
                self.replays += 1
                return tuple(o.clone() for o in static_out)
        finally:
            self._lock.release()

    def evict(self, params) -> int:
        """Drop the graphs of the model whose parameters are ``params``, and
        its pool; returns how many.  Its memory returns to the card at the
        next ``torch.cuda.empty_cache()``."""
        with self._lock:
            keys = [k for k in self.graphs if k[1] == id(params)]
            for k in keys:
                del self.graphs[k]
            self.pools.pop(id(params), None)
        return len(keys)

    def _capture(self, params, key, fn, inputs):
        static_in = [x.clone() for x in inputs]
        pool = self.pools.get(id(params))
        if pool is None:
            pool = self.pools[id(params)] = torch.cuda.graph_pool_handle()
        caller = torch.cuda.current_stream()
        if self.stream is None:
            self.stream = torch.cuda.Stream()
        side = self.stream
        side.wait_stream(caller)
        # a warm run on the stream the capture takes: cuDNN's plans, the
        # allocator, and the cuBLAS workspaces of that stream, which would
        # otherwise be made inside the capture, in the model's pool, and
        # outlive it in cuBLAS's cache
        with torch.cuda.stream(side):
            fn(*static_in)
        caller.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # capture_begin / capture_end, not ``torch.cuda.graph``: that one also
        # collects garbage and empties the allocator's cache on entry, which a
        # capture inside a serving window (a new CFM chunk length) cannot afford
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    out = fn(*static_in)
                finally:
                    graph.capture_end()
        except Exception as exc:
            # a failed capture leaves its capture stream current and its pool
            # recording for good ("beginAllocateToPool: already recording"):
            # the caller's stream back, and a fresh pool for the next capture
            torch.cuda.set_stream(caller)
            del self.pools[id(params)]
            raise RuntimeError(f"CUDA graph capture of the SoVITS program {key} failed") from exc
        side.synchronize()  # the warm run is done before the gate opens
        self.captures += 1
        return graph, static_in, _as_tuple(out), params


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _eager(fn, *args) -> tuple:
    """A SoVITS program run eagerly, outside any CUDA graph."""
    with span("gsv.sovits.eager"):
        return _as_tuple(fn(*args))


def _request(method):
    """Time a public facade call as one request (``gsv.request.<name>``,
    the root of its spans)."""
    name = REQUEST + method.__name__

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with span(name):
            return method(self, *args, **kwargs)

    return wrapped


def _request_stream(method):
    """Time a public streaming call as one request: a span is never held
    across a yield (the consumer's code, on any thread, runs there), so each
    resumption of the stream is a ``gsv.request.<name>`` span of one id."""
    name = REQUEST + method.__name__

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        rid, gen = request_id(), method(self, *args, **kwargs)
        try:
            while True:
                with span(name, request=rid):
                    item = next(gen, None)  # a stream yields no None
                if item is None:
                    return
                yield item
        finally:
            gen.close()

    return wrapped


def _on_card(method):
    """Run a facade method's device work inside the facade's gate
    (``DeviceGate.shared``): no SoVITS graph is captured meanwhile."""

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with self.sovits_graphs.gate.shared():
            return method(self, *args, **kwargs)

    return wrapped


#: the t2s KV-cache buckets ``TTS()`` takes, the JAX facade's: B=1 lengths for
#: ``infer`` and waves of 4 slots for ``infer_batched`` (a wave takes the
#: smallest bucket with B >= its texts, so without a B=4 bucket a batch would
#: decode one text at a time)
DEFAULT_GPT_CACHE = ((1, 512), (1, 768), (1, 1024), (4, 512), (4, 1024))
#: the flow/vocoder frame buckets ``TTS()`` takes, the JAX facade's
DEFAULT_SOVITS_CACHE = (50, 55)


class TTS:
    """Engine facade.  ``device`` and ``dtype`` follow ``Config``'s policy:
    the engine runs on the card in bf16 and raises when there is none, unless
    the caller asks for ``device="cpu"`` (then f32).  ``seed`` seeds the explicit generator every
    random draw (Gumbel noise, SoVITS latent noise) comes from.
    ``attn_impl`` names the t2s engine's kernels (``Config.attn_impl``);
    ``quant_t2s`` (``False``, ``True`` = ``"int8"``, ``"int8"``, ``"int4"``)
    streams K1's and K2's layer weights quantized (``Config.quant_t2s``; with
    an ``attn_impl`` other than ``"fused_step"`` it raises, as does any other
    value).  ``sovits_cache`` lists the flow/vocoder frame buckets (empty: exact
    shapes); ``stream_vocoder`` is ``"bucketed"`` (the padded core, one CUDA
    graph per bucket on the card) or ``"exact"`` (the exact-shape core).
    ``use_flash_attn=False`` takes the engine's ``"xla"`` path (plain
    PyTorch, no kernel), whatever ``attn_impl`` and ``quant_t2s`` say.
    The ERes2NetV2 speaker embedder (``models_dir/sv/``) is loaded the first
    time an embedding has to be computed and kept, as HuBERT is.

    Chinese text takes BERT features from ``models_dir/
    chinese-roberta-wwm-ext-large`` (``use_bert``: loaded now; else, with
    ``auto_bert``, on the first text with Han characters; a missing
    directory is downloaded unless ``GSV_OFFLINE`` is set, else zero
    features and a warning); a ``models_dir`` without the HuBERT, G2P and
    speaker-verification bundle is filled the same way
    (``download.check_pretrained_models``).  Every returned clip carries
    ``audio_queue``, the facade's playback queue (``AudioClip.play``);
    ``quant_bert`` runs its linear layers in int8, ``featurizer_buckets``
    pads the BERT and HuBERT inputs to a ladder of shapes, and
    ``use_jieba_fast`` has the Chinese G2P segment with ``jieba_fast`` when
    it imports.  ``timings`` keeps the stages' wall times of the calls
    (``get_timings``); the ``*_async`` wrappers run a call in an executor
    thread under ``_infer_lock``, one at a time, but for
    ``stream_shared_async``.  ``wave_max_batch`` caps the shared wave's batch
    bucket (``stream_shared``), ``wave_max_clients`` its concurrent clients
    (``None``: no cap), and ``vocoder_batch=False`` vocodes every stream chunk
    alone instead of batching the chunks that come due together."""

    def __init__(self, gpt_cache: List[tuple] = DEFAULT_GPT_CACHE,
                 sovits_cache: List[int] = DEFAULT_SOVITS_CACHE,
                 models_dir: Optional[str] = None, device: Optional[str] = None,
                 dtype: Optional[str] = None, seed: Optional[int] = None,
                 attn_impl: str = "fused_step", stream_vocoder: str = "bucketed",
                 quant_t2s=False, use_flash_attn: bool = True, use_bert: bool = False,
                 auto_bert: bool = True, use_jieba_fast: bool = False,
                 quant_bert: bool = False, featurizer_buckets: bool = False,
                 wave_max_batch: int = 4, wave_max_clients: Optional[int] = None,
                 vocoder_batch: bool = True):
        if stream_vocoder not in ("bucketed", "exact"):
            raise ValueError(f'stream_vocoder must be "bucketed" or "exact", not {stream_vocoder!r}')
        self.tts_config = Config(device=device, dtype=dtype, gpt_cache=list(gpt_cache),
                                 sovits_cache=sorted(sovits_cache or []), attn_impl=attn_impl,
                                 quant_t2s=quant_t2s, use_flash_attn=use_flash_attn,
                                 quant_bert=quant_bert, featurizer_buckets=featurizer_buckets)
        resolve_t2s_attn_impl(self.tts_config)  # a bad combination fails here, not at load
        self.stream_vocoder = stream_vocoder
        #: the padded SoVITS programs' CUDA graphs (counted in ``last_timings``)
        self.sovits_graphs = SovitsGraphs()
        if models_dir is None:
            models_dir = Path.home() / ".cache" / "gsv"
        self.models_dir = Path(models_dir)
        self.tts_config.models_dir = self.models_dir
        if global_config.models_dir is None:
            global_config.models_dir = self.models_dir
        if global_config.use_jieba_fast is None:
            global_config.use_jieba_fast = use_jieba_fast
        from .download import check_pretrained_models

        try:
            check_pretrained_models(self.models_dir)
        except (ImportError, OSError) as exc:
            # the mirror probe runs outside the download manager's own guard: a host
            # without ``requests`` (or without a route out) keeps the local assets
            logger.warning("Missing pretrained assets in %s cannot be fetched (%s); features "
                           "depending on them will be gated.", self.models_dir, exc)
        self.device = self.tts_config.device
        self.generator = torch.Generator(device=self.device)
        if seed is None:
            self.generator.seed()
        else:
            self.generator.manual_seed(seed)

        self.gpt_models: Dict[str, Gpt] = {}
        self.sovits_models: Dict[str, Sovits] = {}
        self.spk_audio_cache: Dict[str, dict] = {}
        self.prompt_audio_cache: Dict[str, dict] = {}
        self.cnhubert_path = self.models_dir / "chinese-hubert-base"
        self.cnroberta_path = self.models_dir / "chinese-roberta-wwm-ext-large"
        self.sv_path = self.models_dir / "sv" / "pretrained_eres2netv2w24s4ep4.ckpt"
        self.default_gpt_path = self.models_dir / "s1v3.ckpt"
        self.default_sovits_path = self.models_dir / "s2Gv2ProPlus.pth"
        self.auto_bert = auto_bert
        self._bert_loaded = False
        if use_bert:
            self._load_bert()
        self.cnhubert_model = None
        self.sv_model = None
        #: serializes the ``*_async`` wrappers' calls in their executor threads
        #: (``stream_shared_async`` takes no lock: its callers share the wave)
        self._infer_lock = threading.Lock()
        #: shared-wave streaming: one ``runtime.wave.WaveScheduler`` per GPT
        #: model and one ``runtime.vocoder_batch.VocoderBatcher``, made on first
        #: use; ``_sched_lock`` guards both, ``_prep_lock`` the caches and the
        #: frontend that concurrent ``stream_shared`` callers fill, ``_rng_lock``
        #: the draws from ``generator``
        self.wave_max_batch = wave_max_batch
        self.wave_max_clients = wave_max_clients
        self.vocoder_batch = vocoder_batch
        self._wave_schedulers: Dict = {}
        self._vocoder_batcher = None
        self._sched_lock = threading.Lock()
        self._prep_lock = threading.Lock()
        self._rng_lock = threading.Lock()
        #: rolling wall times of the stages (``frontend``, ``t2s``, ``sovits``
        #: of ``infer``; ``ttfa_s`` of ``infer_stream``), read by ``get_timings``
        self.timings = Timings()
        self.punctuation = tuple(pause_map.keys())
        self.samplerate = 32000
        self.sovits_hz = 50
        #: the playback queue every returned clip carries (``AudioClip.play``)
        self.audio_queue = AudioQueue(self.samplerate)
        #: stage wall times (s) and decode counts of the last ``infer``,
        #: ``infer_batched`` or ``infer_stream`` (``ttfa_s``: time to the
        #: first audio chunk; ``sovits_graphs`` / ``sovits_replays``: CUDA
        #: graphs captured / replayed by the call, ``sovits_capture_s`` the
        #: part of ``sovits_s`` its captures took)
        self.last_timings: Dict[str, float] = {}
        #: what the last v4 decode adds to ``last_timings`` (``_v4_decode``)
        self._v4_stats: Dict[str, object] = {}
        #: set by :meth:`warmup` (a server's ``/health`` reports it)
        self._warmed = False
        logger.info("Device: %s, dtype: %s", self.device, self.tts_config.dtype)

    # -- model registry --------------------------------------------------

    def load_gpt_model(self, *model_paths):
        """Load each model; a model loaded again under its path closes the
        shared-wave scheduler of its old weights (its open streams fail, as
        an unload fails them), so later streams decode with the new ones."""
        for path in model_paths or (self.default_gpt_path,):
            model = get_gpt_weights(path, self.tts_config)
            with self._sched_lock:
                sched = self._wave_schedulers.pop(path, None)
            if sched is not None:
                sched.close()
            self.gpt_models[path] = model
            logger.info("Loaded GPT model: %s", path)

    def load_sovits_model(self, *model_paths):
        """Load each model; a model loaded again under its path drops the CUDA
        graphs of its old parameters (they hold those weights).  On the card
        a v4 model's ``decode_encp`` graphs are captured here, one per bucket
        (:meth:`_capture_encp`), so that no request pays a capture."""
        for path in model_paths or (self.default_sovits_path,):
            old = self.sovits_models.get(path)
            model = self.sovits_models[path] = get_sovits_weights(path, self.tts_config)
            if old is not None:
                self.sovits_graphs.evict(old.params)
                if old.vocoder is not None:
                    self.sovits_graphs.evict(old.vocoder)
            if model.v4 is not None:
                self._capture_encp(model)
            logger.info("Loaded SoVITS model: %s", path)

    def unload_gpt_model(self, *model_paths):
        """Drop each model: its shared-wave scheduler (closed: its open
        streams fail), its weights, its kernels' table and, under
        ``quant_t2s``, its packed pages, whose memory returns to the card."""
        for path in model_paths:
            if path in self.gpt_models:
                with self._sched_lock:
                    sched = self._wave_schedulers.pop(path, None)
                if sched is not None:
                    sched.close()
                del self.gpt_models[path]
                logger.info("Unloaded GPT model: %s", path)
            else:
                logger.warning("GPT model %s not found.", path)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def unload_sovits_model(self, *model_paths):
        """Drop each model, its ``ge`` from every speaker cache entry (the
        entries and their embeddings stay), and its CUDA graphs, whose memory
        returns to the card."""
        for path in model_paths:
            if path in self.sovits_models:
                model = self.sovits_models.pop(path)
                params, vocoder = model.params, model.vocoder
                del model
                for audio in self.spk_audio_cache.values():
                    audio["ge"].pop(path, None)
                self.sovits_graphs.evict(params)
                if vocoder is not None:
                    self.sovits_graphs.evict(vocoder)
                del params, vocoder  # their last references: the weights go with the graphs
                logger.info("Unloaded SoVITS model: %s", path)
            else:
                logger.warning("SoVITS model %s not found.", path)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def get_gpt_list(self):
        return list(self.gpt_models.keys())

    def get_sovits_list(self):
        return list(self.sovits_models.keys())

    def init_language_module(self, *languages):
        """Build the G2P engine of each language now rather than on its first
        text; an unknown language logs a warning."""
        from .frontend.g2p import text_to_phonemes

        for language in languages:
            if language in ("en", "zh", "ja"):
                text_to_phonemes(" .", language, models_dir=self.models_dir)
                logger.info("Loaded language module: %s", language)
            else:
                logger.warning('Language "%s" not found.', language)

    def to_safetensors(self, checkpoint_path, output_dir: Optional[str] = None):
        """Convert a GPT ``.ckpt`` or a SoVITS ``.pth`` into a safetensors
        directory (by default the checkpoint's path without its suffix) that
        this package and the JAX package both load."""
        if output_dir is None:
            output_dir, _ = os.path.splitext(str(checkpoint_path))
        if str(checkpoint_path).endswith(".pth"):
            sovits_to_safetensors(checkpoint_path, output_dir, self.tts_config)
        else:
            gpt_to_safetensors(checkpoint_path, output_dir, self.tts_config)
        logger.info("Successfully converted and saved to: %s", output_dir)

    def _get_cnhubert(self):
        if self.cnhubert_model is None:
            from .models.hubert import CNHubert

            self.cnhubert_model = CNHubert(str(self.cnhubert_path), self.tts_config)
        return self.cnhubert_model

    def _get_sv_model(self):
        """The ERes2NetV2 embedder (``sv_path``), loaded on first use and kept;
        a missing or incomplete checkpoint raises.  On the card its load
        captures the embedding's CUDA graphs, one per clip-length bucket, in
        :attr:`sovits_graphs`."""
        if self.sv_model is None:
            from .models.sv import ERes2Net

            if not self.sv_path.exists():
                raise FileNotFoundError(
                    f"speaker-verification checkpoint not found: {self.sv_path}")
            self.sv_model = ERes2Net(self.sv_path, self.tts_config, graphs=self.sovits_graphs)
        return self.sv_model

    # -- caches ----------------------------------------------------------

    @_request
    @_on_card
    def cache_spk_audio(self, *spk_audio_paths, sovits_model: Optional[str] = None):
        """Speaker conditioning of each clip under a loaded SoVITS model (the
        first by default): ``spk_audio_cache[path] = {"ge": {model: ge},
        "sv_emb": embedding or None}``.  A v2Pro model adds the clip's
        ERes2NetV2 embedding, computed once per clip and reused by every
        model; a clip already cached for the model is left as it is.  With no
        such model loaded it logs an error and caches nothing, as JAX does."""
        if not self.sovits_models:
            logger.error("No SoVITS models are currently loaded! Cannot cache speaker audio.")
            return
        if sovits_model is None:
            sovits_model = next(iter(self.sovits_models))
        if sovits_model not in self.sovits_models:
            logger.error("The SoVITS model %s is not loaded!", sovits_model)
            return
        model = self.sovits_models[sovits_model]
        for path in spk_audio_paths:
            entry = self.spk_audio_cache.get(path)
            if entry is None or sovits_model not in entry["ge"]:
                refers, audio16k = self._get_spec(model.hps, path)
                if entry is None:
                    entry = self.spk_audio_cache[path] = {"ge": {}, "sv_emb": None}
                if model.cfg.is_v2pro and entry["sv_emb"] is None:
                    sv = self._get_sv_model()
                    with span("gsv.voice.sv_emb", device=True):
                        entry["sv_emb"] = sv.compute_embedding3(audio16k)
                with torch.no_grad(), span("gsv.voice.ge"):
                    entry["ge"][sovits_model] = sovits_model_ge(model, refers, entry["sv_emb"])
            logger.info("Cached speaker audio: %s", path)

    @_request
    @_on_card
    def cache_prompt_audio(self, prompt_audio_paths, prompt_audio_texts):
        if not self.sovits_models:
            logger.error("No SoVITS models are currently loaded! Cannot cache prompt audio.")
            return
        model = self.sovits_models[next(iter(self.sovits_models))]
        hub = self._get_cnhubert()
        if isinstance(prompt_audio_paths, (str, Path)):
            prompt_audio_paths = [prompt_audio_paths]
        if isinstance(prompt_audio_texts, str):
            prompt_audio_texts = [prompt_audio_texts] * len(prompt_audio_paths)
        for path, text in zip(prompt_audio_paths, prompt_audio_texts):
            if not text or not text.strip():
                raise ValueError("Prompt audio text is empty. Please provide the text "
                                 "transcription for the reference audio.")
            prompt = self._get_prompt(hub, model, path)
            with span("gsv.voice.prompt_text"):
                phones1, _, bert1, _ = get_phones_and_bert(text, self.tts_config)
            entry = self.prompt_audio_cache[path] = {"prompt": prompt, "phones1": phones1,
                                                     "bert1": bert1}
            v4 = next((m.v4 for m in self.sovits_models.values() if m.v4 is not None), None)
            if v4 is not None:
                entry["mel_v4"] = self._prompt_mel(path, v4)
            logger.info("Cached prompt audio: %s", path)

    def del_spk_audio(self, *spk_audio_list):
        for path in spk_audio_list:
            if self.spk_audio_cache.pop(path, None) is None:
                logger.warning("Speaker audio %s not found in cache.", path)

    def del_prompt_audio(self, *prompt_audio_list):
        for path in prompt_audio_list:
            if self.prompt_audio_cache.pop(path, None) is None:
                logger.warning("Prompt audio %s not found in cache.", path)

    def get_spk_audio_list(self):
        return list(self.spk_audio_cache.keys())

    def get_prompt_audio_list(self):
        return list(self.prompt_audio_cache.keys())

    # -- inference -------------------------------------------------------

    @_request
    @_on_card
    def infer(self, spk_audio_path, prompt_audio_path, prompt_audio_text, text,
              return_subtitles: bool = False, top_k: int = 15, top_p: float = 1.0,
              temperature: float = 1.0, repetition_penalty: float = 1.35,
              noise_scale: float = 0.5, speed: float = 1.0,
              gpt_model=None, sovits_model=None) -> AudioClip:
        """Single-utterance synthesis (reference ``TTS.py:149-286``)."""
        if self._contains_chinese(text):
            self._ensure_bert_loaded()
        if not self._check_pause(text):
            text += "."
        gpt_model, sovits_model = self._default_models(gpt_model, sovits_model)
        sovits, ge = self._prepare_sovits_resources(sovits_model, spk_audio_path, v4=True)
        gpt, cache = self._prepare_gpt_resources(gpt_model, prompt_audio_path,
                                                 prompt_audio_text)
        if sovits.v4 is not None and "mel_v4" not in cache:  # cached before a v4 model loaded
            cache["mel_v4"] = self._prompt_mel(prompt_audio_path, sovits.v4)
        sr = sovits.samplerate

        with span("gsv.frontend") as fe:
            phones2, word2ph, bert2, norm_text = get_phones_and_bert(text, self.tts_config)
            all_phones = np.asarray(cache["phones1"] + phones2, np.int64)
            bert = np.concatenate([np.asarray(cache["bert1"], np.float32),
                                   np.asarray(bert2, np.float32)], axis=0)
        graphs = self._graph_counts()
        with torch.no_grad():
            with span("gsv.t2s.generate") as t2s:
                semantic = gpt.engine.generate(
                    all_phones, cache["prompt"], bert, top_k=top_k, top_p=top_p,
                    temperature=temperature, repetition_penalty=repetition_penalty,
                    generator=self.generator).reshape(-1)
            with span("gsv.sovits.decode") as sov:
                audio, attn = self._sovits_decode(sovits, semantic[None, None, :],
                                                  np.asarray(phones2, np.int64)[None], ge,
                                                  noise_scale=noise_scale, speed=speed,
                                                  prompt=cache)
                audio = audio.reshape(-1)
        # each stage ends in a copy to the host, so its wall time holds its device work
        for name, sp in (("frontend", fe), ("t2s", t2s), ("sovits", sov)):
            self.timings.record(name, sp.seconds)
        self.last_timings = {"frontend_s": fe.seconds, "t2s_s": t2s.seconds,
                             "sovits_s": sov.seconds, "tokens": int(semantic.size),
                             **self._graph_counts(graphs), **gpt.engine.last_stats,
                             **(self._v4_stats if sovits.v4 is not None else {})}

        with span("gsv.tts.finish"):
            subtitles = []
            if return_subtitles:
                subtitles = self._utterance_subtitles(word2ph, attn, speed, norm_text, text)
            # the search and margin are 2 s and 0.1 s at any rate (64000 and 3200 at 32 kHz)
            head_offset = dsp.find_head_threshold_offset(audio, search_len=2 * sr,
                                                         margin=sr // 10)
            audio = audio[head_offset:]
            if subtitles:
                self._increment_subtitle_times(subtitles, -head_offset / sr)
                subtitles[0]["start_s"] = max(0, subtitles[0]["start_s"])
            max_audio = np.abs(audio).max() if audio.size else 0.0
            if max_audio > 1:
                audio = audio / max_audio
            audio = np.concatenate([audio, np.zeros(int(0.2 * sr), audio.dtype)])
            return AudioClip(self.audio_queue, audio.astype(np.float32), sr,
                             len(audio) / sr, subtitles, text)

    def get_timings(self) -> Dict[str, Dict[str, float]]:
        """Latency percentiles by stage (``frontend``, ``t2s``, ``sovits``,
        ``ttfa_s``): count, p50, p95, mean and last, in seconds."""
        return self.timings.summary()

    def warmup(self, voice: Optional[dict] = None, text: Optional[str] = None,
               stream: bool = False, gpt_model=None, sovits_model=None) -> Dict[str, float]:
        """One short ``infer`` before traffic arrives, so the CUDA graphs of
        the SoVITS buckets its lengths hit are captured (and the kernels'
        first launches paid) before a user waits on them.  ``voice`` is a
        ``{"speaker_audio", "prompt_audio", "prompt_text"}`` bundle; without
        one, synthetic sine references are written to a temporary directory
        (graphs are keyed by shapes, not by content).  The default text gains
        a Chinese prefix when the BERT directory exists and a Chinese G2P works
        for ``models_dir``, so the BERT featurizer runs once too (a failing
        zh G2P only drops the prefix).  A longer first request still captures
        its own buckets.  ``stream=True`` also runs one ``stream_shared`` of
        the text (its scheduler, chunk graphs and vocoder batcher).  Returns
        wall seconds by phase (``infer_s``, ``stream_s``, ``total_s``).  The
        host DSP library (``utils/native.py``) is built here too, so the first
        stream or subtitle request does not compile it."""
        from .utils.native import native_lib

        native_lib()
        if text is None:
            text = "warm up, testing one two three."
            if self.cnroberta_path.exists():
                zh_prefix = "预热完成。"
                try:
                    from .frontend.g2p import text_to_phonemes

                    text_to_phonemes(zh_prefix, "zh", models_dir=self.models_dir)
                    text = zh_prefix + " " + text
                except Exception as exc:  # no usable zh G2P here: warm without it
                    logger.warning("warmup: zh prefix skipped (no usable zh G2P for "
                                   "models_dir=%s: %s)", self.models_dir, exc)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="gsv_warmup_") as tmp:
            if voice:
                spk, prompt = voice["speaker_audio"], voice["prompt_audio"]
                ptext = voice.get("prompt_text") or "one two three four five."
            else:
                rng = np.random.RandomState(0)

                def sine(path, seconds, freq):
                    t = np.arange(int(self.samplerate * seconds)) / self.samplerate
                    wav = 0.3 * np.sin(2 * np.pi * freq * t) + 0.01 * rng.randn(len(t))
                    save_wav(path, wav.astype(np.float32), self.samplerate)
                    return path

                spk = sine(f"{tmp}/warmup_spk.wav", 0.7, 220.0)
                prompt = sine(f"{tmp}/warmup_prompt.wav", 0.6, 330.0)
                ptext = "one two three four five."
            clip = self.infer(spk, prompt, ptext, text, gpt_model=gpt_model,
                              sovits_model=sovits_model)
            if len(clip.audio_data) == 0:
                raise RuntimeError("warmup synthesis produced no audio")
            stats = {"infer_s": time.perf_counter() - t0}
            if stream:
                t1 = time.perf_counter()
                n = sum(len(c.audio_data) for c in self.stream_shared(
                    spk, prompt, ptext, text, debug=False, gpt_model=gpt_model,
                    sovits_model=sovits_model))
                if n == 0:
                    raise RuntimeError("warmup stream produced no audio")
                stats["stream_s"] = time.perf_counter() - t1
        stats["total_s"] = time.perf_counter() - t0
        self._warmed = True
        logger.info("warmup done: %s", stats)
        return stats

    @_request_stream
    def infer_stream(self, spk_audio_path, prompt_audio_path, prompt_audio_text, text,
                     return_subtitles: bool = False, is_cut_text: bool = True,
                     cut_minlen: int = 10, cut_mute: float = 0.4,
                     cut_mute_scale_map: dict = DEFAULT_MUTE_SCALE,
                     stream_mode: str = "token", stream_chunk: int = 25,
                     overlap_len: int = 5, boost_first_chunk: bool = True, top_k: int = 15,
                     top_p: float = 1.0, temperature: float = 1.0,
                     repetition_penalty: float = 1.35, noise_scale: float = 0.5,
                     speed: float = 1.0, gpt_model=None, sovits_model=None,
                     debug: bool = True):
        """Streaming synthesis (reference ``TTS.py:288-504``): a generator
        of ``AudioClip`` chunks.  The t2s decode is cut into chunks of
        ``stream_chunk`` tokens (``stream_mode="sentence"``: one chunk per
        text segment); each chunk is vocoded over the cumulative tokens with
        a latent cross-fade of ``overlap_len`` frames and stitched to the
        previous one by SOLA; with ``return_subtitles`` each clip carries the
        subtitles its audio completes.  ``boost_first_chunk`` sends the first
        chunk of the first segment out without holding it back for its
        successor.  ``last_timings["ttfa_s"]`` is the time to the first
        chunk (also recorded in ``timings``), ``sovits_s`` the vocoder's time
        over the stream so far.  ``debug`` logs each segment and the stream's
        end."""
        if self._contains_chinese(text):
            self._ensure_bert_loaded()
        if not self._check_pause(text):
            text += "."
        if stream_mode == "sentence":
            stream_chunk = 10000
        if not is_cut_text:
            cut_minlen = 10000
        cut_mute = cut_mute / speed
        gpt_model, sovits_model = self._default_models(gpt_model, sovits_model)
        sovits, ge = self._prepare_sovits_resources(sovits_model, spk_audio_path)
        gpt, cache = self._prepare_gpt_resources(gpt_model, prompt_audio_path,
                                                 prompt_audio_text)

        gate = self.sovits_graphs.gate
        audio_len_s = 0.0
        req_state = {"last_end_s": 0.0, "cur_text_l": 0}
        t_start = time.perf_counter()
        graphs = self._graph_counts()
        self.last_timings = {"sovits_s": 0.0}
        text_cuts = cut_text(text, cut_minlen)
        for i, text_cut in enumerate(text_cuts):
            if debug:
                logger.info("Processing segment %d/%d: %r", i + 1, len(text_cuts), text_cut)
            with gate.shared():
                phones2, word2ph, bert2, norm_text = get_phones_and_bert(text_cut,
                                                                         self.tts_config)
            all_phones = np.asarray(cache["phones1"] + phones2, np.int64)
            bert = np.concatenate([np.asarray(cache["bert1"], np.float32),
                                   np.asarray(bert2, np.float32)], axis=0)
            seg = _SegStream(phones2, ge, text_cut, word2ph, norm_text,
                             want_subtitles=return_subtitles)
            chunks = gpt.engine.generate(
                all_phones, cache["prompt"], bert, top_k=top_k, top_p=top_p,
                temperature=temperature, repetition_penalty=repetition_penalty,
                generator=self.generator, stream_chunk=stream_chunk,
                boost_first_chunk=boost_first_chunk and i == 0)
            while True:
                # grad mode is switched off only while this generator runs,
                # never across a yield
                with torch.no_grad():
                    with gate.shared():
                        item = next(chunks, None)
                    if item is None:
                        break
                    pred_semantic, is_final = item
                    seg.tokens = list(np.asarray(pred_semantic).reshape(-1))
                    if not seg.tokens and not is_final:
                        continue
                    with span("gsv.sovits.decode") as sov:
                        audio, new_subtitles = seg.step(
                            self, sovits, is_final, req_state, noise_scale=noise_scale,
                            speed=speed, overlap_len=overlap_len, cut_mute=cut_mute,
                            cut_mute_scale_map=cut_mute_scale_map)
                    self.last_timings["sovits_s"] += sov.seconds
                audio_len_s += len(audio) / self.samplerate
                if "ttfa_s" not in self.last_timings:
                    self.last_timings["ttfa_s"] = time.perf_counter() - t_start
                    self.timings.record("ttfa_s", self.last_timings["ttfa_s"])
                self.last_timings.update(gpt.engine.last_stats, **self._graph_counts(graphs))
                yield AudioClip(self.audio_queue, audio, self.samplerate, audio_len_s, new_subtitles, text)
        if debug:
            logger.info("Stream inference complete. Generated %.2fs of audio.", audio_len_s)

    @_on_card
    def _prepare_batched_inputs(self, spk_audio_paths, prompt_audio_paths,
                                prompt_audio_texts, texts, is_cut_text, cut_minlen,
                                bert_batch_size, gpt_model, sovits_model):
        """Front half of the batched mode: expand per-request inputs, cut
        texts into engine-request segments, featurize, and gather
        prompt/speaker resources per segment."""
        if isinstance(texts, str):
            texts = [texts]
        if any(self._contains_chinese(t) for t in texts):
            self._ensure_bert_loaded()
        texts = [t if self._check_pause(t) else t + "." for t in texts]
        if not is_cut_text:
            cut_minlen = 10000
        n = len(texts)
        if isinstance(spk_audio_paths, (str, dict, Path)):
            spk_audio_paths = [spk_audio_paths] * n
        if isinstance(prompt_audio_paths, (str, Path)):
            prompt_audio_paths = [prompt_audio_paths] * n
        if isinstance(prompt_audio_texts, str):
            prompt_audio_texts = [prompt_audio_texts] * n
        gpt_model, sovits_model = self._default_models(gpt_model, sovits_model)
        if gpt_model not in self.gpt_models:
            self.load_gpt_model(gpt_model)
        if sovits_model not in self.sovits_models:
            self.load_sovits_model(sovits_model)
        gpt = self.gpt_models[gpt_model]
        sovits = self.sovits_models[sovits_model]

        all_segments: List[str] = []
        segment_to_original: List[int] = []
        for idx, t in enumerate(texts):
            for cutted in cut_text(t, cut_minlen):
                all_segments.append(cutted)
                segment_to_original.append(idx)

        def expand(inp):
            return [inp[i] for i in segment_to_original]

        all_phones2, all_word2ph, all_bert2, all_norm_text = [], [], [], []
        for i in range(0, len(all_segments), bert_batch_size):
            p2, w2, b2, nt = get_phones_and_bert(all_segments[i: i + bert_batch_size],
                                                 self.tts_config)
            all_phones2 += p2
            all_word2ph += w2
            all_bert2 += b2
            all_norm_text += nt

        xs, ys, berts, all_ge = [], [], [], []
        for spk, ppath, ptext, phones2, bert2 in zip(
                expand(spk_audio_paths), expand(prompt_audio_paths),
                expand(prompt_audio_texts), all_phones2, all_bert2):
            if ppath not in self.prompt_audio_cache:
                self.cache_prompt_audio(ppath, ptext)
            cache = self.prompt_audio_cache[ppath]
            _, ge = self._prepare_sovits_resources(sovits_model, spk)
            xs.append(np.asarray(cache["phones1"] + phones2, np.int64))
            ys.append(np.asarray(cache["prompt"], np.int64).reshape(-1))
            berts.append(np.concatenate([np.asarray(cache["bert1"], np.float32),
                                         np.asarray(bert2, np.float32)], axis=0))
            all_ge.append(ge)
        return (gpt, sovits, texts, all_segments, segment_to_original, all_phones2,
                all_word2ph, all_norm_text, xs, ys, berts, all_ge)

    @_request
    @_on_card
    def infer_batched(self, spk_audio_paths, prompt_audio_paths, prompt_audio_texts, texts,
                      return_subtitles: bool = False, is_cut_text: bool = True,
                      cut_minlen: int = 10, cut_mute: float = 0.4,
                      cut_mute_scale_map: dict = DEFAULT_MUTE_SCALE, top_k: int = 15,
                      top_p: float = 1.0, temperature: float = 1.0,
                      repetition_penalty: float = 1.35, noise_scale: float = 0.5,
                      speed: float = 1.0, bert_batch_size: int = 20,
                      sovits_batch_size: int = 10, gpt_model=None, sovits_model=None):
        """Batched synthesis (reference ``TTS.py:506-868``): continuous-batched
        t2s, then packed SoVITS decodes with block-diagonal MRTE masks, each
        cut back into its segments by length or, with ``return_subtitles``,
        by the segments' subtitles.  Returns one ``AudioClip`` per text."""
        cut_mute = cut_mute / speed
        with span("gsv.frontend") as fe:
            (gpt, sovits, orig_texts, texts, segment_to_original, all_phones2, all_word2ph,
             all_norm_text, xs, ys, berts, all_ge) = self._prepare_batched_inputs(
                spk_audio_paths, prompt_audio_paths, prompt_audio_texts, texts, is_cut_text,
                cut_minlen, bert_batch_size, gpt_model, sovits_model)

        with torch.no_grad(), span("gsv.t2s.generate") as t2s:
            pred_semantic, semantic_orig_idx = gpt.engine.generate_batched(
                xs, ys, berts, top_k=top_k, top_p=top_p, temperature=temperature,
                repetition_penalty=repetition_penalty, generator=self.generator)
        with span("gsv.sovits.decode") as sov:
            graphs = self._graph_counts()

            lengths = np.asarray([len(s) for s in pred_semantic])
            idx_map = np.argsort(lengths, kind="stable")
            # dual-ended interleave to balance packed-batch lengths (``TTS.py:707-716``)
            m = len(idx_map)
            interleave = np.zeros(m, np.int64)
            interleave[0::2] = np.arange(m)[: (m + 1) // 2]
            interleave[1::2] = np.arange(m)[(m + 1) // 2:][::-1]
            idx_map = idx_map[interleave]
            pred_semantic = [pred_semantic[i] for i in idx_map]
            semantic_orig_idx = np.asarray(semantic_orig_idx)[idx_map]
            lengths = lengths[idx_map]

            generated_audios: List[np.ndarray] = []
            generated_subtitles: List[list] = []
            for i in range(0, len(pred_semantic), sovits_batch_size):
                sem_list = pred_semantic[i: i + sovits_batch_size]
                cur_orig = [int(o) for o in semantic_orig_idx[i: i + sovits_batch_size]]
                cur_lens = lengths[i: i + sovits_batch_size]
                # one packed decode: codes, phones and per-frame speaker
                # conditioning concatenated; each frame attends its own request's
                # text span
                curr_ge = torch.cat([all_ge[oi].expand(-1, -1, int(n))
                                     for oi, n in zip(cur_orig, cur_lens)], dim=2)
                curr_sem = np.concatenate([np.asarray(s) for s in sem_list])[None, None, :]
                phone_lens = np.asarray([len(all_phones2[oi]) for oi in cur_orig])
                curr_phones = np.concatenate(
                    [np.asarray(all_phones2[oi], np.int64) for oi in cur_orig])[None]
                ends = np.cumsum(phone_lens)
                pairs = np.stack([ends - phone_lens, ends], axis=1)
                slice_indices = np.repeat(pairs, np.asarray(cur_lens) * 2, axis=0)

                with torch.no_grad():
                    audio_batch, attn = self._sovits_decode(
                        sovits, curr_sem, curr_phones, curr_ge, noise_scale=noise_scale,
                        speed=speed, slice_indices=slice_indices, use_buckets=False)
                audio_batch = audio_batch.reshape(-1)
                if return_subtitles:
                    curr_word2ph = {
                        "word": [w for oi in cur_orig for w in all_word2ph[oi]["word"]],
                        "ph": [p for oi in cur_orig for p in all_word2ph[oi]["ph"]]}
                    subtitles = self._get_subtitles(curr_word2ph, dsp.viterbi_monotonic(attn),
                                                    speed)
                    if subtitles and not self._check_pause(subtitles[-1]["text"]):
                        subtitles.append({"text": curr_word2ph["word"][-1],
                                          "start_s": subtitles[-1]["end_s"],
                                          "end_s": subtitles[-1]["end_s"]})
                max_audio = np.abs(audio_batch).max() if audio_batch.size else 0.0
                if max_audio > 1.0:
                    audio_batch = audio_batch / max_audio

                if return_subtitles:
                    last_i = 0
                    for oi in cur_orig:
                        best_i = self._find_subtitles(subtitles, all_word2ph[oi], last_i)
                        subtitle = subtitles[last_i:best_i]
                        last_i = best_i
                        if not subtitle:
                            # misaligned attention left this segment unmatched:
                            # an empty segment, not the whole batch down
                            logger.warning("subtitle alignment failed for a batched segment; "
                                           "emitting it empty")
                            generated_audios.append(np.zeros(0, np.float32))
                            generated_subtitles.append([])
                            continue
                        seg_start = int(subtitle[0]["start_s"] * self.samplerate)
                        seg_end = int(subtitle[-1]["end_s"] * self.samplerate)
                        audio = audio_batch[seg_start:seg_end]
                        ho = dsp.find_head_threshold_offset(audio)
                        to = dsp.find_tail_threshold_offset(audio)
                        audio = audio[ho: len(audio) - to]
                        subtitle[0]["start_s"] += ho / self.samplerate
                        subtitle[-1]["end_s"] -= to / self.samplerate
                        generated_audios.append(audio)
                        generated_subtitles.append(
                            sub2text_index(subtitle, all_norm_text[oi], texts[oi]))
                else:
                    last_len = 0.0
                    for n in cur_lens:
                        cur_len = last_len + int(n) * 2 * sovits.cfg.samples_per_frame / speed
                        audio = audio_batch[int(last_len): int(cur_len)]
                        last_len = cur_len
                        ho = dsp.find_head_threshold_offset(audio)
                        to = dsp.find_tail_threshold_offset(audio)
                        generated_audios.append(audio[ho: len(audio) - to])
        self.last_timings = {"frontend_s": fe.seconds, "t2s_s": t2s.seconds,
                             "sovits_s": sov.seconds, "tokens": int(lengths.sum()),
                             "requests": len(texts),
                             **self._graph_counts(graphs), **gpt.engine.last_stats}

        ordered_audios = [None] * len(generated_audios)
        ordered_subtitles = [None] * len(generated_audios)
        for cur_pos, orig_pos in enumerate(semantic_orig_idx.tolist()):
            ordered_audios[orig_pos] = generated_audios[cur_pos]
            if return_subtitles:
                ordered_subtitles[orig_pos] = generated_subtitles[cur_pos]

        final_audios = [[] for _ in orig_texts]
        final_subs = [[] for _ in orig_texts]
        last_orig_idx, cur_text_l = None, 0
        for i, (audio_data, subtitle) in enumerate(zip(ordered_audios, ordered_subtitles)):
            oi = segment_to_original[i]
            final_audios[oi].append(audio_data)
            scale = self._mute_scale(texts[i], cut_mute_scale_map)
            final_audios[oi].append(
                np.zeros(int(cut_mute * scale * self.samplerate), audio_data.dtype))
            if return_subtitles and subtitle:
                if oi != last_orig_idx:
                    cur_text_l, last_orig_idx = 0, oi
                subtitle[-1]["end_s"] += cut_mute * scale
                self._increment_subtitle_indices(subtitle, cur_text_l)
                final_subs[oi].append(subtitle)
                cur_text_l += len(texts[i])

        result = []
        for audio_list, subs_list, orig_text in zip(final_audios, final_subs, orig_texts):
            audio = np.concatenate(audio_list)
            subs = self._cat_subtitles(*subs_list) if (return_subtitles and subs_list) else []
            result.append(AudioClip(self.audio_queue, audio.astype(np.float32), self.samplerate,
                                    len(audio) / self.samplerate, subs, orig_text))
        return tuple(result)

    @_request_stream
    def infer_batched_stream(self, spk_audio_paths, prompt_audio_paths, prompt_audio_texts,
                             texts, return_subtitles: bool = False, is_cut_text: bool = True,
                             cut_minlen: int = 10, cut_mute: float = 0.4,
                             cut_mute_scale_map: dict = DEFAULT_MUTE_SCALE,
                             stream_chunk: int = 25, overlap_len: int = 5, top_k: int = 15,
                             top_p: float = 1.0, temperature: float = 1.0,
                             repetition_penalty: float = 1.35, noise_scale: float = 0.5,
                             speed: float = 1.0, bert_batch_size: int = 20, gpt_model=None,
                             sovits_model=None):
        """Streaming continuous batching (JAX ``infer_batched_stream``): N
        requests decode together in the engine's batched wave
        (``generate_batched_stream``: K2 for 2..8 slots, K1 for a compacted
        tail), and ``(request_idx, AudioClip, request_done)`` is yielded as
        each request's audio becomes ready, interleaved across requests.

        Within a request, segments stream in text order: the current segment
        vocodes chunk by chunk (``infer_stream``'s chunked SoVITS, latent
        cross-fade and SOLA) while later segments that other slots finished
        wait as tokens.  The chunks that come due on one decode chunk run as
        one batched vocoder call (``VocoderBatcher.decode_many``).  Sampling
        has batched-mode semantics (no repetition penalty over generated
        tokens).  With ``return_subtitles`` each clip carries
        ``infer_stream``'s incremental subtitles.  ``last_timings`` holds the
        engine's counts, ``tokens``, ``sovits_s`` and the CUDA graphs of the
        call."""
        cut_mute = cut_mute / speed
        (gpt, sovits, orig_texts, all_segments, segment_to_original, all_phones2, all_word2ph,
         all_norm_text, xs, ys, berts, all_ge) = self._prepare_batched_inputs(
            spk_audio_paths, prompt_audio_paths, prompt_audio_texts, texts, is_cut_text,
            cut_minlen, bert_batch_size, gpt_model, sovits_model)
        gate = self.sovits_graphs.gate
        orig_segments: Dict[int, List[int]] = {}
        for s, oi in enumerate(segment_to_original):
            orig_segments.setdefault(oi, []).append(s)
        cur_pos = {oi: 0 for oi in orig_segments}
        audio_len_s = {oi: 0.0 for oi in orig_segments}
        req_state = {oi: {"last_end_s": 0.0, "cur_text_l": 0} for oi in orig_segments}
        seg = [_SegStream(all_phones2[s], all_ge[s], all_segments[s], word2ph=all_word2ph[s],
                          norm_text=all_norm_text[s], want_subtitles=return_subtitles)
               for s in range(len(all_segments))]

        def clip(oi: int, audio: np.ndarray, subtitles) -> AudioClip:
            audio_len_s[oi] += len(audio) / self.samplerate
            return AudioClip(self.audio_queue, audio, self.samplerate, audio_len_s[oi], subtitles, orig_texts[oi])

        # the requests gain tokens in step, so their chunks come due on the same
        # decode chunk: take the engine's events a chunk at a time, plan every
        # vocode due, run the eligible ones as one batched call, then finish
        # and yield them in the events' order
        batcher = self._get_vocoder_batcher() if speed == 1 else None
        graphs = self._graph_counts()
        self.last_timings = {"sovits_s": 0.0, "tokens": 0}
        events_iter = gpt.engine.generate_batched_stream(
            xs, ys, berts, top_k=top_k, top_p=top_p, temperature=temperature,
            repetition_penalty=repetition_penalty, generator=self._next_generator(),
            grouped=True)
        while True:
            # grad mode off only while this generator runs, never across a yield
            with torch.no_grad(), gate.shared():
                events = next(events_iter, None)
            if events is None:
                break
            self.last_timings.update(gpt.engine.last_stats)
            plan: List[dict] = []
            planned_idx: Dict[int, int] = {}

            def plan_vocode(s: int, final: bool):
                if s in planned_idx:
                    # a chunk planned this step is widened to the segment's end
                    # (one pass covers all tokens; a second would need the
                    # first's overlap state)
                    e = plan[planned_idx[s]]
                    e["final"] = e["final"] or final
                    e["upto"] = len(seg[s].tokens)
                else:
                    planned_idx[s] = len(plan)
                    plan.append({"s": s, "final": final, "upto": len(seg[s].tokens),
                                 "oi": segment_to_original[s]})
                seg[s].vocoded = len(seg[s].tokens)

            for s, new_toks, sdone in events:
                st = seg[s]
                st.tokens.extend(int(t) for t in new_toks)
                self.last_timings["tokens"] += len(new_toks)
                if sdone:
                    st.done = True
                oi = segment_to_original[s]
                if orig_segments[oi][cur_pos[oi]] != s:
                    continue  # a later segment: kept as tokens until its turn
                if not st.done:
                    if len(st.tokens) - st.vocoded >= stream_chunk:
                        plan_vocode(s, final=False)
                    continue
                # the current segment ended: finish it, then every later
                # segment of the request that other slots already finished
                plan_vocode(s, final=True)
                cur_pos[oi] += 1
                while cur_pos[oi] < len(orig_segments[oi]):
                    nxt = orig_segments[oi][cur_pos[oi]]
                    if not seg[nxt].done:
                        break
                    plan_vocode(nxt, final=True)
                    cur_pos[oi] += 1
            if not plan:
                continue
            results = {}
            eligible = [e for e in plan
                        if e["upto"] > 0 and seg[e["s"]].batch_eligible(self, speed)]
            with torch.no_grad(), span("gsv.sovits.decode") as sov:
                if batcher is not None and len(eligible) >= 2:
                    specs = [(sovits, np.asarray(seg[e["s"]].tokens[:e["upto"]], np.int64),
                              np.asarray(seg[e["s"]].phones2, np.int64), seg[e["s"]].ge,
                              noise_scale, seg[e["s"]]._y_overlap, seg[e["s"]]._vsi, overlap_len)
                             for e in eligible]
                    results = {e["s"]: r for e, r in zip(eligible, batcher.decode_many(specs))}
                done_plan = []
                for e in plan:
                    audio, subs = seg[e["s"]].step(
                        self, sovits, e["final"], req_state[e["oi"]], noise_scale=noise_scale,
                        speed=speed, overlap_len=overlap_len, cut_mute=cut_mute,
                        cut_mute_scale_map=cut_mute_scale_map, upto=e["upto"],
                        vocode_result=results.get(e["s"]))
                    done_plan.append((e, audio, subs))
            self.last_timings["sovits_s"] += sov.seconds
            self.last_timings.update(self._graph_counts(graphs))
            last_final = {e["oi"]: e["s"] for e in plan if e["final"]}
            for e, audio, subs in done_plan:
                s, oi = e["s"], e["oi"]
                if e["final"]:
                    req_done = cur_pos[oi] == len(orig_segments[oi]) and last_final[oi] == s
                    yield oi, clip(oi, audio, subs), req_done
                elif audio.size or subs:
                    # subtitles go out even when the head trim ate the chunk's
                    # audio: step() has moved the segment's subtitle cursor
                    yield oi, clip(oi, audio, subs), False

    @_request_stream
    def stream_shared(self, spk_audio_path, prompt_audio_path, prompt_audio_text, text,
                      return_subtitles: bool = False, is_cut_text: bool = True,
                      cut_minlen: int = 10, cut_mute: float = 0.4,
                      cut_mute_scale_map: dict = DEFAULT_MUTE_SCALE, stream_chunk: int = 25,
                      overlap_len: int = 5, top_k: int = 15, top_p: float = 1.0,
                      temperature: float = 1.0, repetition_penalty: float = 1.35,
                      noise_scale: float = 0.5, speed: float = 1.0, gpt_model=None,
                      sovits_model=None, debug: bool = True,
                      cancel_event: Optional[threading.Event] = None, admitted: bool = False):
        """Streaming synthesis through the shared wave (JAX ``stream_shared``):
        unlike ``infer_stream``, callers on any number of threads, arriving at
        any time, decode together in one batched wave (``runtime/wave.py``:
        K2 for a wave of 2..8 slots, K1 for one), each with its own SoVITS,
        SOLA and subtitle state; chunks that come due together are vocoded as
        one batched call (``VocoderBatcher``).  A generator of ``AudioClip``.

        Sampling has batched-mode semantics (no repetition penalty over
        generated tokens, no initial suppression window), so the tokens are
        ``infer_batched_stream``'s, not ``infer_stream``'s.  The stream holds
        one of the scheduler's client slots for its whole life (raising
        ``WaveOverloadedError`` at ``wave_max_clients``); ``admitted=True``
        means the caller holds it already (``admit_shared_client``).
        ``cancel_event`` detaches the request mid-stream."""
        if self._contains_chinese(text):
            self._ensure_bert_loaded()
        if not self._check_pause(text):
            text += "."
        if not is_cut_text:
            cut_minlen = 10000
        cut_mute = cut_mute / speed
        gpt_model, sovits_model = self._default_models(gpt_model, sovits_model)
        with self._prep_lock:
            sovits, ge = self._prepare_sovits_resources(sovits_model, spk_audio_path)
            gpt, cache = self._prepare_gpt_resources(gpt_model, prompt_audio_path,
                                                     prompt_audio_text)
        sched = self._get_wave_scheduler(gpt_model)
        if not admitted:
            sched.acquire_client()
        try:
            batcher = self._get_vocoder_batcher() if speed == 1 else None
            t_start = time.perf_counter()
            first_yield = True
            req_state = {"last_end_s": 0.0, "cur_text_l": 0}
            audio_len_s = 0.0
            text_cuts = cut_text(text, cut_minlen)
            for i, text_cut in enumerate(text_cuts):
                if debug:
                    logger.info("Shared-stream segment %d/%d: %r", i + 1, len(text_cuts),
                                text_cut)
                with self._prep_lock, self.sovits_graphs.gate.shared():
                    phones2, word2ph, bert2, norm_text = get_phones_and_bert(text_cut,
                                                                             self.tts_config)
                bert = np.concatenate([np.asarray(cache["bert1"], np.float32),
                                       np.asarray(bert2, np.float32)], axis=0)
                handle = sched.attach(
                    np.asarray(cache["phones1"] + phones2, np.int64),
                    np.asarray(cache["prompt"], np.int64).reshape(-1), bert, top_k=top_k,
                    top_p=top_p, temperature=temperature,
                    repetition_penalty=repetition_penalty)
                seg = _SegStream(phones2, ge, text_cut, word2ph=word2ph, norm_text=norm_text,
                                 want_subtitles=return_subtitles)
                try:
                    for toks, done in handle:
                        if cancel_event is not None and cancel_event.is_set():
                            handle.cancel()
                            return
                        seg.tokens.extend(int(t) for t in toks)
                        if not done and len(seg.tokens) - seg.vocoded < stream_chunk:
                            continue
                        with torch.no_grad():
                            audio, subs = seg.step(
                                self, sovits, done, req_state, noise_scale=noise_scale,
                                speed=speed, overlap_len=overlap_len, cut_mute=cut_mute,
                                cut_mute_scale_map=cut_mute_scale_map, batcher=batcher)
                        if audio.size or subs or done:
                            audio_len_s += len(audio) / self.samplerate
                            if first_yield:
                                self.timings.record("ttfa_s", time.perf_counter() - t_start)
                                first_yield = False
                            yield AudioClip(self.audio_queue, audio, self.samplerate, audio_len_s, subs, text)
                finally:
                    if not handle.done:
                        handle.cancel()
            if debug:
                logger.info("Shared-stream inference complete. Generated %.2fs of audio.",
                            audio_len_s)
        finally:
            if not admitted:
                sched.release_client()

    @_request
    @_on_card
    def infer_vc(self, spk_audio_path, prompt_audio_path, prompt_audio_text,
                 noise_scale: float = 0.5, speed: float = 1.0, sovits_model=None) -> AudioClip:
        """Zero-shot voice conversion (reference ``TTS.py:870-964``): the
        prompt clip's own semantic codes (HuBERT → RVQ) decoded by SoVITS in
        the speaker's voice, against the phones of ``prompt_audio_text``,
        with that text's subtitles.  ``last_timings``: ``prompt_s`` (codes
        and phones), ``sovits_s`` and the CUDA graphs of the call."""
        if not self._check_pause(prompt_audio_text):
            prompt_audio_text += "."
        _, sovits_model = self._default_models(None, sovits_model)
        sovits, ge = self._prepare_sovits_resources(sovits_model, spk_audio_path)
        with span("gsv.voice.prompt") as pr:
            codes = self._get_prompt(self._get_cnhubert(), sovits, prompt_audio_path)
            with span("gsv.voice.prompt_text"):
                phones, word2ph, _, norm_text = get_phones_and_bert(prompt_audio_text,
                                                                    self.tts_config)
        graphs = self._graph_counts()
        with torch.no_grad(), span("gsv.sovits.decode") as sov:
            audio, attn = self._sovits_decode(sovits, np.asarray(codes, np.int64).reshape(1, 1, -1),
                                              np.asarray(phones, np.int64)[None], ge,
                                              noise_scale=noise_scale, speed=speed)
            audio = audio.reshape(-1)
        self.last_timings = {"prompt_s": pr.seconds, "sovits_s": sov.seconds,
                             "tokens": int(np.asarray(codes).size), **self._graph_counts(graphs)}
        subtitles = self._utterance_subtitles(word2ph, attn, speed, norm_text, prompt_audio_text)
        max_audio = np.abs(audio).max() if audio.size else 0.0
        if max_audio > 1:
            audio = audio / max_audio
        audio = np.concatenate([audio, np.zeros(int(0.2 * self.samplerate), audio.dtype)])
        return AudioClip(self.audio_queue, audio.astype(np.float32), self.samplerate,
                         len(audio) / self.samplerate, subtitles, prompt_audio_text)

    @_request
    @_on_card
    def verify_speaker(self, speaker1_audio, speaker2_audio) -> Optional[float]:
        """Cosine similarity of two clips' ERes2NetV2 embeddings (reference
        ``TTS.py:1205-1247``), the clips read at the first loaded SoVITS
        model's rate.  An embedding in the speaker cache is reused; one
        computed for a cached clip is memoized into its entry.  With no SoVITS
        model loaded it logs an error and returns None, as JAX does."""
        if not self.sovits_models:
            logger.error("No SoVITS models are currently loaded! Cannot verify speaker.")
            return None
        model = self.sovits_models[next(iter(self.sovits_models))]

        def emb(path):
            entry = self.spk_audio_cache.get(path)
            if entry is not None and entry["sv_emb"] is not None:
                return entry["sv_emb"]
            e = self._get_sv_model().compute_embedding3(self._get_spec(model.hps, path)[1])
            if entry is not None:
                entry["sv_emb"] = e
            return e

        e1, e2 = (emb(p).float().cpu().numpy() for p in (speaker1_audio, speaker2_audio))
        return float(np.sum(e1 * e2) / (np.linalg.norm(e1) * np.linalg.norm(e2) + 1e-6))

    # -- async wrappers (reference ``TTS.py:966-1162``) ---------------------
    # Each call runs in an executor thread under ``_infer_lock``: one call's
    # CUDA work (a SoVITS graph capture included) never overlaps another's.

    async def _locked(self, fn, args, kwargs, executor):
        def run():
            with self._infer_lock:
                return fn(*args, **kwargs)

        return await asyncio.get_running_loop().run_in_executor(executor, run)

    async def infer_async(self, *args, executor: Optional[ThreadPoolExecutor] = None,
                          **kwargs):
        return await self._locked(self.infer, args, kwargs, executor)

    async def infer_batched_async(self, *args, executor: Optional[ThreadPoolExecutor] = None,
                                  **kwargs):
        return await self._locked(self.infer_batched, args, kwargs, executor)

    async def infer_vc_async(self, *args, executor: Optional[ThreadPoolExecutor] = None,
                             **kwargs):
        return await self._locked(self.infer_vc, args, kwargs, executor)

    async def infer_stream_async(self, *args, executor: Optional[ThreadPoolExecutor] = None,
                                 **kwargs):
        """``infer_stream``'s chunks as an async generator.  A worker's error
        is raised to the consumer; a consumer that stops early sets the
        cancel event, and the worker stops at its next chunk."""
        async for chunk in self._relay(self.infer_stream, args, kwargs, executor,
                                       threading.Event(), lock=self._infer_lock):
            yield chunk

    async def stream_shared_async(self, *args, executor: Optional[ThreadPoolExecutor] = None,
                                  **kwargs):
        """``stream_shared``'s chunks as an async generator.  It takes no
        ``_infer_lock``: concurrent callers sharing the wave is the point.  A
        consumer that stops early sets ``cancel_event``, which detaches its
        request from the wave."""
        cancel_event = kwargs.setdefault("cancel_event", threading.Event())
        async for chunk in self._relay(self.stream_shared, args, kwargs, executor,
                                       cancel_event, lock=None):
            yield chunk

    async def infer_batched_stream_async(self, *args,
                                         executor: Optional[ThreadPoolExecutor] = None,
                                         **kwargs):
        """``infer_batched_stream``'s ``(request_idx, AudioClip, done)`` events
        as an async generator, under ``_infer_lock`` in an executor thread; a
        worker's error is raised to the consumer."""
        async for event in self._relay(self.infer_batched_stream, args, kwargs, executor,
                                       threading.Event(), lock=self._infer_lock):
            yield event

    async def _relay(self, gen_fn, args, kwargs, executor, cancel_event, lock):
        """Run the generator ``gen_fn(*args, **kwargs)`` in an executor thread
        (under ``lock`` unless it is None) and hand its items to the event
        loop through a queue; errors travel through the queue too.  The
        worker stops at its next item once ``cancel_event`` is set, which the
        consumer's exit does."""
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def run():
            # errors travel through the queue: the executor's future is dropped
            try:
                with lock if lock is not None else contextlib.nullcontext():
                    gen = gen_fn(*args, **kwargs)
                    try:
                        for item in gen:
                            if cancel_event.is_set():  # the consumer went away
                                break
                            loop.call_soon_threadsafe(queue.put_nowait, item)
                    finally:
                        gen.close()
            except BaseException as exc:  # noqa: BLE001 — raised to the consumer
                loop.call_soon_threadsafe(queue.put_nowait, exc)
            finally:
                loop.call_soon_threadsafe(queue.put_nowait, None)

        loop.run_in_executor(executor, run)
        try:
            while True:
                item = await queue.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            cancel_event.set()

    # -- internals -------------------------------------------------------

    def _next_generator(self) -> torch.Generator:
        """A generator of its own for one call (the JAX facade's ``_next_rng``
        split), seeded by a draw from ``generator``."""
        gen = torch.Generator(device=self.device)
        with self._rng_lock:
            gen.manual_seed(int(torch.randint(0, 2 ** 62, (), generator=self.generator,
                                              device=self.device)))
        return gen

    def _get_wave_scheduler(self, gpt_model):
        """The shared-wave scheduler of a loaded GPT model, made on first use
        (``wave_max_batch``, ``wave_max_clients``; its Gumbel draws seeded from
        ``generator``; its pumps inside the facade's ``DeviceGate``)."""
        from .runtime.wave import WaveScheduler

        with self._sched_lock:
            sched = self._wave_schedulers.get(gpt_model)
            if sched is None:
                with self._rng_lock:
                    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=self.generator,
                                             device=self.device))
                sched = WaveScheduler(self.gpt_models[gpt_model].engine,
                                      max_batch=self.wave_max_batch, seed=seed,
                                      max_clients=self.wave_max_clients,
                                      gate=self.sovits_graphs.gate)
                self._wave_schedulers[gpt_model] = sched
            return sched

    def _get_vocoder_batcher(self):
        """The cross-stream vocoder batcher (``runtime/vocoder_batch.py``),
        made on first use; None with ``vocoder_batch=False`` (each shared
        stream then vocodes alone)."""
        if not self.vocoder_batch:
            return None
        from .runtime.vocoder_batch import VocoderBatcher

        with self._sched_lock:
            if self._vocoder_batcher is None:
                self._vocoder_batcher = VocoderBatcher(self, max_batch=self.wave_max_batch)
            return self._vocoder_batcher

    def shared_stream_overloaded(self, gpt_model=None) -> bool:
        """Advisory: True when a new ``stream_shared`` client would be refused
        (``wave_max_clients`` reached on the model's scheduler);
        :meth:`admit_shared_client` is the authoritative check."""
        if self.wave_max_clients is None:
            return False
        gpt_model, _ = self._default_models(gpt_model, None)
        if gpt_model not in self.gpt_models:
            return False  # not loaded: no clients on it
        return self._get_wave_scheduler(gpt_model).overloaded

    def admit_shared_client(self, gpt_model=None):
        """Claim a shared-stream client slot before the stream starts (so a
        server can answer 503 before its response begins).  Raises
        ``WaveOverloadedError`` at the cap; returns the release callable the
        caller must call when the stream ends (and passes ``admitted=True`` to
        :meth:`stream_shared`), or None when the model is not loaded."""
        gpt_model, _ = self._default_models(gpt_model, None)
        if gpt_model not in self.gpt_models:
            return None
        sched = self._get_wave_scheduler(gpt_model)
        sched.acquire_client()
        return sched.release_client

    def wave_stats(self) -> Dict:
        """The shared-wave scheduler's state per GPT model (``WaveScheduler.
        stats``: waves, clients, and the port's step and time totals)."""
        with self._sched_lock:
            return {str(k): s.stats for k, s in self._wave_schedulers.items()}

    def vocoder_batch_stats(self) -> Dict:
        """The vocoder batcher's counters (empty until a shared stream or a
        batched stream made it)."""
        with self._sched_lock:
            if self._vocoder_batcher is None:
                return {}
            return dict(self._vocoder_batcher.stats)

    def _default_models(self, gpt_model, sovits_model):
        if gpt_model is None:
            gpt_model = next(iter(self.gpt_models)) if self.gpt_models else self.default_gpt_path
        if sovits_model is None:
            sovits_model = (next(iter(self.sovits_models)) if self.sovits_models
                            else self.default_sovits_path)
        return gpt_model, sovits_model

    @_on_card
    def _prepare_sovits_resources(self, sovits_model, spk_audio_path, v4: bool = False):
        """The loaded SoVITS model and the speaker conditioning ``ge`` for
        ``spk_audio_path`` — a path, or a ``{path: weight}`` dict blending
        several speakers.  A v4 model raises ``NotImplementedError`` unless
        the caller runs v4 (``v4=True``: ``infer``)."""
        if sovits_model not in self.sovits_models:
            self.load_sovits_model(sovits_model)
        if self.sovits_models[sovits_model].v4 is not None and not v4:
            raise NotImplementedError(
                f"GPT-SoVITS v4 models ({sovits_model}) run through TTS.infer only; "
                f"the streams, the batched calls and infer_vc take v2 / v2Pro / v2ProPlus")
        paths = spk_audio_path if isinstance(spk_audio_path, dict) else {spk_audio_path: 1.0}
        weight_sum = sum(paths.values())
        ge = None
        for path, weight in paths.items():
            if (path not in self.spk_audio_cache
                    or sovits_model not in self.spk_audio_cache[path]["ge"]):
                self.cache_spk_audio(path, sovits_model=sovits_model)
            part = self.spk_audio_cache[path]["ge"][sovits_model]
            if isinstance(spk_audio_path, dict):
                part = part * (weight / weight_sum)
            ge = part if ge is None else ge + part
        return self.sovits_models[sovits_model], ge

    @_on_card
    def _prepare_gpt_resources(self, gpt_model, prompt_audio_path, prompt_audio_text):
        """The loaded t2s model and the prompt cache entry (semantic prompt,
        phones and BERT features of its text) for ``prompt_audio_path``."""
        if gpt_model not in self.gpt_models:
            self.load_gpt_model(gpt_model)
        if prompt_audio_path not in self.prompt_audio_cache:
            self.cache_prompt_audio(prompt_audio_path, prompt_audio_text)
        return self.gpt_models[gpt_model], self.prompt_audio_cache[prompt_audio_path]

    # -- SoVITS ----------------------------------------------------------

    def _graph_counts(self, since: Optional[dict] = None) -> dict:
        """The CUDA graphs captured and replayed so far, and the seconds the
        captures took, or since ``since``."""
        now = {"sovits_graphs": self.sovits_graphs.captures,
               "sovits_replays": self.sovits_graphs.replays,
               "sovits_capture_s": self.sovits_graphs.capture_s}
        return now if since is None else {k: v - since[k] for k, v in now.items()}

    def _noise(self, shape, noise_scale) -> torch.Tensor:
        """SoVITS's latent noise, drawn from the facade's generator (outside
        any graph capture: a graph's input, never part of it)."""
        with self._rng_lock:
            noise = torch.randn(shape, generator=self.generator, device=self.device,
                                dtype=torch.float32)
        noise = noise * noise_scale
        return noise.to(self.tts_config.dtype)

    def _padded(self, codes: np.ndarray, text: np.ndarray):
        """codes [1, 1, n] and phones [1, N] right-padded to multiples of
        ``STREAM_PAD_MULTIPLE``, on the device with their lengths as 0-dim
        int64 tensors: (codes_pad, n, text_pad, N)."""
        n, N = codes.shape[-1], text.shape[-1]
        mult = sovits_model.STREAM_PAD_MULTIPLE
        codes_pad = np.zeros((1, 1, _round_up(max(n, 1), mult)), np.int64)
        codes_pad[..., :n] = codes.reshape(1, 1, -1)
        text_pad = np.zeros((1, _round_up(max(N, 1), mult)), np.int64)
        text_pad[..., :N] = text.reshape(1, -1)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        return dev(codes_pad), dev(np.int64(n)), dev(text_pad), dev(np.int64(N))

    @_on_card
    def _sovits_decode(self, sovits: Sovits, codes, text, ge, noise_scale=0.5, speed=1.0,
                       slice_indices=None, use_buckets=True, prompt=None):
        """Full decode (``SynthesizerTrn.decode`` with the bucketed flow and
        vocoder, ``models.py:406-425``).  codes [1, 1, n], text [1, N], ge
        [1, gin, 1 or n], ``slice_indices`` [2n, 2] (packed batches: each
        latent frame's text span).  At speed 1 with one ``ge`` and
        ``stream_vocoder="bucketed"`` the padded core runs (one CUDA graph per
        (codes, phones) bucket), else the exact core; either way flow⁻¹ +
        HiFi-GAN run at ``_flow_bucket``'s frames (``use_buckets=False``:
        past the configured buckets, the ladder only).  A v4 model takes
        :meth:`_v4_decode` with ``prompt``, the prompt clip's cache entry.
        Returns (audio [1, 1, frames·hop], MRTE attention [4, 2n, N]) in
        numpy."""
        if sovits.v4 is not None:
            return self._v4_decode(sovits, codes, text, ge, prompt, speed)
        cfg, p = sovits.cfg, sovits.params
        codes = np.asarray(codes, np.int64)
        text = np.asarray(text, np.int64)
        ge = ge.to(self.tts_config.dtype)
        n, N = codes.shape[-1], text.shape[-1]
        t50 = 2 * n
        if (speed == 1 and slice_indices is None and ge.shape[-1] == 1
                and self.stream_vocoder == "bucketed"):
            codes_pad, n_t, text_pad, N_t = self._padded(codes, text)
            Bc, Np = codes_pad.shape[-1], text_pad.shape[-1]
            # no cross-fade: a one-frame zero overlap and vsi 0
            y_ov = torch.zeros((1, cfg.hidden_channels, 1), dtype=ge.dtype, device=self.device)
            core = functools.partial(sovits_model.decode_core_stream_padded, p, cfg,
                                     overlap_len=1, blend=False)
            z_p, mask, attn, _ = self.sovits_graphs.run(
                p, ("core", Bc, Np), core, codes_pad, n_t, text_pad, N_t, ge,
                self._noise((1, cfg.inter_channels, 2 * Bc), noise_scale), y_ov,
                torch.zeros((), dtype=torch.int64, device=self.device))
            audio = self._flow_dec_bucketed(sovits, z_p, mask, ge, use_buckets, t_true=t50)
            with span("gsv.sovits.readback"):
                return audio, attn[0, :, :t50, :N].float().cpu().numpy()
        t_lat = int(t50 / speed) + 1 if speed != 1 else t50
        if slice_indices is not None:
            slice_indices = torch.as_tensor(np.asarray(slice_indices, np.int64),
                                            device=self.device)
        z_p, y_mask, attn, _, ge_out = _eager(
            functools.partial(sovits_model.decode_core, p, cfg, speed=speed,
                              slice_indices=slice_indices),
            torch.as_tensor(codes, device=self.device), torch.as_tensor(text, device=self.device),
            ge, self._noise((1, cfg.inter_channels, t_lat), noise_scale))
        audio = self._flow_dec_bucketed(sovits, z_p, y_mask, ge_out, use_buckets)
        with span("gsv.sovits.readback"):
            return audio, attn[0].float().cpu().numpy()

    @_on_card
    def _v4_decode(self, sovits: Sovits, codes, text, ge, prompt: dict, speed: float = 1.0):
        """GPT-SoVITS v4's decode (``using_vocoder_synthesis``, ``TTS.py``):
        ``decode_encp`` of the prompt's codes and phones (``fea_ref``) and of
        ``codes`` [1, 1, n] against ``text`` [1, N] (``fea_todo``, 4n frames),
        both with ``ge`` (:meth:`_encp`: a replay of the padded bucket's
        graph, else eagerly); T_min = min(prompt mel frames, ``fea_ref`` frames,
        ``T_ref``) of the prompt's last frames; then chunks of T_chunk − T_min
        new frames, each the CFM (:meth:`_cfm_chunk`) over ``fea_ref`` and the
        chunk's features with the prompt mel in front, the next chunk's
        prompt mel and ``fea_ref`` this chunk's last T_min frames; the
        chunks' mel denormalised and vocoded at 48 kHz (:meth:`_vocode_v4`).
        ``noise_scale`` has no part (the CFM's temperature is 1); ``speed``
        must be 1.  Sets ``_v4_stats`` (``cfm_s``, ``vocoder_s``,
        ``cfm_chunks``: each chunk's frames, prompt frames and steps).
        Returns (audio [1, 1, 480·4n], MRTE attention [4, 2n, N]) in numpy."""
        if speed != 1:
            raise NotImplementedError("GPT-SoVITS v4 runs at speed 1 only")
        v4 = sovits.v4
        ge = ge.to(self.tts_config.dtype)
        with span("gsv.sovits.encp"):
            # every copy from the host first: one after a launch waits for it
            ref_in = self._encp_inputs(prompt["prompt"], prompt["phones1"])
            todo_in = self._encp_inputs(codes, text)
            fea_ref, _ = self._encp(sovits, ref_in, ge)
            fea_todo, attn = self._encp(sovits, todo_in, ge)
        mel2 = prompt["mel_v4"]
        t_both = min(mel2.shape[-1], fea_ref.shape[-1])
        t_min = min(t_both, v4.t_ref)  # of the prompt's first t_both frames, the last t_min
        mel2, fea_ref = mel2[..., :t_both][..., -t_min:], fea_ref[..., :t_both][..., -t_min:]
        chunk_len = v4.t_chunk - t_min
        outs, chunks, cfm_s = [], [], 0.0
        for idx in range(0, fea_todo.shape[-1], chunk_len):
            part = fea_todo[..., idx: idx + chunk_len]
            fea = torch.cat([fea_ref, part], dim=-1)
            noise = self._cfm_noise((1, v4.dit.mel_dim, fea.shape[-1]))
            with span("gsv.sovits.cfm", device=True) as sp:
                new = self._cfm_chunk(sovits, fea, mel2, noise)[..., t_min:]
                sp.set(frames=fea.shape[-1], prompt=t_min, steps=v4.steps)
            cfm_s += sp.seconds
            chunks.append((int(fea.shape[-1]), int(t_min), v4.steps))
            outs.append(new)
            mel2, fea_ref = new[..., -t_min:], part[..., -t_min:]
        with span("gsv.sovits.vocoder", device=True) as voc:
            audio = self._vocode_v4(sovits, v4.denorm(torch.cat(outs, dim=-1)))
        self._v4_stats = {"cfm_s": cfm_s, "vocoder_s": voc.seconds, "cfm_chunks": chunks}
        return audio, attn[0].float().cpu().numpy()

    def _encp_buckets(self) -> tuple:
        """The padded ``decode_encp``'s (codes, phones) widths
        (``sovits_v4.encp_buckets``) up to the longest t2s sequence of
        ``gpt_cache``; none on the CPU or without ``gpt_cache``."""
        lengths = [s for _, s in self.tts_config.gpt_cache or ()]
        if self.device.type != "cuda" or not lengths:
            return (), ()
        return sovits_v4.encp_buckets(max(lengths))

    def _encp_inputs(self, codes, text) -> tuple:
        """One ``decode_encp`` call's inputs on the device, from one copy:
        (bucket, n, N, inputs).  In a bucket (``sovits_v4.encp_bucket``) the
        codes and phones right-padded to it, each followed by its length as a
        0-dim int64 tensor; else (bucket None) as they are, [1, 1, n] and
        [1, N]."""
        codes = np.asarray(codes, np.int64).reshape(-1)
        text = np.asarray(text, np.int64).reshape(-1)
        n, N = codes.size, text.size
        bucket = sovits_v4.encp_bucket(self._encp_buckets(), n, N)
        if bucket is None:
            d = torch.as_tensor(np.concatenate([codes, text]), device=self.device)
            return None, n, N, (d[:n].reshape(1, 1, n), d[n:].reshape(1, N))
        Bc, Np = bucket
        buf = np.zeros(Bc + Np + 2, np.int64)
        buf[:n], buf[Bc:Bc + N], buf[-2:] = codes, text, (n, N)
        d = torch.as_tensor(buf, device=self.device)
        return bucket, n, N, (d[:Bc].reshape(1, 1, Bc), d[-2], d[Bc:Bc + Np].reshape(1, Np),
                              d[-1])

    def _encp(self, sovits: Sovits, encp_in: tuple, ge):
        """``decode_encp`` of :meth:`_encp_inputs`' call with ``ge``: in a
        bucket a replay of its CUDA graph (``("encp", Bc, Np)``,
        ``gsv.sovits.encp.replay``) cut to the exact call's fea [1, bridge,
        4n] and attention [1, 4, 2n, N]; else the exact function, eagerly
        (``gsv.sovits.encp.eager``)."""
        cfg, v4, p = sovits.cfg, sovits.v4, sovits.params
        bucket, n, N, inputs = encp_in
        if bucket is None:
            with span("gsv.sovits.encp.eager"):
                return sovits_v4.decode_encp(p, cfg, v4, *inputs, ge)
        key = ("encp",) + bucket
        with span("gsv.sovits.encp.replay"):
            fea, attn = self.sovits_graphs.run(
                p, key, functools.partial(sovits_v4.decode_encp_padded, p, cfg, v4),
                *inputs, ge)
        return fea[..., :4 * n], attn[:, :, :2 * n, :N]

    def _capture_encp(self, sovits: Sovits):
        """Capture the padded ``decode_encp`` of a v4 model at every bucket of
        :meth:`_encp_buckets` (nothing on the CPU)."""
        codes_w, phones_w = self._encp_buckets()
        ge = torch.zeros((1, sovits.cfg.gin_channels, 1), dtype=self.tts_config.dtype,
                         device=self.device)
        with torch.no_grad():
            for Bc in codes_w:
                for Np in phones_w:
                    self._encp(sovits, self._encp_inputs(np.zeros(Bc), np.zeros(Np)), ge)

    def _cfm_noise(self, shape) -> torch.Tensor:
        """A chunk's CFM noise, standard normal float32, from the facade's generator."""
        with self._rng_lock:
            return torch.randn(shape, generator=self.generator, device=self.device,
                               dtype=torch.float32)

    def _cfm_chunk(self, sovits: Sovits, fea, prompt_mel, noise):
        """One chunk's Euler loop (``models/cfm.py:cfm_chunk``): fea [1, 512,
        T], prompt_mel [1, 100, P] (normalised), noise [1, 100, T] → the mel
        [1, 100, T] float32 (zero over the prompt), on the device.  Each step
        replays the CUDA graph of an Euler step at T frames (``("cfm", T)``,
        captured the first time T is seen and kept: whole chunks all have
        ``T_chunk`` frames, a last chunk at most ``T_chunk`` others)."""
        run = functools.partial(self.sovits_graphs.run, sovits.params, ("cfm", fea.shape[-1]))
        return cfm_model.cfm_chunk(sovits.params, sovits.v4.dit, fea, prompt_mel, noise, run=run)

    @_on_card
    def _vocode_v4(self, sovits: Sovits, mel) -> np.ndarray:
        """The 48 kHz vocoder on mel [1, 100, F] (denormalised), padded with
        zeros to ``_flow_bucket(F)`` frames (``sovits_cache`` counts 100 Hz
        mel frames for a v4 model), one CUDA graph per bucket on the card,
        every layer cut at F frames (``sovits_v4.vocode``), so that the audio,
        cut to F frames on the host, is the vocoder's at F frames: [1, 1,
        480·F] numpy."""
        v4 = sovits.v4
        t = mel.shape[-1]
        target = self._flow_bucket(t)
        mel = F.pad(mel.to(self.tts_config.dtype), (0, target - t))
        frames = torch.full((1,), t, dtype=torch.int64, device=mel.device)
        fn = functools.partial(sovits_v4.vocode, sovits.vocoder, v4)
        audio, = self.sovits_graphs.run(sovits.vocoder, ("vocoder", target), fn, mel, frames)
        with span("gsv.sovits.readback"):
            return audio.float().cpu().numpy()[:, :, : t * v4.vocoder.samples_per_frame]

    def _prompt_mel(self, path, v4: sovits_v4.V4Config) -> torch.Tensor:
        """v4's normalised mel of a prompt clip at 32 kHz (``mel_fn_v4``,
        ``norm_spec``), [1, 100, frames] float32 on the device."""
        with span("gsv.voice.mel"):
            wav, sr = load_audio(path)
            wav = np.asarray(wav, np.float32)
            wav = wav.mean(axis=0, keepdims=True) if wav.ndim == 2 else wav[None]
            wav = stft.resample(wav, sr, v4.mel_rate)
            mel = stft.mel_v4(torch.as_tensor(wav, device=self.device), v4.mel_rate,
                              v4.n_fft, v4.hop, v4.dit.mel_dim)
            return v4.norm(mel)

    @_on_card
    def _sovits_decode_stream(self, sovits: Sovits, codes, text, ge, noise_scale, speed,
                              y_overlap, valid_start_idx: int, overlap_len: int):
        """One streaming chunk: the latent of the cumulative ``codes``
        [1, 1, n] from frame ``valid_start_idx`` on, cross-faded with
        ``y_overlap``, through flow⁻¹ and HiFi-GAN.  Bucketed (speed 1, one
        ``ge``, ``stream_vocoder="bucketed"``): the whole chunk as one
        :func:`runtime.vocoder_batch.stream_batch_fused` call at B=1, one CUDA
        graph per (codes, phones, flow bucket, overlap); else the exact core.
        Returns (audio [1, 1, valid frames·hop], MRTE attention [4, 2n, N],
        the new overlap [1, hidden, overlap_len] on the device)."""
        cfg, p = sovits.cfg, sovits.params
        codes = np.asarray(codes, np.int64)
        text = np.asarray(text, np.int64)
        ge = ge.to(self.tts_config.dtype)
        n, N = codes.shape[-1], text.shape[-1]
        t_valid = 2 * n - valid_start_idx
        if speed == 1 and ge.shape[-1] == 1 and self.stream_vocoder == "bucketed":
            codes_pad, n_t, text_pad, N_t = self._padded(codes, text)
            Bc, Np = codes_pad.shape[-1], text_pad.shape[-1]
            blend = y_overlap is not None
            y_ov = y_overlap if blend else torch.zeros(
                (1, cfg.hidden_channels, overlap_len), dtype=ge.dtype, device=self.device)
            bucket = self._flow_bucket(t_valid)
            chunk = functools.partial(stream_batch_fused, p, cfg, overlap_len=overlap_len,
                                      bucket=bucket)
            audio, attn, new_overlap = self.sovits_graphs.run(
                p, ("chunk", Bc, Np, bucket, overlap_len), chunk, codes_pad,
                n_t.reshape(1), text_pad, N_t.reshape(1), ge,
                self._noise((1, cfg.inter_channels, 2 * Bc), noise_scale), y_ov,
                torch.full((1,), valid_start_idx, device=self.device),
                torch.full((1,), blend, device=self.device))
            audio = audio.float().cpu().numpy()[:, :, : t_valid * cfg.samples_per_frame]
            return audio, attn[0, :, :2 * n, :N].float().cpu().numpy(), new_overlap
        t_lat = int(t_valid / speed) + 1 if speed != 1 else t_valid
        z_p, y_mask, attn, new_overlap, ge_out = _eager(
            functools.partial(sovits_model.decode_core, p, cfg, speed=speed,
                              y_overlap=y_overlap, valid_start_idx=valid_start_idx,
                              overlap_len=overlap_len),
            torch.as_tensor(codes, device=self.device), torch.as_tensor(text, device=self.device),
            ge, self._noise((1, cfg.inter_channels, t_lat), noise_scale))
        audio = self._flow_dec_bucketed(sovits, z_p, y_mask, ge_out, True)
        return audio, attn[0].float().cpu().numpy(), new_overlap

    def _flow_bucket(self, t: int, use_buckets: bool = True) -> int:
        """Frame bucket of a t-frame flow/vocoder run: the first configured
        ``sovits_cache`` bucket that fits (with ``use_buckets``), else the
        ×1.5 ladder above the largest rounded up to 64, else t itself
        (``sovits_cache=[]``: exact shapes)."""
        buckets = self.tts_config.sovits_cache
        if use_buckets:
            for b in buckets:
                if b >= t:
                    return b
        if not buckets:
            return t
        target = max(buckets)
        while target < t:
            target = _round_up(int(target * 1.5) + 1, 64)
        return target

    @_on_card
    def _flow_dec_bucketed(self, sovits: Sovits, z_p, y_mask, ge, use_buckets: bool,
                           t_true: Optional[int] = None) -> np.ndarray:
        """flow⁻¹ + HiFi-GAN with ``z_p`` and its mask padded with zeros (or
        cut) to ``_flow_bucket`` frames, then the audio trimmed to the ``t``
        valid frames on the host; ``t_true`` names them when ``z_p`` arrives
        padded.  With one ``ge`` the run is a CUDA graph per bucket on the
        card; a frame-wise ``ge`` (a packed batch) is padded too and runs
        eagerly.  Returns audio [1, 1, t·hop] in numpy."""
        cfg, p = sovits.cfg, sovits.params
        t = t_true if t_true is not None else z_p.shape[-1]
        target = self._flow_bucket(t, use_buckets)
        pad = target - z_p.shape[-1]  # negative: cut
        z_p, y_mask = F.pad(z_p, (0, pad)), F.pad(y_mask, (0, pad))
        flow = functools.partial(sovits_model.flow_dec, p, cfg)
        if ge.shape[-1] == 1:
            audio, = self.sovits_graphs.run(p, ("flow", target), flow, z_p, y_mask, ge)
        else:
            audio, = _eager(flow, z_p, y_mask, F.pad(ge, (0, pad)))
        with span("gsv.sovits.readback"):
            return audio.float().cpu().numpy()[:, :, : t * cfg.samples_per_frame]

    def _get_spec(self, hps, filename):
        """Linear spectrogram of the speaker audio at the model's rate, on the
        device, and the audio resampled to 16 kHz (numpy [1, T]) for the
        speaker embedder (reference ``TTS.py:1578-1610``)."""
        sr1 = int(hps.data.sampling_rate)
        with span("gsv.voice.load"):
            audio, sr0 = load_audio(filename)
            audio = np.asarray(audio, np.float32)
            if audio.ndim == 2 and audio.shape[0] > 1:
                audio = audio.mean(axis=0, keepdims=True)
            elif audio.ndim == 1:
                audio = audio[None]
            if sr0 != sr1:
                audio = stft.resample(audio, sr0, sr1)
            maxx = np.abs(audio).max()
            if maxx > 1:
                audio = audio / min(2.0, maxx)
            audio16k = stft.resample(audio, sr1, 16000)
        with span("gsv.voice.spec"):
            spec = stft.spectrogram(torch.as_tensor(audio, device=self.device),
                                    hps.data.filter_length, hps.data.hop_length,
                                    hps.data.win_length)
            return spec.to(self.tts_config.dtype), audio16k

    def _get_prompt(self, cnhubert_model, sovits: Sovits, audio_path) -> np.ndarray:
        """Prompt semantic tokens: HuBERT features → RVQ codes."""
        with span("gsv.voice.load"):
            wav, sr = load_audio(audio_path)
            wav16k = stft.resample(np.asarray(wav, np.float32), sr, 16000).mean(axis=0)
            wav16k = np.concatenate([wav16k, np.zeros(int(16000 * 0.3), np.float32)])
        with torch.no_grad(), span("gsv.voice.hubert"):
            ssl = cnhubert_model(wav16k[None]).transpose(1, 2)
            n_codes = None
            if self.tts_config.featurizer_buckets:
                # RVQ is per frame and ssl_proj a strided conv without
                # padding: zero frames up to a multiple of 64, then codes cut
                n_frames = ssl.shape[-1]
                k = sovits.params["ssl_proj.weight"].shape[-1]
                n_codes = (n_frames - k) // 2 + 1
                ssl = F.pad(ssl, (0, -(-n_frames // 64) * 64 - n_frames))
            with span("gsv.voice.hubert.codes"):
                codes = sovits_model.extract_latent(sovits.params, ssl)[..., :n_codes]
                return codes[0, 0].cpu().numpy()

    def _contains_chinese(self, text: str) -> bool:
        return any(seg["lang"] == "zh" for seg in LangSegment.getTexts(text))

    def _ensure_bert_loaded(self):
        if self._bert_loaded or not self.auto_bert:
            return
        self._load_bert()

    def _load_bert(self):
        """Load the BERT featurizer from ``cnroberta_path`` into the config
        the frontend reads.  A missing directory is fetched first
        (``download.download_bert``, unless ``GSV_OFFLINE`` is set); if it is
        still missing, zero BERT features and a warning, once."""
        from .models.roberta import CNRoberta

        try:
            self.tts_config.cnroberta = CNRoberta(self.cnroberta_path, self.tts_config)
            logger.info("BERT model loaded for Chinese text")
        except FileNotFoundError:
            from .download import download_bert

            if download_bert(self.models_dir):
                try:
                    self.tts_config.cnroberta = CNRoberta(self.cnroberta_path, self.tts_config)
                    self._bert_loaded = True
                    logger.info("BERT model downloaded and loaded")
                    return
                except FileNotFoundError:
                    pass
            logger.warning("BERT model files not found; Chinese synthesis will use zero BERT "
                           "features")
        self._bert_loaded = True  # not retried on every call

    def _mute_scale(self, text_cut: str, scale_map: dict) -> float:
        if text_cut and text_cut[-1] in scale_map:
            return scale_map[text_cut[-1]]
        if "…" in scale_map and text_cut[-3:] in ("...", "。。。"):
            return scale_map["…"]
        return 1.0

    def _check_pause(self, text: str) -> bool:
        return text.endswith(self.punctuation) or text[-3:] in ("...", "。。。")

    # -- subtitles -------------------------------------------------------

    def _utterance_subtitles(self, word2ph, attn, speed, norm_text, text) -> List[dict]:
        """Subtitles of one whole utterance from its MRTE attention, with the
        tail rule (``TTS.py:262-270``): the last word appended when the last
        subtitle is no pause, its end +0.2 s, then text indices."""
        subtitles = self._get_subtitles(word2ph, dsp.viterbi_monotonic(attn), speed)
        if subtitles:
            if not self._check_pause(subtitles[-1]["text"]):
                subtitles.append({"text": word2ph["word"][-1],
                                  "start_s": subtitles[-1]["end_s"],
                                  "end_s": subtitles[-1]["end_s"]})
            subtitles[-1]["end_s"] += 0.2
            subtitles = sub2text_index(subtitles, norm_text, text)
        return subtitles

    def _get_subtitles(self, word2ph, assign, speed, last_end_s=0.0) -> List[dict]:
        """Word timings from the frame→phone assignment (reference
        ``_get_subtitles``, ``TTS.py:1664-1707``)."""
        frame_time = (1 / self.sovits_hz) / speed
        assign = np.asarray(assign)
        ph_end_s = []
        cur_ph = int(assign[0])
        for f in range(1, assign.shape[-1]):
            ph = int(assign[f])
            if ph != cur_ph:
                ph_end_s.append(f * frame_time)
                cur_ph = ph
        ph_end_s.append(assign.shape[-1] * frame_time)

        idx = -1
        end_s = last_end_s + ph_end_s.pop(0) if assign[0] == -1 else last_end_s
        subtitles = []
        word = ""
        for word, ph in zip(word2ph["word"], word2ph["ph"]):
            idx += ph
            if idx >= len(ph_end_s):
                break
            start_s, end_s = end_s, ph_end_s[idx] + last_end_s
            subtitles.append({"text": word, "start_s": start_s, "end_s": end_s})
        # the entry covering the tail (``TTS.py:1697-1705``), also when the
        # loop broke before its first entry; an assignment all on the null
        # key (``ph_end_s`` emptied above) gives no subtitles
        if word and ph_end_s and end_s - last_end_s != ph_end_s[-1]:
            subtitles.append({"text": word, "start_s": end_s,
                              "end_s": ph_end_s[-1] + last_end_s})
        return subtitles

    def _find_subtitles(self, subtitles, word2ph, last_i) -> int:
        """End index of the run of ``subtitles`` from ``last_i`` on whose
        words are ``word2ph``'s (a packed batch's segment)."""
        target = " ".join(word2ph["word"])
        w = len(word2ph["word"])
        for i in range(last_i, len(subtitles) - w + 1):
            if " ".join(s["text"] for s in subtitles[i:i + w]) == target:
                break
        else:
            i = len(subtitles) - w
        return i + w

    def _cat_subtitles(self, *subtitles_list) -> List[dict]:
        """Segments' subtitles chained in time, each list shifted to start
        where the previous ended."""
        last_end_s = 0.0
        result = []
        for subtitles in subtitles_list:
            if not subtitles:
                continue
            m = subtitles[0]["start_s"] - last_end_s
            for s in subtitles:
                s["start_s"] -= m
                s["end_s"] -= m
                result.append(s)
            last_end_s = subtitles[-1]["end_s"]
        return result

    def _increment_subtitle_indices(self, subtitles, increment):
        for s in subtitles:
            s["orig_idx_start"] += increment
            s["orig_idx_end"] += increment

    def _increment_subtitle_times(self, subtitles, increment):
        for s in subtitles:
            s["start_s"] += increment
            if s["end_s"]:
                s["end_s"] += increment


def sovits_model_ge(model: Sovits, refers: torch.Tensor, sv_emb=None) -> torch.Tensor:
    """Speaker conditioning vector [1, gin, 1] for a loaded SoVITS model
    (``sv_emb``: the clip's speaker embedding, which a v2Pro model adds)."""
    return sovits_model.get_ge(model.params, model.cfg, refers, sv_emb)
