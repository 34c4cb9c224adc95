"""TTS engine facade (counterpart of ``gsv_tts_tpu/tts.py``): model
registry, speaker/prompt audio caches, single-utterance ``infer``, streaming
``infer_stream`` and batched ``infer_batched``.

Pipeline: text → English frontend (host) → t2s engine (prefill, then one
whole-step kernel per decode step by default: K1 for one utterance, K2 for a
continuous-batched wave, the generic step with K3b for waves above K2's
limit; ``attn_impl`` selects the K4 / K3b or the K6 paths instead) → SoVITS
decode at the exact shape (packed, with block-diagonal MRTE masks, in the
batched mode; chunk by chunk over the cumulative tokens with a latent
cross-fade and SOLA stitching in the streaming mode) → host trim.  Not
ported yet (ROADMAP Queue 1): subtitles, speed != 1, the bucket-padded
stream vocoder and batched streaming, voice conversion, Chinese and Japanese
text, v2Pro speaker verification.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import dsp
from .config import Config, global_config
from .frontend.pause import pause_map
from .frontend.text_processor import cut_text, get_phones_and_bert
from .loader import Gpt, Sovits, get_gpt_weights, get_sovits_weights
from .models import sovits as sovits_model
from .ops import stft
from .player import AudioClip
from .utils.audio_io import load_audio

logger = logging.getLogger(__name__)

DEFAULT_MUTE_SCALE = {"…": 2.0, ".": 1.5, "。": 1.5, "?": 1.5, "？": 1.5,
                      "!": 1.5, "！": 1.5, ",": 1.0, "，": 1.0, ":": 1.0,
                      "：": 1.0, ";": 1.0, "；": 1.0, "~": 1.0, "、": 0.8,
                      "・": 0.8}


class _SegStream:
    """Incremental vocoder state of one text segment of ``infer_stream``
    (the JAX ``_SegStream`` without its subtitle and batcher branches):
    chunked SoVITS decode over the cumulative tokens with the latent
    cross-fade (``y_overlap``), SOLA waveform stitching, head trim on the
    first chunk and the mute pad after the last (reference
    ``TTS.py:415-476``)."""

    __slots__ = ("tokens", "phones2", "ge", "text_cut", "_y_overlap", "_vsi",
                 "_last_overlap", "_chunk_idx")

    def __init__(self, phones2, ge, text_cut):
        self.tokens: List[int] = []
        self.phones2 = phones2
        self.ge = ge
        self.text_cut = text_cut
        self._y_overlap = None  # the previous chunk's last latent frames
        self._vsi = 0           # latent frames already voiced
        self._last_overlap = None  # the previous chunk's last samples
        self._chunk_idx = 0

    def step(self, tts: "TTS", sovits, final: bool, *, noise_scale: float, overlap_len: int,
             cut_mute: float, cut_mute_scale_map: dict) -> np.ndarray:
        """One vocode pass over the cumulative tokens; returns the new audio
        (float32)."""
        overlap_samples = overlap_len * sovits.cfg.samples_per_frame
        semantic = np.asarray(self.tokens, np.int64)
        if semantic.size:
            audio, n_frames, self._y_overlap = tts._sovits_decode_stream(
                sovits, semantic[None, None, :], np.asarray(self.phones2, np.int64)[None],
                self.ge, noise_scale=noise_scale, y_overlap=self._y_overlap,
                valid_start_idx=self._vsi, overlap_len=overlap_len)
            audio = audio.reshape(-1)
            if self._last_overlap is not None:
                audio, _ = dsp.sola_align(self._last_overlap, audio, overlap_samples)
            self._last_overlap = audio[-overlap_samples:].copy()
            if not final:
                audio = audio[:-overlap_samples]
                self._vsi = n_frames - overlap_len
            if self._chunk_idx == 0:
                audio = audio[dsp.find_head_threshold_offset(audio):]
            self._chunk_idx += 1
        else:
            audio = np.zeros(0, np.float32)
        if final:
            scale = tts._mute_scale(self.text_cut, cut_mute_scale_map)
            audio = np.concatenate(
                [audio, np.zeros(int(cut_mute * scale * tts.samplerate), np.float32)])
        return audio.astype(np.float32)


#: the t2s KV-cache buckets ``TTS()`` takes, the JAX facade's: B=1 lengths for
#: ``infer`` and waves of 4 slots for ``infer_batched`` (a wave takes the
#: smallest bucket with B >= its texts, so without a B=4 bucket a batch would
#: decode one text at a time)
DEFAULT_GPT_CACHE = ((1, 512), (1, 768), (1, 1024), (4, 512), (4, 1024))


class TTS:
    """Engine facade.  ``device`` and ``dtype`` follow ``Config``'s policy:
    the engine runs on the card in bf16 and raises when there is none, unless
    the caller asks for ``device="cpu"`` (then f32).  ``seed`` seeds the explicit generator every
    random draw (Gumbel noise, SoVITS latent noise) comes from.
    ``attn_impl`` names the t2s engine's kernels (``Config.attn_impl``)."""

    def __init__(self, gpt_cache: List[tuple] = DEFAULT_GPT_CACHE,
                 models_dir: Optional[str] = None, device: Optional[str] = None,
                 dtype: Optional[str] = None, seed: Optional[int] = None,
                 attn_impl: str = "fused_step"):
        self.tts_config = Config(device=device, dtype=dtype, gpt_cache=list(gpt_cache),
                                 attn_impl=attn_impl)
        if models_dir is None:
            models_dir = Path.home() / ".cache" / "gsv"
        self.models_dir = Path(models_dir)
        self.tts_config.models_dir = self.models_dir
        if global_config.models_dir is None:
            global_config.models_dir = self.models_dir
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
        self.default_gpt_path = self.models_dir / "s1v3.ckpt"
        self.default_sovits_path = self.models_dir / "s2Gv2ProPlus.pth"
        self.cnhubert_model = None
        self.punctuation = tuple(pause_map.keys())
        self.samplerate = 32000
        #: stage wall times (s) and decode counts of the last ``infer``,
        #: ``infer_batched`` or ``infer_stream`` (``ttfa_s``: time to the
        #: first audio chunk)
        self.last_timings: Dict[str, float] = {}
        logger.info("Device: %s, dtype: %s", self.device, self.tts_config.dtype)

    # -- model registry --------------------------------------------------

    def load_gpt_model(self, *model_paths):
        for path in model_paths or (self.default_gpt_path,):
            self.gpt_models[path] = get_gpt_weights(path, self.tts_config)
            logger.info("Loaded GPT model: %s", path)

    def load_sovits_model(self, *model_paths):
        for path in model_paths or (self.default_sovits_path,):
            self.sovits_models[path] = get_sovits_weights(path, self.tts_config)
            logger.info("Loaded SoVITS model: %s", path)

    def _get_cnhubert(self):
        if self.cnhubert_model is None:
            from .models.hubert import CNHubert

            self.cnhubert_model = CNHubert(str(self.cnhubert_path), self.tts_config)
        return self.cnhubert_model

    # -- caches ----------------------------------------------------------

    def cache_spk_audio(self, *spk_audio_paths, sovits_model: Optional[str] = None):
        if not self.sovits_models:
            raise RuntimeError("No SoVITS model is loaded; cannot cache speaker audio.")
        if sovits_model is None:
            sovits_model = next(iter(self.sovits_models))
        model = self.sovits_models[sovits_model]
        for path in spk_audio_paths:
            refers = self._get_spec(model.hps, path)
            with torch.no_grad():
                ge = sovits_model_ge(model, refers)
            self.spk_audio_cache.setdefault(path, {"ge": {}})["ge"][sovits_model] = ge
            logger.info("Cached speaker audio: %s", path)

    def cache_prompt_audio(self, prompt_audio_paths, prompt_audio_texts):
        if not self.sovits_models:
            raise RuntimeError("No SoVITS model is loaded; cannot cache prompt audio.")
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
            phones1, _, bert1, _ = get_phones_and_bert(text, self.tts_config)
            self.prompt_audio_cache[path] = {"prompt": prompt, "phones1": phones1,
                                             "bert1": bert1}
            logger.info("Cached prompt audio: %s", path)

    # -- inference -------------------------------------------------------

    def infer(self, spk_audio_path, prompt_audio_path, prompt_audio_text, text,
              return_subtitles: bool = False, top_k: int = 15, top_p: float = 1.0,
              temperature: float = 1.0, repetition_penalty: float = 1.35,
              noise_scale: float = 0.5, speed: float = 1.0,
              gpt_model=None, sovits_model=None) -> AudioClip:
        """Single-utterance synthesis (reference ``TTS.py:149-286``)."""
        if return_subtitles:
            raise NotImplementedError("subtitles are not ported yet (ROADMAP Queue 1: subtitles)")
        if speed != 1.0:
            raise NotImplementedError("speed != 1 is not ported yet (ROADMAP Queue 1)")
        if not self._check_pause(text):
            text += "."
        gpt_model, sovits_model = self._default_models(gpt_model, sovits_model)
        sovits, ge = self._prepare_sovits_resources(sovits_model, spk_audio_path)
        gpt, cache = self._prepare_gpt_resources(gpt_model, prompt_audio_path,
                                                 prompt_audio_text)

        t0 = time.perf_counter()
        phones2, _, bert2, _ = get_phones_and_bert(text, self.tts_config)
        all_phones = np.asarray(cache["phones1"] + phones2, np.int64)
        bert = np.concatenate([np.asarray(cache["bert1"], np.float32),
                               np.asarray(bert2, np.float32)], axis=0)
        t1 = time.perf_counter()
        with torch.no_grad():
            semantic = gpt.engine.generate(
                all_phones, cache["prompt"], bert, top_k=top_k, top_p=top_p,
                temperature=temperature, repetition_penalty=repetition_penalty,
                generator=self.generator).reshape(-1)
            t2 = time.perf_counter()
            audio = self._sovits_decode(sovits, semantic[None, None, :],
                                        np.asarray(phones2, np.int64)[None], ge,
                                        noise_scale=noise_scale).reshape(-1)
        t3 = time.perf_counter()
        self.last_timings = {"frontend_s": t1 - t0, "t2s_s": t2 - t1, "sovits_s": t3 - t2,
                             "tokens": int(semantic.size), **gpt.engine.last_stats}

        head_offset = dsp.find_head_threshold_offset(audio)
        audio = audio[head_offset:]
        max_audio = np.abs(audio).max() if audio.size else 0.0
        if max_audio > 1:
            audio = audio / max_audio
        audio = np.concatenate([audio, np.zeros(int(0.2 * self.samplerate), audio.dtype)])
        return AudioClip(audio.astype(np.float32), self.samplerate,
                         len(audio) / self.samplerate, [], text)

    def infer_stream(self, spk_audio_path, prompt_audio_path, prompt_audio_text, text,
                     return_subtitles: bool = False, is_cut_text: bool = True,
                     cut_minlen: int = 10, cut_mute: float = 0.4,
                     cut_mute_scale_map: dict = DEFAULT_MUTE_SCALE,
                     stream_mode: str = "token", stream_chunk: int = 25,
                     overlap_len: int = 5, boost_first_chunk: bool = True, top_k: int = 15,
                     top_p: float = 1.0, temperature: float = 1.0,
                     repetition_penalty: float = 1.35, noise_scale: float = 0.5,
                     speed: float = 1.0, gpt_model=None, sovits_model=None):
        """Streaming synthesis (reference ``TTS.py:288-504``): a generator
        of ``AudioClip`` chunks.  The t2s decode is cut into chunks of
        ``stream_chunk`` tokens (``stream_mode="sentence"``: one chunk per
        text segment); each chunk is vocoded over the cumulative tokens with
        a latent cross-fade of ``overlap_len`` frames and stitched to the
        previous one by SOLA.  ``boost_first_chunk`` sends the first chunk of
        the first segment out without holding it back for its successor.
        ``last_timings["ttfa_s"]`` is the time to the first chunk."""
        if return_subtitles:
            raise NotImplementedError("subtitles are not ported yet (ROADMAP Queue 1: subtitles)")
        if speed != 1.0:
            raise NotImplementedError("speed != 1 is not ported yet (ROADMAP Queue 1)")
        if not self._check_pause(text):
            text += "."
        if stream_mode == "sentence":
            stream_chunk = 10000
        if not is_cut_text:
            cut_minlen = 10000
        gpt_model, sovits_model = self._default_models(gpt_model, sovits_model)
        sovits, ge = self._prepare_sovits_resources(sovits_model, spk_audio_path)
        gpt, cache = self._prepare_gpt_resources(gpt_model, prompt_audio_path,
                                                 prompt_audio_text)

        audio_len_s = 0.0
        t_start = time.perf_counter()
        self.last_timings = {}
        for i, text_cut in enumerate(cut_text(text, cut_minlen)):
            phones2, _, bert2, _ = get_phones_and_bert(text_cut, self.tts_config)
            all_phones = np.asarray(cache["phones1"] + phones2, np.int64)
            bert = np.concatenate([np.asarray(cache["bert1"], np.float32),
                                   np.asarray(bert2, np.float32)], axis=0)
            seg = _SegStream(phones2, ge, text_cut)
            chunks = gpt.engine.generate(
                all_phones, cache["prompt"], bert, top_k=top_k, top_p=top_p,
                temperature=temperature, repetition_penalty=repetition_penalty,
                generator=self.generator, stream_chunk=stream_chunk,
                boost_first_chunk=boost_first_chunk and i == 0)
            while True:
                # grad mode is switched off only while this generator runs,
                # never across a yield
                with torch.no_grad():
                    item = next(chunks, None)
                    if item is None:
                        break
                    pred_semantic, is_final = item
                    seg.tokens = list(np.asarray(pred_semantic).reshape(-1))
                    if not seg.tokens and not is_final:
                        continue
                    audio = seg.step(self, sovits, is_final, noise_scale=noise_scale,
                                     overlap_len=overlap_len, cut_mute=cut_mute,
                                     cut_mute_scale_map=cut_mute_scale_map)
                audio_len_s += len(audio) / self.samplerate
                self.last_timings.setdefault("ttfa_s", time.perf_counter() - t_start)
                self.last_timings.update(gpt.engine.last_stats)
                yield AudioClip(audio, self.samplerate, audio_len_s, [], text)

    def _prepare_batched_inputs(self, spk_audio_paths, prompt_audio_paths,
                                prompt_audio_texts, texts, is_cut_text, cut_minlen,
                                bert_batch_size, gpt_model, sovits_model):
        """Front half of the batched mode: expand per-request inputs, cut
        texts into engine-request segments, featurize, and gather
        prompt/speaker resources per segment."""
        if isinstance(texts, str):
            texts = [texts]
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

        all_phones2, all_bert2 = [], []
        for i in range(0, len(all_segments), bert_batch_size):
            p2, _, b2, _ = get_phones_and_bert(all_segments[i: i + bert_batch_size],
                                               self.tts_config)
            all_phones2 += p2
            all_bert2 += b2

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
                xs, ys, berts, all_ge)

    def infer_batched(self, spk_audio_paths, prompt_audio_paths, prompt_audio_texts, texts,
                      return_subtitles: bool = False, is_cut_text: bool = True,
                      cut_minlen: int = 10, cut_mute: float = 0.4,
                      cut_mute_scale_map: dict = DEFAULT_MUTE_SCALE, top_k: int = 15,
                      top_p: float = 1.0, temperature: float = 1.0,
                      repetition_penalty: float = 1.35, noise_scale: float = 0.5,
                      speed: float = 1.0, bert_batch_size: int = 20,
                      sovits_batch_size: int = 10, gpt_model=None, sovits_model=None):
        """Batched synthesis (reference ``TTS.py:506-868``): continuous-batched
        t2s, then packed SoVITS decodes with block-diagonal MRTE masks.
        Returns one ``AudioClip`` per text."""
        if return_subtitles:
            raise NotImplementedError("subtitles are not ported yet (ROADMAP Queue 1: subtitles)")
        if speed != 1.0:
            raise NotImplementedError("speed != 1 is not ported yet (ROADMAP Queue 1)")
        t0 = time.perf_counter()
        (gpt, sovits, orig_texts, texts, segment_to_original, all_phones2,
         xs, ys, berts, all_ge) = self._prepare_batched_inputs(
            spk_audio_paths, prompt_audio_paths, prompt_audio_texts, texts, is_cut_text,
            cut_minlen, bert_batch_size, gpt_model, sovits_model)
        t1 = time.perf_counter()

        with torch.no_grad():
            pred_semantic, semantic_orig_idx = gpt.engine.generate_batched(
                xs, ys, berts, top_k=top_k, top_p=top_p, temperature=temperature,
                repetition_penalty=repetition_penalty, generator=self.generator)
        t2 = time.perf_counter()

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
                audio_batch = self._sovits_decode(
                    sovits, curr_sem, curr_phones, curr_ge, noise_scale=noise_scale,
                    slice_indices=slice_indices).reshape(-1)
            max_audio = np.abs(audio_batch).max() if audio_batch.size else 0.0
            if max_audio > 1.0:
                audio_batch = audio_batch / max_audio

            last_len = 0
            for n in cur_lens:
                cur_len = last_len + int(n) * 2 * sovits.cfg.samples_per_frame
                audio = audio_batch[last_len:cur_len]
                last_len = cur_len
                ho = dsp.find_head_threshold_offset(audio)
                to = dsp.find_tail_threshold_offset(audio)
                generated_audios.append(audio[ho: len(audio) - to])
        t3 = time.perf_counter()
        self.last_timings = {"frontend_s": t1 - t0, "t2s_s": t2 - t1, "sovits_s": t3 - t2,
                             "tokens": int(lengths.sum()), "requests": len(texts),
                             **gpt.engine.last_stats}

        ordered_audios = [None] * len(generated_audios)
        for cur_pos, orig_pos in enumerate(semantic_orig_idx.tolist()):
            ordered_audios[orig_pos] = generated_audios[cur_pos]

        final_audios = [[] for _ in orig_texts]
        for i, audio_data in enumerate(ordered_audios):
            oi = segment_to_original[i]
            final_audios[oi].append(audio_data)
            scale = self._mute_scale(texts[i], cut_mute_scale_map)
            final_audios[oi].append(
                np.zeros(int(cut_mute * scale * self.samplerate), audio_data.dtype))

        result = []
        for audio_list, orig_text in zip(final_audios, orig_texts):
            audio = np.concatenate(audio_list)
            result.append(AudioClip(audio.astype(np.float32), self.samplerate,
                                    len(audio) / self.samplerate, [], orig_text))
        return tuple(result)

    # -- internals -------------------------------------------------------

    def _default_models(self, gpt_model, sovits_model):
        if gpt_model is None:
            gpt_model = next(iter(self.gpt_models)) if self.gpt_models else self.default_gpt_path
        if sovits_model is None:
            sovits_model = (next(iter(self.sovits_models)) if self.sovits_models
                            else self.default_sovits_path)
        return gpt_model, sovits_model

    def _prepare_sovits_resources(self, sovits_model, spk_audio_path):
        """The loaded SoVITS model and the speaker conditioning ``ge`` for
        ``spk_audio_path`` — a path, or a ``{path: weight}`` dict blending
        several speakers."""
        if sovits_model not in self.sovits_models:
            self.load_sovits_model(sovits_model)
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

    def _prepare_gpt_resources(self, gpt_model, prompt_audio_path, prompt_audio_text):
        """The loaded t2s model and the prompt cache entry (semantic prompt,
        phones and BERT features of its text) for ``prompt_audio_path``."""
        if gpt_model not in self.gpt_models:
            self.load_gpt_model(gpt_model)
        if prompt_audio_path not in self.prompt_audio_cache:
            self.cache_prompt_audio(prompt_audio_path, prompt_audio_text)
        return self.gpt_models[gpt_model], self.prompt_audio_cache[prompt_audio_path]

    def _sovits_decode(self, sovits: Sovits, codes, text, ge, noise_scale=0.5,
                       slice_indices=None) -> np.ndarray:
        """Full decode at the exact shape: latent pipeline, then flow⁻¹ and
        HiFi-GAN.  codes [1, 1, n], text [1, N], ge [1, gin, 1 or n],
        ``slice_indices`` [2n, 2] (packed batches: each latent frame's text
        span) → audio [1, 1, 2n·hop]."""
        cfg = sovits.cfg
        dtype = self.tts_config.dtype
        codes_t = torch.as_tensor(np.asarray(codes, np.int64), device=self.device)
        text_t = torch.as_tensor(np.asarray(text, np.int64), device=self.device)
        n = codes_t.shape[-1]
        noise = torch.randn((1, cfg.inter_channels, 2 * n), generator=self.generator,
                            device=self.device, dtype=torch.float32) * noise_scale
        if slice_indices is not None:
            slice_indices = torch.as_tensor(np.asarray(slice_indices, np.int64),
                                            device=self.device)
        z_p, y_mask, _, _, ge_out = sovits_model.decode_core(
            sovits.params, cfg, codes_t, text_t, ge.to(dtype), noise.to(dtype), slice_indices)
        audio = sovits_model.flow_dec(sovits.params, cfg, z_p, y_mask, ge_out)
        return audio.float().cpu().numpy()

    def _sovits_decode_stream(self, sovits: Sovits, codes, text, ge, noise_scale, y_overlap,
                              valid_start_idx: int, overlap_len: int):
        """One streaming chunk at the exact shape: the latent of the
        cumulative ``codes`` [1, 1, n] from frame ``valid_start_idx`` on,
        cross-faded with ``y_overlap``, through flow⁻¹ and HiFi-GAN.  Returns
        (audio [1, 1, (2n - valid_start_idx)·hop], latent frames 2n, the new
        overlap [1, hidden, overlap_len])."""
        cfg = sovits.cfg
        dtype = self.tts_config.dtype
        codes_t = torch.as_tensor(np.asarray(codes, np.int64), device=self.device)
        text_t = torch.as_tensor(np.asarray(text, np.int64), device=self.device)
        n_frames = 2 * codes_t.shape[-1]
        noise = torch.randn((1, cfg.inter_channels, n_frames - valid_start_idx),
                            generator=self.generator, device=self.device,
                            dtype=torch.float32) * noise_scale
        z_p, y_mask, _, new_overlap, ge_out = sovits_model.decode_core(
            sovits.params, cfg, codes_t, text_t, ge.to(dtype), noise.to(dtype),
            y_overlap=y_overlap, valid_start_idx=valid_start_idx, overlap_len=overlap_len)
        audio = sovits_model.flow_dec(sovits.params, cfg, z_p, y_mask, ge_out)
        return audio.float().cpu().numpy(), n_frames, new_overlap

    def _get_spec(self, hps, filename) -> torch.Tensor:
        """Linear spectrogram of the speaker audio at the model's rate."""
        sr1 = int(hps.data.sampling_rate)
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
        spec = stft.spectrogram(torch.as_tensor(audio, device=self.device),
                                hps.data.filter_length, hps.data.hop_length,
                                hps.data.win_length)
        return spec.to(self.tts_config.dtype)

    def _get_prompt(self, cnhubert_model, sovits: Sovits, audio_path) -> np.ndarray:
        """Prompt semantic tokens: HuBERT features → RVQ codes."""
        wav, sr = load_audio(audio_path)
        wav16k = stft.resample(np.asarray(wav, np.float32), sr, 16000).mean(axis=0)
        wav16k = np.concatenate([wav16k, np.zeros(int(16000 * 0.3), np.float32)])
        with torch.no_grad():
            ssl = cnhubert_model(wav16k[None]).transpose(1, 2)
            codes = sovits_model.extract_latent(sovits.params, ssl)
        return codes[0, 0].cpu().numpy()

    def _mute_scale(self, text_cut: str, scale_map: dict) -> float:
        if text_cut and text_cut[-1] in scale_map:
            return scale_map[text_cut[-1]]
        if "…" in scale_map and text_cut[-3:] in ("...", "。。。"):
            return scale_map["…"]
        return 1.0

    def _check_pause(self, text: str) -> bool:
        return text.endswith(self.punctuation) or text[-3:] in ("...", "。。。")


def sovits_model_ge(model: Sovits, refers: torch.Tensor) -> torch.Tensor:
    """Speaker conditioning vector [1, gin, 1] for a loaded SoVITS model."""
    return sovits_model.get_ge(model.params, model.cfg, refers)
