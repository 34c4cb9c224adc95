"""Dataset pipeline for fine-tuning: (wav, text) pairs → training samples
(counterpart of ``gsv_tts_tpu/train_data.py``).

Featurization runs the facade's own inference stack — the frontend, HuBERT
and the loaded SoVITS model's RVQ, and for v2Pro the speaker embedder — so
train-time features cannot drift from inference.  HuBERT and the embedder
stay loaded on the facade afterwards, as its inference paths keep them.

Pieces:
  * :func:`read_manifest` — ``.list`` lines (``wav|speaker|lang|text``, the
    upstream GPT-SoVITS annotation format) or ``.jsonl``
    (``{"wav": ..., "text": ..., "lang": ...}``).
  * :func:`featurize` — ``(x_ids, y_ids, bert)`` samples for the t2s step;
    :func:`featurize_sovits` — ``(ssl, spec, wav, text[, sv_emb])`` for the
    SoVITS GAN step.
  * :func:`save_samples` / :func:`load_samples` — flat ``.npz`` shard
    (offset-indexed, no pickled objects; the JAX package's files load here).
  * :func:`batches` — length-bucketed padded batches in the JAX package's
    order for a seed.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Sample = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]

# manifest lang field → explicit segment tag for the language splitter;
# "auto"/empty leaves detection to LangSegment
_LANG_TAGS = {"zh": "zh", "all_zh": "zh", "ja": "ja", "all_ja": "ja",
              "en": "en", "ko": "ko", "auto": None, "": None}


def read_manifest(path) -> List[Tuple[str, str, str]]:
    """Returns ``[(wav_path, text, lang), ...]``.

    ``.list``: ``wav_path|speaker|lang|text`` (speaker ignored; a text may
    hold ``|``).  ``.jsonl``: one ``{"wav": ..., "text": ..., "lang": "auto"}``
    per line.  Relative wav paths resolve against the manifest's directory."""
    path = Path(path)
    base = path.parent
    items: List[Tuple[str, str, str]] = []

    def resolve(p: str) -> str:
        q = Path(p)
        return str(q if q.is_absolute() else base / q)

    for lineno, line in enumerate(path.read_text(encoding="utf-8").splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if path.suffix == ".jsonl" or line.startswith("{"):
            d = json.loads(line)
            items.append((resolve(d["wav"]), d["text"], d.get("lang", "auto")))
        else:
            parts = line.split("|")
            if len(parts) < 4:
                raise ValueError(f"{path}:{lineno}: expected wav|speaker|lang|text")
            wav, _speaker, lang, text = parts[0], parts[1], parts[2], "|".join(parts[3:])
            items.append((resolve(wav), text, lang.lower()))
    return items


def _phones_and_bert(tts, text: str, lang: str):
    from .frontend.text_processor import get_phones_and_bert

    tag = _LANG_TAGS.get(lang, None)
    tagged = f"<{tag}>{text}</{tag}>" if tag else text
    phones, _word2ph, bert, _norm = get_phones_and_bert(tagged, tts.tts_config)
    return np.asarray(phones, np.int32), bert


def _sovits(tts, sovits_model: Optional[str]):
    if not tts.sovits_models:
        raise ValueError("load a SoVITS model first — its RVQ codebook defines the "
                         "semantic token targets")
    return tts.sovits_models[sovits_model or next(iter(tts.sovits_models))]


def featurize(tts, items: Iterable[Tuple[str, str, str]], sovits_model: Optional[str] = None,
              keep_bert: bool = True) -> List[Sample]:
    """``(x_ids, y_ids, bert)`` per (wav, text, lang) item with the facade's
    stack: frontend → phone ids + BERT features, HuBERT + RVQ → semantic
    codes (the prompt featurization of ``TTS._get_prompt``).  Needs a loaded
    SoVITS model (the first by default).  ``keep_bert=False`` stores ``None``
    for the [n_phones, 1024] features: the step then feeds zeros, as
    inference does for non-Chinese text."""
    sovits = _sovits(tts, sovits_model)
    hubert = tts._get_cnhubert()
    samples: List[Sample] = []
    for wav_path, text, lang in items:
        phones, bert = _phones_and_bert(tts, text, lang)
        codes = tts._get_prompt(hubert, sovits, wav_path)
        samples.append((phones, np.asarray(codes, np.int32),
                        np.asarray(bert, np.float32) if keep_bert else None))
    return samples


def featurize_sovits(tts, items: Iterable[Tuple[str, str, str]],
                     sovits_model: Optional[str] = None):
    """Stage-2 featurization: (wav, text, lang) → ``(ssl [768, T], spec
    [spec_ch, T], wav [T·hop], text_ids[, sv_emb])`` (numpy) for
    ``models/sovits_train.pad_sovits_batch``.  A v2Pro / v2ProPlus model
    gives each sample its own ERes2NetV2 embedding (the clip is its own
    reference), so training sees the fused ``ge`` inference applies.

    ssl (50 Hz HuBERT on the 16 kHz mono mix) and the linear spectrogram (at
    the model's rate and hop) are cut to a common frame count, the waveform
    to ``T·hop`` samples so every random window has audio under it."""
    from .ops import stft
    from .utils.audio_io import load_audio

    sovits = _sovits(tts, sovits_model)
    hps = sovits.hps
    sr1 = int(hps.data.sampling_rate)
    hop = int(hps.data.hop_length)
    hubert = tts._get_cnhubert()
    embedder = tts._get_sv_model() if sovits.cfg.is_v2pro else None
    out = []
    for wav_path, text, lang in items:
        audio, sr0 = load_audio(wav_path)
        audio = np.asarray(audio, np.float32)
        audio = audio.mean(axis=0) if audio.ndim == 2 else audio
        if sr0 != sr1:
            audio = stft.resample(audio[None], sr0, sr1)[0]
        maxx = np.abs(audio).max()
        if maxx > 1:
            audio = audio / min(2.0, maxx)
        wav16k = stft.resample(audio[None], sr1, 16000)[0]
        with torch.no_grad():
            spec = stft.spectrogram(torch.as_tensor(audio[None], device=tts.device),
                                    int(hps.data.filter_length), hop,
                                    int(hps.data.win_length))[0].cpu().numpy()
            ssl = hubert(wav16k[None])[0].float().cpu().numpy().T  # [768, T]
        T = min(spec.shape[-1], ssl.shape[-1])
        phones, _bert = _phones_and_bert(tts, text, lang)
        sample = [ssl[:, :T], spec[:, :T], audio[:T * hop].astype(np.float32), phones]
        if embedder is not None:
            sample.append(embedder.compute_embedding3(wav16k).float().cpu().numpy().reshape(-1))
        out.append(tuple(sample))
    return out


def save_samples(path, samples: Sequence[Sample]) -> None:
    """Offset-indexed flat ``.npz`` (no object arrays, no pickle): BERT rows
    are stored only for the samples that have them (``bert_has``)."""
    x_cat = np.concatenate([s[0] for s in samples]) if samples else np.zeros(0, np.int32)
    y_cat = np.concatenate([s[1] for s in samples]) if samples else np.zeros(0, np.int32)
    x_len = np.asarray([len(s[0]) for s in samples], np.int32)
    y_len = np.asarray([len(s[1]) for s in samples], np.int32)
    bert_has = np.asarray([s[2] is not None for s in samples], bool)
    berts = [np.asarray(s[2], np.float32) for s in samples if s[2] is not None]
    bert_cat = np.concatenate(berts) if berts else np.zeros((0, 1024), np.float32)
    np.savez_compressed(path, x_cat=x_cat, y_cat=y_cat, x_len=x_len, y_len=y_len,
                        bert_has=bert_has, bert_cat=bert_cat)


def load_samples(path) -> List[Sample]:
    z = np.load(path)
    x_off = np.concatenate([[0], np.cumsum(z["x_len"])])
    y_off = np.concatenate([[0], np.cumsum(z["y_len"])])
    b_off = np.concatenate([[0], np.cumsum(np.where(z["bert_has"], z["x_len"], 0))])
    out: List[Sample] = []
    for i in range(len(z["x_len"])):
        bert = z["bert_cat"][b_off[i]: b_off[i + 1]] if z["bert_has"][i] else None
        out.append((z["x_cat"][x_off[i]: x_off[i + 1]], z["y_cat"][y_off[i]: y_off[i + 1]],
                    bert))
    return out


def bucketed_chunks(lengths: Sequence[int], batch_size: int, seed: Optional[int],
                    drop_remainder: bool = False) -> List[List[int]]:
    """Sample indices sorted by length, cut into batches, the batches'
    order shuffled by ``np.random.RandomState(seed)`` (``seed=None``: sorted
    order), a short last batch filled by repeating its last sample — the
    JAX package's order for the same seed."""
    order = sorted(range(len(lengths)), key=lambda i: lengths[i])
    chunks = [order[i: i + batch_size] for i in range(0, len(order), batch_size)]
    if drop_remainder and chunks and len(chunks[-1]) < batch_size:
        chunks.pop()
    if seed is not None:
        np.random.RandomState(seed).shuffle(chunks)
    return [c + [c[-1]] * (batch_size - len(c)) for c in chunks]


def batches(cfg, samples: Sequence[Sample], batch_size: int, seed: Optional[int] = 0,
            drop_remainder: bool = False, pad_multiple: int = 32, device="cpu"):
    """Yield padded batch dicts for ``parallel/train.make_train_step`` on
    ``device``: samples bucketed by packed length (:func:`bucketed_chunks`),
    so each batch pads against neighbours of similar size."""
    from .parallel.train import pad_batch

    lengths = [len(s[0]) + len(s[1]) for s in samples]
    for chunk in bucketed_chunks(lengths, batch_size, seed, drop_remainder):
        yield pad_batch(cfg, [samples[i] for i in chunk], pad_multiple=pad_multiple,
                        device=device)
