"""Text segmentation and feature assembly (reference ``TextProcessor.py``).

``cut_text`` splits text into synthesis segments: sentence segmentation →
clause split on pause punctuation → greedy merge until the estimated semantic
length reaches ``cut_minlen`` (CJK chars + 1.75 × latin words,
``TextProcessor.py:13-16``) → leading-punctuation repair.  The reference uses
``pysbd`` for sentence segmentation; a built-in splitter with equivalent
behaviour on CJK/latin sentence enders is used when pysbd is absent.

``sub2text_index`` maps normalized-text subtitle spans back into the original
text via token-level LIS alignment + linear interpolation
(``TextProcessor.py:128-235``).
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List

import numpy as np

from .lang_segment import LangSegment
from .g2p import phonemes_to_ids, text_to_phonemes

_ABBREV = {"mr", "mrs", "ms", "dr", "st", "jr", "etc", "vs", "no", "e.g", "i.e"}


_SEGMENTER = None  # pysbd.Segmenter is expensive to build; cache like the
_SEG_MOD = False  # reference's module-level `seg` (TextProcessor.py) — but
# keyed on the live pysbd module so a test swapping in/out a pysbd stub
# (the oracle-test pattern) never keeps using a stale cached segmenter


def _split_sentences(text: str) -> List[str]:
    """Sentence segmentation (pysbd when installed, else built-in)."""
    global _SEGMENTER, _SEG_MOD
    try:
        import pysbd
    except ImportError:
        pysbd = None
    if pysbd is not _SEG_MOD:
        _SEG_MOD = pysbd
        _SEGMENTER = pysbd.Segmenter() if pysbd is not None else None
    if _SEGMENTER is not None:
        return _SEGMENTER.segment(text)
    return builtin_split_sentences(text)


def builtin_split_sentences(text: str) -> List[str]:
    """Dependency-free sentence splitter (pysbd stand-in): split on ender
    runs + closing quotes, keeping abbreviations and decimals intact."""
    out: List[str] = []
    buf = ""
    i = 0
    n = len(text)
    while i < n:
        ch = text[i]
        buf += ch
        if ch in ".。!！?？…":
            # consume the full ender run + closing quotes
            j = i + 1
            while j < n and text[j] in ".。!！?？…”」』\"')]】":
                buf += text[j]
                j += 1
            # don't split after common abbreviations or decimals
            last_word = re.findall(r"([A-Za-z]+)\.$", buf)
            is_abbrev = bool(last_word) and last_word[-1].lower() in _ABBREV
            is_decimal = (ch == "." and i + 1 < n and text[i - 1: i].isdigit()
                          and text[i + 1: i + 2].isdigit())
            if not is_abbrev and not is_decimal:
                out.append(buf)
                buf = ""
            i = j
            continue
        i += 1
    if buf.strip():
        out.append(buf)
    return out if out else ([text] if text else [])


def get_semantic_length(text: str, en_weight: float = 1.75) -> float:
    cjk = len(re.findall(r"[぀-ゟ゠-ヿ一-鿥ｦ-ﾟ]", text))
    en = len(re.findall(r"[a-zA-Z0-9]+", text))
    return cjk + en * en_weight


# a run of pause punctuation closes the clause it follows; 2+ latin/CJK
# periods count as a pause run too (single periods are sentence enders)
_PAUSE_RUN = re.compile(r"[，,；;：:、~・…]+|[\.。]{2,}")
_LEADING_ENDERS = re.compile(r"^[!！?？.。]+")


def _iter_clauses(sentence: str):
    """Yield pause-terminated clauses of ``sentence`` (each clause carries
    its closing punctuation run; a punct-free tail is its own clause)."""
    pos = 0
    for m in _PAUSE_RUN.finditer(sentence):
        yield sentence[pos:m.end()]
        pos = m.end()
    if pos < len(sentence):
        yield sentence[pos:]


def cut_text(text: str, cut_minlen: int = 10) -> List[str]:
    sentences = _split_sentences(text)
    if not sentences:
        return []
    # sentence segmentation eats leading newlines; restore them on cut 0
    n_leading_nl = len(text) - len(text.lstrip("\n"))
    if n_leading_nl:
        sentences[0] = "\n" * n_leading_nl + sentences[0]

    # greedy clause merge: a cut closes once its estimated semantic length
    # reaches cut_minlen; a too-short tail rides the previous cut
    cuts: List[str] = []
    buf = ""
    for clause in (c for s in sentences for c in _iter_clauses(s)):
        buf += clause
        if get_semantic_length(buf) >= cut_minlen:
            cuts.append(buf)
            buf = ""
    if buf:
        if cuts:
            cuts[-1] += buf
        else:
            cuts = [buf]

    # sentence enders stranded at a cut's head belong to the previous cut
    for i in range(1, len(cuts)):
        m = _LEADING_ENDERS.match(cuts[i])
        if m:
            cuts[i - 1] += m.group(0)
            cuts[i] = cuts[i][m.end():]
    return [c for c in cuts if c]


def get_phones_and_bert(texts, tts_config):
    """Per text: language segmentation → G2P → phone ids, with Chinese
    segments batched into one BERT call (``TextProcessor.py:62-125``).
    BERT features are numpy [n_phones, 1024] (zeros when BERT is off)."""
    is_batch = True
    if isinstance(texts, str):
        texts = [texts]
        is_batch = False

    batch_phones, batch_word2ph, batch_bert, batch_norm_text = [], [], [], []
    bert_tasks = {"pos": [], "word2ph": []}

    for text in texts:
        segments = LangSegment.getTexts(text)
        if not segments:
            raise ValueError(
                f"Text processing produced no valid segments for input: {text!r}.")

        phones_list: List[List[int]] = []
        norm_text_list: List[str] = []
        word2ph = {"word": [], "ph": []}
        batch_bert.append([])

        for segment in segments:
            phones_raw, _word2ph, norm_text = text_to_phonemes(
                segment["text"], segment["lang"],
                models_dir=getattr(tts_config, "models_dir", None))
            phones = phonemes_to_ids(phones_raw)
            word2ph["word"] += _word2ph["word"]
            word2ph["ph"] += _word2ph["ph"]
            if getattr(tts_config, "cnroberta", None) and segment["lang"] == "zh":
                bert_tasks["pos"].append((len(batch_bert) - 1, len(batch_bert[-1])))
                bert_tasks["word2ph"].append(_word2ph)
                batch_bert[-1].append(None)
            else:
                batch_bert[-1].append(np.zeros((len(phones), 1024), np.float32))
            phones_list.append(phones)
            norm_text_list.append(norm_text)

        batch_phones.append(sum(phones_list, []))
        batch_word2ph.append(word2ph)
        batch_norm_text.append("".join(norm_text_list))

    if bert_tasks["word2ph"]:
        berts = tts_config.cnroberta(bert_tasks["word2ph"])
        for (i, j), bert in zip(bert_tasks["pos"], berts):
            batch_bert[i][j] = np.asarray(bert, np.float32)

    processed = [np.concatenate(bt, axis=0) if bt else np.zeros((0, 1024), np.float32)
                 for bt in batch_bert]

    if is_batch:
        return batch_phones, batch_word2ph, processed, batch_norm_text
    return batch_phones[0], batch_word2ph[0], processed[0], batch_norm_text[0]


# ---------------------------------------------------------------------------
# Subtitle index back-mapping (``TextProcessor.py:128-235``)
# ---------------------------------------------------------------------------

def split_text(text: str) -> List[str]:
    return re.compile(r"[a-zA-Z]+|.", flags=re.DOTALL).findall(text)


def LIS_mapping(norm_split_orig_idx: List[List[int]]) -> List[int]:
    """Longest-increasing-subsequence alignment over candidate index lists."""
    dp: List[int] = []
    trace: List[List] = [[] for _ in range(len(norm_split_orig_idx))]
    for i, candidates in enumerate(norm_split_orig_idx):
        updates = []
        for val in candidates:
            idx = bisect.bisect_left(dp, val)
            updates.append((idx, val))
            trace[i].append((val, idx + 1))
        for idx, val in updates:
            if idx < len(dp):
                dp[idx] = min(dp[idx], val)
            else:
                dp.append(val)
    max_len = len(dp)
    result = [-1] * len(norm_split_orig_idx)
    if max_len == 0:
        return result
    current_len = max_len
    last_val = float("inf")
    for i in range(len(norm_split_orig_idx) - 1, -1, -1):
        cands = sorted((item for item in trace[i] if item[1] == current_len),
                       key=lambda x: x[0], reverse=True)
        for val, _ in cands:
            if val < last_val:
                result[i] = val
                last_val = val
                current_len -= 1
                break
    return result


def linear_interpolate(indices: List[int]) -> List[int]:
    result = list(indices)
    valid = [(i, v) for i, v in enumerate(result) if v != -1]
    if not valid:
        return result
    first_idx, first_val = valid[0]
    if first_idx > 0:
        for i in range(first_idx):
            result[i] = int(round((first_val / first_idx) * i))
    for k in range(len(valid) - 1):
        i0, v0 = valid[k]
        i1, v1 = valid[k + 1]
        steps = i1 - i0
        for i in range(1, steps):
            result[i0 + i] = int(round(v0 + (v1 - v0) / steps * i))
    last_idx, last_val = valid[-1]
    for i in range(last_idx + 1, len(result)):
        result[i] = last_val + (i - last_idx)
    return result


def sub2text_index(subtitles: List[Dict], norm_text: str, orig_text: str) -> List[Dict]:
    idx = 0
    sub_norm_idx = []
    for subtitle in subtitles:
        t = subtitle["text"]
        idx = norm_text.find(t, idx)
        sub_norm_idx.append({"start": idx, "end": idx + len(t) - 1})

    orig_split = split_text(orig_text)
    norm_split = split_text(norm_text)

    cand = []
    for t1 in norm_split:
        cand.append([i for i, t2 in enumerate(orig_split) if t2 == t1])
    mapped = LIS_mapping(cand)

    norm_orig_idx: List[int] = []
    for i, m in enumerate(mapped):
        if m == -1:
            norm_orig_idx += [-1] * len(norm_split[i])
        else:
            base = sum(len(t) for t in orig_split[:m])
            norm_orig_idx += list(range(base, base + len(norm_split[i])))
    norm_orig_idx = linear_interpolate(norm_orig_idx)

    for i, ni in enumerate(sub_norm_idx):
        start = norm_orig_idx[ni["start"]] if 0 <= ni["start"] < len(norm_orig_idx) else 0
        end = norm_orig_idx[ni["end"]] if 0 <= ni["end"] < len(norm_orig_idx) else start
        subtitles[i]["orig_idx_start"] = start
        subtitles[i]["orig_idx_end"] = end + 1
    return subtitles
