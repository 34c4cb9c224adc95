"""G2P dispatcher (counterpart of ``gsv_tts_tpu/frontend/g2p/__init__.py``).

Same contract as the JAX package's dispatcher — per-``models_dir`` cached
engines, ellipsis collapse, pause-symbol mapping, UNK filtering and
consecutive-punctuation dedup with the word2ph repair — but bound to this
package's ``global_config``.  The English and Chinese engines and their
helpers (``english``, ``en_norm``, ``en_oov``, ``en_pos``; ``chinese``,
``zh_norm``, ``tone_sandhi``; ``japanese``) are this package's own copies,
beside this file; an engine assigned to ``global_config.english_g2p``,
``chinese_g2p`` or ``japanese_g2p`` by the caller wins over a built one.
Japanese reads kana with its built-in converter when ``pyopenjtalk`` does not
import, and then raises ``RuntimeError`` on kanji.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

from .. import pause as Pause
from .. import symbols as Symbols
from ...config import global_config

symbol_to_id = Symbols.symbol_to_id
_PUNCT_SET = set(Symbols.punctuation)
_LANG_ATTR = {"zh": "chinese_g2p", "ja": "japanese_g2p", "en": "english_g2p"}


def phonemes_to_ids(phones_raw: List[str]) -> List[int]:
    return [symbol_to_id[s] for s in phones_raw]


def _build_g2p(lang: str, models_dir):
    if lang == "zh":
        from .chinese import ChineseG2P

        return ChineseG2P(models_dir, use_jieba_fast=bool(global_config.use_jieba_fast))
    if lang == "ja":
        from .japanese import JapaneseG2P

        return JapaneseG2P()
    from .english import EnglishG2P

    return EnglishG2P(models_dir)


def _get_g2p(language: str, models_dir=None):
    """The engine for ``language``: an injected ``global_config.<lang>_g2p``
    wins, otherwise one cached per ``models_dir``."""
    lang = language if language in ("zh", "ja") else "en"
    attr = _LANG_ATTR[lang]
    current = getattr(global_config, attr)
    # an instance without the _auto_models_dir marker was installed on purpose
    if current is not None and not hasattr(current, "_auto_models_dir"):
        return current
    if models_dir is None:
        models_dir = global_config.models_dir
    key = None if models_dir is None else str(models_dir)
    if current is not None and current._auto_models_dir == key:
        return current
    cache = global_config._g2p_auto.setdefault(lang, {})
    inst = cache.get(key)
    if inst is None:
        inst = _build_g2p(lang, models_dir)
        inst._auto_models_dir = key
        cache[key] = inst
    setattr(global_config, attr, inst)
    return inst


def text_to_phonemes(text: str, language: str,
                     models_dir=None) -> Tuple[List[str], Dict[str, list], str]:
    text = re.sub(r"\.{3,}|。{3,}", "…", text)
    g2p = _get_g2p(language, models_dir)
    if language == "ja":
        phones, word2ph = g2p.g2p(text)
        norm_text = "".join(word2ph["word"])
    else:
        norm_text = g2p.text_normalize(text)
        phones, word2ph = g2p.g2p(norm_text)
    if len(phones) != sum(word2ph["ph"]):
        raise RuntimeError(
            f"length mismatch: phones={len(phones)} vs word2ph total={sum(word2ph['ph'])}")

    # pause-symbol mapping, then anything outside the symbol table → UNK
    phones = [Pause.pause_map.get(ph, ph) for ph in phones]
    phones = [ph if ph in Symbols.symbol_set else "UNK" for ph in phones]

    # UNK phones go; a punctuation phone equal to its predecessor goes
    keep = [ph != "UNK" for ph in phones]
    for i in range(1, len(phones)):
        if phones[i] in _PUNCT_SET and phones[i] == phones[i - 1]:
            keep[i] = False

    # re-count each word's span over the keep mask; emptied words vanish
    kept_words: List[str] = []
    kept_counts: List[int] = []
    pos = 0
    for word, n_ph in zip(word2ph["word"], word2ph["ph"]):
        survivors = sum(keep[pos:pos + n_ph])
        pos += n_ph
        if survivors:
            kept_words.append(word)
            kept_counts.append(survivors)
    phones = [ph for ph, k in zip(phones, keep) if k]
    return phones, {"word": kept_words, "ph": kept_counts}, norm_text
