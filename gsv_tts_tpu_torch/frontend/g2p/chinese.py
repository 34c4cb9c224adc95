"""Chinese G2P: pinyin → GPT-SoVITS symbol pairs, with tone sandhi.

Equivalent of the reference ``G2P/Chinese/chinese.py``: text is normalized,
jieba-segmented, tone-sandhi'd, converted to pinyin and split into
(initial, final+tone) symbols following the opencpop-strict conventions
(zero-initial AA/EE/OO pseudo-initials, ``ir``/``i0`` apical vowels,
``E``/``En`` for ye/yan, ``v*`` for ü finals).

Pinyin backends (tried in order):
  1. ``pypinyin`` (phrase-aware polyphone handling) if installed;
  2. a user-supplied lexicon (``{word_or_char: "pin1 yin1"}``), e.g. loaded
     from ``models_dir/g2p/zh/pinyin.txt``;
otherwise Chinese input raises a clear error.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..pause import pause_map, escaped_pause
from . import zh_norm

_HAN_RE = re.compile(r"[一-龥]")

ZERO_INITIAL = {
    "a": "AA", "ai": "AA", "an": "AA", "ang": "AA", "ao": "AA",
    "e": "EE", "ei": "EE", "en": "EE", "eng": "EE", "er": "EE",
    "o": "OO", "ou": "OO",
}

# y-onset syllables: full spelling → final (opencpop-strict)
Y_FINALS = {
    "yi": "i", "ya": "ia", "yan": "En", "yang": "iang", "yao": "iao",
    "ye": "E", "yin": "in", "ying": "ing", "yo": "o", "yong": "iong",
    "you": "iu", "yu": "v", "yuan": "van", "yue": "ve", "yun": "vn",
}
# w-onset syllables
W_FINALS = {
    "wu": "u", "wa": "ua", "wai": "uai", "wan": "uan", "wang": "uang",
    "wei": "ui", "wen": "un", "weng": "ong", "wo": "uo",
}

INITIALS = ["zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l",
            "g", "k", "h", "j", "q", "x", "r", "z", "c", "s"]


def split_full_pinyin(pinyin: str) -> Optional[Tuple[str, str]]:
    """Toneless standard-spelling pinyin → (initial_symbol, final_symbol).

    Returns None for unknown syllables."""
    p = pinyin.lower().replace("ü", "v").replace("u:", "v")
    if p in ZERO_INITIAL:
        return ZERO_INITIAL[p], p
    if p in Y_FINALS:
        return "y", Y_FINALS[p]
    if p in W_FINALS:
        return "w", W_FINALS[p]
    for ini in INITIALS:
        if p.startswith(ini) and len(p) > len(ini):
            fin = p[len(ini):]
            if fin == "i" and ini in ("zh", "ch", "sh", "r"):
                fin = "ir"
            elif fin == "i" and ini in ("z", "c", "s"):
                fin = "i0"
            elif ini in ("j", "q", "x"):
                # ü written as u after j/q/x
                if fin == "u":
                    fin = "v"
                elif fin.startswith("u"):
                    fin = "v" + fin[1:]
            if fin == "ue":
                fin = "ve"
            return ini, fin
    return None


class ChineseG2P:
    def __init__(self, models_dir=None, lexicon: Optional[Dict[str, str]] = None,
                 use_jieba_fast: bool = False):
        self._pypinyin = None
        try:
            import pypinyin  # optional

            self._pypinyin = pypinyin
        except ImportError:
            pass

        self.lexicon: Dict[str, str] = {}
        if models_dir is not None:
            lex_path = Path(models_dir) / "g2p" / "zh" / "pinyin.txt"
            if lex_path.exists():
                for line in lex_path.read_text("utf-8").splitlines():
                    if "\t" in line:
                        k, v = line.split("\t", 1)
                        self.lexicon[k] = v.strip()
        if lexicon:
            self.lexicon.update(lexicon)

        if use_jieba_fast:
            try:
                import jieba_fast as jieba
                import jieba_fast.posseg as psg
            except ImportError:
                import jieba
                import jieba.posseg as psg
        else:
            import jieba
            import jieba.posseg as psg
        import logging

        jieba.setLogLevel(logging.CRITICAL)
        self._psg = psg

        from .tone_sandhi import ToneSandhi

        # the sandhi merges need per-word finals; feed them from whichever
        # pinyin backend this G2P is using (pypinyin or the bundled lexicon)
        self.tone_modifier = ToneSandhi(
            finals_fn=lambda w: self._get_initials_finals(w)[1])

        # erhua rule sets (linguistic exception data; same membership as the
        # reference ``chinese.py:34-81`` so pronunciations agree)
        self.must_erhua = {"小院儿", "胡同儿", "范儿", "老汉儿", "撒欢儿",
                           "寻老礼儿", "妥妥儿", "媳妇儿"}
        self.not_erhua = {
            "虐儿", "为儿", "护儿", "瞒儿", "救儿", "替儿", "有儿", "一儿",
            "我儿", "俺儿", "妻儿", "拐儿", "聋儿", "乞儿", "患儿", "幼儿",
            "孤儿", "婴儿", "婴幼儿", "连体儿", "脑瘫儿", "流浪儿", "体弱儿",
            "混血儿", "蜜雪儿", "舫儿", "祖儿", "美儿", "应采儿", "可儿",
            "侄儿", "孙儿", "侄孙儿", "女儿", "男儿", "红孩儿", "花儿",
            "虫儿", "马儿", "鸟儿", "猪儿", "猫儿", "狗儿", "少儿",
        }

    # -- pinyin backends ---------------------------------------------------

    def _word_pinyins(self, word: str) -> List[str]:
        """word → per-char toned pinyin (e.g. ['zhong1', 'guo2'])."""
        if self._pypinyin is not None:
            from pypinyin import lazy_pinyin, Style

            return lazy_pinyin(word, neutral_tone_with_five=True,
                               style=Style.TONE3)
        # lexicon backend: longest-match phrases then per-char
        out: List[str] = []
        i = 0
        while i < len(word):
            matched = False
            for ln in range(min(4, len(word) - i), 1, -1):
                chunk = word[i:i + ln]
                if chunk in self.lexicon:
                    out.extend(self.lexicon[chunk].split())
                    i += ln
                    matched = True
                    break
            if not matched:
                ch = word[i]
                if ch in self.lexicon:
                    out.append(self.lexicon[ch].split()[0])
                elif ch in pause_map:
                    out.append(ch)
                else:
                    raise KeyError(
                        f"No pinyin for {ch!r}: install pypinyin or provide a "
                        f"lexicon (models_dir/g2p/zh/pinyin.txt)")
                i += 1
        return out

    def _get_initials_finals(self, word: str) -> Tuple[List[str], List[str]]:
        initials, finals = [], []
        for py in self._word_pinyins(word):
            m = re.match(r"([a-zü:]+)([1-5])$", py)
            if not m:
                # punctuation inside the word stream
                initials.append(py)
                finals.append(py)
                continue
            base, tone = m.groups()
            parts = split_full_pinyin(base)
            if parts is None:
                initials.append(py)
                finals.append(py)
                continue
            ini, fin = parts
            initials.append(ini)
            finals.append(fin + tone)
        return initials, finals

    # -- erhua -------------------------------------------------------------

    def _merge_erhua(self, initials, finals, word, pos):
        """Rhotic-ending merge (reference ``chinese.py:95-130``)."""
        for i, phn in enumerate(finals):
            if i == len(finals) - 1 and word[i] == "儿" and phn == "er1":
                finals[i] = "er2"
        if word not in self.must_erhua and (word in self.not_erhua or pos in {"a", "j", "nr"}):
            return initials, finals
        if len(finals) != len(word):
            return initials, finals
        new_initials, new_finals = [], []
        for i, phn in enumerate(finals):
            if (i == len(finals) - 1 and word[i] == "儿" and phn in {"er2", "er5"}
                    and word[-2:] not in self.not_erhua and new_finals):
                phn = "er" + new_finals[-1][-1]
            new_initials.append(initials[i])
            new_finals.append(phn)
        return new_initials, new_finals

    # -- public API --------------------------------------------------------

    def text_normalize(self, text: str) -> str:
        text = zh_norm.normalize(text)
        text = re.sub(f"[^一-龥{escaped_pause}]", "", text)
        return text.replace("嗯", "恩").replace("呣", "母")

    def g2p(self, text: str):
        pattern = r"(?<=[{0}])\s*".format("".join(pause_map.keys()))
        sentences = [i for i in re.split(pattern, text) if i.strip() != ""]
        return self._g2p(sentences)

    def _g2p(self, segments: List[str]):
        phones_list: List[str] = []
        word2ph = {"word": [], "ph": []}
        for seg in segments:
            seg = re.sub("[a-zA-Z]+", "", seg)
            seg_cut = list(self._psg.lcut(seg))
            seg_cut = self.tone_modifier.pre_merge_for_modify(seg_cut)
            for word, pos in seg_cut:
                if pos == "eng" or not word:
                    continue
                sub_initials, sub_finals = self._get_initials_finals(word)
                sub_finals = self.tone_modifier.modified_tone(word, pos, sub_finals)
                sub_initials, sub_finals = self._merge_erhua(sub_initials, sub_finals, word, pos)
                for ch in word:
                    word2ph["word"].append(ch)
                for c, v in zip(sub_initials, sub_finals):
                    if c == v:
                        # punctuation/pause char
                        phones_list.append(c)
                        word2ph["ph"].append(1)
                    else:
                        # split_full_pinyin always yields a non-empty
                        # initial (AA/EE/OO, y/w, or a consonant); the
                        # guard is belt-and-braces, not a reachable path
                        phones_list += [c if c else "UNK", v]
                        word2ph["ph"].append(2)
        return phones_list, word2ph
