"""Japanese G2P.

Primary backend: ``pyopenjtalk`` full-context labels with prosody marks
(``#``, ``[``, ``]``, ``^``, ``$``, ``?``, ``_``) and per-node phone counting
for word2ph — mirroring the reference ``G2P/Japanese/japanese.py:50-185``.
When pyopenjtalk is unavailable, a built-in kana converter produces the same
phone inventory (``ja_symbols``: a/i/u/e/o, ky/sh/ch/ts/…, ``N``, ``cl``)
without prosody marks — kanji cannot be read without a dictionary and raise.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

_KANA_BASE = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "k a", "き": "k i", "く": "k u", "け": "k e", "こ": "k o",
    "さ": "s a", "し": "sh i", "す": "s u", "せ": "s e", "そ": "s o",
    "た": "t a", "ち": "ch i", "つ": "ts u", "て": "t e", "と": "t o",
    "な": "n a", "に": "n i", "ぬ": "n u", "ね": "n e", "の": "n o",
    "は": "h a", "ひ": "h i", "ふ": "f u", "へ": "h e", "ほ": "h o",
    "ま": "m a", "み": "m i", "む": "m u", "め": "m e", "も": "m o",
    "や": "y a", "ゆ": "y u", "よ": "y o",
    "ら": "r a", "り": "r i", "る": "r u", "れ": "r e", "ろ": "r o",
    "わ": "w a", "を": "o", "ん": "N",
    "が": "g a", "ぎ": "g i", "ぐ": "g u", "げ": "g e", "ご": "g o",
    "ざ": "z a", "じ": "j i", "ず": "z u", "ぜ": "z e", "ぞ": "z o",
    "だ": "d a", "ぢ": "j i", "づ": "z u", "で": "d e", "ど": "d o",
    "ば": "b a", "び": "b i", "ぶ": "b u", "べ": "b e", "ぼ": "b o",
    "ぱ": "p a", "ぴ": "p i", "ぷ": "p u", "ぺ": "p e", "ぽ": "p o",
    "ゔ": "v u",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
}
_YOON = {
    "ゃ": ("y", "a"), "ゅ": ("y", "u"), "ょ": ("y", "o"),
}
# consonant + yōon → palatalized consonant (ja_symbols ky/gy/ny/...)
_PALATAL = {
    "k": "ky", "g": "gy", "n": "ny", "h": "hy", "b": "by", "p": "py",
    "m": "my", "r": "ry", "d": "dy",
    "sh": "sh", "ch": "ch", "j": "j",
}


def _kata_to_hira(text: str) -> str:
    out = []
    for ch in text:
        o = ord(ch)
        if 0x30A1 <= o <= 0x30F6:
            out.append(chr(o - 0x60))
        else:
            out.append(ch)
    return "".join(out)


def kana_to_phonemes(text: str) -> Tuple[List[str], List[int]]:
    """Kana string → (phones, per-char phone counts).  Built-in fallback."""
    text = _kata_to_hira(text)
    phones: List[str] = []
    counts: List[int] = []
    i = 0
    while i < len(text):
        ch = text[i]
        n_before = len(phones)
        if ch == "っ":
            phones.append("cl")
        elif ch == "ー":
            # long vowel: repeat last vowel
            for p in reversed(phones):
                if p in ("a", "i", "u", "e", "o", "N"):
                    phones.append(p if p != "N" else "N")
                    break
        elif ch in _KANA_BASE:
            base = _KANA_BASE[ch].split()
            if i + 1 < len(text) and text[i + 1] in _YOON:
                glide, vowel = _YOON[text[i + 1]]
                cons = base[0] if len(base) == 2 else ""
                pal = _PALATAL.get(cons)
                if pal in ("sh", "ch", "j"):
                    phones += [pal, vowel]
                elif pal:
                    phones += [pal, vowel]
                else:
                    phones += [glide, vowel]
                counts.append(len(phones) - n_before)
                counts.append(0)  # the small kana maps to 0 phones
                i += 2
                continue
            phones += base
        else:
            phones.append(ch)  # punctuation handled upstream
        counts.append(len(phones) - n_before)
        i += 1
    return phones, counts


class JapaneseG2P:
    def __init__(self):
        self._pyopenjtalk = None
        try:
            import pyopenjtalk  # optional full backend

            self._pyopenjtalk = pyopenjtalk
        except ImportError:
            pass
        self._ja_chars = re.compile(
            r"[A-Za-z\d々぀-ヺー-ヿ一-鿿"
            r"１-９Ａ-Ｚａ-ｚｦ-ﾝ]")
        self._ja_marks = re.compile(
            r"[^A-Za-z\d々぀-ヺー-ヿ一-鿿"
            r"１-９Ａ-Ｚａ-ｚｦ-ﾝ]")
        self._kana_only = re.compile(r"[぀-ゟ゠-ヿー]+$")

    def _g2p_sentence(self, sentence: str, word2ph: Dict[str, list]) -> List[str]:
        if self._pyopenjtalk is not None:
            return self._openjtalk_prosody(sentence, word2ph)
        if not self._kana_only.match(sentence):
            raise RuntimeError(
                "Japanese kanji G2P requires pyopenjtalk; the built-in "
                "fallback handles kana-only text")
        phones, counts = kana_to_phonemes(sentence)
        for ch, cnt in zip(sentence, counts):
            word2ph["word"].append(ch)
            word2ph["ph"].append(cnt)
        return phones

    # -- pyopenjtalk prosody backend (reference ``japanese.py:50-153``) ----

    def _openjtalk_prosody(self, text: str, word2ph, drop_unvoiced_vowels=True):
        pjt = self._pyopenjtalk
        features = pjt.run_frontend(text)
        labels = pjt.make_label(features)
        N = len(labels)
        phones: List[str] = []
        node_counts = [0] * len(features)
        expected = []
        for node in features:
            if node["pron"] == "IDLE":
                expected.append(0)
            else:
                ph_str = pjt.g2p(node["pron"])
                expected.append(len(ph_str.split()) if ph_str else 0)
        node_idx = 0
        consumed = 0
        while node_idx < len(features) - 1 and expected[node_idx] == 0:
            node_idx += 1

        def feat(regex, s):
            m = re.search(regex, s)
            return -50 if m is None else int(m.group(1))

        for n in range(N):
            lab = labels[n]
            p3 = re.search(r"\-(.*?)\+", lab).group(1)
            if drop_unvoiced_vowels and p3 in "AEIOU":
                p3 = p3.lower()
            mark = None
            if p3 not in ("sil", "pau"):
                a1 = feat(r"/A:([0-9\-]+)\+", lab)
                a2 = feat(r"\+(\d+)\+", lab)
                a3 = feat(r"\+(\d+)/", lab)
                f1 = feat(r"/F:(\d+)_", lab)
                a2n = feat(r"\+(\d+)\+", labels[n + 1]) if n + 1 < N else -1
                if a3 == 1 and a2n == 1 and p3 in "aeiouAEIOUNcl":
                    mark = "#"
                elif a1 == 0 and a2n == a2 + 1 and a2 != f1:
                    mark = "]"
                elif a2 == 1 and a2n == 2:
                    mark = "["
                if mark is not None:
                    node_counts[node_idx] += 1
            res = None
            boundary_sil = False
            if p3 == "sil":
                if n == 0:
                    res, boundary_sil = "^", True
                elif n == N - 1:
                    e3 = feat(r"!(\d+)_", lab)
                    res, boundary_sil = ("$" if e3 == 0 else "?"), True
                else:
                    res = "_"
            elif p3 == "pau":
                res = "_"
            else:
                res = p3
            if res:
                phones.append(res)
                if not boundary_sil:
                    node_counts[node_idx] += 1
                    consumed += 1
                    while node_idx < len(features) - 1 and consumed >= expected[node_idx]:
                        consumed -= expected[node_idx]
                        node_idx += 1
            if mark:
                phones.append(mark)

        for i, node in enumerate(features):
            if node["pron"] == "IDLE":
                continue
            surface = node["string"]
            total = node_counts[i]
            n_chars = len(surface)
            if n_chars <= 1:
                word2ph["word"].append(surface)
                word2ph["ph"].append(total)
            else:
                avg, rem = divmod(total, n_chars)
                for j in range(n_chars):
                    word2ph["word"].append(surface[j])
                    word2ph["ph"].append(avg + 1 if j < rem else avg)
        return phones[1:-1]  # strip ^ / $|? sentence marks

    # -- public ------------------------------------------------------------

    def g2p(self, text: str):
        text = text.replace("％", "パーセント").lower()
        sentences = re.split(self._ja_marks, text)
        marks = re.findall(self._ja_marks, text)
        phones: List[str] = []
        word2ph = {"word": [], "ph": []}
        for i, sentence in enumerate(sentences):
            if sentence and self._ja_chars.match(sentence):
                phones += self._g2p_sentence(sentence, word2ph)
            if i < len(marks):
                if marks[i] == " ":
                    continue
                phones.append(marks[i].replace(" ", ""))
                word2ph["word"].append(marks[i])
                word2ph["ph"].append(1)
        return phones, word2ph
