"""Mixed-language text splitter.

Clean-room equivalent of the reference ``gsv_tts/LangSegment.py`` public
behaviour: ``LangSegment.getTexts(text)`` → ``[{"text": ..., "lang": zh|ja|ko|en}]``.

Design: segment the text into script runs (hangul → ko, kana → ja, han → zh
unless adjacent kana pulls it into ja, latin → en), attach digits/punctuation
and whitespace to the surrounding language, honour explicit language tags
(``<ja>…</ja>`` etc., reference tag channel), and smooth single-character CJK
islands into their neighbours (reference ``LangSegment.py:344-377``).  If
``py3langid`` is installed it is used to disambiguate long han-only runs
(zh vs ja); otherwise they default to zh.
"""
from __future__ import annotations

import re
from typing import Dict, List

_TAG_RE = re.compile(r"<(zh|ja|ko|en)>(.*?)</\1>", re.S)

_RANGES = {
    "hangul": r"가-힣ᄀ-ᇿ㄰-㆏",
    "kana": r"぀-ゟ゠-ヿㇰ-ㇿｦ-ﾟ",
    "han": r"一-鿿㐀-䶿々〇",
    "latin": r"A-Za-zÀ-ɏ",
}

_CLS_RE = {k: re.compile(f"[{v}]") for k, v in _RANGES.items()}
_DIGIT_RE = re.compile(r"[0-9０-９]")


def _char_class(ch: str) -> str:
    for name, rx in _CLS_RE.items():
        if rx.match(ch):
            return name
    if _DIGIT_RE.match(ch):
        return "digit"
    if ch.isspace():
        return "space"
    return "other"


_CLASS_TO_LANG = {"hangul": "ko", "kana": "ja", "han": "zh", "latin": "en"}


def _langid_classify(text: str) -> str:
    try:
        import py3langid  # optional refinement

        lang = py3langid.classify(text)[0]
        if lang in ("zh", "ja", "ko", "en"):
            return lang
    except Exception:
        pass
    return "zh"


class LangSegment:
    """Namespace-style API mirroring the reference (class-level methods)."""

    # languages the caller wants (reference setfilters semantics)
    _filters = ["zh", "ja", "ko", "en"]

    @classmethod
    def setfilters(cls, filters: List[str]):
        cls._filters = list(filters)

    @classmethod
    def getfilters(cls) -> List[str]:
        return list(cls._filters)

    @classmethod
    def getTexts(cls, text: str) -> List[Dict[str, str]]:
        if not text:
            return []
        out: List[Dict[str, str]] = []
        pos = 0
        for m in _TAG_RE.finditer(text):
            if m.start() > pos:
                out.extend(cls._segment(text[pos: m.start()]))
            inner = m.group(2)
            if inner:
                out.append({"lang": m.group(1), "text": inner})
            pos = m.end()
        if pos < len(text):
            out.extend(cls._segment(text[pos:]))
        # merge adjacent same-language segments
        merged: List[Dict[str, str]] = []
        for seg in out:
            if merged and merged[-1]["lang"] == seg["lang"]:
                merged[-1]["text"] += seg["text"]
            else:
                merged.append(dict(seg))
        # english post-format (reference _insert_english_uppercase,
        # LangSegment.py:73-76): split mid-word capitals ("SoVITS" →
        # "So V I T S") and add a trailing space
        for seg in merged:
            if seg["lang"] == "en":
                seg["text"] = re.sub(r"(?<!\b)([A-Z])", r" \1",
                                     seg["text"]).strip("-") + " "
        # reference post-pass runs LAST, after tags, and does not re-merge
        merged = cls._post_process_short_cjk(merged)
        return [s for s in merged if s["text"]]

    # short-CJK neighbour smoothing (reference _post_process_short_cjk,
    # LangSegment.py:344-377): zh with kana → ja; short zh (≤6 CJK chars)
    # adopts a ja/ko neighbour (previous first); short kana-less ja adopts a
    # zh neighbour.  Applies to tag-forced segments too, like the reference.
    @staticmethod
    def _post_process_short_cjk(segments: List[Dict[str, str]]):
        if len(segments) <= 1:
            return segments
        cjk = re.compile(r"[一-鿿]")
        kana = re.compile(r"[぀-ゟ゠-ヿｦ-ﾟ]")
        for i, seg in enumerate(segments):
            has_kana = bool(kana.search(seg["text"]))
            n_cjk = len(cjk.findall(seg["text"]))
            if seg["lang"] == "zh":
                if has_kana:
                    seg["lang"] = "ja"
                    continue
                if 0 < n_cjk <= 6:
                    nb = None
                    if i > 0 and segments[i - 1]["lang"] in ("ja", "ko"):
                        nb = segments[i - 1]["lang"]
                    elif (i < len(segments) - 1
                          and segments[i + 1]["lang"] in ("ja", "ko")):
                        nb = segments[i + 1]["lang"]
                    if nb:
                        seg["lang"] = nb
            elif seg["lang"] == "ja" and not has_kana and 0 < n_cjk <= 6:
                if i > 0 and segments[i - 1]["lang"] == "zh":
                    seg["lang"] = "zh"
                elif (i < len(segments) - 1
                      and segments[i + 1]["lang"] == "zh"):
                    seg["lang"] = "zh"
        return segments

    # -- core segmentation -------------------------------------------------

    @classmethod
    def _segment(cls, text: str) -> List[Dict[str, str]]:
        if not text:
            return []
        runs: List[List] = []  # [class, chars]
        for ch in text:
            c = _char_class(ch)
            if runs and runs[-1][0] == c:
                runs[-1][1] += ch
            else:
                runs.append([c, ch])

        def _neighbor_class(i: int, step: int) -> str:
            j = i + step
            while 0 <= j < len(runs) and runs[j][0] in ("space", "other", "digit"):
                j += step
            return runs[j][0] if 0 <= j < len(runs) else ""

        # assign provisional languages
        segs: List[List] = []  # [lang or None, text]
        for i, (c, chunk) in enumerate(runs):
            if c in _CLASS_TO_LANG:
                lang = _CLASS_TO_LANG[c]
                if c == "han":
                    # han *directly* adjacent to kana reads as Japanese
                    if "kana" in (_neighbor_class(i, -1), _neighbor_class(i, 1)):
                        lang = "ja"
                    else:
                        lang = _langid_classify(chunk) if len(chunk) >= 8 else "zh"
                segs.append([lang, chunk])
            else:
                segs.append([None, chunk])  # attach later

        # attach digits / punctuation / spaces to a neighbouring language
        def nearest_lang(i: int) -> str:
            for j in range(i - 1, -1, -1):
                if segs[j][0]:
                    return segs[j][0]
            for j in range(i + 1, len(segs)):
                if segs[j][0]:
                    return segs[j][0]
            return "zh" if cls._filters and "zh" in cls._filters else (cls._filters[0] if cls._filters else "zh")

        for i, s in enumerate(segs):
            if s[0] is None:
                s[0] = nearest_lang(i)

        # apply language filters (unfiltered languages fall back to nearest)
        allowed = set(cls._filters)
        for i, s in enumerate(segs):
            if s[0] not in allowed and allowed:
                s[0] = nearest_lang(i) if nearest_lang(i) in allowed else next(iter(allowed))

        out = []
        for lang, chunk in segs:
            if out and out[-1]["lang"] == lang:
                out[-1]["text"] += chunk
            else:
                out.append({"lang": lang, "text": chunk})
        return out


def getTexts(text: str) -> List[Dict[str, str]]:
    return LangSegment.getTexts(text)
