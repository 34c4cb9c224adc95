"""Mandarin tone sandhi (clean-room logic + lexical data asset).

Behavioral equivalent of the reference ``G2P/Chinese/tone_sandhi.py``:
neutral-tone rules (reduplication, particles, 们/子, locatives, directional
来/去, quantifier 个, lexicalized words), 不 sandhi, 一 sandhi, third-tone
sandhi with jieba-guided word splits, and the pre-merge passes that re-join
jieba segments (不/一/reduplication/continuous-third-tones/儿) before the
rules run.

The lexicalized word lists are linguistic data, not logic — they ship as
``assets/zh_sandhi.json`` (originating from PaddleSpeech, Apache-2.0, the
same provenance as the reference's lists) so pronunciations match.

Unlike the reference, pinyin lookup is injected (``finals_fn``) instead of a
hard pypinyin dependency: the caller supplies word → FINALS_TONE3-style
finals from whichever backend it uses (pypinyin or the bundled lexicon), and
the continuous-third-tone merges degrade gracefully without one.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, List, Optional, Tuple

_ASSET = Path(__file__).resolve().parents[2] / "assets" / "zh_sandhi.json"
_DATA = json.loads(_ASSET.read_text(encoding="utf-8"))

NEURAL_TONE_WORDS = frozenset(_DATA["neural_tone_words"])
NOT_NEURAL_WORDS = frozenset(_DATA["not_neural_tone_words"])

_PUNC = "：，；。？！“”‘’':,;.?!"
_FINAL_PARTICLES = "吧呢哈啊呐噻嘛吖嗨呐哦哒额滴哩哟喽啰耶喔诶"
_GE_PRECEDERS = "几有两半多各整每做是"

Seg = List[Tuple[str, str]]


def _jieba_cut_for_search(word: str) -> List[str]:
    try:
        import jieba_fast as jieba
    except ImportError:
        try:
            import jieba
        except ImportError:
            return [word]
    return list(jieba.cut_for_search(word))


class ToneSandhi:
    def __init__(self, finals_fn: Optional[Callable[[str], List[str]]] = None):
        # finals_fn: word → per-char finals like ['ia1','i3'] (neutral as 5);
        # used only by the continuous-third-tone merge passes.
        self._finals_fn = finals_fn

    # -- word split ---------------------------------------------------------

    def _split_word(self, word: str) -> List[str]:
        """Split into [head, tail] at the boundary of the shortest jieba
        search-mode subword, anchored to whichever end it sits at."""
        pieces = sorted(_jieba_cut_for_search(word), key=len)
        shortest = pieces[0]
        if word.find(shortest) == 0:
            return [shortest, word[len(shortest):]]
        return [word[:-len(shortest)], shortest]

    # -- individual rules ----------------------------------------------------

    def _neural_sandhi(self, word: str, pos: str, finals: List[str]) -> List[str]:
        # reduplicated noun/verb/adjective syllables go neutral (奶奶, 试试)
        for j in range(1, len(word)):
            if (word[j] == word[j - 1] and pos[:1] in ("n", "v", "a")
                    and word not in NOT_NEURAL_WORDS):
                finals[j] = finals[j][:-1] + "5"
        ge_idx = word.find("个")
        if word and word[-1] in _FINAL_PARTICLES:
            finals[-1] = finals[-1][:-1] + "5"
        elif word and word[-1] in "的地得":
            finals[-1] = finals[-1][:-1] + "5"
        elif len(word) == 1 and word in "了着过" and pos in ("ul", "uz", "ug"):
            finals[-1] = finals[-1][:-1] + "5"
        elif (len(word) > 1 and word[-1] in "们子" and pos in ("r", "n")
              and word not in NOT_NEURAL_WORDS):
            finals[-1] = finals[-1][:-1] + "5"
        elif len(word) > 1 and word[-1] in "上下里" and pos in ("s", "l", "f"):
            finals[-1] = finals[-1][:-1] + "5"
        elif len(word) > 1 and word[-1] in "来去" and word[-2] in "上下进出回过起开":
            finals[-1] = finals[-1][:-1] + "5"
        elif (ge_idx >= 1 and (word[ge_idx - 1].isnumeric()
                               or word[ge_idx - 1] in _GE_PRECEDERS)) or word == "个":
            finals[ge_idx] = finals[ge_idx][:-1] + "5"
        elif word in NEURAL_TONE_WORDS or word[-2:] in NEURAL_TONE_WORDS:
            finals[-1] = finals[-1][:-1] + "5"

        # lexicalized neutral tone inside compounds (e.g. X+时候)
        head, tail = self._split_word(word)
        parts = [finals[:len(head)], finals[len(head):]]
        for i, sub in enumerate((head, tail)):
            if (sub in NEURAL_TONE_WORDS or sub[-2:] in NEURAL_TONE_WORDS) and parts[i]:
                parts[i][-1] = parts[i][-1][:-1] + "5"
        return parts[0] + parts[1]

    def _bu_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if len(word) == 3 and word[1] == "不":
            finals[1] = finals[1][:-1] + "5"  # 看不懂
        else:
            for i, ch in enumerate(word):
                if ch == "不" and i + 1 < len(word) and finals[i + 1][-1] == "4":
                    finals[i] = finals[i][:-1] + "2"  # 不 + 4th tone → bu2
        return finals

    def _yi_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if "一" in word and all(c.isnumeric() for c in word if c != "一"):
            return finals  # digit string: 一 keeps tone 1
        if len(word) == 3 and word[1] == "一" and word[0] == word[-1]:
            finals[1] = finals[1][:-1] + "5"  # 看一看
        elif word.startswith("第一"):
            finals[1] = finals[1][:-1] + "1"
        else:
            for i, ch in enumerate(word):
                if ch == "一" and i + 1 < len(word):
                    if finals[i + 1][-1] == "4":
                        finals[i] = finals[i][:-1] + "2"  # 一段 → yi2
                    elif word[i + 1] not in _PUNC:
                        finals[i] = finals[i][:-1] + "4"  # 一天 → yi4
        return finals

    @staticmethod
    def _all_tone_three(finals: List[str]) -> bool:
        return all(f[-1] == "3" for f in finals)

    def _three_sandhi(self, word: str, finals: List[str]) -> List[str]:
        if len(word) == 2 and self._all_tone_three(finals):
            finals[0] = finals[0][:-1] + "2"
        elif len(word) == 3:
            head, _ = self._split_word(word)
            if self._all_tone_three(finals):
                if len(head) == 2:  # disyllabic + mono (蒙古/包)
                    finals[0] = finals[0][:-1] + "2"
                    finals[1] = finals[1][:-1] + "2"
                elif len(head) == 1:  # mono + disyllabic (纸/老虎)
                    finals[1] = finals[1][:-1] + "2"
            else:
                parts = [finals[:len(head)], finals[len(head):]]
                for i, sub in enumerate(parts):
                    if self._all_tone_three(sub) and len(sub) == 2:
                        sub[0] = sub[0][:-1] + "2"  # 所有/人
                    elif (i == 1 and not self._all_tone_three(sub) and sub
                          and sub[0][-1] == "3" and parts[0]
                          and parts[0][-1][-1] == "3"):
                        parts[0][-1] = parts[0][-1][:-1] + "2"  # 好/喜欢
                finals = parts[0] + parts[1]
        elif len(word) == 4:  # idioms split 2+2
            out: List[str] = []
            for sub in (finals[:2], finals[2:]):
                if self._all_tone_three(sub):
                    sub[0] = sub[0][:-1] + "2"
                out += sub
            finals = out
        return finals

    # -- segment pre-merges ---------------------------------------------------

    @staticmethod
    def _merge_bu(seg: Seg) -> Seg:
        out: Seg = []
        last = ""
        for word, pos in seg:
            if last == "不":
                word = last + word
            if word != "不":
                out.append((word, pos))
            last = word
        if last == "不":
            out.append((last, "d"))
        return out

    @staticmethod
    def _merge_yi(seg: Seg) -> Seg:
        out: Seg = []
        i = 0
        while i < len(seg):  # V 一 V → one verb token (听一听)
            word, pos = seg[i]
            if (i >= 1 and word == "一" and i + 1 < len(seg) and out
                    and out[-1][0] == seg[i + 1][0] and out[-1][1] == "v"
                    and seg[i + 1][1] == "v"):
                out[-1] = (out[-1][0] + "一" + seg[i + 1][0], out[-1][1])
                i += 2
            else:
                out.append((word, pos))
                i += 1
        merged: Seg = []
        for word, pos in out:  # a dangling 一 joins the word after it
            if merged and merged[-1][0] == "一":
                merged[-1] = (merged[-1][0] + word, merged[-1][1])
            else:
                merged.append((word, pos))
        return merged

    @staticmethod
    def _merge_reduplication(seg: Seg) -> Seg:
        out: Seg = []
        for word, pos in seg:
            if out and word == out[-1][0]:
                out[-1] = (out[-1][0] + word, out[-1][1])
            else:
                out.append((word, pos))
        return out

    def _merge_three_tones(self, seg: Seg, whole_word: bool) -> Seg:
        """Join neighbours across a third-tone boundary so _three_sandhi sees
        them as one word. whole_word=True requires both words to be entirely
        third-tone; False only looks at the boundary syllables."""
        if self._finals_fn is None:
            return seg
        finals = [self._finals_fn(word) for word, _ in seg]
        out: Seg = []
        merged_prev = [False] * len(seg)
        for i, (word, pos) in enumerate(seg):
            if i >= 1 and not merged_prev[i - 1] and finals[i - 1] and finals[i]:
                joinable = (self._all_tone_three(finals[i - 1])
                            and self._all_tone_three(finals[i])) if whole_word \
                    else (finals[i - 1][-1][-1] == "3" and finals[i][0][-1] == "3")
                prev_word = seg[i - 1][0]
                if (joinable and not (len(prev_word) == 2
                                      and prev_word[0] == prev_word[1])
                        and len(prev_word) + len(word) <= 3):
                    out[-1] = (out[-1][0] + word, out[-1][1])
                    merged_prev[i] = True
                    continue
            out.append((word, pos))
        return out

    @staticmethod
    def _merge_er(seg: Seg) -> Seg:
        out: Seg = []
        for i, (word, pos) in enumerate(seg):
            if i >= 1 and word == "儿" and seg[i - 1][0] != "#" and out:
                out[-1] = (out[-1][0] + word, out[-1][1])
            else:
                out.append((word, pos))
        return out

    # -- public API -----------------------------------------------------------

    def pre_merge_for_modify(self, seg: Seg) -> Seg:
        seg = [(w, p) for w, p in seg]
        seg = self._merge_bu(seg)
        try:
            seg = self._merge_yi(seg)
        except Exception:
            pass
        seg = self._merge_reduplication(seg)
        try:
            seg = self._merge_three_tones(seg, whole_word=True)
            seg = self._merge_three_tones(seg, whole_word=False)
        except Exception:
            pass
        return self._merge_er(seg)

    def modified_tone(self, word: str, pos: str, finals: List[str]) -> List[str]:
        if len(finals) != len(word):
            return finals  # polyphonic/erhua length mismatch: leave untouched
        finals = self._bu_sandhi(word, finals)
        finals = self._yi_sandhi(word, finals)
        finals = self._neural_sandhi(word, pos, finals)
        finals = self._three_sandhi(word, finals)
        return finals
