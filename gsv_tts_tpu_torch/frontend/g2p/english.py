"""English G2P → ARPAbet symbols.

Dictionary chain mirroring the reference (``G2P/English/english.py``):
``cmudict.rep`` (from line 57, double-space separated) → ``cmudict-fast.rep``
→ ``engdict-hot.rep`` overrides, all loaded from ``models_dir/g2p/en`` when
present; plus the nltk cmudict corpus if installed.

Pronunciation resolution per token (``english.py:121-211``):
  1. non-alpha tokens pass through; single letters spell out ("A" → EY1);
  2. homographs pick a pronunciation by POS prefix match
     (``english.py:143-151``) — POS from nltk when its tagger data is
     installed, else the built-in tagger (``en_pos.py``);
  3. CMU dictionary lookup;
  4. title-case words fall back to the name dictionary
     (``english.py:170-172``);
  5. OOV ≤3 chars spell out; possessive ``'s`` applies voicing rules;
  6. compounds split by corpus word segmentation (``en_oov.Segmenter``,
     the wordsegment model of ``english.py:204``);
  7. remaining OOV goes to the g2p_en GRU seq2seq when
     ``checkpoint20.npz`` is installed (``g2p_en.py:99-120``), else the
     built-in rule LTS (always emits valid ARPAbet).
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Dict, List, Optional

from ..pause import escaped_pause
from . import en_norm, en_oov, en_pos

_WORD_RE = re.compile(r"[A-Za-z]+(?:'[A-Za-z]+)?|[^A-Za-z\s]")

LETTER_PRON = {
    "a": ["EY1"], "b": ["B", "IY1"], "c": ["S", "IY1"], "d": ["D", "IY1"],
    "e": ["IY1"], "f": ["EH1", "F"], "g": ["JH", "IY1"], "h": ["EY1", "CH"],
    "i": ["AY1"], "j": ["JH", "EY1"], "k": ["K", "EY1"], "l": ["EH1", "L"],
    "m": ["EH1", "M"], "n": ["EH1", "N"], "o": ["OW1"], "p": ["P", "IY1"],
    "q": ["K", "Y", "UW1"], "r": ["AA1", "R"], "s": ["EH1", "S"],
    "t": ["T", "IY1"], "u": ["Y", "UW1"], "v": ["V", "IY1"],
    "w": ["D", "AH1", "B", "AH0", "L", "Y", "UW0"], "x": ["EH1", "K", "S"],
    "y": ["W", "AY1"], "z": ["Z", "IY1"],
}

# rule-based letter-to-sound fallback tables (longest-match digraphs first)
_LTS_DIGRAPH = [
    ("tion", ["SH", "AH0", "N"]), ("sion", ["ZH", "AH0", "N"]),
    ("ough", ["AO1"]), ("augh", ["AO1"]), ("igh", ["AY1"]),
    ("tch", ["CH"]), ("dge", ["JH"]), ("sch", ["S", "K"]),
    ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]), ("ph", ["F"]),
    ("wh", ["W"]), ("ck", ["K"]), ("ng", ["NG"]), ("qu", ["K", "W"]),
    ("oo", ["UW1"]), ("ee", ["IY1"]), ("ea", ["IY1"]), ("ai", ["EY1"]),
    ("ay", ["EY1"]), ("oa", ["OW1"]), ("ow", ["OW1"]), ("ou", ["AW1"]),
    ("oi", ["OY1"]), ("oy", ["OY1"]), ("au", ["AO1"]), ("aw", ["AO1"]),
    ("ar", ["AA1", "R"]), ("er", ["ER0"]), ("ir", ["ER1"]),
    ("or", ["AO1", "R"]), ("ur", ["ER1"]),
]
_LTS_SINGLE = {
    "a": ["AE1"], "b": ["B"], "c": ["K"], "d": ["D"], "e": ["EH1"],
    "f": ["F"], "g": ["G"], "h": ["HH"], "i": ["IH1"], "j": ["JH"],
    "k": ["K"], "l": ["L"], "m": ["M"], "n": ["N"], "o": ["AA1"],
    "p": ["P"], "r": ["R"], "s": ["S"], "t": ["T"], "u": ["AH1"],
    "v": ["V"], "w": ["W"], "x": ["K", "S"], "y": ["Y"], "z": ["Z"],
}
_VOWELS = set("aeiou")


def rule_lts(word: str) -> List[str]:
    """Deterministic grapheme→ARPAbet fallback."""
    word = word.lower()
    phones: List[str] = []
    i = 0
    while i < len(word):
        matched = False
        for g, ph in _LTS_DIGRAPH:
            if word.startswith(g, i):
                phones += ph
                i += len(g)
                matched = True
                break
        if matched:
            continue
        ch = word[i]
        # silent final e
        if ch == "e" and i == len(word) - 1 and any(c in _VOWELS for c in word[:i]):
            i += 1
            continue
        if ch == "c" and i + 1 < len(word) and word[i + 1] in "eiy":
            phones.append("S")
        elif ch == "g" and i + 1 < len(word) and word[i + 1] in "eiy":
            phones.append("JH")
        elif ch == "y" and (i == len(word) - 1 or word[i + 1] not in _VOWELS) and i > 0:
            phones.append("IY0")
        elif ch in _LTS_SINGLE:
            phones += _LTS_SINGLE[ch]
        i += 1
    if not any(p[-1].isdigit() for p in phones):
        phones.append("AH0")
    return phones


def _load_cmu_rep(path: Path, skip_to_line: int = 0, sep: str = "  ") -> Dict[str, List[str]]:
    d: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8", errors="ignore") as f:
        for idx, line in enumerate(f, start=1):
            if idx < skip_to_line:
                continue
            line = line.strip()
            if not line or line.startswith(";;;"):
                continue
            if sep in line:
                w, p = line.split(sep, 1)
                d.setdefault(w.lower(), p.split())
            else:
                parts = line.split(" ")
                d.setdefault(parts[0].lower(), parts[1:])
    return d


def _probe_in_thread(fn):
    """Run a best-effort optional-backend probe on a THROWAWAY thread.

    The nltk probes (corpus load, tagger data lookup) leak a frame deep in
    nltk/importlib on failure, and a leaked frame pins its ENTIRE ancestor
    chain via f_back — measured in r5: the first request that lazily built
    an EnglishG2P kept its whole ``TTS.infer`` stack alive, pinning one
    full stale model copy (~300 device arrays) across weight switches.  On
    a private thread the leaked frame's ancestry ends at the thread
    bootstrap — nothing of the caller's stack is reachable."""
    out = {}

    def run():
        try:
            out["v"] = fn()
        except Exception:  # noqa: BLE001 — probes are best-effort by contract
            pass

    import threading

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join()
    return out.get("v")


class EnglishG2P:
    def __init__(self, models_dir=None):
        self.cmu: Dict[str, List[str]] = {}
        if models_dir is not None:
            base = Path(models_dir) / "g2p" / "en"
            if (base / "cmudict.rep").exists():
                self.cmu.update(_load_cmu_rep(base / "cmudict.rep", skip_to_line=57))
            if (base / "cmudict-fast.rep").exists():
                for k, v in _load_cmu_rep(base / "cmudict-fast.rep", sep=" ").items():
                    self.cmu.setdefault(k, v)
            if (base / "engdict-hot.rep").exists():
                self.cmu.update(_load_cmu_rep(base / "engdict-hot.rep", sep=" "))
        if not self.cmu:
            def load_nltk_cmu():
                from nltk.corpus import cmudict

                return {k: v[0] for k, v in cmudict.dict().items()}

            self.cmu = _probe_in_thread(load_nltk_cmu) or {}
        for w in ("ae", "ai", "ar", "ios", "hud", "os"):
            self.cmu.pop(w, None)
        self.homographs = en_oov.load_homographs(models_dir)
        self.namedict = en_oov.load_namedict(models_dir)
        self.gru_lts = en_oov.load_gru_lts(models_dir)
        self.segmenter = en_oov.Segmenter(models_dir, lexicon=self.cmu)
        self._pos_tag = self._pick_tagger(models_dir)

    @staticmethod
    def _pick_tagger(models_dir):
        """nltk's perceptron tagger when its data is installed (exact
        reference behavior, ``english.py:25,124``); built-in tagger else.
        Probed on a throwaway thread — see :func:`_probe_in_thread`."""
        def probe():
            import nltk

            if models_dir is not None:
                nltk.data.path.insert(
                    0, str(Path(models_dir) / "g2p" / "en" / "nltk"))
            nltk.pos_tag(["probe"])  # raises LookupError without data
            return nltk.pos_tag

        return _probe_in_thread(probe) or en_pos.pos_tag

    def text_normalize(self, text: str) -> str:
        text = en_norm.normalize(text)
        # the reference keeps ONLY letters/whitespace/pause marks
        # (``english.py:217``) — apostrophes are stripped ("it's" → "its"),
        # so the possessive branch below only fires on unnormalized input
        text = re.sub(f"[^a-zA-Z\\s{escaped_pause}]", "", text)
        return re.sub(r"\s+", " ", text).strip()

    def qryword(self, o_word: str) -> List[str]:
        word = o_word.lower()
        if len(word) > 1 and word in self.cmu:
            return list(self.cmu[word])
        # title-case OOV: the reference's given-name dictionary
        # (``english.py:170-172``)
        if o_word.istitle() and word in self.namedict:
            return list(self.namedict[word][0])
        if len(word) <= 3:
            phones: List[str] = []
            for ch in word:
                if ch == "a":
                    phones += ["EY1"]
                elif not ch.isalpha():
                    phones += [ch]
                else:
                    phones += LETTER_PRON[ch]
            return phones
        m = re.match(r"^([a-z]+)('s)$", word)
        if m:
            phones = self.qryword(m.group(1))[:]
            if phones and phones[-1] in ("P", "T", "K", "F", "TH", "HH"):
                phones += ["S"]
            elif phones and phones[-1] in ("S", "Z", "SH", "ZH", "CH", "JH"):
                phones += ["AH0", "Z"]
            else:
                phones += ["Z"]
            return phones
        # compound splitting by corpus word segmentation (``english.py:204``)
        comps = self.segmenter.segment(word)
        if len(comps) <= 1:
            return self.predict(word)
        return [p for comp in comps for p in self.qryword(comp)]

    def predict(self, word: str) -> List[str]:
        """OOV letter-to-sound: the g2p_en GRU when its checkpoint asset is
        installed (``g2p_en.py:99-120``), the rule LTS otherwise."""
        if self.gru_lts is not None:
            return self.gru_lts.predict(word)
        return rule_lts(word)

    def g2p(self, text: str):
        words = _WORD_RE.findall(text)
        tokens = self._pos_tag(words)
        word2ph = {"word": [], "ph": []}
        phones: List[str] = []
        for o_word, pos in tokens:
            word = o_word.lower()
            if re.search("[a-z]", word) is None:
                pron = [word]
            elif len(word) == 1:
                # dict entry for single letters ("a" article → AH0); the
                # capitalized standalone "A" reads as the letter name
                # (``english.py:136-141``)
                if o_word == "A":
                    pron = ["EY1"]
                else:
                    pron = list(self.cmu.get(word, LETTER_PRON[word]))
            elif word in self.homographs:
                # POS-prefix homograph dispatch (``english.py:143-151``);
                # the len(pos) < len(pos1) clause lets bare "VB" trigger the
                # "VBP" entry for "read"
                pron1, pron2, pos1 = self.homographs[word]
                if pos.startswith(pos1):
                    pron = pron1
                elif len(pos) < len(pos1) and pos == pos1[: len(pos)]:
                    pron = pron1
                else:
                    pron = pron2
            else:
                pron = self.qryword(o_word)
            pron = [("UNK" if p == "<unk>" else p) for p in pron
                    if p not in (" ", "<pad>", "UW", "</s>", "<s>")]
            phones += pron
            word2ph["word"].append(o_word)
            word2ph["ph"].append(len(pron))
        return phones, word2ph
