"""English OOV machinery: GRU letter-to-sound, homographs, word segmentation.

Clean-room counterparts of the reference's OOV stack
(``G2P/English/g2p_en.py:48-120``, ``english.py:38-46,204-211``):

* ``GruLts`` — the published g2p_en GRU seq2seq (encoder GRU over grapheme
  embeddings, greedy decoder GRU + linear head), pure numpy.  Weights load
  from the SAME ``models_dir/g2p/en/g2p_en/checkpoint20.npz`` asset the
  reference downloads; without the asset the caller falls back to the
  rule-based LTS.
* homographs — a built-in table of common stress-shift/POS pairs, overridden
  by ``models_dir/g2p/en/g2p_en/homographs.en`` when the reference bundle is
  installed (format ``word|pron1|pron2|pos1``).
* ``Segmenter`` — Norvig-style word segmentation with the wordsegment
  corpus statistics (``unigrams.txt``/``bigrams.txt``; loaded from the
  installed ``wordsegment`` package or ``models_dir/g2p/en/wordsegment``).
  Scoring follows wordsegment's documented model: unigram relative
  frequency with a 10/(N·10^len) OOV penalty and conditional bigram
  chaining.  Without corpus data, a dictionary DP split (longest-parts
  first) stands in.
* ``load_namedict`` — the reference's given-name pronunciation cache
  (``namedict_cache.pickle``), read through a restricted unpickler that
  admits no globals at all (the file is a plain dict of lists).
"""
from __future__ import annotations

import functools
import io
import math
import os
import pickle
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

GRAPHEMES = ["<pad>", "<unk>", "</s>"] + list("abcdefghijklmnopqrstuvwxyz")
PHONEMES = ["<pad>", "<unk>", "<s>", "</s>"] + [
    "AA0", "AA1", "AA2", "AE0", "AE1", "AE2", "AH0", "AH1", "AH2",
    "AO0", "AO1", "AO2", "AW0", "AW1", "AW2", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH", "EH0", "EH1", "EH2", "ER0", "ER1", "ER2",
    "EY0", "EY1", "EY2", "F", "G", "HH", "IH0", "IH1", "IH2",
    "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW0", "OW1", "OW2", "OY0", "OY1", "OY2", "P", "R", "S", "SH",
    "T", "TH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2",
    "V", "W", "Y", "Z", "ZH",
]
_G2I = {g: i for i, g in enumerate(GRAPHEMES)}
_I2P = dict(enumerate(PHONEMES))


class GruLts:
    """Greedy GRU seq2seq letter-to-sound (g2p_en ``checkpoint20.npz``)."""

    def __init__(self, npz_path):
        v = np.load(npz_path)
        self.enc_emb = v["enc_emb"].astype(np.float32)
        self.dec_emb = v["dec_emb"].astype(np.float32)
        self.fc_w = v["fc_w"].astype(np.float32)
        self.fc_b = v["fc_b"].astype(np.float32)
        # pre-split the fused r|z|n gate blocks once at load; the per-step
        # cell then runs two GEMVs + gate math with no slicing
        self.enc = self._split_gates(v, "enc")
        self.dec = self._split_gates(v, "dec")
        self.hidden = v["enc_w_hh"].shape[1]

    @staticmethod
    def _split_gates(v, prefix):
        w_ih = v[f"{prefix}_w_ih"].astype(np.float32)  # [3H, E]
        w_hh = v[f"{prefix}_w_hh"].astype(np.float32)  # [3H, H]
        b_ih = v[f"{prefix}_b_ih"].astype(np.float32)
        b_hh = v[f"{prefix}_b_hh"].astype(np.float32)
        H = w_hh.shape[1]
        return {
            "w_ih_T": w_ih.T.copy(), "w_hh_T": w_hh.T.copy(),
            "b_ih": b_ih, "b_hh": b_hh, "H": H,
        }

    @staticmethod
    def _cell(x, h, g):
        """One GRU step; gate layout rr|zz|nn matches torch's GRUCell export."""
        H = g["H"]
        gi = x @ g["w_ih_T"] + g["b_ih"]
        gh = h @ g["w_hh_T"] + g["b_hh"]
        r = 1.0 / (1.0 + np.exp(-(gi[:H] + gh[:H])))
        z = 1.0 / (1.0 + np.exp(-(gi[H:2 * H] + gh[H:2 * H])))
        n = np.tanh(gi[2 * H:] + r * gh[2 * H:])
        return (1.0 - z) * n + z * h

    def predict(self, word: str, max_len: int = 20) -> List[str]:
        ids = [_G2I.get(c, _G2I["<unk>"]) for c in word] + [_G2I["</s>"]]
        h = np.zeros((self.hidden,), np.float32)
        for i in ids:
            h = self._cell(self.enc_emb[i], h, self.enc)
        out: List[str] = []
        x = self.dec_emb[2]  # <s>
        for _ in range(max_len):
            h = self._cell(x, h, self.dec)
            pred = int(np.argmax(h @ self.fc_w.T + self.fc_b))
            if pred == 3:  # </s>
                break
            out.append(_I2P.get(pred, "<unk>"))
            x = self.dec_emb[pred]
        return out


def load_gru_lts(models_dir) -> Optional[GruLts]:
    if models_dir is None:
        return None
    path = Path(models_dir) / "g2p" / "en" / "g2p_en" / "checkpoint20.npz"
    if not path.exists():
        return None
    try:
        return GruLts(path)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# homographs
# ---------------------------------------------------------------------------

# (pron_when_pos_matches, pron_otherwise, trigger_pos_prefix) — standard
# noun/verb stress-shift pairs and POS-sensitive readings; CMU pronunciations
BUILTIN_HOMOGRAPHS: Dict[str, Tuple[List[str], List[str], str]] = {
    "lead": (["L", "EH1", "D"], ["L", "IY1", "D"], "N"),
    "live": (["L", "IH1", "V"], ["L", "AY1", "V"], "V"),
    "wind": (["W", "AY1", "N", "D"], ["W", "IH1", "N", "D"], "V"),
    "bow": (["B", "AW1"], ["B", "OW1"], "V"),
    "tear": (["T", "EH1", "R"], ["T", "IH1", "R"], "V"),
    "close": (["K", "L", "OW1", "Z"], ["K", "L", "OW1", "S"], "V"),
    "use": (["Y", "UW1", "Z"], ["Y", "UW1", "S"], "V"),
    "house": (["HH", "AW1", "Z"], ["HH", "AW1", "S"], "V"),
    "excuse": (["IH0", "K", "S", "K", "Y", "UW1", "Z"],
               ["IH0", "K", "S", "K", "Y", "UW1", "S"], "V"),
    "abuse": (["AH0", "B", "Y", "UW1", "Z"], ["AH0", "B", "Y", "UW1", "S"], "V"),
    "record": (["R", "EH1", "K", "ER0", "D"],
               ["R", "IH0", "K", "AO1", "R", "D"], "N"),
    "present": (["P", "R", "EH1", "Z", "AH0", "N", "T"],
                ["P", "R", "IY0", "Z", "EH1", "N", "T"], "N"),
    "object": (["AA1", "B", "JH", "EH0", "K", "T"],
               ["AH0", "B", "JH", "EH1", "K", "T"], "N"),
    "project": (["P", "R", "AA1", "JH", "EH0", "K", "T"],
                ["P", "R", "AH0", "JH", "EH1", "K", "T"], "N"),
    "produce": (["P", "R", "OW1", "D", "UW0", "S"],
                ["P", "R", "AH0", "D", "UW1", "S"], "N"),
    "permit": (["P", "ER1", "M", "IH2", "T"],
               ["P", "ER0", "M", "IH1", "T"], "N"),
    "conduct": (["K", "AA1", "N", "D", "AH0", "K", "T"],
                ["K", "AH0", "N", "D", "AH1", "K", "T"], "N"),
    "content": (["K", "AA1", "N", "T", "EH0", "N", "T"],
                ["K", "AH0", "N", "T", "EH1", "N", "T"], "N"),
    "contract": (["K", "AA1", "N", "T", "R", "AE2", "K", "T"],
                 ["K", "AH0", "N", "T", "R", "AE1", "K", "T"], "N"),
    "contrast": (["K", "AA1", "N", "T", "R", "AE2", "S", "T"],
                 ["K", "AH0", "N", "T", "R", "AE1", "S", "T"], "N"),
    "convert": (["K", "AA1", "N", "V", "ER0", "T"],
                ["K", "AH0", "N", "V", "ER1", "T"], "N"),
    "convict": (["K", "AA1", "N", "V", "IH0", "K", "T"],
                ["K", "AH0", "N", "V", "IH1", "K", "T"], "N"),
    "decrease": (["D", "IY1", "K", "R", "IY2", "S"],
                 ["D", "IH0", "K", "R", "IY1", "S"], "N"),
    "increase": (["IH1", "N", "K", "R", "IY2", "S"],
                 ["IH0", "N", "K", "R", "IY1", "S"], "N"),
    "insult": (["IH1", "N", "S", "AH2", "L", "T"],
               ["IH0", "N", "S", "AH1", "L", "T"], "N"),
    "protest": (["P", "R", "OW1", "T", "EH2", "S", "T"],
                ["P", "R", "AH0", "T", "EH1", "S", "T"], "N"),
    "rebel": (["R", "EH1", "B", "AH0", "L"],
              ["R", "IH0", "B", "EH1", "L"], "N"),
    "refuse": (["R", "EH1", "F", "Y", "UW2", "S"],
               ["R", "IH0", "F", "Y", "UW1", "Z"], "N"),
    "suspect": (["S", "AH1", "S", "P", "EH2", "K", "T"],
                ["S", "AH0", "S", "P", "EH1", "K", "T"], "N"),
    "survey": (["S", "ER1", "V", "EY2"], ["S", "ER0", "V", "EY1"], "N"),
    "conflict": (["K", "AA1", "N", "F", "L", "IH0", "K", "T"],
                 ["K", "AH0", "N", "F", "L", "IH1", "K", "T"], "N"),
    "console": (["K", "AA1", "N", "S", "OW0", "L"],
                ["K", "AH0", "N", "S", "OW1", "L"], "N"),
    "desert": (["D", "EH1", "Z", "ER0", "T"],
               ["D", "IH0", "Z", "ER1", "T"], "N"),
    "digest": (["D", "AY1", "JH", "EH0", "S", "T"],
               ["D", "AY0", "JH", "EH1", "S", "T"], "N"),
    "export": (["EH1", "K", "S", "P", "AO0", "R", "T"],
               ["IH0", "K", "S", "P", "AO1", "R", "T"], "N"),
    "import": (["IH1", "M", "P", "AO2", "R", "T"],
               ["IH0", "M", "P", "AO1", "R", "T"], "N"),
    "impact": (["IH1", "M", "P", "AE0", "K", "T"],
               ["IH0", "M", "P", "AE1", "K", "T"], "N"),
    "progress": (["P", "R", "AA1", "G", "R", "EH2", "S"],
                 ["P", "R", "AH0", "G", "R", "EH1", "S"], "N"),
    "subject": (["S", "AH1", "B", "JH", "IH0", "K", "T"],
                ["S", "AH0", "B", "JH", "EH1", "K", "T"], "N"),
    "perfect": (["P", "ER1", "F", "IH2", "K", "T"],
                ["P", "ER0", "F", "EH1", "K", "T"], "JJ"),
    "minute": (["M", "IH1", "N", "AH0", "T"],
               ["M", "AY0", "N", "UW1", "T"], "N"),
    "separate": (["S", "EH1", "P", "ER0", "EY2", "T"],
                 ["S", "EH1", "P", "R", "AH0", "T"], "V"),
    "graduate": (["G", "R", "AE1", "JH", "UW0", "EY2", "T"],
                 ["G", "R", "AE1", "JH", "AH0", "W", "AH0", "T"], "V"),
    "estimate": (["EH1", "S", "T", "AH0", "M", "EY2", "T"],
                 ["EH1", "S", "T", "AH0", "M", "AH0", "T"], "V"),
    "alternate": (["AO1", "L", "T", "ER0", "N", "EY2", "T"],
                  ["AO0", "L", "T", "ER1", "N", "AH0", "T"], "V"),
    "duplicate": (["D", "UW1", "P", "L", "AH0", "K", "EY2", "T"],
                  ["D", "UW1", "P", "L", "AH0", "K", "AH0", "T"], "V"),
    "delegate": (["D", "EH1", "L", "AH0", "G", "EY2", "T"],
                 ["D", "EH1", "L", "AH0", "G", "AH0", "T"], "V"),
    "associate": (["AH0", "S", "OW1", "S", "IY0", "EY2", "T"],
                  ["AH0", "S", "OW1", "S", "IY0", "AH0", "T"], "V"),
    "moderate": (["M", "AA1", "D", "ER0", "EY2", "T"],
                 ["M", "AA1", "D", "ER0", "AH0", "T"], "V"),
    "elaborate": (["IH0", "L", "AE1", "B", "ER0", "EY2", "T"],
                  ["IH0", "L", "AE1", "B", "R", "AH0", "T"], "V"),
    "deliberate": (["D", "IH0", "L", "IH1", "B", "ER0", "EY2", "T"],
                   ["D", "IH0", "L", "IH1", "B", "ER0", "AH0", "T"], "V"),
    "appropriate": (["AH0", "P", "R", "OW1", "P", "R", "IY0", "EY2", "T"],
                    ["AH0", "P", "R", "OW1", "P", "R", "IY0", "AH0", "T"], "V"),
    "invalid": (["IH1", "N", "V", "AH0", "L", "AH0", "D"],
                ["IH0", "N", "V", "AE1", "L", "AH0", "D"], "N"),
    "attribute": (["AE1", "T", "R", "AH0", "B", "Y", "UW2", "T"],
                  ["AH0", "T", "R", "IH1", "B", "Y", "UW2", "T"], "N"),
    "compound": (["K", "AA1", "M", "P", "AW0", "N", "D"],
                 ["K", "AH0", "M", "P", "AW1", "N", "D"], "N"),
    "upset": (["AH1", "P", "S", "EH2", "T"], ["AH0", "P", "S", "EH1", "T"], "N"),
    "escort": (["EH1", "S", "K", "AO0", "R", "T"],
               ["EH0", "S", "K", "AO1", "R", "T"], "N"),
    "extract": (["EH1", "K", "S", "T", "R", "AE2", "K", "T"],
                ["IH0", "K", "S", "T", "R", "AE1", "K", "T"], "N"),
    "transplant": (["T", "R", "AE1", "N", "S", "P", "L", "AE0", "N", "T"],
                   ["T", "R", "AE0", "N", "S", "P", "L", "AE1", "N", "T"], "N"),
    "transport": (["T", "R", "AE1", "N", "S", "P", "AO0", "R", "T"],
                  ["T", "R", "AE0", "N", "S", "P", "AO1", "R", "T"], "N"),
    "addict": (["AE1", "D", "IH0", "K", "T"], ["AH0", "D", "IH1", "K", "T"], "N"),
    "ally": (["AE1", "L", "AY0"], ["AH0", "L", "AY1"], "N"),
    "combat": (["K", "AA1", "M", "B", "AE0", "T"],
               ["K", "AH0", "M", "B", "AE1", "T"], "N"),
    "compress": (["K", "AA1", "M", "P", "R", "EH0", "S"],
                 ["K", "AH0", "M", "P", "R", "EH1", "S"], "N"),
    "defect": (["D", "IY1", "F", "EH0", "K", "T"],
               ["D", "IH0", "F", "EH1", "K", "T"], "N"),
    "discharge": (["D", "IH1", "S", "CH", "AA0", "R", "JH"],
                  ["D", "IH0", "S", "CH", "AA1", "R", "JH"], "N"),
    "discount": (["D", "IH1", "S", "K", "AW0", "N", "T"],
                 ["D", "IH0", "S", "K", "AW1", "N", "T"], "N"),
    "incline": (["IH1", "N", "K", "L", "AY0", "N"],
                ["IH0", "N", "K", "L", "AY1", "N"], "N"),
    "intern": (["IH1", "N", "T", "ER0", "N"],
               ["IH0", "N", "T", "ER1", "N"], "N"),
    "overflow": (["OW1", "V", "ER0", "F", "L", "OW2"],
                 ["OW2", "V", "ER0", "F", "L", "OW1"], "N"),
    "relay": (["R", "IY1", "L", "EY2"], ["R", "IY0", "L", "EY1"], "N"),
    "research": (["R", "IY1", "S", "ER0", "CH"],
                 ["R", "IY0", "S", "ER1", "CH"], "N"),
    "torment": (["T", "AO1", "R", "M", "EH2", "N", "T"],
                ["T", "AO0", "R", "M", "EH1", "N", "T"], "N"),
    "update": (["AH1", "P", "D", "EY2", "T"], ["AH0", "P", "D", "EY1", "T"], "N"),
}


def load_homographs(models_dir) -> Dict[str, Tuple[List[str], List[str], str]]:
    """Built-in table, overridden by the bundled ``homographs.en`` when the
    reference assets are installed (exact parity with ``g2p_en.py:15-22``)."""
    table = dict(BUILTIN_HOMOGRAPHS)
    if models_dir is not None:
        path = Path(models_dir) / "g2p" / "en" / "g2p_en" / "homographs.en"
        if path.exists():
            try:
                for line in path.read_text(encoding="utf-8").splitlines():
                    if not line or line.startswith("#"):
                        continue
                    parts = line.strip().split("|")
                    if len(parts) == 4:
                        word, p1, p2, pos1 = parts
                        table[word.lower()] = (p1.split(), p2.split(), pos1)
            except Exception:
                pass
    # the reference's in-code corrections (``english.py:41-46``)
    table["read"] = (["R", "IY1", "D"], ["R", "EH1", "D"], "VBP")
    table["complex"] = (["K", "AH0", "M", "P", "L", "EH1", "K", "S"],
                        ["K", "AA1", "M", "P", "L", "EH0", "K", "S"], "JJ")
    return table


# ---------------------------------------------------------------------------
# name dictionary (restricted pickle)
# ---------------------------------------------------------------------------

class _NoGlobalsUnpickler(pickle.Unpickler):
    def find_class(self, module, name):  # pragma: no cover - defense
        raise pickle.UnpicklingError(
            f"namedict pickles may not reference globals ({module}.{name})")


def load_namedict(models_dir) -> Dict[str, List[List[str]]]:
    if models_dir is None:
        return {}
    path = Path(models_dir) / "g2p" / "en" / "namedict_cache.pickle"
    if not path.exists():
        return {}
    try:
        with open(path, "rb") as f:
            obj = _NoGlobalsUnpickler(f).load()
        return obj if isinstance(obj, dict) else {}
    except Exception:
        return {}


# ---------------------------------------------------------------------------
# word segmentation (compound splitting)
# ---------------------------------------------------------------------------

class Segmenter:
    """Unigram/bigram word segmentation for OOV compounds.

    Follows the wordsegment library's documented scoring (Norvig's "Natural
    Language Corpus Data" construction): P(w) = count/N with an OOV penalty
    of 10/(N·10^len(w)), chained with conditional bigram probabilities; the
    reference calls that library directly (``english.py:204``).  Corpus
    files load from the installed ``wordsegment`` package or from
    ``models_dir/g2p/en/wordsegment/{unigrams,bigrams}.txt``.  Without
    corpus data, a dictionary DP (maximize Σ len²  over known parts) splits
    compounds against the CMU lexicon.
    """

    TOTAL = 1024908267229.0
    LIMIT = 24

    def __init__(self, models_dir=None, lexicon: Optional[Dict] = None):
        self.unigrams: Dict[str, float] = {}
        self.bigrams: Dict[str, float] = {}
        self.lexicon = lexicon or {}
        self._load_corpus(models_dir)

    def _load_corpus(self, models_dir):
        paths = []
        try:
            import wordsegment as _ws  # optional dependency

            base = Path(os.path.dirname(_ws.__file__))
            paths.append(base)
        except ImportError:
            pass
        if models_dir is not None:
            paths.append(Path(models_dir) / "g2p" / "en" / "wordsegment")
        for base in paths:
            uni, bi = base / "unigrams.txt", base / "bigrams.txt"
            if uni.exists():
                self.unigrams = self._parse(uni)
                if bi.exists():
                    self.bigrams = self._parse(bi)
                return

    @staticmethod
    def _parse(path) -> Dict[str, float]:
        out: Dict[str, float] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                word, _, count = line.rstrip("\n").partition("\t")
                if count:
                    out[word] = float(count)
        return out

    def _score(self, word: str, prev: Optional[str]) -> float:
        """log10 probability of ``word`` following ``prev``."""
        if prev is None:
            if word in self.unigrams:
                return math.log10(self.unigrams[word] / self.TOTAL)
            return math.log10(10.0 / self.TOTAL) - len(word)
        bigram = f"{prev} {word}"
        if bigram in self.bigrams and prev in self.unigrams:
            return (math.log10(self.bigrams[bigram] / self.TOTAL)
                    - self._score(prev, None))
        return self._score(word, None)

    def segment(self, text: str) -> List[str]:
        text = re.sub(r"[^a-z0-9]", "", text.lower())
        if not text:
            return []
        if not self.unigrams:
            return self._segment_lexicon(text)

        @functools.lru_cache(maxsize=None)
        def search(start: int, prev: Optional[str]) -> Tuple[float, tuple]:
            if start == len(text):
                return 0.0, ()
            best = (-1e18, ())
            for end in range(start + 1, min(start + self.LIMIT, len(text)) + 1):
                word = text[start:end]
                rest_score, rest = search(end, word)
                cand = self._score(word, prev) + rest_score
                if cand > best[0]:
                    best = (cand, (word,) + rest)
            return best

        result = list(search(0, None)[1])
        search.cache_clear()
        return result

    def _segment_lexicon(self, text: str) -> List[str]:
        """DP fallback: cover the word with known lexicon parts (≥3 chars),
        maximizing Σ len(part)²  — prefers fewer, longer real words."""
        n = len(text)
        best = [None] * (n + 1)  # type: List[Optional[Tuple[float, int]]]
        best[0] = (0.0, -1)
        for end in range(1, n + 1):
            for start in range(max(0, end - self.LIMIT), end):
                if best[start] is None:
                    continue
                part = text[start:end]
                if len(part) >= 3 and part in self.lexicon:
                    score = best[start][0] + len(part) ** 2
                    if best[end] is None or score > best[end][0]:
                        best[end] = (score, start)
        if best[n] is None:
            return [text]
        parts = []
        pos = n
        while pos > 0:
            start = best[pos][1]
            parts.append(text[start:pos])
            pos = start
        parts.reverse()
        return parts
