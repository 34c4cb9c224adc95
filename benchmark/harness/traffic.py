"""The one traffic generator: a mix file (``benchmark/traffic/<mix>.json``)
of parameters in, a seeded order of requests out.

A mix gives the voices (how many, clip lengths, cached before the window or
brought by each request), the text lengths in words, the pool's size and
the sampling: every ``greedy_every``-th text decodes greedily with no SoVITS
noise, so its served codes can be judged against the reference; the rest
sample as the library's defaults do.  One client sends the requests back to
back.

The work is the same for every seed: the texts, the voices and their clips
come from ``WORK_SEED``, and each text has its own voice, greedy flag and
sampling seed (the harness seeds the facade's generator with it before the
request), so every seed decodes the same set of output lengths.  The seed
orders the pool, pass after pass.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

HERE = Path(__file__).resolve().parents[1]

#: the seed of the texts, the voices, their clips and each text's sampling seed
WORK_SEED = 1

# common English words (all in the CMU dictionary), for seeded sentences
WORDS = """the a of and to in is was he for it with as his on be at by had they this from
or one have an were her all she there would their we him been has when who will more no
if out so said what up its about into than them can only other new some could time these
two may then do first any my now such like our over man me even most made after also did
many before must through back years where much your way well down should because each just
those people how too little state good very make world still own see men work long get here
between both life being under never day same another know while last might us great old
year off come since against go came right used take three small house around place water
number light morning garden river music story family friend table window evening summer
letter city street voice sound question answer point home school study paper mother father
child children country green road book open early together follow began close near learn
plant cover food sun four thought let keep eye feet tree land line picture again young hand
high every large spell add even land here must big such follow act why ask men change went
kind off need house picture try animal point mother world near build self earth father""".split()

VOWEL_F = (120.0, 300.0)  # Hz: the clips' tone range


@dataclasses.dataclass
class Request:
    index: int
    text: str
    voice: int                # index into the voice pool
    greedy: bool
    sample_seed: int          # the facade's generator is seeded with it before the request


@dataclasses.dataclass
class Voice:
    spk_s: float
    prompt_s: float
    spk_freq: float
    prompt_freq: float
    prompt_text: str


def load_mix(name: str, root: Optional[Path] = None) -> dict:
    path = (root or HERE) / "traffic" / f"{name}.json"
    mix = json.loads(path.read_text())
    mix["name"] = name
    return mix


def spread_sizes(lo: float, hi: float, n: int, rng: np.random.RandomState) -> list:
    """``n`` sizes evenly over [lo, hi], in a seeded order."""
    sizes = list(np.linspace(lo, hi, n)) if n > 1 else [0.5 * (lo + hi)]
    return [sizes[i] for i in rng.permutation(n)]


def sentence(rng: np.random.RandomState, n: int) -> str:
    n = int(round(n))
    words = [WORDS[i] for i in rng.randint(0, len(WORDS), n)]
    if n > 12:  # a clause break, as long sentences have
        words[n // 2] += ","
    text = " ".join(words)
    return text[0].upper() + text[1:] + "."


def voices(mix: dict) -> List[Voice]:
    """The voice pool: clip lengths and prompt-text lengths spread evenly
    over the mix's ranges, tones and words from ``WORK_SEED``."""
    v = mix["voices"]
    rng = np.random.RandomState(WORK_SEED + 1)
    n = v["count"]
    spk = spread_sizes(*v["spk_s"], n, rng)
    prompt = spread_sizes(*v["prompt_s"], n, rng)
    words = spread_sizes(*v["prompt_words"], n, rng)
    return [Voice(spk_s=float(spk[i]), prompt_s=float(prompt[i]),
                  spk_freq=float(rng.uniform(*VOWEL_F)),
                  prompt_freq=float(rng.uniform(*VOWEL_F)),
                  prompt_text=sentence(rng, words[i])) for i in range(n)]


def clip_rng() -> np.random.RandomState:
    """The noise of the voices' clips, drawn in the pool's order."""
    return np.random.RandomState(WORK_SEED + 2)


def schedule(mix: dict, seed: int, n: Optional[int] = None) -> List[Request]:
    """``n`` requests (the mix's ``max_requests`` by default), the pool's
    texts pass after pass, each pass in an order drawn from ``seed``.  Text
    ``j`` decodes greedily when ``j % greedy_every`` is the last of its
    group, and groups of ``greedy_every`` texts share a voice, so every
    voice has greedy texts."""
    rng = np.random.RandomState(seed % (2 ** 32))
    pool = text_pool(mix)
    n = mix["max_requests"] if n is None else n
    every = mix["greedy_every"]
    n_voices = mix["voices"]["count"]
    seq: List[int] = []
    while len(seq) < n:
        seq.extend(int(j) for j in rng.permutation(len(pool)))
    return [Request(index=i, text=pool[j], voice=(j // every) % n_voices,
                    greedy=j % every == every - 1, sample_seed=WORK_SEED * 7919 + j)
            for i, j in enumerate(seq[:n])]


def text_pool(mix: dict) -> List[str]:
    """``text_pool`` sentences whose word counts spread evenly over the
    mix's range, words from ``WORK_SEED``."""
    rng = np.random.RandomState(WORK_SEED + 3)
    return [sentence(rng, n) for n in spread_sizes(*mix["words"], mix["text_pool"], rng)]


def sampling(mix: dict, greedy: bool) -> dict:
    return dict(mix["sampling"], **(mix["greedy"] if greedy else {}))
