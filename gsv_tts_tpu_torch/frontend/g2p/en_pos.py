"""Lightweight Penn-Treebank-style POS tagger for homograph disambiguation.

The reference English G2P disambiguates homographs with nltk's averaged
perceptron tagger (``G2P/English/english.py:124-150``, ``g2p_en.py:134``),
whose pickled weights ship in the downloaded model bundle.  This module is a
dependency-free clean-room tagger tuned for the SAME downstream decision:
homograph entries trigger on prefix matches against {N*, V*, VB*, VBP, VBZ,
VBD, JJ}, so what matters is reliable noun/verb/adjective discrimination in
context, not full-treebank accuracy.

Design: closed-class lexicon → suffix heuristics → two contextual repair
passes (determiner/possessive ⇒ nominal, to/modal/auxiliary ⇒ verbal,
subject-pronoun ⇒ finite verb).  When nltk's tagger data IS available
(reference bundle installed), the dispatcher prefers it for exact parity.
"""
from __future__ import annotations

import re
from typing import List, Sequence, Tuple

# -- closed classes ---------------------------------------------------------

_LEX = {
    "the": "DT", "a": "DT", "an": "DT", "this": "DT", "that": "DT",
    "these": "DT", "those": "DT", "some": "DT", "any": "DT", "no": "DT",
    "every": "DT", "each": "DT", "either": "DT", "neither": "DT",
    "both": "DT", "all": "PDT", "half": "PDT",
    "i": "PRP", "you": "PRP", "he": "PRP", "she": "PRP", "it": "PRP",
    "we": "PRP", "they": "PRP", "me": "PRP", "him": "PRP", "her": "PRP",
    "us": "PRP", "them": "PRP", "myself": "PRP", "yourself": "PRP",
    "himself": "PRP", "herself": "PRP", "itself": "PRP", "ourselves": "PRP",
    "themselves": "PRP",
    "my": "PRP$", "your": "PRP$", "his": "PRP$", "its": "PRP$",
    "our": "PRP$", "their": "PRP$",
    "who": "WP", "whom": "WP", "whose": "WP$", "which": "WDT", "what": "WP",
    "when": "WRB", "where": "WRB", "why": "WRB", "how": "WRB",
    "and": "CC", "or": "CC", "but": "CC", "nor": "CC", "yet": "CC",
    "so": "CC", "plus": "CC",
    "in": "IN", "on": "IN", "at": "IN", "by": "IN", "for": "IN",
    "with": "IN", "about": "IN", "against": "IN", "between": "IN",
    "into": "IN", "through": "IN", "during": "IN", "before": "IN",
    "after": "IN", "above": "IN", "below": "IN", "from": "IN", "up": "IN",
    "down": "IN", "of": "IN", "off": "IN", "over": "IN", "under": "IN",
    "again": "RB", "further": "RB", "then": "RB", "once": "RB",
    "if": "IN", "because": "IN", "as": "IN", "until": "IN", "while": "IN",
    "than": "IN", "whether": "IN", "though": "IN", "although": "IN",
    "since": "IN", "unless": "IN", "upon": "IN", "per": "IN",
    "to": "TO",
    "not": "RB", "n't": "RB", "never": "RB", "always": "RB", "often": "RB",
    "very": "RB", "too": "RB", "also": "RB", "just": "RB", "now": "RB",
    "here": "RB", "there": "EX", "quite": "RB", "rather": "RB",
    "already": "RB", "still": "RB", "yesterday": "NN", "today": "NN",
    "tomorrow": "NN",
    "can": "MD", "could": "MD", "may": "MD", "might": "MD", "must": "MD",
    "shall": "MD", "should": "MD", "will": "MD", "would": "MD",
    "ought": "MD", "cannot": "MD",
    "be": "VB", "am": "VBP", "is": "VBZ", "are": "VBP", "was": "VBD",
    "were": "VBD", "been": "VBN", "being": "VBG",
    "do": "VBP", "does": "VBZ", "did": "VBD", "done": "VBN",
    "have": "VBP", "has": "VBZ", "had": "VBD", "having": "VBG",
    "get": "VB", "got": "VBD", "gets": "VBZ",
    "one": "CD", "two": "CD", "three": "CD", "four": "CD", "five": "CD",
    "six": "CD", "seven": "CD", "eight": "CD", "nine": "CD", "ten": "CD",
    "eleven": "CD", "twelve": "CD", "twenty": "CD", "thirty": "CD",
    "hundred": "CD", "thousand": "CD", "million": "CD", "billion": "CD",
    "first": "JJ", "second": "JJ", "third": "JJ", "last": "JJ",
    "next": "JJ", "new": "JJ", "old": "JJ", "good": "JJ", "bad": "JJ",
    "big": "JJ", "small": "JJ", "great": "JJ", "little": "JJ",
    "own": "JJ", "other": "JJ", "same": "JJ", "such": "JJ", "more": "JJR",
    "most": "JJS", "less": "JJR", "least": "JJS", "many": "JJ",
    "much": "JJ", "few": "JJ", "several": "JJ",
    "please": "VB", "let": "VB", "yes": "UH", "oh": "UH", "ah": "UH",
    "hello": "UH", "hi": "UH", "hey": "UH", "wow": "UH",
}

# common irregular past participles / pasts not derivable by suffix
_VBN = {"given", "taken", "seen", "known", "shown", "grown", "thrown",
        "written", "driven", "eaten", "fallen", "chosen", "spoken",
        "broken", "frozen", "stolen", "worn", "torn", "born", "drawn",
        "gone", "come", "become", "begun", "sung", "drunk", "swum",
        "run", "brought", "bought", "caught", "taught", "thought",
        "found", "held", "kept", "left", "lost", "made", "meant", "met",
        "paid", "said", "sold", "sent", "set", "told", "understood",
        "won", "built", "felt", "heard", "led", "put", "sat", "stood"}

_JJ_SUFFIX = ("ous", "ful", "ive", "able", "ible", "ical", "less", "ish",
              "ary", "ant", "ent")
_NN_SUFFIX = ("tion", "sion", "ment", "ness", "ship", "ance", "ence",
              "ity", "ism", "ist", "ure", "age", "dom", "hood", "logy",
              "graphy", "ing")  # -ing nouns repaired contextually
_RB_SUFFIX = ("ly",)

_NOMINAL_LEFT = {"DT", "PDT", "JJ", "JJR", "JJS", "PRP$", "WP$", "CD",
                 "NN", "NNP"}
_VERBAL_LEFT = {"TO", "MD", "PRP", "WP", "NNS", "EX"}
_AUX = {"is", "are", "was", "were", "be", "been", "being", "am",
        "has", "have", "had", "get", "got", "gets"}


def _initial_tag(word: str, is_first: bool) -> str:
    w = word.lower()
    if not re.search("[a-z]", w):
        return "CD" if re.search(r"\d", w) else w  # punct tags itself
    if w in _LEX:
        return _LEX[w]
    if w in _VBN:
        return "VBN"
    if word[:1].isupper() and not is_first:
        return "NNP"
    if w.endswith("ly") and len(w) > 3:
        return "RB"
    if w.endswith("ing") and len(w) > 4:
        return "VBG"
    if w.endswith("ed") and len(w) > 3:
        return "VBD"
    for suf in _JJ_SUFFIX:
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return "JJ"
    for suf in _NN_SUFFIX:
        if w.endswith(suf) and len(w) > len(suf) + 2:
            return "NN"
    if w.endswith("s") and not w.endswith(("ss", "us", "is")) and len(w) > 3:
        return "NNS"  # may be repaired to VBZ in context
    return "NN"


def pos_tag(words: Sequence[str]) -> List[Tuple[str, str]]:
    """Penn-style tags for a token sequence (same call shape as
    ``nltk.pos_tag``)."""
    tags = [_initial_tag(w, i == 0) for i, w in enumerate(words)]
    lower = [w.lower() for w in words]

    # contextual repair, left-to-right so fixes feed forward
    for i, w in enumerate(lower):
        prev = tags[i - 1] if i else "<s>"
        prev_w = lower[i - 1] if i else ""
        # adverbs are transparent for subject→verb agreement
        # ("she quickly closes")
        if prev == "RB" and i >= 2:
            prev = tags[i - 2]
            prev_w = lower[i - 2]
        nxt = tags[i + 1] if i + 1 < len(tags) else "</s>"

        if tags[i] in ("NN", "NNS", "VBG", "VBD", "VBN", "NNP"):
            # infinitives, modal complements, and imperative chains
            # ("please record …") are base verbs
            if prev in ("TO", "MD") or (prev == "VB" and prev_w in
                                        ("please", "let", "help")):
                tags[i] = "VB"
            # subject pronoun / plural subject ⇒ finite verb
            elif prev in ("PRP", "WP", "EX") and tags[i] in ("NN", "NNS"):
                tags[i] = "VBZ" if (w.endswith("s") and not w.endswith("ss")
                                    and prev_w in ("he", "she", "it")) else "VBP"
            # auxiliary have/be ⇒ participle
            elif prev_w in _AUX and tags[i] == "VBD":
                tags[i] = "VBN"
            # determiner/adjective/possessive ⇒ nominal reading
            elif prev in _NOMINAL_LEFT and tags[i] in ("VBG", "VBD", "VBP"):
                tags[i] = "NN"
        # noun directly before a finite verb was probably a subject; keep.
        # gerund after preposition stays VBG; noun-noun compounds stay NN.
        if tags[i] == "NN" and prev in ("DT", "JJ", "PRP$") and nxt == "NN":
            pass  # compound modifier position — NN is already right
        # sentence-initial imperatives: bare verb candidates
        if i == 0 and tags[i] == "NN" and nxt in ("DT", "PRP$", "PRP"):
            tags[i] = "VB"

    return list(zip(list(words), tags))
