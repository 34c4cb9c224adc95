"""English text normalization (clean-room).

Behavioral equivalent of the reference ``G2P/English/Normalization/expend.py``:
ordinal list markers, chained arithmetic, negative integers, comma numbers,
12-hour clock times, measurement suffixes, £/$ amounts on either side,
decimals, fractions (half/halves/ordinal-plural), ordinal suffixes,
year-style number grouping, accent stripping, %/i.e./e.g., and uppercase-run
splitting.

The reference leans on the `inflect` package for number wording; this module
ships a small self-contained engine with the same interface
(``number_to_words(n, andword=, zero=, group=)`` / ``ordinal``) and uses the
real package when installed.

One deliberate divergence: inflect emits hyphenated numbers ("twenty-one");
the reference strips the hyphen later and relies on `wordsegment` to re-split
the glued word. This stack has no wordsegment, so hyphens become spaces at
the end of ``normalize``.
"""
from __future__ import annotations

import re
import unicodedata

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
          (10 ** 3, "thousand"), (100, "hundred")]
_ORD_SPECIAL = {"one": "first", "two": "second", "three": "third",
                "five": "fifth", "eight": "eighth", "nine": "ninth",
                "twelve": "twelfth"}


def int_to_words(n: int) -> str:
    if n < 0:
        return "minus " + int_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[r] if r else "")
    for val, name in _SCALE:
        if n >= val:
            q, r = divmod(n, val)
            out = int_to_words(q) + " " + name
            if r:
                out += " " + int_to_words(r)
            return out
    return _ONES[0]


def ordinal_words(n: int) -> str:
    words = int_to_words(n)
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    if last in _ORD_SPECIAL:
        last = _ORD_SPECIAL[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    elif last.endswith("t"):
        last = last + "h"
    else:
        last = last + "th"
    parts[-1] = last
    return " ".join(parts)


def year_words(y: int) -> str:
    if 1000 <= y <= 1999 or 2100 <= y <= 9999:
        hi, lo = divmod(y, 100)
        if lo == 0:
            return int_to_words(hi) + " hundred"
        if lo < 10:
            return int_to_words(hi) + " oh " + int_to_words(lo)
        return int_to_words(hi) + " " + int_to_words(lo)
    return int_to_words(y)


def digits_words(s: str) -> str:
    return " ".join(_ONES[int(c)] if c.isdigit() else c for c in s)


def _decimal_words(s: str) -> str:
    a, b = s.split(".")
    return int_to_words(int(a)) + " point " + digits_words(b)


# ---------------------------------------------------------------------------
# minimal inflect-compatible number engine
# ---------------------------------------------------------------------------

_ORD_WORD_MAP = {"one": "first", "two": "second", "three": "third",
                 "five": "fifth", "eight": "eighth", "nine": "ninth",
                 "twelve": "twelfth"}


class MiniInflect:
    """The subset of `inflect.engine()` the normalizer pipeline uses, with
    inflect's conventions: hyphenated 21-99 compounds, ", " between scale
    chunks, `andword` before a trailing sub-hundred part, `group=2` pair
    reading, and digit/word ordinals."""

    def _two(self, n: int, zero: str) -> str:
        if n == 0:
            return zero
        if n < 20:
            return _ONES[n]
        t, r = divmod(n, 10)
        return _TENS[t] + ("-" + _ONES[r] if r else "")

    def _three(self, n: int, andword: str, zero: str) -> str:
        h, rest = divmod(n, 100)
        if h == 0:
            return self._two(n, zero)
        out = _ONES[h] + " hundred"
        if rest:
            out += (" " + andword + " " if andword else " ") + self._two(rest, zero)
        return out

    def number_to_words(self, n, andword: str = "and", zero: str = "zero",
                        group: int = 0) -> str:
        if isinstance(n, str) and re.fullmatch(r"\d+(st|nd|rd|th)", n):
            return self.ordinal(self.number_to_words(int(n[:-2]),
                                                     andword=andword))
        if isinstance(n, str) and not n.lstrip("-").isdigit():
            return self.ordinal(n)  # word-form passthrough safety
        n = int(n)
        if n < 0:
            return "minus " + self.number_to_words(-n, andword=andword,
                                                   zero=zero, group=group)
        if group == 2:
            s = str(n)
            if len(s) % 2:
                s = "0" + s
            pairs = [int(s[i:i + 2]) for i in range(0, len(s), 2)]
            return ", ".join(
                (zero + " " + _ONES[p % 10] if 0 < p < 10 else
                 self._two(p, zero)) for p in pairs)
        if n == 0:
            return zero
        chunks = []
        scales = ["", " thousand", " million", " billion", " trillion"]
        s = str(n)
        while s:
            chunks.append(int(s[-3:]))
            s = s[:-3]
        parts = []
        for i in range(len(chunks) - 1, -1, -1):
            if chunks[i]:
                parts.append((self._three(chunks[i], andword, zero)
                              if i == 0 else
                              self._three(chunks[i], "", zero)) + scales[i])
        if len(parts) > 1 and chunks[0] and chunks[0] < 100:
            head = ", ".join(parts[:-1])
            joiner = (" " + andword + " ") if andword else " "
            return head + joiner + parts[-1]
        return ", ".join(parts)

    def ordinal(self, x) -> str:
        s = str(x)
        if s.lstrip("-").isdigit():
            n = int(s)
            if 10 <= n % 100 <= 20:
                return s + "th"
            return s + {1: "st", 2: "nd", 3: "rd"}.get(n % 10, "th")
        head, sep, last = s.rpartition(" ")
        h2, sep2, last2 = last.rpartition("-")
        if last2 in _ORD_WORD_MAP:
            last2 = _ORD_WORD_MAP[last2]
        elif last2.endswith("y"):
            last2 = last2[:-1] + "ieth"
        else:
            last2 = last2 + "th"
        return head + sep + h2 + sep2 + last2


try:
    import inflect

    _inflect = inflect.engine()
except ImportError:
    _inflect = MiniInflect()


# ---------------------------------------------------------------------------
# reference-parity pipeline (expend.py:277-311 order)
# ---------------------------------------------------------------------------

_MEASUREMENTS = {
    "m": ("meter", "meters"), "km": ("kilometer", "kilometers"),
    "km/h": ("kilometer per hour", "kilometers per hour"),
    "ft": ("feet", "feet"), "L": ("liter", "liters"),
    "tbsp": ("tablespoon", "tablespoons"), "tsp": ("teaspoon", "teaspoons"),
    "h": ("hour", "hours"), "min": ("minute", "minutes"),
    "s": ("second", "seconds"), "°C": ("degree celsius", "degrees celsius"),
    "°F": ("degree fahrenheit", "degrees fahrenheit"),
}
_RE_LIST_ORDINAL = re.compile(r"\b([0-9]+)\. ")
_RE_COMMA_NUM = re.compile(r"([0-9][0-9\,]+[0-9])")
_RE_TIME12 = re.compile(r"\b([01]?[0-9]|2[0-3]):([0-5][0-9])\b")
_RE_MEASUREMENT = re.compile(
    r"\b([0-9]+(\.[0-9]+)?(m|km|km/h|ft|L|tbsp|tsp|h|min|s|°C|°F))\b")
_RE_POUNDS_L = re.compile(r"£([0-9\.\,]*[0-9]+)")
_RE_POUNDS_R = re.compile(r"([0-9\.\,]*[0-9]+)£")
_RE_DOLLARS_L = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_RE_DOLLARS_R = re.compile(r"([0-9\.\,]*[0-9]+)\$")
_RE_DECIMAL_REF = re.compile(r"([0-9]+\.\s*[0-9]+)")
_RE_FRACTION_REF = re.compile(r"([0-9]+/[0-9]+)")
_RE_ORDINAL_REF = re.compile(r"[0-9]+(st|nd|rd|th)")
_RE_NUMBER_REF = re.compile(r"[0-9]+")
_SUPS = "⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ"
_ASMD_OPERAND_EN = (r"(?:-?(?:\d+(?:\.\d+)?|\.\d+)[" + _SUPS + r"]*"
                    r"|[A-Za-z][" + _SUPS + r"]*)")
_RE_ASMD_EN = re.compile(
    f"({_ASMD_OPERAND_EN})\\s+([+\\-×÷=])\\s+({_ASMD_OPERAND_EN})")
_ASMD_WORDS = {"+": " plus ", "-": " minus ", "×": " times ",
               "÷": " divided by ", "=": " Equals "}
_RE_NEG_INT_EN = re.compile(r"(?:^|\s+)(-)(\d+)")


def _money_words(amount: str, one: str, many: str, small_one: str,
                 small_many: str) -> str:
    parts = amount.split(".")
    if len(parts) > 2:
        return amount + " " + many
    whole = int(parts[0]) if parts[0] else 0
    frac = int(parts[1].ljust(2, "0")) if len(parts) > 1 and parts[1] else 0
    if whole and frac:
        return (f"{whole} {one if whole == 1 else many} and "
                f"{frac} {small_one if frac == 1 else small_many}")
    if whole:
        return f"{whole} {one if whole == 1 else many}"
    if frac:
        return f"{frac} {small_one if frac == 1 else small_many}"
    return f"zero {many}"


def _expand_time12(m: re.Match) -> str:
    hours, minutes = int(m.group(1)), int(m.group(2))
    period = "a.m." if hours < 12 else "p.m."
    if hours > 12:
        hours -= 12
    hw = _inflect.number_to_words(hours)
    if minutes == 0:
        return f"{hw} o'clock {period}"
    return f"{hw} {_inflect.number_to_words(minutes)} {period}"


def _expand_measurement(m: re.Match) -> str:
    unit = m.group(3)
    num = int(m.group(1).replace(unit, "").replace(".", ""))
    plural = not (m.group(2) is None and num == 1)
    return m.group(1).replace(unit, " " + _MEASUREMENTS[unit][int(plural)])


def _expand_decimal_ref(m: re.Match) -> str:
    whole, frac = m.group(1).split(".")
    return whole + " point " + " ".join(frac)


def _expand_fraction(m: re.Match) -> str:
    num, den = map(int, m.group(0).split("/"))
    num_part = _inflect.number_to_words(num)
    if den == 2:
        den_part = "half" if num == 1 else "halves"
    elif den == 1:
        return num_part
    else:
        den_part = _inflect.ordinal(_inflect.number_to_words(den))
        if num > 1:
            den_part += "s"
    return f"{num_part} {den_part}"


def _expand_number_ref(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + _inflect.number_to_words(num % 100)
        if num % 100 == 0:
            return _inflect.number_to_words(num // 100) + " hundred"
        return _inflect.number_to_words(
            num, andword="", zero="oh", group=2).replace(", ", " ")
    return _inflect.number_to_words(num, andword="")


def normalize(text: str) -> str:
    text = _RE_LIST_ORDINAL.sub(
        lambda m: _inflect.ordinal(m.group(1)) + ", ", text)
    while _RE_ASMD_EN.search(text):
        text = _RE_ASMD_EN.sub(
            lambda m: m.group(1) + _ASMD_WORDS[m.group(2)] + m.group(3), text)
    # NOTE: like the reference, this swallows the whitespace before "-N"
    text = _RE_NEG_INT_EN.sub(lambda m: "negative " + m.group(2), text)
    text = _RE_COMMA_NUM.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _RE_TIME12.sub(_expand_time12, text)
    text = _RE_MEASUREMENT.sub(_expand_measurement, text)
    for pat in (_RE_POUNDS_L, _RE_POUNDS_R):
        text = pat.sub(lambda m: _money_words(m.group(1), "pound", "pounds",
                                              "penny", "pence"), text)
    for pat in (_RE_DOLLARS_L, _RE_DOLLARS_R):
        text = pat.sub(lambda m: _money_words(m.group(1), "dollar", "dollars",
                                              "cent", "cents"), text)
    text = _RE_DECIMAL_REF.sub(_expand_decimal_ref, text)
    text = _RE_FRACTION_REF.sub(_expand_fraction, text)
    text = _RE_ORDINAL_REF.sub(
        lambda m: _inflect.number_to_words(m.group(0)), text)
    text = _RE_NUMBER_REF.sub(_expand_number_ref, text)
    text = "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")
    text = text.replace("%", " percent")
    text = re.sub(r"(?i)i\.e\.", "that is", text)
    text = re.sub(r"(?i)e\.g\.", "for example", text)
    text = re.sub(r"(?<!^)(?<![\s])([A-Z])", r" \1", text)
    # divergence from the reference (see module docstring): split inflect's
    # hyphenated numbers here instead of relying on wordsegment downstream
    return text.replace("-", " ")
