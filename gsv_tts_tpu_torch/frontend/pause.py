"""Pause-symbol normalization (reference ``G2P/Pause.py``): every pause-ish
punctuation mark collapses onto one of the five canonical pause phones."""
import re

pause_map = {
    "!": "!", "！": "!",
    "?": "?", "？": "?",
    "…": "…", "~": "…",
    ".": ".", "。": ".",
    ",": ",", "，": ",", ":": ",", "：": ",", ";": ",", "；": ",",
    "、": ",", "・": ",",
}

escaped_pause = re.escape("".join(pause_map.keys()))
