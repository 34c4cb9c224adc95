"""Phoneme symbol table (732 symbols) and id mapping, read from this
package's ``assets/symbols.json`` (counterpart of
``gsv_tts_tpu/frontend/symbols.py``)."""
from __future__ import annotations

import json
import os
from typing import Dict, List

SYMBOLS_JSON = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "symbols.json")

with open(SYMBOLS_JSON, encoding="utf-8") as _f:
    _data = json.load(_f)



def get_symbols() -> List[str]:
    return list(_data["symbols"])


symbols: List[str] = get_symbols()
punctuation: List[str] = list(_data["punctuation"])
symbol_to_id: Dict[str, int] = {s: i for i, s in enumerate(symbols)}
symbol_set = frozenset(symbols)
