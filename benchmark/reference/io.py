"""Read a ``.safetensors`` file the benchmark wrote (no program code)."""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict

import torch

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def load_file(path) -> Dict[str, torch.Tensor]:
    raw = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", raw[:8])
    header = json.loads(raw[8:8 + n])
    data = memoryview(raw)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dt = _DTYPES[info["dtype"]]
        b, e = info["data_offsets"]
        t = torch.frombuffer(bytearray(data[b:e]),
                             dtype=torch.int16 if dt == torch.bfloat16 else dt)
        out[name] = (t.view(torch.bfloat16) if dt == torch.bfloat16 else t).reshape(
            info["shape"])
    return out
