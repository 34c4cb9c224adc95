"""GPT-SoVITS v4 in the tiny CPU copy of the benchmark (``tiny.py``):
``install()`` has ``tiny.build`` also write the ``sovits-v4`` and
``vocoder-v4`` leaf tables at tiny widths (``tools/make_leaves_v4.py`` over
the program's initialisers), so that the copy builds with ``gsv-v4-en`` in
``configs/`` and runs ``v4-infer``.  The tiny DiT keeps the mel's 100 bins;
its chunks are 130 frames with prompts of at most 50 and 4 Euler steps, so
the short texts take several chunks."""
from __future__ import annotations

import json
import sys

import torch

import tiny

TINY_DIT = {"dim": 64, "depth": 2, "heads": 4, "dim_head": 16, "ff_mult": 2, "mel_dim": 100,
            "text_dim": 32, "conv_layers": 2, "conv_mult": 2, "freq_embed_dim": 32,
            "conv_pos_kernel": 31, "conv_pos_groups": 16}
TINY_VOCODER = {"initial_channel": 100, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]], "upsample_rates": [10, 6, 8],
                "upsample_initial_channel": 32, "upsample_kernel_sizes": [20, 12, 16]}
HPS_V4 = {"data": tiny.HPS["data"], "train": tiny.HPS["train"],
          "model": {**tiny.HPS["model"], "version": "v4", "cfm": TINY_DIT, "t_ref": 50,
                    "t_chunk": 130, "cfm_steps": 4},
          "vocoder": TINY_VOCODER}


def v4_tables(out) -> dict:
    sys.path.insert(0, str(tiny.BENCH / "tools"))
    from make_leaves_v4 import tables

    tabs = tables(HPS_V4, torch.Generator().manual_seed(7))
    for name, tab in tabs.items():
        (out / f"{name}.json").write_text(json.dumps(tab))
    return tabs


def install():
    """Make ``tiny.build`` write the v4 tables beside the others (once)."""
    if getattr(tiny._tables, "with_v4", False):
        return
    base = tiny._tables

    def _tables(out):
        tabs = base(out)
        tabs.update(v4_tables(out))
        return tabs

    _tables.with_v4 = True
    tiny._tables = _tables
