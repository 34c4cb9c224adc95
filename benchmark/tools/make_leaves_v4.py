"""Write the leaf tables of GPT-SoVITS v4's SoVITS stage under
``benchmark/weights/``: ``sovits-v4`` (the text encoder, style encoder,
quantizer, ``bridge``, ``wns1`` and the flow-matching DiT, laid out as
``sovits/model.safetensors`` with its ``hps.json``) and ``vocoder-v4`` (the
48 kHz HiFi-GAN as ``sovits/vocoder.pth`` beside it), read off the
program's own initialisers at the published widths as
``tools/make_leaves.py`` reads v2's.  The benchmark never runs this script:
it reads the tables.  Run it from the repository root:

    python benchmark/tools/make_leaves_v4.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "benchmark" / "weights"
sys.path[:0] = [str(ROOT), str(Path(__file__).resolve().parent)]

from make_leaves import V2_DATA, V2_MODEL, table  # noqa: E402

#: s2Gv4's ``hps`` as recalled (v2's widths, version "v4"), with the DiT's
#: widths, the chunking and the vocoder of ``TTS.py`` written out
V4_MODEL = {**V2_MODEL, "version": "v4",
            "cfm": {"dim": 1024, "depth": 22, "heads": 16, "dim_head": 64, "ff_mult": 2,
                    "mel_dim": 100, "text_dim": 512, "conv_layers": 4},
            "t_ref": 500, "t_chunk": 1000, "cfm_steps": 32}
V4_VOCODER = {"initial_channel": 100, "resblock_kernel_sizes": [3, 7, 11],
              "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
              "upsample_rates": [10, 6, 2, 2, 2], "upsample_initial_channel": 512,
              "upsample_kernel_sizes": [20, 12, 4, 4, 4]}
V4_HPS = {"data": V2_DATA, "model": V4_MODEL, "train": {"segment_size": 20480},
          "vocoder": V4_VOCODER}
LAYOUTS = {
    "sovits-v4": {"dir": "sovits", "file": "model.safetensors", "container": "safetensors",
                  "meta_file": "hps.json"},
    "vocoder-v4": {"dir": "sovits", "file": "vocoder.pth", "container": "torch",
                   "meta_file": None},
}


def tables(hps: dict, gen: torch.Generator) -> dict:
    """Both v4 tables for ``hps`` (the published one, or a test's)."""
    from gsv_tts_tpu_torch.models import sovits, sovits_v4

    cfg = sovits.SovitsConfig.from_hps(hps["model"], hps["data"]["filter_length"] // 2 + 1)
    v4 = sovits_v4.V4Config.from_hps(hps)
    parts = {"sovits-v4": (sovits_v4.init_params(cfg, v4, gen), hps),
             "vocoder-v4": (sovits_v4.init_vocoder(v4, gen), {})}
    out = {}
    for name, (sd, meta) in parts.items():
        tab = table(sd, None, meta)
        del tab["format"]
        out[name] = {"layout": LAYOUTS[name], **tab}
    return out


def main():
    gen = torch.Generator().manual_seed(0)
    for name, tab in tables(V4_HPS, gen).items():
        (OUT / f"{name}.json").write_text(json.dumps(tab, separators=(",", ":")) + "\n")
        n = sum(int(torch.tensor(s).prod()) for _, s, *_ in tab["leaves"])
        print(f"{name}: {len(tab['leaves'])} leaves, {n} weights")


if __name__ == "__main__":
    main()
