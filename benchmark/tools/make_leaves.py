"""Write the leaf tables under ``benchmark/weights/``: for every weight of a
model part, its checkpoint key, shape and how the benchmark draws it
(``["n", mean, std]`` normal, ``["u", lo, hi]`` uniform, ``["c", value]``
constant).

The tables are read off the program's own random initialisers, once, at the
published widths, so that the weights the benchmark makes on the card have
the scales the program's tests and smoke use.  The benchmark never runs this
script: it reads the tables.  Run it from the repository root:

    python benchmark/tools/make_leaves.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "benchmark" / "weights"

V2_MODEL = {"inter_channels": 192, "hidden_channels": 192, "filter_channels": 768,
            "n_heads": 2, "n_layers": 6, "kernel_size": 3, "p_dropout": 0.1,
            "resblock": "1", "resblock_kernel_sizes": [3, 7, 11],
            "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
            "upsample_rates": [10, 8, 2, 2, 2], "upsample_initial_channel": 512,
            "upsample_kernel_sizes": [16, 16, 8, 2, 2], "gin_channels": 512,
            "semantic_frame_rate": "25hz", "version": "v2"}
V2_DATA = {"sampling_rate": 32000, "filter_length": 2048, "hop_length": 640,
           "win_length": 2048, "n_mel_channels": 128}


def leaf(t: torch.Tensor):
    t = t.double()
    lo, hi = float(t.min()), float(t.max())
    if lo == hi:
        return ["c", lo]
    if t.dim() == 1 and lo >= 0.5 and hi <= 1.5 and t.numel() > 8 and hi - lo > 0.5:
        return ["u", 0.5, 1.5]  # the speaker embedder's BatchNorm scales and variances
    return ["n", round(float(t.mean()), 6) if abs(float(t.mean())) > 0.05 else 0.0,
            round(float(t.std()), 6)]


def table(sd, fmt, meta):
    return {"format": fmt, "meta": meta,
            "leaves": [[k, list(v.shape), *leaf(v)] for k, v in sd.items()]}


def main():
    sys.path.insert(0, str(ROOT))
    from gsv_tts_tpu_torch.models import hubert, sovits, sv, t2s

    gen = torch.Generator().manual_seed(0)
    OUT.mkdir(parents=True, exist_ok=True)
    tcfg = t2s.T2SConfig()
    tables = {
        "t2s-s1v3": table(t2s.params_to_torch_state_dict(t2s.init_params(tcfg, gen), tcfg),
                          "gpt_dir", tcfg.to_checkpoint_config()),
        "hubert-base": table(hubert.init_params(hubert.HubertConfig(), gen), "hubert_dir",
                             hubert.HubertConfig().to_dict()),
        "eres2netv2": table(sv.init_params(sv.SVConfig(), gen), "sv_ckpt", {}),
    }
    for name, version, gin in (("sovits-v2", "v2", 512), ("sovits-v2pro", "v2Pro", 1024)):
        model = {**V2_MODEL, "gin_channels": gin, "version": version}
        cfg = sovits.SovitsConfig.from_hps(model, V2_DATA["filter_length"] // 2 + 1)
        hps = {"data": V2_DATA, "model": model, "train": {"segment_size": 20480}}
        tables[name] = table(sovits.init_params(cfg, gen), "sovits_dir", hps)
    for name, tab in tables.items():
        (OUT / f"{name}.json").write_text(json.dumps(tab, separators=(",", ":")) + "\n")
        n = sum(int(torch.tensor(s).prod()) for _, s, *_ in tab["leaves"])
        print(f"{name}: {len(tab['leaves'])} leaves, {n} weights")


if __name__ == "__main__":
    main()
