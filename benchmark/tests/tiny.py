"""A copy of the benchmark at tiny widths, for runs on the CPU in tests.

``build(tmp)`` copies ``BENCHMARK.json`` and the benchmark's folder under
``tmp`` and replaces the t2s, SoVITS and HuBERT leaf tables and the
configurations' widths with tiny ones (the ERes2NetV2 table stays whole, as
the program's own CPU tests keep it); texts are shorter and the windows a
few requests long.  The harness then runs unchanged on it with the card's
look skipped."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

T2S = {"hidden_dim": 128, "embedding_dim": 128, "head": 4, "n_layer": 2, "ffn_dim": 512,
       "vocab_size": 1025, "phoneme_vocab_size": 732, "EOS": 1024, "bert_dim": 1024}
HPS = {"data": {"filter_length": 1408, "hop_length": 320, "win_length": 1408,
                "sampling_rate": 32000, "n_mel_channels": 128},
       "train": {"segment_size": 1280},
       "model": {"inter_channels": 192, "hidden_channels": 192, "filter_channels": 256,
                 "n_heads": 2, "n_layers": 2, "kernel_size": 3, "p_dropout": 0.0,
                 "resblock": "1", "resblock_kernel_sizes": [3],
                 "resblock_dilation_sizes": [[1, 3, 5]], "upsample_rates": [8, 5, 4, 4],
                 "upsample_initial_channel": 64, "upsample_kernel_sizes": [16, 11, 8, 8],
                 "gin_channels": 512, "semantic_frame_rate": "25hz", "version": "v2"}}
HUBERT = dict(hidden_size=768, num_hidden_layers=1, num_attention_heads=4,
              intermediate_size=128, conv_dim=[32, 32, 32, 32], conv_kernel=[10, 8, 4, 4],
              conv_stride=[5, 4, 4, 4], num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=4, feat_extract_norm="group",
              do_stable_layer_norm=False, conv_bias=False)


def _tables(out: Path):
    from gsv_tts_tpu_torch.models import hubert, sovits, t2s

    sys.path.insert(0, str(BENCH / "tools"))
    from make_leaves import table

    gen = torch.Generator().manual_seed(0)
    tcfg = t2s.T2SConfig(hidden_dim=T2S["hidden_dim"], embedding_dim=T2S["embedding_dim"],
                         num_heads=T2S["head"], num_layers=T2S["n_layer"])
    tabs = {"t2s-s1v3": table(t2s.params_to_torch_state_dict(t2s.init_params(tcfg, gen), tcfg),
                              "gpt_dir", tcfg.to_checkpoint_config())}
    hcfg = hubert.HubertConfig.from_dict(HUBERT)
    tabs["hubert-base"] = table(hubert.init_params(hcfg, gen), "hubert_dir", hcfg.to_dict())
    for name, version, gin in (("sovits-v2", "v2", 512), ("sovits-v2pro", "v2Pro", 1024)):
        hps = json.loads(json.dumps(HPS))
        hps["model"].update(gin_channels=gin, version=version)
        cfg = sovits.SovitsConfig.from_hps(hps["model"], hps["data"]["filter_length"] // 2 + 1)
        tabs[name] = table(sovits.init_params(cfg, gen), "sovits_dir", hps)
    for name, tab in tabs.items():
        (out / f"{name}.json").write_text(json.dumps(tab))
    return tabs


def build(tmp: Path, window_requests: int = 6) -> Path:
    root = Path(tmp) / "checkout"
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    tabs = _tables(bench / "weights")
    for path in (bench / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["t2s"] = dict(T2S)
        cfg["sovits"] = tabs[cfg["parts"]["sovits"]]["meta"]
        cfg["hubert"] = tabs["hubert-base"]["meta"]
        cfg["gpt_cache"] = [[1, 256], [1, 512], [4, 512]]
        path.write_text(json.dumps(cfg))
    for path in (bench / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(words=[3, 8], text_pool=6, max_requests=window_requests, trace_slice_s=0.5,
                   check_requests=3, greedy_every=2)
        mix["voices"].update(spk_s=[1.0, 1.5], prompt_s=[1.0, 1.5], prompt_words=[3, 5])
        path.write_text(json.dumps(mix))
    return root
