"""Calibrate the EOS length control on the CPU at the published widths.

Draws the t2s weights as the benchmark does (here on the CPU, in float32),
applies the control for each ``(bias, gain)`` given, and decodes seeded
prompts through the program's engine with the benchmark's two sampling
settings (top-k 15 and greedy), in its two modes (``generate``: the
repetition penalty and the suppression window; ``generate_batched``: neither).
Prints the output lengths' mean, median and share at the cache edge.

    python benchmark/tools/calibrate_eos.py --requests 16 --deltas -3.2 -2.9 --seeds 11 22
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

from harness import weights  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--deltas", type=float, nargs="+", default=[-2.9])
    ap.add_argument("--gain", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", default=[7])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--batched", action="store_true")
    ap.add_argument("--config", default="gsv-v2-en")
    args = ap.parse_args()
    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine

    torch.set_num_threads(4)
    table = weights.leaf_table("t2s-s1v3")
    cfg = t2s.T2SConfig.from_checkpoint_config(table["meta"])
    dev = args.device
    dt = torch.bfloat16 if dev == "cuda" else torch.float32
    rng = np.random.RandomState(1)
    prompts = []
    for _ in range(args.requests):
        lx = 35 + int(rng.randint(20, 150))
        ly = int(rng.randint(80, 320))
        prompts.append((rng.randint(1, 732, lx), rng.randint(0, 1024, ly),
                        np.zeros((lx, 1024), np.float32)))
    gain = args.gain
    for delta, seed in [(d, s) for d in args.deltas for s in args.seeds]:
        gen = torch.Generator(device=dev).manual_seed(seed)
        sd = weights.draw_part(table, gen, dev, dt)
        cfg_file = json.loads((HERE / "configs" / f"{args.config}.json").read_text())
        weights.t2s_shaping(sd, table["meta"], cfg_file["assumed"]["t2s_shaping"])
        mu, sigma, best = weights.eos_control(sd, table["meta"], {"delta": delta, "gain": gain},
                                              gen)
        params = t2s.params_from_torch_state_dict(sd, cfg, dtype=dt, device=dev)
        eng = T2SEngine(params, cfg, gpt_cache=[(1, 1024), (4, 1024)], dtype=dt)
        for top_k in (15, 1):
            t0 = time.time()
            g = torch.Generator(device=dev).manual_seed(1)
            if args.batched:
                out, _ = eng.generate_batched([p[0] for p in prompts], [p[1] for p in prompts],
                                              [p[2] for p in prompts], top_k=top_k, generator=g)
                lens = [len(o) for o in out]
            else:
                lens = [eng.generate(*p, top_k=top_k, generator=g).size for p in prompts]
            edge = [1024 - len(p[0]) - len(p[1]) for p in prompts]
            lens = np.asarray(lens)
            at_edge = np.mean([n >= e - 6 for n, e in zip(sorted(lens), sorted(edge))])
            print(f"seed {seed} probe mu {mu:.3f} sigma {sigma:.3f} best {best:.3f} delta {delta} gain {gain} top_k {top_k} {'batched' if args.batched else 'infer'}:"
                  f" mean {lens.mean():.1f} median {np.median(lens):.0f} max {lens.max()} "
                  f"lens {lens.tolist()} ({time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
