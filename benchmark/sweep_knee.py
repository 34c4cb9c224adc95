"""Find the highest arrival rate that shared streams sustain: one process
sets a configuration up once, then offers each rate in turn for
``--seconds`` of open-loop Poisson arrivals into ``TTS.stream_shared`` (a
traffic file's texts, voices and sampling), lets the streams finish, and
prints a row per rate: TTFA p50 and p95 from the due time, the chunk gap
p95, the share of streams that never underran, the generator's lateness,
the streams still running after the drain and the vocoder graphs captured.
Run once on the card; a stream cell takes its rate from the table.

    python3 benchmark/sweep_knee.py --config gsv-v2-en --traffic open_shared_stream \\
        --seed 7 --seconds 20 --rates 0.5 1 1.5 2 3
"""
import argparse
import os
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()
os.environ["GSV_OFFLINE"] = "1"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path[:0] = [str(ROOT), str(HERE)]

from harness import cli, stats, traffic  # noqa: E402


def offer(c, mix, rate: float, seconds: float, seed: int) -> dict:
    """Poisson arrivals at ``rate`` for ``seconds``, each request a
    ``stream_shared`` client on a thread of its own, timed from its due
    time; the running streams then get ``drain_s`` to finish."""
    tts = c.tts
    rng = np.random.RandomState(seed % (2 ** 32))
    reqs = traffic.schedule(mix, seed)
    due = np.cumsum(rng.exponential(1.0 / rate, len(reqs)))
    rows, threads, lateness = [], [], []

    def client(r, due_abs):
        v = c.voices[r.voice]
        row = {"ok": True, "chunks": []}
        try:
            for clip in tts.stream_shared(v["spk"], v["prompt"], v["text"], r.text,
                                          stream_chunk=mix["stream_chunk"], debug=False,
                                          is_cut_text=False, **traffic.sampling(mix, r.greedy)):
                row["chunks"].append((time.perf_counter() - due_abs,
                                      len(clip.audio_data) / clip.samplerate))
        except Exception as exc:  # noqa: BLE001 - a failed stream counts, the sweep goes on
            row["ok"] = False
            print(f"stream failed: {type(exc).__name__}: {exc}", file=sys.stderr)
        rows.append(row)

    t_open = time.perf_counter()
    for r, d in zip(reqs, due):
        if d >= seconds:
            break
        due_abs = t_open + d
        while time.perf_counter() < due_abs:
            time.sleep(min(0.002, max(0.0, due_abs - time.perf_counter())))
        lateness.append(time.perf_counter() - due_abs)
        th = threading.Thread(target=client, args=(r, due_abs), daemon=True)
        th.start()
        threads.append(th)
    end = time.perf_counter() + mix["drain_s"]
    for th in threads:
        th.join(timeout=max(0.0, end - time.perf_counter()))
    return {"rows": rows, "lateness": lateness,
            "unfinished": sum(th.is_alive() for th in threads)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--warm-seconds", type=float, default=20.0,
                    help="traffic at the first rate before the table, so graphs the "
                         "arrivals make are captured there")
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args()
    cfg = cli.load_config(args.config)
    mix = traffic.load_mix(args.traffic)
    with tempfile.TemporaryDirectory(prefix="gsv-sweep-") as tmp:
        c = cli.Cell(cfg, mix, args.seed, "cuda", Path(tmp))
        tts = c.tts
        tts.wave_max_batch = mix["wave_max_batch"]
        for v in c.voices:
            tts.cache_spk_audio(v["spk"])
            tts.cache_prompt_audio(v["prompt"], v["text"])
        offer(c, mix, args.rates[0], args.warm_seconds, args.seed + 7919)
        print("rate_per_s,arrivals,ttfa_p50_ms,ttfa_p95_ms,chunk_gap_p95_ms,no_underrun_share,"
              "late_p95_ms,unfinished,captures", flush=True)
        for i, rate in enumerate(args.rates):
            g0 = tts.sovits_graphs.captures
            win = offer(c, mix, rate, args.seconds, args.seed + 1000 * (i + 1))
            reqs = [r for r in win["rows"] if r["ok"] and r["chunks"]]
            ttfa = [1000 * r["chunks"][0][0] for r in reqs]
            gaps = [1000 * (b[0] - a[0]) for r in reqs for a, b in zip(r["chunks"],
                                                                     r["chunks"][1:])]
            smooth = sum(stats.lead_and_underrun(r["chunks"])[1] for r in reqs) / max(len(reqs), 1)
            late = [1000 * x for x in win["lateness"]]
            print(f"{rate},{len(late)},{stats.percentile(ttfa, 50):.1f},"
                  f"{stats.percentile(ttfa, 95):.1f},"
                  f"{stats.percentile(gaps, 95) if gaps else float('nan'):.1f},{smooth:.3f},"
                  f"{stats.percentile(late, 95):.2f},{win['unfinished']},"
                  f"{tts.sovits_graphs.captures - g0}", flush=True)
            time.sleep(1.0)
        for sched in list(tts._wave_schedulers.values()):
            sched.close()
        if tts._vocoder_batcher is not None:
            tts._vocoder_batcher.close()


if __name__ == "__main__":
    main()
