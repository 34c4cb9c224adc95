"""One run of one cell: set-up, the measured window, the check, the line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<mix>.json``); metrics are read by ``metrics/<metric>.py`` and
limits come from ``limits/<cell>.json``, all found by the names in
``BENCHMARK.json``.  The configuration's SoVITS stage is recorded, warmed
and judged by ``families/<sovits_family>.py`` (``vits`` where it names
none).  The last line of standard output is the result.

``--control`` (a calibration run, never the driver's) also reads the
float8 control and judges it by the same limits; a run in which the
control comes out correct exits with 4 and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import guard, stats, traffic, weights

HERE = Path(__file__).resolve().parents[1]   # benchmark/
T_PROCESS = time.perf_counter()


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


class RunError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------

def load_bench(root: Path) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise RunError(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise RunError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str, root: Path = HERE) -> dict:
    return json.loads((root / "configs" / f"{name}.json").read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = HERE):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    return _module(root / "metrics" / f"{name}.py", f"bench_metric_{name}").read


def load_family(cfg: dict, root: Path = HERE):
    """``families/<name>.py`` of the configuration's ``"sovits_family"``
    (default ``vits``): ``install``, ``warm``, ``reference``, ``numbers``."""
    name = cfg.get("sovits_family", "vits")
    path = root / "families" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"configuration {cfg.get('name')!r} names the SoVITS family {name!r}, "
                       f"but {path} does not exist")
    return _module(path, f"bench_family_{name}")


def cell_metrics(bench: dict, cell: str, kind: str) -> List[dict]:
    """The cell's metrics of one kind: those listing it, and those listing
    no cells that move an end-to-end metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def load_limits(cell: str, root: Path = HERE) -> Dict[str, float]:
    return json.loads((root / "limits" / f"{cell}.json").read_text())["limits"]


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------

class Cell:
    """The facade built for one cell, its voices and its requests."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str, tmp: Path,
                 tables: Path = HERE):
        import torch

        from gsv_tts_tpu_torch import TTS

        self.mix, self.device = mix, device
        self.family = load_family(cfg, tables)
        t0 = time.perf_counter()
        self.paths = weights.write_models(cfg, seed, tmp, device,
                                          torch.bfloat16 if device == "cuda" else torch.float32,
                                          tables)
        torch.cuda.synchronize() if device == "cuda" else None
        self.weights_s = time.perf_counter() - t0
        self.gpt_cache = [tuple(b) for b in cfg["gpt_cache"]]
        self.tts = TTS(gpt_cache=self.gpt_cache, sovits_cache=cfg["sovits_cache"],
                       models_dir=str(tmp), device=device,
                       dtype=cfg["dtype"] if device == "cuda" else None,
                       seed=seed % (2 ** 31), attn_impl=cfg["attn_impl"])
        self.gpt_key, self.sovits_key = str(self.paths["gpt"]), str(self.paths["sovits"])
        self.tts.load_gpt_model(self.gpt_key)
        self.tts.load_sovits_model(self.sovits_key)
        self.engine = self.tts.gpt_models[self.gpt_key].engine
        rng = traffic.clip_rng()
        self.voices = []
        for i, v in enumerate(traffic.voices(mix)):
            spk, prompt = tmp / f"spk{i}.wav", tmp / f"prompt{i}.wav"
            weights.save_wav(spk, weights.sine_voice(v.spk_s, v.spk_freq, rng))
            weights.save_wav(prompt, weights.sine_voice(v.prompt_s, v.prompt_freq, rng))
            self.voices.append({"spk": str(spk), "prompt": str(prompt),
                                "text": v.prompt_text})
        self.requests = traffic.schedule(mix, seed)
        self.pool = traffic.text_pool(mix)

    # -- warm-up ----------------------------------------------------------------
    def warm(self):
        """The cell's own shapes: every voice's clips through the
        featurizers and one request with each voice (the first voice in
        both sampling kinds), and every SoVITS graph its texts and lengths
        can reach (the family's ``warm``).  A mix whose requests bring
        their voices has them deleted again."""
        tts, mix = self.tts, self.mix
        cached = mix["voices"]["cached"]
        for i, v in enumerate(self.voices):
            tts.cache_spk_audio(v["spk"])
            tts.cache_prompt_audio(v["prompt"], v["text"])
            for greedy in ((False, True) if i == 0 else (True,)):
                tts.infer(v["spk"], v["prompt"], v["text"], self.pool[0],
                          **traffic.sampling(mix, greedy))
            if not cached:
                tts.del_spk_audio(v["spk"])
                tts.del_prompt_audio(v["prompt"])
        if self.device == "cuda":  # graphs exist on the card only
            self.family.warm(self)


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

def _timings(tts) -> dict:
    lt = tts.last_timings
    keys = ("frontend_s", "sovits_s", "prefill_s", "decode_s", "decode_steps", "tokens",
            "k1_steps", "sovits_graphs")
    return {k: lt[k] for k in keys if k in lt}


def closed_window(c: Cell, seconds: float, rec, slice_) -> dict:
    """One client, back to back, until ``seconds`` have passed; the request
    running at the close completes and counts.  With ``slice_``, the traced
    slice starts at the first request boundary a third into the window and
    stops at the first boundary ``trace_slice_s`` later."""
    import torch

    tts, mix = c.tts, c.mix
    cached = mix["voices"]["cached"]
    out: List[dict] = []
    torch.cuda.synchronize() if c.device == "cuda" else None
    t_open = time.perf_counter()
    deadline = t_open + seconds
    slice_at = t_open + seconds / 3
    slice_reqs: List[int] = []
    tracing = False
    for r in c.requests:
        now = time.perf_counter()
        if now >= deadline:
            break
        if slice_ is not None and not tracing and not slice_reqs and now >= slice_at:
            slice_.start()
            tracing = True
        v = c.voices[r.voice]
        kw = traffic.sampling(mix, r.greedy)
        tts.generator.manual_seed(r.sample_seed)
        item = {"index": r.index, "greedy": r.greedy, "spk_wav": v["spk"],
                "prompt_wav": v["prompt"]} if r.greedy else None
        rec.want(item)
        t0 = time.perf_counter()
        row = {"index": r.index, "greedy": r.greedy, "t_call": t0 - t_open, "ok": True}
        try:
            if not cached:
                tts.cache_spk_audio(v["spk"])
                tts.cache_prompt_audio(v["prompt"], v["text"])
                row["voice_prep_s"] = time.perf_counter() - t0
                if item is not None:
                    emb = tts.spk_audio_cache[v["spk"]].get("sv_emb")
                    item["sv_emb"] = None if emb is None else \
                        emb.reshape(-1).float().cpu().numpy()
            clip = tts.infer(v["spk"], v["prompt"], v["text"], r.text, **kw)
            row["audio_s"] = clip.audio_len_s
            if not cached:
                tts.del_spk_audio(v["spk"])
                tts.del_prompt_audio(v["prompt"])
            row.update(_timings(tts))
            if rec.last_lens is not None:
                row["prompt_len"] = sum(rec.last_lens)
        except Exception as exc:  # noqa: BLE001 - a failed request counts, the run goes on
            row["ok"] = False
            row["error"] = f"{type(exc).__name__}: {exc}"
            log(f"request {r.index} failed: {row['error']}")
        t1 = time.perf_counter()
        row["t_done"] = t1 - t_open
        row["latency_s"] = t1 - t0
        if item is not None and item["gen"]:
            item["codes"] = item["gen"][0]["y"]  # the prompt codes the program fed
        rec.want(None)
        out.append(row)
        if tracing:
            slice_reqs.append(len(out) - 1)
            if t1 - slice_.t0 >= mix["trace_slice_s"]:
                slice_.stop()
                tracing = False
    if tracing:
        slice_.stop()
    return {"requests": out, "t_open": t_open, "seconds": seconds, "slice": slice_reqs}


# ---------------------------------------------------------------------------
# end-to-end metrics
# ---------------------------------------------------------------------------

def end_to_end(win: dict) -> Dict[str, float]:
    reqs = [r for r in win["requests"] if r["ok"]]
    out: Dict[str, float] = {}
    if reqs:
        out["latency_p90_ms"] = stats.percentile([r["latency_s"] * 1000 for r in reqs], 90)
    done = [r for r in reqs if r["t_done"] <= win["seconds"]]
    if done:
        last = max(r["t_done"] for r in done)
        out["audio_s_per_s"] = sum(r["audio_s"] for r in done) / last
    return out


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the control (the reference in float8) after the check")
    return ap.parse_args(argv)


def run(argv, root: Optional[Path] = None, require_cuda: bool = True, device: str = "cuda",
        config_root: Optional[Path] = None, hooks=None) -> dict:
    """One run; returns the result object.  ``require_cuda=False`` (tests
    only) skips the look for a card and runs on ``device``; ``hooks`` may
    change the cell after set-up (a test breaks the timed path there)."""
    args = parse(argv)
    root = Path.cwd() if root is None else root
    bench = load_bench(root)
    cell = find_cell(bench, args.workload)
    croot = config_root or HERE
    import torch

    if require_cuda:
        if not torch.cuda.is_available():
            raise RunError("no CUDA device: the benchmark measures the card and has no CPU path")
        if torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"{cell['name']} needs {cell['chips']} cards, "
                           f"{torch.cuda.device_count()} present")
    cfg = load_config(cell["config"], croot)
    mix = traffic.load_mix(cell["traffic"], croot)
    limits = load_limits(cell["name"], croot)
    with tempfile.TemporaryDirectory(prefix="gsv-bench-") as tmp:
        c = Cell(cfg, mix, args.seed, device, Path(tmp), croot)
        c.warm()
        from .recorder import Recorder

        if hooks is not None:  # beneath the recorder, as a fault in the program would be
            hooks(c)
        rec = Recorder()
        rec.install(c.tts, c.engine, c.family)
        slice_ = None
        if args.trace:
            from .trace import Slice

            slice_ = Slice()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T_PROCESS
        win = closed_window(c, args.seconds, rec, slice_)
        if device == "cuda":
            torch.cuda.synchronize()
        mem_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        rec.finish()
        rec.uninstall()
        summary = slice_.summary() if slice_ is not None else None
        paths, family = c.paths, c.family
        engine_meta = {"s_max": max(s for b, s in c.gpt_cache if b == 1),
                       "suppress_until": c.engine.initial_suppression_steps,
                       "suppressed": tuple(c.engine.cfg.suppressed_tokens)}
        ctx = Context(cfg, mix, win, summary, c)
        del c
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers = judge(cfg, mix, paths, rec.items, engine_meta, device, args.seed, family,
                        control=args.control)
        check_s = time.perf_counter() - t_check
    reqs = win["requests"]
    failed = sum(not r["ok"] for r in reqs)
    e2e = end_to_end(win)
    report_distribution(win, ctx)
    metrics = {}
    if args.trace:
        for m in cell_metrics(bench, cell["name"], "per_layer"):
            v = metric_reader(m["name"], croot)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell["name"], "end_to_end"):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    from .check import checked, limit_lines, verdict

    control = numbers.pop("_control", None)
    correct = failed == 0 and verdict(numbers, limits)
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": len(reqs), "failed": failed,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    log(f"set-up {setup_s:.3f} s (weights {ctx.weights_s:.3f} s), window {args.seconds} s, "
        f"check {check_s:.3f} s; end-to-end {e2e}")
    log(f"readings {json.dumps(numbers)}")
    if control is not None:
        log(f"control readings {json.dumps(control)}")
        for line in limit_lines(control, limits):
            log(f"control {line}")
        result["control"] = {"correct": verdict(control, limits),
                             "checked": checked(control, limits)}
        log(f"control correct: {str(result['control']['correct']).lower()}")
    result["checked"] = checked(numbers, limits)
    for line in limit_lines(numbers, limits):
        log(line)
    return result


class Context:
    """What a per-layer reader may read."""

    def __init__(self, cfg, mix, win, summary, c: Cell):
        from .roofline import Dims

        self.cfg, self.mix, self.win, self.trace = cfg, mix, win, summary
        self.dims = Dims(cfg["t2s"])
        self.requests = [r for r in win["requests"] if r["ok"]]
        self.slice_requests = [win["requests"][i] for i in win["slice"]]
        self.weights_s = c.weights_s
        self.gpt_cache = c.gpt_cache
        self.s_max = max(s for b, s in c.gpt_cache if b == 1)


def report_distribution(win: dict, ctx: Context):
    toks = [r.get("tokens") for r in ctx.requests if r.get("tokens") is not None]
    if toks:
        t = np.asarray(toks)
        log(f"output lengths (codes) over {len(t)} requests: mean {t.mean():.1f}, median "
            f"{np.median(t):.0f}, p90 {stats.percentile(list(t), 90):.0f}, max {t.max()}; "
            f"{int(np.sum(t >= ctx.s_max - 300))} of {ctx.s_max - 300} codes or more")


def judge(cfg, mix, paths, items, meta, device, seed, family,
          control=False) -> Dict[str, float]:
    """The check's numbers (and, with ``control``, the control's under
    ``"_control"``): the t2s gaps, the voices' prompt codes and embedding
    under the family's reference, and the family's own numbers."""
    import torch

    from reference.t2s import T2SReference

    from .check import fp8_rows, select, t2s_gaps, voice_numbers

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState((seed + 2) % (2 ** 32))
    judged = [it for it in items if it["gen"]]
    pick = select(judged, mix["check_requests"], rng)
    gens = [g for it in judged for g in it["gen"]]
    gpt_dir = Path(paths["gpt"])
    sd = weights.load_safetensors(gpt_dir / "model.safetensors")
    config = json.loads((gpt_dir / "config.json").read_text())
    sample = {"penalty": mix["sampling"]["repetition_penalty"],
              "suppress_until": meta["suppress_until"], "suppressed": meta["suppressed"]}
    numbers: Dict[str, float] = {}
    ref = T2SReference(sd, config, device)
    numbers.update(t2s_gaps(ref, gens, sample, meta["s_max"]))
    ctl_numbers = {}
    if control:
        ctl_ref = T2SReference(sd, config, device, weight_fn=fp8_rows)
        ctl_numbers.update(t2s_gaps(ref, gens, sample, meta["s_max"], ctl_ref=ctl_ref))
        del ctl_ref
    del ref, sd
    vref = family.reference(paths, device)
    voices, seen = [], set()  # every voice a judged request brought
    for it in judged:
        if it["prompt_wav"] not in seen:
            seen.add(it["prompt_wav"])
            voices.append({"prompt_wav": it["prompt_wav"], "spk_wav": it["spk_wav"],
                           "codes": np.asarray(it.get("codes", [])),
                           "sv_emb": it.get("sv_emb")})
    decodes = [dict(d, spk_wav=it["spk_wav"]) for it in pick for d in it["sovits"][:1]]
    numbers.update(voice_numbers(vref, voices))
    numbers.update(family.numbers(vref, judged, decodes))
    if control:
        ctl = family.reference(paths, device, weight_fn=fp8_rows)
        ctl_numbers.update(voice_numbers(vref, voices, ctl=ctl))
        ctl_numbers.update(family.numbers(vref, judged, decodes, ctl=ctl))
        numbers["_control"] = ctl_numbers
    numbers["judged_requests"] = len(judged)
    return numbers


def main(argv=None, **run_kw) -> int:
    """``run_kw`` go to :func:`run` (tests only)."""
    argv = sys.argv[1:] if argv is None else argv
    guard.no_outside_connections()
    try:
        result = run(argv, **run_kw)
    except RunError as exc:
        log(f"benchmark: {exc}")
        return 2
    found = guard.forbidden_modules()
    if found:
        log(f"benchmark: forbidden modules loaded in this process: {', '.join(found)}")
        return 3
    control = result.pop("control", None)
    if control is not None and control["correct"]:
        log("benchmark: the control came out correct: the limits do not separate it")
        return 4
    checked = result.pop("checked")
    result["checked"] = checked
    print(json.dumps(result), flush=True)
    return 0
