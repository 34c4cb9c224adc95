"""The harness finds configurations, traffic mixes, metrics and limits by
the names in BENCHMARK.json: a copy with one more mix and one more metric
runs them with no code edited."""
import json

from harness import cli, traffic

import tiny


def test_files_are_found_by_name():
    bench = cli.load_bench(cli.HERE.parent)
    for cfg in bench["configs"]:
        assert cli.load_config(cfg["name"])["name"] == cfg["name"]
    for w in bench["workloads"]:
        assert traffic.load_mix(w["traffic"])["voices"]["count"]
        assert cli.load_limits(w["name"])
        for kind in ("end_to_end", "per_layer"):
            for m in cli.cell_metrics(bench, w["name"], kind):
                if kind == "per_layer":
                    assert callable(cli.metric_reader(m["name"]))
        names = {m["name"] for m in cli.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert cli.cell_metrics(bench, w["name"], "per_layer")


def test_an_added_mix_and_metric_run_with_no_code_edited(tmp_path):
    root = tiny.build(tmp_path, window_requests=12)
    bench_dir = root / "benchmark"
    mix = json.loads((bench_dir / "traffic" / "closed_infer.json").read_text())
    mix.update(words=[2, 4], greedy_every=2)
    (bench_dir / "traffic" / "short_texts.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "requests_in_slice.extra.py").write_text(
        '"""Requests in the traced slice."""\n\n\ndef read(ctx):\n'
        '    return float(len(ctx.slice_requests)) or None\n')
    (bench_dir / "limits" / "v2-short.json").write_text(
        json.dumps({"limits": {"t2s_gap": 0.15}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "v2-short", "config": "gsv-v2-en",
                               "traffic": "short_texts", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("v2-short")
    bench["per_layer"].append({"name": "requests_in_slice.extra", "unit": "requests",
                               "better": "higher", "source": "program_counter",
                               "layer": "t2s engine", "moves": "latency_p90_ms",
                               "workloads": ["v2-short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = cli.run(["--workload", "v2-short", "--seed", "4100000007", "--seconds", "8",
                   "--trace", "1"], root=root, require_cuda=False, device="cpu",
                  config_root=bench_dir)
    assert res["correct"] is True
    assert res["metrics"]["requests_in_slice.extra"]["value"] >= 1
    assert "frontend_ms.infer" not in res["metrics"]   # listed for other cells only
    assert list(res)[-1] == "checked"
