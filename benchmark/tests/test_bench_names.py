"""The harness finds configurations, traffic mixes, metrics, limits and
SoVITS families by the names in BENCHMARK.json and the configurations, and
writes weights where the leaf tables' layouts say: a copy with one more
mix and one more metric, or one more family, leaf table and configuration,
runs them with no code edited."""
import json
from pathlib import Path

import pytest
import torch

from harness import cli, traffic, weights

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


PROBE_FAMILY = '''"""A stand-in SoVITS family: v2's VITS stage and one number of its own."""
import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("vits_under_probe",
                                               Path(__file__).with_name("vits.py"))
vits = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(vits)
warm = vits.warm
install = vits.install


def reference(paths, device, weight_fn=None):
    ref = vits.reference(paths, device, weight_fn)
    ref.probe_part = Path(paths["probe"])
    ref.sovits_dir = Path(paths["sovits"])
    return ref


def numbers(ref, items, decodes, ctl=None):
    out = vits.numbers(ref, items, decodes, ctl)
    # 0 while the extra part lies beside the SoVITS model, as its layout says
    out["probe_part_missing"] = float(not (ref.probe_part.is_file()
                                           and ref.probe_part.parent == ref.sovits_dir))
    return out
'''


def test_an_added_family_runs_with_no_code_edited(tmp_path):
    root = tiny.build(tmp_path, window_requests=4)
    bench_dir = root / "benchmark"
    (bench_dir / "families" / "vits_probe.py").write_text(PROBE_FAMILY)
    (bench_dir / "weights" / "probe-extra.json").write_text(json.dumps({
        "layout": {"dir": "sovits", "file": "vocoder.pth", "container": "torch",
                   "meta_file": None},
        "leaves": [["w", [4, 8], "n", 0.0, 0.02]], "meta": {}}))
    cfg = json.loads((bench_dir / "configs" / "gsv-v2-en.json").read_text())
    cfg.update(name="gsv-v2-probe", sovits_family="vits_probe")
    cfg["parts"]["probe"] = "probe-extra"
    (bench_dir / "configs" / "gsv-v2-probe.json").write_text(json.dumps(cfg))
    limits = json.loads((bench_dir / "limits" / "v2-infer.json").read_text())
    limits["limits"]["probe_part_missing"] = 0.5
    (bench_dir / "limits" / "v2-probe.json").write_text(json.dumps(limits))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="gsv-v2-probe",
                                 file="benchmark/configs/gsv-v2-probe.json"))
    bench["workloads"].append({"name": "v2-probe", "config": "gsv-v2-probe",
                               "traffic": "closed_infer", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("v2-probe")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    seen = {}

    def look(c):
        seen["family"] = c.family.__name__
        seen["probe"] = Path(c.paths["probe"])
        seen["on_disk"] = seen["probe"].is_file()

    res = cli.run(["--workload", "v2-probe", "--seed", "4100000023", "--seconds", "600",
                   "--trace", "0"], root=root, require_cuda=False, device="cpu",
                  config_root=bench_dir, hooks=look)
    assert res["correct"] is True
    assert res["checked"]["probe_part_missing"] == [0.0, 0.5]
    assert res["checked"]["sovits_spec"][0] <= res["checked"]["sovits_spec"][1]
    assert seen["family"] == "bench_family_vits_probe"
    assert seen["on_disk"] and seen["probe"].name == "vocoder.pth"
    assert seen["probe"].parent.name == "sovits"


def test_an_unknown_family_is_a_run_error():
    with pytest.raises(cli.RunError, match=r"families/no_such\.py"):
        cli.load_family({"name": "gsv-x", "sovits_family": "no_such"})


@pytest.mark.parametrize("fmt,path,meta", [
    ("gpt_dir", "gpt", "config.json"),
    ("sovits_dir", "sovits", "hps.json"),
    ("hubert_dir", "chinese-hubert-base", "config.json"),
    ("sv_ckpt", "sv/pretrained_eres2netv2w24s4ep4.ckpt", None),
])
def test_the_known_formats_keep_their_paths(tmp_path, fmt, path, meta):
    table = {"format": fmt, "meta": {"k": 1}}
    got = weights.write_part({"w": torch.ones(2, 3)}, table, weights.layout(table, fmt),
                             tmp_path)
    assert got == tmp_path / path
    if meta is None:
        assert torch.equal(torch.load(str(got), weights_only=True)["w"], torch.ones(2, 3))
    else:
        assert json.loads((got / meta).read_text()) == {"k": 1}
        assert torch.equal(weights.load_safetensors(got / "model.safetensors")["w"],
                           torch.ones(2, 3))


def test_a_table_without_a_known_layout_raises(tmp_path):
    (tmp_path / "weights").mkdir()
    (tmp_path / "weights" / "odd.json").write_text(json.dumps(
        {"format": "vocoder_pth", "leaves": [["w", [2], "n", 0.0, 1.0]], "meta": {}}))
    cfg = {"parts": {"vocoder": "odd"}}
    with pytest.raises(ValueError, match="no layout and no known format"):
        weights.write_models(cfg, 1, tmp_path / "m", "cpu", torch.float32, tmp_path)
    assert not (tmp_path / "m").exists()   # refused before anything is written
    for bad in ({"dir": "sovits", "file": "v.pth", "container": "pickle"},
                {"dir": "../out", "file": "v.pth", "container": "torch"}):
        with pytest.raises(ValueError, match="a layout needs"):
            weights.layout({"layout": bad}, "odd")
