"""The readers of the program's spans: a traced run of the tiny copy on the
CPU reports each of them in exactly the cells that list it (but for the
two that read the card's events and allocator, which read nothing here),
and against a program that keeps no span log every one returns None."""
import json

import pytest

from harness import cli

import tiny

SPAN_METRICS = ("hubert_ms.newvoice", "sv_emb_ms.newvoice", "decode_gap_ms_per_step.infer",
                "sovits_offgraph_ms.infer", "facade_self_ms.infer", "device_mallocs.infer")
ON_THE_CARD = ("decode_gap_ms_per_step.infer", "device_mallocs.infer")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("spans"), window_requests=12)


def test_each_cell_reports_the_span_metrics_it_lists(root):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    listed = {m["name"]: m["workloads"] for m in bench["per_layer"] if m["name"] in SPAN_METRICS}
    assert set(listed) == set(SPAN_METRICS)
    for cell in ("v2-infer", "v2pro-newvoice"):
        res = cli.run(["--workload", cell, "--seed", "4300000013", "--seconds", "6",
                       "--trace", "1"], root=root, require_cuda=False, device="cpu",
                      config_root=root / "benchmark")
        assert res["correct"] is True
        m = res["metrics"]
        got = {n for n in m if n in SPAN_METRICS}
        assert got == {n for n, cells in listed.items() if cell in cells} - set(ON_THE_CARD)
        assert all(m[n]["value"] >= 0 for n in got)
        if cell == "v2pro-newvoice":
            assert 0 < m["hubert_ms.newvoice"]["value"] <= m["voice_prep_ms.newvoice"]["value"]
            assert 0 < m["sv_emb_ms.newvoice"]["value"] <= m["voice_prep_ms.newvoice"]["value"]


def test_readers_return_none_without_a_span_log(monkeypatch):
    from gsv_tts_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "span_log")
    for name in SPAN_METRICS:
        assert cli.metric_reader(name)(object()) is None, name
