"""``sv_emb_replay_share.newvoice``: the share of ``gsv.voice.sv_emb``
spans with a ``.replay`` child, from span records grouped by request; None
where the program marks neither path (a program before the embedder's
graphs) or keeps no span log."""
import types

import pytest

from harness import cli, spans

NAME = "sv_emb_replay_share.newvoice"


def rec(i, name, parent=None):
    return types.SimpleNamespace(id=i, name=name, parent=parent)


@pytest.mark.parametrize("children,want", [
    (["gsv.voice.sv_emb.replay", "gsv.voice.sv_emb.replay"], 1.0),
    (["gsv.voice.sv_emb.replay", "gsv.voice.sv_emb.eager"], 0.5),
    (["gsv.voice.sv_emb.eager", "gsv.voice.sv_emb.eager"], 0.0),
    (["gsv.voice.sv_emb.fbank", "gsv.voice.sv_emb.block"], None),
], ids=["replayed", "half", "eager", "neither-path"])
def test_share_of_embeddings_that_replayed(monkeypatch, children, want):
    groups = []
    for i, child in enumerate(children):
        top = rec(10 * i + 1, "gsv.voice.sv_emb", parent=10 * i)
        groups.append([rec(10 * i, "gsv.request.cache_spk_audio"), top,
                       rec(10 * i + 2, child, parent=top.id),
                       rec(10 * i + 3, "gsv.sovits.replay", parent=10 * i + 2)])
    monkeypatch.setattr(spans, "by_request", lambda ctx: groups)
    assert cli.metric_reader(NAME)(object()) == want


def test_share_is_none_without_embeddings_or_a_span_log(monkeypatch):
    monkeypatch.setattr(spans, "by_request", lambda ctx: [[rec(1, "gsv.request.infer")]])
    assert cli.metric_reader(NAME)(object()) is None
    monkeypatch.setattr(spans, "by_request", lambda ctx: None)
    assert cli.metric_reader(NAME)(object()) is None
