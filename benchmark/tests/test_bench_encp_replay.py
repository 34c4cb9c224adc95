"""``encp_replay_share.v4``: the share of ``gsv.sovits.encp.*`` calls that
replayed, from span records grouped by request; None where the program marks
neither path (a program before the padded ``decode_encp``) or keeps no span
log."""
import types

import pytest

from harness import cli, spans

NAME = "encp_replay_share.v4"


def rec(i, name, parent=None):
    return types.SimpleNamespace(id=i, name=name, parent=parent)


@pytest.mark.parametrize("calls,want", [
    (["replay", "replay", "replay", "replay"], 1.0),
    (["replay", "eager", "replay", "replay"], 0.75),
    (["eager", "eager", "eager", "eager"], 0.0),
], ids=["replayed", "one-eager", "eager"])
def test_share_of_encp_calls_that_replayed(monkeypatch, calls, want):
    groups = []
    for i in range(2):
        root, top = 10 * i, 10 * i + 1
        group = [rec(root, "gsv.request.infer"), rec(top, "gsv.sovits.encp", parent=root)]
        for j, kind in enumerate(calls[2 * i: 2 * i + 2]):
            group.append(rec(top + 1 + 2 * j, "gsv.sovits.encp." + kind, parent=top))
            group.append(rec(top + 2 + 2 * j, "gsv.sovits.replay", parent=top + 1 + 2 * j))
        groups.append(group)
    monkeypatch.setattr(spans, "by_request", lambda ctx: groups)
    assert cli.metric_reader(NAME)(object()) == want


def test_share_is_none_without_encp_calls_or_a_span_log(monkeypatch):
    groups = [[rec(1, "gsv.request.infer"), rec(2, "gsv.sovits.encp", parent=1),
               rec(3, "gsv.sovits.cfm", parent=1)]]
    monkeypatch.setattr(spans, "by_request", lambda ctx: groups)
    assert cli.metric_reader(NAME)(object()) is None
    monkeypatch.setattr(spans, "by_request", lambda ctx: None)
    assert cli.metric_reader(NAME)(object()) is None
