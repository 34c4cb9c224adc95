"""The port's spans (``gsv_tts_tpu_torch/utils/timing.py``): nothing but two
clock reads and a flag while no profiler collects; under ``torch.profiler``
a range per span in the trace, nested request → stage → chunk, and a
record per span with its parent, request and thread.  Tiny float32 models
on the CPU."""
import contextlib
import threading

import pytest
import torch

from test_torch_assets import build_assets
from test_torch_assets import one_torch_thread  # noqa: F401
from test_torch_assets import text_modules_as_installed  # noqa: F401

from gsv_tts_tpu_torch.utils import timing

PROMPT_TEXT = "hello there."
TEXT = "one two three."
KW = dict(top_k=1, noise_scale=0.0)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


@pytest.fixture(scope="module")
def tts(assets):
    from gsv_tts_tpu_torch import TTS

    t = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
            device="cpu", seed=0, stream_vocoder="exact")
    t.load_gpt_model(assets["gpt"])
    t.load_sovits_model(assets["sovits"])
    return t


def _infer(tts, assets):
    return tts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, TEXT, **KW)


def _traced(fn):
    """The span records ``fn`` leaves under a CPU profiler, and the profiler."""
    timing.SPAN_LOG.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return timing.span_log(), prof


def _by_id(records):
    return {r.id: r for r in records}


def test_no_profiler_makes_no_range_event_or_record(tts, assets, monkeypatch):
    calls = []

    def counted(name):
        calls.append(name)
        raise AssertionError(f"a profiler range opened with no profiler: {name}")

    monkeypatch.setattr(timing, "_Range", counted)
    monkeypatch.setattr(torch.profiler, "record_function", counted)
    monkeypatch.setattr(torch.cuda, "Event", counted)
    timing.SPAN_LOG.clear()
    assert not torch.autograd._profiler_enabled()
    clip = _infer(tts, assets)
    tts.cache_spk_audio(assets["spk"])
    assert clip.audio_len_s > 0
    assert calls == [] and timing.span_log() == []


def test_profiler_sees_request_stage_and_chunk(tts, assets):
    for p in (assets["spk"], assets["prompt"]):
        tts.spk_audio_cache.pop(p, None)
        tts.prompt_audio_cache.pop(p, None)

    def work():
        tts.cache_spk_audio(assets["spk"])
        tts.cache_prompt_audio(assets["prompt"], PROMPT_TEXT)
        _infer(tts, assets)

    records, prof = _traced(work)
    events = {e.name: e for e in prof.events() if e.name.startswith("gsv.")}
    for name in ("gsv.request.infer", "gsv.request.cache_spk_audio",
                 "gsv.request.cache_prompt_audio", "gsv.frontend", "gsv.t2s.generate",
                 "gsv.t2s.prefill", "gsv.t2s.chunk", "gsv.t2s.readback", "gsv.t2s.host",
                 "gsv.t2s.check", "gsv.sovits.decode", "gsv.sovits.eager",
                 "gsv.sovits.readback", "gsv.tts.finish", "gsv.voice.load", "gsv.voice.spec",
                 "gsv.voice.ge", "gsv.voice.hubert", "gsv.voice.hubert.layer",
                 "gsv.voice.hubert.codes", "gsv.voice.prompt_text"):
        assert name in events, name

    def parents(e):
        out = []
        while e.cpu_parent is not None:
            e = e.cpu_parent
            out.append(e.name)
        return out

    assert parents(events["gsv.t2s.chunk"])[-2:] == ["gsv.t2s.generate", "gsv.request.infer"]
    assert parents(events["gsv.voice.hubert.layer"])[-2:] == [
        "gsv.voice.hubert", "gsv.request.cache_prompt_audio"]
    # the records say the same: every span's chain ends in its request's root
    by_id = _by_id(records)
    for r in records:
        root = r
        while root.parent is not None:
            root = by_id[root.parent]
        assert root.name.startswith(timing.REQUEST) and root.request == r.request
        assert root.t0 <= r.t0 <= r.t1 <= root.t1


def test_two_calls_get_distinct_request_ids(tts, assets):
    records, _ = _traced(lambda: (_infer(tts, assets), _infer(tts, assets)))
    roots = [r for r in records if r.parent is None]
    assert [r.name for r in roots] == ["gsv.request.infer"] * 2
    assert roots[0].request != roots[1].request
    for r in records:
        assert r.request in (roots[0].request, roots[1].request)


def test_stage_timings_fit_in_the_request_span(tts, assets):
    records, _ = _traced(lambda: _infer(tts, assets))
    root, = [r for r in records if r.parent is None]
    lt = tts.last_timings
    assert lt["frontend_s"] + lt["t2s_s"] + lt["sovits_s"] <= root.t1 - root.t0
    stages = {r.name: r for r in records if r.parent == root.id}
    assert lt["t2s_s"] == stages["gsv.t2s.generate"].t1 - stages["gsv.t2s.generate"].t0
    prefill, = [r for r in records if r.name == "gsv.t2s.prefill"]
    assert tts.last_timings["prefill_s"] == prefill.t1 - prefill.t0


def test_chunk_steps_sum_to_the_decode_steps(tts, assets):
    records, _ = _traced(lambda: _infer(tts, assets))
    chunks = [r for r in records if r.name == "gsv.t2s.chunk"]
    assert chunks and all(r.events is None for r in chunks)  # no card: no device events
    assert sum(r.attrs["steps"] for r in chunks) == tts.last_timings["decode_steps"]


def test_threads_keep_their_own_parents(monkeypatch):
    """``torch.profiler`` collects on the thread that started it, so the two
    threads here stand in for threads that each collect: every span opens
    as if a profiler ran, and the two nest without interleaving."""
    monkeypatch.setattr(timing, "_profiling", lambda: True)
    monkeypatch.setattr(timing, "_Range", lambda name: contextlib.nullcontext())
    timing.SPAN_LOG.clear()
    both = threading.Barrier(2, timeout=30)

    def worker(tag):
        with timing.span(f"gsv.test.{tag}"):
            both.wait()  # both roots open before either child
            with timing.span(f"gsv.test.{tag}.child"):
                both.wait()

    threads = [threading.Thread(target=worker, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    by_name = {r.name: r for r in timing.span_log()}
    assert len(by_name) == 4
    for tag in ("a", "b"):
        root, child = by_name[f"gsv.test.{tag}"], by_name[f"gsv.test.{tag}.child"]
        assert root.parent is None and child.parent == root.id
        assert child.thread == root.thread and child.request == root.request
    assert by_name["gsv.test.a"].request != by_name["gsv.test.b"].request
    assert by_name["gsv.test.a"].thread != by_name["gsv.test.b"].thread


def test_eager_sovits_runs_are_spans(tts, assets):
    records, _ = _traced(lambda: _infer(tts, assets))
    by_id = _by_id(records)
    eager = [r for r in records if r.name == "gsv.sovits.eager"]
    # the exact core and the flow on the CPU: two eager runs in the SoVITS stage
    assert len(eager) == 2
    assert all(by_id[r.parent].name == "gsv.sovits.decode" for r in eager)


def test_stream_call_is_one_request(tts, assets):
    """A stream's spans are opened at each resumption, never across a
    yield, and all take the call's one request id."""
    records, _ = _traced(lambda: list(tts.infer_stream(
        assets["spk"], assets["prompt"], PROMPT_TEXT, "a stream of words.", stream_chunk=5,
        debug=False, **KW)))
    roots = [r for r in records if r.parent is None]
    assert len(roots) > 1 and {r.name for r in roots} == {"gsv.request.infer_stream"}
    assert {r.request for r in records} == {roots[0].request}
    assert [r.id for r in roots] == sorted(r.id for r in roots)
    assert all(a.t1 <= b.t0 for a, b in zip(roots, roots[1:]))
    sov = [r for r in records if r.name == "gsv.sovits.decode"]
    assert sov and tts.last_timings["sovits_s"] == pytest.approx(
        sum(r.t1 - r.t0 for r in sov), rel=1e-9)


def test_batched_and_vc_timings_are_their_spans(tts, assets):
    records, _ = _traced(lambda: tts.infer_batched(
        assets["spk"], assets["prompt"], PROMPT_TEXT, ["one two.", "three four five."], **KW))
    root, = [r for r in records if r.parent is None]
    assert root.name == "gsv.request.infer_batched"
    stages = {r.name: r for r in records if r.parent == root.id}
    for key, name in (("frontend_s", "gsv.frontend"), ("t2s_s", "gsv.t2s.generate"),
                      ("sovits_s", "gsv.sovits.decode")):
        assert tts.last_timings[key] == stages[name].t1 - stages[name].t0

    records, _ = _traced(lambda: tts.infer_vc(assets["spk"], assets["prompt"], PROMPT_TEXT,
                                              noise_scale=0.0))
    root, = [r for r in records if r.parent is None]
    assert root.name == "gsv.request.infer_vc"
    stages = {r.name: r for r in records if r.parent == root.id}
    for key, name in (("prompt_s", "gsv.voice.prompt"), ("sovits_s", "gsv.sovits.decode")):
        assert tts.last_timings[key] == stages[name].t1 - stages[name].t0
