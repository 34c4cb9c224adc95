"""Batched and shared-wave streaming at the port's facade against the JAX
facade: ``TTS.infer_batched_stream`` (the engine's grouped events, the
coinciding chunks vocoded by one ``VocoderBatcher.decode_many`` call),
``TTS.stream_shared`` (``runtime/wave.py`` and the batcher's worker), the
batcher itself, the async wrappers, ``warmup(stream=True)`` and
``unload_gpt_model`` closing the model's scheduler.

Both facades run their default SoVITS path (``sovits_cache=[50, 55]``,
``stream_vocoder="bucketed"``) in float32 on the tiny checkpoints of
``test_torch_assets``, with ``top_k=1`` and ``noise_scale=0``.  Tolerance:
rtol 2e-4, atol 2e-5 (summation order only); subtitle words and text
indices equal, times within 1e-6 s.  Every blocking wait has a deadline."""
import asyncio
import threading
import time

import numpy as np
import pytest

from test_torch_assets import build_assets, text_modules_as_installed  # noqa: F401
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
PROMPT_TEXT = "hello there."
TEXTS = ["this is a test.", "good day to you!", "one more line."]
GPT_CACHE = [(1, 128), (4, 96)]


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


@pytest.fixture(scope="module")
def pair(assets):
    import jax

    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    jtts = JaxTTS(gpt_cache=GPT_CACHE, models_dir=str(assets["root"]), dtype="float32")
    jtts.load_gpt_model(assets["gpt"])
    jtts.load_sovits_model(assets["sovits"])
    jtts._rng = jax.random.PRNGKey(0)
    ptts = TTS(gpt_cache=GPT_CACHE, models_dir=str(assets["root"]), device="cpu", seed=0)
    ptts.load_gpt_model(assets["gpt"])
    ptts.load_sovits_model(assets["sovits"])
    yield jtts, ptts
    for t in (jtts, ptts):
        for sched in t._wave_schedulers.values():
            sched.close()
        if t._vocoder_batcher is not None:
            t._vocoder_batcher.close()


def same_subtitles(got, want):
    assert [(s["text"], s["orig_idx_start"], s["orig_idx_end"]) for s in got] == \
        [(s["text"], s["orig_idx_start"], s["orig_idx_end"]) for s in want]
    for g, w in zip(got, want):
        assert g["start_s"] == pytest.approx(w["start_s"], abs=1e-6)
        if w["end_s"] is None:
            assert g["end_s"] is None
        else:
            assert g["end_s"] == pytest.approx(w["end_s"], abs=1e-6)


def test_infer_batched_stream_matches_jax_clip_for_clip(assets, pair):
    """Order, ``req_done``, lengths, samples and subtitles of every event
    equal JAX's; the coinciding chunks went through the batcher."""
    jtts, ptts = pair
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT, TEXTS)
    kw = dict(top_k=1, noise_scale=0.0, stream_chunk=20, return_subtitles=True)
    jev = list(jtts.infer_batched_stream(*args, **kw))
    before = ptts.vocoder_batch_stats().get("rows", 0)
    pev = list(ptts.infer_batched_stream(*args, **kw))
    assert [(i, d) for i, _, d in pev] == [(i, d) for i, _, d in jev]
    assert sum(d for _, _, d in pev) == len(TEXTS) and len(pev) > 2 * len(TEXTS)
    for n, ((_, pc, _), (_, jc, _)) in enumerate(zip(pev, jev)):
        assert pc.audio_data.shape == np.asarray(jc.audio_data).shape, f"event {n}"
        np.testing.assert_allclose(pc.audio_data, np.asarray(jc.audio_data), rtol=RTOL,
                                   atol=ATOL, err_msg=f"event {n}")
        assert pc.audio_len_s == pytest.approx(jc.audio_len_s, abs=1e-9)
        same_subtitles(pc.subtitles, jc.subtitles)
    assert ptts.vocoder_batch_stats()["rows"] - before >= 2 * len(TEXTS)
    assert ptts.last_timings["tokens"] > 0 and ptts.last_timings["k2_steps"] > 0


def test_stream_shared_single_client_matches_jax(assets, pair):
    """One client: the wave's tokens and the solo chunks give JAX's clips,
    and the same audio as ``infer_batched_stream`` of the one text."""
    jtts, ptts = pair
    text = "this is a longer test sentence to stream."
    kw = dict(top_k=1, noise_scale=0.0, stream_chunk=10, is_cut_text=False,
              return_subtitles=True)
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT, text)
    jclips = list(jtts.stream_shared(*args, debug=False, **kw))
    pclips = list(ptts.stream_shared(*args, debug=False, **kw))
    assert [len(c.audio_data) for c in pclips] == [len(c.audio_data) for c in jclips]
    assert len(pclips) >= 3
    for n, (pc, jc) in enumerate(zip(pclips, jclips)):
        np.testing.assert_allclose(pc.audio_data, np.asarray(jc.audio_data), rtol=RTOL,
                                   atol=ATOL, err_msg=f"chunk {n}")
        same_subtitles(pc.subtitles, jc.subtitles)
    batched = [c.audio_data for _, c, _ in ptts.infer_batched_stream(
        assets["spk"], assets["prompt"], PROMPT_TEXT, [text], **kw)]
    np.testing.assert_array_equal(np.concatenate(batched),
                                  np.concatenate([c.audio_data for c in pclips]))
    # the idle wave is torn down (its cache freed)
    deadline = time.time() + 10.0
    while time.time() < deadline and any(v["waves"] for v in ptts.wave_stats().values()):
        time.sleep(0.05)
    assert all(not v["waves"] for v in ptts.wave_stats().values())


def _rows(tts, sovits, ge, rng_seed=5, overlap=5):
    """Chunk states at different points of their streams: two first chunks
    of different lengths and one cross-faded continuation (its carried
    overlap from a solo first chunk)."""
    rng = np.random.RandomState(rng_seed)
    c_long = rng.randint(0, 1024, 41).astype(np.int64)
    t_long = rng.randint(1, 100, 13).astype(np.int64)
    _, _, carry = tts._sovits_decode_stream(sovits, c_long[None, None, :20], t_long[None], ge,
                                            noise_scale=0.0, speed=1.0, y_overlap=None,
                                            valid_start_idx=0, overlap_len=overlap)
    return [(c_long[:20], t_long, 0, None), (c_long, t_long, 35, carry),
            (rng.randint(0, 1024, 9).astype(np.int64),
             rng.randint(1, 100, 7).astype(np.int64), 0, None),
            (c_long[:33], t_long[:11], 0, None)]


@pytest.mark.parametrize("n_rows", [2, 3, 4])
def test_decode_many_rows_match_solo_and_jax(assets, pair, n_rows):
    """``decode_many`` at B=2 and B=4 (three rows: one masked dummy row):
    each row's audio, attention and carried overlap equal its solo
    ``_sovits_decode_stream`` and JAX's ``decode_many`` row."""
    import jax.numpy as jnp

    from gsv_tts_tpu.runtime.vocoder_batch import VocoderBatcher as JaxBatcher
    from gsv_tts_tpu_torch.runtime.vocoder_batch import VocoderBatcher

    jtts, ptts = pair
    psov, pge = ptts._prepare_sovits_resources(assets["sovits"], assets["spk"])
    jsov, jge = jtts._prepare_sovits_resources(assets["sovits"], assets["spk"])
    rows = _rows(ptts, psov, pge)[:n_rows]
    solo = [ptts._sovits_decode_stream(psov, c[None, None, :], t[None], pge, noise_scale=0.0,
                                       speed=1.0, y_overlap=yo, valid_start_idx=v,
                                       overlap_len=5) for c, t, v, yo in rows]
    pb = VocoderBatcher(ptts, max_batch=4)
    jb = JaxBatcher(jtts, max_batch=4)
    try:
        got = pb.decode_many([(psov, c, t, pge, 0.0, yo, v, 5) for c, t, v, yo in rows])
        want = jb.decode_many([(jsov, c.astype(np.int32), t.astype(np.int32), jge, 0.0,
                                None if yo is None else jnp.asarray(yo.numpy()), v, 5)
                               for c, t, v, yo in rows])
        assert pb.stats["max_group"] == n_rows and pb.stats["solo_rows"] == 0
    finally:
        pb.close()
        jb.close()
    for i, (g, s, w) in enumerate(zip(got, solo, want)):
        for name, a, b, c in zip(("audio", "attn", "overlap"), g, s, w):
            a = a.numpy() if hasattr(a, "numpy") else np.asarray(a)
            b = b.numpy() if hasattr(b, "numpy") else np.asarray(b)
            assert a.shape == b.shape == np.asarray(c).shape, (i, name)
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f"row {i} {name} solo")
            np.testing.assert_allclose(a, np.asarray(c), rtol=RTOL, atol=ATOL,
                                       err_msg=f"row {i} {name} jax")


def test_concurrent_clients_engage_the_batcher(assets):
    """Three client threads at once: each finishes with finite audio of about
    its solo length, the wave holds more than one slot, and coinciding
    chunks run as batched groups (a wide window: a slow CPU box)."""
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.runtime.vocoder_batch import VocoderBatcher

    # one cache length at every batch size: a lone client and a shared wave
    # decode to the same edge
    ptts = TTS(gpt_cache=[(1, 128), (4, 128)], models_dir=str(assets["root"]), device="cpu",
               seed=0)
    ptts.load_gpt_model(assets["gpt"])
    ptts.load_sovits_model(assets["sovits"])
    texts = ["the first client speaks now.", "meanwhile a second client is talking.",
             "and one more joins in."]
    kw = dict(top_k=1, noise_scale=0.0, stream_chunk=20, is_cut_text=False, debug=False)
    solo = [sum(len(c.audio_data) for c in ptts.stream_shared(
        assets["spk"], assets["prompt"], PROMPT_TEXT, t, **kw)) for t in texts]
    old = ptts._vocoder_batcher
    ptts._vocoder_batcher = VocoderBatcher(ptts, max_batch=4, window_s=0.15)
    sched = ptts._get_wave_scheduler(assets["gpt"])
    live0 = sched.stats["totals"]["max_live"]
    results, errors = [None] * 3, []

    def client(i):
        try:
            results[i] = list(ptts.stream_shared(assets["spk"], assets["prompt"], PROMPT_TEXT,
                                                 texts[i], **kw))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        stats = dict(ptts.vocoder_batch_stats())
        totals, clients = sched.stats["totals"], sched.stats["clients"]
    finally:
        ptts._vocoder_batcher.close()
        ptts._vocoder_batcher = old
        ptts.unload_gpt_model(assets["gpt"])
    for i, clips in enumerate(results):
        audio = np.concatenate([c.audio_data for c in clips])
        assert np.all(np.isfinite(audio)) and audio.dtype == np.float32
        assert abs(audio.size - solo[i]) <= 4 * 2 * 640 * 5, (i, audio.size, solo[i])
    assert stats["max_group"] >= 2 and stats["rows"] > stats["solo_rows"], stats
    assert live0 == 1 and totals["max_live"] >= 2 and totals["k2_steps"] > 0
    assert clients == 0  # every client released its slot


class _StubFacade:
    """What ``VocoderBatcher`` reads of a facade: one open client, and a solo
    decode that holds until released."""

    def __init__(self, clients):
        self.clients = clients
        self.release = threading.Event()
        self.calls = 0

    def wave_stats(self):
        return {"m": {"clients": self.clients}}

    def _sovits_decode_stream(self, *a, **kw):
        self.calls += 1
        assert self.release.wait(timeout=30.0)
        return "solo"


def test_close_fails_queued_items():
    """``close()`` fails what is still queued (its callers would otherwise
    wait for ever) and refuses new chunks."""
    from gsv_tts_tpu_torch.runtime.vocoder_batch import VocoderBatcher, _Item

    b = VocoderBatcher(_StubFacade(1), max_batch=2, window_s=0.01)
    b._closed = True  # stop the worker first, so that the item stays queued
    b._q.put(None)
    b._thread.join(timeout=10.0)
    assert not b._thread.is_alive()
    it = _Item(None, np.zeros(3, np.int64), np.zeros(2, np.int64), None, 0.0, None, 0, 5)
    b._q.put(it)
    b.close()
    assert it.event.is_set() and isinstance(it.error, RuntimeError)
    with pytest.raises(RuntimeError, match="closed"):
        b.decode_stream(None, [1], [1], None, 0.0, None, 0, 5)


def test_lone_stream_skips_the_window():
    """With one open client the worker takes no collect window: a chunk
    returns well within the window, and ``windowless`` counts it; with two
    it waits the window out for company."""
    from gsv_tts_tpu_torch.runtime.vocoder_batch import VocoderBatcher

    for clients, quick in ((1, True), (2, False)):
        stub = _StubFacade(clients)
        stub.release.set()
        b = VocoderBatcher(stub, max_batch=4, window_s=1.0)
        try:
            t0 = time.perf_counter()
            assert b.decode_stream(object(), [1, 2], [3], None, 0.0, None, 0, 5) == "solo"
            took = time.perf_counter() - t0
        finally:
            b.close()
        assert (took < 0.5) == quick, (clients, took)
        assert b.stats["windowless"] == (1 if quick else 0) and b.stats["solo_rows"] == 1


def test_async_wrappers_warmup_and_unload(assets):
    """``stream_shared_async`` and ``infer_batched_stream_async`` relay what
    their generators give (and an error); ``warmup(stream=True)`` runs one
    shared stream; ``unload_gpt_model`` closes the model's scheduler, whose
    open handles then fail."""
    from gsv_tts_tpu_torch import TTS

    tts = TTS(gpt_cache=GPT_CACHE, models_dir=str(assets["root"]), device="cpu", seed=0)
    tts.load_gpt_model(assets["gpt"])
    tts.load_sovits_model(assets["sovits"])
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT)
    kw = dict(top_k=1, noise_scale=0.0, stream_chunk=30, is_cut_text=False)

    async def drive():
        shared = [c async for c in tts.stream_shared_async(*args, TEXTS[0], debug=False, **kw)]
        batched = [e async for e in tts.infer_batched_stream_async(*args, TEXTS[:2], **kw)]
        with pytest.raises(ZeroDivisionError):
            async for _ in tts.infer_batched_stream_async(*args, TEXTS[:1], speed=0, **kw):
                pass
        return shared, batched

    shared, batched = asyncio.run(asyncio.wait_for(drive(), timeout=120.0))
    solo = list(tts.stream_shared(*args, TEXTS[0], debug=False, **kw))
    np.testing.assert_array_equal(np.concatenate([c.audio_data for c in shared]),
                                  np.concatenate([c.audio_data for c in solo]))
    assert sorted({i for i, _, d in batched if d}) == [0, 1]
    stats = tts.warmup(text="a warm up.", stream=True)
    assert stats["stream_s"] > 0 and stats["total_s"] >= stats["infer_s"] + stats["stream_s"]

    sched = tts._get_wave_scheduler(assets["gpt"])
    handle = sched.attach(np.arange(1, 9), np.arange(1, 6), np.zeros((8, 1024), np.float32),
                          top_k=1)
    tts.unload_gpt_model(assets["gpt"])
    assert tts.wave_stats() == {} and not sched._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        while not handle.get(timeout=10.0)[1]:
            pass
    with pytest.raises(RuntimeError, match="closed"):
        sched.attach(np.arange(1, 9), np.arange(1, 6), np.zeros((8, 1024), np.float32))


def test_admission_cap(assets):
    """``wave_max_clients``: ``admit_shared_client`` claims a slot before a
    stream starts and refuses past the cap; ``stream_shared(admitted=True)``
    does not claim again; releasing admits the next."""
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.runtime.wave import WaveOverloadedError

    tts = TTS(gpt_cache=GPT_CACHE, models_dir=str(assets["root"]), device="cpu", seed=0,
              wave_max_clients=1)
    tts.load_gpt_model(assets["gpt"])
    tts.load_sovits_model(assets["sovits"])
    try:
        assert not tts.shared_stream_overloaded()
        release = tts.admit_shared_client()
        assert tts.shared_stream_overloaded()
        with pytest.raises(WaveOverloadedError):
            tts.admit_shared_client()
        with pytest.raises(WaveOverloadedError):
            next(tts.stream_shared(assets["spk"], assets["prompt"], PROMPT_TEXT, TEXTS[0]))
        clips = list(tts.stream_shared(assets["spk"], assets["prompt"], PROMPT_TEXT, TEXTS[0],
                                       admitted=True, top_k=1, debug=False))
        assert clips and tts.wave_stats()[assets["gpt"]]["clients"] == 1
        release()
        assert not tts.shared_stream_overloaded()
    finally:
        tts.unload_gpt_model(assets["gpt"])
