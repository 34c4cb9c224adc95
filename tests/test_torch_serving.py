"""The serving layer as a whole: JAX's aiohttp app (``gsv_tts_tpu.serving.
server.create_app`` and ``webui.create_webui_app``) and the port's, each over
its own facade on the same tiny ``save_trained_*`` checkpoints and wavs,
given the same requests through ``aiohttp.test_utils.TestClient``.

Compared: status, ``Content-Type``, ``Retry-After``, SSE event names in
order, JSON fields, and the audio.  Both facades run float32 on the
exact-shape SoVITS path (``sovits_cache=[]``, ``stream_vocoder="exact"``,
``gpt_cache=[(1, 128)]``) with ``top_k=1, noise_scale=0``.  Tolerance of
float32 audio: rtol 2e-4, atol 2e-5 (summation order only); of audio packed
as 16-bit PCM (wav, raw, OpenAI pcm deltas): the same plus one step of
1/32767, since the packing truncates and two floats that close can fall on
either side of a step.  Files the routes write go to each facade's own
temporary directory."""
import asyncio
import base64
import io
import json
import os
import pickle
import wave

import numpy as np
import pytest

pytest.importorskip("aiohttp")

from aiohttp.test_utils import TestClient, TestServer

from test_torch_assets import build_assets, text_modules_as_installed  # noqa: F401
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
PCM_ATOL = ATOL + 1 / 32767
PROMPT_TEXT = "hello there."
TEXT = "this is a test."
GREEDY = {"top_k": 1, "noise_scale": 0}


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


@pytest.fixture(scope="module")
def pair(assets):
    """The JAX facade and the port's, configured alike."""
    import jax

    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    jtts = JaxTTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
                  dtype="float32", stream_vocoder="exact")
    jtts.load_gpt_model(assets["gpt"])
    jtts.load_sovits_model(assets["sovits"])
    jtts._rng = jax.random.PRNGKey(0)
    ptts = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
               device="cpu", seed=0, stream_vocoder="exact")
    ptts.load_gpt_model(assets["gpt"])
    ptts.load_sovits_model(assets["sovits"])
    yield jtts, ptts
    for t in (jtts, ptts):
        for sched in t._wave_schedulers.values():
            sched.close()
        if t._vocoder_batcher is not None:
            t._vocoder_batcher.close()


def both(pair, drive, make="server", **app_kw):
    """``drive(client)`` against JAX's app, then against the port's; returns
    (JAX's result, the port's)."""
    import gsv_tts_tpu.serving.server as jserver
    import gsv_tts_tpu.serving.webui as jwebui
    import gsv_tts_tpu_torch.serving.server as pserver
    import gsv_tts_tpu_torch.serving.webui as pwebui

    makers = {"server": (jserver.create_app, pserver.create_app),
              "webui": (jwebui.create_webui_app, pwebui.create_webui_app)}[make]

    async def go(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            return await drive(client)
        finally:
            await client.close()

    out = []
    for create, tts in zip(makers, pair):
        kw = {k: (v(tts) if callable(v) else v) for k, v in app_kw.items()}
        out.append(asyncio.run(go(create(tts, **kw))))
    return tuple(out)


def head(r):
    return r.status, r.headers.get("Content-Type"), r.headers.get("Retry-After")


def close(got, want, pcm=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=PCM_ATOL if pcm else ATOL)


def wav_samples(body: bytes) -> np.ndarray:
    assert body[:4] == b"RIFF"
    with wave.open(io.BytesIO(body)) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 32000)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2") / 32767.0


def pcm_samples(body: bytes) -> np.ndarray:
    return np.frombuffer(body, "<i2") / 32767.0


def sse(body: str):
    """[(event name or None, data)] of an SSE body."""
    out = []
    for block in body.split("\n\n"):
        if not block.strip():
            continue
        lines = block.split("\n")
        name = lines[0][7:] if lines[0].startswith("event: ") else None
        out.append((name, json.loads(next(x[6:] for x in lines if x.startswith("data: ")))))
    return out


def f32(ev) -> np.ndarray:
    return np.frombuffer(base64.b64decode(ev["audio"]), np.float32)


def v2_query(assets, **kw):
    return {"text": TEXT, "ref_audio_path": assets["prompt"], "prompt_text": PROMPT_TEXT,
            "top_k": "1", "noise_scale": "0", **kw}


def stream_body(assets, **kw):
    return {"text": TEXT, "speaker_audio": assets["spk"], "prompt_audio": assets["prompt"],
            "prompt_text": PROMPT_TEXT, **GREEDY, **kw}


# -- api_v2 ------------------------------------------------------------------------

def test_api_v2_wav_raw_get_and_post_match_jax(assets, pair):
    """GET wav, POST raw, GET with ``aux_ref_audio_paths`` repeated in the
    query (a two-speaker blend): the same heads and the same samples."""
    async def drive(client):
        out = []
        r = await client.get("/tts", params=v2_query(assets, media_type="wav"))
        out.append((head(r), wav_samples(await r.read())))
        r = await client.post("/tts", json={**v2_query(assets), "top_k": 1, "noise_scale": 0,
                                            "media_type": "raw"})
        out.append((head(r), pcm_samples(await r.read())))
        q = list(v2_query(assets, media_type="wav").items())
        q += [("aux_ref_audio_paths", assets["spk"]), ("aux_ref_audio_paths", assets["prompt"])]
        r = await client.get("/tts", params=q)
        out.append((head(r), wav_samples(await r.read())))
        return out

    jout, pout = both(pair, drive)
    for (jh, ja), (ph, pa) in zip(jout, pout):
        assert ph == jh and ph[0] == 200
        close(pa, ja, pcm=True)
    assert pout[0][0][1] == "audio/wav" and pout[1][0][1] == "audio/raw"


def test_get_query_with_repeated_keys_matches_jax(assets, pair):
    """A GET query that repeats a key is read as JAX's handlers read it
    (``dict`` of the query: the first value).  ``/tts`` with ``text`` and
    ``media_type`` given twice (the second ``media_type`` one the route
    refuses) answers as the same query with their first values: the same
    head in both apps, each app's body byte for byte its own single-valued
    answer, the samples within the file's tolerance of JAX's; a repeated
    ``weights_path`` reloads from its first value."""
    async def drive(client):
        out = []
        single = v2_query(assets, media_type="wav")
        r = await client.get("/tts", params=single)
        out.append((head(r), await r.read()))
        q = list(single.items()) + [("text", "something else entirely."),
                                     ("media_type", "mp9")]
        r = await client.get("/tts", params=q)
        out.append((head(r), await r.read()))
        r = await client.get("/set_gpt_weights", params=[("weights_path", assets["gpt"]),
                                                         ("weights_path", "/no/such.ckpt")])
        out.append((head(r), (await r.json())["message"]))
        return out

    jout, pout = both(pair, drive)
    for out in (jout, pout):
        assert out[0][0] == out[1][0] == (200, "audio/wav", None)
        assert out[1][1] == out[0][1]
    close(wav_samples(pout[1][1]), wav_samples(jout[1][1]), pcm=True)
    assert pout[2] == jout[2] and pout[2][0][0] == 200


def test_get_query_repeated_aux_refs_reach_both_handlers_as_one_list(assets, pair,
                                                                     monkeypatch):
    """``aux_ref_audio_paths`` given twice in a GET query reaches JAX's
    ``_handle_api_v2`` and the port's ``tts_v2`` as the same list (and the
    other keys as the same strings); given once, as the same string."""
    from aiohttp import web

    import gsv_tts_tpu.serving.server as jserver
    import gsv_tts_tpu_torch.serving.server as pserver

    seen = {"jax": [], "port": []}

    async def jax_seen(self, req):
        seen["jax"].append(req)
        raise web.HTTPBadRequest(text="seen")

    async def port_seen(self, req):
        seen["port"].append(req)
        raise pserver.HTTPError(400, "seen")

    monkeypatch.setattr(jserver.TTSServer, "_handle_api_v2", jax_seen)
    monkeypatch.setattr(pserver.TTSServer, "tts_v2", port_seen)

    async def drive(client):
        base = list(v2_query(assets, media_type="wav").items())
        statuses = []
        for aux in ([assets["spk"], assets["prompt"]], [assets["spk"]]):
            r = await client.get("/tts", params=base + [("aux_ref_audio_paths", p) for p in aux])
            statuses.append(r.status)
        return statuses

    jout, pout = both(pair, drive)
    assert jout == pout == [400, 400]
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 2
    assert seen["port"][0]["aux_ref_audio_paths"] == [assets["spk"], assets["prompt"]]
    assert seen["port"][1]["aux_ref_audio_paths"] == assets["spk"]
    assert seen["port"][0]["text"] == TEXT


def test_api_v2_streaming_mode_and_batch_infer_match_jax(assets, pair):
    """``streaming_mode=1``: a wav header chunk, then raw frames (the whole
    body parses as one wav); ``batch_infer``: the batched call's clips
    merged.  Heads and samples equal JAX's."""
    async def drive(client):
        r = await client.get("/tts", params=v2_query(assets, media_type="wav",
                                                     streaming_mode="1"))
        body = await r.read()
        header = body[:44]
        s = (head(r), header[:4], pcm_samples(body[44:]))
        r = await client.get("/tts", params=v2_query(assets, media_type="wav",
                                                     batch_infer="true",
                                                     text="this is a test. good day to you!"))
        return s, (head(r), wav_samples(await r.read()))

    (js, jb), (ps, pb) = both(pair, drive)
    assert ps[0] == js[0] and ps[0][0] == 200 and ps[1] == js[1] == b"RIFF"
    close(ps[2], js[2], pcm=True)
    assert pb[0] == jb[0] and pb[0][0] == 200
    close(pb[1], jb[1], pcm=True)


@pytest.mark.parametrize("case", ["no ref", "no text", "mp9", "ogg", "aac", "batch+stream",
                                  "bad json", "non-object"])
def test_api_v2_client_errors_match_jax(assets, pair, case):
    """The 400 and 415 answers: status, type and body equal (ogg and aac
    need the optional ``soundfile`` encoder, absent here: 415 and the list
    of what is supported)."""
    params = {"no ref": {"text": "x"},
              "no text": {"ref_audio_path": assets["prompt"], "prompt_text": PROMPT_TEXT},
              "mp9": v2_query(assets, media_type="mp9"),
              "ogg": v2_query(assets, media_type="ogg"),
              "aac": v2_query(assets, media_type="aac"),
              "batch+stream": v2_query(assets, batch_infer="1", streaming_mode="1")}

    async def drive(client):
        if case == "bad json":
            r = await client.post("/tts", data=b"{not json",
                                  headers={"Content-Type": "application/json"})
        elif case == "non-object":
            r = await client.post("/tts", json=["a", "list"])
        else:
            r = await client.get("/tts", params=params[case])
        return head(r), await r.text()

    (jh, jbody), (ph, pbody) = both(pair, drive)
    assert ph == jh and ph[0] in (400, 415)
    assert pbody == jbody


# -- /tts/stream ---------------------------------------------------------------------

def test_sse_stream_not_shared_and_its_error_event_match_jax(assets, pair):
    """Not shared: ``event: audio`` × N then one ``event: done``, the same
    chunks and total duration; ``"speed": 0`` gives one ``event: error`` and
    no ``done``; a malformed number and a missing field are 400s before
    any SSE byte."""
    async def drive(client):
        out = []
        for body in (stream_body(assets), stream_body(assets, speed=0)):
            r = await client.post("/tts/stream", json=body)
            out.append((head(r), sse(await r.text())))
        r = await client.post("/tts/stream", json=stream_body(assets, top_k="lots"))
        out.append((head(r), await r.json()))
        r = await client.post("/tts/stream", json={"text": "hi"})
        out.append((head(r), await r.json()))
        return out

    jout, pout = both(pair, drive)
    (jh, jev), (ph, pev) = jout[0], pout[0]
    assert ph == jh and "text/event-stream" in ph[1]
    assert [n for n, _ in pev] == [n for n, _ in jev]
    assert pev[-1][0] == "done" and len(pev) > 2
    for (_, p), (_, j) in zip(pev[:-1], jev[:-1]):
        close(f32(p), f32(j))
        assert p["sample_rate"] == j["sample_rate"] == 32000 and p["text"] == j["text"]
    assert pev[-1][1]["total_duration"] == pytest.approx(jev[-1][1]["total_duration"])
    (jh, jev), (ph, pev) = jout[1], pout[1]
    assert ph == jh and [n for n, _ in pev] == [n for n, _ in jev] == ["error"]
    assert pout[2] == jout[2] and pout[2][0][0] == 400
    assert pout[3] == jout[3] and pout[3][0][0] == 400


def test_sse_stream_shared_and_its_admission_match_jax(assets, pair):
    """Shared (the wave): a lone client's events and audio equal JAX's;
    with the cap at 0 a shared client gets 503 + ``Retry-After: 1`` and
    JAX's body; with the cap at 1 a client arriving while one streams gets
    the 503 before any SSE byte, and one arriving after it ends streams."""
    def set_cap(tts, n):
        gpt, _ = tts._default_models(None, None)
        tts.wave_max_clients = n
        tts._get_wave_scheduler(gpt).max_clients = n
        return tts._get_wave_scheduler(gpt)

    async def drive(client):
        out = []
        r = await client.post("/tts/stream", json=stream_body(assets, shared=True))
        out.append((head(r), sse(await r.text())))
        tts = client.app["server"].tts
        sched = set_cap(tts, 0)
        try:
            r = await client.post("/tts/stream", json=stream_body(assets, shared=True))
            out.append((head(r), await r.json()))
            set_cap(tts, 1)
            first = asyncio.ensure_future(client.post(
                "/tts/stream", json=stream_body(assets, shared=True)))
            for _ in range(600):
                if sched.stats["clients"] >= 1:
                    break
                await asyncio.sleep(0.05)
            assert sched.stats["clients"] == 1, "the first client was never admitted"
            r = await client.post("/tts/stream", json=stream_body(assets, shared=True))
            out.append((head(r), await r.text()))
            r1 = await first
            out.append((head(r1), [n for n, _ in sse(await r1.text())][-1]))
            r = await client.post("/tts/stream", json=stream_body(assets, shared=True))
            out.append((head(r), [n for n, _ in sse(await r.text())][-1]))
            out.append(sched.stats["clients"])
        finally:
            set_cap(tts, None)
        return out

    jout, pout = both(pair, drive)
    (jh, jev), (ph, pev) = jout[0], pout[0]
    assert ph == jh and ph[0] == 200
    assert [n for n, _ in pev] == [n for n, _ in jev] and pev[-1][0] == "done"
    for (_, p), (_, j) in zip(pev[:-1], jev[:-1]):
        close(f32(p), f32(j))
    assert pout[1] == jout[1] and pout[1][0] == (503, "application/json; charset=utf-8", "1")
    assert "capacity" in pout[1][1]["error"]
    assert pout[2][0] == jout[2][0] == (503, "application/json; charset=utf-8", "1")
    assert "capacity" in pout[2][1] and "event:" not in pout[2][1]
    assert pout[3:] == jout[3:]
    assert pout[3][1] == pout[4][1] == "done" and pout[5] == 0


def test_sse_stream_batched_matches_jax(assets, pair):
    """``/tts/stream/batched``: the same (index, done) sequence, each
    request's audio equal, one final ``done``."""
    texts = [TEXT, "good day to you!"]

    async def drive(client):
        r = await client.post("/tts/stream/batched", json={
            "texts": texts, "speaker_audio": assets["spk"], "prompt_audio": assets["prompt"],
            "prompt_text": PROMPT_TEXT, **GREEDY})
        return head(r), sse(await r.text())

    (jh, jev), (ph, pev) = both(pair, drive)
    assert ph == jh and ph[0] == 200
    assert [(n, d.get("index"), d.get("done")) for n, d in pev] == \
        [(n, d.get("index"), d.get("done")) for n, d in jev]
    assert pev[-1] == ("done", {}) and sum(d.get("done", False) for _, d in pev) == 2
    for i in range(len(texts)):
        close(np.concatenate([f32(d) for n, d in pev if n == "audio" and d["index"] == i]),
              np.concatenate([f32(d) for n, d in jev if n == "audio" and d["index"] == i]))


# -- /tts/batched, /audio, /drain, weights, /health, / ------------------------------

def test_tts_batched_and_audio_files_match_jax(assets, pair):
    """``/tts/batched`` answers JAX's fields, each ``audio_url`` serves a
    wav of JAX's samples, and a missing file is JAX's 404."""
    async def drive(client):
        r = await client.post("/tts/batched", json={
            "texts": [TEXT, "good day to you!"], "speaker_audio": assets["spk"],
            "prompt_audio": assets["prompt"], "prompt_text": PROMPT_TEXT, **GREEDY})
        data = await r.json()
        files = []
        for res in data["results"]:
            f = await client.get(res["audio_url"])
            files.append((head(f), wav_samples(await f.read())))
        missing = await client.get("/audio/missing.wav")
        return head(r), data["results"], files, (head(missing), await missing.text())

    (jh, jres, jfiles, jmiss), (ph, pres, pfiles, pmiss) = both(pair, drive)
    assert ph == jh and ph[0] == 200
    assert [sorted(x) for x in pres] == [sorted(x) for x in jres]
    assert [x["text"] for x in pres] == [x["text"] for x in jres]
    assert [x["duration"] for x in pres] == pytest.approx([x["duration"] for x in jres])
    for (fph, pa), (fjh, ja) in zip(pfiles, jfiles):
        assert fph == fjh == (200, "audio/x-wav", None)
        close(pa, ja, pcm=True)
    assert pmiss == jmiss and pmiss[0][0] == 404


def test_drain_health_metrics_and_root_match_jax(assets, pair):
    """``/drain`` sheds every synthesis route with JAX's 503 + ``Retry-After:
    5`` and reopens; ``/health`` carries JAX's keys (``device``,
    ``backend_compiles`` and ``live_arrays`` mean the card's counterparts
    in the port); ``/metrics`` is Prometheus text with the same gauges;
    ``/`` is JAX's."""
    async def drive(client):
        out = {}
        r = await client.post("/drain")
        out["drain"] = (head(r), await r.json())
        r = await client.post("/tts/stream", json=stream_body(assets))
        out["shed"] = (head(r), await r.json())
        r = await client.get("/tts", params=v2_query(assets))
        out["shed_v2"] = head(r)
        out["health"] = await (await client.get("/health")).json()
        r = await client.post("/drain", json={"enable": False})
        out["undrain"] = (head(r), await r.json())
        r = await client.get("/metrics")
        out["metrics"] = (head(r), await r.text())
        r = await client.get("/")
        out["root"] = (head(r), await r.json())
        return out

    j, p = both(pair, drive)
    for key in ("drain", "shed", "shed_v2", "undrain", "root"):
        assert p[key] == j[key], key
    assert p["shed"][0] == (503, "application/json; charset=utf-8", "5")
    assert set(p["health"]) == set(j["health"]) and p["health"]["draining"] is True
    assert p["health"]["device"] == "cpu" and p["health"]["live_arrays"] == 0
    assert isinstance(p["health"]["backend_compiles"], int)
    assert p["metrics"][0] == j["metrics"][0] == (200, "text/plain; charset=utf-8", None)
    names = [{ln.split(" ")[0] for ln in m[1].splitlines() if ln.startswith("gsv_")}
             for m in (p["metrics"], j["metrics"])]
    assert {"gsv_up", "gsv_backend_compiles", "gsv_live_arrays"} <= names[0] & names[1]


def test_weight_switches_and_the_evil_pickle_match_jax(assets, pair, tmp_path):
    """Reloading the loaded checkpoints succeeds; a missing file and a
    pickle that would run code answer JAX's 400 (the code never runs), and
    the server keeps serving."""
    marker = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    evil = tmp_path / "evil.ckpt"
    with open(evil, "wb") as f:
        pickle.dump({"config": {}, "weight": Evil()}, f)

    async def drive(client):
        out = []
        for route, path in (("/set_gpt_weights", assets["gpt"]),
                            ("/set_sovits_weights", assets["sovits"]),
                            ("/set_gpt_weights", "/no/such.ckpt"),
                            ("/set_gpt_weights", str(evil)),
                            ("/set_sovits_weights", str(evil))):
            r = await client.get(route, params={"weights_path": path})
            out.append((head(r), (await r.json())["message"].split(":")[0]))
        r = await client.get("/set_gpt_weights")
        out.append((head(r), await r.text()))
        r = await client.get("/tts", params=v2_query(assets, media_type="wav"))
        out.append((head(r), wav_samples(await r.read()).size > 0))
        return out

    jout, pout = both(pair, drive)
    assert pout == jout
    assert [x[0][0] for x in pout] == [200, 200, 400, 400, 400, 400, 200]
    assert not marker.exists()


# -- micro-batching ------------------------------------------------------------------

def test_micro_batcher_coalesces_like_jax(assets, pair):
    """``batch_window_ms``: four concurrent api_v2 requests coalesce into
    one ``infer_batched`` call, each answer equal to JAX's; a lone request
    takes the single ``infer`` (equal to JAX's too)."""
    texts = [TEXT, "good day to you!", "one more line.", "hello again."]

    async def drive(client):
        rs = await asyncio.gather(*[client.get("/tts", params=v2_query(
            assets, media_type="wav", text=t)) for t in texts])
        many = [(head(r), wav_samples(await r.read())) for r in rs]
        stats = dict(client.app["server"].batcher.stats)
        r = await client.get("/tts", params=v2_query(assets, media_type="wav"))
        lone = (head(r), wav_samples(await r.read()))
        health = await (await client.get("/health")).json()
        return many, stats, lone, health["batcher"]

    (jm, js, jl, jh), (pm, ps, pl, ph) = both(pair, drive, batch_window_ms=200.0)
    assert ps == js and ps["calls"] == 1 and ps["requests"] == 4
    assert ph == jh and ph["calls"] == 2
    for (phd, pa), (jhd, ja) in zip(pm + [pl], jm + [jl]):
        assert phd == jhd and phd[0] == 200
        close(pa, ja, pcm=True)


# -- OpenAI ------------------------------------------------------------------------

def test_openai_routes_match_jax(assets, pair, tmp_path):
    """``/v1/audio/speech`` as wav and as SSE (pcm deltas, one
    ``speech.audio.done``), the error envelope of an unknown voice, a bad
    speed, mp3 and a malformed body, ``/v1/models`` and ``/v1/audio/voices``."""
    reg = tmp_path / "voices.json"
    reg.write_text(json.dumps({"alloy": {"speaker_audio": assets["spk"],
                                         "prompt_audio": assets["prompt"],
                                         "prompt_text": PROMPT_TEXT}}))
    from gsv_tts_tpu.serving.openai_compat import load_voices

    voices = load_voices(str(reg))

    async def drive(client):
        out = {}
        r = await client.post("/v1/audio/speech", json={"input": TEXT, "voice": "alloy",
                                                        **GREEDY})
        out["wav"] = (head(r), wav_samples(await r.read()))
        r = await client.post("/v1/audio/speech", json={"input": TEXT, "voice": "alloy",
                                                        "stream_format": "sse", **GREEDY})
        out["sse"] = (head(r), sse(await r.text()))
        for name, body in (("voice", {"input": "x", "voice": "nope"}),
                           ("speed", {"input": "x", "voice": "alloy", "speed": 9}),
                           ("mp3", {"input": "x", "voice": "alloy", "response_format": "mp3"}),
                           ("input", {"voice": "alloy"})):
            r = await client.post("/v1/audio/speech", json=body)
            out[name] = (head(r), await r.json())
        r = await client.post("/v1/audio/speech", data=b"{nope")
        out["json"] = (head(r), await r.json())
        models = await (await client.get("/v1/models")).json()
        out["models"] = [(m["id"], m["object"], m["owned_by"]) for m in models["data"]]
        out["voices"] = await (await client.get("/v1/audio/voices")).json()
        return out

    j, p = both(pair, drive, voices=voices)
    assert p["wav"][0] == j["wav"][0] == (200, "audio/wav", None)
    close(p["wav"][1], j["wav"][1], pcm=True)
    assert p["sse"][0] == j["sse"][0]
    types = [d["type"] for _, d in p["sse"][1]]
    assert types == [d["type"] for _, d in j["sse"][1]] and types[-1] == "speech.audio.done"
    close(np.concatenate([pcm_samples(base64.b64decode(d["audio"])) for _, d in p["sse"][1][:-1]]),
          np.concatenate([pcm_samples(base64.b64decode(d["audio"])) for _, d in j["sse"][1][:-1]]),
          pcm=True)
    assert p["sse"][1][-1][1]["usage"] == pytest.approx(j["sse"][1][-1][1]["usage"])
    for key in ("voice", "speed", "mp3", "input", "json", "models", "voices"):
        assert p[key] == j[key], key
    assert p["voice"][0][0] == 400 and p["mp3"][0][0] == 415
    assert p["voice"][1]["error"]["type"] == "invalid_request_error"


# -- WebUI ---------------------------------------------------------------------------

def test_webui_page_flow_matches_jax(assets, pair, tmp_path):
    """Every ``/ui/*`` route in the page's order (load, save a preset,
    reload, a rich-text script with a preset and a break through the
    ``enhance`` chain, history, the file, a missing file, voice conversion,
    the preset's deletion): the same statuses, fields and audio."""
    async def drive(client):
        out = []
        page = await client.get("/")
        out.append((head(page), "<script>" in await page.text()))
        out.append(await (await client.get("/ui/history")).json())
        out.append(await (await client.get("/ui/presets")).json())
        r = await client.post("/ui/presets", json={
            "name": "alice", "speaker_audio": assets["spk"], "prompt_audio": assets["prompt"],
            "prompt_text": PROMPT_TEXT})
        out.append((head(r), await r.json()))
        out.append(await (await client.get("/ui/presets")).json())
        r = await client.post("/ui/synth", json={
            "text": f"{TEXT} <alice>{TEXT}</alice> <break:0.3/>",
            "speaker_audio": assets["spk"], "prompt_audio": assets["prompt"],
            "prompt_text": PROMPT_TEXT, "top_k": 1, "temperature": 1.0, "speed": 1.0,
            "noise_scale": 0, "enhance": True})
        d = await r.json()
        out.append((head(r), sorted(d), d["duration"], d["text"]))
        f = await client.get(d["audio_url"])
        synth = (head(f), wav_samples(await f.read()))
        hist = await (await client.get("/ui/history")).json()
        out.append([(sorted(e), e["duration"], e["text"]) for e in hist])
        f = await client.get(f"/ui/audio/{hist[0]['file']}")
        out.append(head(f))
        r = await client.get("/ui/audio/missing.wav")
        out.append((head(r), await r.text()))
        r = await client.post("/ui/vc", json={
            "speaker_audio": assets["spk"], "prompt_audio": assets["prompt"],
            "prompt_text": PROMPT_TEXT, "noise_scale": 0})
        d = await r.json()
        f = await client.get(d["audio_url"])
        vc = (head(f), wav_samples(await f.read()))
        out.append((head(r), sorted(d), round(d["duration"], 6)))
        r = await client.post("/ui/presets", json={"name": "alice", "delete": True})
        out.append(await r.json())
        models = await (await client.get("/ui/models")).json()
        out.append((models["gpt_loaded"], models["sovits_loaded"]))
        return out, synth, vc

    (jout, jsynth, jvc), (pout, psynth, pvc) = both(
        pair, drive, make="webui", workdir=lambda t: tmp_path / type(t).__module__)
    assert pout == jout
    assert pout[0][0] == (200, "text/html; charset=utf-8", None) and pout[0][1]
    assert pout[5][0][0] == 200 and pout[5][2] > 0.3
    for (ph, pa), (jh, ja) in ((psynth, jsynth), (pvc, jvc)):
        assert ph == jh == (200, "audio/x-wav", None)
        close(pa, ja, pcm=True)
