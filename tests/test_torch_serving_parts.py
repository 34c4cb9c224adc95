"""The serving layer's parts: ``fx`` against JAX's numpy path, the modules
copied byte for byte (``batcher``, ``router``), the router shedding and
failing over in front of two port servers, the fleet's card pinning, the
realtime module without ``aiortc``, ``/health``'s keys, and the app builders
without ``aiohttp``.  The servers run one tiny port facade on the CPU."""
import asyncio
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("aiohttp")

from aiohttp.test_utils import TestClient, TestServer

from test_torch_assets import build_assets, text_modules_as_installed  # noqa: F401
from test_torch_assets import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
PROMPT_TEXT = "hello there."
TEXT = "this is a test."


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


@pytest.fixture(scope="module")
def ptts(assets):
    from gsv_tts_tpu_torch import TTS

    tts = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
              device="cpu", seed=0, stream_vocoder="exact")
    tts.load_gpt_model(assets["gpt"])
    tts.load_sovits_model(assets["sovits"])
    yield tts
    for sched in tts._wave_schedulers.values():
        sched.close()
    if tts._vocoder_batcher is not None:
        tts._vocoder_batcher.close()


def v2_query(assets, **kw):
    return {"text": TEXT, "ref_audio_path": assets["prompt"], "prompt_text": PROMPT_TEXT,
            "top_k": "1", "noise_scale": "0", "media_type": "wav", **kw}


# -- fx ------------------------------------------------------------------------------

def fx_stages(fx, jfx):
    """Every stage of both enhance chains and both whole chains on seeded
    speech-like audio at 32 kHz and on a short clip at 16 kHz, sample for
    sample."""
    rng = np.random.RandomState(7)
    for sr, seconds in ((32000, 1.5), (16000, 0.3)):
        t = np.arange(int(sr * seconds)) / sr
        x = (0.4 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
             + 0.05 * rng.randn(t.size)).astype(np.float32)
        for name, args in (("highpass", (x, sr)), ("peak_filter", (x, sr, 300.0, 2.5, 1.0)),
                           ("compressor", (x, sr)), ("reverb", (x, sr)), ("gain", (x, 2.0)),
                           ("loudness_normalize", (x, sr)), ("enhance_audio", (x, sr))):
            got, want = getattr(fx, name)(*args), getattr(jfx, name)(*args)
            assert got.dtype == want.dtype == np.float32, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        assert fx.integrated_loudness(x, sr) == jfx.integrated_loudness(x, sr)
    assert np.abs(fx.enhance_audio(x, 16000)).max() > 0


def test_fx_matches_jax_numpy_path(monkeypatch):
    """Each stage of the enhance chain and the whole chain equal JAX's numpy
    path sample for sample: both packages' native libraries patched out."""
    import gsv_tts_tpu.utils.native as jnative
    from gsv_tts_tpu import fx as jfx
    from gsv_tts_tpu_torch import fx
    from gsv_tts_tpu_torch.utils import native as pnative

    monkeypatch.setattr(jnative, "native_lib", lambda: None)
    monkeypatch.setattr(pnative, "native_lib", lambda: None)
    fx_stages(fx, jfx)


def test_fx_matches_jax_native_path(monkeypatch):
    """The same stages through both packages' native libraries (the
    envelope follower and the Freeverb wet path in C++) equal each other
    sample for sample, and the port's library ran."""
    import gsv_tts_tpu.utils.native as jnative
    from gsv_tts_tpu import fx as jfx
    from gsv_tts_tpu_torch import fx
    from gsv_tts_tpu_torch.utils import native as pnative

    monkeypatch.delenv("GSV_DISABLE_NATIVE", raising=False)
    if jnative.native_lib() is None or pnative.native_lib() is None:
        pytest.skip("no C++ compiler: neither native library is built")
    before = dict(pnative.native_lib().calls)
    fx_stages(fx, jfx)
    after = pnative.native_lib().calls
    assert after["envelope_follow"] > before["envelope_follow"]
    assert after["freeverb"] > before["freeverb"]


# -- the verbatim copies ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["batcher.py", "router.py"])
def test_copied_modules_are_byte_equal(name):
    """``MicroBatcher`` and the router import nothing of the package: the
    port's files are the JAX package's, byte for byte."""
    assert (REPO / "gsv_tts_tpu_torch" / "serving" / name).read_bytes() == \
        (REPO / "gsv_tts_tpu" / "serving" / name).read_bytes()


# -- the router in front of port servers -------------------------------------------------

async def _servers(*apps):
    servers = [TestServer(a) for a in apps]
    for s in servers:
        await s.start_server()
    return servers


def test_router_fails_over_a_shedding_port_server(assets, ptts):
    """Two port servers on one facade behind the router: while one drains
    (its synthesis routes answer 503), every request lands on the other;
    when both drain, the router relays the 503 with its ``Retry-After`` and
    keeps both healthy; a backend that refuses connections is marked
    unhealthy and its requests fail over."""
    from gsv_tts_tpu_torch.serving.router import create_router_app
    from gsv_tts_tpu_torch.serving.server import create_app

    async def go():
        a, b = create_app(ptts), create_app(ptts)
        sa, sb = await _servers(a, b)
        urls = [str(sa.make_url("")).rstrip("/"), str(sb.make_url("")).rstrip("/")]
        dead = "http://127.0.0.1:9"  # nothing listens on the discard port
        client = TestClient(TestServer(create_router_app(urls + [dead], health_interval=3600,
                                                         max_retries=3)))
        await client.start_server()
        try:
            a["server"].draining = True
            landed = []
            for _ in range(3):
                r = await client.get("/tts", params=v2_query(assets))
                body = await r.read()
                assert r.status == 200 and body[:4] == b"RIFF"
                landed.append(r.headers["X-GSV-Backend"])
            assert set(landed) == {urls[1]}
            b["server"].draining = True
            r = await client.get("/tts", params=v2_query(assets))
            shed = (r.status, r.headers.get("Retry-After"), (await r.json())["error"])
            health = await (await client.get("/health")).json()
            return shed, {h["url"]: h["healthy"] for h in health["backends"]}
        finally:
            await client.close()
            await sa.close()
            await sb.close()

    shed, healthy = asyncio.run(go())
    assert shed == (503, "5", "server draining")
    assert list(healthy.values()) == [True, True, False]


def test_router_sheds_while_a_port_stream_holds_the_slot(assets, ptts, monkeypatch):
    """``max_outstanding=1``: while a ``/tts/stream`` of the one port server
    is in flight, a second request gets the router's 503 + ``Retry-After:
    1``; the held stream ends with its ``done``."""
    from gsv_tts_tpu_torch.serving.router import create_router_app
    from gsv_tts_tpu_torch.serving.server import create_app

    release = threading.Event()
    clip = types.SimpleNamespace(audio_data=np.zeros(320, np.float32), samplerate=32000,
                                 audio_len_s=0.01, subtitles=None, orig_text=TEXT)

    def held_stream(*a, **kw):
        yield clip
        release.wait(30)
        yield clip

    monkeypatch.setattr(ptts, "infer_stream", held_stream)

    async def go():
        (s,) = await _servers(create_app(ptts))
        client = TestClient(TestServer(create_router_app([str(s.make_url(""))],
                                                         health_interval=3600,
                                                         max_outstanding=1)))
        await client.start_server()
        try:
            held = await client.post("/tts/stream", json={
                "text": TEXT, "speaker_audio": assets["spk"], "prompt_audio": assets["prompt"],
                "prompt_text": PROMPT_TEXT})
            first = await held.content.readuntil(b"\n\n")
            r = await client.post("/tts/stream", json={"text": "x"})
            shed = (r.status, r.headers.get("Retry-After"))
            release.set()
            rest = await held.text()
            return first, shed, rest
        finally:
            release.set()
            await client.close()
            await s.close()

    first, shed, rest = asyncio.run(go())
    assert first.startswith(b"event: audio")
    assert shed == (503, "1")
    assert rest.rstrip().split("\n\n")[-1].startswith("event: done")


def test_a_client_leaving_mid_stream_stops_the_worker(assets, ptts, monkeypatch):
    """A client that disconnects after the first SSE event: the adapter
    closes the stream, the facade's worker stops at its next chunk and
    ``_infer_lock`` is free again; nothing more is synthesized."""
    from gsv_tts_tpu_torch.serving.server import create_app

    progress = {"yielded": 0, "closed": False}
    clip = types.SimpleNamespace(audio_data=np.zeros(1600, np.float32), samplerate=32000,
                                 audio_len_s=0.05, subtitles=None, orig_text=TEXT)

    def slow_stream(*a, **kw):
        try:
            for _ in range(1000):
                progress["yielded"] += 1
                yield clip
                time.sleep(0.02)
        finally:
            progress["closed"] = True

    monkeypatch.setattr(ptts, "infer_stream", slow_stream)

    async def go():
        client = TestClient(TestServer(create_app(ptts)))
        await client.start_server()
        try:
            r = await client.post("/tts/stream", json={
                "text": TEXT, "speaker_audio": assets["spk"], "prompt_audio": assets["prompt"],
                "prompt_text": PROMPT_TEXT})
            assert (await r.content.readuntil(b"\n\n")).startswith(b"event: audio")
            r.close()  # the client goes away
            for _ in range(200):
                if progress["closed"]:
                    break
                await asyncio.sleep(0.05)
        finally:
            await client.close()

    asyncio.run(go())
    assert progress["closed"] and progress["yielded"] < 1000
    assert ptts._infer_lock.acquire(timeout=10)
    ptts._infer_lock.release()


# -- the fleet ---------------------------------------------------------------------------

def test_fleet_pins_each_replica_to_its_card(monkeypatch):
    """``chip_env="on"``: each replica sees only its card
    (``CUDA_VISIBLE_DEVICES``, the i-th of a given list) and takes
    ``--device 0``; ``"off"``: ``--device i`` and the environment as it
    is; ``"auto"`` isolates exactly when CUDA is available.  The command is
    the port's server."""
    import torch

    import gsv_tts_tpu_torch.serving.fleet as fleet_mod
    from gsv_tts_tpu_torch.serving.fleet import FleetSupervisor

    captured = []

    class FakeProc:
        pid = 4242

        def poll(self):
            return None

    def fake_popen(cmd, env=None):
        captured.append((list(cmd), dict(env)))
        return FakeProc()

    monkeypatch.setattr(fleet_mod.subprocess, "Popen", fake_popen)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    FleetSupervisor([0, 2], ports_base=46000, chip_env="on").spawn_all()
    for (cmd, env), dev in zip(captured, (0, 2)):
        assert cmd[1:3] == ["-m", "gsv_tts_tpu_torch.serving.server"]
        assert env["CUDA_VISIBLE_DEVICES"] == str(dev)
        assert cmd[cmd.index("--device") + 1] == "0"
        assert cmd[cmd.index("--port") + 1] == str(46000 + (0, 2).index(dev))
    captured.clear()
    FleetSupervisor([1], chip_env="on", env={"CUDA_VISIBLE_DEVICES": "5,7"}).spawn_all()
    assert captured[0][1]["CUDA_VISIBLE_DEVICES"] == "7"
    captured.clear()
    FleetSupervisor([0, 2], ports_base=46010, chip_env="off",
                    server_args=["--models-dir", "m"]).spawn_all()
    for (cmd, env), dev in zip(captured, (0, 2)):
        assert "CUDA_VISIBLE_DEVICES" not in env
        assert cmd[cmd.index("--device") + 1] == str(dev) and cmd[-2:] == ["--models-dir", "m"]
    for avail in (False, True):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: avail)
        assert FleetSupervisor([0], chip_env="auto")._chip_env_active() is avail


# -- realtime ----------------------------------------------------------------------------

class _Frame:
    @staticmethod
    def from_ndarray(arr, format=None, layout=None):
        return types.SimpleNamespace(array=np.asarray(arr), format=format, layout=layout)


@pytest.fixture()
def aiortc_stubs(monkeypatch):
    """Stand-in ``aiortc`` and ``av`` modules (neither is installed)."""
    aiortc = types.ModuleType("aiortc")
    media = types.ModuleType("aiortc.mediastreams")
    media.MediaStreamTrack = type("MediaStreamTrack", (), {"__init__": lambda self: None})
    media.AudioFrame = _Frame
    aiortc.RTCPeerConnection = aiortc.RTCSessionDescription = object
    aiortc.mediastreams = media
    av = types.ModuleType("av")
    av.AudioFrame = _Frame
    for name, mod in (("aiortc", aiortc), ("aiortc.mediastreams", media), ("av", av)):
        monkeypatch.setitem(sys.modules, name, mod)


def test_realtime_without_aiortc_raises_a_clear_error(monkeypatch):
    """Neither host has ``aiortc``: the module imports, and building the app
    or a track raises ``ImportError`` naming it."""
    from gsv_tts_tpu_torch.serving import realtime

    monkeypatch.setitem(sys.modules, "aiortc", None)
    with pytest.raises(ImportError, match="aiortc"):
        realtime.create_realtime_app(object())
    with pytest.raises(ImportError, match="aiortc"):
        realtime.make_audio_track()


def test_realtime_frames_match_jax(aiortc_stubs):
    """The track's frame arithmetic (resample 32 → 48 kHz, s16, 960-sample
    frames, pts, an underflow padded with silence) gives JAX's frames."""
    from gsv_tts_tpu.serving import realtime as jrt
    from gsv_tts_tpu_torch.serving import realtime as prt

    sr = 32000
    t = np.arange(int(0.05 * sr)) / sr
    clip = types.SimpleNamespace(audio_data=(0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32),
                                 samplerate=sr)

    async def frames(mod):
        track = mod.make_audio_track()
        await track.put_audio(clip)
        return [await track.recv() for _ in range(4)]

    got, want = asyncio.run(frames(prt)), asyncio.run(frames(jrt))
    assert [f.pts for f in got] == [f.pts for f in want] == [0, 960, 1920, 2880]
    for g, w in zip(got, want):
        assert g.sample_rate == w.sample_rate == 48000 and g.format == "s16"
        np.testing.assert_array_equal(g.array, w.array)
    assert np.abs(got[0].array).max() > 1000 and np.abs(got[3].array).max() == 0


# -- /health, asr, the builders without aiohttp -----------------------------------------

def test_health_carries_what_the_soak_tool_reads(assets, ptts):
    """``/health`` has every key ``tools/soak.py`` samples (``backend_compiles``,
    ``live_arrays``, ``inflight``) as integers, ``device`` names the CPU,
    ``warmed`` follows ``TTS.warmup``, and two identical requests leave
    ``backend_compiles`` where the first left it."""
    import re

    from gsv_tts_tpu_torch.serving.server import create_app

    soak = (REPO / "tools" / "soak.py").read_text()
    read = {"backend_compiles", "live_arrays", "inflight"}
    assert read <= set(re.findall(r'h\.get\("(\w+)"\)', soak))

    async def go():
        client = TestClient(TestServer(create_app(ptts)))
        await client.start_server()
        try:
            seen = []
            for _ in range(2):
                r = await client.get("/tts", params=v2_query(assets))
                assert r.status == 200 and (await r.read())[:4] == b"RIFF"
                seen.append(await (await client.get("/health")).json())
            return seen
        finally:
            await client.close()

    seen = asyncio.run(go())
    for h in seen:
        assert read <= set(h)
        assert all(isinstance(h[k], int) for k in read)
        assert h["device"] == "cpu" and h["warmed"] is bool(ptts._warmed)
    assert seen[0]["backend_compiles"] == seen[1]["backend_compiles"]


def test_asr_hook_fills_a_missing_prompt_text(assets, ptts, monkeypatch):
    """Without ``prompt_text`` and without a hook: JAX's 400; with a
    registered hook, its transcript is the prompt text."""
    from gsv_tts_tpu_torch.serving import asr
    from gsv_tts_tpu_torch.serving.server import create_app

    monkeypatch.setattr(asr, "_CUSTOM", None)
    assert asr.make_asr_fn() is None
    heard = []

    def transcribe(path):
        heard.append(path)
        return PROMPT_TEXT

    async def go(app):
        client = TestClient(TestServer(app))
        await client.start_server()
        try:
            q = v2_query(assets)
            del q["prompt_text"]
            r = await client.get("/tts", params=q)
            return r.status, await r.read()
        finally:
            await client.close()

    status, body = asyncio.run(go(create_app(ptts, asr_fn=asr.make_asr_fn())))
    assert status == 400 and body == b"prompt_text is required (no ASR backend configured)"
    asr.register_asr(transcribe)
    status, body = asyncio.run(go(create_app(ptts, asr_fn=asr.make_asr_fn())))
    assert status == 200 and body[:4] == b"RIFF" and heard == [assets["prompt"]]


def test_a_stream_never_started_still_releases_its_slot():
    """A streamed reply's release runs when it is closed, started or not,
    and once."""
    from gsv_tts_tpu_torch.serving.server import Stream

    released = []

    async def body():
        yield b"x"

    async def go():
        s = Stream(body(), lambda: released.append(1))
        await s.aclose()
        await s.aclose()
        t = Stream(body(), lambda: released.append(2))
        assert [c async for c in t] == [b"x"]
        await t.aclose()

    asyncio.run(go())
    assert released == [1, 2]


def test_builders_refuse_to_run_without_aiohttp(ptts, monkeypatch):
    """With ``aiohttp`` unimportable the route methods still import, and
    every app builder and ``main`` raises JAX's ``ImportError``: there is
    no fallback."""
    from gsv_tts_tpu_torch.serving import realtime, server, webui

    monkeypatch.setitem(sys.modules, "aiohttp", None)
    monkeypatch.setitem(sys.modules, "aiohttp.web", None)
    for build in (lambda: server.create_app(ptts), lambda: webui.create_webui_app(ptts),
                  lambda: server.main(["--device", "cpu"]), lambda: webui.main([])):
        with pytest.raises(ImportError, match="requires `aiohttp`"):
            build()
    with pytest.raises(ImportError, match="requires `aiohttp`"):
        realtime.create_realtime_app(ptts)


def test_main_without_device_needs_a_card(tmp_path, monkeypatch):
    """``main()`` without ``--device`` takes the card and raises on a host
    without one; ``--device cpu`` is the CPU's counterpart of JAX's
    ``JAX_PLATFORMS=cpu``."""
    import torch

    from gsv_tts_tpu_torch.serving import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        server.main(["--models-dir", str(tmp_path)])
    assert server.engine_device("cpu") == "cpu" and server.engine_device(None) is None


def test_reloading_a_model_drops_what_holds_the_old_weights(assets, ptts):
    """``set_*_weights`` on the loaded path reloads it: the GPT model's
    shared-wave scheduler (which holds the old engine) is closed, so the
    next shared stream decodes with the new weights, and the SoVITS
    model's CUDA graphs (which hold the old parameters) are evicted."""
    gpt, sov = assets["gpt"], assets["sovits"]
    old_engine = ptts.gpt_models[gpt].engine
    sched = ptts._get_wave_scheduler(gpt)
    old_params = ptts.sovits_models[sov].params
    # a stand-in entry where a capture on the card would have stored the graph
    ptts.sovits_graphs.graphs[("core", id(old_params), 1, 32)] = (None, [], (), old_params)
    ptts.load_gpt_model(gpt)
    ptts.load_sovits_model(sov)
    assert gpt not in ptts._wave_schedulers and sched._closed
    assert ptts.gpt_models[gpt].engine is not old_engine
    assert ptts._get_wave_scheduler(gpt).engine is ptts.gpt_models[gpt].engine
    assert not any(k[1] == id(old_params) for k in ptts.sovits_graphs.graphs)
