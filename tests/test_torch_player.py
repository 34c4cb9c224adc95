"""Playback and the clip container of the port (``player.py``) against the JAX
package's: ``AudioQueue`` over a stand-in ``sounddevice`` (no audio device is
opened) and without one, ``AudioClip.play`` and ``save`` to a non-WAV path
through a stand-in ``soundfile``, the facade's ``audio_queue`` on every clip
it returns, and the package's four exports."""
import sys
import threading
import types

import numpy as np
import pytest

from test_torch_assets import build_assets, text_modules_as_installed  # noqa: F401
from test_torch_assets import one_torch_thread  # noqa: F401

PROMPT_TEXT = "hello there."


class FakeStream:
    """``sounddevice.OutputStream`` stand-in: records its settings, writes and
    restarts; a write waits on ``gate`` so a test can hold playback."""

    made = []

    def __init__(self, **kw):
        self.kw = kw
        self.written, self.starts, self.stops = [], 0, 0
        self.gate = threading.Event()
        self.gate.set()
        FakeStream.made.append(self)

    def start(self):
        self.starts += 1

    def stop(self):
        self.stops += 1

    def write(self, data):
        assert self.gate.wait(10)
        self.written.append(np.array(data))


@pytest.fixture
def fake_sounddevice(monkeypatch):
    FakeStream.made = []
    monkeypatch.setitem(sys.modules, "sounddevice", types.SimpleNamespace(OutputStream=FakeStream))
    return FakeStream


@pytest.fixture
def no_sounddevice(monkeypatch):
    monkeypatch.setitem(sys.modules, "sounddevice", None)  # the import raises ImportError


def joined(q):
    if q.t is not None:
        q.t.join(timeout=10)
        assert not q.t.is_alive()


def test_audio_queue_writes_chunks_in_order(fake_sounddevice):
    from gsv_tts_tpu_torch.player import AudioQueue

    q = AudioQueue(32000)
    (stream,) = fake_sounddevice.made
    assert stream.kw == {"samplerate": 32000, "channels": 1, "dtype": "float32"}
    assert stream.starts == 1
    chunks = [np.full(n, i, np.float32) for i, n in enumerate((100, 7, 3000))]
    stream.gate.clear()  # hold the first write until all three are queued
    for c in chunks:
        q.put(c)
    assert not q.playback_finished.is_set()
    stream.gate.set()
    q.wait()
    joined(q)
    assert [w.shape for w in stream.written] == [(100, 1), (7, 1), (3000, 1)]
    for w, c in zip(stream.written, chunks):
        np.testing.assert_array_equal(w[:, 0], c)
    q.put(chunks[1].reshape(-1, 1))  # a second round starts a new thread
    q.wait()
    joined(q)
    assert len(stream.written) == 4


def test_audio_queue_stop_clears_and_wait_returns(fake_sounddevice):
    from gsv_tts_tpu_torch.player import AudioQueue

    q = AudioQueue(16000)
    (stream,) = fake_sounddevice.made
    stream.gate.clear()
    for i in range(5):
        q.put(np.full(10, i, np.float32))
    q.stop()  # the thread holds the first chunk; the other four go
    assert q.q.empty() and q.playback_finished.is_set()
    assert stream.stops == 1 and stream.starts == 2
    q.wait()  # returns at once
    stream.gate.set()
    joined(q)
    assert len(stream.written) <= 1


def test_audio_queue_without_sounddevice(no_sounddevice):
    from gsv_tts_tpu_torch.player import AudioQueue

    q = AudioQueue(32000)
    assert q.stream is None
    q.wait()  # nothing queued: returns at once
    q.put(np.zeros(50, np.float32))
    q.wait()  # the thread drains the queue without a stream
    joined(q)
    assert q.q.empty()


@pytest.mark.parametrize("volume", [1.0, 0.5, 3.0])
def test_play_scales_and_clips_as_jax(volume):
    """``play(volume)`` changes the clip's audio and queues it as JAX's does."""
    from gsv_tts_tpu.player import AudioClip as JaxClip
    from gsv_tts_tpu_torch.player import AudioClip

    audio = np.random.RandomState(0).uniform(-0.9, 0.9, 800).astype(np.float32)
    got = []
    for cls in (AudioClip, JaxClip):
        queued = []
        clip = cls(types.SimpleNamespace(put=queued.append), audio.copy(), 32000, 0.025, [],
                   "text")
        clip.play(volume)
        got.append((clip.audio_data, queued))
    (pa, pq), (ja, jq) = got
    np.testing.assert_array_equal(pa, ja)
    assert len(pq) == len(jq) == 1
    np.testing.assert_array_equal(pq[0], jq[0])
    assert np.abs(pa).max() <= 1.0
    if volume == 3.0:
        assert np.abs(pa).max() == 1.0


def test_save_non_wav_through_soundfile_as_jax(monkeypatch, tmp_path):
    """A non-WAV path goes to ``soundfile.write`` with the same arguments from
    both packages; the subtitles' JSON is written beside it alike."""
    from gsv_tts_tpu.player import AudioClip as JaxClip
    from gsv_tts_tpu_torch.player import AudioClip

    calls = []
    monkeypatch.setitem(sys.modules, "soundfile", types.SimpleNamespace(
        write=lambda path, data, sr: calls.append((path, np.array(data), sr))))
    audio = np.linspace(-0.5, 0.5, 320, dtype=np.float32)
    subs = [{"text": "hi", "start_s": 0.0, "end_s": 0.01}]
    for cls, name in ((AudioClip, "port"), (JaxClip, "jax")):
        cls(None, audio, 16000, 0.02, subs, "hi").save(str(tmp_path / f"{name}.flac"),
                                                       is_save_subtitles=True)
    (pp, pd, psr), (jp, jd, jsr) = calls
    assert (pp, psr) == (str(tmp_path / "port.flac"), 16000)
    assert (jp, jsr) == (str(tmp_path / "jax.flac"), 16000)
    np.testing.assert_array_equal(pd, jd)
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


def test_save_non_wav_without_soundfile_raises_import_error(monkeypatch, tmp_path):
    from gsv_tts_tpu_torch.player import AudioClip

    monkeypatch.setitem(sys.modules, "soundfile", None)
    with pytest.raises(ImportError):
        AudioClip(None, np.zeros(10, np.float32), 32000, 0.0, [], "").save(str(tmp_path / "a.ogg"))
    clip = AudioClip(None, np.zeros(10, np.float32), 32000, 0.0, [], "")
    clip.save(str(tmp_path / "a.WAV"))  # WAV needs no module
    assert (tmp_path / "a.WAV").stat().st_size > 44


def test_package_exports():
    import gsv_tts_tpu
    import gsv_tts_tpu_torch
    from gsv_tts_tpu_torch import AudioClip, TTS, WaveOverloadedError, cut_text
    from gsv_tts_tpu_torch.frontend.text_processor import cut_text as port_cut
    from gsv_tts_tpu_torch.player import AudioClip as port_clip
    from gsv_tts_tpu_torch.runtime.wave import WaveOverloadedError as port_err
    from gsv_tts_tpu_torch.tts import TTS as port_tts

    assert gsv_tts_tpu_torch.__all__ == gsv_tts_tpu.__all__
    assert gsv_tts_tpu_torch.__version__ == gsv_tts_tpu.__version__
    assert (AudioClip, TTS, WaveOverloadedError, cut_text) == (port_clip, port_tts, port_err,
                                                              port_cut)
    text = "First sentence here. And a second, longer one follows it!"
    assert cut_text(text, 10) == gsv_tts_tpu.cut_text(text, 10)
    with pytest.raises(AttributeError):
        gsv_tts_tpu_torch.NotAName  # noqa: B018


@pytest.fixture(scope="module")
def tts(tmp_path_factory):
    from gsv_tts_tpu_torch import TTS

    saved = sys.modules.get("sounddevice", "absent")
    sys.modules["sounddevice"] = None  # no audio device is ever opened
    try:
        assets = build_assets(tmp_path_factory.mktemp("models"))
        t = TTS(gpt_cache=[(1, 128), (2, 128)], sovits_cache=[], models_dir=str(assets["root"]),
                device="cpu", seed=0, stream_vocoder="exact")
    finally:
        if saved == "absent":
            del sys.modules["sounddevice"]
        else:
            sys.modules["sounddevice"] = saved
    t.load_gpt_model(assets["gpt"])
    t.load_sovits_model(assets["sovits"])
    return t, assets


def test_every_clip_carries_the_facades_queue(tts):
    from gsv_tts_tpu_torch.player import AudioClip, AudioQueue

    t, assets = tts
    assert isinstance(t.audio_queue, AudioQueue) and t.audio_queue.samplerate == 32000
    assert t.audio_queue.stream is None
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT)
    kw = dict(top_k=1, noise_scale=0.0)
    clips = [t.infer(*args, "one short line.", **kw)]
    clips += list(t.infer_stream(*args, "a streamed line of text.", stream_chunk=10, **kw))
    clips += t.infer_batched(*args, ["first text.", "the second text."], **kw)
    assert len(clips) >= 4
    for c in clips:
        assert isinstance(c, AudioClip) and c.audio_queue is t.audio_queue
    clips[0].play(0.5)
    t.audio_queue.wait()
    joined(t.audio_queue)
