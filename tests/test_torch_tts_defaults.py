"""The facade's defaults against the JAX facade's.  ``TTS()`` takes JAX's
KV-cache buckets, so a default ``infer_batched`` of four texts decodes them
as the one wave of four slots the JAX engine picks, through K2 (its twin on
the CPU).  (Decoding itself is held against JAX's at other buckets in
``test_torch_tts_batched.py``; the tiny random checkpoints sample no EOS, so
a default facade decodes to its 1024-row bucket's edge, which only the
port's run pays here.)

``TTS()`` also takes JAX's SoVITS defaults (``sovits_cache=[50, 55]``,
``stream_vocoder="bucketed"``): ``infer``, ``infer_stream`` and
``infer_batched`` at both packages' defaults give JAX's audio and
subtitles, ``speed`` != 1 included.  The port is fed the JAX engine's
tokens (``top_k=1``, ``noise_scale=0``), so what is compared is everything
after the t2s stage.  Tolerance: audio rtol=2e-4, atol=2e-5 (float32 on
both sides, summation order only); subtitle words and text indices equal,
times within one latent frame."""
import inspect

import numpy as np
import pytest
import torch

from test_torch_assets import build_assets, text_modules_as_installed  # noqa: F401
from test_torch_assets import one_torch_thread  # noqa: F401

PROMPT_TEXT = "hello there."
TEXTS = ["this is a test.", "good day!", "one more line.", "and the last."]
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


def test_default_gpt_cache_is_the_jax_facades():
    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    def default(cls):
        return [tuple(b) for b in inspect.signature(cls.__init__).parameters["gpt_cache"].default]

    assert default(TTS) == default(JaxTTS)
    assert max(b for b, _ in default(TTS)) >= len(TEXTS)


def test_default_infer_batched_of_four_is_one_wave_as_in_jax(assets):
    """Four texts on default facades: the port's engine has JAX's buckets,
    and decodes the four as the wave JAX's engine picks for them (its
    smallest bucket with B >= 4: one wave of four, no refill), through the
    batched whole-step kernel's path (``k2_steps``)."""
    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    jtts = JaxTTS(sovits_cache=[], models_dir=str(assets["root"]), dtype="float32",
                  stream_vocoder="exact")
    jtts.load_gpt_model(assets["gpt"])
    jeng = jtts.gpt_models[assets["gpt"]].engine
    jax_wave = next(b for b in sorted(jeng.buckets) if b >= len(TEXTS))
    ptts = TTS(models_dir=str(assets["root"]), device="cpu", seed=0)
    ptts.load_gpt_model(assets["gpt"])
    ptts.load_sovits_model(assets["sovits"])
    peng = ptts.gpt_models[assets["gpt"]].engine
    assert peng.buckets == jeng.buckets
    waves, alloc = [], peng._alloc_cache

    def alloc_cache(B, S):
        waves.append(B)
        return alloc(B, S)

    peng._alloc_cache = alloc_cache
    clips = ptts.infer_batched(assets["spk"], assets["prompt"], PROMPT_TEXT, TEXTS, top_k=1,
                               noise_scale=0.0)
    st = ptts.last_timings
    assert len(clips) == len(TEXTS) and st["requests"] == len(TEXTS)
    assert waves[0] == jax_wave == len(TEXTS) and peng.refills == 0
    assert st["k2_steps"] > 0 and st["generic_steps"] == 0
    for clip in clips:
        assert np.all(np.isfinite(clip.audio_data)) and clip.audio_data.size > 6400


def signature_default(cls, name):
    return inspect.signature(cls.__init__).parameters[name].default


def test_default_sovits_options_are_the_jax_facades(assets):
    """``sovits_cache=[50, 55]`` (sorted as JAX sorts it) and
    ``stream_vocoder="bucketed"``, in the signature and on a facade."""
    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    assert list(signature_default(TTS, "sovits_cache")) == signature_default(
        JaxTTS, "sovits_cache") == [50, 55]
    assert signature_default(TTS, "stream_vocoder") == signature_default(
        JaxTTS, "stream_vocoder") == "bucketed"
    ptts = TTS(models_dir=str(assets["root"]), device="cpu")
    assert ptts.tts_config.sovits_cache == [50, 55] and ptts.stream_vocoder == "bucketed"
    assert TTS(sovits_cache=[55, 50], models_dir=str(assets["root"]),
               device="cpu").tts_config.sovits_cache == [50, 55]
    with pytest.raises(ValueError, match="stream_vocoder"):
        TTS(models_dir=str(assets["root"]), device="cpu", stream_vocoder="eager")


def same_subtitles(got, want, frame_s):
    """Words and text indices equal, times within one latent frame (an open
    end, ``None``, on both sides)."""
    assert [s["text"] for s in got] == [s["text"] for s in want]
    assert ([(s["orig_idx_start"], s["orig_idx_end"]) for s in got]
            == [(s["orig_idx_start"], s["orig_idx_end"]) for s in want])
    for g, w in zip(got, want):
        assert abs(g["start_s"] - w["start_s"]) <= frame_s, (g, w)
        assert (g["end_s"] is None) == (w["end_s"] is None), (g, w)
        if w["end_s"] is not None:
            assert abs(g["end_s"] - w["end_s"]) <= frame_s, (g, w)


def same_clip(got, want, frame_s):
    assert got.audio_data.shape == np.asarray(want.audio_data).shape
    np.testing.assert_allclose(got.audio_data, np.asarray(want.audio_data), rtol=RTOL,
                               atol=ATOL)
    assert got.audio_len_s == pytest.approx(want.audio_len_s)
    same_subtitles(got.subtitles, want.subtitles, frame_s)


def feed_jax_tokens(jeng, peng) -> list:
    """The port's engine ``peng`` returns what the JAX engine ``jeng``
    returned for the same call (``generate``, streamed or not, and
    ``generate_batched``); returns the list of JAX results not yet replayed."""
    harvest = []

    def record(name, wrap):
        orig = getattr(jeng, name)

        def call(*a, **kw):
            out = wrap(orig(*a, **kw), kw)
            harvest.append(out)
            return out if not kw.get("stream_chunk") else iter(out)

        setattr(jeng, name, call)

    record("generate", lambda out, kw: [(np.asarray(p).copy(), f) for p, f in out]
           if kw.get("stream_chunk") else np.asarray(out).copy())
    record("generate_batched", lambda out, kw: ([np.asarray(p).copy() for p in out[0]],
                                                np.asarray(out[1]).copy()))

    def replay(*a, **kw):
        out = harvest.pop(0)
        if isinstance(out, tuple):
            return [p.astype(np.int64) for p in out[0]], out[1]
        if kw.get("stream_chunk"):
            return iter([(p.astype(np.int64), f) for p, f in out])
        return out.astype(np.int64)

    peng.generate = peng.generate_batched = replay
    return harvest


@pytest.fixture(scope="module")
def default_pair(assets):
    """Both facades at their SoVITS defaults, on small KV-cache buckets; the
    port's engine returns what the JAX engine returned for the same call."""
    import jax

    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    cache = [(1, 128), (2, 128)]
    jtts = JaxTTS(gpt_cache=cache, models_dir=str(assets["root"]), dtype="float32")
    ptts = TTS(gpt_cache=cache, models_dir=str(assets["root"]), device="cpu", seed=0)
    for tts in (jtts, ptts):
        tts.load_gpt_model(assets["gpt"])
        tts.load_sovits_model(assets["sovits"])
    jtts._rng = jax.random.PRNGKey(0)
    harvest = feed_jax_tokens(jtts.gpt_models[assets["gpt"]].engine,
                              ptts.gpt_models[assets["gpt"]].engine)
    return jtts, ptts, harvest


@pytest.mark.parametrize("speed", [1.0, 1.25])
def test_default_infer_matches_jax(assets, default_pair, speed):
    """``infer(return_subtitles=True)``: at speed 1 the padded core and the
    bucketed flow, at 1.25 the exact core resampled, then the flow bucket;
    the same audio and subtitles as JAX's default facade."""
    jtts, ptts, harvest = default_pair
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT, "this is a test.")
    kw = dict(top_k=1, noise_scale=0.0, return_subtitles=True, speed=speed)
    jclip = jtts.infer(*args, **kw)
    pclip = ptts.infer(*args, **kw)
    assert not harvest and pclip.subtitles and pclip.audio_data.size > 6400
    same_clip(pclip, jclip, 0.02 / speed)
    st = ptts.last_timings
    assert st["sovits_graphs"] == st["sovits_replays"] == 0  # the CPU runs eagerly


@pytest.mark.parametrize("speed", [1.0, 1.25])
def test_default_infer_stream_matches_jax(assets, default_pair, speed):
    """``infer_stream(return_subtitles=True)`` over two segments: every chunk
    of the bucketed vocoder (one fused call a chunk, the cross-fade's offset
    a device tensor; at speed 1.25 the exact core, then the flow bucket) and
    its subtitles equal JAX's."""
    jtts, ptts, harvest = default_pair
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT,
            "this is a test of the stream. it has two parts.")
    kw = dict(top_k=1, noise_scale=0.0, return_subtitles=True, stream_chunk=15, cut_minlen=5,
              speed=speed)
    jclips = list(jtts.infer_stream(*args, debug=False, **kw))
    pclips = list(ptts.infer_stream(*args, **kw))
    assert not harvest and len(pclips) == len(jclips) >= 4
    for i, (pc, jc) in enumerate(zip(pclips, jclips)):
        assert pc.audio_data.dtype == np.float32, i
        same_clip(pc, jc, 0.02 / speed)
    assert sum(len(c.subtitles) for c in pclips) > 0
    assert ptts.last_timings["sovits_s"] > 0 and torch.is_grad_enabled()


def test_default_infer_batched_subtitles_match_jax(assets, default_pair):
    """``infer_batched(return_subtitles=True)``: the packed decode (exact
    core, the flow padded to the ladder), each segment cut out by its
    subtitles, clips and subtitles as JAX's."""
    jtts, ptts, harvest = default_pair
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT, TEXTS[:3])
    kw = dict(top_k=1, noise_scale=0.0, return_subtitles=True)
    jclips = jtts.infer_batched(*args, **kw)
    pclips = ptts.infer_batched(*args, **kw)
    assert not harvest and len(pclips) == len(jclips) == 3
    assert sum(len(c.subtitles) for c in pclips) >= 3
    for pc, jc in zip(pclips, jclips):
        same_clip(pc, jc, 0.02)


def test_warmup_runs_one_default_infer(assets):
    """``warmup()`` synthesises once from synthetic sine references on the
    default SoVITS path; ``stream=True`` also runs one ``stream_shared``."""
    from gsv_tts_tpu_torch import TTS

    ptts = TTS(gpt_cache=[(1, 128)], models_dir=str(assets["root"]), device="cpu", seed=0)
    ptts.load_gpt_model(assets["gpt"])
    ptts.load_sovits_model(assets["sovits"])
    stats = ptts.warmup(text="a warm up.")
    assert stats["total_s"] >= stats["infer_s"] > 0
    assert ptts.last_timings["tokens"] > 0 and ptts.last_timings["sovits_s"] > 0
    stats = ptts.warmup(text="a warm up.", stream=True)
    assert stats["total_s"] >= stats["infer_s"] + stats["stream_s"] > stats["stream_s"] > 0
    assert ptts.wave_stats()[str(assets["gpt"])]["totals"]["tokens"] > 0
