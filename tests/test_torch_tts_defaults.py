"""The facade's defaults against the JAX facade's.  ``TTS()`` takes JAX's
KV-cache buckets, so a default ``infer_batched`` of four texts decodes them
as the one wave of four slots the JAX engine picks, through K2 (its twin on
the CPU).  (Decoding itself is held against JAX's at other buckets in
``test_torch_tts_batched.py``; the tiny random checkpoints sample no EOS, so
a default facade decodes to its 1024-row bucket's edge, which only the
port's run pays here.)"""
import inspect

import numpy as np
import pytest

from test_torch_assets import build_assets, text_modules_as_installed  # noqa: F401
from test_torch_tts_batched import one_torch_thread  # noqa: F401

PROMPT_TEXT = "hello there."
TEXTS = ["this is a test.", "good day!", "one more line.", "and the last."]


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
