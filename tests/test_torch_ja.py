"""Japanese text on the port: ``frontend/g2p/japanese.py`` is the JAX
package's file byte for byte (``test_torch_frontend.py``), behind the port's
dispatcher.  Without ``pyopenjtalk`` (neither machine has it) kana take the
built-in converter and kanji raise JAX's ``RuntimeError``.  Phones and
``word2ph`` must equal JAX's ``text_to_phonemes``; ``TTS.infer`` of kana text
must give the JAX facade's audio (float32, ``top_k=1``, ``noise_scale=0``;
rtol 2e-4, atol 2e-5: summation order only)."""
import sys

import numpy as np
import pytest

from test_torch_assets import build_assets, text_modules_as_installed  # noqa: F401
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
PROMPT_TEXT = "hello there."

KANA = [
    "こんにちは。",                # hiragana, ん
    "カタカナです！",              # katakana
    "きょうは、しゃしんをとりゃ？",  # yōon after k / sh, and a vowel-less one (りゃ)
    "ちょっと、まって。",          # っ, ちょ
    "ラーメン、コーヒー…",          # ー after a vowel and after ん, the ellipsis
    "ぎゅうにゅう、ぴょん。",        # voiced and p- yōon
    "ゔぁいおりん、をを。",          # ゔ, small ぁ, を
]


@pytest.fixture(autouse=True)
def no_openjtalk(monkeypatch):
    """Both packages' Japanese G2P built afresh, with ``pyopenjtalk``
    unimportable (the built-in kana converter)."""
    from gsv_tts_tpu.config import global_config as jax_global
    from gsv_tts_tpu_torch.config import global_config

    monkeypatch.setitem(sys.modules, "pyopenjtalk", None)
    for cfg in (global_config, jax_global):
        monkeypatch.setattr(cfg, "japanese_g2p", None)
        monkeypatch.setattr(cfg, "_g2p_auto", {})


@pytest.mark.parametrize("text", KANA)
def test_kana_phones_match_jax(text):
    from gsv_tts_tpu.frontend.g2p import text_to_phonemes as jax_t2p
    from gsv_tts_tpu_torch.frontend.g2p import text_to_phonemes as port_t2p

    got = port_t2p(text, "ja")
    want = jax_t2p(text, "ja")
    assert got[0] and got == want
    assert len(got[0]) == sum(got[1]["ph"])


@pytest.mark.parametrize("text", ["今日は晴れ。", "カタカナと漢字。"])
def test_kanji_raise_jax_error(text):
    from gsv_tts_tpu.frontend.g2p import text_to_phonemes as jax_t2p
    from gsv_tts_tpu_torch.frontend.g2p import text_to_phonemes as port_t2p

    with pytest.raises(RuntimeError, match="requires pyopenjtalk") as port_err:
        port_t2p(text, "ja")
    with pytest.raises(RuntimeError) as jax_err:
        jax_t2p(text, "ja")
    assert str(port_err.value) == str(jax_err.value)


def test_dispatcher_builds_one_engine_per_models_dir(tmp_path):
    from gsv_tts_tpu_torch.config import global_config
    from gsv_tts_tpu_torch.frontend.g2p import _get_g2p
    from gsv_tts_tpu_torch.frontend.g2p.japanese import JapaneseG2P

    a = _get_g2p("ja", tmp_path / "a")
    assert isinstance(a, JapaneseG2P) and global_config.japanese_g2p is a
    assert _get_g2p("ja", tmp_path / "a") is a and _get_g2p("ja", tmp_path / "b") is not a
    injected = JapaneseG2P()
    global_config.japanese_g2p = injected  # an engine installed on purpose wins
    assert _get_g2p("ja", tmp_path / "c") is injected


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


@pytest.mark.parametrize("text", ["こんにちは、せかい。", "カタカナ、ちょっとまって。"])
def test_infer_on_kana_matches_jax(assets, text):
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
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT, text)
    jclip = jtts.infer(*args, top_k=1, noise_scale=0.0, return_subtitles=True)
    pclip = ptts.infer(*args, top_k=1, noise_scale=0.0, return_subtitles=True)
    assert pclip.audio_data.shape == np.asarray(jclip.audio_data).shape
    assert pclip.audio_data.size > 6400
    np.testing.assert_allclose(pclip.audio_data, np.asarray(jclip.audio_data), rtol=RTOL,
                               atol=ATOL)
    assert [s["text"] for s in pclip.subtitles] == [s["text"] for s in jclip.subtitles]
    for ps, js in zip(pclip.subtitles, jclip.subtitles):
        assert ps["start_s"] == pytest.approx(js["start_s"], abs=1e-6)
        assert ps["end_s"] == pytest.approx(js["end_s"], abs=1e-6)
