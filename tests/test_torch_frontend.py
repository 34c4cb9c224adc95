"""The port's English frontend: ``gsv_tts_tpu_torch.frontend`` keeps its own
copies of the JAX package's host code (nothing is loaded from
``gsv_tts_tpu/``) and must give the same phones, ``word2ph`` and normalized
text as the JAX package's own ``get_phones_and_bert``."""
import types
from pathlib import Path

import pytest

SENTENCES = [
    "Hello there, this is a test.",
    "The 3 quick brown foxes jumped over 12 lazy dogs!",
    "Dr. Smith read the book... yesterday; she'll read it again tomorrow.",
    "It costs $4.50, or about 20% more than last year?",
    "GPT-SoVITS speaks English: one, two, three.",
]


@pytest.mark.parametrize("text", SENTENCES)
def test_english_phones_match_jax(text):
    from gsv_tts_tpu.frontend.text_processor import get_phones_and_bert as jax_fe
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.frontend.text_processor import get_phones_and_bert as port_fe

    jp, jw, jb, jn = jax_fe(text, types.SimpleNamespace(models_dir=None, cnroberta=None))
    pp, pw, pb, pn = port_fe(text, Config(device="cpu"))
    assert pp == jp and pw == jw and pn == jn
    assert pb.shape == jb.shape == (len(pp), 1024) and not pb.any()


def test_frontend_modules_load_under_the_port_package():
    """Every frontend module is a file of the port's own package, and each
    copied module is the JAX package's source byte for byte (so the two
    frontends cannot drift apart unnoticed)."""
    import importlib
    import os

    from gsv_tts_tpu_torch import frontend
    from gsv_tts_tpu_torch.frontend import symbols, text_processor

    port_dir = os.path.dirname(os.path.abspath(frontend.__file__))
    jax_dir = os.path.join(os.path.dirname(os.path.dirname(port_dir)), "gsv_tts_tpu", "frontend")
    assert list(frontend.__path__) == [port_dir]
    for name in ("lang_segment", "pause", "text_processor", "g2p.english", "g2p.en_norm",
                 "g2p.en_oov", "g2p.en_pos", "g2p.chinese", "g2p.zh_norm", "g2p.tone_sandhi",
                 "g2p.japanese"):
        mod = importlib.import_module("gsv_tts_tpu_torch.frontend." + name)
        rel = name.replace(".", os.sep) + ".py"
        assert os.path.abspath(mod.__file__) == os.path.join(port_dir, rel)
        with open(mod.__file__, "rb") as a, open(os.path.join(jax_dir, rel), "rb") as b:
            assert a.read() == b.read(), name
    assert text_processor.text_to_phonemes.__module__ == "gsv_tts_tpu_torch.frontend.g2p"
    assert os.path.abspath(symbols.SYMBOLS_JSON) == os.path.join(
        os.path.dirname(port_dir), "assets", "symbols.json")
    from gsv_tts_tpu_torch.frontend.g2p import tone_sandhi

    assert tone_sandhi._ASSET == Path(port_dir).parent / "assets" / "zh_sandhi.json"
    for asset in ("symbols.json", "zh_sandhi.json"):
        with open(os.path.join(os.path.dirname(port_dir), "assets", asset), "rb") as a, \
                open(os.path.join(os.path.dirname(jax_dir), "assets", asset), "rb") as b:
            assert a.read() == b.read(), asset


def test_port_symbols_equal_jax_symbols():
    from gsv_tts_tpu.frontend import symbols as js
    from gsv_tts_tpu_torch.frontend import symbols as ps

    assert ps.symbols == js.symbols and ps.punctuation == js.punctuation
    assert len(ps.symbols) == 732


@pytest.mark.parametrize("text,error,item", [
    # without a pinyin backend (no pypinyin, no lexicon) the Chinese G2P raises
    # its own error naming the lexicon, as the JAX package's does
    pytest.param("你好，世界。", KeyError, "provide a lexicon", id="你好，世界。-zh BERT"),
    # without pyopenjtalk the Japanese G2P reads kana (JAX's phones) and raises
    # JAX's error on kanji
    pytest.param("こんにちは。", RuntimeError, "requires pyopenjtalk", id="こんにちは。-ja")])
def test_chinese_and_japanese_raise_with_the_roadmap_item(text, error, item, monkeypatch):
    import sys

    from gsv_tts_tpu.config import global_config as jax_global
    from gsv_tts_tpu.frontend.text_processor import get_phones_and_bert as jax_fe
    from gsv_tts_tpu_torch.config import Config, global_config
    from gsv_tts_tpu_torch.frontend.text_processor import get_phones_and_bert

    monkeypatch.setitem(sys.modules, "pypinyin", None)
    monkeypatch.setitem(sys.modules, "pyopenjtalk", None)
    for cfg in (global_config, jax_global):
        monkeypatch.setattr(cfg, "chinese_g2p", None)
        monkeypatch.setattr(cfg, "japanese_g2p", None)
        monkeypatch.setattr(cfg, "models_dir", None)
        monkeypatch.setattr(cfg, "_g2p_auto", {})
    if error is RuntimeError:
        pp, pw, _, pn = get_phones_and_bert(text, Config(device="cpu"))
        jp, jw, _, jn = jax_fe(text, types.SimpleNamespace(models_dir=None, cnroberta=None))
        assert pp and (pp, pw, pn) == (jp, jw, jn)
        text = "今日は" + text  # kanji
    with pytest.raises(error, match=item):
        get_phones_and_bert(text, Config(device="cpu"))
