"""Chinese text through the facade: the port's ``TTS`` with ``use_bert=True``
against the JAX package's on the same tiny checkpoints, HuBERT and BERT
directories and wavs, at ``top_k=1`` and ``noise_scale=0`` (float32 on the
CPU; both facades on the exact SoVITS path, as ``test_torch_tts.py`` runs
them).  Both packages take an injected lexicon-backed ``ChineseG2P``
(``pypinyin`` is absent here)."""
import logging
import socket

import numpy as np
import pytest

from test_torch_assets import build_assets, text_modules_as_installed  # noqa: F401
from test_torch_roberta import SMALL_BERT, write_bert_dir
from test_torch_zh_frontend import ZH_LEXICON
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
PROMPT_TEXT = "hello there."
ZH_TEXT = "你好中国人，天气真不错。"
MIXED_TEXT = "hello 你好中国人。"
#: the t2s takes 1024-wide BERT rows: a 1024-wide BERT of 2 + 2 layers
BERT_1024 = dict(SMALL_BERT, hidden_size=1024, num_hidden_layers=4)
LEXICON = dict(ZH_LEXICON, 真="zhen1", 错="cuo4", 预="yu4", 热="re4", 完="wan2", 成="cheng2")
KW = dict(top_k=1, noise_scale=0.0)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    assets = build_assets(tmp_path_factory.mktemp("models"))
    write_bert_dir(assets["root"] / "chinese-roberta-wwm-ext-large", BERT_1024, seed=8)
    return assets


@pytest.fixture(scope="module", autouse=True)
def zh_g2p_in_both():
    from gsv_tts_tpu.config import global_config as jax_global
    from gsv_tts_tpu.frontend.g2p.chinese import ChineseG2P as JaxG2P
    from gsv_tts_tpu_torch.config import global_config as port_global
    from gsv_tts_tpu_torch.frontend.g2p.chinese import ChineseG2P as PortG2P

    saved = jax_global.chinese_g2p, port_global.chinese_g2p
    jax_global.chinese_g2p = JaxG2P(lexicon=LEXICON)
    port_global.chinese_g2p = PortG2P(lexicon=LEXICON)
    try:
        yield
    finally:
        jax_global.chinese_g2p, port_global.chinese_g2p = saved


def _capture(engine, name, sink):
    """Records the BERT rows each ``generate`` / ``generate_batched`` call
    takes and the tokens it returns."""
    orig = getattr(engine, name)

    def wrapped(*args, **kw):
        out = orig(*args, **kw)
        toks = out[0] if name == "generate_batched" else out
        sink.append((args[2], toks))
        return out

    setattr(engine, name, wrapped)


def _facades(assets, **opts):
    import jax

    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    common = dict(gpt_cache=[(1, 128), (2, 128)], sovits_cache=[],
                  models_dir=str(assets["root"]), stream_vocoder="exact", **opts)
    jtts = JaxTTS(dtype="float32", **common)
    jtts._rng = jax.random.PRNGKey(0)
    ptts = TTS(device="cpu", seed=0, **common)
    for t in (jtts, ptts):
        t.load_gpt_model(assets["gpt"])
        t.load_sovits_model(assets["sovits"])
    return jtts, ptts


@pytest.fixture(scope="module")
def both(assets):
    jtts, ptts = _facades(assets, use_bert=True)
    jcalls, pcalls = [], []
    for t, sink in ((jtts, jcalls), (ptts, pcalls)):
        engine = t.gpt_models[assets["gpt"]].engine
        _capture(engine, "generate", sink)
        _capture(engine, "generate_batched", sink)
    clips = {}
    for text in (ZH_TEXT, MIXED_TEXT):
        clips[text] = (jtts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, text, **KW),
                       ptts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, text, **KW))
    return jtts, ptts, jcalls, pcalls, clips


def test_bert_rows_entering_the_t2s_match_jax(both):
    """The prefill's BERT rows: zeros for the prompt's English phones, the
    BERT features of the Chinese phones, equal to JAX's."""
    jtts, ptts, jcalls, pcalls, _ = both
    assert ptts.tts_config.cnroberta is not None and jtts.tts_config.cnroberta is not None
    n_prompt = len(ptts.prompt_audio_cache[next(iter(ptts.prompt_audio_cache))]["phones1"])
    for (jb, _), (pb, _) in zip(jcalls[:2], pcalls[:2]):
        jb, pb = np.asarray(jb), np.asarray(pb)
        assert pb.shape == jb.shape and pb.shape[1] == 1024
        np.testing.assert_allclose(pb, jb, rtol=RTOL, atol=ATOL)
        assert not pb[:n_prompt].any()
    zh_rows = np.asarray(pcalls[0][0])[n_prompt:]
    assert np.abs(zh_rows).sum(axis=1).min() > 0  # every Chinese phone has features
    mixed = np.asarray(pcalls[1][0])[n_prompt:]
    en_rows = np.abs(mixed).sum(axis=1) == 0
    assert en_rows.any() and not en_rows.all()  # "hello" zeros, the Chinese rows not


def test_tokens_match_jax_over_a_prefix(both):
    _, _, jcalls, pcalls, _ = both
    for (_, jt), (_, pt) in zip(jcalls[:2], pcalls[:2]):
        jt, pt = np.asarray(jt).ravel(), np.asarray(pt).ravel()
        n = min(len(jt), len(pt), 40)
        assert n >= 20
        np.testing.assert_array_equal(pt[:n], jt[:n])


def test_audio_matches_jax(assets, both):
    """JAX's tokens through both facades' SoVITS stage give the same audio,
    and where the two chains agree in full, so do the clips."""
    from gsv_tts_tpu.frontend.text_processor import get_phones_and_bert

    jtts, ptts, jcalls, pcalls, clips = both
    phones2 = np.asarray(get_phones_and_bert(ZH_TEXT, jtts.tts_config)[0], np.int32)
    jtoks = np.asarray(jcalls[0][1]).ravel()
    jsov, psov = jtts.sovits_models[assets["sovits"]], ptts.sovits_models[assets["sovits"]]
    jge = jtts.spk_audio_cache[assets["spk"]]["ge"][assets["sovits"]]
    pge = ptts.spk_audio_cache[assets["spk"]]["ge"][assets["sovits"]]
    ja, _ = jtts._sovits_decode(jsov, jtoks[None, None, :], phones2[None], jge, noise_scale=0.0)
    pa, _ = ptts._sovits_decode(psov, jtoks[None, None, :], phones2[None], pge, noise_scale=0.0)
    np.testing.assert_allclose(pa, np.asarray(ja), rtol=RTOL, atol=ATOL)
    for text, (jclip, pclip) in clips.items():
        assert np.all(np.isfinite(pclip.audio_data)) and pclip.audio_data.size > 6400
        i = 0 if text == ZH_TEXT else 1
        if np.array_equal(np.asarray(jcalls[i][1]).ravel(), np.asarray(pcalls[i][1]).ravel()):
            np.testing.assert_allclose(pclip.audio_data, jclip.audio_data, rtol=RTOL, atol=ATOL)


def test_batched_and_stream_take_the_bert_rows(assets, both):
    """``infer_batched`` of two Chinese texts and a Chinese ``infer_stream``:
    the rows entering the engine equal JAX's, the first tokens too."""
    jtts, ptts, jcalls, pcalls, _ = both
    texts = [ZH_TEXT, "我爱中国。"]
    n = len(pcalls)
    jtts.infer_batched(assets["spk"], assets["prompt"], PROMPT_TEXT, texts, **KW)
    ptts.infer_batched(assets["spk"], assets["prompt"], PROMPT_TEXT, texts, **KW)
    list(jtts.infer_stream(assets["spk"], assets["prompt"], PROMPT_TEXT, ZH_TEXT, debug=False,
                           **KW))
    chunks = list(ptts.infer_stream(assets["spk"], assets["prompt"], PROMPT_TEXT, ZH_TEXT, **KW))
    assert chunks and all(np.all(np.isfinite(c.audio_data)) for c in chunks)
    (jb, jt), (pb, pt) = jcalls[n], pcalls[n]
    for j, p in zip(jb, pb):
        np.testing.assert_allclose(np.asarray(p), np.asarray(j), rtol=RTOL, atol=ATOL)
    for j, p in zip(jt, pt):
        m = min(len(j), len(p), 30)
        np.testing.assert_array_equal(np.asarray(p).ravel()[:m], np.asarray(j).ravel()[:m])
    # the stream's generator took the same rows as the whole-utterance infer
    np.testing.assert_allclose(np.asarray(pcalls[-1][0]), np.asarray(pcalls[0][0]), rtol=0,
                               atol=0)


def test_quant_bert_and_featurizer_buckets_match_jax(assets):
    """``quant_bert`` and ``featurizer_buckets`` together: the int8 BERT rows
    against JAX's, and the bucketed HuBERT's prompt codes equal JAX's.

    At width 1024 the two packages' float32 sums (in other orders) put some
    activation ``x / scale`` on the other side of a rounding tie ``n + 1/2``,
    which moves that int8 value by one and, through the attention, the
    sequence's rows (``test_torch_roberta.py`` holds the int8 encoder to JAX
    within 1e-5 at width 32, where no tie falls).  So the rows are held in
    K1's tolerance form: the two int8 evaluations sit closer to each other
    than half the distance of either from the float32 evaluation."""
    import dataclasses

    from gsv_tts_tpu.frontend.text_processor import get_phones_and_bert as jfe
    from gsv_tts_tpu_torch.frontend.text_processor import get_phones_and_bert as pfe
    from gsv_tts_tpu_torch.models.roberta import CNRoberta

    jtts, ptts = _facades(assets, use_bert=True, quant_bert=True, featurizer_buckets=True)
    assert ptts.tts_config.cnroberta.quant and ptts.tts_config.cnroberta.buckets
    jp, _, jb, _ = jfe(ZH_TEXT, jtts.tts_config)
    pp, _, pb, _ = pfe(ZH_TEXT, ptts.tts_config)
    f32 = dataclasses.replace(ptts.tts_config, quant_bert=False, featurizer_buckets=False)
    f32.cnroberta = CNRoberta(ptts.cnroberta_path, f32)
    _, _, fb, _ = pfe(ZH_TEXT, f32)
    assert pp == jp
    jb = np.asarray(jb)

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(pb, jb) < 0.5 * min(rel(pb, fb), rel(jb, fb)), (rel(pb, jb), rel(pb, fb))
    assert 1e-4 < rel(pb, fb) < 5e-2
    jtts.cache_prompt_audio(assets["prompt"], PROMPT_TEXT)
    ptts.cache_prompt_audio(assets["prompt"], PROMPT_TEXT)
    jcodes = np.asarray(jtts.prompt_audio_cache[assets["prompt"]]["prompt"])
    pcodes = ptts.prompt_audio_cache[assets["prompt"]]["prompt"]
    np.testing.assert_array_equal(pcodes, jcodes)
    clip = ptts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, ZH_TEXT, **KW)
    assert np.all(np.isfinite(clip.audio_data)) and clip.audio_data.size > 6400


def test_auto_bert_loads_on_the_first_han_text_only(assets):
    from gsv_tts_tpu_torch import TTS

    tts = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
              device="cpu", seed=0)
    tts.load_gpt_model(assets["gpt"])
    tts.load_sovits_model(assets["sovits"])
    assert tts.tts_config.cnroberta is None and not tts._bert_loaded
    tts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, "a short test.", **KW)
    assert tts.tts_config.cnroberta is None and not tts._bert_loaded
    tts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, "你好。", **KW)
    bert = tts.tts_config.cnroberta
    assert bert is not None and tts._bert_loaded
    tts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, "中国。", **KW)
    assert tts.tts_config.cnroberta is bert  # loaded once
    off = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
              device="cpu", seed=0, auto_bert=False)
    off._ensure_bert_loaded()
    assert off.tts_config.cnroberta is None and not off._bert_loaded
    assert TTS(models_dir=str(assets["root"]), device="cpu",
               use_bert=True).tts_config.cnroberta is not None


def test_missing_bert_dir_gives_zero_features_and_a_warning(assets, tmp_path, monkeypatch,
                                                           caplog):
    """Without the BERT directory the facade warns once and the Chinese rows
    are zeros; no connection is attempted (the port never downloads)."""
    import shutil

    from gsv_tts_tpu_torch import TTS

    def no_network(*a, **kw):
        raise AssertionError("a network connection was attempted")

    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.setattr(socket.socket, "connect", no_network)
    root = tmp_path / "models"
    root.mkdir()
    shutil.copytree(assets["root"] / "chinese-hubert-base", root / "chinese-hubert-base")
    with caplog.at_level(logging.WARNING, logger="gsv_tts_tpu_torch.tts"):
        tts = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(root), device="cpu",
                  seed=0, use_bert=True)
    assert "BERT model files not found" in caplog.text
    assert tts.tts_config.cnroberta is None and tts._bert_loaded
    tts.load_gpt_model(assets["gpt"])
    tts.load_sovits_model(assets["sovits"])
    rows = []
    _capture(tts.gpt_models[assets["gpt"]].engine, "generate", rows)
    caplog.clear()
    clip = tts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, ZH_TEXT, **KW)
    assert "BERT model files not found" not in caplog.text  # not retried
    assert not np.asarray(rows[0][0]).any() and clip.audio_data.size > 6400


def test_warmup_takes_the_zh_prefix_only_when_a_zh_g2p_works(assets, monkeypatch, caplog):
    """With the BERT directory present and a working Chinese G2P the warmup
    text starts with the zh prefix (so BERT loads and runs); without a pinyin
    backend the prefix is dropped with a warning and the warmup still runs."""
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.config import global_config

    def facade():
        t = TTS(gpt_cache=[(1, 256)], sovits_cache=[], models_dir=str(assets["root"]),
                device="cpu", seed=0)
        t.load_gpt_model(assets["gpt"])
        t.load_sovits_model(assets["sovits"])
        texts = []
        orig = t.infer
        t.infer = lambda *a, **kw: texts.append(a[3]) or orig(*a, **kw)
        return t, texts

    t, texts = facade()
    t.warmup()
    assert texts[0].startswith("预热完成。") and t.tts_config.cnroberta is not None
    monkeypatch.setattr(global_config, "chinese_g2p", None)
    monkeypatch.setattr(global_config, "_g2p_auto", {})
    import sys

    monkeypatch.setitem(sys.modules, "pypinyin", None)
    t, texts = facade()
    with caplog.at_level(logging.WARNING, logger="gsv_tts_tpu_torch.tts"):
        stats = t.warmup()
    assert not texts[0].startswith("预热") and "zh prefix skipped" in caplog.text
    assert stats["infer_s"] > 0 and t.tts_config.cnroberta is None
