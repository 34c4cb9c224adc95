"""The slice as a whole: JAX ``TTS.infer`` and the port's ``TTS.infer`` on the
same tiny ``save_trained_*`` checkpoints, HuBERT directory and wavs, and the
port running with JAX made unimportable.

Both facades run with ``sovits_cache=[]`` and ``stream_vocoder="exact"``:
the exact-shape path (the bucket padding lets the vocoder's unmasked convs
see the padded tail; ``test_torch_tts_defaults.py`` holds the defaults)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_assets import build_assets, text_modules_as_installed  # noqa: F401
from test_torch_assets import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_TEXT = "hello there."
TEXT = "this is a test."


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


def _capture_tokens(engine, sink):
    orig = engine.generate

    def generate(*args, **kw):
        out = orig(*args, **kw)
        sink.append(np.asarray(out).ravel())
        return out

    engine.generate = generate


@pytest.fixture(scope="module")
def both(assets):
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
    jtoks, ptoks = [], []
    _capture_tokens(jtts.gpt_models[assets["gpt"]].engine, jtoks)
    _capture_tokens(ptts.gpt_models[assets["gpt"]].engine, ptoks)
    kw = dict(top_k=1, noise_scale=0.0)
    jclip = jtts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, TEXT, **kw)
    pclip = ptts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, TEXT, **kw)
    return jtts, ptts, jclip, pclip, jtoks[0], ptoks[0]


def test_infer_caches_and_tokens_match_jax(assets, both):
    """Speaker ``ge``, prompt codes and phones agree; with ``top_k=1`` the
    semantic tokens agree over a bounded prefix (greedy chains of two
    float32 implementations may part at a near-tie)."""
    jtts, ptts, jclip, pclip, jtoks, ptoks = both
    jc = jtts.prompt_audio_cache[assets["prompt"]]
    pc = ptts.prompt_audio_cache[assets["prompt"]]
    assert np.array_equal(np.asarray(jc["prompt"]), pc["prompt"])
    assert jc["phones1"] == pc["phones1"]
    jge = np.asarray(jtts.spk_audio_cache[assets["spk"]]["ge"][assets["sovits"]])
    pge = ptts.spk_audio_cache[assets["spk"]]["ge"][assets["sovits"]].numpy()
    np.testing.assert_allclose(pge, jge, rtol=2e-4, atol=2e-5)
    n = min(len(jtoks), len(ptoks), 40)
    assert n == 40
    np.testing.assert_array_equal(ptoks[:n], jtoks[:n])
    assert pclip.samplerate == 32000 and pclip.audio_data.dtype == np.float32
    assert np.all(np.isfinite(pclip.audio_data)) and np.abs(pclip.audio_data).max() <= 1.0
    assert ptts.last_timings["tokens"] == len(ptoks)


def test_sovits_stage_fed_jax_tokens_matches_jax(assets, both):
    """The port's SoVITS decode of JAX's tokens gives JAX's waveform
    (float32; 2e-4 / 2e-5: summation order only)."""
    from gsv_tts_tpu.frontend.text_processor import get_phones_and_bert

    jtts, ptts, jclip, pclip, jtoks, _ = both
    phones2 = np.asarray(get_phones_and_bert(TEXT, jtts.tts_config)[0], np.int32)
    jsov = jtts.sovits_models[assets["sovits"]]
    psov = ptts.sovits_models[assets["sovits"]]
    jge = jtts.spk_audio_cache[assets["spk"]]["ge"][assets["sovits"]]
    pge = ptts.spk_audio_cache[assets["spk"]]["ge"][assets["sovits"]]
    codes = jtoks[None, None, :]
    ja, jattn = jtts._sovits_decode(jsov, codes, phones2[None], jge, noise_scale=0.0)
    pa, pattn = ptts._sovits_decode(psov, codes, phones2[None], pge, noise_scale=0.0)
    assert pa.shape == np.asarray(ja).shape == (1, 1, 2 * len(jtoks) * 640)
    np.testing.assert_allclose(pa, np.asarray(ja), rtol=2e-4, atol=2e-5)
    assert pattn.shape == jattn.shape == (4, 2 * len(jtoks), len(phones2))
    np.testing.assert_allclose(pattn, jattn, rtol=2e-4, atol=2e-5)


def test_infer_rejects_what_is_not_ported(assets, both, monkeypatch):
    """Japanese is ported as JAX has it without ``pyopenjtalk``: kana
    synthesize, kanji raise JAX's ``RuntimeError``."""
    _, ptts, *_ = both
    monkeypatch.setitem(sys.modules, "pyopenjtalk", None)
    clip = ptts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, "こんにちは。", top_k=1)
    assert clip.audio_data.size > 6400 and np.all(np.isfinite(clip.audio_data))
    with pytest.raises(RuntimeError, match="requires pyopenjtalk"):
        ptts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, "今日は。")


def test_port_runs_without_jax(assets):
    """With ``jax``, ``safetensors`` and ``transformers`` unimportable, every
    module of the port imports and a tiny ``TTS.infer`` runs on the CPU."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "safetensors", "transformers"):
            sys.modules[name] = None
        import gsv_tts_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(gsv_tts_tpu_torch.__path__,
                                                      "gsv_tts_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        from gsv_tts_tpu_torch import TTS
        tts = TTS(gpt_cache=[(1, 128)], models_dir={str(assets["root"])!r}, device="cpu", seed=1)
        tts.load_gpt_model({assets["gpt"]!r})
        tts.load_sovits_model({assets["sovits"]!r})
        clip = tts.infer({assets["spk"]!r}, {assets["prompt"]!r}, "hello there.", "a short test.")
        leaked = sorted(m for m in sys.modules if m == "gsv_tts_tpu" or m.startswith("gsv_tts_tpu."))
        assert not leaked, leaked
        assert clip.audio_data.size > 6400 and len(mods) > 20
        print("OK", len(mods), clip.audio_data.size)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")
