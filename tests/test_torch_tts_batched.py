"""The batched slice as a whole: JAX ``TTS.infer_batched`` and the port's on
the same tiny ``save_trained_*`` checkpoints, HuBERT directory and wavs; the
port running from a copy of its package alone with JAX unimportable; and the
device policy (the card unless the caller asks for the CPU).

Both facades run with ``sovits_cache=[]`` and ``stream_vocoder="exact"``:
the exact-shape path (``test_torch_tts_defaults.py`` holds the defaults).
Tolerance of the audio: rtol=2e-4, atol=2e-5 (float32 on both sides,
summation order only)."""
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from test_torch_assets import build_assets, text_modules_as_installed  # noqa: F401
from test_torch_assets import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_TEXT = "hello there."
TEXTS = ["this is a test.", "one more short line here now. then a second clause follows it.", "good day!"]
GPT_CACHE = [(1, 128), (2, 128)]
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


def _capture(engine, sink):
    orig = engine.generate_batched

    def generate_batched(*args, **kw):
        pred, idx = orig(*args, **kw)
        sink.append(([np.asarray(p).ravel() for p in pred], np.asarray(idx)))
        return pred, idx

    engine.generate_batched = generate_batched


@pytest.fixture(scope="module")
def both(assets):
    import jax

    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    old = os.environ.get("GSV_OFFLINE")
    os.environ["GSV_OFFLINE"] = "1"
    try:
        jtts = JaxTTS(gpt_cache=GPT_CACHE, sovits_cache=[], models_dir=str(assets["root"]),
                      dtype="float32", stream_vocoder="exact")
        jtts.load_gpt_model(assets["gpt"])
        jtts.load_sovits_model(assets["sovits"])
        jtts._rng = jax.random.PRNGKey(0)
        ptts = TTS(gpt_cache=GPT_CACHE, sovits_cache=[], models_dir=str(assets["root"]),
                   device="cpu", seed=0, stream_vocoder="exact")
        ptts.load_gpt_model(assets["gpt"])
        ptts.load_sovits_model(assets["sovits"])
        jout, pout = [], []
        _capture(jtts.gpt_models[assets["gpt"]].engine, jout)
        _capture(ptts.gpt_models[assets["gpt"]].engine, pout)
        kw = dict(top_k=1, noise_scale=0.0)
        jclips = jtts.infer_batched(assets["spk"], assets["prompt"], PROMPT_TEXT, TEXTS, **kw)
        pclips = ptts.infer_batched(assets["spk"], assets["prompt"], PROMPT_TEXT, TEXTS, **kw)
    finally:
        if old is None:
            os.environ.pop("GSV_OFFLINE", None)
        else:
            os.environ["GSV_OFFLINE"] = old
    return jtts, ptts, jclips, pclips, jout[0], pout[0]


def test_infer_batched_tokens_match_jax(both):
    """Every text is cut into the same engine requests, they finish in the
    same order, and with ``top_k=1`` each request's semantic tokens agree
    over a bounded prefix (greedy chains of two float32 implementations may
    part at a near-tie)."""
    jtts, ptts, jclips, pclips, (jpred, jidx), (ppred, pidx) = both
    assert len(pclips) == len(jclips) == len(TEXTS)
    assert len(ppred) == len(jpred) > len(TEXTS)  # the second text is cut in two
    assert pidx.tolist() == jidx.tolist()
    for i, pt, jt in zip(pidx.tolist(), ppred, jpred):
        n = min(len(pt), len(jt), 30)
        assert n == 30, (i, len(pt), len(jt))
        np.testing.assert_array_equal(pt[:n], jt[:n], err_msg=f"request {i}")
    eng = ptts.gpt_models[next(iter(ptts.gpt_models))].engine
    assert eng.refills >= 1  # more requests than slots
    st = ptts.last_timings
    assert st["requests"] == len(ppred) and st["tokens"] == sum(len(p) for p in ppred)
    for clip, text in zip(pclips, TEXTS):
        assert clip.samplerate == 32000 and clip.audio_data.dtype == np.float32
        assert clip.orig_text == text
        assert np.all(np.isfinite(clip.audio_data)) and np.abs(clip.audio_data).max() <= 1.0


def test_infer_batched_sovits_stage_fed_jax_tokens_matches_jax(both, monkeypatch):
    """Fed JAX's harvests, the port's back half (length sort with dual-ended
    interleave, packed SoVITS decodes with block-diagonal MRTE masks,
    per-segment head/tail trim, ``cut_mute`` padding) gives JAX's clips:
    equal length and audio within the tolerance."""
    jtts, ptts, jclips, _, (jpred, jidx), _ = both
    eng = ptts.gpt_models[next(iter(ptts.gpt_models))].engine
    monkeypatch.setattr(eng, "generate_batched",
                        lambda *a, **kw: ([p.copy() for p in jpred], jidx.copy()))
    for batch in (10, 2):  # one packed decode, then two
        pclips = ptts.infer_batched(next(iter(ptts.spk_audio_cache)),
                                    next(iter(ptts.prompt_audio_cache)), PROMPT_TEXT, TEXTS,
                                    top_k=1, noise_scale=0.0, sovits_batch_size=batch)
        if batch == 2:
            jclips = jtts.infer_batched(next(iter(ptts.spk_audio_cache)),
                                        next(iter(ptts.prompt_audio_cache)), PROMPT_TEXT, TEXTS,
                                        top_k=1, noise_scale=0.0, sovits_batch_size=batch)
        for pc, jc in zip(pclips, jclips):
            assert pc.audio_data.shape == jc.audio_data.shape
            assert abs(pc.audio_len_s - jc.audio_len_s) < 1e-9 and pc.audio_data.size > 6400
            np.testing.assert_allclose(pc.audio_data, jc.audio_data, rtol=RTOL, atol=ATOL)


def test_infer_batched_rejects_what_is_not_ported(assets, both, monkeypatch):
    """Japanese is ported as JAX has it without ``pyopenjtalk``: a kana text
    joins the batch, kanji raise JAX's ``RuntimeError``."""
    _, ptts, *_ = both
    monkeypatch.setitem(sys.modules, "pyopenjtalk", None)
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT)
    clips = ptts.infer_batched(*args, TEXTS[:1] + ["こんにちは。"], top_k=1)
    assert len(clips) == 2 and all(c.audio_data.size > 0 for c in clips)
    with pytest.raises(RuntimeError, match="requires pyopenjtalk"):
        ptts.infer_batched(*args, TEXTS + ["今日は。"])


def test_copied_package_runs_alone_without_jax(assets, tmp_path):
    """Only ``gsv_tts_tpu_torch/`` is copied into an empty directory and run
    from there with ``jax`` blocked: every module imports, and a tiny
    ``infer`` and ``infer_batched`` run on the CPU.  Passes only if the port
    reaches for no file of ``gsv_tts_tpu/``."""
    shutil.copytree(os.path.join(REPO, "gsv_tts_tpu_torch"), tmp_path / "gsv_tts_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    script = textwrap.dedent(f"""
        import importlib, os, pkgutil, sys
        for name in ("jax", "jaxlib", "safetensors", "transformers"):
            sys.modules[name] = None
        import gsv_tts_tpu_torch
        here = os.path.realpath({str(tmp_path)!r})
        assert os.path.realpath(gsv_tts_tpu_torch.__file__).startswith(here)
        mods = [m.name for m in pkgutil.walk_packages(gsv_tts_tpu_torch.__path__,
                                                      "gsv_tts_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        from gsv_tts_tpu_torch import TTS
        tts = TTS(gpt_cache=[(1, 128), (2, 128)], models_dir={str(assets["root"])!r},
                  device="cpu", seed=1)
        tts.load_gpt_model({assets["gpt"]!r})
        tts.load_sovits_model({assets["sovits"]!r})
        spk, prompt = {assets["spk"]!r}, {assets["prompt"]!r}
        clip = tts.infer(spk, prompt, "hello there.", "a short test.")
        clips = tts.infer_batched(spk, prompt, "hello there.",
                                  ["a short test.", "and another one.", "the third."])
        for m in sys.modules.values():
            f = getattr(m, "__file__", None) or ""
            assert os.sep + "gsv_tts_tpu" + os.sep not in f, f
        assert clip.audio_data.size > 6400 and len(clips) == 3 and len(mods) > 25
        assert all(c.audio_data.size > 6400 for c in clips)
        print("OK", len(mods), clip.audio_data.size, [c.audio_data.size for c in clips])
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         env=env, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("OK")


def test_engine_needs_a_card_unless_asked_for_the_cpu(assets, monkeypatch):
    """``Config()`` and ``TTS()`` without ``device`` take the card and raise
    when there is none; ``device="cpu"`` works (float32)."""
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.config import Config, default_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (Config, default_device, lambda: TTS(models_dir=str(assets["root"]))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
    cfg = Config(device="cpu")
    assert cfg.device == torch.device("cpu") and cfg.dtype == torch.float32
    assert TTS(models_dir=str(assets["root"]), device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda")
