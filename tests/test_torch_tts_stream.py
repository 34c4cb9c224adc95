"""The streaming slice: ``decode_core`` with the latent cross-fade,
``dsp.sola_align`` and ``TTS.infer_stream`` of the port against the JAX
package, on the tiny ``save_trained_*`` checkpoints of ``test_torch_assets``.

Both facades run with ``sovits_cache=[]`` and ``stream_vocoder="exact"``,
the exact-shape path (``test_torch_tts_defaults.py`` holds the defaults);
``top_k=1`` and ``noise_scale=0`` take the randomness out.  Tolerance: rtol=2e-4, atol=2e-5
(float32 on both sides, summation order only)."""
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import build_assets, real_text_modules, text_modules_as_installed  # noqa: F401,E501
from test_torch_sovits import models  # noqa: F401  (module-scoped fixture)
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
PROMPT_TEXT = "hello there."
TEXT = "this is a test of the stream. it has two parts."


@pytest.mark.parametrize("blend", [False, True])
def test_decode_core_stream_overlap_matches_jax(models, blend):  # noqa: F811
    """A later chunk of a stream: the latent from ``valid_start_idx`` on,
    cross-faded with the previous chunk's overlap when there is one, and the
    new overlap, equal JAX's."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    rng = np.random.RandomState(9)
    n, vsi, ov = 21, 16, 5
    codes = rng.randint(0, 1024, size=(1, 1, n)).astype(np.int32)
    text = rng.randint(1, 700, size=(1, 13)).astype(np.int32)
    ge = (rng.randn(1, 512, 1) * 0.5).astype(np.float32)
    noise = (rng.randn(1, jcfg.inter_channels, 2 * n - vsi) * 0.5).astype(np.float32)
    y_ov = (rng.randn(1, jcfg.hidden_channels, ov) * 0.5).astype(np.float32) if blend else None
    jz, jmask, jattn, jnew, _ = jax.jit(
        lambda p, c, t, g, nz, yo: js.decode_core(p, jcfg, c, t, g, nz, y_overlap=yo,
                                                  valid_start_idx=vsi, overlap_len=ov))(
        jp, jnp.asarray(codes), jnp.asarray(text), jnp.asarray(ge), jnp.asarray(noise),
        None if y_ov is None else jnp.asarray(y_ov))
    pz, pmask, pattn, pnew, _ = ps.decode_core(
        pp, pcfg, torch.tensor(codes), torch.tensor(text), torch.tensor(ge),
        torch.tensor(noise), y_overlap=None if y_ov is None else torch.tensor(y_ov),
        valid_start_idx=vsi, overlap_len=ov)
    assert pz.shape == (1, jcfg.inter_channels, 2 * n - vsi)
    assert pmask.shape == tuple(jmask.shape) and pnew.shape == (1, jcfg.hidden_channels, ov)
    assert pattn.shape[2] == 2 * n  # the attention keeps every frame
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pnew.numpy(), np.asarray(jnew), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pattn.numpy(), np.asarray(jattn), rtol=RTOL, atol=ATOL)


def sola_chunks(seed, overlap, n2):
    rng = np.random.RandomState(seed)
    base = rng.randn(overlap + 400).astype(np.float32)
    shift = 37 + 50 * seed
    f1 = base[shift: shift + overlap] + 0.01 * rng.randn(overlap).astype(np.float32)
    f2 = np.concatenate([base, rng.randn(max(n2 - len(base), 0)).astype(np.float32)])[:n2]
    return f1, f2, shift


@pytest.mark.parametrize("seed,overlap,n2", [(0, 1600, 9000), (1, 640, 700), (2, 1600, 1700)])
def test_sola_align_matches_jax(monkeypatch, seed, overlap, n2):
    """Random chunks sharing a shifted tail: the same offset and samples as
    the JAX package's numpy path (a chunk shorter than overlap + search too);
    both packages' native libraries patched out."""
    from gsv_tts_tpu import dsp as jdsp
    from gsv_tts_tpu_torch import dsp as pdsp

    monkeypatch.setenv("GSV_DISABLE_NATIVE", "1")
    monkeypatch.setattr(jdsp, "native_lib", lambda: None)
    monkeypatch.setattr(pdsp, "native_lib", lambda: None)
    f1, f2, shift = sola_chunks(seed, overlap, n2)
    ja, joff = jdsp.sola_align(f1, f2, overlap)
    pa, poff = pdsp.sola_align(f1, f2, overlap)
    assert poff == joff and (n2 < overlap + 320 or poff == shift)
    np.testing.assert_array_equal(pa, ja)


@pytest.mark.parametrize("seed,overlap,n2", [(0, 1600, 9000), (1, 640, 700), (2, 1600, 1700)])
def test_sola_align_native_matches_jax(monkeypatch, seed, overlap, n2):
    """The same chunks through both packages' C++ offset search."""
    from gsv_tts_tpu import dsp as jdsp
    from gsv_tts_tpu_torch import dsp as pdsp
    from gsv_tts_tpu_torch.utils import native as pnative

    monkeypatch.delenv("GSV_DISABLE_NATIVE", raising=False)
    if jdsp.native_lib() is None or pnative.native_lib() is None:
        pytest.skip("no C++ compiler: neither native library is built")
    f1, f2, shift = sola_chunks(seed, overlap, n2)
    n = pnative.native_lib().calls["sola_offset"]
    ja, joff = jdsp.sola_align(f1, f2, overlap)
    pa, poff = pdsp.sola_align(f1, f2, overlap)
    assert pnative.native_lib().calls["sola_offset"] == n + 1
    assert poff == joff and (n2 < overlap + 320 or poff == shift)
    np.testing.assert_array_equal(pa, ja)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


@pytest.fixture(scope="module")
def engines(assets):
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
    return jtts, ptts


@pytest.mark.parametrize("kw", [
    dict(stream_chunk=10, boost_first_chunk=True),
    dict(stream_chunk=15, boost_first_chunk=False, overlap_len=3),
    dict(stream_mode="sentence"),
], ids=["token-boost", "token-held", "sentence"])
def test_infer_stream_chunks_match_jax(assets, engines, kw):
    """Chunk count, chunk lengths and samples of ``TTS.infer_stream`` equal
    the JAX facade's, over two text segments (head trim on each segment's
    first chunk, the mute pad after its last)."""
    jtts, ptts = engines
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT, TEXT)
    common = dict(top_k=1, noise_scale=0.0, cut_minlen=5, **kw)
    jchunks = [np.asarray(c.audio_data) for c in jtts.infer_stream(*args, debug=False, **common)]
    pclips = list(ptts.infer_stream(*args, **common))
    pchunks = [c.audio_data for c in pclips]
    assert [len(c) for c in pchunks] == [len(c) for c in jchunks]
    assert len(pchunks) >= (2 if kw.get("stream_mode") == "sentence" else 4)
    for i, (pc, jc) in enumerate(zip(pchunks, jchunks)):
        assert pc.dtype == np.float32 and np.all(np.isfinite(pc))
        np.testing.assert_allclose(pc, jc, rtol=RTOL, atol=ATOL, err_msg=f"chunk {i}")
    total = sum(len(c) for c in pchunks)
    assert pclips[-1].audio_len_s == pytest.approx(total / 32000)
    assert pclips[-1].samplerate == 32000 and pclips[-1].orig_text == TEXT
    assert 0 < ptts.last_timings["ttfa_s"] and ptts.last_timings["decode_steps"] > 0


def test_stream_chunks_hold_after_the_frontend_oracle_stubs(assets, engines, monkeypatch):
    """The order hazard of a whole run: ``tests/test_frontend.py``'s oracle
    tests put stand-ins for ``pysbd`` (a whole text as one sentence) and
    ``py3langid`` into ``sys.modules`` and leave them there.  Left in place
    they cut this file's two-sentence text as one, and the chunk count
    falls below what the stream tests hold (each file passed alone); within
    :func:`real_text_modules`, which every test module of the facade runs
    under, the stream is what it is alone, chunk for chunk JAX's."""
    from gsv_tts_tpu_torch.frontend import text_processor as tp

    jtts, ptts = engines
    # the stand-ins of test_frontend.py:_load_ref_textprocessor, as it installs them
    pysbd = types.ModuleType("pysbd")

    class Segmenter:
        def segment(self, text):
            return [text]

    pysbd.Segmenter = Segmenter
    py3langid = types.ModuleType("py3langid")
    py3langid.classify = lambda t: ("zh", 0.0)
    monkeypatch.setitem(sys.modules, "pysbd", pysbd)
    monkeypatch.setitem(sys.modules, "py3langid", py3langid)
    assert len(tp._split_sentences(TEXT)) == 1  # what the hazard did
    with real_text_modules():
        assert "pysbd" not in sys.modules or getattr(sys.modules["pysbd"], "__file__", None)
        assert len(tp._split_sentences(TEXT)) == 2
        args = (assets["spk"], assets["prompt"], PROMPT_TEXT, TEXT)
        common = dict(top_k=1, noise_scale=0.0, cut_minlen=5, stream_chunk=15,
                      boost_first_chunk=False, overlap_len=3)
        jchunks = [np.asarray(c.audio_data)
                   for c in jtts.infer_stream(*args, debug=False, **common)]
        pchunks = [c.audio_data for c in ptts.infer_stream(*args, **common)]
    assert sys.modules["pysbd"] is pysbd  # put back as found
    assert len(pchunks) >= 4 and [len(c) for c in pchunks] == [len(c) for c in jchunks]
    for i, (pc, jc) in enumerate(zip(pchunks, jchunks)):
        np.testing.assert_allclose(pc, jc, rtol=RTOL, atol=ATOL, err_msg=f"chunk {i}")


def test_infer_stream_under_flash_matches_default(assets, engines):
    """The facade under ``attn_impl="flash"`` (K4 and K3b twins) streams the
    audio the default engine does."""
    from gsv_tts_tpu_torch import TTS

    _, ptts = engines
    ftts = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
               device="cpu", seed=0, attn_impl="flash", stream_vocoder="exact")
    ftts.load_gpt_model(assets["gpt"])
    ftts.load_sovits_model(assets["sovits"])
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT, "a short test.")
    kw = dict(top_k=1, noise_scale=0.0, stream_chunk=10)
    a = [c.audio_data for c in ptts.infer_stream(*args, **kw)]
    b = [c.audio_data for c in ftts.infer_stream(*args, **kw)]
    assert [len(c) for c in a] == [len(c) for c in b] and len(a) > 1
    # the first chunks: greedy chains of two float32 routes may part later
    np.testing.assert_allclose(b[0], a[0], rtol=RTOL, atol=ATOL)


def test_infer_stream_rejects_what_is_not_ported(assets, engines, monkeypatch):
    """Japanese is ported as JAX has it without ``pyopenjtalk``: kana stream,
    kanji raise JAX's ``RuntimeError``."""
    _, ptts = engines
    monkeypatch.setitem(sys.modules, "pyopenjtalk", None)
    chunks = list(ptts.infer_stream(assets["spk"], assets["prompt"], PROMPT_TEXT,
                                    "こんにちは、せかい。", top_k=1, stream_chunk=10))
    assert chunks and sum(c.audio_data.size for c in chunks) > 0
    with pytest.raises(RuntimeError, match="requires pyopenjtalk"):
        next(ptts.infer_stream(assets["spk"], assets["prompt"], PROMPT_TEXT, "今日は。"))


def test_infer_stream_leaves_grad_mode_alone(assets, engines):
    """The generator computes without autograd but never holds it switched
    off across a yield."""
    _, ptts = engines
    stream = ptts.infer_stream(assets["spk"], assets["prompt"], PROMPT_TEXT, "a short test.",
                               top_k=1, stream_chunk=10)
    next(stream)
    assert torch.is_grad_enabled()
    stream.close()
