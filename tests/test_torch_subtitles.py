"""The port's subtitle pipeline against the JAX package's: the monotonic
Viterbi over the MRTE attention and its quality gate (both numpy paths,
the native libraries switched off, and both C++ paths), the word timings of ``_get_subtitles``,
and the batched mode's ``_find_subtitles`` / ``_cat_subtitles``, on the same
inputs.  Host numpy on both sides: results equal exactly, times to float
rounding."""
import copy
import types

import numpy as np
import pytest

from test_torch_assets import text_modules_as_installed  # noqa: F401


def attention(seed, heads=4, frames=60, phones=12, lead=0, flat=False):
    """Softmax rows [heads, frames, phones] walking the phones in order (or
    no order at all, ``flat``), the first ``lead`` frames on the null key
    (the last column)."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(heads, frames, phones).astype(np.float32)
    if not flat:
        walk = np.minimum((np.arange(frames) * (phones - 1)) // frames, phones - 2)
        logits[:, np.arange(frames), walk] += 4.0
    logits[:, :lead, -1] += 8.0
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.fixture
def jdsp(monkeypatch):
    """JAX's dsp on its numpy path, and the port's on its own: both
    packages' native libraries patched out."""
    from gsv_tts_tpu import dsp
    from gsv_tts_tpu_torch import dsp as pdsp

    monkeypatch.setattr(dsp, "native_lib", lambda: None)
    monkeypatch.setattr(pdsp, "native_lib", lambda: None)
    return dsp


@pytest.fixture
def jdsp_native(monkeypatch):
    """JAX's dsp through its native library; the port's takes its own."""
    from gsv_tts_tpu import dsp
    from gsv_tts_tpu_torch.utils import native as pnative

    monkeypatch.delenv("GSV_DISABLE_NATIVE", raising=False)
    if dsp.native_lib() is None or pnative.native_lib() is None:
        pytest.skip("no C++ compiler: neither native library is built")
    return dsp


@pytest.mark.parametrize("seed,lead,flat", [(0, 0, False), (1, 7, False), (2, 0, True),
                                            (3, 3, True), (4, 60, False)])
def test_viterbi_monotonic_and_gate_match_jax(jdsp, seed, lead, flat):
    from gsv_tts_tpu_torch import dsp as pdsp

    attn = attention(seed, lead=lead, flat=flat)
    got, want = pdsp.viterbi_monotonic(attn), jdsp.viterbi_monotonic(attn)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (60,) and got.dtype == np.int64
    valid = got[got >= 0]
    assert np.all(np.isin(np.diff(valid), (0, 1)))  # monotonic, one phone at a time
    assert pdsp.is_normal_assign(got) == jdsp.is_normal_assign(want)


@pytest.mark.parametrize("seed,lead,flat", [(0, 0, False), (1, 7, False), (2, 0, True),
                                            (3, 3, True), (4, 60, False)])
def test_viterbi_monotonic_native_matches_jax(jdsp_native, seed, lead, flat):
    """The same alignments through both packages' C++ Viterbi."""
    from gsv_tts_tpu_torch import dsp as pdsp
    from gsv_tts_tpu_torch.utils import native as pnative

    attn = attention(seed, lead=lead, flat=flat)
    n = pnative.native_lib().calls["viterbi_monotonic"]
    got, want = pdsp.viterbi_monotonic(attn), jdsp_native.viterbi_monotonic(attn)
    assert pnative.native_lib().calls["viterbi_monotonic"] == n + 1
    np.testing.assert_array_equal(got, want)
    assert pdsp.is_normal_assign(got) == jdsp_native.is_normal_assign(want)


@pytest.mark.parametrize("assign", [[-1, -1, -1], [0, 1, 2, 3, 4, 5], [0, 0, 1, 1, 2, 2, 3],
                                    [-1, 0, 0, 1, 2, 2, 2, 3, 4, 4], [5]])
def test_is_normal_assign_matches_jax(jdsp, assign):
    from gsv_tts_tpu_torch import dsp as pdsp

    a = np.asarray(assign, np.int64)
    assert pdsp.is_normal_assign(a) == jdsp.is_normal_assign(a)


def word2ph_of(text):
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.frontend.text_processor import get_phones_and_bert

    phones, word2ph, _, norm_text = get_phones_and_bert(text, Config(device="cpu"))
    return phones, word2ph, norm_text


def facades():
    """The two facades' subtitle methods, on objects with just the sampling
    rate they read."""
    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    def bound(cls):
        ns = types.SimpleNamespace(sovits_hz=50)
        for name in ("_get_subtitles", "_find_subtitles", "_cat_subtitles"):
            setattr(ns, name, getattr(cls, name).__get__(ns))
        return ns

    return bound(TTS), bound(JaxTTS)


@pytest.mark.parametrize("seed,lead,speed,last_end_s", [(0, 0, 1.0, 0.0), (1, 7, 1.25, 0.0),
                                                        (2, 0, 0.8, 1.7), (3, 5, 1.0, 0.4)])
def test_get_subtitles_matches_jax(jdsp, seed, lead, speed, last_end_s):
    """Word timings from one assignment: the same words, times equal to
    float rounding, under a speed change and a chained start."""
    phones, word2ph, _ = word2ph_of("this is a test of the subtitles, in order.")
    p, j = facades()
    assign = jdsp.viterbi_monotonic(attention(seed, frames=90, phones=len(phones) + 1,
                                              lead=lead))
    got = p._get_subtitles(word2ph, assign, speed, last_end_s=last_end_s)
    want = j._get_subtitles(word2ph, assign, speed, last_end_s=last_end_s)
    assert got and [s["text"] for s in got] == [s["text"] for s in want]
    for g, w in zip(got, want):
        assert g["start_s"] == pytest.approx(w["start_s"], abs=1e-9)
        assert g["end_s"] == pytest.approx(w["end_s"], abs=1e-9)
    assert got[0]["start_s"] >= last_end_s


def test_get_subtitles_of_an_all_null_assignment_is_empty_as_in_jax():
    phones, word2ph, _ = word2ph_of("a short one.")
    p, j = facades()
    assign = np.full(30, -1, np.int64)
    assert p._get_subtitles(word2ph, assign, 1.0) == j._get_subtitles(word2ph, assign, 1.0) == []


def test_find_and_cat_subtitles_match_jax():
    """A packed batch's subtitles cut back into segments by their words
    (``_find_subtitles``, also where a segment's words are missing), then
    the segments chained in time (``_cat_subtitles``)."""
    p, j = facades()
    segs = [word2ph_of(t)[1] for t in ("good day!", "this is a test.", "and the last.")]
    subs, t = [], 0.0
    for w2p in segs:
        for word in w2p["word"]:
            subs.append({"text": word, "start_s": t, "end_s": t + 0.25})
            t += 0.3
    for subtitles in (subs, subs[:2] + subs[3:]):  # the second lost a word
        cuts = {}
        for name, f in (("port", p), ("jax", j)):
            last, out = 0, []
            for w2p in segs:
                best = f._find_subtitles(subtitles, w2p, last)
                out.append(copy.deepcopy(subtitles[last:best]))
                last = best
            cuts[name] = out
        assert cuts["port"] == cuts["jax"]
        got = p._cat_subtitles(*copy.deepcopy(cuts["port"]))
        want = j._cat_subtitles(*copy.deepcopy(cuts["jax"]))
        assert got == want and got[0]["start_s"] == 0.0
