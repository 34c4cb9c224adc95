"""The host C++ DSP library of the port (``csrc/host/gsv_native.cpp``, built by
``utils/cuda_build.load_host_library`` at first use, bound by
``utils/native.py``) against the JAX package's library built from
``native/gsv_native.cpp`` (``tests/conftest.py`` builds it) and against the
numpy fallbacks.

The two libraries come from the same source with the same flags, so their
results are held equal bit for bit; the numpy fallbacks differ where they
recur in float32 (the envelope follower, ``ENV_ATOL``) or filter as dense IIRs
(Freeverb, ``VERB_ATOL``), and the enhance chain carries that difference to
its output (``ENHANCE_ATOL``)."""
import logging
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SR = 32000
ENV_ATOL = 1e-5  # a float32 recurrence against a float64 one, on levels below 1
VERB_ATOL = 1e-12  # float64 both: delay lines against dense lfilter IIRs
ENHANCE_ATOL = 1e-5


def speech_like(seed, seconds=1.0, sr=SR):
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.4 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
            + 0.05 * rng.randn(t.size)).astype(np.float32)


@pytest.fixture
def libs(monkeypatch):
    """(the port's library, JAX's library), both built; JAX's cache cleared
    around the test so an earlier ``GSV_DISABLE_NATIVE`` cannot leak in."""
    from gsv_tts_tpu.utils import native as jnative
    from gsv_tts_tpu_torch.utils import native as pnative

    monkeypatch.delenv("GSV_DISABLE_NATIVE", raising=False)
    jnative.native_lib.cache_clear()
    jlib, plib = jnative.native_lib(), pnative.native_lib()
    if jlib is None or plib is None:
        pytest.skip("no C++ compiler: a native library is not built")
    yield plib, jlib
    jnative.native_lib.cache_clear()


def test_source_is_a_copy_of_the_jax_packages():
    assert (REPO / "gsv_tts_tpu_torch" / "csrc" / "host" / "gsv_native.cpp").read_bytes() == \
        (REPO / "native" / "gsv_native.cpp").read_bytes()


def test_native_lib_builds_from_the_packages_source(libs):
    """``native_lib()`` builds ``csrc/host/gsv_native.cpp`` into
    ``gsv_tts_tpu_torch/build/`` once and keeps the result."""
    from gsv_tts_tpu_torch.utils import cuda_build, native

    plib, _ = libs
    path = Path(cuda_build.build_info["gsv_native"]["path"])
    assert path.parent == REPO / "gsv_tts_tpu_torch" / "build"
    assert path.name.startswith("libgsv_native-") and path.exists()
    assert native.native_lib() is plib
    for sym in ("gsv_sola_offset", "gsv_viterbi_monotonic", "gsv_envelope_follow",
                "gsv_freeverb"):
        assert getattr(plib._lib, sym).argtypes


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_entry_points_equal_jax_library_and_numpy(libs, seed):
    """Each of the four entry points equals JAX's bit for bit on seeded
    inputs, and the numpy fallbacks within the stated tolerances."""
    from gsv_tts_tpu_torch import fx

    plib, jlib = libs
    rng = np.random.RandomState(seed)
    # SOLA: the next chunk's head holds the previous tail at a known shift
    base = rng.randn(2400).astype(np.float32)
    shift = 40 + 90 * seed
    query = base[shift: shift + 1600] + 0.01 * rng.randn(1600).astype(np.float32)
    key = base[:1920]
    off = plib.sola_offset(query, key, 1600)
    assert off == jlib.sola_offset(query, key, 1600) == shift
    windows = np.lib.stride_tricks.sliding_window_view(key, 1600)
    assert off == int(np.argmax((windows @ query) / np.sqrt((windows ** 2).sum(1) + 1e-8)))
    assert plib.sola_offset(query, key[:100], 1600) == 0  # a key shorter than the overlap
    # Viterbi: softmax rows over 12 phones along 60 frames
    probs = rng.rand(60, 12).astype(np.float32)
    path = plib.viterbi_monotonic(probs)
    np.testing.assert_array_equal(path, jlib.viterbi_monotonic(probs))
    assert path.dtype == np.int64 and np.all(np.isin(np.diff(path), (0, 1)))
    # envelope follower and Freeverb on speech-like audio at the compressor's / reverb's
    # settings
    x = speech_like(seed)
    att, rel = np.exp(-1 / (SR * 0.001)), np.exp(-1 / (SR * 0.1))
    env = plib.envelope_follow(np.abs(x), att, rel)
    np.testing.assert_array_equal(env, jlib.envelope_follow(np.abs(x), att, rel))
    np.testing.assert_allclose(env, fx._envelope_numpy(np.abs(x), att, rel), rtol=0, atol=ENV_ATOL)
    combs = [max(1, int(round(d * SR / 44100))) for d in fx._COMB_TUNINGS]
    aps = [max(1, int(round(d * SR / 44100))) for d in fx._ALLPASS_TUNINGS]
    wet = plib.freeverb(x, combs, aps, 0.728, 0.2)
    np.testing.assert_array_equal(wet, jlib.freeverb(x, combs, aps, 0.728, 0.2))
    want = sum(fx._comb_damped(x, d, 0.728, 0.2) for d in combs) * 0.015
    for d in aps:
        want = fx._allpass(want, d)
    assert wet.dtype == np.float64
    np.testing.assert_allclose(wet, want, rtol=0, atol=VERB_ATOL)
    assert plib.calls["freeverb"] >= 1 and plib.calls["sola_offset"] >= 2


@pytest.mark.parametrize("sr,seconds", [(32000, 1.5), (16000, 0.4)])
def test_dsp_and_fx_through_native_equal_jax(libs, sr, seconds):
    """``dsp.sola_align``, ``dsp.viterbi_monotonic``, ``fx.compressor``,
    ``fx.reverb`` and ``fx.enhance_audio`` of the port equal JAX's, both
    through their native libraries, bit for bit; the port's counts show its
    library ran."""
    from gsv_tts_tpu import dsp as jdsp, fx as jfx
    from gsv_tts_tpu_torch import dsp, fx

    plib, _ = libs
    before = dict(plib.calls)
    x = speech_like(3, seconds, sr)
    for name, args in (("compressor", (x, sr)), ("reverb", (x, sr)), ("enhance_audio", (x, sr))):
        got, want = getattr(fx, name)(*args), getattr(jfx, name)(*args)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=name)
    f1, f2 = x[1000:1640], x[963:963 + 4000]
    (pa, poff), (ja, joff) = dsp.sola_align(f1, f2, 640), jdsp.sola_align(f1, f2, 640)
    assert poff == joff == 37
    np.testing.assert_array_equal(pa, ja)
    rng = np.random.RandomState(5)
    logits = rng.randn(4, 50, 9).astype(np.float32)
    logits[:, :6, -1] += 8.0  # leading frames on the null key
    attn = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    np.testing.assert_array_equal(dsp.viterbi_monotonic(attn), jdsp.viterbi_monotonic(attn))
    calls = {k: plib.calls[k] - before[k] for k in before}
    assert calls == {"sola_offset": 1, "viterbi_monotonic": 1, "envelope_follow": 2,
                     "freeverb": 2}


def test_enhance_audio_native_against_numpy(libs, monkeypatch):
    """The enhance chain through the library against its numpy path on the same
    audio: within ``ENHANCE_ATOL``, and the numpy path calls no entry point."""
    from gsv_tts_tpu_torch import fx

    plib, _ = libs
    x = speech_like(4)
    native = fx.enhance_audio(x, SR)
    monkeypatch.setenv("GSV_DISABLE_NATIVE", "1")
    n = dict(plib.calls)
    plain = fx.enhance_audio(x, SR)
    assert plib.calls == n
    assert np.all(np.isfinite(native)) and np.abs(native).max() > 0
    np.testing.assert_allclose(native, plain, rtol=0, atol=ENHANCE_ATOL)


def test_disable_after_first_use_takes_the_numpy_path(libs, monkeypatch):
    """``GSV_DISABLE_NATIVE`` is read on every call: set after the library was
    built, ``native_lib()`` gives ``None`` and ``dsp`` takes its numpy code
    (the JAX package caches its first answer instead)."""
    from gsv_tts_tpu_torch import dsp
    from gsv_tts_tpu_torch.utils import native

    plib, _ = libs
    assert native.native_lib() is plib
    monkeypatch.setenv("GSV_DISABLE_NATIVE", "1")
    assert native.native_lib() is None
    n = dict(plib.calls)
    attn = np.random.RandomState(6).rand(3, 40, 8).astype(np.float32)
    path = dsp.viterbi_monotonic(attn)
    x = speech_like(7, 0.2)
    _, off = dsp.sola_align(x[100:740], x[80:2000], 640)
    assert plib.calls == n and off == 20
    monkeypatch.delenv("GSV_DISABLE_NATIVE")
    assert native.native_lib() is plib
    np.testing.assert_array_equal(dsp.viterbi_monotonic(attn), path)


def test_broken_source_raises_with_the_compilers_log(monkeypatch, tmp_path):
    from gsv_tts_tpu_torch.utils import cuda_build

    if cuda_build.find_cxx() is None:
        pytest.skip("no C++ compiler")
    src = tmp_path / "broken.cpp"
    src.write_text('extern "C" int broken( { return 0; }\n')
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_failed", {})
    with pytest.raises(RuntimeError, match="failed building broken_test") as e:
        cuda_build.load_host_library("broken_test", [str(src)])
    assert "broken.cpp" in str(e.value) and "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))
    # asked again, the same error is raised without compiling again
    monkeypatch.setattr(cuda_build, "_build_and_load",
                        lambda *a, **kw: pytest.fail("the failed build was run again"))
    with pytest.raises(RuntimeError) as again:
        cuda_build.load_host_library("broken_test", [str(src)])
    assert again.value is e.value


def test_no_compiler_gives_none_and_one_warning(monkeypatch, caplog):
    """An empty ``PATH`` and no ``CXX``: ``native_lib()`` is ``None``, with one
    warning however often it is asked, and the callers take numpy."""
    from gsv_tts_tpu_torch import dsp
    from gsv_tts_tpu_torch.utils import cuda_build, native

    monkeypatch.delenv("GSV_DISABLE_NATIVE", raising=False)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with caplog.at_level(logging.WARNING, logger="gsv_tts_tpu_torch.utils.cuda_build"):
        assert native.native_lib() is None and native.native_lib() is None
        _, off = dsp.sola_align(np.ones(64, np.float32), np.ones(500, np.float32), 64)
    warnings = [r for r in caplog.records if "no host C++ compiler" in r.getMessage()]
    assert len(warnings) == 1 and off == 0
