"""The port's SoVITS v2 inference stack and spectral ops against the JAX
package, on the tiny hyperparameters of ``test_e2e.py`` with weights from
the JAX key layout (float32, CPU).

Tolerance: rtol=2e-4, atol=2e-5 — float32 on both sides, summation order
only — except where a stated reason widens it."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import HPS, jax_sovits
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def models():
    from gsv_tts_tpu_torch.convert import sovits_from_jax
    from gsv_tts_tpu_torch.models.sovits import SovitsConfig

    jcfg, jp = jax_sovits(1)
    pcfg = SovitsConfig.from_hps(HPS["model"], HPS["data"]["filter_length"] // 2 + 1)
    return jcfg, jp, pcfg, sovits_from_jax(jax.tree.map(np.asarray, jp))


def test_extract_latent_codes_exact(models):
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    _, jp, _, pp = models
    ssl = np.random.RandomState(0).randn(1, 768, 57).astype(np.float32)
    jc = np.asarray(js.extract_latent(jp, jnp.asarray(ssl)))
    pc = ps.extract_latent(pp, torch.tensor(ssl)).numpy()
    assert pc.shape == jc.shape == (1, 1, 28)
    assert np.array_equal(pc, jc)


def test_spectrogram_and_resample_match_jax():
    from gsv_tts_tpu.ops import stft as js
    from gsv_tts_tpu_torch.ops import stft as ps

    audio = np.random.RandomState(1).randn(1, 12345).astype(np.float32) * 0.3
    d = HPS["data"]
    j = np.asarray(js.spectrogram(jnp.asarray(audio), d["filter_length"], d["hop_length"],
                                  d["win_length"]))
    p = ps.spectrogram(torch.tensor(audio), d["filter_length"], d["hop_length"],
                       d["win_length"]).numpy()
    assert p.shape == j.shape
    # FFT vs strided rfft: magnitudes of O(10) bins, float32 rounding
    np.testing.assert_allclose(p, j, rtol=1e-3, atol=1e-4)
    np.testing.assert_array_equal(ps.resample(audio, 32000, 16000),
                                  js.resample(audio, 32000, 16000))


def test_get_ge_matches_jax(models):
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    refer = np.abs(np.random.RandomState(2).randn(1, jcfg.spec_channels, 83)).astype(np.float32)
    j = np.asarray(js.get_ge(jp, jcfg, jnp.asarray(refer)))
    p = ps.get_ge(pp, pcfg, torch.tensor(refer)).numpy()
    assert p.shape == j.shape == (1, 512, 1)
    np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL)


def test_decode_core_and_flow_dec_match_jax(models):
    """Same codes, phones, ``ge`` and latent noise ⇒ same ``z_p``, MRTE
    attention and waveform."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    rng = np.random.RandomState(3)
    codes = rng.randint(0, 1024, size=(1, 1, 23)).astype(np.int32)
    text = rng.randint(1, 700, size=(1, 17)).astype(np.int32)
    ge = (rng.randn(1, 512, 1) * 0.5).astype(np.float32)
    noise = (rng.randn(1, jcfg.inter_channels, 46) * 0.5).astype(np.float32)
    # jitted: eager JAX dispatches every op separately (~20 s here)
    jz, jmask, jattn, _, jge = jax.jit(js.decode_core, static_argnums=1)(
        jp, jcfg, jnp.asarray(codes), jnp.asarray(text), jnp.asarray(ge), jnp.asarray(noise))
    pz, pmask, pattn, _, pge = ps.decode_core(pp, pcfg, torch.tensor(codes),
                                              torch.tensor(text), torch.tensor(ge),
                                              torch.tensor(noise))
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pattn.numpy(), np.asarray(jattn), rtol=RTOL, atol=ATOL)
    ja = np.asarray(jax.jit(js.flow_dec, static_argnums=1)(jp, jcfg, jz, jmask, jge))
    pa = ps.flow_dec(pp, pcfg, pz, pmask, pge).numpy()
    assert pa.shape == ja.shape == (1, 1, 46 * jcfg.samples_per_frame)
    assert np.abs(pa).max() > 0.05  # the tiny vocoder is audible, not silent
    np.testing.assert_allclose(pa, ja, rtol=RTOL, atol=ATOL)


def test_decode_core_packed_with_slice_indices_matches_jax(models):
    """A packed batch of three requests: concatenated codes and phones, the
    per-frame speaker conditioning ``ge`` [1, C, T] of two speakers, and
    ``slice_indices`` giving each latent frame its own request's text span.
    ``z_p``, the MRTE attention and the waveform equal JAX's, and no frame
    attends another request's phones (the last column, the null key, apart)."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    rng = np.random.RandomState(5)
    code_lens, phone_lens = np.asarray([9, 14, 6]), np.asarray([7, 11, 5])
    T, N = int(code_lens.sum()), int(phone_lens.sum())
    codes = rng.randint(0, 1024, size=(1, 1, T)).astype(np.int32)
    text = rng.randint(1, 700, size=(1, N)).astype(np.int32)
    spk = (rng.randn(2, 512, 1) * 0.5).astype(np.float32)
    ge = np.concatenate([np.broadcast_to(spk[i % 2][None], (1, 512, n))
                         for i, n in enumerate(code_lens)], axis=2)
    ends = np.cumsum(phone_lens)
    pairs = np.stack([ends - phone_lens, ends], axis=1)
    slice_indices = np.repeat(pairs, code_lens * 2, axis=0)
    noise = (rng.randn(1, jcfg.inter_channels, 2 * T) * 0.5).astype(np.float32)
    jz, jmask, jattn, _, jge = jax.jit(
        lambda p, c, t, g, n, si: js.decode_core(p, jcfg, c, t, g, n, slice_indices=si))(
        jp, jnp.asarray(codes), jnp.asarray(text), jnp.asarray(ge), jnp.asarray(noise),
        jnp.asarray(slice_indices, jnp.int32))
    pz, pmask, pattn, _, pge = ps.decode_core(
        pp, pcfg, torch.tensor(codes), torch.tensor(text), torch.tensor(ge),
        torch.tensor(noise), torch.tensor(slice_indices))
    assert pge.shape == (1, 512, 2 * T)
    np.testing.assert_allclose(pge.numpy(), np.asarray(jge), rtol=0, atol=0)
    np.testing.assert_allclose(pz.numpy(), np.asarray(jz), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pattn.numpy(), np.asarray(jattn), rtol=RTOL, atol=ATOL)
    cols = np.arange(N)[None, :]
    outside = ~((cols >= slice_indices[:, :1]) & (cols < slice_indices[:, 1:]))
    outside[:, -1] = False
    assert float(pattn[0][:, torch.tensor(outside)].abs().max()) == 0.0
    ja = np.asarray(jax.jit(js.flow_dec, static_argnums=1)(jp, jcfg, jz, jmask, jge))
    pa = ps.flow_dec(pp, pcfg, pz, pmask, pge).numpy()
    assert pa.shape == ja.shape == (1, 1, 2 * T * jcfg.samples_per_frame)
    np.testing.assert_allclose(pa, ja, rtol=RTOL, atol=ATOL)


def test_flow_reverse_and_generator_channels_first(models):
    """The flow and the vocoder separately, against JAX's channels-first
    (``nch``) functions."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    rng = np.random.RandomState(4)
    z = rng.randn(1, jcfg.inter_channels, 31).astype(np.float32)
    mask = np.ones((1, 1, 31), np.float32)
    mask[..., 27:] = 0
    ge = (rng.randn(1, 512, 1) * 0.5).astype(np.float32)
    jf = np.asarray(jax.jit(js.flow_reverse, static_argnums=1)(
        jp, jcfg, jnp.asarray(z), jnp.asarray(mask), jnp.asarray(ge)))
    pf = ps.flow_reverse(pp, pcfg, torch.tensor(z), torch.tensor(mask), torch.tensor(ge)).numpy()
    np.testing.assert_allclose(pf, jf, rtol=RTOL, atol=ATOL)
    jg = np.asarray(jax.jit(js.generator, static_argnums=1)(
        jp, jcfg, jnp.asarray(jf), g=jnp.asarray(ge)))
    pg = ps.generator(pp, pcfg, torch.tensor(jf), g=torch.tensor(ge)).numpy()
    np.testing.assert_allclose(pg, jg, rtol=RTOL, atol=ATOL)

