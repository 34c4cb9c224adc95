"""The port's SoVITS training halves (``gsv_tts_tpu_torch/models/sovits_train.py``)
against the JAX package's at a tiny width (2 layers, 64 channels; the
discriminators at their fixed published widths): the same params, the
fresh posterior encoder and discriminators drawn by JAX's own init and
carried over with ``convert.sovits_from_jax``, the same batch and JAX's own
random draws (the posterior noise, the slice draws).

Tolerance: rtol 2e-4, atol 2e-5 relative to each tensor's largest entry
(float32, summation order only), unless a test says otherwise."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gsv_tts_tpu.models import sovits as jsv
from gsv_tts_tpu.models import sovits_train as jsvt
from gsv_tts_tpu.ops import stft as jstft
from gsv_tts_tpu_torch import convert
from gsv_tts_tpu_torch.models import sovits as psv
from gsv_tts_tpu_torch.models import sovits_train as psvt
from gsv_tts_tpu_torch.ops import stft as pstft
from gsv_tts_tpu_torch.parallel.train import Optimizer
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
HOP, N_FFT, SEG, N_MELS = 4, 16, 16, 8
CFG_KW = dict(spec_channels=129, inter_channels=64, hidden_channels=64, filter_channels=96,
              n_heads=2, n_layers=2, kernel_size=3, p_dropout=0.0, resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3, 5),), upsample_rates=(2, 2),
              upsample_initial_channel=32, upsample_kernel_sizes=(4, 4), gin_channels=512,
              ref_enc_in=96, flow_n_layers=2)


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, np.abs(want).max()),
                               err_msg=what)


def jax_params(cfg, seed=0):
    """JAX-init-shaped SoVITS params drawn with numpy (N(0, 0.05), an N(0, 1)
    codebook), plus JAX's own fresh ``enc_q``."""
    shapes = jax.eval_shape(lambda: jsv.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    p = {}
    for k in sorted(shapes):
        shape = shapes[k].shape
        if k.endswith(".gamma"):
            p[k] = np.ones(shape, np.float32)
        elif k.endswith((".bias", ".beta")):
            p[k] = np.zeros(shape, np.float32)
        else:
            scale = 1.0 if k.endswith("_codebook.embed") else 0.05
            p[k] = (rng.randn(*shape) * scale).astype(np.float32)
    if cfg.is_v2pro:
        p["sv_emb.weight"] *= 0.1
    enc_q = jax.jit(lambda key: jsvt.init_enc_q_params(key, cfg))(jax.random.PRNGKey(1))
    p.update({k: np.asarray(v) for k, v in enc_q.items()})
    return p


def make_samples(cfg, lengths=(32, 22), seed=4, sv_dim=None):
    rng = np.random.RandomState(seed)
    out = []
    for i, T in enumerate(lengths):
        s = (rng.randn(768, T).astype(np.float32) * 0.1,
             np.abs(rng.randn(cfg.spec_channels, T)).astype(np.float32),
             (rng.randn(T * HOP) * 0.1).astype(np.float32),
             rng.randint(1, 100, size=(12 - 5 * i,)).astype(np.int32))
        if sv_dim:
            s += (rng.randn(sv_dim).astype(np.float32) * 0.1,)
        out.append(s)
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg, pcfg = jsv.SovitsConfig(**CFG_KW), psv.SovitsConfig(**CFG_KW)
    jp = jax_params(jcfg)
    dp = {k: np.asarray(v) for k, v in
          jax.jit(jsvt.init_discriminator_params)(jax.random.PRNGKey(2)).items()}
    samples = make_samples(jcfg)
    return dict(jcfg=jcfg, pcfg=pcfg, jp=jp, dp=dp, samples=samples,
                jb=jsvt.pad_sovits_batch(jcfg, samples, HOP),
                pb=psvt.pad_sovits_batch(pcfg, samples, HOP))


def jtree(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def test_pad_sovits_batch_matches_jax(setup):
    jb, pb = setup["jb"], setup["pb"]
    assert set(jb) == set(pb)
    for k in jb:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]), err_msg=k)


def test_mel_filterbank_and_spectrogram_gradient_match_jax():
    """The filterbank is JAX's bit for bit; the magnitude STFT's gradient is
    JAX's, also through bins of zero magnitude (a silent stretch, where
    both give 0: torch's ``abs`` backward is ``sgn``, JAX's ``abs`` of a
    complex zero has gradient 0); so is the log-mel's."""
    np.testing.assert_array_equal(pstft.mel_filterbank(16000, N_FFT, N_MELS),
                                  jstft.mel_filterbank(16000, N_FFT, N_MELS))
    np.testing.assert_array_equal(pstft.mel_filterbank(32000, 2048, 128, 20.0, 12000.0),
                                  jstft.mel_filterbank(32000, 2048, 128, 20.0, 12000.0))
    rng = np.random.RandomState(0)
    audio = (rng.randn(2, 200) * 0.1).astype(np.float32)
    audio[:, 40:120] = 0.0  # whole frames of silence: bins of magnitude 0
    w = rng.randn(2, N_FFT // 2 + 1, 1 + 200 // HOP).astype(np.float32)

    def jloss(a):
        return jnp.sum(jstft.spectrogram(a, N_FFT, HOP, N_FFT) * w)

    a = torch.tensor(audio, requires_grad=True)
    spec = pstft.spectrogram(a, N_FFT, HOP, N_FFT)
    assert (spec.detach() == 0).any()
    (g,) = torch.autograd.grad((spec * torch.as_tensor(w)).sum(), a)
    close(g, jax.grad(jloss)(jnp.asarray(audio)), what="spectrogram grad")
    assert np.isfinite(g.numpy()).all()

    kw = dict(n_fft=N_FFT, hop_length=HOP, win_length=N_FFT, sr=16000, n_mels=N_MELS)
    a = torch.tensor(audio, requires_grad=True)
    mel = psvt.mel_spectrogram(a, **kw)
    close(mel, jsvt.mel_spectrogram(jnp.asarray(audio), **kw), what="log-mel")
    (g,) = torch.autograd.grad(mel.sum(), a)
    close(g, jax.grad(lambda x: jnp.sum(jsvt.mel_spectrogram(x, **kw)))(jnp.asarray(audio)),
          what="log-mel grad")


def test_posterior_encoder_and_flow_forward_match_jax(setup):
    """The posterior encoder (masked frames exactly 0) and the forward flow
    match JAX; the forward flow inverts the port's ``flow_reverse``."""
    jcfg, pcfg, jp = setup["jcfg"], setup["pcfg"], setup["jp"]
    pp = convert.sovits_from_jax(jp)
    rng = np.random.RandomState(1)
    B, T = 2, 20
    spec = rng.randn(B, jcfg.spec_channels, T).astype(np.float32)
    mask = (np.arange(T)[None, None, :] < np.array([20, 13])[:, None, None]).astype(np.float32)
    noise = rng.randn(B, jcfg.inter_channels, T).astype(np.float32)
    ge = (rng.randn(B, jcfg.gin_channels, 1) * 0.1).astype(np.float32)
    want = jsvt.posterior_encoder(jtree(jp), jcfg, spec, mask, ge, noise)
    got = psvt.posterior_encoder(pp, pcfg, *map(torch.as_tensor, (spec, mask, ge, noise)))
    for name, g, w in zip(("z", "m_q", "logs_q"), got, want):
        close(g, w, what=name)
    assert (got[0][1, :, 13:] == 0).all()

    x = torch.as_tensor(rng.randn(B, jcfg.inter_channels, T).astype(np.float32))
    ones = torch.ones(B, 1, T)
    z_p = psvt.flow_forward(pp, pcfg, x, ones, torch.as_tensor(ge))
    close(z_p, jsvt.flow_forward(jtree(jp), jcfg, x.numpy(), ones.numpy(), ge), what="z_p")
    close(psv.flow_reverse(pp, pcfg, z_p, ones, torch.as_tensor(ge)), x.numpy(),
          rtol=1e-4, atol=1e-5, what="flow_reverse(flow_forward(x))")


def test_discriminators_match_jax(setup):
    """Every discriminator's logits and feature maps (the periods' reflect
    padding and the scale discriminator's grouped convs included)."""
    dp = setup["dp"]
    y = (np.random.RandomState(3).randn(2, 1, 250) * 0.1).astype(np.float32)
    jouts, jfmaps = jsvt.discriminate(jtree(dp), jnp.asarray(y))
    pouts, pfmaps = psvt.discriminate(convert.sovits_from_jax(dp), torch.as_tensor(y))
    assert len(pouts) == 1 + len(psvt.PERIODS) and len(pfmaps[0]) == 7
    for i, (po, jo) in enumerate(zip(pouts, jouts)):
        close(po, jo, what=f"logits {i}")
        assert len(pfmaps[i]) == len(jfmaps[i])
        for j, (pf, jf) in enumerate(zip(pfmaps[i], jfmaps[i])):
            close(pf, jf, what=f"fmap {i}.{j}")


def test_losses_match_jax():
    rng = np.random.RandomState(5)
    z_p, logs_q, m_p = (rng.randn(2, 8, 30).astype(np.float32) for _ in range(3))
    logs_p = (rng.randn(2, 8, 30) * 0.3).astype(np.float32)
    mask = (np.arange(30)[None, None, :] < np.array([30, 17])[:, None, None]).astype(np.float32)
    close(psvt.kl_loss(*map(torch.as_tensor, (z_p, logs_q, m_p, logs_p, mask))),
          jsvt.kl_loss(z_p, logs_q, m_p, logs_p, mask), what="kl")
    outs_r = [rng.randn(2, n).astype(np.float32) for n in (5, 7, 3)]
    outs_f = [rng.randn(2, n).astype(np.float32) for n in (5, 7, 3)]
    fm_r = [[rng.randn(2, 4, n).astype(np.float32) for n in (6, 3)] for _ in range(3)]
    fm_f = [[rng.randn(2, 4, n).astype(np.float32) for n in (6, 3)] for _ in range(3)]

    def t(tree):
        return [[torch.as_tensor(a) for a in x] if isinstance(x, list) else torch.as_tensor(x)
                for x in tree]

    close(psvt.feature_loss(t(fm_r), t(fm_f)), jsvt.feature_loss(fm_r, fm_f), what="fm")
    close(psvt.generator_adv_loss(t(outs_f)), jsvt.generator_adv_loss(outs_f), what="adv")
    close(psvt.discriminator_loss(t(outs_r), t(outs_f)),
          jsvt.discriminator_loss(outs_r, outs_f), what="disc")


def test_rand_slice_segments_match_jax():
    """Given JAX's uniform draws, the same starts and windows, rows shorter
    than ``segment_frames`` included (start 0, the window reaching into the
    padding), and the matching audio windows."""
    rng = np.random.RandomState(6)
    x = rng.randn(4, 3, 40).astype(np.float32)
    lengths = np.array([40, 9, 25, 16], np.int32)  # row 1: shorter than SEG
    wav = rng.randn(4, 40 * HOP).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jslices, jids = jsvt.rand_slice_segments(key, jnp.asarray(x), jnp.asarray(lengths), SEG)
    u = np.array(jax.random.uniform(key, (4,)))
    pslices, pids = psvt.rand_slice_segments(torch.as_tensor(x), torch.as_tensor(lengths),
                                             SEG, torch.as_tensor(u))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    assert pids[1] == 0
    np.testing.assert_array_equal(pslices.numpy(), np.asarray(jslices))
    np.testing.assert_array_equal(
        psvt.slice_audio(torch.as_tensor(wav), pids, SEG, HOP).numpy(),
        np.asarray(jsvt.slice_audio(jnp.asarray(wav), jids, SEG, HOP)))
    # a start past the end is clamped into the row, as dynamic_slice clamps it
    ids = torch.tensor([30, 0, 24, 40])
    want = jax.vmap(lambda r, s: jax.lax.dynamic_slice(r, (0, s), (3, SEG)))(
        jnp.asarray(x), jnp.asarray(ids.numpy()))
    np.testing.assert_array_equal(psvt._windows(torch.as_tensor(x), ids, SEG).numpy(),
                                  np.asarray(want))


def test_train_forward_matches_jax_given_its_draws(setup):
    jcfg, pcfg, jp = setup["jcfg"], setup["pcfg"], setup["jp"]
    key = jax.random.PRNGKey(8)
    want = jax.jit(lambda p, b: jsvt.train_forward(p, jcfg, b, key))(jtree(jp), setup["jb"])
    rng_q, _ = jax.random.split(key)
    noise = jax.random.normal(rng_q, want["m_p"].shape, dtype=jnp.float32)
    got = psvt.train_forward(convert.sovits_from_jax(jp), pcfg, setup["pb"],
                             torch.as_tensor(np.array(noise)))
    for k in ("ge", "m_p", "logs_p", "m_q", "logs_q", "z", "z_p", "y_mask"):
        close(got[k], want[k], what=k)
    # rows of a padded batch are their own: row 1 alone gives row 1's prior
    one = psvt.pad_sovits_batch(pcfg, setup["samples"][1:], HOP)
    alone = psvt.train_forward(convert.sovits_from_jax(jp), pcfg, one,
                               torch.as_tensor(np.array(noise))[1:])
    T = int(one["spec_lens"][0])
    for k in ("ge", "m_p", "m_q"):
        close(got[k][1:, :, :T], alone[k][:, :, :T].detach().numpy(), what=f"{k} alone")


def test_gan_step_matches_jax(setup):
    """One D + G step with JAX's draws and optax's ``chain(
    clip_by_global_norm(1.0), adamw(2e-4))`` for both: every G and D param
    and every loss as JAX's, the frozen RVQ leaves unchanged bit for bit."""
    jcfg, pcfg, jp, dp = setup["jcfg"], setup["pcfg"], setup["jp"], setup["dp"]
    key = jax.random.PRNGKey(5)
    kw = dict(n_fft=N_FFT, hop_length=HOP, win_length=N_FFT, sr=16000, segment_frames=SEG,
              n_mels=N_MELS)

    def chain():
        return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(2e-4))

    jstep = jsvt.make_sovits_train_step(jcfg, chain(), chain(), **kw)
    g, d = jtree(jp), jtree(dp)
    g2, d2, _, _, jm = jax.jit(jstep)(g, d, chain().init(g), chain().init(d), setup["jb"], key)
    rng_q, rng_s = jax.random.split(jax.random.split(key)[0])
    B, _, T = setup["pb"]["spec"].shape
    noise = torch.as_tensor(np.array(jax.random.normal(rng_q, (B, jcfg.inter_channels, T))))
    u = torch.as_tensor(np.array(jax.random.uniform(rng_s, (B,))))

    pg, pd = convert.sovits_from_jax(jp), convert.sovits_from_jax(dp)
    frozen = {k: v.clone() for k, v in pg.items() if k.startswith(psvt.FROZEN_PREFIXES)}
    assert frozen
    g_opt = Optimizer({k: v.requires_grad_(True) for k, v in pg.items() if k not in frozen},
                      lambda _: 2e-4)
    d_opt = Optimizer({k: v.requires_grad_(True) for k, v in pd.items()}, lambda _: 2e-4)
    pm = psvt.make_sovits_train_step(pcfg, g_opt, d_opt, **kw)(pg, pd, setup["pb"], noise, u)
    for k in jm:
        close(pm[k], jm[k], what=k)
    for k in jp:
        close(pg[k], g2[k], what=k)
    for k in dp:
        close(pd[k], d2[k], what=k)
    for k, v in frozen.items():
        assert torch.equal(pg[k], v), k
    assert sum(not np.array_equal(pg[k].detach().numpy(), jp[k]) for k in jp) > 10


def test_v2pro_sv_emb_fusion_under_refer_mask():
    """v2Pro training fuses each sample's speaker embedding into ``ge`` as
    inference does, under the batch's ``refer_mask``: the port's float32
    ``get_ge`` is JAX's, the fusion moves ``ge``, and a v2Pro batch without
    embeddings is refused.  (A padded row's ``ge`` is not its unpadded one in
    either package: the style encoder masks after its two temporal convs,
    whose kernels reach into the padding, as the reference's does.)"""
    kw = {**CFG_KW, "version": "v2Pro"}
    jcfg, pcfg = jsv.SovitsConfig(**kw), psv.SovitsConfig(**kw)
    jp = jax_params(jcfg)
    pp = convert.sovits_from_jax(jp)
    sv_dim = jp["sv_emb.weight"].shape[-1]
    samples = make_samples(jcfg, lengths=(27, 20), seed=3, sv_dim=sv_dim)
    jb = jsvt.pad_sovits_batch(jcfg, samples, HOP, pad_multiple=8)
    pb = psvt.pad_sovits_batch(pcfg, samples, HOP, pad_multiple=8)
    np.testing.assert_array_equal(pb["sv_emb"].numpy(), np.asarray(jb["sv_emb"]))
    T = pb["spec"].shape[-1]
    mask = (torch.arange(T)[None, None, :] < pb["spec_lens"][:, None, None]).float()
    got = psv.get_ge(pp, pcfg, pb["spec"], sv_emb=pb["sv_emb"], refer_mask=mask)
    want = jsv.get_ge(jtree(jp), jcfg, jb["spec"], sv_emb=jb["sv_emb"],
                      refer_mask=jnp.asarray(mask.numpy()))
    close(got, want, what="fused ge")
    unfused = psv.get_ge(pp, pcfg, pb["spec"], refer_mask=mask)
    assert not torch.allclose(got, unfused)
    with pytest.raises(ValueError, match="sv_emb"):
        psvt.pad_sovits_batch(pcfg, [s[:4] for s in samples], HOP, pad_multiple=8)
