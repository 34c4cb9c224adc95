"""The port's speaker-verification embedder (``models/sv.py``: Kaldi fbank,
ERes2NetV2, the ``ERes2Net`` facade) and its 2-D convolution helpers against
the JAX package, float32 on the CPU.

Tolerance: rtol=2e-4, atol=2e-5 (float32 on both sides, summation order
only); the fbank is the same numpy code and must be equal bit for bit."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import write_sv_checkpoint
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
#: a reduced ERes2NetV2 (every kind of block, AFF and shortcut, at a quarter
#: of the published width)
SMALL = dict(m_channels=16, num_blocks=(1, 1, 2, 1))


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


def clip(kind: str, seconds: float) -> np.ndarray:
    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    if kind == "tone":
        return (0.3 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    if kind == "silence":
        return np.zeros(n, np.float32)
    rng = np.random.RandomState(n)
    return (0.1 * rng.randn(n) + 0.2 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)


@pytest.mark.parametrize("kind,seconds", [("noise", 0.02), ("noise", 0.025), ("tone", 0.5),
                                          ("silence", 0.3), ("noise", 1.013)],
                         ids=["shorter-than-a-window", "one-window", "1kHz-tone", "silence",
                              "noise"])
def test_kaldi_fbank_equals_jax(kind, seconds):
    """The own copy of the fbank gives JAX's arrays bit for bit: a clip
    shorter than one 25 ms window (0 frames), exactly one window, a 1 kHz
    tone, silence (the log's floor) and noise."""
    from gsv_tts_tpu.models import sv as jsv
    from gsv_tts_tpu_torch.models import sv as psv

    wav = clip(kind, seconds)
    got, want = psv.kaldi_fbank(wav), jsv.kaldi_fbank(wav)
    frames = 0 if len(wav) < 400 else 1 + (len(wav) - 400) // 160
    assert got.shape == want.shape == (frames, 80) and got.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("helper", ["conv2d", "batch_norm", "batch_norm-no-affine", "prelu"])
def test_conv_helpers_match_jax(helper):
    """``conv2d`` (stride 2, padding 1, a bias), ``batch_norm`` with and
    without affine weights, ``prelu`` with per-channel slopes."""
    from gsv_tts_tpu.ops import convs as jc
    from gsv_tts_tpu_torch.ops import convs as pc

    rng = np.random.RandomState(3)
    x = rng.randn(2, 6, 13, 9).astype(np.float32)
    if helper == "conv2d":
        w, b = rng.randn(5, 6, 3, 3).astype(np.float32), rng.randn(5).astype(np.float32)
        got = pc.conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(b), stride=2, padding=1)
        want = jc.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=2, padding=1)
        assert got.shape == (2, 5, 7, 5)
    elif helper.startswith("batch_norm"):
        mean, var = rng.randn(6).astype(np.float32), rng.rand(6).astype(np.float32) + 0.5
        gb = [rng.randn(6).astype(np.float32) for _ in range(2)]
        if helper.endswith("no-affine"):
            gb = [None, None]
        got = pc.batch_norm(torch.tensor(x), torch.tensor(mean), torch.tensor(var),
                            *[None if a is None else torch.tensor(a) for a in gb])
        want = jc.batch_norm(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(var),
                             *[None if a is None else jnp.asarray(a) for a in gb])
    else:
        x = x[:, :, :, 0]
        w = rng.rand(6).astype(np.float32)
        got, want = pc.prelu(torch.tensor(x), torch.tensor(w)), jc.prelu(jnp.asarray(x),
                                                                        jnp.asarray(w))
    close(got, want, helper)


def _jax_cfg(cfg):
    """The port's ``SVConfig`` as the attributes JAX's reads."""
    return types.SimpleNamespace(**dataclasses.asdict(cfg))


def test_param_shapes_are_the_keys_jax_reads():
    """``param_shapes`` names exactly the keys JAX's forward pass reads
    (reduced config, recorded while JAX traces it), and JAX traces through
    parameters of those shapes to the fused map's shape."""
    from gsv_tts_tpu.models import sv as jsv
    from gsv_tts_tpu_torch.models import sv as psv

    cfg = psv.SVConfig(**SMALL)

    class Recorder(dict):
        def __init__(self, *a):
            super().__init__(*a)
            self.read = set()

        def __getitem__(self, k):
            self.read.add(k)
            return super().__getitem__(k)

        def get(self, k, default=None):
            self.read.add(k)
            return super().get(k, default)

    p = Recorder({k: jnp.asarray(v.numpy())
                  for k, v in psv.init_params(cfg, torch.Generator().manual_seed(0)).items()})
    feat = jnp.asarray(np.random.RandomState(0).randn(1, 24, 80).astype(np.float32))
    out = jax.eval_shape(lambda: jsv.eres2netv2_features(p, feat, _jax_cfg(cfg)))
    assert out.shape == (1, 16 * 8 * 4, 10, 3)
    assert p.read == set(psv.param_shapes(cfg))


@pytest.mark.parametrize("width", ["reduced", "published"])
def test_eres2netv2_forward3_matches_jax(width):
    """The fused feature map's temporal mean, flattened channel-major: at a
    reduced width and at the published one (m_channels 64, blocks
    (3, 4, 6, 3), baseWidth 24, scale 4, expansion 4) on a ~1 s clip, where
    the embedding is 20480 wide."""
    from gsv_tts_tpu.models import sv as jsv
    from gsv_tts_tpu_torch.models import sv as psv

    cfg = psv.SVConfig(**SMALL) if width == "reduced" else psv.SVConfig()
    p = psv.init_params(cfg, torch.Generator().manual_seed(1))
    feat = np.stack([psv.kaldi_fbank(clip("noise", 1.013)), psv.kaldi_fbank(clip("tone", 1.013))])
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    want = np.asarray(jax.jit(lambda p, f: jsv.eres2netv2_forward3(p, f, _jax_cfg(cfg)))(
        jp, jnp.asarray(feat)))
    got = psv.eres2netv2_forward3(p, torch.tensor(feat), cfg)
    dim = psv.EMBED_DIM if width == "published" else 16 * 8 * 4 * 10
    assert got.shape == want.shape == (2, dim) and got.dtype == torch.float32
    close(got, want, width)
    fused = psv.eres2netv2_features(p, torch.tensor(feat), cfg)
    # channel-major: entry c·F + f is channel c's mel row f
    torch.testing.assert_close(got.reshape(fused.shape[:3]), fused.mean(-1))


@pytest.fixture(scope="module")
def sv_ckpt(tmp_path_factory):
    return write_sv_checkpoint(tmp_path_factory.mktemp("sv_models"))


def test_compute_embedding3_matches_jax(sv_ckpt):
    """Both facades read one checkpoint written with ``torch.save`` (extra
    keys included) and embed a batch of two 16 kHz clips alike; a single
    clip [T] is a batch of one."""
    from gsv_tts_tpu.models.sv import ERes2Net as JaxERes2Net
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.models.sv import ERes2Net

    wav = np.stack([clip("noise", 0.8), clip("tone", 0.8)])
    want = JaxERes2Net(sv_ckpt, types.SimpleNamespace(dtype=jnp.float32)).compute_embedding3(wav)
    sv = ERes2Net(sv_ckpt, Config(device="cpu"))
    got = sv.compute_embedding3(wav)
    assert got.shape == (2, 20480) and got.dtype == torch.float32 and got.device.type == "cpu"
    close(got, want, "embedding")
    close(sv.compute_embedding3(wav[1]), want[1:], "one clip")


def test_sv_loader_takes_extra_keys_and_names_a_missing_one(tmp_path):
    """Keys the forward pass never reads are dropped; a key it reads that the
    file lacks raises, naming it."""
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.models import sv as psv

    cfg = psv.SVConfig(**SMALL)
    sd = psv.init_params(cfg, torch.Generator().manual_seed(2))
    sd["seg_1.weight"] = torch.zeros(3, 3)
    torch.save(sd, str(tmp_path / "ok.ckpt"))
    sv = psv.ERes2Net(tmp_path / "ok.ckpt", Config(device="cpu"), cfg)
    assert set(sv.params) == set(psv.param_shapes(cfg))
    del sd["layer3_ds.weight"]
    torch.save(sd, str(tmp_path / "bad.ckpt"))
    with pytest.raises(KeyError, match="layer3_ds.weight"):
        psv.ERes2Net(tmp_path / "bad.ckpt", Config(device="cpu"), cfg)


def test_sv_from_jax_takes_the_jax_facades_params(sv_ckpt):
    """``convert.sv_from_jax`` maps the JAX facade's flat params (numpy) to
    the port's: the keys the forward pass reads, equal values."""
    from gsv_tts_tpu.models.sv import ERes2Net as JaxERes2Net
    from gsv_tts_tpu_torch.convert import sv_from_jax
    from gsv_tts_tpu_torch.models import sv as psv

    jsv = JaxERes2Net(sv_ckpt, types.SimpleNamespace(dtype=jnp.float32))
    got = sv_from_jax(jax.tree.map(np.asarray, jsv.params))
    assert set(got) == set(psv.param_shapes(psv.SVConfig()))
    for k in ("conv1.weight", "layer4.2.fuse_models.2.local_att.4.running_var",
              "fuse34.local_att.0.bias"):
        assert np.array_equal(got[k].numpy(), np.asarray(jsv.params[k])), k


@pytest.mark.parametrize("kind,seconds", [("tone", 0.5), ("noise", 1.013), ("silence", 0.3),
                                          ("noise", 3.0), ("noise", 6.37)],
                         ids=["1kHz-tone", "noise", "silence", "3.0s", "6.37s"])
def test_torch_fbank_follows_the_numpy_fbank(kind, seconds):
    """``torch_fbank`` on the CPU gives ``kaldi_fbank``'s frame count and its
    values within 1e-4; the clip padded to its bucket with the valid count
    as a tensor gives the same frames, then zeros."""
    from gsv_tts_tpu_torch.models import sv as psv

    wav = clip(kind, seconds)
    want = psv.kaldi_fbank(wav)
    got = psv.torch_fbank(torch.tensor(wav[None]))
    assert got.shape == (1, *want.shape) and got.dtype == torch.float32
    assert want.shape[0] == psv.n_frames(len(wav))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-4)
    n = want.shape[0]
    padded = np.zeros(psv.bucket_samples(psv.sv_bucket(n)), np.float32)
    padded[:len(wav)] = wav
    got = psv.torch_fbank(torch.tensor(padded[None]), torch.tensor(n))[0].numpy()
    assert got.shape == (psv.sv_bucket(n), 80)
    np.testing.assert_allclose(got[:n], want, rtol=0, atol=1e-4)
    assert not got[n:].any()


def test_sv_bucket_choice():
    """Frame counts round up to a multiple of 128 up to 1024 (10.24 s); an
    empty clip and a longer one have no bucket (they run eagerly); a
    bucket's samples hold exactly its frames."""
    from gsv_tts_tpu_torch.models import sv as psv

    assert psv.SV_BUCKETS == (128, 256, 384, 512, 640, 768, 896, 1024)
    assert [psv.sv_bucket(n) for n in (1, 128, 129, 298, 998, 1024)] == \
        [128, 128, 256, 384, 1024, 1024]
    assert psv.sv_bucket(1025) is None and psv.sv_bucket(0) is None
    for frames in psv.SV_BUCKETS:
        assert psv.n_frames(psv.bucket_samples(frames)) == frames
        assert psv.n_frames(psv.bucket_samples(frames) - 1) == frames - 1
    assert psv.n_frames(int(16000 * 10.24)) == 1022


@pytest.mark.parametrize("frames", [37, 64, 101, 298])
def test_masked_forward_on_padding_equals_the_exact_length(frames):
    """ERes2NetV2 (reduced width, float32) on fbank frames zero-padded to a
    bucket, told the valid count, gives the exact-length run's embedding:
    lengths of every parity at strides 2, 4 and 8, alone (a 0-dim length) and
    beside a full-length clip (a length a row)."""
    from gsv_tts_tpu_torch.models import sv as psv

    cfg = psv.SVConfig(**SMALL)
    p = psv.init_params(cfg, torch.Generator().manual_seed(4))
    feat = torch.tensor(psv.kaldi_fbank(clip("noise", 3.1))[:frames])
    other = torch.tensor(psv.kaldi_fbank(clip("tone", 4.0)))
    t = psv.sv_bucket(frames)
    padded = torch.zeros(2, t, 80)
    padded[0, :frames] = feat
    padded[1] = other[:t]

    def rel(got, want):
        return float((got - want).norm() / want.norm())

    want = psv.eres2netv2_forward3(p, feat[None], cfg)
    got = psv.eres2netv2_forward3(p, padded[:1], cfg, torch.tensor(frames))
    assert got.shape == want.shape and rel(got, want) <= 1e-5
    both = psv.eres2netv2_forward3(p, padded, cfg, torch.tensor([frames, t]))
    assert rel(both[:1], want) <= 1e-5
    assert rel(both[1:], psv.eres2netv2_forward3(p, padded[1:], cfg)) <= 1e-5


def test_bucket_body_equals_the_eager_embedding_on_the_cpu(tmp_path):
    """What a bucket's CUDA graph computes (``ERes2Net._embed``: the torch
    fbank of the padded wav, the masked network, the masked mean), run
    eagerly on the CPU in float32, equals the facade's exact-length
    embedding of a 3 s clip; on the CPU the facade keeps no graph store."""
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.models import sv as psv

    cfg = psv.SVConfig(**SMALL)
    torch.save(psv.init_params(cfg, torch.Generator().manual_seed(5)), str(tmp_path / "sv.ckpt"))
    sv = psv.ERes2Net(tmp_path / "sv.ckpt", Config(device="cpu"), cfg, graphs=object())
    assert sv.graphs is None
    wav = clip("noise", 3.0)
    frames = psv.n_frames(len(wav))
    padded = np.zeros((1, psv.bucket_samples(psv.sv_bucket(frames))), np.float32)
    padded[0, :len(wav)] = wav
    with torch.no_grad():
        got = sv._embed(torch.tensor(padded), torch.tensor(frames))
    want = sv.compute_embedding3(wav)
    assert got.shape == want.shape == (1, 16 * 8 * 4 * 10)
    assert float((got - want).norm() / want.norm()) <= 1e-5
