"""Shared tiny assets for the PyTorch-port tests, plus tests of the port's
checkpoint I/O.

Both packages load the same files: random JAX parameters written by the JAX
package's own ``save_trained_gpt`` / ``save_trained_sovits``, a tiny HuBERT
directory in the Hugging Face layout, and two synthetic wavs — all made
from fixed seeds.
"""
import contextlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

#: optional packages the frontend takes when they import (sentence
#: segmentation, language identification), and which JAX-side oracle tests
#: stand in for with stubs they leave in ``sys.modules``
#: (``tests/test_frontend.py:_load_ref_textprocessor``)
OPTIONAL_TEXT_MODULES = ("pysbd", "py3langid")


@contextlib.contextmanager
def real_text_modules():
    """Within the block, the optional text packages import as installed: a
    stand-in that another test left in ``sys.modules`` (a module object
    without a file) is taken out, and put back afterwards.  The stub
    ``pysbd`` takes a whole text as one sentence, so without this a facade
    test that runs after those tests in the same process cuts its text
    differently than when it runs alone."""
    hidden = {}
    for name in OPTIONAL_TEXT_MODULES:
        mod = sys.modules.get(name)
        if mod is not None and getattr(mod, "__file__", None) is None:
            hidden[name] = sys.modules.pop(name)
    try:
        yield
    finally:
        sys.modules.update(hidden)


@contextlib.contextmanager
def torch_threads(n):
    """Within the block, torch's CPU ops on ``n`` threads.  The loops' many
    small convolutions (the full-width discriminators) and the facade's
    small decode-step ops ran ~30x slower when each of six test workers spun
    8 threads on one 8-core host."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """For a whole test module that imports it (its module-scoped fixtures
    included): torch's CPU ops on one thread (:func:`torch_threads`), the
    count restored at teardown."""
    with torch_threads(1):
        yield


@pytest.fixture(scope="module", autouse=True)
def text_modules_as_installed():
    """For a whole test module (its module-scoped fixtures included): the
    optional text packages as installed (:func:`real_text_modules`)."""
    with real_text_modules():
        yield


TINY_T2S = dict(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2,
                vocab_size=1025, phoneme_vocab_size=732, eos=1024)

#: tiny SoVITS hyperparameters (full 192-wide latent, short stacks)
HPS = {
    "data": {"filter_length": 1408, "hop_length": 320, "win_length": 1408,
             "sampling_rate": 32000, "n_speakers": 0},
    "train": {"segment_size": 1280},
    "model": {
        "inter_channels": 192, "hidden_channels": 192, "filter_channels": 256,
        "n_heads": 2, "n_layers": 2, "kernel_size": 3, "p_dropout": 0.0,
        "resblock": "1", "resblock_kernel_sizes": [3],
        "resblock_dilation_sizes": [[1, 3, 5]],
        "upsample_rates": [8, 5, 4, 4], "upsample_initial_channel": 64,
        "upsample_kernel_sizes": [16, 11, 8, 8], "gin_channels": 512,
        "version": "v2",
    },
}

#: the tiny SoVITS as a v2ProPlus model, with ``gin_channels`` 1024 rather than
#: 512: the flow and HiFi-GAN take ``ge`` at 1024, MRTE ``ge_to512(ge)`` at 512,
#: so a projection left out or misplaced fails on a shape, not only on a value
HPS_V2PRO = {**HPS, "model": {**HPS["model"], "gin_channels": 1024, "version": "v2ProPlus"}}

TINY_HUBERT = dict(hidden_size=768, num_hidden_layers=1, num_attention_heads=4,
                   intermediate_size=128, conv_dim=[32, 32, 32, 32],
                   conv_kernel=[10, 8, 4, 4], conv_stride=[5, 4, 4, 4],
                   num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
                   feat_extract_norm="group", do_stable_layer_norm=False, conv_bias=False)


def jax_t2s(seed=0, **over):
    from gsv_tts_tpu.models import t2s

    cfg = t2s.T2SConfig(**{**TINY_T2S, **over})
    return cfg, t2s.init_params(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)


def jax_sovits(seed=1, hps=HPS):
    """Tiny SoVITS params (v2, or v2Pro with ``HPS_V2PRO``) with the keys and
    shapes of the JAX ``init_params`` (taken abstractly with
    ``jax.eval_shape``; drawing them through it costs ~20 s of eager key
    splits): N(0, 0.05) weights — including the flow's ``post`` convs, which
    the JAX init zeroes, and v2Pro's PReLU slopes — zero biases and betas,
    unit gammas, an N(0, 1) codebook, and a louder vocoder output so the
    audio clears the trim thresholds.  v2Pro's ``sv_emb`` weight is N(0,
    0.005): its 20480 inputs would otherwise swamp the style vector."""
    from gsv_tts_tpu.models import sovits

    cfg = sovits.SovitsConfig.from_hps(hps["model"], hps["data"]["filter_length"] // 2 + 1)
    shapes = jax.eval_shape(lambda: sovits.init_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    p = {}
    for k in sorted(shapes):
        shape = shapes[k].shape
        if k.endswith(".gamma"):
            p[k] = np.ones(shape, np.float32)
        elif k.endswith((".bias", ".beta")):
            p[k] = np.zeros(shape, np.float32)
        elif k.endswith("_codebook.embed"):
            p[k] = rng.randn(*shape).astype(np.float32)
        else:
            p[k] = (rng.randn(*shape) * 0.05).astype(np.float32)
    p["dec.conv_post.weight"] *= 30.0
    if cfg.is_v2pro:
        p["sv_emb.weight"] *= 0.1
    return cfg, {k: jnp.asarray(v) for k, v in p.items()}


def write_sv_checkpoint(root, seed=6):
    """A full-width random ERes2NetV2 checkpoint where ``TTS`` looks for it
    (``root/sv/pretrained_eres2netv2w24s4ep4.ckpt``), a flat state dict
    written with ``torch.save`` as the published file is, with keys the
    forward pass never reads (BatchNorm ``num_batches_tracked``, a bias of
    the pooling head)."""
    from gsv_tts_tpu_torch.models import sv

    sd = sv.init_params(sv.SVConfig(), torch.Generator().manual_seed(seed))
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(7)
               for k in list(sd) if k.endswith("running_mean")})
    sd["seg_1.bias"] = torch.zeros(192)
    path = root / "sv" / "pretrained_eres2netv2w24s4ep4.ckpt"
    path.parent.mkdir(exist_ok=True)
    torch.save(sd, str(path))
    return str(path)


def tiny_hubert_dir(path, seed=2):
    """A HuBERT directory (``config.json`` + ``model.safetensors`` in the
    Hugging Face key layout) with random weights, written without
    ``transformers``."""
    from gsv_tts_tpu_torch.models.hubert import HubertConfig, init_params
    from gsv_tts_tpu_torch.utils.safetensors import save_file

    cfg = HubertConfig.from_dict(TINY_HUBERT)
    path.mkdir()
    (path / "config.json").write_text(json.dumps(cfg.to_dict()))
    save_file(init_params(cfg, torch.Generator().manual_seed(seed)),
              path / "model.safetensors")
    return str(path)


def save_wav_sine(path, seconds, freq, seed):
    from gsv_tts_tpu_torch.utils.audio_io import save_wav

    rng = np.random.RandomState(seed)
    sr = 32000
    t = np.arange(int(sr * seconds)) / sr
    wav = (0.3 * np.sin(2 * np.pi * freq * t) + 0.05 * rng.randn(len(t))).astype(np.float32)
    save_wav(str(path), wav, sr)
    return str(path)


def build_assets(root):
    """Write the tiny checkpoints, HuBERT directory and wavs under ``root``."""
    from gsv_tts_tpu.hparams import HParams
    from gsv_tts_tpu.loader import save_trained_gpt, save_trained_sovits

    cfg, tp = jax_t2s(0)
    save_trained_gpt(tp, cfg, str(root / "gpt"))
    _, sp = jax_sovits(1)
    save_trained_sovits(sp, HParams(HPS), str(root / "sovits"))
    return dict(root=root, gpt=str(root / "gpt"), sovits=str(root / "sovits"),
                hubert=tiny_hubert_dir(root / "chinese-hubert-base"),
                spk=save_wav_sine(root / "spk.wav", 0.7, 220, 3),
                prompt=save_wav_sine(root / "prompt.wav", 0.6, 330, 4))


# ---------------------------------------------------------------------------
# checkpoint I/O of the port
# ---------------------------------------------------------------------------

def test_safetensors_reader_matches_package(tmp_path):
    """The in-package reader returns what ``safetensors`` wrote, for every
    dtype the checkpoints use, and the writer's files read back in the
    ``safetensors`` package."""
    from safetensors.numpy import load_file as st_load, save_file as st_save
    from gsv_tts_tpu_torch.utils.safetensors import load_file, save_file

    rng = np.random.RandomState(0)
    arrays = {"a": rng.randn(3, 5).astype(np.float32), "b": rng.randn(7).astype(np.float16),
              "c": rng.randint(-5, 5, size=(2, 2, 2)).astype(np.int64),
              "d": np.zeros((0, 4), np.float32), "e": np.asarray(1.5, np.float32)}
    st_save(arrays, str(tmp_path / "x.safetensors"))
    got = load_file(tmp_path / "x.safetensors")
    assert set(got) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    bf = torch.randn(4, 3).to(torch.bfloat16)
    save_file({"w": bf, **{k: torch.from_numpy(v) for k, v in arrays.items()}},
              tmp_path / "y.safetensors")
    back = load_file(tmp_path / "y.safetensors")
    assert torch.equal(back["w"], bf)
    # numpy has no bfloat16, so the package reads back the other dtypes
    save_file({k: torch.from_numpy(v) for k, v in arrays.items()}, tmp_path / "z.safetensors")
    for k, v in st_load(str(tmp_path / "z.safetensors")).items():
        np.testing.assert_array_equal(v, arrays[k])


def test_safetensors_reader_rejects_bad_offsets(tmp_path):
    from gsv_tts_tpu_torch.utils.safetensors import load_file

    header = json.dumps({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 8]}}).encode()
    with open(tmp_path / "bad.safetensors", "wb") as f:
        f.write(len(header).to_bytes(8, "little") + header + b"\0" * 8)
    with pytest.raises(ValueError, match="inconsistent offsets"):
        load_file(tmp_path / "bad.safetensors")


def test_gpt_ckpt_and_safetensors_load_identically(tmp_path):
    """A training-format ``.ckpt`` (read with ``weights_only=True``) and the
    JAX-written safetensors directory give the port the same parameters."""
    from gsv_tts_tpu.loader import GPT_KEY_MAP, save_trained_gpt
    from gsv_tts_tpu.models import t2s as jt2s
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_gpt_weights

    cfg, tp = jax_t2s(5)
    save_trained_gpt(tp, cfg, str(tmp_path / "gpt"))
    inv = {new: old for old, new in GPT_KEY_MAP}
    weight = {}
    for k, v in jt2s.params_to_torch_state_dict(tp, cfg).items():
        t = torch.from_numpy(np.array(v))
        if k.startswith("t2s_transformer.blocks."):
            parts = k.split(".")
            weight[f"model.h.layers.{parts[2]}." + inv[".".join(parts[3:])]] = t
        else:
            weight["model." + k] = t
    config = json.loads((tmp_path / "gpt" / "config.json").read_text())
    torch.save({"config": config, "weight": weight}, str(tmp_path / "g.ckpt"))
    tcfg = Config(device="cpu", gpt_cache=[(1, 128)])
    a = get_gpt_weights(tmp_path / "gpt", tcfg).params
    b = get_gpt_weights(tmp_path / "g.ckpt", tcfg).params
    for k in ("text_emb", "audio_emb", "bert_proj_w", "predict_w", "audio_pos_alpha"):
        assert torch.equal(a[k], b[k]), k
    for la, lb in zip(a["layers"], b["layers"]):
        for k in la:
            assert torch.equal(la[k], lb[k]), k


def test_loader_missing_file_names_it(tmp_path):
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_gpt_weights, get_sovits_weights

    with pytest.raises(FileNotFoundError, match="s1v3.ckpt"):
        get_gpt_weights(tmp_path / "s1v3.ckpt", Config(device="cpu"))
    (tmp_path / "sov").mkdir()
    with pytest.raises(FileNotFoundError, match="hps.json"):
        get_sovits_weights(tmp_path / "sov", Config(device="cpu"))


def test_sovits_pth_header_versions(tmp_path):
    """The 2-byte version tag in place of the zip magic is read back
    (``load_sovits_raw``), and the weights arrive with weight norm folded."""
    from gsv_tts_tpu_torch.loader import load_sovits_raw
    from gsv_tts_tpu_torch.models.sovits import params_from_torch_state_dict

    v = torch.randn(4, 3, 5)
    g = torch.rand(4, 1, 1) + 0.5
    path = tmp_path / "m.pth"
    torch.save({"config": HPS, "weight": {"x.weight_v": v, "x.weight_g": g}}, str(path))
    raw = path.read_bytes()
    assert raw[:2] == b"PK"
    path.write_bytes(b"05" + raw[2:])
    sd, version = load_sovits_raw(str(path))
    assert version == "v2Pro"
    w = params_from_torch_state_dict(sd["weight"])["x.weight"]
    ref = g * v / torch.sqrt((v * v).sum(dim=(1, 2), keepdim=True))
    torch.testing.assert_close(w, ref, rtol=1e-6, atol=1e-6)


def test_loader_refuses_arbitrary_pickles(tmp_path):
    """A pickle that would run code on load is refused (weights_only)."""
    import pickle

    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_gpt_weights

    marker = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    with open(tmp_path / "evil.ckpt", "wb") as f:
        pickle.dump({"config": {}, "weight": Evil()}, f)
    with pytest.raises(Exception):
        get_gpt_weights(tmp_path / "evil.ckpt", Config(device="cpu"))
    assert not marker.exists()
