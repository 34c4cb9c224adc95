"""The port's training data pipeline and loops (``gsv_tts_tpu_torch/train_data.py``,
``train_loop.py``) as a whole, on the tiny shared assets, beside the JAX
package's: the manifest and the sample cache cross between the packages,
featurization through both facades gives the same samples, the batch order
for a seed is JAX's, the train state round-trips, a resumed run equals the
straight run bit for bit on the CPU, and an exported checkpoint loads in
both packages' ``TTS`` with equal params.

Tolerance for the featurized float features: rtol 2e-4, atol 2e-5 of each
array's largest entry (float32 HuBERT and STFT, summation order only);
phones, codes, waveforms and batch orders are exact."""
import json

import numpy as np
import pytest
import torch

from test_torch_assets import build_assets, save_wav_sine, text_modules_as_installed  # noqa: F401
from test_torch_assets import one_torch_thread, torch_threads  # noqa: F401

from gsv_tts_tpu import train_data as jdata
from gsv_tts_tpu import train_loop as jloop
from gsv_tts_tpu_torch import train_data, train_loop
from gsv_tts_tpu_torch.models import t2s as pt2s
from gsv_tts_tpu_torch.parallel.train import t2s_leaves

RTOL, ATOL = 2e-4, 2e-5
TEXTS = ["hello there.", "this is a test of training."]


def close(got, want, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()), err_msg=what)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    a = build_assets(tmp_path_factory.mktemp("models"))
    root = a["root"]
    a["clips"] = [save_wav_sine(root / "c0.wav", 0.9, 200, 7),
                  save_wav_sine(root / "c1.wav", 0.7, 260, 8)]
    (root / "train.list").write_text("".join(f"{c.split('/')[-1]}|spk|en|{t}\n"
                                             for c, t in zip(a["clips"], TEXTS)))
    return a


@pytest.fixture(scope="module")
def facades(assets):
    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    jtts = JaxTTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
                  dtype="float32")
    ptts = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
               device="cpu", seed=0)
    for tts in (jtts, ptts):
        tts.load_gpt_model(assets["gpt"])
        tts.load_sovits_model(assets["sovits"])
    return jtts, ptts


@pytest.fixture(scope="module")
def featurized(assets, facades):
    jtts, ptts = facades
    items = train_data.read_manifest(assets["root"] / "train.list")
    with torch_threads(1):
        port = (train_data.featurize(ptts, items), train_data.featurize_sovits(ptts, items))
    return dict(items=items, port=port,
                jax=(jdata.featurize(jtts, items), jdata.featurize_sovits(jtts, items)))


def test_read_manifest_matches_jax(tmp_path):
    (tmp_path / "a.wav").write_bytes(b"")
    lst = tmp_path / "train.list"
    lst.write_text("a.wav|spk0|ZH|你好，世界|带竖线\n/abs/b.wav|spk1|en|hello world\n\n",
                   encoding="utf-8")
    jl = tmp_path / "train.jsonl"
    jl.write_text(json.dumps({"wav": "a.wav", "text": "hi"}) + "\n"
                  + json.dumps({"wav": "/abs/c.wav", "text": "yo", "lang": "ja"}) + "\n")
    for path in (lst, jl):
        assert train_data.read_manifest(path) == jdata.read_manifest(path)
    assert train_data.read_manifest(lst)[0] == (str(tmp_path / "a.wav"), "你好，世界|带竖线", "zh")
    bad = tmp_path / "bad.list"
    bad.write_text("only|three|fields\n")
    with pytest.raises(ValueError, match="wav\\|speaker"):
        train_data.read_manifest(bad)


def test_featurize_matches_jax_facade(featurized):
    """``featurize`` (phones and RVQ codes exact, BERT features within
    tolerance) and ``featurize_sovits`` (ssl and spectrogram within
    tolerance, waveform and phones exact) through both facades."""
    (jt2s, jsov), (pt2s_, psov) = featurized["jax"], featurized["port"]
    assert len(pt2s_) == len(jt2s) == len(psov) == len(jsov) == 2
    for (jx, jy, jb), (px, py, pb) in zip(jt2s, pt2s_):
        np.testing.assert_array_equal(px, jx)
        np.testing.assert_array_equal(py, jy)
        assert px.dtype == py.dtype == np.int32 and len(py) > 10
        close(pb, jb, "bert")
    for j, p in zip(jsov, psov):
        assert len(p) == len(j) == 4
        close(p[0], j[0], "ssl")
        close(p[1], j[1], "spec")
        np.testing.assert_array_equal(p[2], j[2])
        np.testing.assert_array_equal(p[3], j[3])
        assert p[0].shape[-1] == p[1].shape[-1] and p[2].shape[-1] == p[1].shape[-1] * 320


def test_sample_cache_crosses_packages(tmp_path):
    """A cache the JAX package wrote loads in the port, and back."""
    rng = np.random.RandomState(0)
    samples = [(rng.randint(1, 50, n).astype(np.int32), rng.randint(0, 100, m).astype(np.int32),
                rng.randn(n, 1024).astype(np.float32) if bert else None)
               for n, m, bert in ((7, 11, True), (3, 5, False), (9, 2, True))]
    jdata.save_samples(tmp_path / "j.npz", samples)
    train_data.save_samples(tmp_path / "p.npz", samples)
    for back in (train_data.load_samples(tmp_path / "j.npz"),
                 jdata.load_samples(tmp_path / "p.npz")):
        assert len(back) == 3
        for s, b in zip(samples, back):
            np.testing.assert_array_equal(b[0], s[0])
            np.testing.assert_array_equal(b[1], s[1])
            assert (b[2] is None) == (s[2] is None)
            if s[2] is not None:
                np.testing.assert_array_equal(b[2], s[2])


def test_batch_order_matches_jax():
    """For each seed the port yields JAX's batches in JAX's order: t2s
    batches (with and without a dropped remainder, unshuffled) and SoVITS
    GAN batches."""
    from gsv_tts_tpu.models import sovits as jsv
    from gsv_tts_tpu.models.t2s import T2SConfig as JCfg
    from gsv_tts_tpu_torch.models import sovits as psv

    cfg = pt2s.T2SConfig(hidden_dim=64, embedding_dim=64, num_heads=4, num_layers=2,
                         vocab_size=101, phoneme_vocab_size=50, eos=100)
    jcfg = JCfg(**{f: getattr(cfg, f) for f in ("hidden_dim", "embedding_dim", "num_heads",
                                                 "num_layers", "vocab_size",
                                                 "phoneme_vocab_size", "eos")})
    rng = np.random.RandomState(1)
    samples = [(rng.randint(1, 50, rng.randint(3, 40)).astype(np.int32),
                rng.randint(0, 100, rng.randint(3, 60)).astype(np.int32), None)
               for _ in range(13)]
    for seed, drop in ((0, False), (3, False), (7, True), (None, False)):
        got = list(train_data.batches(cfg, samples, 4, seed=seed, drop_remainder=drop))
        want = list(jdata.batches(jcfg, samples, 4, seed=seed, drop_remainder=drop))
        assert len(got) == len(want) == (3 if drop else 4)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)
    spec_ch = 129
    sov = [(rng.randn(4, T).astype(np.float32), rng.randn(spec_ch, T).astype(np.float32),
            rng.randn(T * 4).astype(np.float32), rng.randint(1, 9, 5).astype(np.int32))
           for T in rng.randint(10, 40, 7)]
    pcfg = psv.SovitsConfig(spec_channels=spec_ch)
    jscfg = jsv.SovitsConfig(spec_channels=spec_ch)
    for seed in (0, 5):
        got = list(train_loop.sovits_batches(pcfg, sov, 3, 4, seed=seed))
        want = list(jloop.sovits_batches(jscfg, sov, 3, 4, seed=seed))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]), err_msg=k)


def test_train_state_roundtrip_and_mismatch(tmp_path):
    state = {"params": {"w": (torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) / 3),
                        "layers": [{"b": torch.randn(3)}]},
             "opt": {"w": {"step": torch.tensor(4.0), "exp_avg": torch.randn(2, 3)}},
             "step": 7}
    path = str(tmp_path / "st.npz")
    train_loop.save_train_state(path, state)
    template = {"params": {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
                           "layers": [{"b": torch.zeros(3)}]},
                "opt": {"w": {"step": torch.tensor(0.0), "exp_avg": torch.zeros(2, 3)}},
                "step": 0}
    back = train_loop.load_train_state(path, template)
    assert back["params"]["w"].dtype == torch.bfloat16 and back["step"] == 7
    assert torch.equal(back["params"]["w"], state["params"]["w"])
    assert torch.equal(back["params"]["layers"][0]["b"], state["params"]["layers"][0]["b"])
    assert torch.equal(back["opt"]["w"]["exp_avg"], state["opt"]["w"]["exp_avg"])
    assert sorted(np.load(path).files) == ["opt.w.exp_avg", "opt.w.step", "params.layers.0.b",
                                           "params.w", "step"]
    with pytest.raises(ValueError, match="does not match"):
        train_loop.load_train_state(path, {"params": {"w": template["params"]["w"]},
                                           "step": 0})
    bad = dict(template, params={"w": torch.zeros(3, 2, dtype=torch.bfloat16),
                                 "layers": [{"b": torch.zeros(3)}]})
    with pytest.raises(ValueError, match="shape"):
        train_loop.load_train_state(path, bad)


def test_finetune_needs_a_card_unless_told_otherwise(tmp_path):
    samples = [(np.arange(1, 6, dtype=np.int32), np.arange(7, dtype=np.int32), None)]
    cfg = pt2s.T2SConfig(hidden_dim=32, embedding_dim=32, num_heads=2, num_layers=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop.finetune_t2s(samples, cfg, str(tmp_path), total_steps=1)
    with pytest.raises(ValueError, match="no training samples"):
        train_loop.finetune_t2s([], cfg, str(tmp_path), total_steps=1, device="cpu")


@pytest.fixture(scope="module")
def trained(assets, facades, featurized, tmp_path_factory):
    """Both loops on the facade's featurized clips (each twice: four samples,
    two batches an epoch), straight and interrupted-then-resumed mid-epoch,
    both exporting; on one thread (:func:`torch_threads`)."""
    _, ptts = facades
    t2s_samples, sov_samples = (s * 2 for s in featurized["port"])
    gpt = ptts.gpt_models[assets["gpt"]]
    sov = ptts.sovits_models[assets["sovits"]]
    out = tmp_path_factory.mktemp("runs")
    quiet = dict(log_fn=lambda *_: None, ckpt_every=100, log_every=100, device="cpu")
    t2s_kw = dict(total_steps=5, batch_size=2, init_params=gpt.params, dtype=torch.float32,
                  peak_lr=1e-3, warmup_steps=2, **quiet)
    sov_kw = dict(total_steps=3, batch_size=2, init_params=sov.params, **quiet)
    runs = {}
    with torch_threads(1):
        for stage, run, samples, kw in (
                ("t2s", train_loop.finetune_t2s, t2s_samples, t2s_kw),
                ("sovits", train_loop.finetune_sovits, sov_samples, sov_kw)):
            args = (samples, gpt.cfg) if stage == "t2s" else (samples, sov.cfg, sov.hps)
            straight = run(*args, str(out / f"{stage}_a"), **kw)
            run(*args, str(out / f"{stage}_b"), max_steps_this_run=2, export=False, **kw)
            resumed = run(*args, str(out / f"{stage}_b"), **kw)
            runs[stage] = (straight, resumed, str(out / f"{stage}_a"))
    for state in out.glob("*/*_state.npz"):  # ~0.6 GB: the discriminators' AdamW moments
        state.unlink()
    return runs


def test_resumed_runs_equal_straight_runs(trained, facades, assets):
    """Interrupted after 2 steps and resumed (mid-epoch for t2s, the
    per-step generators re-seeded from (seed, step) for SoVITS): every param
    bit for bit; the frozen RVQ leaves are the loaded model's."""
    _, ptts = facades
    straight, resumed, _ = trained["t2s"]
    for (name, a), b in zip(t2s_leaves(straight).items(), t2s_leaves(resumed).values()):
        assert torch.equal(a, b), name
    loaded = ptts.gpt_models[assets["gpt"]].params
    assert not torch.equal(straight["predict_w"], loaded["predict_w"])
    straight, resumed, _ = trained["sovits"]
    assert set(straight) == set(resumed)
    for k in straight:
        assert torch.equal(straight[k], resumed[k]), k
    loaded = ptts.sovits_models[assets["sovits"]].params
    for k in loaded:
        if k.startswith(("quantizer.", "ssl_proj.")):
            assert torch.equal(straight[k], loaded[k]), k
    assert sum(not torch.equal(straight[k], loaded[k]) for k in loaded) > 50


def test_exports_load_in_both_packages(trained, assets):
    """The exported t2s and SoVITS directories load in both facades with the
    trained params; the port's loads serve ``infer``."""
    import jax

    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch import convert

    t2s_params, _, t2s_dir = trained["t2s"]
    sov_params, _, sov_dir = trained["sovits"]
    jtts = JaxTTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
                  dtype="float32")
    ptts = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
               device="cpu", seed=0)
    for tts in (jtts, ptts):
        tts.load_gpt_model(t2s_dir)
        tts.load_sovits_model(sov_dir)
    cfg = ptts.gpt_models[t2s_dir].cfg
    for params in (ptts.gpt_models[t2s_dir].params,
                   convert.t2s_from_jax(jax.tree.map(np.asarray,
                                                     jtts.gpt_models[t2s_dir].params), cfg)):
        for (name, a), b in zip(t2s_leaves(t2s_params).items(), t2s_leaves(params).values()):
            assert torch.equal(a.detach(), b), name
    jsov = jtts.sovits_models[sov_dir].params
    psov = ptts.sovits_models[sov_dir].params
    assert set(psov) == set(jsov) == set(sov_params)
    for k, v in sov_params.items():
        assert torch.equal(psov[k], v.detach()), k
        np.testing.assert_array_equal(np.asarray(jsov[k]), v.detach().numpy(), err_msg=k)
    with torch_threads(1):
        clip = ptts.infer(assets["spk"], assets["prompt"], "hello there.", "a test.", top_k=1)
    assert clip.audio_data.size > 0 and np.all(np.isfinite(clip.audio_data))
