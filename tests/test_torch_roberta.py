"""The featurizers against the JAX package: the port's CNRoberta BERT
(tokenizer, float32 and int8 encoders, the facade with and without
``featurizer_buckets``) and the bucketed HuBERT, on weights and inputs made
from seeds with numpy, loaded by both packages from the same directories.
from test_torch_assets import one_torch_thread  # noqa: F401
Float32 on the CPU: rtol 2e-4, atol 2e-5 unless stated."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

RTOL, ATOL = 2e-4, 2e-5

#: a small BERT: the encoder runs num_hidden_layers - 2 = 4 layers of width 32
SMALL_BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=6, num_attention_heads=4,
                  intermediate_size=64, max_position_embeddings=40)
#: BERT's special tokens, CJK (a rare-plane character and a compatibility
#: ideograph among them), ASCII words and ``##`` pieces, punctuation
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + list("你好中国人天气真不错的很")
         + ["\U00020000", "\U0002A700", "㐀", "豈", "\U0002F800"]
         + ["hello", "he", "##llo", "##l", "##o", "world", "wor", "##ld", "gpt", "-", "so",
            "##vi", "##ts", "cafe"] + list("，。！？,.!?"))


def bert_params(cfg, seed):
    """Float32 numpy weights in the Hugging Face key layout: N(0, 0.2)
    embeddings, matrices N(0, 0.2 · sqrt(32 / fan_in)) (0.2 at width 32:
    large enough that the layers' outputs differ from their inputs),
    N(1, 0.1) LayerNorm gains, N(0, 0.1) biases."""
    rng = np.random.RandomState(seed)
    D, I = cfg.hidden_size, cfg.intermediate_size

    def nrm(*shape, scale=0.2):
        return (rng.randn(*shape) * scale).astype(np.float32)

    p = {"embeddings.word_embeddings.weight": nrm(cfg.vocab_size, D),
         "embeddings.position_embeddings.weight": nrm(cfg.max_position_embeddings, D),
         "embeddings.token_type_embeddings.weight": nrm(cfg.type_vocab_size, D)}
    for pfx, n in [("embeddings.LayerNorm", D)] + [
            (f"encoder.layer.{i}.{nm}", D) for i in range(cfg.num_hidden_layers)
            for nm in ("attention.output.LayerNorm", "output.LayerNorm")]:
        p[pfx + ".weight"] = 1 + nrm(n, scale=0.1)
        p[pfx + ".bias"] = nrm(n, scale=0.1)
    for i in range(cfg.num_hidden_layers):
        for nm, n_out, n_in in (("attention.self.query", D, D), ("attention.self.key", D, D),
                                ("attention.self.value", D, D),
                                ("attention.output.dense", D, D), ("intermediate.dense", I, D),
                                ("output.dense", D, I)):
            p[f"encoder.layer.{i}.{nm}.weight"] = nrm(n_out, n_in, scale=0.2 * (32 / n_in) ** 0.5)
            p[f"encoder.layer.{i}.{nm}.bias"] = nrm(n_out, scale=0.1)
    return p


def write_bert_dir(path, cfg_dict=SMALL_BERT, seed=0, fmt="safetensors"):
    """A BERT directory both packages load: ``config.json``, ``vocab.txt`` and
    the weights under the published ``bert.`` prefix (with a pooler the
    featurizer never reads), as ``model.safetensors`` or
    ``pytorch_model.bin``."""
    from gsv_tts_tpu_torch.models.roberta import BertConfig
    from gsv_tts_tpu_torch.utils.safetensors import save_file

    cfg = BertConfig(**cfg_dict)
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(cfg.to_dict()))
    vocab = VOCAB + [f"[unused{i}]" for i in range(cfg.vocab_size - len(VOCAB))]
    (path / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    sd = {"bert." + k: torch.from_numpy(v) for k, v in bert_params(cfg, seed).items()}
    sd["bert.pooler.dense.weight"] = torch.zeros(cfg.hidden_size, cfg.hidden_size)
    if fmt == "safetensors":
        save_file(sd, path / "model.safetensors")
    else:
        torch.save(sd, str(path / "pytorch_model.bin"))
    return str(path)


def _ids(cfg, seed, B=3, T=17):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, 11:] = 0  # a padded row
    mask[2, 5:] = 0
    return ids, mask


def test_tokenizer_ids_match_jax(tmp_path):
    from gsv_tts_tpu.models.roberta import BertTokenizer as JTok
    from gsv_tts_tpu_torch.models.roberta import BertTokenizer, _is_cjk

    d = write_bert_dir(tmp_path / "bert")
    jtok, ptok = JTok(d + "/vocab.txt"), BertTokenizer(d + "/vocab.txt")
    texts = ["你好，中国人！", "今天天气真不错的。", "\U00020000㐀中\U0002A700好",
             "豈\U0002F800x", "Hello world, GPT-SoVITS!", "héllo wörld", "helllo cafés",
             "unknownword?", "a​b\x00c�", "你好hello世界world"]
    for t in texts:
        assert ptok.encode(t) == jtok.encode(t), t
        assert ptok.tokenize(t) == jtok.tokenize(t), t
    assert ptok.tokenize("hello world") == ["hello", "world"]
    assert ptok.tokenize("helllo") == ["he", "##l", "##llo"]  # ## pieces
    assert ptok.encode("\U00020000\U0002A700")[1:3] == [VOCAB.index("\U00020000"),
                                                         VOCAB.index("\U0002A700")]
    assert ptok.encode("x" * 600, max_length=8) == jtok.encode("x" * 600, max_length=8)
    for cp in (0x4E00, 0x9FFF, 0x3400, 0x20000, 0x2A700, 0x2B740, 0x2B820, 0xF900, 0x2F800):
        assert _is_cjk(cp)
    assert not _is_cjk(0x3041) and not _is_cjk(ord("a"))


def test_bert_hidden_minus3_matches_jax():
    from gsv_tts_tpu.models import roberta as jr
    from gsv_tts_tpu_torch.convert import roberta_params_from_jax
    from gsv_tts_tpu_torch.models import roberta as pr

    jcfg, pcfg = jr.BertConfig(**SMALL_BERT), pr.BertConfig(**SMALL_BERT)
    p = bert_params(pcfg, 1)
    ids, mask = _ids(pcfg, 2)
    want = np.asarray(jr.bert_hidden_minus3({k: jnp.asarray(v) for k, v in p.items()}, jcfg,
                                            jnp.asarray(ids), jnp.asarray(mask)))
    got = pr.bert_hidden_minus3(roberta_params_from_jax(p), pcfg, torch.as_tensor(ids),
                                torch.as_tensor(mask)).numpy()
    assert got.shape == (3, 17, 32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # only num_hidden_layers - 2 layers run: the last two never enter
    p2 = dict(p, **{k: v * 0 for k, v in p.items() if k.startswith("encoder.layer.5.")})
    again = pr.bert_hidden_minus3(roberta_params_from_jax(p2), pcfg, torch.as_tensor(ids),
                                  torch.as_tensor(mask)).numpy()
    np.testing.assert_array_equal(again, got)


def test_quantized_params_and_features_match_jax():
    """The int8 dict's weights and scales equal JAX's bit for bit; the int8
    features (float64 products, exact) match JAX's int32 accumulation within
    1e-5."""
    from gsv_tts_tpu.models import roberta as jr
    from gsv_tts_tpu_torch.models import roberta as pr

    jcfg, pcfg = jr.BertConfig(**SMALL_BERT), pr.BertConfig(**SMALL_BERT)
    p = bert_params(pcfg, 3)
    jq = jr.quantize_bert_params({k: jnp.asarray(v) for k, v in p.items()}, jcfg)
    pq = pr.quantize_bert_params({k: torch.from_numpy(v) for k, v in p.items()}, pcfg)
    assert set(pq) == set(jq)
    n_q8 = 0
    for k, v in jq.items():
        assert pq[k].dtype == {np.dtype(np.int8): torch.int8,
                               np.dtype(np.float32): torch.float32}[np.asarray(v).dtype], k
        np.testing.assert_array_equal(pq[k].numpy(), np.asarray(v), err_msg=k)
        n_q8 += k.endswith("::q8")
    assert n_q8 == 6 * pcfg.num_hidden_layers
    ids, mask = _ids(pcfg, 4)
    want = np.asarray(jr.bert_hidden_minus3_q8(jq, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    got = pr.bert_hidden_minus3_q8(pq, pcfg, torch.as_tensor(ids), torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the int8 features sit near the float32 ones, not on them
    full = pr.bert_hidden_minus3({k: torch.from_numpy(v) for k, v in p.items()}, pcfg,
                                 torch.as_tensor(ids), torch.as_tensor(mask)).numpy()
    rel = np.linalg.norm(got.numpy() - full) / np.linalg.norm(full)
    assert 1e-4 < rel < 5e-2


def test_q8_linear_is_exact_past_float32():
    """Int8 products over K=4096 reach 4096 · 127² > 2^24, past float32's
    exact integers: the float64 product accumulates them exactly, so the
    output is the exact integer sum rounded once to float32, as JAX's int32
    accumulation gives it."""
    from gsv_tts_tpu.models.roberta import _q8_linear as jax_q8
    from gsv_tts_tpu_torch.models.roberta import _q8_linear

    rng = np.random.RandomState(9)
    K = 4096
    x = rng.randint(100, 128, size=(3, K)).astype(np.float32)
    x[:, 0] = 127  # the row scale is 1: the activations quantize to themselves
    wq = rng.randint(100, 128, size=(K, 5)).astype(np.int8)
    exact = x.astype(np.int64) @ wq.astype(np.int64)
    assert exact.min() > 2 ** 24
    ones, zeros = np.ones(5, np.float32), np.zeros(5, np.float32)
    got = _q8_linear(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ones),
                     torch.from_numpy(zeros)).numpy()
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    want = np.asarray(jax_q8(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(ones),
                             jnp.asarray(zeros)))
    np.testing.assert_array_equal(got, want)


W2P = [{"word": list("你好中国人"), "ph": [2, 2, 2, 2, 2]},
       {"word": list("天气真不错"), "ph": [2, 1, 2, 2, 3]},
       {"word": ["\U00020000", "的", "很", "，"], "ph": [2, 2, 2, 1]}]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("buckets", [False, True])
def test_cnroberta_matches_jax_on_a_shared_directory(tmp_path, buckets, quant):
    """Both facades load one directory (``bert.`` prefix, a pooler) and give
    the same phone-level rows; bucketed and exact agree in the port."""
    from gsv_tts_tpu.config import Config as JConfig
    from gsv_tts_tpu.models.roberta import CNRoberta as JBert
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.models.roberta import CNRoberta

    d = write_bert_dir(tmp_path / "bert", seed=5)
    jc = JConfig(dtype="float32", platform="cpu", featurizer_buckets=buckets)
    pc = Config(device="cpu", featurizer_buckets=buckets)
    jb, pb = JBert(d, jc, quant=quant), CNRoberta(d, pc, quant=quant)
    assert pb.buckets == buckets and pb.quant == quant
    ids, _ = pb.batch(["".join(w["word"]) for w in W2P])
    assert ids.shape == ((4, 32) if buckets else (3, 7))
    want, got = jb(W2P), pb(W2P)
    tol = dict(rtol=1e-5, atol=1e-5) if quant else dict(rtol=RTOL, atol=ATOL)
    for g, w, w2p in zip(got, want, W2P):
        assert g.dtype == np.float32 and g.shape == (sum(w2p["ph"]), 32)
        np.testing.assert_allclose(g, np.asarray(w), **tol)
    exact = CNRoberta(d, Config(device="cpu"), quant=quant)(W2P)
    for g, e in zip(got, exact):
        np.testing.assert_allclose(g, e, **tol)


def test_cnroberta_reads_pytorch_model_bin(tmp_path):
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.models.roberta import CNRoberta

    a = CNRoberta(write_bert_dir(tmp_path / "a", seed=6), Config(device="cpu"))
    b = CNRoberta(write_bert_dir(tmp_path / "b", seed=6, fmt="bin"), Config(device="cpu"))
    assert set(a.params) == set(b.params) and not any(k.startswith("pooler") for k in a.params)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "config.json").write_text(json.dumps(SMALL_BERT))
    (tmp_path / "c" / "vocab.txt").write_text("[UNK]\n")
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        CNRoberta(tmp_path / "c", Config(device="cpu"))


# ---------------------------------------------------------------------------
# HuBERT under featurizer_buckets
# ---------------------------------------------------------------------------

TINY_HUBERT = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                   intermediate_size=128, conv_dim=[32, 32, 32], conv_kernel=[10, 3, 2],
                   conv_stride=[5, 2, 2], num_conv_pos_embeddings=16,
                   num_conv_pos_embedding_groups=4, feat_extract_norm="group",
                   do_stable_layer_norm=False, conv_bias=False)


@pytest.fixture(scope="module")
def hubert_dir(tmp_path_factory):
    """A HuBERT directory from a numpy seed (Hugging Face key layout)."""
    from gsv_tts_tpu_torch.models.hubert import HubertConfig, init_params
    from gsv_tts_tpu_torch.utils.safetensors import save_file

    cfg = HubertConfig.from_dict(TINY_HUBERT)
    shapes = {k: v.shape for k, v in init_params(cfg, torch.Generator().manual_seed(0)).items()}
    rng = np.random.RandomState(7)
    sd = {k: torch.from_numpy((rng.randn(*s) * (0.3 if "conv_layers" in k else 0.1)
                               + (1.0 if "norm" in k and k.endswith("weight") else 0.0))
                              .astype(np.float32)) for k, s in shapes.items()}
    path = tmp_path_factory.mktemp("hubert")
    (path / "config.json").write_text(json.dumps(cfg.to_dict()))
    save_file(sd, path / "model.safetensors")
    return str(path)


def test_conv_out_length_matches_jax_and_the_convs(hubert_dir):
    from gsv_tts_tpu.models import hubert as jh
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.models import hubert as ph

    model = ph.CNHubert(hubert_dir, Config(device="cpu"))
    jcfg = jh.HubertConfig.from_json(hubert_dir + "/config.json")
    for T in (320, 1000, 3217, 8000):
        frames = ph.feature_extractor(model.params, model.cfg, torch.zeros(1, T)).shape[2]
        assert ph.conv_out_length(T, model.cfg) == frames == jh.conv_out_length(T, jcfg)
        assert ph.conv_out_length(T, model.cfg, 1) == jh.conv_out_length(T, jcfg, n_layers=1)


def test_masked_hubert_forward_matches_jax_and_the_exact_run(hubert_dir):
    """A zero-padded waveform through the masked forward: JAX's masked forward
    row for row, and the exact-shape run on the valid frames."""
    from gsv_tts_tpu.config import Config as JConfig
    from gsv_tts_tpu.models import hubert as jh
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.models import hubert as ph

    model = ph.CNHubert(hubert_dir, Config(device="cpu"))
    jmodel = jh.CNHubert(hubert_dir, JConfig(dtype="float32", platform="cpu"))
    T, pad_T = 3217, 4096
    wav = np.random.RandomState(1).randn(2, T).astype(np.float32)
    wav_p = np.pad(wav, ((0, 0), (0, pad_T - T)))
    nf, v0 = ph.conv_out_length(T, model.cfg), ph.conv_out_length(T, model.cfg, 1)
    got = ph.hubert_forward(model.params, model.cfg, torch.from_numpy(wav_p),
                            n_frames=torch.full((2,), nf), valid_l0=torch.full((2,), v0)).numpy()
    want = np.asarray(jh.hubert_forward(jmodel.params, jmodel.cfg, jnp.asarray(wav_p),
                                        n_frames=jnp.full((2,), nf, jnp.int32),
                                        valid_l0=jnp.full((2,), v0, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    exact = ph.hubert_forward(model.params, model.cfg, torch.from_numpy(wav)).numpy()
    assert exact.shape[1] == nf < got.shape[1]
    np.testing.assert_allclose(got[:, :nf], exact, rtol=1e-4, atol=1e-5)


def test_cnhubert_buckets_match_jax(hubert_dir):
    """The bucketed facade (0.5 s buckets, trimmed) against JAX's bucketed
    facade and the port's exact one, at two lengths of one bucket."""
    from gsv_tts_tpu.config import Config as JConfig
    from gsv_tts_tpu.models import hubert as jh
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.models import hubert as ph

    exact = ph.CNHubert(hubert_dir, Config(device="cpu"))
    bucketed = ph.CNHubert(hubert_dir, Config(device="cpu", featurizer_buckets=True))
    jb = jh.CNHubert(hubert_dir, JConfig(dtype="float32", platform="cpu",
                                         featurizer_buckets=True))
    assert bucketed.buckets and not exact.buckets and ph.CNHubert.BUCKET_SAMPLES == 8000
    rng = np.random.RandomState(3)
    for n in (8500, 8999):
        wav = rng.randn(n).astype(np.float32)
        got = bucketed(wav).numpy()
        np.testing.assert_allclose(got, np.asarray(jb(wav)), rtol=RTOL, atol=ATOL)
        want = exact(wav).numpy()
        assert got.shape == want.shape == (1, ph.conv_out_length(n, exact.cfg), 64)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
