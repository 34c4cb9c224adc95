"""The port's t2s model and prefill against the JAX package (float32, CPU).

Tolerance: rtol=2e-4, atol=2e-5 throughout — both sides compute in float32
and differ only in summation order (the JAX suite's own bound for its
kernels against XLA, ``test_flash_decode.py``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import jax_t2s
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


def port_t2s(cfg, jp):
    from gsv_tts_tpu_torch.convert import t2s_from_jax
    from gsv_tts_tpu_torch.models.t2s import T2SConfig

    pcfg = T2SConfig(**{f: getattr(cfg, f) for f in (
        "hidden_dim", "embedding_dim", "num_heads", "num_layers", "vocab_size",
        "phoneme_vocab_size", "eos")})
    return pcfg, t2s_from_jax(jax.tree.map(np.asarray, jp), pcfg)


def prompt(cfg, seed, lx=13, ly=9, pad=(19, 23)):
    rng = np.random.RandomState(seed)
    x = np.zeros((1, pad[0]), np.int64)
    y = np.zeros((1, pad[1]), np.int64)
    x[0, :lx] = rng.randint(1, cfg.phoneme_vocab_size, size=lx)
    y[0, :ly] = rng.randint(0, cfg.vocab_size - 1, size=ly)
    bert = (rng.randn(1, pad[0], cfg.bert_dim) * 0.1).astype(np.float32)
    bert[:, lx:] = 0
    return x, y, bert, lx, ly


def test_sine_pe_table_identical():
    from gsv_tts_tpu.models.t2s import sine_pe_table as jpe
    from gsv_tts_tpu_torch.models.t2s import sine_pe_table as ppe

    np.testing.assert_array_equal(jpe(4000, 512), ppe(4000, 512))


def test_prefill_hidden_kv_and_logits_match_jax():
    from gsv_tts_tpu.models import t2s as jt2s
    from gsv_tts_tpu_torch.models import t2s as pt2s

    cfg, jp = jax_t2s(3)
    pcfg, pp = port_t2s(cfg, jp)
    x, y, bert, lx, ly = prompt(cfg, 0)
    jxy, jmask, jlast = jt2s.embed_prompt_batch(
        jp, cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(bert),
        jnp.asarray([lx]), jnp.asarray([ly]), jnp.float32)
    jh, jks, jvs = jt2s.transformer_prefill(jp, cfg, jxy, jmask)
    jlogits = jnp.sum(jh * jlast[:, :, None], axis=1) @ jp["predict_w"]

    pxy, pmask, plast = pt2s.embed_prompt_batch(
        pp, pcfg, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(bert),
        torch.tensor([lx]), torch.tensor([ly]), torch.float32)
    assert torch.equal(pmask, torch.as_tensor(np.asarray(jmask)))
    assert torch.equal(plast, torch.as_tensor(np.asarray(jlast)))
    ph, pks, pvs = pt2s.transformer_prefill(pp, pcfg, pxy, pmask)
    plogits = torch.nn.functional.linear(ph[:, lx + ly - 1], pp["predict_w"])
    n = lx + ly  # rows past the prompt are padding
    np.testing.assert_allclose(pxy.numpy(), np.asarray(jxy), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ph[:, :n].numpy(), np.asarray(jh)[:, :n], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pks[:, :, :n].numpy(), np.asarray(jks)[:, :, :n],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pvs[:, :, :n].numpy(), np.asarray(jvs)[:, :, :n],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(plogits.numpy(), np.asarray(jlogits), rtol=RTOL, atol=ATOL)


def test_embed_prompt_single_matches_jax():
    from gsv_tts_tpu.models import t2s as jt2s
    from gsv_tts_tpu_torch.models import t2s as pt2s

    cfg, jp = jax_t2s(4)
    pcfg, pp = port_t2s(cfg, jp)
    x, y, bert, lx, ly = prompt(cfg, 1, pad=(13, 9))
    jxy, jmask = jt2s.embed_prompt_single(jp, cfg, jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(bert), jnp.float32)
    pxy, pmask = pt2s.embed_prompt_single(pp, pcfg, torch.as_tensor(x), torch.as_tensor(y),
                                          torch.as_tensor(bert), torch.float32)
    np.testing.assert_allclose(pxy.numpy(), np.asarray(jxy), rtol=RTOL, atol=ATOL)
    assert np.array_equal(pmask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("S,kv_len", [(128, 40), (200, 199)])
def test_transformer_decode_step_matches_jax(S, kv_len):
    from gsv_tts_tpu.models import t2s as jt2s
    from gsv_tts_tpu_torch.models import t2s as pt2s

    cfg, jp = jax_t2s(5)
    pcfg, pp = port_t2s(cfg, jp)
    rng = np.random.RandomState(S)
    L, H, Dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
    kc = rng.randn(L, 1, S, H, Dh).astype(np.float32) * 0.3
    vc = rng.randn(L, 1, S, H, Dh).astype(np.float32) * 0.3
    x = rng.randn(1, cfg.hidden_dim).astype(np.float32)
    jh, jkc, jvc = jt2s.transformer_decode_step(jp, cfg, jnp.asarray(x), jnp.asarray(kc),
                                                jnp.asarray(vc), jnp.asarray([kv_len]), "xla")
    pk, pv = torch.tensor(kc), torch.tensor(vc)
    ph, pk, pv = pt2s.transformer_decode_step(pp, pcfg, torch.tensor(x), pk, pv,
                                              torch.tensor([kv_len]))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jkc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jvc), rtol=RTOL, atol=ATOL)


def test_prefill_batch_first_token_matches_jax():
    """Same Gumbel draw ⇒ same first token, token buffer and counters; the
    caches hold the same prompt rows."""
    from gsv_tts_tpu.runtime import t2s_session as js
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(6)
    pcfg, pp = port_t2s(cfg, jp)
    x, y, bert, lx, ly = prompt(cfg, 2, pad=(32, 32))
    S = 96
    shape = (cfg.num_layers, 1, S, cfg.num_heads, cfg.head_dim)
    rng = jax.random.PRNGKey(11)
    jsa = js.SampleArgs()
    state, jtok = js.prefill_batch(
        jp, cfg, jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32), jnp.asarray(bert),
        jnp.asarray([lx]), jnp.asarray([ly]), jnp.zeros(shape), jnp.zeros(shape), rng,
        jsa, True, "float32", "xla")
    _, sub = jax.random.split(rng)
    g = np.asarray(jax.random.gumbel(sub, (1, cfg.vocab_size), jnp.float32))
    pstate, ptok = ps.prefill_batch(
        pp, pcfg, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(bert), lx, ly,
        torch.zeros(shape), torch.zeros(shape), torch.as_tensor(g), ps.SampleArgs(), True)
    assert int(ptok[0]) == int(jtok[0])
    assert np.array_equal(pstate.tok_buf.numpy(), np.asarray(state.tok_buf))
    assert (pstate.kv_len, pstate.x_len, pstate.buf_len, pstate.step_idx) == (
        int(state.kv_len[0]), int(state.x_len[0]), int(state.buf_len[0]), int(state.step_idx[0]))
    n = lx + ly
    np.testing.assert_allclose(pstate.k_cache[:, :, :n].numpy(),
                               np.asarray(state.k_cache)[:, :, :n], rtol=RTOL, atol=ATOL)
