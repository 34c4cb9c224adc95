"""K1, the whole B=1 decode step (``gsv_tts_tpu_torch/ops/fused_step.py``):
its plain twin against the JAX TPU kernel run in interpret mode and against
the JAX XLA decode path, and the decode runtime against JAX's.  The CUDA
kernel itself is held against the twin in ``test_torch_cuda.py``.

Tolerance: rtol=2e-4, atol=2e-5 in float32 (summation order only; the JAX
suite's bound, ``test_flash_decode.py:444-447``).  Token chains are
compared exactly over bounded prefixes: two float32 implementations can
still part at a near-tie deep in a chain."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import jax_t2s
from test_torch_t2s import port_t2s
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(vocab_size=101, phoneme_vocab_size=50, eos=100)


def caches(cfg, S, seed):
    rng = np.random.RandomState(seed)
    shape = (cfg.num_layers, 1, S, cfg.num_heads, cfg.head_dim)
    return (rng.randn(*shape).astype(np.float32) * 0.3,
            rng.randn(*shape).astype(np.float32) * 0.3)


def tok_history(cfg, S, n, seed):
    rng = np.random.RandomState(seed)
    buf = np.full((1, S), cfg.vocab_size, np.int32)
    buf[0, :n] = rng.randint(0, cfg.vocab_size - 1, size=n)
    return buf


@pytest.mark.parametrize("vocab,S,kv_len,last_tok,sa_kw,suppress_until", [
    (101, 128, 40, 17, dict(top_k=15, top_p=1.0, temperature=1.0, repetition_penalty=1.35), 10),
    (1025, 256, 200, 1024, dict(top_k=8, top_p=0.7, temperature=0.8, repetition_penalty=1.2), 0),
])
def test_k1_twin_matches_interpret_kernel(vocab, S, kv_len, last_tok, sa_kw, suppress_until):
    """Token, filtered row and both updated caches against the TPU kernel
    (``interpret=True``); ``last_tok=1024`` sits in the 1025-row table's
    last partial 8-row window."""
    from gsv_tts_tpu.ops.fused_step import fused_decode_step_sample as jk1
    from gsv_tts_tpu.runtime.t2s_session import SampleArgs as JSA
    from gsv_tts_tpu_torch.ops.fused_step import fused_decode_step_sample
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg, jp = jax_t2s(7, **({} if vocab == 1025 else SMALL))
    pcfg, pp = port_t2s(cfg, jp)
    kc, vc = caches(cfg, S, 1)
    buf = tok_history(cfg, S, 30, 2)
    V = cfg.vocab_size
    Vp = -(-V // 128) * 128
    g = np.random.RandomState(3).gumbel(size=(1, V)).astype(np.float32)
    sup = cfg.suppressed_tokens + (cfg.eos,)
    jtok, jrow, jkc, jvc = jk1(
        jp, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(buf), jnp.asarray([kv_len]),
        jnp.asarray([12]), jnp.asarray([last_tok]), jnp.asarray([30]), jnp.asarray([5]),
        jnp.asarray(np.pad(g, ((0, 0), (0, Vp - V)))), sa=JSA(**sa_kw),
        suppress_until=suppress_until, suppressed=sup, interpret=True)
    pk, pv, pb = torch.tensor(kc), torch.tensor(vc), torch.tensor(buf)
    ptok, prow, pk, pv = fused_decode_step_sample(
        pp, pk, pv, pb, kv_len, 12, torch.tensor([last_tok], dtype=torch.int32), 30, 5,
        torch.tensor(g), sa=SampleArgs(**sa_kw), suppress_until=suppress_until,
        suppressed=sup)
    assert int(ptok[0]) == int(jtok[0])
    np.testing.assert_allclose(prow.numpy(), np.asarray(jrow)[:, :V], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jkc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jvc), rtol=RTOL, atol=ATOL)
    assert int(pb[0, 30]) == int(ptok[0])  # the port appends in place
    assert np.array_equal(pb[0, :30].numpy(), buf[0, :30])


GRID_SA = [dict(top_k=15, top_p=1.0, temperature=1.0, repetition_penalty=1.35, use_prev=True),
           dict(top_k=8, top_p=0.7, temperature=0.8, repetition_penalty=1.2, use_prev=True),
           dict(top_k=3, top_p=0.95, temperature=1.3, repetition_penalty=1.0, use_prev=False)]


@pytest.mark.parametrize("sa_kw", GRID_SA)
@pytest.mark.parametrize("suppress_until,step_idx", [(0, 5), (10, 5), (10, 20)])
def test_k1_twin_row_matches_sampling_ops(sa_kw, suppress_until, step_idx):
    """The twin's filtered row, after softmax, equals the JAX XLA chain
    (``transformer_decode_step`` + ``ops/sampling.logits_to_probs``) — the
    grid of ``test_flash_decode.py:412-418`` — and with zero noise the
    token is the most probable one."""
    from gsv_tts_tpu.models.t2s import transformer_decode_step
    from gsv_tts_tpu.ops import sampling
    from gsv_tts_tpu_torch.ops.fused_step import fused_decode_step_sample
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg, jp = jax_t2s(0, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    S, kv_len, x_len, last_tok = 128, 40, 12, 17
    kc, vc = caches(cfg, S, 7)
    buf = tok_history(cfg, S, 30, 7)
    tok, row, _, _ = fused_decode_step_sample(
        pp, torch.tensor(kc), torch.tensor(vc), torch.tensor(buf), kv_len, x_len,
        torch.tensor([last_tok], dtype=torch.int32), 30, step_idx,
        torch.zeros((1, cfg.vocab_size)), sa=SampleArgs(**sa_kw),
        suppress_until=suppress_until, suppressed=cfg.suppressed_tokens + (cfg.eos,))

    pe = jp["audio_pos_alpha"] * jp["pe"][kv_len - x_len]
    x = jnp.take(jp["audio_emb"], jnp.asarray([last_tok]), axis=0) + pe
    h, _, _ = transformer_decode_step(jp, cfg, x, jnp.asarray(kc), jnp.asarray(vc),
                                      jnp.asarray([kv_len]), "xla")
    logits = h @ jp["predict_w"]
    if suppress_until and step_idx < suppress_until:
        logits = logits.at[:, jnp.asarray(cfg.suppressed_tokens + (cfg.eos,))].set(-jnp.inf)
    probs_ref = sampling.logits_to_probs(
        logits, jnp.asarray(buf) if sa_kw["use_prev"] else None,
        temperature=sa_kw["temperature"], top_k=sa_kw["top_k"], top_p=sa_kw["top_p"],
        repetition_penalty=sa_kw["repetition_penalty"])
    np.testing.assert_allclose(torch.softmax(row, -1).numpy(), np.asarray(probs_ref),
                               rtol=RTOL, atol=ATOL)
    assert int(tok[0]) == int(np.argmax(np.asarray(probs_ref)))


def test_k1_twin_odd_bucket_matches_xla_step():
    """An odd cache length (S=200; the TPU kernel requires S % 128 == 0) and
    the last cache row: logits equal the JAX XLA step's, the K/V row lands
    at ``kv_len`` and nothing else in the cache moves."""
    from gsv_tts_tpu.models.t2s import transformer_decode_step
    from gsv_tts_tpu_torch.ops.fused_step import fused_decode_step_sample
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg, jp = jax_t2s(2)
    pcfg, pp = port_t2s(cfg, jp)
    S, kv_len, x_len = 200, 199, 20
    kc, vc = caches(cfg, S, 9)
    V = cfg.vocab_size
    for last_tok in (1017, 1024):  # both in the table's last partial 8-row window
        pk, pv = torch.tensor(kc), torch.tensor(vc)
        _, row, pk, pv = fused_decode_step_sample(
            pp, pk, pv, torch.full((1, S), V, dtype=torch.int32), kv_len, x_len,
            torch.tensor([last_tok], dtype=torch.int32), 0, 50, torch.zeros((1, V)),
            sa=SampleArgs(top_k=V, top_p=1.0, temperature=1.0, repetition_penalty=1.0,
                          use_prev=False))
        pe = jp["audio_pos_alpha"] * jp["pe"][kv_len - x_len]
        x = jnp.take(jp["audio_emb"], jnp.asarray([last_tok]), axis=0) + pe
        h, jkc, _ = transformer_decode_step(jp, cfg, x, jnp.asarray(kc), jnp.asarray(vc),
                                            jnp.asarray([kv_len]), "xla")
        np.testing.assert_allclose(row.numpy(), np.asarray(h @ jp["predict_w"]),
                                   rtol=RTOL, atol=ATOL, err_msg=f"tok {last_tok}")
        np.testing.assert_allclose(pk.numpy(), np.asarray(jkc), rtol=RTOL, atol=ATOL)
        assert np.array_equal(pk[:, :, :kv_len].numpy(), kc[:, :, :kv_len])


def test_k1_bounds_are_checked_not_clamped():
    from gsv_tts_tpu_torch.ops.fused_step import fused_decode_step_sample
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg, jp = jax_t2s(1, **SMALL)
    _, pp = port_t2s(cfg, jp)
    kc, vc = caches(cfg, 64, 0)
    buf = torch.full((1, 64), cfg.vocab_size, dtype=torch.int32)
    tok = torch.tensor([3], dtype=torch.int32)
    g = torch.zeros((1, cfg.vocab_size))
    common = dict(sa=SampleArgs())
    with pytest.raises(ValueError, match="kv_len=64 outside"):
        fused_decode_step_sample(pp, torch.tensor(kc), torch.tensor(vc), buf, 64, 0, tok, 0,
                                 1, g, **common)
    with pytest.raises(ValueError, match="positional index"):
        fused_decode_step_sample(pp, torch.tensor(kc), torch.tensor(vc), buf, 10, 11, tok, 0,
                                 1, g, **common)
    with pytest.raises(ValueError, match="gumbel"):
        fused_decode_step_sample(pp, torch.tensor(kc), torch.tensor(vc), buf, 10, 0, tok, 0,
                                 1, torch.zeros((1, 7)), **common)
    with pytest.raises(ValueError, match="top_k=0"):
        fused_decode_step_sample(pp, torch.tensor(kc), torch.tensor(vc), buf, 10, 0, tok, 0,
                                 1, g, sa=SampleArgs(top_k=0))
    with pytest.raises(ValueError, match="runs on CUDA"):
        fused_decode_step_sample(pp, torch.tensor(kc, device="meta"),
                                 torch.tensor(vc, device="meta"), buf, 10, 0, tok, 0, 1, g,
                                 **common)


def _jax_noise_chain(rng):
    """Replays the JAX engine's key chain: the prefill draws [1, V] from
    split(rng)[1]; each decode dispatch splits the state key and draws
    [n, 1, V] from the second half."""
    state = {"key": rng, "first": True}

    def gumbel_noise(shape, generator, device):
        key = state["key"]
        nxt, sub = jax.random.split(key)
        state["key"] = nxt
        return torch.as_tensor(np.array(jax.random.gumbel(sub, shape, jnp.float32)))

    return gumbel_noise


def test_decode_chunk_chain_matches_jax_xla_decode_chunk():
    """Port prefill + K1 twin decode chunks fed JAX's Gumbel tensors give
    JAX's XLA ``decode_chunk`` tokens, step for step, over four chunks."""
    from gsv_tts_tpu.runtime import t2s_session as js
    from gsv_tts_tpu_torch.runtime import t2s_session as ps
    from test_torch_t2s import prompt

    cfg, jp = jax_t2s(8, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    x, y, bert, lx, ly = prompt(cfg, 3, pad=(32, 32))
    S = 128
    shape = (cfg.num_layers, 1, S, cfg.num_heads, cfg.head_dim)
    rng = jax.random.PRNGKey(5)
    jsa = js.SampleArgs()
    jstate, jtok = js.prefill_batch(
        jp, cfg, jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32), jnp.asarray(bert),
        jnp.asarray([lx]), jnp.asarray([ly]), jnp.zeros(shape), jnp.zeros(shape), rng,
        jsa, True, "float32", "xla")
    noise = _jax_noise_chain(rng)
    pstate, ptok = ps.prefill_batch(
        pp, pcfg, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(bert), lx, ly,
        torch.zeros(shape), torch.zeros(shape), noise((1, cfg.vocab_size), None, None),
        ps.SampleArgs(), True)
    assert int(ptok[0]) == int(jtok[0])
    for _ in range(4):
        key = jnp.asarray(np.asarray(jstate.rng))  # decode_chunk donates the state
        jstate, jtoks = js.decode_chunk(jp, cfg, jstate, 5, jsa, 10, "float32", "xla")
        _, sub = jax.random.split(key)
        g = torch.as_tensor(np.asarray(jax.random.gumbel(sub, (5, 1, cfg.vocab_size))))
        pstate, ptoks = ps.decode_chunk(pp, pcfg, pstate, 5, ps.SampleArgs(), g, 10)
        assert np.array_equal(ptoks.numpy(), np.asarray(jtoks))
    assert np.array_equal(pstate.tok_buf.numpy(), np.asarray(jstate.tok_buf))
    assert pstate.kv_len == int(jstate.kv_len[0]) and pstate.buf_len == int(jstate.buf_len[0])
    np.testing.assert_allclose(pstate.k_cache.numpy(), np.asarray(jstate.k_cache),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stream_chunk", [None, 10])
def test_engine_generate_matches_jax_with_escalation(monkeypatch, stream_chunk):
    """``T2SEngine.generate`` end to end (suppression window, repetition
    penalty, the 96 → 128 bucket escalation and the full-cache stop)
    against the JAX engine's XLA path on the same key chain; exact over a
    30-token prefix (``test_flash_decode.py:489-517`` uses the same bound).
    With ``stream_chunk`` the yielded (tokens so far, final) pairs match
    too, over the same prefix."""
    from gsv_tts_tpu.runtime.t2s_session import T2SEngine as JEngine
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(1, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    rng = np.random.RandomState(9)
    x = rng.randint(1, 50, size=(12,))
    y = rng.randint(0, 100, size=(7,))
    bert = (rng.randn(12, cfg.bert_dim) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jout = JEngine(jp, cfg, gpt_cache=[(1, 96), (1, 128)], dtype=jnp.float32,
                   attn_impl="xla").generate(x, y, bert, rng=key, stream_chunk=stream_chunk)
    monkeypatch.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
    eng = ps.T2SEngine(pp, pcfg, gpt_cache=[(1, 96), (1, 128)])
    pout = eng.generate(x, y, bert, stream_chunk=stream_chunk)
    if stream_chunk is None:
        jout, pout = [(jout, True)], [(pout, True)]
    jout, pout = list(jout), list(pout)
    assert [f for _, f in pout] == [f for _, f in jout] and len(jout) > (stream_chunk or 0) // 5
    for (jt, _), (pt, _) in zip(jout, pout):
        jt, pt = np.asarray(jt).ravel(), pt.ravel()
        n = min(len(jt), len(pt), 30)
        np.testing.assert_array_equal(pt[:n], jt[:n])
    assert len(pout[-1][0].ravel()) >= 30
    assert eng.last_stats["decode_steps"] >= len(pout[-1][0].ravel())
