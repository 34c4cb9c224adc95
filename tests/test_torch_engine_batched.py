"""Continuous batching of the port's decode runtime
(``gsv_tts_tpu_torch/runtime/t2s_session.py:T2SEngine.generate_batched`` and
``generate_batched_stream``) against the JAX engine's XLA path on the same
key chain, on a fixture where slot refill, bucket escalation and tail
compaction (down to B=1, the K1 twin) all happen — mirrors
``test_flash_decode.py:338-384`` and ``test_t2s_parity.py:172-216``.

With ``top_k=1`` the chains are greedy, so the harvests are compared token
for token; float32 on both sides (summation order only, and no near-tie
flips a token on this fixture)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import jax_t2s
from test_torch_fused_step import SMALL, _jax_noise_chain
from test_torch_t2s import port_t2s
from test_torch_assets import one_torch_thread  # noqa: F401

GPT_CACHE = [(1, 128), (2, 128), (2, 256), (4, 128), (4, 256)]


def requests(cfg, n, seed):
    rng = np.random.RandomState(seed)
    xs = [rng.randint(1, cfg.phoneme_vocab_size, size=rng.randint(4, 12)).astype(np.int64)
          for _ in range(n)]
    ys = [rng.randint(0, cfg.vocab_size - 1, size=rng.randint(3, 8)).astype(np.int64)
          for _ in range(n)]
    berts = [(rng.randn(len(x), cfg.bert_dim) * 0.1).astype(np.float32) for x in xs]
    return xs, ys, berts


@pytest.fixture(scope="module")
def engines():
    from gsv_tts_tpu.runtime.t2s_session import T2SEngine as JEngine
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(1, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    jeng = JEngine(jp, cfg, gpt_cache=GPT_CACHE, dtype=jnp.float32, attn_impl="xla")
    peng = ps.T2SEngine(pp, pcfg, gpt_cache=GPT_CACHE)
    return cfg, jeng, peng


def test_generate_batched_matches_jax_with_refill_escalation_and_compaction(engines, monkeypatch):
    """Five requests on a four-slot wave: harvests and completion order equal
    the JAX engine's, with the same number of refills and compactions, and
    the port's steps go through the K2 twin (waves of 4 and 2) and the K1 twin
    (the compacted tail)."""
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jeng, peng = engines
    xs, ys, berts = requests(cfg, 5, seed=11)
    key = jax.random.PRNGKey(3)
    j0 = (jeng.refills, jeng.compactions)
    jpred, jidx = jeng.generate_batched(xs, ys, berts, top_k=1, rng=key)

    monkeypatch.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
    calls = {"k1": 0, "k2": 0}
    escalations = []
    for name, target in (("k1", "fused_decode_step_sample"),
                         ("k2", "fused_decode_step_sample_batched")):
        orig = getattr(ps, target)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(ps, target, counted)
    orig_escalate = peng._escalate
    monkeypatch.setattr(peng, "_escalate",
                        lambda st, s: escalations.append(s) or orig_escalate(st, s))
    p0 = (peng.refills, peng.compactions)
    ppred, pidx = peng.generate_batched(xs, ys, berts, top_k=1)

    assert pidx.tolist() == jidx.tolist() and sorted(pidx.tolist()) == list(range(5))
    for i, pt, jt in zip(pidx.tolist(), ppred, jpred):
        assert pt.dtype == np.int64
        np.testing.assert_array_equal(pt, np.asarray(jt), err_msg=f"request {i}")
    refills, compactions = peng.refills - p0[0], peng.compactions - p0[1]
    assert (refills, compactions) == (jeng.refills - j0[0], jeng.compactions - j0[1])
    assert refills >= 1 and compactions >= 1 and 256 in escalations
    assert calls["k2"] > 0 and calls["k1"] > 0
    st = peng.last_stats
    assert st["decode_steps"] > 0 and st["slot_steps"] >= st["decode_steps"]


@pytest.mark.parametrize("grouped", [False, True])
def test_generate_batched_stream_events_concatenate_to_generate_batched(engines, monkeypatch,
                                                                       grouped):
    """The stream's per-request events, concatenated, are ``generate_batched``'s
    harvest exactly (both forms of ``grouped``), tokens arrive incrementally,
    nothing at or past EOS is emitted, and they equal the JAX stream's
    events one for one."""
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jeng, peng = engines
    xs, ys, berts = requests(cfg, 5, seed=12)
    key = jax.random.PRNGKey(7)
    kw = dict(top_k=1)

    def flat(stream):
        for item in stream:
            if grouped:
                assert isinstance(item, list) and item
                yield from item
            else:
                yield item

    jevents = list(flat(jeng.generate_batched_stream(xs, ys, berts, rng=key, grouped=grouped,
                                                     **kw)))
    monkeypatch.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
    pevents = list(flat(peng.generate_batched_stream(xs, ys, berts, grouped=grouped, **kw)))
    monkeypatch.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
    ppred, pidx = peng.generate_batched(xs, ys, berts, **kw)

    assert len(pevents) == len(jevents)
    for (pi, pt, pd), (ji, jt, jd) in zip(pevents, jevents):
        assert (pi, pd) == (ji, jd)
        np.testing.assert_array_equal(pt, np.asarray(jt))
    acc, order = {}, []
    for i, toks, done in pevents:
        assert toks.dtype == np.int64 and cfg.eos not in toks.tolist()
        acc.setdefault(i, []).append(toks)
        if done:
            order.append(i)
    assert order == pidx.tolist()
    for i, p in zip(pidx.tolist(), ppred):
        np.testing.assert_array_equal(np.concatenate(acc[i]), p, err_msg=f"request {i}")
    assert sum(1 for _, _, done in pevents if not done) >= 5  # incremental emission


def test_refill_falls_back_to_single_slot_prefills_when_the_group_pad_overflows():
    """Two requests whose x/y splits are mismatched pad, as a group, past
    the only bucket although each fits alone: ``_refill_slots_prefill``
    takes one ``prefill_slot`` pass per request, and raises when a single
    request fits no bucket."""
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(2, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    eng = ps.T2SEngine(pp, pcfg, gpt_cache=[(2, 96)])
    rng = np.random.RandomState(0)

    def item(lx, ly):
        x = rng.randint(1, cfg.phoneme_vocab_size, size=lx)
        return x, rng.randint(0, cfg.vocab_size - 1, size=ly), np.zeros((lx, cfg.bert_dim))

    k, v = eng._alloc_cache(2, 96)
    a, b = item(40, 5), item(5, 40)  # each pads to 64+32 = 96 rows; together to 64+64
    assert ps.prompt_rows(a[0], a[1]) == 96
    xs, ys, bs, xl, yl = eng._pad_prompts([item(4, 4), item(4, 4)])
    gen = torch.Generator().manual_seed(0)
    state, _ = ps.prefill_batch(pp, pcfg, *eng._dev(xs, ys, bs, xl, yl), k, v,
                                eng._noise(gen, 2, cfg.vocab_size), ps.SampleArgs(use_prev=False),
                                False)
    state, batched = eng._refill_slots_prefill(state, [0, 1], [a, b],
                                               ps.SampleArgs(use_prev=False), gen)
    assert not batched
    assert state.kv_len.tolist() == [45, 45] and state.x_len.tolist() == [40, 5]
    state, batched = eng._refill_slots_prefill(state, [1, 0], [item(6, 4), item(9, 5)],
                                               ps.SampleArgs(use_prev=False), gen)
    assert batched and state.kv_len.tolist() == [14, 10]
    with pytest.raises(ValueError, match="no gpt_cache bucket"):
        eng._refill_slots_prefill(state, [0], [item(70, 30)], ps.SampleArgs(use_prev=False), gen)
