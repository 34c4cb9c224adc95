"""K2, the whole decode step for a wave of slots
(``gsv_tts_tpu_torch/ops/fused_step.py:fused_decode_step_sample_batched``):
its plain twin against the JAX TPU kernel run in interpret mode and against
the JAX XLA path; ``decode_chunk``'s dispatch (K1 / K2 / generic step with
K3b) and the slot operations of the decode runtime against JAX's.  The CUDA
kernels themselves are held against the twins in ``test_torch_cuda.py``.

Tolerance: rtol=2e-4, atol=2e-5 in float32 (summation order only; the JAX
suite's bound, ``test_flash_decode.py:322-335``).  Tokens are compared
exactly over short chains only: two float32 implementations can part at a
near-tie deep in a chain."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import jax_t2s
from test_torch_fused_step import SMALL, _jax_noise_chain
from test_torch_t2s import port_t2s
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
I32 = torch.int32


SA_GRID = [dict(top_k=15, top_p=1.0, temperature=1.0, repetition_penalty=1.35, use_prev=True),
           dict(top_k=8, top_p=0.7, temperature=0.8, repetition_penalty=1.2, use_prev=True),
           dict(top_k=3, top_p=0.95, temperature=1.3, repetition_penalty=1.0, use_prev=False)]


def wave(cfg, B, S, seed, last=None):
    """Ragged wave state from a numpy seed: slot 0 is frozen (kv_len = 0 <
    x_len), the last slot feeds token V-1."""
    rng = np.random.RandomState(seed)
    L, H, Dh, V = cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.vocab_size
    kc = rng.randn(L, B, S, H, Dh).astype(np.float32) * 0.3
    vc = rng.randn(L, B, S, H, Dh).astype(np.float32) * 0.3
    kv_len = rng.randint(8, S - 1, size=B).astype(np.int32)
    x_len = rng.randint(1, 8, size=B).astype(np.int32)
    kv_len[0], x_len[0] = 0, 5
    kv_len[-1] = S - 1  # the cache's last row
    buf_len = np.minimum(kv_len, rng.randint(0, 40, size=B)).astype(np.int32)
    tok_buf = np.full((B, S), V, np.int32)
    for b in range(B):
        tok_buf[b, :buf_len[b]] = rng.randint(0, V - 1, size=buf_len[b])
    last_tok = rng.randint(0, V, size=B).astype(np.int32)
    last_tok[-1] = V - 1 if last is None else last
    step_idx = rng.randint(0, 20, size=B).astype(np.int32)
    return dict(kc=kc, vc=vc, tok_buf=tok_buf, kv_len=kv_len, x_len=x_len, last_tok=last_tok,
                buf_len=buf_len, step_idx=step_idx)


def port_step(pp, w, g, sa_kw, suppress_until, sup):
    from gsv_tts_tpu_torch.ops.fused_step import fused_decode_step_sample_batched
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    t = {k: torch.tensor(v) for k, v in w.items()}
    tok, row, kc, vc = fused_decode_step_sample_batched(
        pp, t["kc"], t["vc"], t["tok_buf"], t["kv_len"], t["x_len"], t["last_tok"],
        t["buf_len"], t["step_idx"], torch.tensor(g), sa=SampleArgs(**sa_kw),
        suppress_until=suppress_until, suppressed=sup)
    return tok.numpy(), row.numpy(), kc.numpy(), vc.numpy(), t["tok_buf"].numpy()


@pytest.mark.parametrize("B,vocab,S,sa_kw,suppress_until", [
    (2, 101, 128, SA_GRID[0], 10),
    (4, 1025, 256, SA_GRID[1], 0),
    (6, 101, 128, SA_GRID[2], 10),
])
def test_k2_twin_matches_interpret_kernel(B, vocab, S, sa_kw, suppress_until):
    """Tokens, filtered rows [B, V] and both updated caches (each slot's K/V
    row appended at its own ragged ``kv_len[b]``) against the TPU kernel
    (``interpret=True``), with a frozen slot, a slot on the cache's last row
    and ``last_tok = V-1``."""
    from gsv_tts_tpu.ops.fused_step import fused_decode_step_sample_batched as jk2
    from gsv_tts_tpu.runtime.t2s_session import SampleArgs as JSA

    cfg, jp = jax_t2s(7, **({} if vocab == 1025 else SMALL))
    _, pp = port_t2s(cfg, jp)
    w = wave(cfg, B, S, seed=B)
    V = cfg.vocab_size
    Vp = -(-V // 128) * 128
    g = np.random.RandomState(3).gumbel(size=(B, V)).astype(np.float32)
    sup = cfg.suppressed_tokens + (cfg.eos,)
    jtok, jrow, jkc, jvc = jk2(
        jp, jnp.asarray(w["kc"]), jnp.asarray(w["vc"]), jnp.asarray(w["tok_buf"]),
        jnp.asarray(w["kv_len"]), jnp.asarray(w["x_len"]), jnp.asarray(w["last_tok"]),
        jnp.asarray(w["buf_len"]), jnp.asarray(w["step_idx"]),
        jnp.asarray(np.pad(g, ((0, 0), (0, Vp - V)))), sa=JSA(**sa_kw),
        suppress_until=suppress_until, suppressed=sup, interpret=True)
    ptok, prow, pkc, pvc, pbuf = port_step(pp, w, g, sa_kw, suppress_until, sup)
    np.testing.assert_array_equal(ptok, np.asarray(jtok))
    np.testing.assert_allclose(prow, np.asarray(jrow)[:, :V], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pkc, np.asarray(jkc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pvc, np.asarray(jvc), rtol=RTOL, atol=ATOL)
    for b in range(B):
        n = w["kv_len"][b]
        assert np.array_equal(pkc[:, b, :n], w["kc"][:, b, :n])  # history untouched
        assert not np.array_equal(pkc[:, b, n], w["kc"][:, b, n])  # the appended row
        assert pbuf[b, w["buf_len"][b]] == ptok[b]  # the port appends in place


@pytest.mark.parametrize("sa_kw", SA_GRID)
@pytest.mark.parametrize("suppress_until", [0, 10])
def test_k2_twin_rows_match_sampling_ops(sa_kw, suppress_until):
    """Per-row filtered logits, after softmax, equal the JAX XLA chain
    (``transformer_decode_step`` + ``ops/sampling.logits_to_probs``) with
    ragged lengths, histories and per-slot suppression — the grid of
    ``test_flash_decode.py:262-336`` — and with zero noise each token is its
    row's most probable one."""
    from gsv_tts_tpu.models.t2s import transformer_decode_step
    from gsv_tts_tpu.ops import sampling

    cfg, jp = jax_t2s(0, **SMALL)
    _, pp = port_t2s(cfg, jp)
    B, S, V = 3, 128, cfg.vocab_size
    w = wave(cfg, B, S, seed=7, last=99)
    sup = cfg.suppressed_tokens + (cfg.eos,)
    ptok, prow, pkc, pvc, _ = port_step(pp, w, np.zeros((B, V), np.float32), sa_kw,
                                        suppress_until, sup)

    kv_len, step_idx = jnp.asarray(w["kv_len"]), jnp.asarray(w["step_idx"])
    pe_idx = jnp.maximum(kv_len - jnp.asarray(w["x_len"]), 0)
    xin = jnp.take(jp["audio_emb"], jnp.asarray(w["last_tok"]), axis=0) \
        + jp["audio_pos_alpha"] * jp["pe"][pe_idx]
    h, jkc, jvc = transformer_decode_step(jp, cfg, xin, jnp.asarray(w["kc"]),
                                          jnp.asarray(w["vc"]), kv_len, "xla")
    logits = (h @ jp["predict_w"]).astype(jnp.float32)
    if suppress_until:
        ids = jnp.asarray([s for s in sup if s < V])
        logits = jnp.where((step_idx < suppress_until)[:, None],
                           logits.at[:, ids].set(-jnp.inf), logits)
    probs_ref = np.asarray(sampling.logits_to_probs(
        logits, jnp.asarray(w["tok_buf"]) if sa_kw["use_prev"] else None,
        temperature=sa_kw["temperature"], top_k=sa_kw["top_k"], top_p=sa_kw["top_p"],
        repetition_penalty=sa_kw["repetition_penalty"]))
    np.testing.assert_allclose(torch.softmax(torch.tensor(prow), -1).numpy(), probs_ref,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ptok, np.argmax(probs_ref, axis=-1))
    np.testing.assert_allclose(pkc, np.asarray(jkc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pvc, np.asarray(jvc), rtol=RTOL, atol=ATOL)


def test_k2_wrapper_checks_its_arguments():
    from gsv_tts_tpu_torch.ops.fused_step import (MAX_FUSED_B,
                                                  fused_decode_step_sample_batched as k2)
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg, jp = jax_t2s(1, **SMALL)
    _, pp = port_t2s(cfg, jp)
    w = {k: torch.tensor(v) for k, v in wave(cfg, 2, 64, seed=1).items()}
    g = torch.zeros((2, cfg.vocab_size))

    def call(**over):
        a = {**w, "g": g, **over}
        return k2(pp, a["kc"], a["vc"], a["tok_buf"], a["kv_len"], a["x_len"], a["last_tok"],
                  a["buf_len"], a["step_idx"], a["g"], sa=SampleArgs())

    with pytest.raises(ValueError, match="kv_len outside the cache"):
        call(kv_len=torch.tensor([3, 64], dtype=I32))
    with pytest.raises(ValueError, match=r"kv_len must be a \[2\] tensor"):
        call(kv_len=torch.tensor([3], dtype=I32))
    with pytest.raises(ValueError, match="gumbel"):
        call(g=torch.zeros((1, cfg.vocab_size)))
    big = MAX_FUSED_B + 1
    with pytest.raises(ValueError, match=f"takes 1..{MAX_FUSED_B} slots"):
        k2(pp, torch.zeros((2, big, 64, 4, 32)), torch.zeros((2, big, 64, 4, 32)),
           torch.zeros((big, 64), dtype=I32), *([torch.zeros(big, dtype=I32)] * 5),
           torch.zeros((big, cfg.vocab_size)), sa=SampleArgs())
    with pytest.raises(ValueError, match="runs on CUDA"):
        call(kc=w["kc"].to("meta"), vc=w["vc"].to("meta"))


# ---------------------------------------------------------------------------
# decode runtime
# ---------------------------------------------------------------------------

def prompts(cfg, n, seed, lx=(6, 14), ly=(4, 10)):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randint(1, cfg.phoneme_vocab_size, size=rng.randint(*lx)).astype(np.int64)
        y = rng.randint(0, cfg.vocab_size - 1, size=rng.randint(*ly)).astype(np.int64)
        out.append((x, y, (rng.randn(len(x), cfg.bert_dim) * 0.1).astype(np.float32)))
    return out


def both_prefill(cfg, jp, pcfg, pp, items, B, S, sa_kw, key):
    """JAX and port ``prefill_batch`` of ``items`` into a B-slot wave (rows
    past the items are dead slots), fed the same Gumbel draw."""
    from gsv_tts_tpu.runtime import t2s_session as js
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    eng = ps.T2SEngine(pp, pcfg, gpt_cache=[(B, S)])
    xs, ys, bs, xl, yl = eng._pad_prompts(items, B)
    shape = (cfg.num_layers, B, S, cfg.num_heads, cfg.head_dim)
    jstate, jtok = js.prefill_batch(
        jp, cfg, jnp.asarray(xs, jnp.int32), jnp.asarray(ys, jnp.int32), jnp.asarray(bs),
        jnp.asarray(xl, jnp.int32), jnp.asarray(yl, jnp.int32), jnp.zeros(shape),
        jnp.zeros(shape), key, js.SampleArgs(**sa_kw), False, "float32", "xla")
    noise = _jax_noise_chain(key)
    pstate, ptok = ps.prefill_batch(
        pp, pcfg, torch.as_tensor(xs), torch.as_tensor(ys), torch.as_tensor(bs),
        torch.as_tensor(xl), torch.as_tensor(yl), torch.zeros(shape), torch.zeros(shape),
        noise((B, cfg.vocab_size), None, None), ps.SampleArgs(**sa_kw), False)
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    return jstate, pstate, noise


def assert_states_equal(pstate, jstate, frozen=()):
    """Counters exactly; ``last_tok``, ``tok_buf`` and the cache rows below
    ``kv_len`` for every slot not in ``frozen``."""
    keep = [b for b in range(pstate.kv_len.shape[0]) if b not in frozen]
    for name in ("kv_len", "x_len", "buf_len", "step_idx"):
        np.testing.assert_array_equal(getattr(pstate, name).numpy(),
                                      np.asarray(getattr(jstate, name)), err_msg=name)
    for name in ("last_tok", "tok_buf"):
        np.testing.assert_array_equal(getattr(pstate, name).numpy()[keep],
                                      np.asarray(getattr(jstate, name))[keep], err_msg=name)
    assert pstate.kv_len.dtype == I32 and pstate.tok_buf.dtype == I32
    for b, n in enumerate(np.asarray(jstate.kv_len)):
        if b in frozen:
            continue
        np.testing.assert_allclose(pstate.k_cache[:, b, :n].numpy(),
                                   np.asarray(jstate.k_cache)[:, b, :n], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(pstate.v_cache[:, b, :n].numpy(),
                                   np.asarray(jstate.v_cache)[:, b, :n], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,S,use_prev,path", [
    (1, 128, True, "k1"), (4, 128, False, "k2"), (4, 256, True, "k2"),
    (8, 200, False, "k2"),   # B and S outside the interpret kernel's gates
    (10, 128, False, "generic"), (9, 200, True, "generic")])
def test_decode_chunk_dispatch_matches_jax_xla_decode_chunk(monkeypatch, B, S, use_prev, path):
    """Port ``prefill_batch`` + ``decode_chunk`` (B=1 → K1 twin, 2..8 → K2
    twin, above → generic step + K3 twin), fed JAX's Gumbel tensors, give
    JAX's XLA ``decode_chunk`` tokens over a 1-step and two 5-step chunks,
    and the same counters and ``tok_buf`` exactly.  One wave slot is dead
    (1/1 dummy prompt) and, at B > 1, one is frozen before decoding.

    The frozen slot (``kv_len < x_len``) is held to its counters only: JAX's
    XLA step indexes the positional table with the negative ``kv_len -
    x_len`` (which wraps to the table's end) while JAX's K2 clamps it to 0;
    the port clamps on every path (``test_k2_twin_matches_interpret_kernel``
    holds the clamp against the TPU kernel), and a frozen slot's tokens are
    never harvested."""
    from gsv_tts_tpu.runtime import t2s_session as js
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(8, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    sa_kw = dict(top_k=15, top_p=1.0, temperature=1.0, repetition_penalty=1.35,
                 use_prev=use_prev)
    items = prompts(cfg, max(B - 1, 1), seed=B)
    key = jax.random.PRNGKey(5)
    jstate, pstate, noise = both_prefill(cfg, jp, pcfg, pp, items, B, S, sa_kw, key)
    if B > 1:
        jstate = js.freeze_slot(jstate, 1)
        pstate = ps.freeze_slot(pstate, 1)
    calls = {"k1": 0, "k2": 0, "generic": 0}
    for name, target in (("k1", "fused_decode_step_sample"),
                         ("k2", "fused_decode_step_sample_batched"),
                         ("generic", "_generic_step")):
        orig = getattr(ps, target)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(ps, target, counted)
    suppress_until = 10 if B == 1 else 0
    frozen = (1,) if B > 1 else ()
    live = [b for b in range(B) if b not in frozen]
    for n in (1, 5, 5):
        jstate, jtoks = js.decode_chunk(jp, cfg, jstate, n, js.SampleArgs(**sa_kw),
                                        suppress_until, "float32", "xla")
        pstate, ptoks = ps.decode_chunk(pp, pcfg, pstate, n, ps.SampleArgs(**sa_kw),
                                        noise((n, B, cfg.vocab_size), None, None),
                                        suppress_until)
        np.testing.assert_array_equal(ptoks.numpy()[live], np.asarray(jtoks)[live])
    assert calls == {**{k: 0 for k in calls}, path: 11}
    assert fused_step.fused_decode_step_sample_batched.launches == 0  # twins never count
    assert_states_equal(pstate, jstate, frozen=frozen)


def test_prefill_slot_and_slots_match_jax():
    """``prefill_batch`` of a 3-slot wave with a dead slot, then
    ``prefill_slot`` into the dead slot and ``prefill_slots`` into two slots
    at once, each against JAX on the same noise: first tokens, counters,
    ``tok_buf`` and the cache rows below each ``kv_len``; the untouched
    slot keeps its rows bit for bit."""
    from gsv_tts_tpu.runtime import t2s_session as js
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(9, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    B, S, V = 3, 128, cfg.vocab_size
    sa_kw = dict(top_k=5, use_prev=False)
    items = prompts(cfg, 5, seed=21)
    jstate, pstate, noise = both_prefill(cfg, jp, pcfg, pp, items[:2], B, S, sa_kw,
                                         jax.random.PRNGKey(2))
    assert_states_equal(pstate, jstate)
    eng = ps.T2SEngine(pp, pcfg, gpt_cache=[(B, S)])

    x, y, b = items[2]
    xp, yp, bp = eng._pad_prompt(x, y, b)
    jstate, jtok = js.prefill_slot(
        jp, cfg, jstate, 2, jnp.asarray(xp[None], jnp.int32), jnp.asarray(yp[None], jnp.int32),
        jnp.asarray(bp[None]), jnp.asarray(len(x), jnp.int32), jnp.asarray(len(y), jnp.int32),
        js.SampleArgs(**sa_kw), "float32", "xla")
    pstate, ptok = ps.prefill_slot(
        pp, pcfg, pstate, 2, torch.as_tensor(xp[None]), torch.as_tensor(yp[None]),
        torch.as_tensor(bp[None]), len(x), len(y), noise((1, V), None, None),
        ps.SampleArgs(**sa_kw))
    assert int(ptok) == int(jtok)
    assert_states_equal(pstate, jstate)

    keep = pstate.k_cache[:, 1].clone()
    xs, ys, bs, xl, yl = eng._pad_prompts(items[3:5])
    jstate, jtoks = js.prefill_slots(
        jp, cfg, jstate, jnp.asarray([2, 0], jnp.int32), jnp.asarray(xs, jnp.int32),
        jnp.asarray(ys, jnp.int32), jnp.asarray(bs), jnp.asarray(xl, jnp.int32),
        jnp.asarray(yl, jnp.int32), js.SampleArgs(**sa_kw), "float32", "xla")
    pstate, ptoks = ps.prefill_slots(
        pp, pcfg, pstate, [2, 0], torch.as_tensor(xs), torch.as_tensor(ys),
        torch.as_tensor(bs), xl, yl, noise((2, V), None, None), ps.SampleArgs(**sa_kw))
    np.testing.assert_array_equal(ptoks.numpy(), np.asarray(jtoks))
    assert_states_equal(pstate, jstate)
    assert torch.equal(pstate.k_cache[:, 1], keep)


@pytest.mark.parametrize("slot_map,new_S", [([0, 1, 2, -1, -1], 256),  # growth
                                            ([2, -1], 64),            # compaction
                                            ([1], 128)])              # down to B=1
def test_gather_slots_matches_jax(slot_map, new_S):
    from gsv_tts_tpu.runtime import t2s_session as js
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(10, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    jstate, pstate, _ = both_prefill(cfg, jp, pcfg, pp, prompts(cfg, 3, seed=4), 3, 128,
                                     dict(top_k=1, use_prev=False), jax.random.PRNGKey(0))
    jnew = js._gather_slots(jstate, jnp.asarray(slot_map, jnp.int32), new_S, cfg.vocab_size)
    pnew = ps._gather_slots(pstate, slot_map, new_S, cfg.vocab_size)
    assert pnew.k_cache.shape == jnew.k_cache.shape and pnew.tok_buf.shape == jnew.tok_buf.shape
    assert_states_equal(pnew, jnew)
    np.testing.assert_allclose(pnew.k_cache.numpy(), np.asarray(jnew.k_cache), rtol=RTOL,
                               atol=ATOL)
