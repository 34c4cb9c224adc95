"""``decode_chunk`` of the port's decode runtime
(``gsv_tts_tpu_torch/runtime/t2s_session.py``) against the single-step
wrappers it dispatches to (``ops/fused_step.py``: K1's and K2's, on the CPU
their plain twins): a chunk of n steps is n wrapper calls with the counters
advanced in between, whatever the chunking, and a slot keeps its tokens and
its cache rows when its wave is re-packed between chunks (K2 -> K1 -> K2, as
a compacting wave does).  float32, inputs from numpy seeds; the port alone,
no JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from gsv_tts_tpu_torch.models import t2s
from gsv_tts_tpu_torch.ops import fused_step
from gsv_tts_tpu_torch.runtime import t2s_session as ts

CFG = t2s.T2SConfig(hidden_dim=64, embedding_dim=64, num_heads=4, num_layers=2, vocab_size=101,
                    phoneme_vocab_size=50, eos=100)
SUP = CFG.suppressed_tokens + (CFG.eos,)
S = 96


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tensors here are tiny: one thread per test process, instead of
    every worker's threads competing for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return t2s.init_params(CFG, torch.Generator().manual_seed(7))


def wave_state(B, seed, room):
    """A ragged wave with ``room`` free cache rows in every slot; slot 0 of a
    wave of several is frozen (kv_len 0 below its x_len)."""
    rng = np.random.RandomState(seed)
    L, H, Dh, V = CFG.num_layers, CFG.num_heads, CFG.head_dim, CFG.vocab_size
    kv_len = rng.randint(8, S - room, size=B).astype(np.int32)
    x_len = rng.randint(1, 8, size=B).astype(np.int32)
    if B > 1:
        kv_len[0], x_len[0] = 0, 5
    buf_len = np.minimum(kv_len, rng.randint(0, 30, size=B)).astype(np.int32)
    tok_buf = np.full((B, S), V, np.int32)
    for b in range(B):
        tok_buf[b, :buf_len[b]] = rng.randint(0, V - 1, size=buf_len[b])

    def t(a):
        return torch.tensor(a)

    return ts.DecodeState(
        k_cache=t(rng.randn(L, B, S, H, Dh).astype(np.float32) * 0.3),
        v_cache=t(rng.randn(L, B, S, H, Dh).astype(np.float32) * 0.3),
        kv_len=t(kv_len), x_len=t(x_len), tok_buf=t(tok_buf), buf_len=t(buf_len),
        last_tok=t(rng.randint(0, V, size=B).astype(np.int32)),
        step_idx=t(rng.randint(0, 20, size=B).astype(np.int32)))


def clone(state):
    return dataclasses.replace(state, **{f.name: getattr(state, f.name).clone()
                                         for f in dataclasses.fields(state)})


def noise(n, B, seed):
    u = np.random.RandomState(seed).uniform(1e-6, 1 - 1e-6, size=(n, B, CFG.vocab_size))
    return torch.tensor(-np.log(-np.log(u)), dtype=torch.float32)


def single_steps(params, state, n, sa, g, suppress_until):
    """n calls of the single-step wrappers (K1's at B=1, K2's above), the
    counters advanced by hand; returns toks [B, n]."""
    B = state.tok_buf.shape[0]
    toks = torch.empty((n, B), dtype=torch.int32)
    for i in range(n):
        kw = dict(sa=sa, suppress_until=suppress_until, suppressed=SUP, tok_out=toks[i])
        if B == 1:
            fused_step.fused_decode_step_sample(
                params, state.k_cache, state.v_cache, state.tok_buf, int(state.kv_len),
                int(state.x_len), state.last_tok, int(state.buf_len), int(state.step_idx), g[i],
                **kw)
        else:
            fused_step.fused_decode_step_sample_batched(
                params, state.k_cache, state.v_cache, state.tok_buf, state.kv_len, state.x_len,
                state.last_tok, state.buf_len, state.step_idx, g[i], **kw)
        state.last_tok = toks[i]
        for c in (state.kv_len, state.buf_len, state.step_idx):
            c += 1
    return toks.T


def assert_same(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


@pytest.mark.parametrize("use_prev", [True, False])
@pytest.mark.parametrize("B", [1, 3, fused_step.MAX_FUSED_B])
def test_chunk_equals_single_step_calls(params, B, use_prev):
    """Tokens, cache rows, token buffers and counters of a chunk of n steps
    are those of n single-step wrapper calls."""
    n = 5
    sa = ts.SampleArgs(top_k=5, use_prev=use_prev)
    g = noise(n, B, seed=B)
    start = wave_state(B, seed=10 + B, room=n + 1)
    chunked, stepped = clone(start), clone(start)
    _, toks = ts.decode_chunk(params, CFG, chunked, n, sa, g, suppress_until=10)
    ref = single_steps(params, stepped, n, sa, g, 10)
    assert torch.equal(toks, ref)
    assert_same(chunked, stepped)
    assert not torch.equal(chunked.k_cache, start.k_cache)


@pytest.mark.parametrize("B", [1, 4])
def test_chunks_join_at_their_boundary(params, B):
    """Two chunks of 3 and 4 steps give what one chunk of 7 gives."""
    sa = ts.SampleArgs()
    g = noise(7, B, seed=20 + B)
    start = wave_state(B, seed=30 + B, room=8)
    whole, split = clone(start), clone(start)
    _, toks = ts.decode_chunk(params, CFG, whole, 7, sa, g, suppress_until=10)
    _, first = ts.decode_chunk(params, CFG, split, 3, sa, g[:3], suppress_until=10)
    _, second = ts.decode_chunk(params, CFG, split, 4, sa, g[3:], suppress_until=10)
    assert torch.equal(toks, torch.cat([first, second], dim=1))
    assert_same(whole, split)


def test_slot_keeps_its_tokens_and_rows_through_a_compacting_wave(params):
    """A slot decoded in a wave of three (K2's twin), then alone after the
    wave compacts to it (K1's twin), then in a wave of two again, against the
    same slot decoded alone all the way on the same noise: the same tokens,
    the same cache rows (float32: the batched products round like the single
    ones up to summation order)."""
    slot, n = 1, 4
    sa = ts.SampleArgs(top_k=1, repetition_penalty=1.0)  # greedy: the noise cannot flip a token
    V = CFG.vocab_size
    start = wave_state(3, seed=41, room=3 * n + 1)
    alone = ts._gather_slots(clone(start), [slot], S, V)
    g = noise(3 * n, 3, seed=42)
    _, want = ts.decode_chunk(params, CFG, alone, 3 * n, sa, g[:, slot:slot + 1])

    wave = clone(start)
    _, t1 = ts.decode_chunk(params, CFG, wave, n, sa, g[:n])
    wave = ts._gather_slots(wave, [slot], S, V)  # the tail compacts to B=1
    _, t2 = ts.decode_chunk(params, CFG, wave, n, sa, g[n:2 * n, slot:slot + 1])
    wave = ts._gather_slots(wave, [0, -1], S, V)  # and grows again, one slot dead
    _, t3 = ts.decode_chunk(params, CFG, wave, n, sa, g[2 * n:, slot:slot + 2])
    got = torch.cat([t1[slot:slot + 1], t2, t3[:1]], dim=1)
    assert torch.equal(got, want)
    kv = int(alone.kv_len)
    assert int(wave.kv_len[0]) == kv and int(wave.buf_len[0]) == int(alone.buf_len)
    assert torch.equal(wave.tok_buf[0], alone.tok_buf[0])
    torch.testing.assert_close(wave.k_cache[:, 0, :kv], alone.k_cache[:, 0, :kv], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(wave.v_cache[:, 0, :kv], alone.v_cache[:, 0, :kv], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("what", ["overrun", "noise shape", "top_k"])
def test_bad_argument_raises_before_the_first_step(params, what):
    """A chunk that cannot run raises before anything is written."""
    B = 1 if what == "overrun" else 3
    start = wave_state(B, seed=50, room=4)
    state = clone(start)
    sa = ts.SampleArgs(top_k=0) if what == "top_k" else ts.SampleArgs()
    n = S if what == "overrun" else 3
    g = noise(n, B + (what == "noise shape"), seed=51)
    with pytest.raises(ValueError):
        ts.decode_chunk(params, CFG, state, n, sa, g)
    assert_same(state, start)
