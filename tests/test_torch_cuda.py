"""Card-only tests of the port's CUDA kernels (marker ``cuda``): each kernel
against its plain PyTorch twin on the card.  They skip without a card.

This file imports neither JAX nor the other test modules, so it also runs
where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode; run on the GPU)")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_k1_cuda_kernel_matches_twin(cuda_device):
    """The CUDA kernel against its twin on the card (bf16, odd bucket,
    ``last_tok = V-1``, filters on); launches are counted."""
    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg = t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2)
    params = t2s.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                             device=cuda_device)
    params["k1_table"] = fused_step.K1Table(params)
    S, kv_len, V = 200, 150, cfg.vocab_size
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    kc = torch.randn((2, 1, S, 4, 32), generator=gen, device=cuda_device).to(torch.bfloat16)
    vc = torch.randn((2, 1, S, 4, 32), generator=gen, device=cuda_device).to(torch.bfloat16)
    buf = torch.randint(0, V, (1, S), generator=gen, device=cuda_device, dtype=torch.int32)
    last = torch.tensor([V - 1], dtype=torch.int32, device=cuda_device)
    g = torch.zeros((1, V), device=cuda_device)
    before = fused_step.fused_decode_step_sample.launches
    for sa in (SampleArgs(top_k=V, top_p=1.0, repetition_penalty=1.0), SampleArgs()):
        ka, va, ba = kc.clone(), vc.clone(), buf.clone()
        tok, row, _, _ = fused_step.fused_decode_step_sample(
            params, ka, va, ba, kv_len, 20, last, 100, 3, g, sa=sa, suppress_until=10,
            suppressed=cfg.suppressed_tokens + (cfg.eos,))
        kb, vb, bb = kc.clone(), vc.clone(), buf.clone()
        rtok, rrow, _, _ = fused_step.fused_decode_step_sample_ref(
            params, kb, vb, bb, kv_len, 20, last, 100, 3, g, sa=sa, suppress_until=10,
            suppressed=cfg.suppressed_tokens + (cfg.eos,))
        torch.cuda.synchronize()
        params["k1_table"].check()
        # two bf16 layers: the paths agree to float32 rounding unless a bf16
        # rounding flips, which moves an O(1) value by at most ~1e-2
        torch.testing.assert_close(row, rrow, rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(ka, kb, rtol=2e-2, atol=2e-2)
        assert int(tok) == int(rtok)
        assert int(ba[0, 100]) == int(tok)
    assert fused_step.fused_decode_step_sample.launches == before + 2


@pytest.mark.cuda
def test_decode_chunk_on_cuda_runs_the_kernel_and_follows_the_twin(cuda_device):
    """``decode_chunk`` on CUDA launches K1 once per step; fed the same noise,
    its tokens follow the twin's chain wherever the twin's top-2 margin is
    clear of the bf16 tolerance (checked step by step from one shared state)."""
    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.ops.sampling import gumbel_noise
    from gsv_tts_tpu_torch.runtime import t2s_session as ts

    cfg = t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2)
    params = t2s.init_params(cfg, torch.Generator().manual_seed(1), dtype=torch.bfloat16,
                             device=cuda_device)
    eng = ts.T2SEngine(params, cfg, gpt_cache=[(1, 64), (1, 96)], dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randint(1, 700, (1, 32), generator=gen, device=cuda_device)
    y = torch.randint(0, 1024, (1, 32), generator=gen, device=cuda_device)
    bert = torch.zeros((1, 32, cfg.bert_dim), device=cuda_device)
    k, v = eng._alloc_cache(1, 96)
    state, _ = ts.prefill_batch(eng.params, cfg, x, y, bert, 20, 15, k, v,
                                gumbel_noise((1, 1025), gen, cuda_device), ts.SampleArgs(),
                                True, torch.bfloat16)
    before = fused_step.fused_decode_step_sample.launches
    g = gumbel_noise((5, 1, 1025), gen, cuda_device)
    twin = ts.DecodeState(*(t.clone() for t in (
        state.k_cache, state.v_cache, state.kv_len, state.x_len, state.tok_buf, state.buf_len,
        state.last_tok, state.step_idx)))
    state, toks = ts.decode_chunk(eng.params, cfg, state, 5, ts.SampleArgs(), g, 10)
    assert fused_step.fused_decode_step_sample.launches == before + 5
    assert int(state.kv_len) == int(twin.kv_len) + 5
    assert int(toks.min()) >= 0 and int(toks.max()) < 1025
    for i in range(5):
        tok, row, *_ = fused_step.fused_decode_step_sample_ref(
            eng.params, twin.k_cache, twin.v_cache, twin.tok_buf, twin.kv_len, twin.x_len,
            toks[0, i - 1:i] if i else twin.last_tok, twin.buf_len, twin.step_idx, g[i],
            sa=ts.SampleArgs(), suppress_until=10, suppressed=cfg.suppressed_tokens + (cfg.eos,))
        top2 = torch.topk((row + g[i])[0], 2).values
        if float(top2[0] - top2[1]) > 0.1:
            assert int(tok) == int(toks[0, i]), i
        twin.tok_buf[0, twin.buf_len] = toks[0, i]  # follow the kernel's chain
        twin.kv_len += 1
        twin.buf_len += 1
        twin.step_idx += 1


@pytest.mark.cuda
@pytest.mark.parametrize("B", [2, 5, 8])
def test_k2_cuda_kernel_matches_twin(cuda_device, B):
    """K2 against its twin on the card (bf16, odd bucket, ragged ``kv_len``
    with a frozen slot and a slot on the last row, ``last_tok = V-1``,
    per-slot suppression, penalty on and off); launches are counted."""
    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg = t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2)
    params = t2s.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                             device=cuda_device)
    params["k1_table"] = fused_step.K1Table(params)
    S, V = 200, cfg.vocab_size
    gen = torch.Generator(device=cuda_device).manual_seed(B)
    kc = torch.randn((2, B, S, 4, 32), generator=gen, device=cuda_device).to(torch.bfloat16)
    vc = torch.randn((2, B, S, 4, 32), generator=gen, device=cuda_device).to(torch.bfloat16)
    buf = torch.randint(0, V, (B, S), generator=gen, device=cuda_device, dtype=torch.int32)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=cuda_device)

    kv_lens = ([0, S - 1, 63, 64, 150, 7, 128, 199])[:B]
    kv_len, x_len = i32(kv_lens), i32([30] + [min(20, n) for n in kv_lens[1:]])
    last = i32([5] * (B - 1) + [V - 1])
    buf_len, step_idx = i32([min(n, 100) for n in kv_lens]), i32([3 + 4 * b for b in range(B)])
    g = torch.zeros((B, V), device=cuda_device)
    sup = cfg.suppressed_tokens + (cfg.eos,)
    before = fused_step.fused_decode_step_sample_batched.launches
    for sa in (SampleArgs(top_k=V, top_p=1.0, repetition_penalty=1.0), SampleArgs(),
               SampleArgs(use_prev=False)):
        ka, va, ba = kc.clone(), vc.clone(), buf.clone()
        tok, row, _, _ = fused_step.fused_decode_step_sample_batched(
            params, ka, va, ba, kv_len, x_len, last, buf_len, step_idx, g, sa=sa,
            suppress_until=10, suppressed=sup)
        kb, vb, bb = kc.clone(), vc.clone(), buf.clone()
        rtok, rrow, _, _ = fused_step.fused_decode_step_sample_batched_ref(
            params, kb, vb, bb, kv_len, x_len, last, buf_len, step_idx, g, sa=sa,
            suppress_until=10, suppressed=sup)
        torch.cuda.synchronize()
        params["k1_table"].check()
        # two bf16 layers: the paths agree to float32 rounding unless a bf16
        # rounding flips, which moves an O(1) value by at most ~1e-2
        torch.testing.assert_close(row, rrow, rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(ka, kb, rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(va, vb, rtol=2e-2, atol=2e-2)
        top2 = torch.topk(rrow, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 0.1  # clear of the bf16 tolerance
        assert torch.equal(tok[clear], rtok[clear]) and bool(clear.any())
        for b, n in enumerate(kv_lens):  # only row kv_len[b] of each slot changed
            assert int(ba[b, int(buf_len[b])]) == int(tok[b])
            assert torch.equal(ka[:, b, :n], kc[:, b, :n])
            assert torch.equal(ka[:, b, n + 1:], kc[:, b, n + 1:])
    assert fused_step.fused_decode_step_sample_batched.launches == before + 3
    bad = kv_len.clone()
    bad[1] = S  # a device-side value out of range is flagged, not clamped
    fused_step.fused_decode_step_sample_batched(
        params, kc.clone(), vc.clone(), buf.clone(), bad, x_len, last, buf_len, step_idx, g,
        sa=SampleArgs())
    with pytest.raises(RuntimeError, match="kv_len outside the cache"):
        params["k1_table"].check()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3_cuda_kernels_match_twin(cuda_device, dtype):
    """K3a and K3b (every layer) against the twin on the card, ragged
    lengths around the 64-row split size, an odd cache length, and cache rows
    past ``kv_len`` poisoned with NaN (they must never be read)."""
    from gsv_tts_tpu_torch.ops import flash_decode as fd

    L, B, S, H, Dh = 3, 5, 200, 4, 32
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    kc = torch.randn((L, B, S, H, Dh), generator=gen, device=cuda_device).to(torch.bfloat16)
    vc = torch.randn((L, B, S, H, Dh), generator=gen, device=cuda_device).to(torch.bfloat16)
    q = torch.randn((B, H, Dh), generator=gen, device=cuda_device).to(dtype)
    lens = [0, 63, 64, 128, S - 1]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    refs = [fd.decode_attention_ref(q, kc[i], vc[i], kv_len) for i in range(L)]
    for b, n in enumerate(lens):
        kc[:, b, n + 1:] = float("nan")
        vc[:, b, n + 1:] = float("nan")
    # bf16: the twin rounds the probabilities, both round the output
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    before = (fd.flash_decode_attention.launches, fd.flash_decode_attention_layered.launches)
    for layer in range(L):
        out = fd.flash_decode_attention_layered(q, kc, vc, kv_len, layer)
        torch.testing.assert_close(out, refs[layer], rtol=tol, atol=tol)
        one = fd.flash_decode_attention(q, kc[layer], vc[layer], kv_len)
        assert torch.equal(one, out) and out.dtype == dtype
    torch.cuda.synchronize()
    fd.check(cuda_device)
    assert (fd.flash_decode_attention.launches, fd.flash_decode_attention_layered.launches) == (
        before[0] + L, before[1] + L)
    kv_len[2] = S
    fd.flash_decode_attention(q, kc[0], vc[0], kv_len)
    with pytest.raises(RuntimeError, match="kv_len outside"):
        fd.check(cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,path", [(4, "k2"), (10, "generic")])
def test_decode_chunk_wave_on_cuda_counts_its_kernels(cuda_device, B, path):
    """``decode_chunk`` of a wave on CUDA: K2 once per step for 2..8 slots,
    K3b once per layer and step above; counters advance on the device and
    the tokens land in ``tok_buf``."""
    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.ops import flash_decode, fused_step
    from gsv_tts_tpu_torch.ops.sampling import gumbel_noise
    from gsv_tts_tpu_torch.runtime import t2s_session as ts

    cfg = t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2)
    params = t2s.init_params(cfg, torch.Generator().manual_seed(1), dtype=torch.bfloat16,
                             device=cuda_device)
    eng = ts.T2SEngine(params, cfg, gpt_cache=[(B, 96)], dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randint(1, 700, (B, 32), generator=gen, device=cuda_device)
    y = torch.randint(0, 1024, (B, 32), generator=gen, device=cuda_device)
    bert = torch.zeros((B, 32, cfg.bert_dim), device=cuda_device)
    xl = torch.arange(10, 10 + B, device=cuda_device)
    yl = torch.arange(5, 5 + B, device=cuda_device)
    k, v = eng._alloc_cache(B, 96)
    sa = ts.SampleArgs(use_prev=False)
    state, _ = ts.prefill_batch(eng.params, cfg, x, y, bert, xl, yl, k, v,
                                gumbel_noise((B, 1025), gen, cuda_device), sa, False,
                                torch.bfloat16)
    state = ts.freeze_slot(state, 1)
    kv0, buf0 = state.kv_len.clone(), state.buf_len.clone()
    before = (fused_step.fused_decode_step_sample_batched.launches,
              flash_decode.flash_decode_attention_layered.launches)
    state, toks = ts.decode_chunk(eng.params, cfg, state, 5, sa,
                                  gumbel_noise((5, B, 1025), gen, cuda_device), 0,
                                  torch.bfloat16)
    eng._check_kernels()
    after = (fused_step.fused_decode_step_sample_batched.launches,
             flash_decode.flash_decode_attention_layered.launches)
    want = (5, 0) if path == "k2" else (0, 5 * cfg.num_layers)
    assert (after[0] - before[0], after[1] - before[1]) == want
    assert torch.equal(state.kv_len, kv0 + 5) and torch.equal(state.buf_len, buf0 + 5)
    assert toks.shape == (B, 5) and int(toks.min()) >= 0 and int(toks.max()) < 1025
    for b in range(B):
        assert torch.equal(state.tok_buf[b, int(buf0[b]): int(buf0[b]) + 5], toks[b])
    assert bool(torch.isfinite(state.k_cache.float()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Dh", [(torch.bfloat16, 32), (torch.float32, 32),
                                      (torch.bfloat16, 64), (torch.float32, 16),
                                      (torch.bfloat16, 128)])
def test_k4_cuda_kernel_matches_twin(cuda_device, dtype, Dh):
    """K4 against its twin on the card: strided views of one qkv product, a
    ragged batch (one phoneme, no audio rows, a pad tail, the 1/1 lengths of
    a dead slot), T not a multiple of the kernel's tiles."""
    from gsv_tts_tpu_torch.ops import flash_prefill as fp
    from gsv_tts_tpu_torch.ops import fused_step

    B, T, H = 4, 200, 4
    D = H * Dh
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    qkv = torch.randn((B, T, 3 * D), generator=gen, device=cuda_device).to(dtype)
    q, k, v = (t.reshape(B, T, H, Dh) for t in qkv.split(D, dim=-1))
    xl = torch.tensor([1, T, 70, 1], dtype=torch.int32, device=cuda_device)
    xyl = torch.tensor([T, T, 131, 2], dtype=torch.int32, device=cuda_device)
    ref = fp.flash_prefill_attention_ref(q, k, v, xl, xyl, num_heads=H)
    before = fp.flash_prefill_attention.launches
    out = fp.flash_prefill_attention(q, k, v, xl, xyl, num_heads=H)
    torch.cuda.synchronize()
    fused_step.check(cuda_device)
    assert fp.flash_prefill_attention.launches == before + 1
    assert out.shape == (B, T, D) and out.dtype == dtype
    # bf16: the twin rounds the probabilities, both round the output
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    xyl[2] = T + 1
    bad = fp.flash_prefill_attention(q, k, v, xl, xyl, num_heads=H)
    with pytest.raises(RuntimeError, match="xy_lens outside"):
        fused_step.check(cuda_device)
    assert bool(torch.isnan(bad[2].float()).all()) and bool(torch.isfinite(bad[3].float()).all())
    flat = torch.zeros(qkv.numel() + 1, dtype=dtype, device=cuda_device)
    off = (t.reshape(B, T, H, Dh) for t in flat[1:].view(B, T, 3 * D).split(D, dim=-1))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fp.flash_prefill_attention(*off, xl, xyl, num_heads=H)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 16, 17, 160, 1024])
@pytest.mark.parametrize("Dh", [8, 16, 32, 64, 128])
def test_k4_tensor_core_body_matches_twin(cuda_device, Dh, T):
    """K4's bf16 tensor-core body against the twin at every head dim of
    ``HEAD_DIMS``: strided views, a ragged B=4 batch whose lengths fall on
    and beside the 16- and 64-row tile edges, pad rows; two calls are
    bitwise equal.  (The float32 CUDA-core body is held to the twin by
    ``test_k4_cuda_kernel_matches_twin``.)"""
    from gsv_tts_tpu_torch.ops import flash_prefill as fp
    from gsv_tts_tpu_torch.ops import fused_step

    B, H = 4, 2
    D = H * Dh
    gen = torch.Generator(device=cuda_device).manual_seed(Dh * 1000 + T)
    qkv = torch.randn((B, T, 3 * D), generator=gen, device=cuda_device).to(torch.bfloat16)
    q, k, v = (t.reshape(B, T, H, Dh) for t in qkv.split(D, dim=-1))
    xl = torch.tensor([min(n, T) for n in (15, 64, 0, 17)], dtype=torch.int32,
                      device=cuda_device)
    xyl = torch.tensor([max(1, min(n, T)) for n in (63, 65, 16, T)], dtype=torch.int32,
                       device=cuda_device)
    ref = fp.flash_prefill_attention_ref(q, k, v, xl, xyl, num_heads=H)
    before = fp.flash_prefill_attention.launches
    out = fp.flash_prefill_attention(q, k, v, xl, xyl, num_heads=H)
    again = fp.flash_prefill_attention(q, k, v, xl, xyl, num_heads=H)
    torch.cuda.synchronize()
    fused_step.check(cuda_device)
    assert fp.flash_prefill_attention.launches == before + 2
    assert out.shape == (B, T, D) and out.dtype == torch.bfloat16
    assert torch.equal(out, again)
    # bf16: the twin rounds the normalised probabilities, the kernel the
    # unnormalised ones; both round the output (2^-9 relative each)
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)


def _k3_case(dev, B, S, lens, seed, L=2, H=4, Dh=32, dtype=torch.bfloat16):
    """Caches [L, B, S, H, Dh] with the rows past ``lens`` poisoned (NaN), the
    query, ``kv_len`` and the twin's output per layer (from clean caches)."""
    from gsv_tts_tpu_torch.ops import flash_decode as fd

    gen = torch.Generator(device=dev).manual_seed(seed)
    kc = torch.randn((L, B, S, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn((L, B, S, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    refs = [fd.decode_attention_ref(q, kc[i], vc[i], kv_len) for i in range(L)]
    for b, n in enumerate(lens):
        kc[:, b, n + 1:] = float("nan")
        vc[:, b, n + 1:] = float("nan")
    return q, kc, vc, kv_len, refs


@pytest.mark.cuda
@pytest.mark.parametrize("S", [200, 512, 1024])
@pytest.mark.parametrize("B", [1, 4, 12, 20])
def test_k3_one_launch_matches_twin(cuda_device, B, S):
    """K3b (and K3a, the same body) in one launch against the twin: ``kv_len``
    at 0, 63, 64 and S-1 (for B=1 one call each), rows past ``kv_len``
    poisoned, the cluster size ``cluster_plan`` picks; deterministic, K3a
    bitwise equal to K3b."""
    from gsv_tts_tpu_torch.ops import flash_decode as fd

    edges = [0, 63, 64, S - 1]
    gen = torch.Generator().manual_seed(B * S)
    rest = torch.randint(0, S, (max(B - 4, 0),), generator=gen).tolist()
    waves = [[n] for n in edges] if B == 1 else [(edges + rest)[:B]]
    for i, lens in enumerate(waves):
        q, kc, vc, kv_len, refs = _k3_case(cuda_device, B, S, lens, 100 * B + i)
        before = fd.flash_decode_attention_layered.launches
        for layer in range(kc.shape[0]):
            out = fd.flash_decode_attention_layered(q, kc, vc, kv_len, layer)
            torch.testing.assert_close(out, refs[layer], rtol=2e-2, atol=2e-2)
            assert torch.equal(out, fd.flash_decode_attention_layered(q, kc, vc, kv_len, layer))
            assert torch.equal(out, fd.flash_decode_attention(q, kc[layer], vc[layer], kv_len))
        torch.cuda.synchronize()
        fd.check(cuda_device)
        assert fd.flash_decode_attention_layered.launches == before + 2 * kc.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k3_every_cluster_size(cuda_device, monkeypatch, C, dtype):
    """Each cluster size forced once through ``cluster_plan`` (the one thing
    the wrapper picks it by): against the twin, with ranks whose share of
    the rows is empty (kv_len 0); a bad ``kv_len`` gives NaN in its slot
    alone and the flag."""
    from gsv_tts_tpu_torch.ops import flash_decode as fd

    monkeypatch.setattr(fd, "cluster_plan", lambda B, H, S, sms: C)
    fd.launch_plan.cache_clear()
    try:
        lens = [0, 63, 64, 777, 1023]
        q, kc, vc, kv_len, refs = _k3_case(cuda_device, len(lens), 1024, lens, C, dtype=dtype)
        metas = (fd.meta(t, t.data_ptr()) for t in (q, kc, vc, kv_len))
        assert fd.launch_plan(True, *metas, fd.sm_count(cuda_device)).C == C
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        for layer in range(kc.shape[0]):
            out = fd.flash_decode_attention_layered(q, kc, vc, kv_len, layer)
            torch.testing.assert_close(out, refs[layer], rtol=tol, atol=tol)
        torch.cuda.synchronize()
        fd.check(cuda_device)
        bad = kv_len.clone()
        bad[3] = 1024
        nan = fd.flash_decode_attention_layered(q, kc, vc, bad, 0)
        with pytest.raises(RuntimeError, match="kv_len outside"):
            fd.check(cuda_device)
        assert bool(torch.isnan(nan[3].float()).all())
        assert bool(torch.isfinite(nan[torch.arange(5, device=cuda_device) != 3].float()).all())
    finally:
        fd.launch_plan.cache_clear()


def _layer_fixture(dev, B, S, seed):
    from gsv_tts_tpu_torch.models import t2s

    cfg = t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=3)
    params = t2s.init_params(cfg, torch.Generator().manual_seed(seed), dtype=torch.bfloat16,
                             device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (cfg.num_layers, B, S, cfg.num_heads, cfg.head_dim)
    kc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn((B, cfg.hidden_dim), generator=gen, device=dev)
    return cfg, params, x, kc, vc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_cuda_kernel_matches_twin(cuda_device, dtype):
    """K5 against its twin on the card (odd bucket; first, middle and last
    row): hidden row and appended rows close, every other cache row
    untouched, ``kv_len`` read on the device; with the owner's pointer table
    and with the one the wrapper builds for a call."""
    from gsv_tts_tpu_torch.ops import fused_step

    S = 200
    cfg, params, x, kc, vc = _layer_fixture(cuda_device, 1, S, 3)
    x = x.to(dtype)
    before = fused_step.fused_decode_step.launches
    table = fused_step.LayerTable(params["layers"])
    for n in (0, 150, S - 1):
        kv_len = torch.tensor([n], dtype=torch.int32, device=cuda_device)
        ka, va = kc.clone(), vc.clone()
        h, _, _ = fused_step.fused_decode_step(x, params["layers"], ka, va, kv_len,
                                               table=table if n else None)
        kb, vb = kc.clone(), vc.clone()
        rh, _, _ = fused_step.fused_decode_step_ref(x, params["layers"], kb, vb, kv_len)
        torch.cuda.synchronize()
        fused_step.check(cuda_device)
        assert h.dtype == dtype and h.shape == x.shape
        # three bf16 layers: float32 rounding unless one bf16 rounding flips
        torch.testing.assert_close(h.float(), rh.float(), rtol=3e-2, atol=3e-2)
        torch.testing.assert_close(ka, kb, rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(va, vb, rtol=2e-2, atol=2e-2)
        keep = torch.ones(S, dtype=torch.bool, device=cuda_device)
        keep[n] = False
        assert torch.equal(ka[:, :, keep], kc[:, :, keep])
    assert fused_step.fused_decode_step.launches == before + 3
    with pytest.raises(ValueError, match="not built over these layers"):
        fused_step.fused_decode_step(x, [dict(lp) for lp in params["layers"]], kc, vc, kv_len,
                                     table=table)
    fused_step.fused_decode_step(x, params["layers"], kc, vc,
                                 torch.tensor([S], dtype=torch.int32, device=cuda_device),
                                 table=table)
    with pytest.raises(RuntimeError, match="kv_len outside the cache"):
        fused_step.check("cuda")  # no index: the current card's word
    fused_step.check(cuda_device)  # cleared by the raise


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 5, 8, 11, 12])
def test_k6_cuda_kernel_matches_twin(cuda_device, B):
    """K6 against its twin on the card for every layer index, ragged lengths
    (0 and S-1 among them), rows past ``kv_len`` poisoned; above 8 rows the
    wrapper launches the kernel in groups, and a group of 3, 5 or 7 runs with
    dead rows that touch nothing: ``x`` and ``kv_len`` are views whose next
    entry (NaN, and a length past the cache that would set the error bit) no
    row may read, and every cache entry but the appended rows stays bit for
    bit.  Layer 0 goes through a table the wrapper builds for the call, the
    others through one table over all layers."""
    from gsv_tts_tpu_torch.ops import fused_layer, fused_step

    S = 200
    cfg, params, x, kc, vc = _layer_fixture(cuda_device, B, S, 4)
    xbuf = torch.cat([x, torch.full_like(x[:1], float("nan"))]).to(torch.bfloat16)
    x = xbuf[:B]
    lens = ([0, S - 1, 63, 64, 150, 1, 128, 17, 90, 199, 33, 5])[:B]
    kvbuf = torch.tensor(lens + [S + 7], dtype=torch.int32, device=cuda_device)
    kv_len = kvbuf[:B]
    for b, n in enumerate(lens):
        kc[:, b, n:] = float("nan")
        vc[:, b, n:] = float("nan")
    table = fused_step.LayerTable(params["layers"])
    with pytest.raises(ValueError, match="not built over these layers"):
        fused_layer.fused_decode_layer(x, params["layers"][1], kc.clone(), vc.clone(), kv_len, 2,
                                       table=table)
    before = fused_layer.fused_decode_layer.launches
    for layer in range(cfg.num_layers):
        ka, va = kc.clone(), vc.clone()
        h, _, _ = fused_layer.fused_decode_layer(x, params["layers"][layer], ka, va, kv_len,
                                                 layer, table=table if layer else None)
        kb, vb = kc.clone().nan_to_num(0.0), vc.clone().nan_to_num(0.0)
        rh, _, _ = fused_layer.fused_decode_layer_ref(x, params["layers"][layer], kb, vb,
                                                      kv_len, layer)
        torch.cuda.synchronize()
        fused_step.check(cuda_device)  # (the length past the view was not read)
        assert h.shape == x.shape and bool(torch.isfinite(h.float()).all())
        torch.testing.assert_close(h.float(), rh.float(), rtol=2e-2, atol=2e-2)
        for name, got, ref, orig in (("K", ka, kb, kc), ("V", va, vb, vc)):
            want = orig.clone()
            for b, n in enumerate(lens):
                torch.testing.assert_close(got[layer, b, n], ref[layer, b, n], rtol=2e-2,
                                           atol=2e-2)
                want[layer, b, n] = got[layer, b, n]
            # bit for bit: the poisoned rows are NaN, which torch.equal never calls equal
            assert torch.equal(got.view(torch.int16), want.view(torch.int16)), name
    groups = -(-B // fused_step.MAX_FUSED_B)
    assert fused_layer.fused_decode_layer.launches == before + cfg.num_layers * groups


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("where", ["first", "last"])
def test_k5_persistent_matches_twin_at_the_flagship_width(cuda_device, dtype, where):
    """K5 at the flagship widths (24 layers, D=512, M=2048) at ``kv_len`` 0
    and S-1: the persistent kernel against the twin, one launch; only row
    ``kv_len`` of every layer changes."""
    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.ops import fused_step

    S = 1024
    n = 0 if where == "first" else S - 1
    cfg = t2s.T2SConfig()
    params = t2s.init_params(cfg, torch.Generator().manual_seed(5), dtype=torch.bfloat16,
                             device=cuda_device)
    table = fused_step.LayerTable(params["layers"])
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    shape = (cfg.num_layers, 1, S, cfg.num_heads, cfg.head_dim)
    kc = (torch.randn(shape, generator=gen, device=cuda_device) * 0.5).to(torch.bfloat16)
    vc = (torch.randn(shape, generator=gen, device=cuda_device) * 0.5).to(torch.bfloat16)
    x = torch.randn((1, cfg.hidden_dim), generator=gen, device=cuda_device).to(dtype)
    kv_len = torch.tensor([n], dtype=torch.int32, device=cuda_device)
    before = fused_step.fused_decode_step.launches
    ka, va = kc.clone(), vc.clone()
    h, _, _ = fused_step.fused_decode_step(x, params["layers"], ka, va, kv_len, table=table)
    kb, vb = kc.clone(), vc.clone()
    rh, _, _ = fused_step.fused_decode_step_ref(x, params["layers"], kb, vb, kv_len)
    torch.cuda.synchronize()
    table.check()
    assert fused_step.fused_decode_step.launches == before + 1
    assert h.dtype == dtype and h.shape == x.shape
    # 24 bf16 layers carry a flipped rounding forward (the smoke's tolerance)
    torch.testing.assert_close(h.float(), rh.float(), rtol=0.1, atol=0.1)
    torch.testing.assert_close(ka[:, 0, n].float(), kb[:, 0, n].float(), rtol=0.1, atol=0.1)
    torch.testing.assert_close(va[:, 0, n].float(), vb[:, 0, n].float(), rtol=0.1, atol=0.1)
    for a, orig in ((ka, kc), (va, vc)):
        assert torch.equal(a[:, 0, :n], orig[:, 0, :n])
        assert torch.equal(a[:, 0, n + 1:], orig[:, 0, n + 1:])


@pytest.mark.cuda
def test_k1_k6_k5_k1_interleaved_on_one_table_equal_their_lone_calls(cuda_device):
    """K1, K6 (one row, and a group of 4), K5 and K1 again, one after another
    on the one table the engine keeps: each result is bit for bit what the
    same call gives alone.  Every launch on the table's workspace takes its
    number from one count, so no launch can take a value another left under
    the same tag."""
    from gsv_tts_tpu_torch.ops import fused_layer, fused_step
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    S = 200
    cfg, params, kc1, vc1, buf, st = _step_fixture(cuda_device, "small", 1, S, seed=7)
    table = params["k1_table"]
    V, D, L = cfg.vocab_size, cfg.hidden_dim, cfg.num_layers
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    g = torch.randn((1, V), generator=gen, device=cuda_device)
    x1 = torch.randn((1, D), generator=gen, device=cuda_device).to(torch.bfloat16)
    x4 = torch.randn((4, D), generator=gen, device=cuda_device).to(torch.bfloat16)
    kc4 = torch.randn((L, 4, S, cfg.num_heads, cfg.head_dim), generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    kv1 = torch.tensor([150], dtype=torch.int32, device=cuda_device)
    kv4 = torch.tensor([0, 63, 150, S - 1], dtype=torch.int32, device=cuda_device)

    def k1():
        ka, va, ba = kc1.clone(), vc1.clone(), buf.clone()
        tok, row, _, _ = fused_step.fused_decode_step_sample(
            params, ka, va, ba, 150, 20, st["last"], 100, 3, g, sa=SampleArgs())
        return [tok.clone(), row.clone(), table.x[:D].clone(), ka, va, ba]

    def k6(x, kc, kv, layer):
        ka, va = kc.clone(), kc.flip(0).clone()
        h, _, _ = fused_layer.fused_decode_layer(x, params["layers"][layer], ka, va, kv, layer,
                                                 table=table)
        return [h, ka, va]

    def k5():
        ka, va = kc1.clone(), vc1.clone()
        h, _, _ = fused_step.fused_decode_step(x1, params["layers"], ka, va, kv1, table=table)
        return [h, ka, va]

    calls = [k1, lambda: k6(x1, kc1, kv1, 1), lambda: k6(x4, kc4, kv4, 2), k5, k1]
    alone = []
    for fn in calls:
        alone.append(fn())
        torch.cuda.synchronize()
    together = [fn() for fn in calls]
    torch.cuda.synchronize()
    table.check()
    for i, (a, b) in enumerate(zip(alone, together)):
        for u, v in zip(a, b):
            assert torch.equal(u, v), f"call {i}"


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k5", "k6 one row", "k6 group of 5"])
def test_k5_k6_bad_kv_len_sets_the_bit_without_a_hang(cuda_device, kernel):
    """A ``kv_len`` outside ``[0, S)`` sets the error bit and the launch
    comes back: that row is NaN, the other rows finite, and its cache is not
    written."""
    import time

    from gsv_tts_tpu_torch.ops import fused_layer, fused_step

    S = 200
    B = 5 if kernel == "k6 group of 5" else 1
    cfg, params, x, kc, vc = _layer_fixture(cuda_device, B, S, 9)
    x = x.to(torch.bfloat16)
    lens = [10, 150, S, 0, S - 1][:B] if B > 1 else [S]
    bad = lens.index(S)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    table = fused_step.LayerTable(params["layers"])
    ka, va = kc.clone(), vc.clone()
    if kernel == "k5":
        h, _, _ = fused_step.fused_decode_step(x, params["layers"], ka, va, kv_len, table=table)
    else:
        h, _, _ = fused_layer.fused_decode_layer(x, params["layers"][1], ka, va, kv_len, 1,
                                                 table=table)
    done = torch.cuda.Event()
    done.record()
    deadline = time.perf_counter() + 30
    while not done.query():
        assert time.perf_counter() < deadline, "the kernel did not come back"
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="kv_len outside the cache"):
        table.check()
    for b in range(B):
        assert bool(torch.isnan(h[b].float()).all()) if b == bad else \
            bool(torch.isfinite(h[b].float()).all())
    assert torch.equal(ka[:, bad], kc[:, bad]) and torch.equal(va[:, bad], vc[:, bad])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,B,per_call", [("k5", 1, 1), ("k6", 1, 1), ("k6", 4, 1),
                                               ("k6", 11, 2)])
def test_k5_k6_are_one_device_kernel_a_call_or_group(cuda_device, kernel, B, per_call):
    """By ``torch.profiler`` on the card: one device kernel (the persistent
    kernel) per K5 call and per K6 group of rows, and no other kernel."""
    from torch.profiler import ProfilerActivity, profile

    from gsv_tts_tpu_torch.ops import fused_layer, fused_step

    S, calls = 200, 6
    cfg, params, x, kc, vc = _layer_fixture(cuda_device, B, S, 10)
    x = x.to(torch.bfloat16)
    kv_len = torch.tensor([(37 * b) % S for b in range(B)], dtype=torch.int32,
                          device=cuda_device)
    table = fused_step.LayerTable(params["layers"])

    def call():
        if kernel == "k5":
            fused_step.fused_decode_step(x, params["layers"], kc, vc, kv_len, table=table)
        else:
            fused_layer.fused_decode_layer(x, params["layers"][2], kc, vc, kv_len, 2,
                                           table=table)

    call()
    torch.cuda.synchronize()
    for _ in range(3):  # (the profiler may lose a window's kernel events: take another)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if "CUDA" in str(getattr(e, "device_type", "")) and e.count > 0}
        if sum(kernels.values()) >= calls * per_call:
            break
    table.check()
    assert sum(kernels.values()) == calls * per_call, kernels
    assert all("decode_step_persistent" in k for k in kernels), kernels


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["flash", "fused", "fused_step"])
def test_engine_attn_impl_on_cuda_counts_its_kernels(cuda_device, impl):
    """``T2SEngine(attn_impl=...)`` on CUDA at B=1: ``"flash"`` launches K4
    per layer of the prefill and K3b per layer and step, ``"fused"`` K6 per
    layer and step, the default K1 per step; and ``transformer_decode_step``
    under ``"fused_step"`` launches K5."""
    import numpy as np

    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.ops import flash_decode, flash_prefill, fused_layer, fused_step
    from gsv_tts_tpu_torch.runtime import t2s_session as ts

    cfg = t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2)
    params = t2s.init_params(cfg, torch.Generator().manual_seed(1), dtype=torch.bfloat16,
                             device=cuda_device)
    eng = ts.T2SEngine(params, cfg, gpt_cache=[(1, 96)], dtype=torch.bfloat16, attn_impl=impl)
    fns = {"k1": fused_step.fused_decode_step_sample,
           "k3b": flash_decode.flash_decode_attention_layered,
           "k4": flash_prefill.flash_prefill_attention, "k5": fused_step.fused_decode_step,
           "k6": fused_layer.fused_decode_layer}
    before = {k: f.launches for k, f in fns.items()}
    rng = np.random.RandomState(0)
    toks = eng.generate(rng.randint(1, 700, 20), rng.randint(0, 1024, 9),
                        rng.randn(20, cfg.bert_dim).astype(np.float32),
                        generator=torch.Generator(device=cuda_device).manual_seed(3))
    steps, L = eng.last_stats["decode_steps"], cfg.num_layers
    got = {k: f.launches - before[k] for k, f in fns.items()}
    want = {"flash": dict(k1=0, k3b=L * steps, k4=L, k5=0, k6=0),
            "fused": dict(k1=0, k3b=0, k4=0, k5=0, k6=L * steps),
            "fused_step": dict(k1=steps, k3b=0, k4=0, k5=0, k6=0)}[impl]
    assert got == want and steps > 0 and toks.size > 0
    if impl == "fused_step":
        shape = (L, 1, 96, cfg.num_heads, cfg.head_dim)
        kc = torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
        x = torch.randn((1, cfg.hidden_dim), device=cuda_device).to(torch.bfloat16)
        kv_len = torch.tensor([0], dtype=torch.int32, device=cuda_device)
        h, _, _ = t2s.transformer_decode_step(eng.params, cfg, x, kc, kc.clone(), kv_len,
                                              "fused_step")
        assert fns["k5"].launches == before["k5"] + 1 and bool(torch.isfinite(h.float()).all())


# ---------------------------------------------------------------------------
# The persistent whole-step kernels (K1, K2) against their twin
# ---------------------------------------------------------------------------

def _step_fixture(dev, width, B, S, seed=0):
    """Parameters with their table and a random wave state at ragged
    ``kv_len`` (a frozen slot first, a slot on the cache's last row)."""
    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.ops import fused_step

    cfg = (t2s.T2SConfig() if width == "flagship" else
           t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=3,
                         mlp_ratio=2))
    params = t2s.init_params(cfg, torch.Generator().manual_seed(seed), dtype=torch.bfloat16,
                             device=dev)
    params["k1_table"] = fused_step.K1Table(params)
    L, H, Dh, V = cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.vocab_size
    gen = torch.Generator(device=dev).manual_seed(seed + B)
    kc = (torch.randn((L, B, S, H, Dh), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    vc = (torch.randn((L, B, S, H, Dh), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    buf = torch.randint(0, V, (B, S), generator=gen, device=dev, dtype=torch.int32)

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    kv_lens = [0, S - 1, 63, 64, 150, 7, 128, S - 2][:B] if B > 1 else [S - 1]
    x_lens = [30] + [min(20, n) for n in kv_lens[1:]] if B > 1 else [20]
    st = dict(kv_lens=kv_lens, x_lens=x_lens, kv=i32(kv_lens), x=i32(x_lens),
              last=i32(([1017] * B)[:B - 1] + [V - 1]),
              buf=i32([min(n, 100) for n in kv_lens]), step=i32([3 + 4 * b for b in range(B)]))
    return cfg, params, kc, vc, buf, st


def _run_step(fn_b1, fn_wave, params, kc, vc, buf, st, g, sa, sup):
    """One step from a copy of the state through K1's flavour (B=1, host
    counters) or K2's; returns (tok, row, k_cache, v_cache, tok_buf, hidden)."""
    ka, va, ba = kc.clone(), vc.clone(), buf.clone()
    B = kc.shape[1]
    kw = dict(sa=sa, suppress_until=10, suppressed=sup)
    if B == 1:
        tok, row, _, _ = fn_b1(params, ka, va, ba, st["kv_lens"][0], st["x_lens"][0], st["last"],
                               int(st["buf"][0]), int(st["step"][0]), g, **kw)
    else:
        tok, row, _, _ = fn_wave(params, ka, va, ba, st["kv"], st["x"], st["last"], st["buf"],
                                 st["step"], g, **kw)
    torch.cuda.synchronize()
    table = params["k1_table"]
    table.check()
    D = table.D
    return tok.clone(), row.clone(), ka, va, ba, table.x[:B * D].clone().reshape(B, D)


@pytest.mark.cuda
@pytest.mark.parametrize("width,S", [("small", 200), ("flagship", 1024)])
@pytest.mark.parametrize("B", [1, 2, 3, 4, 5, 6, 7, 8])
def test_persistent_step_matches_twin(cuda_device, width, S, B):
    """K1 (B=1) and K2 at every wave size: the persistent kernel against the
    twin at a small width (a partial last 64-row step, tokens 1017 and 1024)
    and at the flagship width; only row ``kv_len[b]`` of a slot's cache
    changes."""
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg, params, kc, vc, buf, st = _step_fixture(cuda_device, width, B, S)
    V = cfg.vocab_size
    g = torch.zeros((B, V), device=cuda_device)
    sup = cfg.suppressed_tokens + (cfg.eos,)
    # a few bf16 layers agree to float32 rounding unless a bf16 rounding
    # flips (~1e-2 on an O(1) value); 24 layers carry a flip forward (the
    # smoke's tolerance: 0.1 absolute)
    tol = 0.1 if width == "flagship" else 2e-2
    for sa in (SampleArgs(top_k=V, top_p=1.0, repetition_penalty=1.0), SampleArgs(use_prev=False)):
        before = (fused_step.fused_decode_step_sample.launches,
                  fused_step.fused_decode_step_sample_batched.launches)
        got = _run_step(fused_step.fused_decode_step_sample,
                        fused_step.fused_decode_step_sample_batched, params, kc, vc, buf, st, g,
                        sa, sup)
        after = (fused_step.fused_decode_step_sample.launches,
                 fused_step.fused_decode_step_sample_batched.launches)
        assert after == ((before[0] + 1, before[1]) if B == 1 else (before[0], before[1] + 1))
        kb, vb, bb = kc.clone(), vc.clone(), buf.clone()
        rtok, rrow, _, _ = fused_step.fused_decode_step_sample_batched_ref(
            params, kb, vb, bb, st["kv"], st["x"], st["last"], st["buf"], st["step"], g, sa=sa,
            suppress_until=10, suppressed=sup)
        rhid, _ = fused_step.decode_hidden_ref(params, kc.clone(), vc.clone(), st["kv"], st["x"],
                                               st["last"])
        tok, row, ka, va, ba, hid = got
        torch.testing.assert_close(hid, rhid, rtol=tol, atol=tol)
        keep = (row > -1e29) & (rrow > -1e29)  # (a value at the filter's cut may flip sides)
        assert float((row - rrow)[keep].abs().max()) <= tol and bool(keep.any())
        torch.testing.assert_close(ka.float(), kb.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(va.float(), vb.float(), rtol=tol, atol=tol)
        for b, n in enumerate(st["kv_lens"]):
            assert int(ba[b, int(st["buf"][b])]) == int(tok[b])
            for a, orig in ((ka, kc), (va, vc)):
                assert torch.equal(a[:, b, :n], orig[:, b, :n])
                assert torch.equal(a[:, b, n + 1:], orig[:, b, n + 1:])
        top2 = torch.topk(rrow, 2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        assert torch.equal(got[0][clear], rtok[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["int8", "int4"])
@pytest.mark.parametrize("B", [1, 2, 4, 6, 8])
def test_quantized_step_matches_twin(cuda_device, quant, B):
    """K1 and K2 on the int8 / int4 pages against the quantized twin: final
    hidden rows, filtered rows and appended K/V rows within the bf16
    tolerance, tokens where the twin's top-2 margin is clear of it; only row
    ``kv_len[b]`` of a slot's cache changes; the launch counts in
    ``launches_q8`` / ``launches_q4``; a table without the pages refuses."""
    import functools

    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg, params, kc, vc, buf, st = _step_fixture(cuda_device, "small", B, 200)
    V, tol = cfg.vocab_size, 2e-2
    sup = cfg.suppressed_tokens + (cfg.eos,)
    g = torch.zeros((B, V), device=cuda_device)
    sa = SampleArgs(use_prev=B == 1)
    fns = [functools.partial(f, quant=quant) for f in (
        fused_step.fused_decode_step_sample, fused_step.fused_decode_step_sample_batched)]
    with pytest.raises(ValueError, match=f"holds no {quant} pages"):
        _run_step(*fns, params, kc, vc, buf, st, g, sa, sup)
    params[fused_step.QUANT_KEYS[quant]] = fused_step.quant_layers(params, quant)
    params["k1_table"] = fused_step.K1Table(params, quant)
    wrapper = fused_step.fused_decode_step_sample if B == 1 else \
        fused_step.fused_decode_step_sample_batched
    name = {"int8": "launches_q8", "int4": "launches_q4"}[quant]
    before = (getattr(wrapper, name), wrapper.launches)
    tok, row, ka, va, ba, hid = _run_step(*fns, params, kc, vc, buf, st, g, sa, sup)
    assert (getattr(wrapper, name), wrapper.launches) == (before[0] + 1, before[1])
    kb, vb, bb = kc.clone(), vc.clone(), buf.clone()
    rtok, rrow, _, _ = fused_step.fused_decode_step_sample_batched_ref(
        params, kb, vb, bb, st["kv"], st["x"], st["last"], st["buf"], st["step"], g, sa=sa,
        suppress_until=10, suppressed=sup, quant=quant)
    rhid, _ = fused_step.decode_hidden_ref(params, kc.clone(), vc.clone(), st["kv"], st["x"],
                                           st["last"], quant)
    bhid, _ = fused_step.decode_hidden_ref(params, kc.clone(), vc.clone(), st["kv"], st["x"],
                                           st["last"])
    torch.testing.assert_close(hid, rhid, rtol=tol, atol=tol)
    assert float((hid - bhid).abs().max()) > tol  # the pages, not the bf16 weights
    keep = (row > -1e29) & (rrow > -1e29)
    assert float((row - rrow)[keep].abs().max()) <= tol and bool(keep.any())
    torch.testing.assert_close(ka.float(), kb.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(va.float(), vb.float(), rtol=tol, atol=tol)
    for b, n in enumerate(st["kv_lens"]):
        assert int(ba[b, int(st["buf"][b])]) == int(tok[b])
        for a, orig in ((ka, kc), (va, vc)):
            assert torch.equal(a[:, b, :n], orig[:, b, :n])
            assert torch.equal(a[:, b, n + 1:], orig[:, b, n + 1:])
    top2 = torch.topk(rrow, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    assert torch.equal(tok[clear], rtok[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("B,path", [(1, "k1q"), (4, "k2q"), (7, "k2")])
def test_engine_q4_on_cuda_counts_its_kernels(cuda_device, B, path):
    """``decode_chunk`` under ``"fused_step_q4"`` on CUDA: the int4 K1 / K2
    once a step up to six slots, the bf16 K2 at seven."""
    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.ops.sampling import gumbel_noise
    from gsv_tts_tpu_torch.runtime import t2s_session as ts

    cfg = t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2)
    params = t2s.init_params(cfg, torch.Generator().manual_seed(1), dtype=torch.bfloat16,
                             device=cuda_device)
    eng = ts.T2SEngine(params, cfg, gpt_cache=[(B, 96)], dtype=torch.bfloat16,
                       attn_impl="fused_step_q4")
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randint(1, 700, (B, 32), generator=gen, device=cuda_device)
    y = torch.randint(0, 1024, (B, 32), generator=gen, device=cuda_device)
    bert = torch.zeros((B, 32, cfg.bert_dim), device=cuda_device)
    k, v = eng._alloc_cache(B, 96)
    sa = ts.SampleArgs(use_prev=B == 1)
    state, _ = ts.prefill_batch(eng.params, cfg, x, y, bert,
                                torch.arange(10, 10 + B, device=cuda_device),
                                torch.arange(5, 5 + B, device=cuda_device), k, v,
                                gumbel_noise((B, 1025), gen, cuda_device), sa, False,
                                torch.bfloat16)
    wrapper = (fused_step.fused_decode_step_sample if B == 1
               else fused_step.fused_decode_step_sample_batched)
    before = (wrapper.launches_q4, wrapper.launches)
    state, toks = ts.decode_chunk(eng.params, cfg, state, 5, sa,
                                  gumbel_noise((5, B, 1025), gen, cuda_device), 0,
                                  torch.bfloat16, eng.attn_impl)
    eng._check_kernels()
    want = (5, 0) if path.endswith("q") else (0, 5)
    assert (wrapper.launches_q4 - before[0], wrapper.launches - before[1]) == want
    assert toks.shape == (B, 5) and int(toks.min()) >= 0 and int(toks.max()) < 1025


@pytest.mark.cuda
def test_persistent_steps_of_two_tables_interleave_on_one_stream(cuda_device):
    """Two decodes, each on its own parameters and table, taking turns on
    one stream give what each gives alone (a table's workspace and barrier
    counter are its own)."""
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    sa = SampleArgs(top_k=1)
    runs = {}
    for order in ("alone", "interleaved"):
        fixtures = [_step_fixture(cuda_device, "small", B, 200, seed)
                    for B, seed in ((1, 3), (4, 5))]
        states = []
        for cfg, params, kc, vc, buf, st in fixtures:
            states.append(dict(cfg=cfg, params=params, kc=kc.clone(), vc=vc.clone(),
                               buf=buf.clone(), st=st, toks=[]))

        def step(s, i):
            B, V = s["kc"].shape[1], s["cfg"].vocab_size
            g = torch.zeros((B, V), device=cuda_device)
            kw = dict(sa=sa, suppress_until=0)
            kv = [min(n, 150) + i for n in s["st"]["kv_lens"]]
            if B == 1:
                tok, _, _, _ = fused_step.fused_decode_step_sample(
                    s["params"], s["kc"], s["vc"], s["buf"], kv[0], 20, s["st"]["last"], 10 + i,
                    20 + i, g, **kw)
            else:
                t = torch.tensor(kv, dtype=torch.int32, device=cuda_device)
                tok, _, _, _ = fused_step.fused_decode_step_sample_batched(
                    s["params"], s["kc"], s["vc"], s["buf"], t, s["st"]["x"], s["st"]["last"],
                    s["st"]["buf"] + i, s["st"]["step"] + i, g, **kw)
            s["toks"].append(tok.clone())

        if order == "alone":
            for s in states:
                for i in range(6):
                    step(s, i)
        else:
            for i in range(6):
                for s in states:
                    step(s, i)
        torch.cuda.synchronize()
        for s in states:
            s["params"]["k1_table"].check()
        runs[order] = [(torch.stack(s["toks"]), s["kc"], s["vc"]) for s in states]
    for (ta, ka, va), (tb, kb, vb) in zip(runs["alone"], runs["interleaved"]):
        assert torch.equal(ta, tb) and torch.equal(ka, kb) and torch.equal(va, vb)


@pytest.mark.cuda
def test_persistent_greedy_steps_repeat_and_follow_the_twin(cuda_device):
    """200 consecutive greedy steps through ``decode_chunk``: the same tokens
    from run to run (no reduction's order depends on timing), and the twin's
    tokens over a bounded prefix (two routes that sum in other orders part at
    the first near-tie)."""
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.runtime import t2s_session as ts

    n = 200
    cfg, params, kc, vc, buf, st = _step_fixture(cuda_device, "small", 1, 256)
    V = cfg.vocab_size
    sa = ts.SampleArgs(top_k=1, repetition_penalty=1.0)
    g = torch.zeros((n, 1, V), device=cuda_device)

    def i32(v):
        return torch.tensor([v], dtype=torch.int32, device=cuda_device)

    def run(twin):
        state = ts.DecodeState(kc.clone(), vc.clone(), i32(30), i32(20), buf.clone(), i32(11),
                               i32(1017), i32(0))
        if not twin:
            _, toks = ts.decode_chunk(params, cfg, state, n, sa, g, dtype=torch.bfloat16)
            out = toks[0].clone()
        else:
            out = torch.empty(n, dtype=torch.int32, device=cuda_device)
            row = torch.empty((1, V), device=cuda_device)
            for i in range(n):
                fused_step.fused_decode_step_sample_ref(
                    params, state.k_cache, state.v_cache, state.tok_buf, 30 + i, 20,
                    state.last_tok, 11 + i, i, g[i], sa=sa, tok_out=out[i:i + 1], row_out=row)
                state.last_tok = out[i:i + 1]
        torch.cuda.synchronize()
        params["k1_table"].check()
        return out

    before = fused_step.fused_decode_step_sample.launches
    first, second, twin = run(False), run(False), run(True)
    assert fused_step.fused_decode_step_sample.launches == before + 2 * n
    assert torch.equal(first, second)
    agree = int((first == twin).int().cumprod(0).sum())
    assert agree >= 8, f"only {agree} leading tokens equal the twin's"


@pytest.mark.cuda
@pytest.mark.parametrize("what,match", [("last_tok", "last_tok outside"),
                                        ("kv_len", "kv_len outside the cache"),
                                        ("pe_idx", "positional index outside")])
def test_persistent_step_error_bits_return_without_a_hang(cuda_device, what, match):
    """An out-of-range device value sets its bit and the launch comes back
    (a persistent block must reach every barrier): the bad slot's hidden row
    is NaN, the others are finite, a bad ``kv_len`` appends nothing."""
    import time

    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    B, S, slot = 4, 200, 2
    cfg, params, kc, vc, buf, st = _step_fixture(cuda_device, "small", B, S)
    V, P = cfg.vocab_size, params["pe"].shape[0]
    kv, x, last = st["kv"].clone(), st["x"].clone(), st["last"].clone()
    if what == "last_tok":
        last[slot] = V
    elif what == "kv_len":
        kv[slot] = S
    else:
        x[slot] = int(kv[slot]) - P
    ka, va = kc.clone(), vc.clone()
    fused_step.fused_decode_step_sample_batched(
        params, ka, va, buf.clone(), kv, x, last, st["buf"], st["step"],
        torch.zeros((B, V), device=cuda_device), sa=SampleArgs(use_prev=False))
    done = torch.cuda.Event()
    done.record()
    deadline = time.perf_counter() + 30
    while not done.query():
        assert time.perf_counter() < deadline, "the kernel did not come back"
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match=match):
        params["k1_table"].check()
    hid = params["k1_table"].x[:B * cfg.hidden_dim].reshape(B, cfg.hidden_dim)
    for b in range(B):
        assert bool(torch.isnan(hid[b]).all()) if b == slot else bool(torch.isfinite(hid[b]).all())
    if what == "kv_len":
        assert torch.equal(ka[:, slot], kc[:, slot]) and torch.equal(va[:, slot], vc[:, slot])
    if what == "last_tok":  # K1's only device-side value
        _, p1, k1, v1, b1, s1 = _step_fixture(cuda_device, "small", 1, S)
        fused_step.fused_decode_step_sample(
            p1, k1, v1, b1, 150, 20, torch.tensor([-1], dtype=torch.int32, device=cuda_device),
            100, 3, torch.zeros((1, V), device=cuda_device), sa=SampleArgs())
        torch.cuda.synchronize()
        with pytest.raises(RuntimeError, match=match):
            p1["k1_table"].check()


def _small_sovits(dev, dtype=torch.float32):
    from gsv_tts_tpu_torch.models import sovits

    cfg = sovits.SovitsConfig(inter_channels=64, hidden_channels=64, filter_channels=96,
                              n_layers=2, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3, 5),), upsample_rates=(4, 4),
                              upsample_initial_channel=32, upsample_kernel_sizes=(8, 8),
                              flow_n_layers=2)
    return cfg, sovits.init_params(cfg, torch.Generator().manual_seed(0), dtype, dev)


def _chunk_inputs(cfg, dev, n, N, vsi, blend, Bc=32, Np=32, ov=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    codes = torch.zeros((1, 1, Bc), dtype=torch.int64)
    codes[..., :n] = torch.randint(0, 1024, (n,), generator=g)
    text = torch.zeros((1, Np), dtype=torch.int64)
    text[:, :N] = torch.randint(1, 700, (N,), generator=g)
    ins = (codes, torch.tensor([n]), text, torch.tensor([N]),
           torch.randn((1, cfg.gin_channels, 1), generator=g) * 0.5,
           torch.randn((1, cfg.inter_channels, 2 * Bc), generator=g) * 0.5,
           torch.randn((1, cfg.hidden_channels, ov), generator=g) * 0.5,
           torch.tensor([vsi]), torch.tensor([blend]))
    return [x.to(dev) for x in ins]


@pytest.mark.cuda
def test_sovits_graph_replay_at_another_length_equals_eager(cuda_device):
    """One padded streaming chunk captured as a CUDA graph at one length of its
    bucket and replayed at others (lengths, offset and blend are input
    tensors) equals the eager run at those lengths."""
    import functools

    from gsv_tts_tpu_torch.runtime.vocoder_batch import stream_batch_fused
    from gsv_tts_tpu_torch.tts import SovitsGraphs

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p = _small_sovits(cuda_device)
    fn = functools.partial(stream_batch_fused, p, cfg, overlap_len=5, bucket=55)
    graphs = SovitsGraphs()
    with torch.no_grad():
        for i, (n, N, vsi, blend) in enumerate([(20, 13, 0, False), (27, 30, 16, True),
                                                (31, 5, 40, True)]):
            ins = _chunk_inputs(cfg, cuda_device, n, N, vsi, blend, seed=i)
            got = graphs.run(p, ("chunk",), fn, *ins)
            want = fn(*ins)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
            assert torch.isfinite(got[0]).all()
    assert graphs.captures == 1 and graphs.replays == 3


@pytest.mark.cuda
def test_failed_sovits_graph_capture_raises(cuda_device):
    """A program that reads the host inside the capture fails to capture:
    ``run`` raises, keeps nothing and leaves the caller's stream current, and
    the next capture works (in a fresh pool: the failed one stays recording)."""
    from gsv_tts_tpu_torch.tts import SovitsGraphs

    graphs = SovitsGraphs()
    x, params = torch.arange(8.0, device=cuda_device), {}
    with pytest.raises(RuntimeError, match="capture of the SoVITS program"):
        graphs.run(params, ("bad",), lambda a: a * float(a.sum().item()), x)
    assert graphs.captures == 0 and not graphs.graphs and not graphs.pools
    assert torch.cuda.current_stream() == torch.cuda.default_stream()
    out, = graphs.run(params, ("good",), lambda a: a * 2, x)
    assert torch.equal(out, x * 2) and graphs.captures == 1


# bf16 against float32 on the card, as chip_smoke.py holds K1: an absolute bound per
# element and a relative L2 bound (the embedding and ge are O(1); bf16 rounds each
# activation to 2^-9 relative, some 40 convolutions deep)
SV_TOL_ABS, SV_TOL_REL = 0.1, 2e-2


@pytest.mark.cuda
def test_sv_embedding_in_bf16_holds_to_float32_on_the_card(cuda_device):
    """The full-width ERes2NetV2 embedding of a 2 s clip, and a v2ProPlus
    ``ge`` built on it, computed in bf16 on the card against the same weights
    in float32: within the stated bounds; the embedding float32 either way,
    ``ge`` in the model's dtype."""
    import numpy as np

    from gsv_tts_tpu_torch.models import sovits, sv

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    p32 = sv.init_params(sv.SVConfig(), torch.Generator().manual_seed(0), device=cuda_device)
    p16 = {k: v.to(torch.bfloat16) for k, v in p32.items()}
    rng = np.random.RandomState(0)
    t = np.arange(32000) / 16000
    wav = (0.1 * rng.randn(32000) + 0.2 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    feat = torch.as_tensor(sv.kaldi_fbank(wav)[None], device=cuda_device)
    e32 = sv.eres2netv2_forward3(p32, feat)
    e16 = sv.eres2netv2_forward3(p16, feat.to(torch.bfloat16))
    cfg = sovits.SovitsConfig(gin_channels=1024, version="v2ProPlus")
    s32 = sovits.init_params(cfg, torch.Generator().manual_seed(1), device=cuda_device)
    s32["sv_emb.weight"] *= 0.1
    s16 = {k: v.to(torch.bfloat16) for k, v in s32.items()}
    refer = torch.rand((1, cfg.spec_channels, 150), generator=torch.Generator().manual_seed(2))
    g32 = sovits.get_ge(s32, cfg, refer.to(cuda_device), e32)
    g16 = sovits.get_ge(s16, cfg, refer.to(cuda_device, torch.bfloat16), e16)
    assert e16.dtype == torch.float32 and e16.shape == (1, sv.EMBED_DIM)
    assert g16.dtype == torch.bfloat16 and g16.shape == (1, 1024, 1)
    for got, want in ((e16, e32), (g16, g32)):
        got = got.float()
        assert float((got - want).abs().max()) <= SV_TOL_ABS
        assert float((got - want).norm() / want.norm()) <= SV_TOL_REL


def _sv_facade(cuda_device, tmp_path, monkeypatch):
    """A facade on the card with a full-width random ERes2NetV2 checkpoint
    where it looks for one, its embedder loaded; offline, so that it fetches
    none of the assets the directory lacks."""
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.models import sv

    monkeypatch.setenv("GSV_OFFLINE", "1")
    path = tmp_path / "sv" / "pretrained_eres2netv2w24s4ep4.ckpt"
    path.parent.mkdir()
    torch.save(sv.init_params(sv.SVConfig(), torch.Generator().manual_seed(0)), str(path))
    tts = TTS(models_dir=str(tmp_path), device=cuda_device, seed=0)
    return tts, tts._get_sv_model()


def _sv_clip(seconds, seed=0):
    import numpy as np

    n = int(16000 * seconds)
    t = np.arange(n) / 16000
    rng = np.random.RandomState(seed)
    return (0.1 * rng.randn(n) + 0.2 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)


def _span_names(fn):
    """``fn()``'s result and the names of the spans it opened, recorded
    under a CPU-only profiler."""
    from gsv_tts_tpu_torch.utils import timing

    before = {id(r) for r in timing.span_log()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    return out, [r.name for r in timing.span_log() if id(r) not in before]


@pytest.mark.cuda
def test_sv_embedder_captures_its_buckets_at_load_and_replays_them(cuda_device, tmp_path,
                                                                   monkeypatch):
    """Loading the facade's embedder captures one graph per bucket (8);
    two clips of one bucket then add two replays and no capture, each
    through ``gsv.voice.sv_emb.replay`` alone; a replay equals the eager
    exact-length bf16 run within the bf16 bounds."""
    from gsv_tts_tpu_torch.models import sv

    tts, emb = _sv_facade(cuda_device, tmp_path, monkeypatch)
    graphs = tts.sovits_graphs
    assert graphs.captures == 8 == len(sv.SV_BUCKETS)
    assert sorted(k[2] for k in graphs.graphs if k[0] == "sv") == list(sv.SV_BUCKETS)
    replays = graphs.replays
    clips = [_sv_clip(3.0, 1), _sv_clip(3.5, 2)]  # 298 and 348 frames: both 384
    for wav in clips:
        got, names = _span_names(lambda: emb.compute_embedding3(wav))
        assert "gsv.voice.sv_emb.replay" in names
        assert not {"gsv.voice.sv_emb.eager", "gsv.voice.sv_emb.fbank",
                    "gsv.voice.sv_emb.block"} & set(names)
        emb.graphs = None  # the same embedder, eagerly at the exact length
        try:
            want = emb.compute_embedding3(wav)
        finally:
            emb.graphs = graphs
        assert got.dtype == torch.float32 and got.shape == (1, sv.EMBED_DIM)
        assert float((got - want).abs().max()) <= SV_TOL_ABS
        assert float((got - want).norm() / want.norm()) <= SV_TOL_REL
    assert graphs.captures == 8 and graphs.replays == replays + 2


@pytest.mark.cuda
def test_sv_embedder_runs_a_long_clip_and_a_batch_eagerly(cuda_device, tmp_path, monkeypatch):
    """A 12 s clip (1198 frames, past the largest bucket) and a batch of two
    clips take ``gsv.voice.sv_emb.eager`` (with its ``.fbank``): no capture,
    no replay; the batch's rows equal each clip's replay within the bf16
    bounds."""
    import numpy as np

    tts, emb = _sv_facade(cuda_device, tmp_path, monkeypatch)
    graphs = tts.sovits_graphs
    captures, replays = graphs.captures, graphs.replays
    batch = np.stack([_sv_clip(4.0, 3), _sv_clip(4.0, 4)])
    for wav in (_sv_clip(12.0, 5), batch):
        out, names = _span_names(lambda: emb.compute_embedding3(wav))
        assert {"gsv.voice.sv_emb.eager", "gsv.voice.sv_emb.fbank"} <= set(names)
        assert "gsv.voice.sv_emb.replay" not in names
        assert torch.isfinite(out).all() and len(out) == (1 if wav.ndim == 1 else len(wav))
    assert (graphs.captures, graphs.replays) == (captures, replays)
    for row, wav in zip(out, batch):
        want = emb.compute_embedding3(wav)[0]
        assert float((row - want).abs().max()) <= SV_TOL_ABS
        assert float((row - want).norm() / want.norm()) <= SV_TOL_REL


@pytest.mark.cuda
def test_unload_sovits_model_evicts_its_graphs_while_another_replays(cuda_device, tmp_path):
    """Two SoVITS models (v2 and v2ProPlus) on one facade, each with the CUDA
    graphs of a padded core and a flow bucket in a pool of its own: unloading
    one drops its graphs and its pool (the pool's memory returns to the
    card), and the other's graphs replay as before, capturing nothing."""
    import numpy as np

    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.hparams import HParams
    from gsv_tts_tpu_torch.loader import save_trained_sovits
    from gsv_tts_tpu_torch.models import sovits

    hps = {"data": {"filter_length": 1408, "hop_length": 320, "win_length": 1408,
                    "sampling_rate": 32000},
           "model": {"inter_channels": 64, "hidden_channels": 64, "filter_channels": 96,
                     "n_heads": 2, "n_layers": 2, "kernel_size": 3, "p_dropout": 0.0,
                     "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3, 5]],
                     "upsample_rates": [8, 5, 4, 4], "upsample_initial_channel": 32,
                     "upsample_kernel_sizes": [16, 11, 8, 8]}}
    paths = []
    for version, gin in (("v2", 512), ("v2ProPlus", 1024)):
        h = {**hps, "model": {**hps["model"], "gin_channels": gin, "version": version}}
        cfg = sovits.SovitsConfig.from_hps(h["model"], 705)
        save_trained_sovits(sovits.init_params(cfg, torch.Generator().manual_seed(0)),
                            HParams(h), tmp_path / version)
        paths.append(str(tmp_path / version))
    tts = TTS(models_dir=str(tmp_path), device=cuda_device, seed=0)
    tts.load_sovits_model(*paths)
    rng = np.random.RandomState(0)
    codes, text = rng.randint(0, 1024, (1, 1, 40)), rng.randint(1, 700, (1, 20))

    def decode(path):
        model = tts.sovits_models[path]
        ge = torch.randn((1, model.cfg.gin_channels, 1), generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            return tts._sovits_decode(model, codes, text, ge.to(cuda_device), noise_scale=0.0)[0]

    def pool_bytes(pool):
        return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
                   if tuple(seg.get("segment_pool_id", ())) == tuple(pool))

    before = {path: decode(path) for path in paths}
    graphs = tts.sovits_graphs
    owners = {path: id(tts.sovits_models[path].params) for path in paths}

    def count(path):
        return sum(k[1] == owners[path] for k in graphs.graphs)

    assert [count(path) for path in paths] == [2, 2] and graphs.captures == 4
    pool = graphs.pools[owners[paths[1]]]
    assert pool_bytes(pool) > 0
    tts.unload_sovits_model(paths[1])
    assert count(paths[1]) == 0 and owners[paths[1]] not in graphs.pools
    assert pool_bytes(pool) == 0 and tts.get_sovits_list() == paths[:1]
    again = decode(paths[0])
    assert graphs.captures == 4 and count(paths[0]) == 2
    assert np.array_equal(again, before[paths[0]])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 512), (512, 2048), (12288, 6144)])
@pytest.mark.parametrize("variant", ["unpack", "unpack_dma"])
def test_p1_probe_kernel_matches_twin(cuda_device, variant, shape):
    """P1 at the probe's shape, the flagship MLP-1 (D=512, N=2048) and the
    s1v3 layer stack as one page (D=12288, N=6144: split over the card, a
    second pass summing the splits): within 1e-5 of max |twin| (float32 sums
    of exact bf16 products in other orders), one launch counted a call, and
    bit for bit its own repeat (the sums meet in a fixed order)."""
    from gsv_tts_tpu_torch import tools
    from gsv_tts_tpu_torch.tools import int4_probe

    d, n = shape
    x, _, packed, scale = int4_probe.make_inputs(1, d=d, n=n)
    args = [torch.from_numpy(a).to(cuda_device) for a in (x, packed, scale)]
    before = int4_probe.int4_unpack_matmul.launches
    got = int4_probe.int4_unpack_matmul(*args, variant=variant)
    again = int4_probe.int4_unpack_matmul(*args, variant=variant)
    want = int4_probe.int4_unpack_matmul_plain(*args)
    torch.cuda.synchronize()
    tools.check(cuda_device)
    assert int4_probe.int4_unpack_matmul.launches == before + 2
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["baseline", "reduce3d", "bcastcmp", "combined"])
def test_p2_probe_kernel_matches_twin(cuda_device, variant):
    """P2 within 1e-5 of max(1, |twin|) (bcastcmp's -5.4e10: within its
    float32 resolution), bit for bit its own repeat."""
    from gsv_tts_tpu_torch.tools import mosaic_probe

    x = torch.from_numpy(mosaic_probe.make_input(2)).to(cuda_device)
    got = mosaic_probe.mosaic_reduce(x, variant)
    want = mosaic_probe.mosaic_reduce_plain(x, variant)
    torch.cuda.synchronize()
    assert ((got - want).abs() / want.abs().clamp_min(1.0)).max() <= 1e-5
    assert torch.equal(got, mosaic_probe.mosaic_reduce(x, variant))


@pytest.mark.cuda
@pytest.mark.parametrize("size,variant", [("small", "fori"), ("small", "fori64"),
                                          ("small", "grid"), ("small", "k1ring"),
                                          ("full", "fori"), ("full", "fori256"),
                                          ("full", "fori1024"), ("full", "fori2048"),
                                          ("full", "grid"), ("full", "k1ring")])
def test_p3_probe_kernel_matches_twin(cuda_device, size, variant):
    """One P3 step, both rows (y[:rows] and y folded, so every column of w),
    against its twin within 1e-4 of max |twin| (float32 sums over up to
    12,288 rows in other orders), and a 3-step chain bit for bit equal to its
    repeat (the partials are summed in a fixed order)."""
    from gsv_tts_tpu_torch import tools
    from gsv_tts_tpu_torch.tools import stream_probe

    L, D, W = (2, 128, 512) if size == "small" else (24, 512, 6144)
    rows = stream_probe.rows_of(variant, D)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    w = (0.02 * torch.randn((L, D, W), generator=gen, device=cuda_device)).to(torch.bfloat16)
    x = (0.1 * torch.randn((1, rows), generator=gen, device=cuda_device)).to(torch.bfloat16)
    got = stream_probe.stream_step(x, w, variant)
    want = stream_probe.stream_step_plain(x, w, variant)
    torch.cuda.synchronize()
    tools.check(cuda_device)
    assert got.shape == want.shape == (2, rows)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    a = stream_probe.chain(x, w, variant, 3)
    b = stream_probe.chain(x, w, variant, 3)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_p3_counts_replayed_steps_not_captures(cuda_device, monkeypatch):
    """A step captured into a CUDA graph launches nothing and counts nothing;
    each replay of the chain's graph counts its REPS steps."""
    from gsv_tts_tpu_torch.tools import stream_probe

    monkeypatch.setattr(stream_probe, "REPS", 4)
    monkeypatch.setattr(stream_probe, "ROUNDS", 2)
    w = torch.zeros((2, 128, 512), dtype=torch.bfloat16, device=cuda_device)
    x = torch.zeros((1, 128), dtype=torch.bfloat16, device=cuda_device)
    before = stream_probe.stream_step.launches
    stream_probe.stream_step(x, w, "fori")  # build and warm outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream_probe.stream_step(x, w, "fori")
    assert stream_probe.stream_step.launches == before + 1
    stream_probe.time_chain(x, w, "fori")
    assert stream_probe.stream_step.launches == before + 1 + 4 + 2 * 4


@pytest.mark.cuda
def test_probe_wrappers_refuse_misaligned_or_strided_inputs(cuda_device):
    """A non-contiguous or misaligned input raises before any launch."""
    from gsv_tts_tpu_torch.tools import int4_probe, mosaic_probe, stream_probe

    x, _, packed, scale = (torch.from_numpy(a).to(cuda_device)
                           for a in int4_probe.make_inputs(0))
    counts = (int4_probe.int4_unpack_matmul.launches, mosaic_probe.mosaic_reduce.launches,
              stream_probe.stream_step.launches)
    strided = torch.empty((x.shape[1], 8), device=cuda_device).t().copy_(x)
    shifted = torch.empty(x.numel() + 1, device=cuda_device)[1:].view_as(x).copy_(x)
    for bad in (strided, shifted):
        with pytest.raises(ValueError, match="16-byte aligned"):
            int4_probe.int4_unpack_matmul(bad, packed, scale, variant="unpack_dma")
    xm = torch.empty(256 * 16 + 1, device=cuda_device)[1:].view(256, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        mosaic_probe.mosaic_reduce(xm, "combined")
    w = torch.zeros((2, 128, 512), dtype=torch.bfloat16, device=cuda_device)
    xs = torch.zeros((1, 128), dtype=torch.bfloat16, device=cuda_device)
    for bad_w in (w.transpose(1, 2).contiguous().transpose(1, 2),
                  torch.zeros(w.numel() + 1, dtype=torch.bfloat16,
                              device=cuda_device)[1:].view_as(w)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            stream_probe.stream_step(xs, bad_w, "fori")
    assert counts == (int4_probe.int4_unpack_matmul.launches,
                      mosaic_probe.mosaic_reduce.launches, stream_probe.stream_step.launches)


@pytest.mark.cuda
def test_cnroberta_bf16_on_the_card_follows_float32(cuda_device):
    """The BERT encoder in bf16 on the card against a float32 evaluation of
    the same (bf16) weights on the card, at hidden 256 (6 of 8 layers): within
    2% relative L2 over the valid tokens; the int8 form within 6%."""
    from gsv_tts_tpu_torch.models import roberta

    cfg = roberta.BertConfig(vocab_size=500, hidden_size=256, num_hidden_layers=8,
                             num_attention_heads=4, intermediate_size=1024)
    p = {k: v.to(cuda_device, torch.bfloat16)
         for k, v in roberta.init_params(cfg, torch.Generator().manual_seed(0)).items()}
    ids = torch.randint(0, 500, (3, 40), generator=torch.Generator().manual_seed(1))
    mask = torch.ones_like(ids)
    mask[1, 30:] = 0
    ids, mask = ids.to(cuda_device), mask.to(cuda_device)
    p32 = {k: v.float() for k, v in p.items()}
    with torch.no_grad():
        f32 = roberta.bert_hidden_minus3(p32, cfg, ids, mask)
        b16 = roberta.bert_hidden_minus3(p, cfg, ids, mask)
        q8 = roberta.bert_hidden_minus3_q8(roberta.quantize_bert_params(p32, cfg), cfg, ids, mask)
    assert b16.dtype == torch.bfloat16 and q8.dtype == torch.float32
    valid = mask.bool()
    for got, tol in ((b16.float(), 2e-2), (q8, 6e-2)):
        assert torch.isfinite(got).all()
        rel = float((got[valid] - f32[valid]).norm() / f32[valid].norm())
        assert rel < tol, rel


@pytest.mark.cuda
def test_xla_engine_on_the_card_launches_no_kernel(cuda_device):
    """``attn_impl="xla"`` on the card: no kernel table is built, no kernel
    wrapper counts a launch, and a wave of 1 and of 3 decodes."""
    import numpy as np

    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.ops import flash_decode, flash_prefill, fused_layer, fused_step
    from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine

    cfg = t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2)
    params = t2s.init_params(cfg, torch.Generator().manual_seed(0), dtype=torch.bfloat16,
                             device=cuda_device)
    eng = T2SEngine(params, cfg, gpt_cache=[(1, 256), (4, 256)], dtype=torch.bfloat16,
                    attn_impl="xla")
    assert "k1_table" not in eng.params
    wrappers = [(fused_step.fused_decode_step_sample, "launches"),
                (fused_step.fused_decode_step_sample_batched, "launches"),
                (flash_decode.flash_decode_attention_layered, "launches"),
                (flash_prefill.flash_prefill_attention, "launches"),
                (fused_step.fused_decode_step, "launches"),
                (fused_layer.fused_decode_layer, "launches")]
    before = [getattr(fn, attr) for fn, attr in wrappers]
    rng = np.random.RandomState(0)
    xs = [rng.randint(1, 700, size=n).astype(np.int64) for n in (9, 12, 7)]
    ys = [rng.randint(0, 1024, size=n).astype(np.int64) for n in (5, 6, 4)]
    berts = [np.zeros((len(x), 1024), np.float32) for x in xs]
    toks = eng.generate(xs[0], ys[0], berts[0], top_k=5)
    assert toks.size > 0 and eng.last_stats["decode_steps"] > 0
    pred, _ = eng.generate_batched(xs, ys, berts, top_k=5)
    assert len(pred) == 3 and all(len(p) > 0 for p in pred)
    assert eng.last_stats["generic_steps"] == eng.last_stats["decode_steps"] > 0
    assert [getattr(fn, attr) for fn, attr in wrappers] == before


def _card_facade(dev):
    """A float32 facade on the card around the small SoVITS (no checkpoint):
    what ``VocoderBatcher`` and the solo chunk path read of it."""
    import types

    from gsv_tts_tpu_torch import TTS

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    tts = TTS(device=str(dev), dtype="float32", seed=0)
    cfg, p = _small_sovits(dev)
    return tts, types.SimpleNamespace(cfg=cfg, params=p)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [2, 4])
def test_decode_many_on_cuda_matches_solo_chunks(cuda_device, n_rows):
    """``VocoderBatcher.decode_many`` at B=2 and B=4 (one CUDA graph of the
    batched chunk) against each row's solo chunk (the B=1 graph), float32:
    audio, attention and the carried overlap, which stays on the card."""
    import numpy as np

    from gsv_tts_tpu_torch.runtime.vocoder_batch import VocoderBatcher

    tts, sov = _card_facade(cuda_device)
    rng = np.random.RandomState(3)
    ge = torch.randn((1, sov.cfg.gin_channels, 1), generator=torch.Generator().manual_seed(1))
    ge = (ge * 0.5).to(cuda_device)
    codes = rng.randint(0, 1024, 41)
    text = rng.randint(1, 700, 13)
    with torch.no_grad():
        _, _, carry = tts._sovits_decode_stream(sov, codes[None, None, :20], text[None], ge,
                                                noise_scale=0.0, speed=1.0, y_overlap=None,
                                                valid_start_idx=0, overlap_len=5)
        rows = [(codes[:20], text, 0, None), (codes, text, 35, carry),
                (codes[:9], text[:7], 0, None), (codes[:33], text[:11], 0, None)][:n_rows]
        solo = [tts._sovits_decode_stream(sov, c[None, None, :], t[None], ge, noise_scale=0.0,
                                          speed=1.0, y_overlap=yo, valid_start_idx=v,
                                          overlap_len=5) for c, t, v, yo in rows]
        b = VocoderBatcher(tts, max_batch=4)
        try:
            got = b.decode_many([(sov, c, t, ge, 0.0, yo, v, 5) for c, t, v, yo in rows])
        finally:
            b.close()
    assert b.stats["max_group"] == n_rows
    assert any(k[0] == "chunk" and k[2] == n_rows for k in tts.sovits_graphs.graphs)
    for i, (g, s) in enumerate(zip(got, solo)):
        assert g[2].is_cuda and g[2].shape == (1, sov.cfg.hidden_channels, 5)
        np.testing.assert_allclose(g[0], s[0], rtol=1e-4, atol=1e-4, err_msg=f"row {i} audio")
        np.testing.assert_allclose(g[1], s[1], rtol=1e-4, atol=1e-5, err_msg=f"row {i} attn")
        torch.testing.assert_close(g[2], s[2], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_sovits_graphs_from_four_threads_equal_serial_calls(cuda_device):
    """Four threads replaying (and the first capturing) the graphs of one
    model's pool at once give what the same calls give one after another."""
    import functools
    import threading

    from gsv_tts_tpu_torch.runtime.vocoder_batch import stream_batch_fused
    from gsv_tts_tpu_torch.tts import SovitsGraphs

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p = _small_sovits(cuda_device)
    fns = {b: functools.partial(stream_batch_fused, p, cfg, overlap_len=5, bucket=b)
           for b in (50, 55)}
    cases = [(b, _chunk_inputs(cfg, cuda_device, 20 + i % 8, 13, 0 if i % 2 else 16,
                               i % 2 == 0, seed=i)) for i, b in enumerate((50, 55) * 8)]
    graphs = SovitsGraphs()
    with torch.no_grad():
        serial = [graphs.run(p, ("chunk", b), fns[b], *ins) for b, ins in cases]
    concurrent = [None] * len(cases)
    errors = []

    def worker(k):
        try:
            with torch.no_grad():
                for i in range(k, len(cases), 4):
                    b, ins = cases[i]
                    concurrent[i] = graphs.run(p, ("chunk", b), fns[b], *ins)
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    graphs.evict(p)  # the threads capture afresh, beside each other's replays
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert graphs.captures == 4
    for i, (a, b) in enumerate(zip(concurrent, serial)):
        for x, y in zip(a, b):
            assert torch.equal(x, y), i


@pytest.mark.cuda
def test_capture_beside_a_thread_launching_k2(cuda_device):
    """One thread decodes a 4-slot wave (K2, each chunk in the gate's shared
    section, as the wave scheduler does) while another captures SoVITS
    graphs: the captures succeed, their replays equal eager runs, and the
    wave's tokens and caches equal the same chunks run alone."""
    import contextlib
    import functools
    import threading
    import time

    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.ops.sampling import gumbel_noise
    from gsv_tts_tpu_torch.runtime import t2s_session as ts
    from gsv_tts_tpu_torch.runtime.vocoder_batch import stream_batch_fused
    from gsv_tts_tpu_torch.tts import SovitsGraphs

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    B, S, n_chunks = 4, 512, 40
    cfg = t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2)
    params = t2s.init_params(cfg, torch.Generator().manual_seed(1), dtype=torch.bfloat16,
                             device=cuda_device)
    eng = ts.T2SEngine(params, cfg, gpt_cache=[(B, S)], dtype=torch.bfloat16)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randint(1, 700, (B, 32), generator=gen, device=cuda_device)
    y = torch.randint(0, 1024, (B, 32), generator=gen, device=cuda_device)
    bert = torch.zeros((B, 32, cfg.bert_dim), device=cuda_device)
    sa = ts.SampleArgs(use_prev=False)
    k, v = eng._alloc_cache(B, S)
    lens = (torch.full((B,), 20, device=cuda_device), torch.full((B,), 10, device=cuda_device))
    state0, _ = ts.prefill_batch(eng.params, cfg, x, y, bert, *lens, k, v,
                                 gumbel_noise((B, 1025), gen, cuda_device), sa, False,
                                 torch.bfloat16)
    noise = [gumbel_noise((5, B, 1025), gen, cuda_device) for _ in range(n_chunks)]

    def clone(st):
        return ts.DecodeState(*[getattr(st, f).clone() for f in (
            "k_cache", "v_cache", "kv_len", "x_len", "tok_buf", "buf_len", "last_tok",
            "step_idx")])

    def decode(st, gate=None):
        toks = []
        for g in noise:
            with gate.shared() if gate is not None else contextlib.nullcontext():
                st, t = ts.decode_chunk(eng.params, cfg, st, 5, sa, g, 0, torch.bfloat16)
                toks.append(t.cpu())
                eng._check_kernels()
        return st, torch.cat(toks, dim=1)

    with torch.no_grad():
        ref_state, ref_toks = decode(clone(state0))
        graphs = SovitsGraphs()
        scfg, sp = _small_sovits(cuda_device)
        out = {}
        launches = fused_step.fused_decode_step_sample_batched.launches

        def wave():
            with torch.no_grad():
                out["wave"] = decode(clone(state0), graphs.gate)

        th = threading.Thread(target=wave)
        th.start()
        time.sleep(0.01)
        captured = []
        for i, b in enumerate((50, 55, 60, 64)):
            fn = functools.partial(stream_batch_fused, sp, scfg, overlap_len=5, bucket=b)
            ins = _chunk_inputs(scfg, cuda_device, 20, 13, 0, False, seed=i)
            got = graphs.run(sp, ("chunk", b), fn, *ins)
            captured.append((got, fn(*ins)))
        th.join(timeout=120.0)
        assert not th.is_alive()
    assert graphs.captures == 4
    assert fused_step.fused_decode_step_sample_batched.launches - launches == 5 * n_chunks
    for got, want in captured:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    state, toks = out["wave"]
    assert torch.equal(toks, ref_toks)
    assert torch.equal(state.k_cache, ref_state.k_cache)


# -- training (single card) ----------------------------------------------------------------

def _full_float32(monkeypatch):
    """Pin float32 products and convolutions to float32 (no TF32), as ``Config()`` does."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)


def _tiny_t2s_batch(device):
    import numpy as np

    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.parallel import train as ptrain

    cfg = t2s.T2SConfig(hidden_dim=128, embedding_dim=128, num_heads=4, num_layers=2)
    rng = np.random.RandomState(0)
    samples = [(rng.randint(1, 700, int(rng.randint(20, 60))).astype(np.int32),
                rng.randint(0, 1024, int(rng.randint(40, 120))).astype(np.int32), None)
               for _ in range(4)]
    return cfg, samples, ptrain.pad_batch(cfg, samples, device=device)


def _tiny_sovits(device):
    """A tiny v2 SoVITS with its fresh posterior encoder, the discriminators, a
    two-row batch and one step's draws, made on the CPU and put on ``device``."""
    import numpy as np

    from gsv_tts_tpu_torch.models import sovits, sovits_train as svt

    cfg = sovits.SovitsConfig(spec_channels=129, inter_channels=64, hidden_channels=64,
                              filter_channels=96, n_layers=2, resblock_kernel_sizes=(3,),
                              resblock_dilation_sizes=((1, 3, 5),), upsample_rates=(2, 2),
                              upsample_initial_channel=32, upsample_kernel_sizes=(4, 4),
                              ref_enc_in=96, flow_n_layers=2)
    gen = torch.Generator().manual_seed(0)
    g = sovits.init_params(cfg, gen)
    g.update(svt.init_enc_q_params(cfg, gen))
    d = svt.init_discriminator_params(gen)
    rng = np.random.RandomState(1)
    samples = [(rng.randn(768, T).astype(np.float32) * 0.1,
                np.abs(rng.randn(129, T)).astype(np.float32),
                (rng.randn(T * 4) * 0.1).astype(np.float32),
                rng.randint(1, 100, size=(9,)).astype(np.int32)) for T in (32, 22)]
    batch = svt.pad_sovits_batch(cfg, samples, 4)
    noise, u = svt.sovits_draws(cfg, batch, torch.Generator().manual_seed(2))
    put = lambda t: {k: v.to(device) for k, v in t.items()}  # noqa: E731
    return cfg, put(g), put(d), put(batch), noise.to(device), u.to(device)


@pytest.mark.cuda
def test_t2s_train_step_on_the_card_follows_the_cpu(cuda_device, monkeypatch):
    """One float32 t2s train step on the card and on the CPU from the same
    params and batch: the loss and every gradient agree to float32
    reduction order (rtol 1e-4 of each leaf's largest entry); the params
    after the update within 2·lr (Adam's first step moves each element by
    ±lr·g/(|g| + eps), whose sign is rounding noise where g is ~0)."""
    from gsv_tts_tpu_torch.models import t2s
    from gsv_tts_tpu_torch.parallel import train as ptrain

    _full_float32(monkeypatch)
    lr = 1e-3
    out = {}
    for dev in ("cpu", cuda_device):
        cfg, _, batch = _tiny_t2s_batch(dev)
        p = ptrain.t2s_train_params(t2s.init_params(cfg, torch.Generator().manual_seed(3),
                                                    device=dev))
        leaves = ptrain.t2s_leaves(p)
        loss = ptrain.t2s_loss(p, cfg, batch["x_ids"], batch["y_ids"], batch["bert"],
                               batch["x_lens"], batch["y_lens"], torch.float32)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        opt, _ = ptrain.make_optimizer(leaves, peak_lr=lr, warmup_steps=0, decay_steps=10)
        step_loss = ptrain.make_train_step(cfg, opt, dtype=torch.float32)(p, batch)
        out[str(dev)] = (loss.item(), step_loss.item(), [g.cpu() for g in grads],
                         {k: v.detach().cpu() for k, v in leaves.items()})
    (l0, s0, g0, p0), (l1, s1, g1, p1) = out["cpu"], out[str(cuda_device)]
    assert abs(l1 - l0) <= 1e-4 * abs(l0) and abs(s1 - s0) <= 1e-4 * abs(s0)
    for name, a, b in zip(p0, g0, g1):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4 * float(a.abs().max()),
                                   msg=name)
    for name in p0:
        torch.testing.assert_close(p1[name], p0[name], rtol=0, atol=2 * lr, msg=name)


@pytest.mark.cuda
def test_sovits_gan_step_on_the_card_follows_the_cpu(cuda_device, monkeypatch):
    """One float32 GAN step (D, then G) on the card and on the CPU from the
    same params, batch and draws: every loss within 1e-3 relative (the
    spectrogram, convolutions and their gradients in another order), every
    G and D param within 2·lr of the CPU's (Adam's first step, as above),
    the frozen RVQ leaves bit for bit."""
    from gsv_tts_tpu_torch.models import sovits_train as svt
    from gsv_tts_tpu_torch.parallel.train import Optimizer

    _full_float32(monkeypatch)
    lr = 2e-4
    out = {}
    for dev in ("cpu", cuda_device):
        cfg, g, d, batch, noise, u = _tiny_sovits(dev)
        frozen = {k: v.clone() for k, v in g.items() if k.startswith(svt.FROZEN_PREFIXES)}
        g_opt = Optimizer({k: v.requires_grad_(True) for k, v in g.items() if k not in frozen},
                          lambda _: lr)
        d_opt = Optimizer({k: v.requires_grad_(True) for k, v in d.items()}, lambda _: lr)
        step = svt.make_sovits_train_step(cfg, g_opt, d_opt, n_fft=16, hop_length=4,
                                          win_length=16, sr=16000, segment_frames=16, n_mels=8)
        metrics = step(g, d, batch, noise, u)
        for k, v in frozen.items():
            assert torch.equal(g[k], v), k
        out[str(dev)] = ({k: float(v) for k, v in metrics.items()},
                         {k: v.detach().cpu() for k, v in {**g, **d}.items()})
    (m0, p0), (m1, p1) = out["cpu"], out[str(cuda_device)]
    for k in m0:
        assert abs(m1[k] - m0[k]) <= 1e-3 * abs(m0[k]) + 1e-6, (k, m0[k], m1[k])
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=0, atol=2 * lr, msg=k)


@pytest.mark.cuda
def test_finetune_resumed_on_the_card_equals_straight(cuda_device, tmp_path, monkeypatch):
    """``finetune_t2s`` (bf16) on the card, interrupted and resumed: every
    param equal to the straight run's.  ``finetune_sovits`` (float32): a GAN
    step does not repeat itself bit for bit on the card (cuDNN's default
    convolution algorithms, the STFT's backward in the mel loss and
    ``reflection_pad1d``'s backward sum in no fixed order), so the resumed
    run is held to the card's own spread: no further from the straight run
    (L2 over every param) than 4x a second straight run is."""
    from gsv_tts_tpu_torch.hparams import HParams
    from gsv_tts_tpu_torch.parallel.train import t2s_leaves
    from gsv_tts_tpu_torch.train_loop import finetune_sovits, finetune_t2s

    _full_float32(monkeypatch)
    cfg, samples, _ = _tiny_t2s_batch("cpu")
    kw = dict(total_steps=4, batch_size=2, device=cuda_device, dtype=torch.bfloat16,
              peak_lr=1e-3, warmup_steps=1, export=False, log_fn=lambda *_: None)
    a = finetune_t2s(samples, cfg, str(tmp_path / "a"), **kw)
    finetune_t2s(samples, cfg, str(tmp_path / "b"), max_steps_this_run=1, **kw)
    b = finetune_t2s(samples, cfg, str(tmp_path / "b"), **kw)
    for (name, x), y in zip(t2s_leaves(a).items(), t2s_leaves(b).values()):
        assert torch.equal(x, y), name

    scfg, g, _, batch, _, _ = _tiny_sovits("cpu")
    samples = [(batch["ssl"][i, :, :n].numpy(), batch["spec"][i, :, :n].numpy(),
                batch["wav"][i, :n * 4].numpy(), batch["text"][i].numpy())
               for i, n in enumerate(batch["spec_lens"].tolist())] * 2
    hps = HParams({"data": {"hop_length": 4, "filter_length": 16, "win_length": 16,
                            "sampling_rate": 16000}, "train": {"segment_size": 64}})
    assert scfg.samples_per_frame == 4
    skw = dict(total_steps=3, batch_size=2, init_params=g, device=cuda_device, export=False,
               log_fn=lambda *_: None)
    a = finetune_sovits(samples, scfg, hps, str(tmp_path / "sa"), **skw)
    a2 = finetune_sovits(samples, scfg, hps, str(tmp_path / "sa2"), **skw)
    finetune_sovits(samples, scfg, hps, str(tmp_path / "sb"), max_steps_this_run=1, **skw)
    b = finetune_sovits(samples, scfg, hps, str(tmp_path / "sb"), **skw)
    assert set(a) == set(b) == set(a2)

    def dist(x, y):
        return float(torch.sqrt(sum(((x[k] - y[k]).detach().double() ** 2).sum() for k in x)))

    assert dist(b, a) <= 4 * dist(a2, a) + 1e-6, (dist(b, a), dist(a2, a))


@pytest.fixture(scope="module")
def card_world():
    """One world of one rank over NCCL on the card (``parallel/launch.py``;
    the rank's code is ``torch_parallel_workers.card_world``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL; run on the GPU)")
    import torch_parallel_workers as workers
    from gsv_tts_tpu_torch.parallel.launch import spawn

    return spawn(workers.card_world, 1, timeout=900)[0]


@pytest.mark.cuda
def test_world_of_one_engines_on_the_card(card_world):
    """``make_mesh()`` over NCCL at world 1 (dp=1, tp=1): ``T2SEngine.shard``
    gives the unsharded ``"xla"`` engine's tokens (``generate`` and
    ``generate_batched``) and launches no kernel; ``DataParallelEngine`` gives
    the plain engine's tokens with K1 and K2 launches equal to its steps."""
    assert card_world["sharded"] == card_world["xla"]
    assert card_world["sharded_launches"] == (0, 0)
    assert card_world["dp"] == card_world["plain"][0]
    k1, k2, k1_steps, k2_steps = card_world["dp_launches"]
    assert (k1, k2) == (k1_steps, k2_steps) and k2 > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tp", "seq", "pp"])
def test_world_of_one_train_steps_on_the_card(card_world, kind):
    """At world 1 the dp×tp step and the ``seq_mesh`` step are the
    single-card step bit for bit (the same products, one-rank collectives);
    GPipe at pp=1 with 2 microbatches sums the loss by microbatch: within
    rtol 1e-5, the params within 2·lr (Adam's first step, as above)."""
    loss, leaves = card_world["steps"][kind]
    want_loss, want = card_world["steps"]["single"]
    if kind == "pp":
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
        for k in want:
            torch.testing.assert_close(leaves[k], want[k], rtol=0, atol=2e-3, msg=k)
    else:
        assert loss == want_loss
        for k in want:
            assert torch.equal(leaves[k], want[k]), k


@pytest.mark.cuda
def test_mel_spectrogram_on_the_card_matches_the_cpu(cuda_device):
    """``ops/stft.mel_spectrogram`` with its spectrogram on the card (the
    default) against ``device="cpu"``: the same log-mel to a mean absolute
    difference of 1e-3 (cuFFT against the CPU's FFT), and ``mel_distance`` of
    a clip with itself 0."""
    import numpy as np

    from gsv_tts_tpu_torch.ops import stft

    rng = np.random.RandomState(0)
    t = np.arange(32000 * 2) / 32000
    audio = (0.4 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
             + 0.05 * rng.randn(t.size)).astype(np.float32)
    card, cpu = stft.mel_spectrogram(audio), stft.mel_spectrogram(audio, device="cpu")
    assert card.shape == cpu.shape == (128, audio.size // 640 + 1)
    assert float(np.mean(np.abs(card - cpu))) <= 1e-3
    assert stft.mel_distance(audio, audio) == 0.0


@pytest.mark.cuda
def test_cfm_chunk_graph_matches_eager(cuda_device):
    """GPT-SoVITS v4's Euler loop with each step a replay of one CUDA graph
    keyed by the chunk's frames (``SovitsGraphs.run``, as the facade runs
    it) against the same loop run eagerly, in bf16 at a small width on the
    card: the first chunk at T captures once and replays every step; a
    second chunk at T with other inputs and another prompt length replays
    the same graph and still equals its eager loop."""
    import functools

    from gsv_tts_tpu_torch.models import cfm
    from gsv_tts_tpu_torch.tts import SovitsGraphs

    cfg = cfm.DiTConfig(dim=256, depth=3, heads=4, dim_head=64, text_dim=64, conv_layers=2,
                        freq_embed_dim=64)
    steps = 8
    p = {k: v.to(cuda_device, torch.bfloat16) for k, v in
         cfm.prepare_params(cfm.init_params(cfg, torch.Generator().manual_seed(0)), cfg,
                            steps).items()}
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    graphs = SovitsGraphs()
    run = functools.partial(graphs.run, p, ("cfm", 300))
    T = 300
    for k, P in enumerate((120, 90)):
        fea = torch.randn((1, 64, T), generator=gen, device=cuda_device).to(torch.bfloat16)
        prompt = torch.randn((1, 100, P), generator=gen, device=cuda_device)
        noise = torch.randn((1, 100, T), generator=gen, device=cuda_device)
        want = cfm.cfm_chunk(p, cfg, fea, prompt, noise)
        got = cfm.cfm_chunk(p, cfg, fea, prompt, noise, run=run)
        torch.cuda.synchronize()
        assert (graphs.captures, graphs.replays) == (1, (k + 1) * steps)
        assert float(got[..., :P].abs().max()) == 0.0
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_v4_vocoder_graph_at_a_bucket_equals_the_vocoder_at_its_length(cuda_device):
    """The 48 kHz vocoder as the facade runs it, one CUDA graph per frame
    bucket with every layer cut at the mel's frames (a tensor input), in
    float32 on the card, biases drawn non-zero and the bucket padded with
    fives: two mels of other lengths through one bucket's graph each equal
    the vocoder run eagerly at their own lengths."""
    from gsv_tts_tpu_torch.models import sovits_v4
    from gsv_tts_tpu_torch.tts import SovitsGraphs

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    v4 = sovits_v4.V4Config()
    g = torch.Generator().manual_seed(0)
    vp = {k: (v + torch.randn(v.shape, generator=g) * 0.1 if k.endswith("bias") else v)
          .to(cuda_device) for k, v in sovits_v4.vocoder_params(
              sovits_v4.init_vocoder(v4, g), torch.float32, "cpu").items()}
    graphs = SovitsGraphs()
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    for t in (61, 40):
        mel = torch.randn((1, 100, t), generator=gen, device=cuda_device) * 2 - 6
        want = sovits_v4.vocode(vp, v4, mel)
        frames = torch.full((1,), t, dtype=torch.int64, device=cuda_device)
        got, = graphs.run(vp, ("vocoder", 64), lambda m, n: sovits_v4.vocode(vp, v4, m, n),
                          torch.nn.functional.pad(mel, (0, 64 - t), value=5.0), frames)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[..., : t * 480], want, rtol=0, atol=1e-4)
    assert (graphs.captures, graphs.replays) == (1, 2)


def _tiny_v4_dir(root):
    """A v4 SoVITS directory at small widths (v2's text encoder at 64, a DiT
    of width 128 and text width 64, a two-stage vocoder), every bias drawn
    non-zero so that a padded frame left unmasked would show."""
    import json

    from gsv_tts_tpu_torch.models import sovits, sovits_v4
    from gsv_tts_tpu_torch.utils.safetensors import save_file

    dit = {"dim": 128, "depth": 2, "heads": 4, "dim_head": 32, "ff_mult": 2, "mel_dim": 100,
           "text_dim": 64, "conv_layers": 2, "conv_mult": 2, "freq_embed_dim": 64,
           "conv_pos_kernel": 31, "conv_pos_groups": 16}
    vocoder = {"initial_channel": 100, "resblock_kernel_sizes": [3],
               "resblock_dilation_sizes": [[1, 3]], "upsample_rates": [10, 48],
               "upsample_initial_channel": 32, "upsample_kernel_sizes": [20, 96]}
    hps = {"data": {"filter_length": 1408, "hop_length": 320, "win_length": 1408,
                    "sampling_rate": 32000},
           "train": {"segment_size": 1280},
           "model": {"inter_channels": 64, "hidden_channels": 64, "filter_channels": 96,
                     "n_heads": 2, "n_layers": 2, "kernel_size": 3, "p_dropout": 0.0,
                     "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1, 3, 5]],
                     "upsample_rates": [8, 5, 4, 4], "upsample_initial_channel": 32,
                     "upsample_kernel_sizes": [16, 11, 8, 8], "gin_channels": 512,
                     "version": "v4", "cfm": dit, "t_ref": 50, "t_chunk": 130,
                     "cfm_steps": 4},
           "vocoder": vocoder}
    cfg = sovits.SovitsConfig.from_hps(hps["model"], 705)
    v4 = sovits_v4.V4Config.from_hps(hps)
    g = torch.Generator().manual_seed(0)
    p = {k: v + torch.randn(v.shape, generator=g) * 0.1 if k.endswith("bias") else v
         for k, v in sovits_v4.init_params(cfg, v4, g).items()}
    root.mkdir()
    save_file(p, root / "model.safetensors")
    torch.save(sovits_v4.init_vocoder(v4, g), str(root / "vocoder.pth"))
    (root / "hps.json").write_text(json.dumps(hps))
    return str(root)


@pytest.mark.cuda
def test_v4_encp_graphs_are_captured_at_load_and_replay_as_the_exact_call(cuda_device, tmp_path,
                                                                          monkeypatch):
    """Loading a v4 model captures its padded ``decode_encp`` at every bucket
    (``gpt_cache`` (1, 128): codes 32, 64, 96, 128 × phones 32, 128 = 8
    graphs).  A replay cut to the valid frames equals the exact eager call
    in bf16: both sum the same bf16 products, in orders that cuDNN picks per
    shape, through 15 convolutions and 12 attention layers, so they agree
    to within 3 % in relative L2 (features) and 1e-2 absolute (attention
    probabilities).  A v4 decode within the buckets runs both of its calls
    (the prompt's and the output's) as replays and captures no ``encp``
    graph."""
    import numpy as np

    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.models import sovits_v4

    monkeypatch.setenv("GSV_OFFLINE", "1")
    path = _tiny_v4_dir(tmp_path / "v4")
    tts = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(tmp_path),
              device=cuda_device, seed=0)
    tts.load_sovits_model(path)
    graphs, model = tts.sovits_graphs, tts.sovits_models[path]
    encp = sorted(k[2:] for k in graphs.graphs if k[0] == "encp")
    assert encp == [(c, n) for c in (32, 64, 96, 128) for n in (32, 128)]
    assert graphs.captures == 8
    rng = np.random.RandomState(1)
    codes, text = rng.randint(0, 1024, 41), rng.randint(1, 300, 20)
    ge = (torch.randn((1, 512, 1), generator=torch.Generator().manual_seed(2)) * 0.5).to(
        cuda_device, torch.bfloat16)
    with torch.no_grad():
        (fea, attn), names = _span_names(lambda: tts._encp(model, tts._encp_inputs(codes, text),
                                                           ge))
        want_fea, want_attn = sovits_v4.decode_encp(
            model.params, model.cfg, model.v4, torch.as_tensor(codes, device=cuda_device)[None, None],
            torch.as_tensor(text, device=cuda_device)[None], ge)
    torch.cuda.synchronize()
    assert names.count("gsv.sovits.encp.replay") == 1 and "gsv.sovits.capture" not in names
    assert fea.shape == want_fea.shape == (1, 64, 4 * 41)
    assert attn.shape == want_attn.shape == (1, 4, 2 * 41, 20)
    rel = float((fea.float() - want_fea.float()).norm() / want_fea.float().norm())
    err = float((attn - want_attn).abs().max())
    print(f"encp replay against eager (bf16): fea rel L2 {rel:.3g}, attn max abs {err:.3g}")
    assert rel <= 3e-2 and err <= 1e-2

    prompt = {"prompt": rng.randint(0, 1024, 30), "phones1": rng.randint(1, 300, 12),
              "mel_v4": torch.randn((1, 100, 100), generator=torch.Generator().manual_seed(3))
              .to(cuda_device) * 0.5}
    before, captures = set(graphs.graphs), graphs.captures
    with torch.no_grad():
        (audio, got_attn), names = _span_names(
            lambda: tts._v4_decode(model, codes[None, None], text[None], ge, prompt))
    new = set(graphs.graphs) - before
    assert names.count("gsv.sovits.encp.replay") == 2 and "gsv.sovits.encp.eager" not in names
    assert {k[0] for k in new} <= {"cfm", "vocoder"} and graphs.captures == captures + len(new)
    assert audio.shape[-1] == 480 * 4 * 41 and np.isfinite(audio).all()
    np.testing.assert_allclose(got_attn, attn[0].float().cpu().numpy(), atol=1e-2, rtol=0)
