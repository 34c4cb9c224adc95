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
@pytest.mark.parametrize("B", [1, 5, 8, 11])
def test_k6_cuda_kernel_matches_twin(cuda_device, B):
    """K6 against its twin on the card for every layer index, ragged lengths
    (0 and S-1 among them), rows past ``kv_len`` poisoned; above 8 rows the
    wrapper launches the kernel in groups.  Layer 0 goes through a table the
    wrapper builds for the call, the others through one table over all
    layers."""
    from gsv_tts_tpu_torch.ops import fused_layer, fused_step

    S = 200
    cfg, params, x, kc, vc = _layer_fixture(cuda_device, B, S, 4)
    x = x.to(torch.bfloat16)
    lens = ([0, S - 1, 63, 64, 150, 1, 128, 17, 90, 199, 33])[:B]
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
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
        fused_step.check(cuda_device)
        assert bool(torch.isfinite(h.float()).all())
        torch.testing.assert_close(h.float(), rh.float(), rtol=2e-2, atol=2e-2)
        for b, n in enumerate(lens):
            torch.testing.assert_close(ka[layer, b, n], kb[layer, b, n], rtol=2e-2, atol=2e-2)
            torch.testing.assert_close(va[layer, b, n], vb[layer, b, n], rtol=2e-2, atol=2e-2)
            assert bool(torch.isnan(ka[layer, b, n + 1:].float()).all())  # untouched
            assert bool(torch.isnan(va[layer, b, n + 1:].float()).all())
            assert torch.equal(ka[layer, b, :n], kc[layer, b, :n])
            assert torch.equal(va[layer, b, :n], vc[layer, b, :n])
    groups = -(-B // fused_step.MAX_FUSED_B)
    assert fused_layer.fused_decode_layer.launches == before + cfg.num_layers * groups


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
