"""K4, the hybrid-mask prefill attention
(``gsv_tts_tpu_torch/ops/flash_prefill.py``): the plain twin against the JAX
TPU kernel run in interpret mode and against the masked-softmax prefill,
mirroring ``test_flash_decode.py:520-604``; then ``transformer_prefill`` under
``impl="flash"`` against the JAX one.  The CUDA kernel itself is held against
the twin in ``test_torch_cuda.py``.

Tolerance: rtol=2e-4, atol=2e-5 in float32 (summation order only)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsv_tts_tpu.ops import flash_prefill as jfp
from gsv_tts_tpu_torch.ops import flash_prefill as pfp

from test_torch_assets import jax_t2s
from test_torch_t2s import port_t2s, prompt
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


def _qkv(seed, B, T, H, Dh):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, T, H, Dh).astype(np.float32) for _ in range(3))


def _both(q, k, v, xl, xyl):
    H = q.shape[2]
    ref = jfp.flash_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(xl, jnp.int32),
        jnp.asarray(xyl, jnp.int32), num_heads=H, interpret=True)
    ours = pfp.flash_prefill_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        torch.tensor(xl, dtype=torch.int32), torch.tensor(xyl, dtype=torch.int32), num_heads=H)
    return np.asarray(ref), ours.numpy()


@pytest.mark.parametrize("T,xl,xyl", [(64, 20, 50), (64, 1, 64), (64, 64, 64), (96, 33, 34),
                                      (32, 1, 2), (160, 70, 131)])
def test_k4_twin_matches_interpret_kernel(T, xl, xyl):
    """One prompt: a pad tail, one phoneme (``xl = 1``), no audio rows
    (``xl = T``), the 1/1 dummy lengths of a dead slot, more than one query
    tile of the TPU kernel."""
    q, k, v = _qkv(T + xl, 1, T, 4, 32)
    ref, ours = _both(q, k, v, [xl], [xyl])
    assert ours.shape == (1, T, 128)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    assert pfp.flash_prefill_attention.launches == 0  # the twin never counts


def test_k4_twin_ragged_batch_matches_interpret_kernel_and_masked_softmax():
    """Rows of a batch with different lengths; the twin also equals the
    plain prefill's masked softmax under ``hybrid_mask``, and columns past
    a row's limit do not enter."""
    B, T, H, Dh = 3, 64, 2, 16
    q, k, v = _qkv(7, B, T, H, Dh)
    xl, xyl = [10, 31, 1], [40, 64, 2]
    ref, ours = _both(q, k, v, xl, xyl)
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    mask = pfp.hybrid_mask(T, torch.tensor(xl), torch.tensor(xyl))
    scores = torch.einsum("bqhd,bkhd->bhqk", tq, tk) / np.sqrt(Dh)
    probs = torch.softmax(scores.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    plain = torch.einsum("bhqk,bkhd->bqhd", probs, tv).reshape(B, T, H * Dh)
    np.testing.assert_allclose(ours, plain.numpy(), rtol=RTOL, atol=ATOL)
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(xyl):
        k2[b, n:] = 1e4
        v2[b, n:] = 1e4
    _, again = _both(q, k2, v2, xl, xyl)
    np.testing.assert_allclose(again, ours, rtol=1e-6, atol=1e-6)


def test_hybrid_mask_is_the_rule_of_the_tpu_kernel():
    T, xl, xyl = 12, 4, 9
    mask = pfp.hybrid_mask(T, torch.tensor([xl]), torch.tensor([xyl]))[0].numpy()
    for r in range(T):
        for c in range(T):
            want = (c < xl if r < xl else c <= r) and c < xyl
            assert mask[r, c] == want, (r, c)
    assert mask.any(axis=1).all()  # pad rows attend the valid columns


def test_k4_takes_strided_views_of_the_qkv_product():
    """The model passes slices of one [B, T, 3D] product."""
    rng = np.random.RandomState(11)
    B, T, H, Dh = 2, 32, 4, 32
    D = H * Dh
    qkv = torch.tensor(rng.randn(B, T, 3 * D).astype(np.float32))
    q, k, v = (t.reshape(B, T, H, Dh) for t in qkv.split(D, dim=-1))
    assert not q.is_contiguous()
    lens = torch.tensor([7, 20], dtype=torch.int32), torch.tensor([19, 32], dtype=torch.int32)
    out = pfp.flash_prefill_attention(q, k, v, *lens, num_heads=H)
    same = pfp.flash_prefill_attention(q.contiguous(), k.contiguous(), v.contiguous(), *lens,
                                       num_heads=H)
    assert torch.equal(out, same)


def test_k4_wrapper_checks_shapes_lengths_and_device():
    q, k, v = (torch.tensor(a) for a in _qkv(3, 2, 32, 4, 32))
    xl = torch.tensor([3, 4], dtype=torch.int32)
    xyl = torch.tensor([9, 32], dtype=torch.int32)
    with pytest.raises(ValueError, match="num_heads=2"):
        pfp.flash_prefill_attention(q, k, v, xl, xyl, num_heads=2)
    with pytest.raises(ValueError, match="shapes"):
        pfp.flash_prefill_attention(q, k[:, :16], v, xl, xyl, num_heads=4)
    with pytest.raises(ValueError, match=r"x_lens must be a \[2\] tensor"):
        pfp.flash_prefill_attention(q, k, v, xl[:1], xyl, num_heads=4)
    with pytest.raises(ValueError, match="lengths outside"):
        pfp.flash_prefill_attention(q, k, v, xl, torch.tensor([9, 33], dtype=torch.int32),
                                    num_heads=4)
    with pytest.raises(ValueError, match="lengths outside"):
        pfp.flash_prefill_attention(q, k, v, xl, torch.tensor([0, 5], dtype=torch.int32),
                                    num_heads=4)
    with pytest.raises(ValueError, match="runs on CUDA"):
        pfp.flash_prefill_attention(*(t.to("meta") for t in (q, k, v, xl, xyl)), num_heads=4)


@pytest.mark.parametrize("lx,ly,pad", [(13, 9, (32, 32)), (32, 20, (32, 32)), (5, 1, (32, 64))])
def test_transformer_prefill_flash_matches_jax(lx, ly, pad):
    """``transformer_prefill(impl="flash")`` — K4's twin in every layer, no
    mask tensor — against the JAX prefill through its kernel in interpret
    mode and through XLA."""
    from gsv_tts_tpu.models import t2s as jt2s
    from gsv_tts_tpu_torch.models import t2s as pt2s

    cfg, jp = jax_t2s(3)
    pcfg, pp = port_t2s(cfg, jp)
    x, y, bert, lx, ly = prompt(cfg, lx + ly, lx, ly, pad)
    jxy, jmask, _ = jt2s.embed_prompt_batch(
        jp, cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(bert),
        jnp.asarray([lx]), jnp.asarray([ly]), jnp.float32)
    jlens = (jnp.asarray([lx], jnp.int32), jnp.asarray([lx + ly], jnp.int32))
    jh, jks, jvs = jt2s.transformer_prefill(jp, cfg, jxy, jmask, lens=jlens,
                                            impl="flash_interpret")
    xh, _, _ = jt2s.transformer_prefill(jp, cfg, jxy, jmask)

    pxy, pmask, _ = pt2s.embed_prompt_batch(
        pp, pcfg, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(bert),
        torch.tensor([lx]), torch.tensor([ly]), torch.float32, with_mask=False)
    assert pmask is None
    lens = (torch.tensor([lx]), torch.tensor([lx + ly]))
    ph, pks, pvs = pt2s.transformer_prefill(pp, pcfg, pxy, None, lens=lens, impl="flash")
    n = lx + ly  # rows past the prompt are padding
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ph[:, :n].numpy(), np.asarray(xh)[:, :n], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pks.numpy(), np.asarray(jks), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pvs.numpy(), np.asarray(jvs), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="needs attn_mask"):
        pt2s.transformer_prefill(pp, pcfg, pxy, None)
    with pytest.raises(ValueError, match="prefill impl"):
        pt2s.transformer_prefill(pp, pcfg, pxy, None, lens=lens, impl="xla")


@pytest.mark.parametrize("with_mask", [False, True])
def test_transformer_prefill_flash_needs_lens(with_mask):
    """A caller who names the kernel gets the kernel's route or an error:
    ``impl="flash"`` without ``lens`` raises, with or without a mask tensor
    to fall back on."""
    from gsv_tts_tpu_torch.models import t2s as pt2s

    cfg, jp = jax_t2s(2)
    pcfg, pp = port_t2s(cfg, jp)
    x, y, bert, lx, ly = prompt(cfg, 22, 13, 9, (32, 32))
    pxy, pmask, _ = pt2s.embed_prompt_batch(
        pp, pcfg, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(bert),
        torch.tensor([lx]), torch.tensor([ly]), torch.float32, with_mask=with_mask)
    before = pfp.flash_prefill_attention.launches
    with pytest.raises(ValueError, match="needs lens"):
        pt2s.transformer_prefill(pp, pcfg, pxy, pmask, impl="flash")
    with pytest.raises(ValueError, match="needs lens"):
        pt2s.transformer_prefill(pp, pcfg, pxy, pmask, lens=None, impl="flash")
    assert pfp.flash_prefill_attention.launches == before
