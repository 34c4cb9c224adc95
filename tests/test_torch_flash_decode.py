"""K3a / K3b, the decode attention (``gsv_tts_tpu_torch/ops/flash_decode.py``):
the plain twin against the JAX TPU kernels run in interpret mode, mirroring
``test_flash_decode.py:11-50``.  The CUDA kernel itself is held against the
twin in ``test_torch_cuda.py``.

Tolerance: rtol=2e-5, atol=2e-5 in float32 (the JAX suite's own bound for the
kernel against its XLA twin: online-softmax blocks vs one softmax, i.e.
summation order only)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gsv_tts_tpu.ops import flash_decode as jfd
from gsv_tts_tpu_torch.ops import flash_decode as pfd

RTOL = ATOL = 2e-5


def _qkv(seed, *cache_shape):
    rng = np.random.RandomState(seed)
    B, H, Dh = cache_shape[-4], cache_shape[-2], cache_shape[-1]
    return (rng.randn(B, H, Dh).astype(np.float32), rng.randn(*cache_shape).astype(np.float32),
            rng.randn(*cache_shape).astype(np.float32))


@pytest.mark.parametrize("kv_len", [0, 5, 127, 128, 200, 511])
def test_k3a_twin_matches_interpret_kernel(kv_len):
    q, k, v = _qkv(0, 1, 512, 4, 32)
    ref = jfd.flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray([kv_len], jnp.int32), interpret=True)
    ours = pfd.flash_decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                      torch.tensor([kv_len], dtype=torch.int32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert pfd.flash_decode_attention.launches == 0  # the twin never counts


def test_k3a_twin_ragged_batch_matches_interpret_kernel():
    q, k, v = _qkv(1, 3, 256, 2, 16)
    lens = [3, 130, 255]
    ref = jfd.flash_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(lens, jnp.int32), interpret=True)
    ours = pfd.flash_decode_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                      torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # rows past kv_len do not enter: poisoning them changes nothing
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(lens):
        k2[b, n + 1:] = np.nan
        v2[b, n + 1:] = np.nan
    again = pfd.flash_decode_attention(torch.tensor(q), torch.tensor(k2).nan_to_num(1e4),
                                       torch.tensor(v2).nan_to_num(1e4),
                                       torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_allclose(again.numpy(), ours.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_k3b_twin_layered_matches_interpret_kernel(layer):
    q, kc, vc = _qkv(2, 3, 2, 256, 4, 32)
    lens = [40, 201]
    ref = jfd.flash_decode_attention_layered(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens, jnp.int32),
        jnp.asarray(layer, jnp.int32), interpret=True)
    ours = pfd.flash_decode_attention_layered(
        torch.tensor(q), torch.tensor(kc), torch.tensor(vc),
        torch.tensor(lens, dtype=torch.int32), layer)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    same = pfd.flash_decode_attention(torch.tensor(q), torch.tensor(kc[layer]),
                                      torch.tensor(vc[layer]),
                                      torch.tensor(lens, dtype=torch.int32))
    assert torch.equal(ours, same)


def test_k3_wrapper_checks_shapes_and_device():
    q, kc, vc = (torch.tensor(a) for a in _qkv(3, 2, 2, 64, 4, 32))
    lens = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="layer 2 outside"):
        pfd.flash_decode_attention_layered(q, kc, vc, lens, 2)
    with pytest.raises(ValueError, match="kv_len"):
        pfd.flash_decode_attention(q, kc[0], vc[0], lens[:1])
    with pytest.raises(ValueError, match="q "):
        pfd.flash_decode_attention(q[:, :2], kc[0], vc[0], lens)
    with pytest.raises(ValueError, match="runs on CUDA"):
        pfd.flash_decode_attention(q.to("meta"), kc[0].to("meta"), vc[0].to("meta"),
                                   lens.to("meta"))
