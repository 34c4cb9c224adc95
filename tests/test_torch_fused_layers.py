"""K5 (all layers, one token, B=1: ``ops/fused_step.py:fused_decode_step``)
and K6 (one layer, one token per row: ``ops/fused_layer.py``): the plain twins
against the JAX TPU kernels run in interpret mode, mirroring
``test_flash_decode.py:81-158``, and ``transformer_decode_step`` under each
implementation name against the JAX one.  The CUDA kernels themselves are
held against the twins in ``test_torch_cuda.py``.

Tolerance: rtol=2e-4, atol=2e-5 in float32 (summation order only)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import jax_t2s
from test_torch_t2s import port_t2s
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5


def _state(cfg, seed, B, S):
    rng = np.random.RandomState(seed)
    shape = (cfg.num_layers, B, S, cfg.num_heads, cfg.head_dim)
    return (rng.randn(B, cfg.hidden_dim).astype(np.float32),
            rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32))


def _close(ours, ref):
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_convert_gives_k5_and_k6_the_same_layers():
    """``convert.t2s_from_jax`` turns the stacked JAX pytree into the list K5
    takes whole and K6 takes one dict of: entry i is layer i of every stacked
    leaf, matrices transposed to ``[out, in]``."""
    cfg, jp = jax_t2s(4, num_layers=3)
    _, pp = port_t2s(cfg, jp)
    layers = pp["layers"]
    assert len(layers) == 3
    for i, lp in enumerate(layers):
        assert set(lp) == set(jp["layers"])
        for name, t in lp.items():
            ref = np.asarray(jp["layers"][name][i])
            np.testing.assert_array_equal(t.numpy(), ref.T if name.endswith("_w") else ref)
            assert t.is_contiguous()


@pytest.mark.parametrize("kv", [0, 127, 140, 255])
def test_k5_twin_matches_interpret_kernel(kv):
    from gsv_tts_tpu.ops.fused_step import fused_decode_step as jk5
    from gsv_tts_tpu_torch.ops.fused_step import fused_decode_step as pk5

    cfg, jp = jax_t2s(5, num_layers=3)
    _, pp = port_t2s(cfg, jp)
    x, kc, vc = _state(cfg, kv, 1, 256)
    jh, jkc, jvc = jk5(jnp.asarray(x), jp["layers"], jnp.asarray(kc), jnp.asarray(vc),
                       jnp.asarray([kv], jnp.int32), interpret=True)
    tk, tv = torch.tensor(kc), torch.tensor(vc)
    ph, pkc, pvc = pk5(torch.tensor(x), pp["layers"], tk, tv,
                       torch.tensor([kv], dtype=torch.int32))
    assert pkc is tk and pvc is tv  # appended in place
    _close(ph, jh)
    _close(pkc, jkc)
    _close(pvc, jvc)
    # only row kv of every layer changed
    changed = (pkc != torch.tensor(kc)).any(-1).any(-1)  # [L, 1, S]
    assert changed[:, 0, kv].all() and int(changed.sum()) == cfg.num_layers
    assert pk5.launches == 0  # the twin never counts


def test_k5_wrapper_checks():
    from gsv_tts_tpu_torch.ops.fused_step import fused_decode_step as pk5

    cfg, jp = jax_t2s(5)
    _, pp = port_t2s(cfg, jp)
    x, kc, vc = (torch.tensor(a) for a in _state(cfg, 0, 2, 64))
    kv = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="batch 2: this kernel is B=1"):
        pk5(x, pp["layers"], kc, vc, kv)
    with pytest.raises(ValueError, match=r"kv_len must be a \[1\] tensor"):
        pk5(x[:1], pp["layers"], kc[:, :1], vc[:, :1], kv)
    with pytest.raises(ValueError, match="kv_len outside the cache"):
        pk5(x[:1], pp["layers"], kc[:, :1], vc[:, :1], torch.tensor([64], dtype=torch.int32))
    with pytest.raises(ValueError, match="1 layers for a 2-layer cache"):
        pk5(x[:1], pp["layers"][:1], kc[:, :1], vc[:, :1], kv[:1])
    with pytest.raises(ValueError, match="runs on CUDA"):
        pk5(x[:1].to("meta"), pp["layers"], kc[:, :1].to("meta"), vc[:, :1].to("meta"),
            kv[:1].to("meta"))


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_k6_twin_matches_interpret_kernel(layer):
    from gsv_tts_tpu.ops.fused_layer import fused_decode_layer as jk6
    from gsv_tts_tpu_torch.ops.fused_layer import fused_decode_layer as pk6

    cfg, jp = jax_t2s(6, num_layers=3)
    _, pp = port_t2s(cfg, jp)
    B, S = 3, 256
    lens = [140, 0, 255]
    x, kc, vc = _state(cfg, layer, B, S)
    jlp = jax.tree.map(lambda a: a[layer], jp["layers"])
    jh, jkc, jvc = jk6(jnp.asarray(x), jlp, jnp.asarray(kc), jnp.asarray(vc),
                       jnp.asarray(lens, jnp.int32), layer, interpret=True)
    tk, tv = torch.tensor(kc), torch.tensor(vc)
    ph, pkc, pvc = pk6(torch.tensor(x), pp["layers"][layer], tk, tv,
                       torch.tensor(lens, dtype=torch.int32), layer)
    assert pkc is tk and pvc is tv
    _close(ph, jh)
    _close(pkc, jkc)
    _close(pvc, jvc)
    changed = (pvc != torch.tensor(vc)).any(-1).any(-1)  # [L, B, S]
    assert int(changed.sum()) == B and all(changed[layer, b, n] for b, n in enumerate(lens))
    assert pk6.launches == 0


def test_k6_rows_are_independent_and_wrapper_checks():
    """A wave of 11 rows (above the kernel's 8-row launch) equals its rows
    taken one at a time; bad arguments raise."""
    from gsv_tts_tpu_torch.ops.fused_layer import fused_decode_layer as pk6

    cfg, jp = jax_t2s(6)
    _, pp = port_t2s(cfg, jp)
    B, S = 11, 64
    x, kc, vc = (torch.tensor(a) for a in _state(cfg, 9, B, S))
    lens = torch.tensor([0, 63, 5, 17, 40, 1, 62, 33, 8, 21, 50], dtype=torch.int32)
    whole, wk, _ = pk6(x, pp["layers"][1], kc.clone(), vc.clone(), lens, 1)
    for b in (0, 1, 10):
        one, ok, _ = pk6(x[b:b + 1], pp["layers"][1], kc[:, b:b + 1].clone(),
                         vc[:, b:b + 1].clone(), lens[b:b + 1], 1)
        np.testing.assert_allclose(one.numpy(), whole[b:b + 1].numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ok.numpy(), wk[:, b:b + 1].numpy(), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="layer 2 outside"):
        pk6(x, pp["layers"][1], kc, vc, lens, 2)
    with pytest.raises(ValueError, match="x .* is not"):
        pk6(x[:, :64], pp["layers"][1], kc, vc, lens, 1)
    with pytest.raises(ValueError, match="kv_len outside the cache"):
        pk6(x, pp["layers"][1], kc, vc, lens + 1, 1)


@pytest.mark.parametrize("impl,jimpl,B", [("flash", "flash_interpret", 1),
                                          ("flash", "flash_interpret", 3),
                                          ("fused_step", "fused_step_interpret", 1),
                                          ("fused_step", "fused_step_interpret", 3),
                                          ("fused", "fused_interpret", 1),
                                          ("fused", "fused_interpret", 3),
                                          ("fused", "fused_interpret", 5),
                                          ("fused", "fused_interpret", 11)])
def test_transformer_decode_step_under_each_impl_matches_jax(impl, jimpl, B):
    """Each implementation name against the JAX step under the same name in
    interpret mode and under ``"xla"``; ``"fused_step"`` at B > 1 degrades to
    ``"flash"`` on both sides.  Under ``"fused"``, B = 5 and 11 are the waves
    the card's K6 runs with dead rows (a group of 5 at its 8-row size; 8 and
    then 3 at its 4-row size)."""
    from gsv_tts_tpu.models import t2s as jt2s
    from gsv_tts_tpu_torch.models import t2s as pt2s

    cfg, jp = jax_t2s(7)
    pcfg, pp = port_t2s(cfg, jp)
    S = 128
    lens = [40, 0, 127, 1, 64, 100, 63, 2, 126, 17, 90][:B]
    x, kc, vc = _state(cfg, B, B, S)
    jargs = (jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens, jnp.int32))
    jh, jkc, jvc = jt2s.transformer_decode_step(jp, cfg, *jargs, jimpl)
    xh, _, _ = jt2s.transformer_decode_step(jp, cfg, *jargs, "xla")
    ph, pkc, pvc = pt2s.transformer_decode_step(
        pp, pcfg, torch.tensor(x), torch.tensor(kc), torch.tensor(vc),
        torch.tensor(lens, dtype=torch.int32), impl)
    _close(ph, jh)
    _close(ph, xh)
    _close(pkc, jkc)
    _close(pvc, jvc)


def test_transformer_decode_step_rejects_unknown_impl():
    from gsv_tts_tpu_torch.models import t2s as pt2s

    cfg, jp = jax_t2s(7)
    pcfg, pp = port_t2s(cfg, jp)
    x, kc, vc = (torch.tensor(a) for a in _state(cfg, 0, 1, 64))
    # ("xla" is a known name since use_flash_attn is ported: the JAX
    # package's interpret-mode names are what the port does not take)
    with pytest.raises(ValueError, match="attn_impl 'xla_interpret'"):
        pt2s.transformer_decode_step(pp, pcfg, x, kc, vc, torch.tensor([3], dtype=torch.int32),
                                     "xla_interpret")
