"""The engine's ``attn_impl`` option
(``gsv_tts_tpu_torch/runtime/t2s_session.py:T2SEngine``): each name routes
its prefill and decode steps as the JAX engine does, and generates the JAX
engine's tokens — the port's twins against the JAX kernels in interpret mode
(``"flash"`` ↔ ``"flash_interpret"``, ``"fused"`` ↔ ``"fused_interpret"``)
and the default against JAX's XLA path.

With ``top_k=1`` the chains are greedy, so tokens are compared exactly, over
a bounded prefix (two float32 implementations may part at a near-tie)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import jax_t2s
from test_torch_engine_batched import requests
from test_torch_fused_step import SMALL, _jax_noise_chain
from test_torch_t2s import port_t2s
from test_torch_assets import one_torch_thread  # noqa: F401

PREFIX = 30
PAIRS = [("fused_step", "xla"), ("flash", "flash_interpret"), ("fused", "fused_interpret")]


@pytest.fixture(scope="module")
def models():
    cfg, jp = jax_t2s(2, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    return cfg, jp, pcfg, pp


def _engines(models, impl, jimpl, gpt_cache):
    from gsv_tts_tpu.runtime.t2s_session import T2SEngine as JEngine
    from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine

    cfg, jp, pcfg, pp = models
    return (JEngine(jp, cfg, gpt_cache=gpt_cache, dtype=jnp.float32, attn_impl=jimpl),
            T2SEngine(pp, pcfg, gpt_cache=gpt_cache, attn_impl=impl))


def _count(monkeypatch, module, name, calls):
    orig = getattr(module, name)

    def counted(*a, **kw):
        calls[name] = calls.get(name, 0) + 1
        return orig(*a, **kw)

    monkeypatch.setattr(module, name, counted)


def _count_kernels(monkeypatch):
    """Counts calls of every kernel wrapper at the place the engine and the
    model look them up."""
    from gsv_tts_tpu_torch.models import t2s as pt2s
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    calls = {}
    for module, name in ((ps, "fused_decode_step_sample"),
                         (ps, "fused_decode_step_sample_batched"),
                         (pt2s, "flash_decode_attention_layered"),
                         (pt2s, "flash_prefill_attention"), (pt2s, "fused_decode_step"),
                         (pt2s, "fused_decode_layer")):
        _count(monkeypatch, module, name, calls)
    return calls


def test_engine_accepts_the_three_names_and_rejects_the_rest(models):
    """The three kernel names, ``"xla"`` (the path without a kernel, since
    ``use_flash_attn`` is ported) and the two quantized whole-step names
    construct an engine (the quantized ones with their pages packed); any
    other name raises."""
    from gsv_tts_tpu_torch.ops.fused_step import QUANT_KEYS
    from gsv_tts_tpu_torch.runtime.t2s_session import ATTN_IMPLS, QUANT_IMPLS, T2SEngine

    _, _, pcfg, pp = models
    assert ATTN_IMPLS == ("fused_step", "flash", "fused", "xla")
    assert T2SEngine(pp, pcfg, gpt_cache=[(1, 128)]).attn_impl == "fused_step"
    for name in ATTN_IMPLS:
        assert T2SEngine(pp, pcfg, gpt_cache=[(1, 128)], attn_impl=name).attn_impl == name
    for name in ("xla_interpret", "flash_interpret", "fused_step:vec", "", "fused_step_q8_interpret",
                 "fused_step_q3", "fused_q8"):
        with pytest.raises(ValueError, match="attn_impl"):
            T2SEngine(pp, pcfg, gpt_cache=[(1, 128)], attn_impl=name)
    assert QUANT_IMPLS == {"fused_step_q8": "int8", "fused_step_q4": "int4"}
    for name, quant in QUANT_IMPLS.items():
        eng = T2SEngine(pp, pcfg, gpt_cache=[(1, 128)], attn_impl=name)
        assert eng.attn_impl == name and eng.quant == quant
        assert len(eng.params[QUANT_KEYS[quant]]) == pcfg.num_layers


def test_config_attn_impl_reaches_the_engine(tmp_path):
    from gsv_tts_tpu.loader import save_trained_gpt
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_gpt_weights

    cfg, jp = jax_t2s(0)
    save_trained_gpt(jp, cfg, str(tmp_path / "gpt"))
    assert Config(device="cpu").attn_impl == "fused_step"
    for name in ("fused_step", "flash", "fused", "xla"):
        gpt = get_gpt_weights(tmp_path / "gpt", Config(device="cpu", attn_impl=name))
        assert gpt.engine.attn_impl == name
    with pytest.raises(ValueError, match="attn_impl 'flash_interpret'"):
        get_gpt_weights(tmp_path / "gpt", Config(device="cpu", attn_impl="flash_interpret"))
    tts = TTS(gpt_cache=[(1, 128)], models_dir=str(tmp_path), device="cpu", attn_impl="flash")
    tts.load_gpt_model(str(tmp_path / "gpt"))
    assert tts.gpt_models[str(tmp_path / "gpt")].engine.attn_impl == "flash"


@pytest.mark.parametrize("impl,jimpl", PAIRS)
def test_generate_tokens_and_routing_match_jax(models, monkeypatch, impl, jimpl):
    """B=1 ``generate`` to the edge of a 128-row cache: the first tokens
    equal the JAX engine's, and the steps went through the kernels the name
    selects — under ``"flash"`` K4 in every layer of the prefill and K3b in
    every layer of every step, B=1 included."""
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg = models[0]
    jeng, peng = _engines(models, impl, jimpl, [(1, 128)])
    xs, ys, berts = requests(cfg, 1, seed=5)
    key = jax.random.PRNGKey(4)
    jtoks = np.asarray(jeng.generate(xs[0], ys[0], berts[0], top_k=1, rng=key)).ravel()
    monkeypatch.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
    calls = _count_kernels(monkeypatch)
    ptoks = peng.generate(xs[0], ys[0], berts[0], top_k=1).ravel()
    assert len(ptoks) == len(jtoks) >= 20
    np.testing.assert_array_equal(ptoks[:PREFIX], jtoks[:PREFIX])
    steps, L = peng.last_stats["decode_steps"], cfg.num_layers
    want = {"fused_step": {"fused_decode_step_sample": steps},
            "flash": {"flash_prefill_attention": L, "flash_decode_attention_layered": L * steps},
            "fused": {"fused_decode_layer": L * steps}}[impl]
    assert calls == want


@pytest.mark.parametrize("impl", ["flash", "fused"])
def test_generate_batched_under_impl_matches_jax(models, monkeypatch, impl):
    """Five requests on a four-slot wave, with refill and compaction: the
    harvests equal the JAX engine's XLA path, and no step took a whole-step
    kernel."""
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg = models[0]
    cache = [(1, 128), (2, 128), (2, 256), (4, 128), (4, 256)]
    jeng, peng = _engines(models, impl, "xla", cache)
    xs, ys, berts = requests(cfg, 5, seed=11)
    key = jax.random.PRNGKey(3)
    jpred, jidx = jeng.generate_batched(xs, ys, berts, top_k=1, rng=key)
    monkeypatch.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
    calls = _count_kernels(monkeypatch)
    ppred, pidx = peng.generate_batched(xs, ys, berts, top_k=1)
    assert pidx.tolist() == jidx.tolist()
    for i, pt, jt in zip(pidx.tolist(), ppred, jpred):
        n = min(len(pt), PREFIX)
        assert len(pt) == len(jt)
        np.testing.assert_array_equal(pt[:n], np.asarray(jt)[:n], err_msg=f"request {i}")
    st = peng.last_stats
    assert st["generic_steps"] == st["decode_steps"] > 0 and st["k1_steps"] == st["k2_steps"] == 0
    L = cfg.num_layers
    if impl == "flash":
        assert set(calls) == {"flash_prefill_attention", "flash_decode_attention_layered"}
        assert calls["flash_decode_attention_layered"] == L * st["decode_steps"]
        assert calls["flash_prefill_attention"] == L * (1 + peng.refills)  # one refill a pass
    else:
        assert calls == {"fused_decode_layer": L * st["decode_steps"]}


def test_flash_prefill_builds_no_mask(models, monkeypatch):
    """Under ``"flash"`` the prefill derives the mask from the lengths inside
    K4: the [k, T, T] tensor is not built, for the batch or for a refill."""
    from gsv_tts_tpu_torch.models import t2s as pt2s
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, _, pcfg, pp = models

    def no_mask(*a, **kw):
        raise AssertionError("the mask tensor was built")

    def run(attn_impl):
        eng = ps.T2SEngine(pp, pcfg, gpt_cache=[(2, 128)], attn_impl=attn_impl)
        xs, ys, berts = requests(cfg, 3, seed=2)
        return eng.generate_batched(xs, ys, berts, top_k=1)[0]

    plain = run("fused")
    monkeypatch.setattr(pt2s, "hybrid_mask", no_mask)
    flash = run("flash")
    for a, b in zip(plain, flash):
        np.testing.assert_array_equal(a[:PREFIX], b[:PREFIX])
    with pytest.raises(AssertionError, match="mask tensor was built"):
        run("fused_step")


@pytest.mark.parametrize("boost", [False, True])
def test_generate_stream_chunks_match_jax(models, monkeypatch, boost):
    """``generate(stream_chunk=10)``: the same chunk boundaries and finality
    flags as the JAX engine, the first chunk going out at once under
    ``boost_first_chunk``, and the cumulative tokens equal over the prefix."""
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg = models[0]
    jeng, peng = _engines(models, "fused_step", "xla", [(1, 128)])
    xs, ys, berts = requests(cfg, 1, seed=8)
    key = jax.random.PRNGKey(6)
    jchunks = [(np.asarray(t).ravel(), f) for t, f in jeng.generate(
        xs[0], ys[0], berts[0], top_k=1, rng=key, stream_chunk=10, boost_first_chunk=boost)]
    monkeypatch.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
    pchunks = [(t.ravel(), f) for t, f in peng.generate(
        xs[0], ys[0], berts[0], top_k=1, stream_chunk=10, boost_first_chunk=boost)]
    assert [(len(t), f) for t, f in pchunks] == [(len(t), f) for t, f in jchunks]
    assert len(pchunks) > 3 and pchunks[-1][1] and not pchunks[0][1]
    assert len(pchunks[0][0]) == 10  # the first chunk, held back or not, is the first ten
    for (pt, _), (jt, _) in zip(pchunks, jchunks):
        n = min(len(pt), PREFIX)
        np.testing.assert_array_equal(pt[:n], jt[:n])
