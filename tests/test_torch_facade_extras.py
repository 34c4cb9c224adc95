"""The facade's entry points beside the three inference calls, against the
JAX package where it has a counterpart: ``use_flash_attn`` and the engine's
``"xla"`` path, ``get_timings``, ``to_safetensors``, the ``*_async``
wrappers, ``infer_stream(debug=...)`` and ``init_language_module``.  Float32
on the CPU; tokens compared exactly over bounded prefixes at ``top_k=1``."""
import asyncio
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import HPS, build_assets, jax_sovits, jax_t2s
from test_torch_assets import text_modules_as_installed  # noqa: F401
from test_torch_engine_batched import requests
from test_torch_fused_step import SMALL, _jax_noise_chain
from test_torch_t2s import port_t2s
from test_torch_assets import one_torch_thread  # noqa: F401

PREFIX = 30
PROMPT_TEXT = "hello there."
KW = dict(top_k=1, noise_scale=0.0)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


@pytest.fixture(scope="module")
def tts(assets):
    from gsv_tts_tpu_torch import TTS

    t = TTS(gpt_cache=[(1, 128), (2, 128)], sovits_cache=[], models_dir=str(assets["root"]),
            device="cpu", seed=0, stream_vocoder="exact")
    t.load_gpt_model(assets["gpt"])
    t.load_sovits_model(assets["sovits"])
    return t


# -- use_flash_attn and the "xla" engine ----------------------------------------

@pytest.fixture(scope="module")
def models():
    cfg, jp = jax_t2s(2, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    return cfg, jp, pcfg, pp


def _no_kernel_and_count_xla(monkeypatch):
    """Every kernel wrapper raises if the engine reaches it; calls of the
    ``"xla"`` attention are counted."""
    from gsv_tts_tpu_torch.models import t2s as pt2s
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    def kernel(*a, **kw):
        raise AssertionError("a kernel wrapper was called under 'xla'")

    for module, name in ((ps, "fused_decode_step_sample"),
                         (ps, "fused_decode_step_sample_batched"),
                         (pt2s, "flash_decode_attention_layered"),
                         (pt2s, "flash_prefill_attention"), (pt2s, "fused_decode_step"),
                         (pt2s, "fused_decode_layer")):
        monkeypatch.setattr(module, name, kernel)
    calls = {"xla": 0}
    orig = pt2s.xla_decode_attention

    def counted(*a, **kw):
        calls["xla"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(pt2s, "xla_decode_attention", counted)
    return calls


def test_xla_decode_attention_matches_jax():
    from gsv_tts_tpu.ops.flash_decode import xla_decode_attention as jxla
    from gsv_tts_tpu_torch.ops.flash_decode import xla_decode_attention

    rng = np.random.RandomState(0)
    B, S, H, Dh = 3, 40, 4, 16
    q = rng.randn(B, H, Dh).astype(np.float32)
    k, v = (rng.randn(B, S, H, Dh).astype(np.float32) for _ in range(2))
    kv_len = np.array([0, 17, 39], np.int32)
    want = np.asarray(jxla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len)))
    got = xla_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, kv_len))).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_xla_engine_matches_jax_at_b1(models, monkeypatch):
    """B=1 ``generate`` under ``"xla"``: JAX's ``"xla"`` engine's tokens, the
    attention ``xla_decode_attention`` in every layer of every step, no kernel."""
    from gsv_tts_tpu.runtime.t2s_session import T2SEngine as JEngine
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp, pcfg, pp = models
    jeng = JEngine(jp, cfg, gpt_cache=[(1, 128)], dtype=jnp.float32, attn_impl="xla")
    peng = ps.T2SEngine(pp, pcfg, gpt_cache=[(1, 128)], attn_impl="xla")
    xs, ys, berts = requests(cfg, 1, seed=5)
    key = jax.random.PRNGKey(4)
    jtoks = np.asarray(jeng.generate(xs[0], ys[0], berts[0], top_k=1, rng=key)).ravel()
    monkeypatch.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
    calls = _no_kernel_and_count_xla(monkeypatch)
    ptoks = peng.generate(xs[0], ys[0], berts[0], top_k=1).ravel()
    assert len(ptoks) == len(jtoks) >= 20
    np.testing.assert_array_equal(ptoks[:PREFIX], jtoks[:PREFIX])
    assert calls["xla"] == cfg.num_layers * peng.last_stats["decode_steps"] > 0


def test_xla_engine_matches_jax_in_a_batched_wave(models, monkeypatch):
    """Five requests on a four-slot wave (refill, compaction): the harvests
    equal JAX's ``"xla"`` engine's, every step the generic one."""
    from gsv_tts_tpu.runtime.t2s_session import T2SEngine as JEngine
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp, pcfg, pp = models
    cache = [(1, 128), (2, 128), (2, 256), (4, 128), (4, 256)]
    jeng = JEngine(jp, cfg, gpt_cache=cache, dtype=jnp.float32, attn_impl="xla")
    peng = ps.T2SEngine(pp, pcfg, gpt_cache=cache, attn_impl="xla")
    xs, ys, berts = requests(cfg, 5, seed=11)
    key = jax.random.PRNGKey(3)
    jpred, jidx = jeng.generate_batched(xs, ys, berts, top_k=1, rng=key)
    monkeypatch.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
    calls = _no_kernel_and_count_xla(monkeypatch)
    ppred, pidx = peng.generate_batched(xs, ys, berts, top_k=1)
    assert pidx.tolist() == jidx.tolist()
    for i, pt, jt in zip(pidx.tolist(), ppred, jpred):
        n = min(len(pt), PREFIX)
        assert len(pt) == len(jt)
        np.testing.assert_array_equal(pt[:n], np.asarray(jt)[:n], err_msg=f"request {i}")
    st = peng.last_stats
    assert st["generic_steps"] == st["decode_steps"] > 0 and st["k1_steps"] == st["k2_steps"] == 0
    assert calls["xla"] == cfg.num_layers * st["decode_steps"]


@pytest.mark.parametrize("quant", [False, True, "int4"])
@pytest.mark.parametrize("attn_impl", ["fused_step", "flash"])
def test_use_flash_attn_false_resolves_to_xla(assets, quant, attn_impl):
    """``use_flash_attn=False`` is ``"xla"`` whatever ``attn_impl`` and
    ``quant_t2s`` say, as in JAX's loader; a bad ``quant_t2s`` still raises."""
    from gsv_tts_tpu.config import Config as JConfig
    from gsv_tts_tpu.loader import resolve_t2s_attn_impl as jresolve
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import resolve_t2s_attn_impl

    jc = JConfig(dtype="float32", platform="cpu", use_flash_attn=False, quant_t2s=quant)
    pc = Config(device="cpu", use_flash_attn=False, quant_t2s=quant, attn_impl=attn_impl)
    assert resolve_t2s_attn_impl(pc) == jresolve(jc) == "xla"
    t = TTS(gpt_cache=[(1, 128)], models_dir=str(assets["root"]), device="cpu",
            use_flash_attn=False, quant_t2s=quant, attn_impl=attn_impl)
    t.load_gpt_model(assets["gpt"])
    engine = t.gpt_models[assets["gpt"]].engine
    assert engine.attn_impl == "xla" and engine.quant is None
    assert "k1_table" not in engine.params
    with pytest.raises(ValueError, match="quant_t2s must be"):
        TTS(device="cpu", use_flash_attn=False, quant_t2s="int3")
    assert Config(device="cpu").use_flash_attn is True


def test_facade_under_xla_runs_no_kernel(assets, monkeypatch):
    from gsv_tts_tpu_torch import TTS

    t = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
            device="cpu", seed=0, use_flash_attn=False)
    t.load_gpt_model(assets["gpt"])
    t.load_sovits_model(assets["sovits"])
    calls = _no_kernel_and_count_xla(monkeypatch)
    clip = t.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, "a short test.", **KW)
    assert np.all(np.isfinite(clip.audio_data)) and clip.audio_data.size > 6400
    assert calls["xla"] == 2 * t.last_timings["decode_steps"]  # two layers a step


# -- get_timings ----------------------------------------------------------------

def test_get_timings_keys(assets, tts):
    tts.timings = type(tts.timings)()
    assert tts.get_timings() == {}
    tts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, "a short test.", **KW)
    tts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, "another test.", **KW)
    list(tts.infer_stream(assets["spk"], assets["prompt"], PROMPT_TEXT, "a stream.",
                          stream_chunk=10, **KW))
    got = tts.get_timings()
    assert set(got) == {"frontend", "t2s", "sovits", "ttfa_s"}
    for name, s in got.items():
        assert set(s) == {"count", "p50", "p95", "mean", "last"}
        assert s["count"] == (1 if name == "ttfa_s" else 2)
        assert 0 <= s["p50"] <= s["p95"] and s["last"] > 0
    assert got["ttfa_s"]["last"] == tts.last_timings["ttfa_s"]


def test_timing_helpers_match_jax():
    from gsv_tts_tpu.utils import timing as jt
    from gsv_tts_tpu_torch.utils import timing as pt

    a, b = pt.Timings(window=3), jt.Timings(window=3)
    for x in (0.4, 0.1, 0.3, 0.2):
        a.record("s", x)
        b.record("s", x)
    assert a.summary() == b.summary()


# -- to_safetensors ----------------------------------------------------------------

def _write_ckpt_and_pth(root):
    """A training-format GPT ``.ckpt`` and a SoVITS ``.pth`` with a v2 version
    header, from the tiny JAX parameters, written with ``torch.save``."""
    from gsv_tts_tpu.loader import GPT_KEY_MAP, save_trained_gpt
    from gsv_tts_tpu.models import t2s as jt2s

    cfg, tp = jax_t2s(5)
    save_trained_gpt(tp, cfg, str(root / "ref_gpt"))
    config = json.loads((root / "ref_gpt" / "config.json").read_text())
    inv = {new: old for old, new in GPT_KEY_MAP}
    weight = {}
    for k, v in jt2s.params_to_torch_state_dict(tp, cfg).items():
        t = torch.from_numpy(np.array(v))
        if k.startswith("t2s_transformer.blocks."):
            parts = k.split(".")
            weight[f"model.h.layers.{parts[2]}." + inv[".".join(parts[3:])]] = t
        else:
            weight["model." + k] = t
    torch.save({"config": config, "weight": weight}, str(root / "g.ckpt"))
    _, sp = jax_sovits(3)
    hps = json.loads(json.dumps(HPS))
    del hps["model"]["version"]
    path = root / "s.pth"
    torch.save({"config": hps, "weight": {k: torch.from_numpy(np.array(v))
                                          for k, v in sp.items()}}, str(path))
    raw = path.read_bytes()
    path.write_bytes(b"01" + raw[2:])  # the v2 header in place of the zip magic
    return str(root / "g.ckpt"), str(path)


def test_to_safetensors_matches_jax_and_loads_in_both(tmp_path):
    """The port's export of a ``.ckpt`` and of a ``.pth`` holds JAX's
    export's tensors and config; each package loads the other's directory
    to the same parameters as its own."""
    from safetensors.numpy import load_file as st_load

    from gsv_tts_tpu.config import Config as JConfig
    from gsv_tts_tpu.loader import get_gpt_weights as jgpt, get_sovits_weights as jsov
    from gsv_tts_tpu.loader import gpt_to_safetensors, sovits_to_safetensors
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_gpt_weights, get_sovits_weights

    ckpt, pth = _write_ckpt_and_pth(tmp_path)
    jc = JConfig(dtype="float32", platform="cpu")
    gpt_to_safetensors(ckpt, str(tmp_path / "jax_gpt"), jc)
    sovits_to_safetensors(pth, str(tmp_path / "jax_sov"), jc)
    t = TTS(models_dir=str(tmp_path), device="cpu")
    t.to_safetensors(ckpt, str(tmp_path / "port_gpt"))
    t.to_safetensors(pth)  # beside the checkpoint, without its suffix
    for ours, theirs, meta in (("port_gpt", "jax_gpt", "config.json"),
                               ("s", "jax_sov", "hps.json")):
        a, b = st_load(str(tmp_path / ours / "model.safetensors")), \
            st_load(str(tmp_path / theirs / "model.safetensors"))
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert json.loads((tmp_path / ours / meta).read_text()) == \
            json.loads((tmp_path / theirs / meta).read_text())
    assert json.loads((tmp_path / "s" / "hps.json").read_text())["model"]["version"] == "v2"
    pc = Config(device="cpu", gpt_cache=[(1, 128)])
    mine, theirs = get_gpt_weights(tmp_path / "jax_gpt", pc).params, get_gpt_weights(ckpt, pc).params
    for k in ("text_emb", "audio_emb", "bert_proj_w", "predict_w"):
        assert torch.equal(mine[k], theirs[k]), k
    for la, lb in zip(mine["layers"], theirs["layers"]):
        assert all(torch.equal(la[k], lb[k]) for k in la)
    a, b = get_sovits_weights(tmp_path / "jax_sov", pc), get_sovits_weights(pth, pc)
    assert a.cfg == b.cfg and all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    ja, jb = jgpt(str(tmp_path / "port_gpt"), jc), jgpt(str(tmp_path / "jax_gpt"), jc)
    jax.tree.map(lambda x, y: np.testing.assert_array_equal(np.asarray(x), np.asarray(y)),
                 ja.params, jb.params)
    sa, sb = jsov(str(tmp_path / "s"), jc), jsov(str(tmp_path / "jax_sov"), jc)
    assert sa.cfg == sb.cfg
    for k in sb.params:
        np.testing.assert_array_equal(np.asarray(sa.params[k]), np.asarray(sb.params[k]))


# -- the async wrappers ------------------------------------------------------------

def test_concurrent_infer_async_calls_serialize(assets, tts):
    """Four ``infer_async`` calls on a four-thread executor: all complete with
    audio, one at a time (``_infer_lock``), and each equals the synchronous
    call's (``top_k=1``, no noise)."""
    active, peak = [0], [0]
    orig = tts.infer

    def tracked(*a, **kw):
        active[0] += 1
        peak[0] = max(peak[0], active[0])
        try:
            time.sleep(0.05)
            return orig(*a, **kw)
        finally:
            active[0] -= 1

    texts = [f"concurrent test {i}." for i in range(4)]

    async def go():
        with ThreadPoolExecutor(max_workers=4) as ex:
            return await asyncio.gather(*[
                tts.infer_async(assets["spk"], assets["prompt"], PROMPT_TEXT, t, executor=ex,
                                **KW) for t in texts])

    tts.infer = tracked
    try:
        clips = asyncio.run(go())
    finally:
        del tts.infer
    assert peak[0] == 1
    for t, c in zip(texts, clips):
        want = tts.infer(assets["spk"], assets["prompt"], PROMPT_TEXT, t, **KW)
        np.testing.assert_array_equal(c.audio_data, want.audio_data)


def test_batched_and_vc_async_wrappers(assets, tts):
    async def go():
        return (await tts.infer_batched_async(assets["spk"], assets["prompt"], PROMPT_TEXT,
                                              ["one text.", "and another."], **KW),
                await tts.infer_vc_async(assets["spk"], assets["prompt"], PROMPT_TEXT,
                                         noise_scale=0.0))

    batched, vc = asyncio.run(go())
    want_b = tts.infer_batched(assets["spk"], assets["prompt"], PROMPT_TEXT,
                               ["one text.", "and another."], **KW)
    want_vc = tts.infer_vc(assets["spk"], assets["prompt"], PROMPT_TEXT, noise_scale=0.0)
    assert len(batched) == 2
    for got, want in zip(batched, want_b):
        np.testing.assert_array_equal(got.audio_data, want.audio_data)
    np.testing.assert_array_equal(vc.audio_data, want_vc.audio_data)
    assert not tts._infer_lock.locked()


def test_infer_stream_async_yields_the_stream(assets, tts):
    async def go():
        return [c async for c in tts.infer_stream_async(
            assets["spk"], assets["prompt"], PROMPT_TEXT, "a streamed sentence here.",
            stream_chunk=10, **KW)]

    chunks = asyncio.run(go())
    want = list(tts.infer_stream(assets["spk"], assets["prompt"], PROMPT_TEXT,
                                 "a streamed sentence here.", stream_chunk=10, **KW))
    assert len(chunks) == len(want) > 1
    for a, b in zip(chunks, want):
        np.testing.assert_array_equal(a.audio_data, b.audio_data)


def test_infer_stream_async_reraises_a_workers_error(assets, tts):
    """``speed=0`` fails inside the worker (a division by zero): the consumer
    sees that error, not a clean empty stream, and the lock is free after."""
    async def go():
        return [c async for c in tts.infer_stream_async(
            assets["spk"], assets["prompt"], PROMPT_TEXT, "a test.", speed=0, **KW)]

    with pytest.raises(ZeroDivisionError):
        asyncio.run(go())
    assert not tts._infer_lock.locked()


def test_infer_stream_async_consumer_leaving_cancels_the_worker(assets, tts, monkeypatch):
    """A consumer that stops after the first chunk sets the cancel event: the
    worker stops at its next chunk and releases the lock, so the next call
    runs."""
    produced, closed = [0], threading.Event()
    orig = tts.infer_stream

    def counting(*a, **kw):
        try:
            for chunk in orig(*a, **kw):
                produced[0] += 1
                yield chunk
                time.sleep(0.05)
        finally:
            closed.set()

    monkeypatch.setattr(tts, "infer_stream", counting)
    text = "a long streamed text, with several chunks in it, and more words at its end."

    async def go():
        agen = tts.infer_stream_async(assets["spk"], assets["prompt"], PROMPT_TEXT, text,
                                      stream_chunk=5, **KW)
        first = await agen.__anext__()
        await agen.aclose()
        return first

    first = asyncio.run(go())
    assert first.audio_data.size > 0
    assert closed.wait(60)
    total = len(list(orig(assets["spk"], assets["prompt"], PROMPT_TEXT, text, stream_chunk=5,
                          **KW)))
    assert produced[0] < total
    deadline = time.time() + 60
    while tts._infer_lock.locked() and time.time() < deadline:
        time.sleep(0.01)
    assert not tts._infer_lock.locked()


# -- infer_stream(debug=...) and init_language_module -----------------------------------

def test_infer_stream_debug_logs(assets, tts, caplog):
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT, "a short test.")
    with caplog.at_level(logging.INFO, logger="gsv_tts_tpu_torch.tts"):
        list(tts.infer_stream(*args, debug=False, stream_chunk=10, **KW))
    assert "Stream inference complete" not in caplog.text
    assert "Processing segment" not in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="gsv_tts_tpu_torch.tts"):
        list(tts.infer_stream(*args, stream_chunk=10, **KW))
    assert "Processing segment 1/1" in caplog.text
    assert "Stream inference complete" in caplog.text


def test_init_language_module(assets, tts, monkeypatch, caplog):
    from gsv_tts_tpu_torch.config import global_config

    from gsv_tts_tpu_torch.frontend.g2p.japanese import JapaneseG2P

    monkeypatch.setattr(global_config, "english_g2p", None)
    monkeypatch.setattr(global_config, "chinese_g2p", None)
    monkeypatch.setattr(global_config, "japanese_g2p", None)
    with caplog.at_level(logging.INFO, logger="gsv_tts_tpu_torch.tts"):
        tts.init_language_module("en", "zh", "xx", "ja")
    assert global_config.english_g2p._auto_models_dir == str(tts.models_dir)
    assert global_config.chinese_g2p._auto_models_dir == str(tts.models_dir)
    assert isinstance(global_config.japanese_g2p, JapaneseG2P)
    assert global_config.japanese_g2p._auto_models_dir == str(tts.models_dir)
    for lang in ("en", "zh", "ja"):
        assert f"Loaded language module: {lang}" in caplog.text
    assert 'Language "xx" not found.' in caplog.text
