"""The quantized weight streams of K1 and K2 (``TTS(quant_t2s=…)``, engine
``attn_impl="fused_step_q8"`` / ``"fused_step_q4"``): the port's int8 / int4
packs against JAX's ``pack_layer_weights_int8`` / ``_int4``, the quantized
twins against the JAX TPU kernels run in interpret mode (``quant=True`` /
``quant4=True``), the engine's routing (K1 and K2 up to six slots on the
packed pages, the bf16 K2 for seven and eight, the generic step above) and
the facade's validation and ``infer`` against JAX's.  The CUDA kernels are
held against these twins in ``test_torch_cuda.py``.

Widths are JAX's quant tests' (``tests/test_quant.py:24-31``: D=128, H=4,
L=2, V=101), float32.  Tolerance: rtol=2e-4, atol=2e-5 (summation order
only); the packs are compared exactly, tokens exactly over bounded chains."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import build_assets, jax_t2s, text_modules_as_installed  # noqa: F401
from test_torch_fused_step import SMALL, _jax_noise_chain, caches, tok_history
from test_torch_fused_step_batched import both_prefill, prompts, wave
from test_torch_t2s import port_t2s
from test_torch_assets import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-4, 2e-5
QUANTS = ("int8", "int4")
JAX_IMPL = {"int8": "fused_step_q8_interpret", "int4": "fused_step_q4_interpret"}
PORT_IMPL = {"int8": "fused_step_q8", "int4": "fused_step_q4"}


def jax_flags(quant):
    return dict(quant=quant == "int8", quant4=quant == "int4")


def jax_values(quant, layers):
    """JAX's packed values [L, D, W] as float32 (int4 unpacked block by
    block in its own nibble layout) and its scales [L, W]."""
    from gsv_tts_tpu.ops import fused_step as jfs

    if quant == "int8":
        q, page = jfs.pack_layer_weights_int8(layers)
        return np.asarray(q, np.float32), np.asarray(page[:, 0])
    q4, page = jfs.pack_layer_weights_int4(layers)
    D = layers["out_w"].shape[-1]
    M = layers["mlp1_w"].shape[-1]
    edges = (0, 3 * D, 4 * D, 4 * D + M, 4 * D + 2 * M)
    vals = np.stack([np.concatenate([
        np.asarray(jfs._unpack_int4(q4[l][:, lo // 2:hi // 2], jnp.float32))
        for lo, hi in zip(edges, edges[1:])], axis=-1) for l in range(q4.shape[0])])
    return vals, np.asarray(page[:, 0])


@pytest.mark.parametrize("quant", QUANTS)
def test_packs_equal_jax(quant):
    """The port's per-layer values (after ``unpack_int4``) and scales equal
    JAX's pack of the same weights exactly, lane for lane in the port's
    [out, in] layout (a row of qkv, out and mlp1, a column of mlp2), and an
    all-zero lane takes the scale 1."""
    from gsv_tts_tpu_torch.ops import fused_step as pfs

    cfg, jp = jax_t2s(0, **SMALL)
    lay = dict(jp["layers"])
    lay["qkv_w"] = lay["qkv_w"].at[0, :, 5].set(0.0)  # qkv lane 5 of layer 0
    lay["mlp2_w"] = lay["mlp2_w"].at[1, 7, :].set(0.0)  # mlp2 lane 7 (contracted) of layer 1
    jp = dict(jp, layers=lay)
    _, pp = port_t2s(cfg, jp)
    jq, js = jax_values(quant, lay)
    pack = pfs.pack_layer_weights_int8 if quant == "int8" else pfs.pack_layer_weights_int4
    packed = pack(pp["layers"])
    D, M = cfg.hidden_dim, lay["mlp1_w"].shape[-1]
    blocks = {"qkv": (0, 3 * D), "out": (3 * D, 4 * D), "mlp1": (4 * D, 4 * D + M),
              "mlp2": (4 * D + M, 4 * D + 2 * M)}
    limit = 127 if quant == "int8" else 7
    for l, ql in enumerate(packed):
        for name, (lo, hi) in blocks.items():
            q = ql[name + "_q"]
            assert q.dtype == (torch.int8 if quant == "int8" else torch.uint8)
            vals = (pfs.unpack_int4(q) if quant == "int4" else q).numpy().astype(np.float32)
            want = jq[l][:, lo:hi]
            np.testing.assert_array_equal(vals, want if name == "mlp2" else want.T,
                                          err_msg=f"{quant} layer {l} {name} values")
            assert np.abs(vals).max() == limit
            s = ql[name + "_s"]
            assert s.dtype == torch.float32 and s.shape == (hi - lo,)
            np.testing.assert_array_equal(s.numpy(), js[l][lo:hi],
                                          err_msg=f"{quant} layer {l} {name} scales")
    assert float(packed[0]["qkv_s"][5]) == 1.0 and not packed[0]["qkv_q"][5].any()
    assert float(packed[1]["mlp2_s"][7]) == 1.0
    assert not (pfs.unpack_int4(packed[1]["mlp2_q"]) if quant == "int4"
                else packed[1]["mlp2_q"])[:, 7].any()


@pytest.mark.parametrize("quant", QUANTS)
def test_k1_quant_twin_matches_interpret_kernel(quant):
    """One B=1 step on the packed pages: token, filtered row and both
    updated caches against the TPU kernel (``interpret=True``, ``quant`` /
    ``quant4``), with the repetition penalty and the suppression window on."""
    from gsv_tts_tpu.ops.fused_step import fused_decode_step_sample as jk1
    from gsv_tts_tpu.runtime.t2s_session import SampleArgs as JSA
    from gsv_tts_tpu_torch.ops.fused_step import fused_decode_step_sample
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg, jp = jax_t2s(7, **SMALL)
    _, pp = port_t2s(cfg, jp)
    S, kv_len, V = 128, 40, cfg.vocab_size
    kc, vc = caches(cfg, S, 1)
    buf = tok_history(cfg, S, 30, 2)
    g = np.random.RandomState(3).gumbel(size=(1, V)).astype(np.float32)
    sup = cfg.suppressed_tokens + (cfg.eos,)
    sa_kw = dict(top_k=15, top_p=0.9, temperature=1.0, repetition_penalty=1.35)
    jtok, jrow, jkc, jvc = jk1(
        jp, jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(buf), jnp.asarray([kv_len]),
        jnp.asarray([12]), jnp.asarray([17]), jnp.asarray([30]), jnp.asarray([5]),
        jnp.asarray(np.pad(g, ((0, 0), (0, 128 - V)))), sa=JSA(**sa_kw), suppress_until=10,
        suppressed=sup, interpret=True, **jax_flags(quant))
    pk, pv, pb = torch.tensor(kc), torch.tensor(vc), torch.tensor(buf)
    ptok, prow, pk, pv = fused_decode_step_sample(
        pp, pk, pv, pb, kv_len, 12, torch.tensor([17], dtype=torch.int32), 30, 5,
        torch.tensor(g), sa=SampleArgs(**sa_kw), suppress_until=10, suppressed=sup,
        quant=quant)
    assert int(ptok[0]) == int(jtok[0])
    np.testing.assert_allclose(prow.numpy(), np.asarray(jrow)[:, :V], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pk.numpy(), np.asarray(jkc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jvc), rtol=RTOL, atol=ATOL)
    assert np.array_equal(pk[:, :, :kv_len].numpy(), kc[:, :, :kv_len])
    assert int(pb[0, 30]) == int(ptok[0])
    # the quantized step is another function than the bf16 one
    _, brow, _, _ = fused_decode_step_sample(
        pp, torch.tensor(kc), torch.tensor(vc), torch.tensor(buf), kv_len, 12,
        torch.tensor([17], dtype=torch.int32), 30, 5, torch.tensor(g),
        sa=SampleArgs(**sa_kw), suppress_until=10, suppressed=sup)
    assert not np.allclose(brow.numpy(), prow.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quant", QUANTS)
def test_k1_quant_decode_chunk_matches_jax(quant):
    """The same prefill on the unquantized weights, then ``decode_chunk`` of
    10 steps on the packed pages, fed the same Gumbel tensor: the port's K1
    twin gives the JAX interpret kernel's tokens, ``tok_buf`` and caches
    (``tests/test_quant.py:77-103``'s set-up, with sampling instead of a
    greedy chain)."""
    from gsv_tts_tpu.runtime import t2s_session as js
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(0, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    rng = np.random.RandomState(3)
    x = rng.randint(1, 50, (1, 12))
    y = rng.randint(0, 100, (1, 7))
    bert = np.zeros((1, 12, cfg.bert_dim), np.float32)
    sa_kw = dict(top_k=5, repetition_penalty=1.35)
    shape = (cfg.num_layers, 1, 128, cfg.num_heads, cfg.head_dim)
    key = jax.random.PRNGKey(1)
    jstate, jtok = js.prefill_batch(
        jp, cfg, jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32), jnp.asarray(bert),
        jnp.asarray([12]), jnp.asarray([7]), jnp.zeros(shape), jnp.zeros(shape), key,
        js.SampleArgs(**sa_kw), True, "float32", "xla")
    noise = _jax_noise_chain(key)
    pstate, ptok = ps.prefill_batch(
        pp, pcfg, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(bert), 12, 7,
        torch.zeros(shape), torch.zeros(shape), noise((1, cfg.vocab_size), None, None),
        ps.SampleArgs(**sa_kw), True)
    assert int(ptok[0]) == int(jtok[0])
    jkey = jnp.asarray(np.asarray(jstate.rng))  # decode_chunk donates the state
    jstate, jtoks = js.decode_chunk(jp, cfg, jstate, 10, js.SampleArgs(**sa_kw), 10, "float32",
                                    JAX_IMPL[quant])
    _, sub = jax.random.split(jkey)
    g = torch.as_tensor(np.array(jax.random.gumbel(sub, (10, 1, cfg.vocab_size))))
    pstate, ptoks = ps.decode_chunk(pp, pcfg, pstate, 10, ps.SampleArgs(**sa_kw), g, 10,
                                    attn_impl=PORT_IMPL[quant])
    np.testing.assert_array_equal(ptoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(pstate.tok_buf.numpy(), np.asarray(jstate.tok_buf))
    assert int(pstate.kv_len[0]) == int(jstate.kv_len[0]) == 12 + 7 + 10
    np.testing.assert_allclose(pstate.k_cache.numpy(), np.asarray(jstate.k_cache),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pstate.v_cache.numpy(), np.asarray(jstate.v_cache),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("B,quant", [(2, "int8"), (4, "int8"), (6, "int8"),
                                     (2, "int4"), (4, "int4"), (6, "int4")])
def test_k2_quant_twin_matches_interpret_kernel(B, quant):
    """One step of a B-slot wave on the packed pages against the batched TPU
    kernel (``interpret=True``): tokens, filtered rows and both caches, with
    ragged ``kv_len``, a frozen slot (``kv_len < x_len``) and a slot on the
    cache's last row."""
    from gsv_tts_tpu.ops.fused_step import fused_decode_step_sample_batched as jk2
    from gsv_tts_tpu.runtime.t2s_session import SampleArgs as JSA
    from gsv_tts_tpu_torch.ops.fused_step import fused_decode_step_sample_batched
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    cfg, jp = jax_t2s(7, **SMALL)
    _, pp = port_t2s(cfg, jp)
    S, V = 128, cfg.vocab_size
    w = wave(cfg, B, S, seed=B)
    g = np.random.RandomState(B).gumbel(size=(B, V)).astype(np.float32)
    sup = cfg.suppressed_tokens + (cfg.eos,)
    sa_kw = dict(top_k=8, top_p=0.8, temperature=0.9, repetition_penalty=1.2, use_prev=True)
    jtok, jrow, jkc, jvc = jk2(
        jp, *(jnp.asarray(w[k]) for k in ("kc", "vc", "tok_buf", "kv_len", "x_len", "last_tok",
                                          "buf_len", "step_idx")),
        jnp.asarray(np.pad(g, ((0, 0), (0, 128 - V)))), sa=JSA(**sa_kw), suppress_until=10,
        suppressed=sup, interpret=True, **jax_flags(quant))
    t = {k: torch.tensor(v) for k, v in w.items()}
    ptok, prow, pkc, pvc = fused_decode_step_sample_batched(
        pp, t["kc"], t["vc"], t["tok_buf"], t["kv_len"], t["x_len"], t["last_tok"],
        t["buf_len"], t["step_idx"], torch.tensor(g), sa=SampleArgs(**sa_kw),
        suppress_until=10, suppressed=sup, quant=quant)
    np.testing.assert_array_equal(ptok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(prow.numpy(), np.asarray(jrow)[:, :V], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pkc.numpy(), np.asarray(jkc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(pvc.numpy(), np.asarray(jvc), rtol=RTOL, atol=ATOL)
    for b in range(B):
        n = w["kv_len"][b]
        assert np.array_equal(pkc[:, b, :n].numpy(), w["kc"][:, b, :n])
        assert np.array_equal(pkc[:, b, n + 1:].numpy(), w["kc"][:, b, n + 1:])
        assert int(t["tok_buf"][b, w["buf_len"][b]]) == int(ptok[b])


@pytest.mark.parametrize("impl", ["fused_step_q4", "fused_step", "flash"])
def test_step_path_routes_by_wave_size(impl):
    """Which kernel a step takes: under the quantized names K1 and K2 up to
    six slots on the pages, the bf16 K2 for seven and eight, the generic step
    above (the JAX engine's ``max_fused_b`` of 6 under the per-row softmax)."""
    from gsv_tts_tpu_torch.runtime.t2s_session import MAX_QUANT_B, step_path

    assert MAX_QUANT_B == 6
    want = {"fused_step_q4": ["k1q"] + ["k2q"] * 5 + ["k2"] * 2 + ["generic"] * 2,
            "fused_step": ["k1"] + ["k2"] * 7 + ["generic"] * 2,
            "flash": ["generic"] * 10}[impl]
    assert [step_path(impl, B) for B in range(1, 11)] == want


@pytest.mark.parametrize("B", [1, 6, 7, 10])
def test_decode_chunk_passes_the_stream_by_wave_size(monkeypatch, B):
    """``decode_chunk`` under ``"fused_step_q8"`` hands ``quant="int8"`` to K1
    and to K2 up to six slots, ``None`` to K2 at seven (the bf16 weights),
    and runs the generic step above eight."""
    from gsv_tts_tpu_torch.ops import fused_step
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(2, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    eng = ps.T2SEngine(pp, pcfg, gpt_cache=[(B, 64)], attn_impl="fused_step_q8")
    seen = []
    for name in ("fused_decode_step_sample", "fused_decode_step_sample_batched", "_generic_step"):
        orig = getattr(ps, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.append((_name, kw.get("quant")))
            return _orig(*a, **kw)

        monkeypatch.setattr(ps, name, spy)
    w = wave(cfg, B, 64, seed=B) if B > 1 else None
    if B == 1:
        kc, vc = caches(cfg, 64, 3)
        w = dict(kc=kc, vc=vc, tok_buf=tok_history(cfg, 64, 10, 3), kv_len=np.int32([20]),
                 x_len=np.int32([8]), last_tok=np.int32([5]), buf_len=np.int32([10]),
                 step_idx=np.int32([2]))
    w["kv_len"] = np.minimum(w["kv_len"], 60).astype(np.int32)
    state = ps.DecodeState(
        k_cache=torch.tensor(w["kc"]), v_cache=torch.tensor(w["vc"]),
        kv_len=torch.tensor(w["kv_len"]), x_len=torch.tensor(w["x_len"]),
        tok_buf=torch.tensor(w["tok_buf"]), buf_len=torch.tensor(w["buf_len"]),
        last_tok=torch.tensor(w["last_tok"]), step_idx=torch.tensor(w["step_idx"]))
    g = torch.tensor(np.random.RandomState(0).gumbel(size=(2, B, cfg.vocab_size)),
                     dtype=torch.float32)
    ps.decode_chunk(eng.params, pcfg, state, 2, ps.SampleArgs(), g, 0,
                    attn_impl=eng.attn_impl)
    want = {1: ("fused_decode_step_sample", "int8"), 6: ("fused_decode_step_sample_batched", "int8"),
            7: ("fused_decode_step_sample_batched", None), 10: ("_generic_step", None)}[B]
    assert seen == [want] * 2
    assert fused_step.fused_decode_step_sample.launches_q8 == 0  # the twins never count


def test_seven_slot_wave_under_q8_matches_jax_generic_step(monkeypatch):
    """A 7-slot wave under ``"fused_step_q8"`` runs the bf16 K2 twin: it gives
    JAX's XLA ``decode_chunk`` on the unquantized weights (JAX's engine takes
    its generic step above six slots) over a 1-step and a 5-step chunk, and
    the engine counts no quantized step."""
    from gsv_tts_tpu.runtime import t2s_session as js
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(8, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    B, S = 7, 128
    sa_kw = dict(top_k=15, use_prev=False)
    jstate, pstate, noise = both_prefill(cfg, jp, pcfg, pp, prompts(cfg, 6, seed=7), B, S,
                                         sa_kw, jax.random.PRNGKey(5))
    eng = ps.T2SEngine(pp, pcfg, gpt_cache=[(B, S)], attn_impl="fused_step_q8")
    for n in (1, 5):
        jstate, jtoks = js.decode_chunk(jp, cfg, jstate, n, js.SampleArgs(**sa_kw), 0,
                                        "float32", "xla")
        pstate, ptoks = ps.decode_chunk(eng.params, pcfg, pstate, n, ps.SampleArgs(**sa_kw),
                                        noise((n, B, cfg.vocab_size), None, None), 0,
                                        attn_impl=eng.attn_impl)
        np.testing.assert_array_equal(ptoks.numpy(), np.asarray(jtoks))
    for b, n in enumerate(np.asarray(jstate.kv_len)):
        np.testing.assert_allclose(pstate.k_cache[:, b, :n].numpy(),
                                   np.asarray(jstate.k_cache)[:, b, :n], rtol=RTOL, atol=ATOL)
    xs, ys, berts = zip(*prompts(cfg, 7, seed=9))
    eng.generate_batched(list(xs), list(ys), list(berts), top_k=1)
    st = eng.last_stats
    assert st["k2_steps"] > 0 and st["k1q_steps"] == st["k2q_steps"] == 0


def test_engine_generate_q8_matches_jax():
    """``T2SEngine(attn_impl="fused_step_q8").generate`` end to end (the
    prefill on the bf16 weights, chunks on the int8 pages, the suppression
    window, the repetition penalty) against the JAX engine under
    ``"fused_step_q8_interpret"`` on the same key chain: token for token over
    a bounded prefix."""
    from gsv_tts_tpu.runtime.t2s_session import T2SEngine as JEngine
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(1, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    rng = np.random.RandomState(13)
    x = rng.randint(1, 50, 10)
    y = rng.randint(0, 100, 6)
    bert = (rng.randn(10, cfg.bert_dim) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jtoks = np.asarray(JEngine(jp, cfg, gpt_cache=[(1, 128)], dtype=jnp.float32,
                               attn_impl="fused_step_q8_interpret").generate(
        x, y, bert, top_k=5, rng=key)).ravel()
    eng = ps.T2SEngine(pp, pcfg, gpt_cache=[(1, 128)], attn_impl="fused_step_q8")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
        ptoks = eng.generate(x, y, bert, top_k=5).ravel()
    n = min(len(jtoks), len(ptoks), 30)
    assert n == 30
    np.testing.assert_array_equal(ptoks[:n], jtoks[:n])
    assert (ptoks < cfg.eos).all()


@pytest.mark.parametrize("quant", QUANTS)
def test_suppression_window_holds_under_quant(quant):
    """With EOS's logit lifted far above the rest (the last LayerNorm's
    shift made a large vector u, its scale cut to a tenth, and EOS's head
    row set to u), the quantized chain never samples EOS (or the other
    suppressed ids) inside the suppression window (reference
    ``t2s_model.py:444-445``; ``tests/test_quant.py:106-126``) and samples
    it at once without the window."""
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp = jax_t2s(5, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    last = dict(pp["layers"][-1], ln2_g=pp["layers"][-1]["ln2_g"] * 0.1,
                ln2_b=torch.full_like(pp["layers"][-1]["ln2_b"], 3.0))
    pp = dict(pp, layers=pp["layers"][:-1] + [last], predict_w=pp["predict_w"].clone())
    pp["predict_w"][cfg.eos] = last["ln2_b"]
    eng = ps.T2SEngine(pp, pcfg, gpt_cache=[(1, 128)], attn_impl=PORT_IMPL[quant])
    kc, vc = caches(cfg, 128, 5)
    sa = ps.SampleArgs(top_k=5, repetition_penalty=1.0, use_prev=False)
    for until in (8, 0):
        state = ps.DecodeState(
            k_cache=torch.tensor(kc), v_cache=torch.tensor(vc), kv_len=torch.tensor([14]),
            x_len=torch.tensor([9]), tok_buf=torch.tensor(tok_history(cfg, 128, 6, 5)),
            buf_len=torch.tensor([6]), last_tok=torch.tensor([3], dtype=torch.int32),
            step_idx=torch.tensor([0]))
        g = torch.tensor(np.random.RandomState(until).gumbel(size=(8, 1, cfg.vocab_size)),
                         dtype=torch.float32)
        _, toks = ps.decode_chunk(eng.params, pcfg, state, 8, sa, g, until,
                                  attn_impl=eng.attn_impl)
        toks = toks.numpy().ravel()
        if until:
            assert not np.isin(toks, cfg.suppressed_tokens + (cfg.eos,)).any(), toks
        else:
            assert toks[0] == cfg.eos, toks


def test_quant_t2s_resolves_as_jax(tmp_path):
    """``quant_t2s`` maps as JAX's loader maps it (``True`` and ``"int8"`` to
    the int8 stream, ``"int4"`` to the int4 one) and reaches the engine through
    ``TTS`` and ``Config``."""
    from gsv_tts_tpu.loader import save_trained_gpt
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_gpt_weights, resolve_t2s_attn_impl

    cfg, jp = jax_t2s(0)
    save_trained_gpt(jp, cfg, str(tmp_path / "gpt"))
    assert Config(device="cpu").quant_t2s is False
    want = {False: "fused_step", True: "fused_step_q8", "int8": "fused_step_q8",
            "int4": "fused_step_q4"}
    for mode, impl in want.items():
        assert resolve_t2s_attn_impl(Config(device="cpu", quant_t2s=mode)) == impl
        gpt = get_gpt_weights(tmp_path / "gpt", Config(device="cpu", quant_t2s=mode))
        assert gpt.engine.attn_impl == impl
    tts = TTS(gpt_cache=[(1, 128)], models_dir=str(tmp_path), device="cpu", quant_t2s=True)
    tts.load_gpt_model(str(tmp_path / "gpt"))
    assert tts.gpt_models[str(tmp_path / "gpt")].engine.quant == "int8"
    tts.unload_gpt_model(str(tmp_path / "gpt"))
    assert not tts.gpt_models


def test_quant_t2s_rejects_what_jax_rejects():
    """A ``quant_t2s`` outside ``False, True, "int8", "int4"`` raises
    ``ValueError`` with JAX's message, at ``TTS()`` (JAX raises it at the
    load); ``quant_t2s`` with another ``attn_impl`` than ``"fused_step"``
    raises too (JAX has no such configuration)."""
    from gsv_tts_tpu.config import Config as JConfig
    from gsv_tts_tpu.loader import resolve_t2s_attn_impl as jresolve
    from gsv_tts_tpu_torch import TTS

    for bad in ("int3", "q8", 8):
        jc = JConfig()
        jc.quant_t2s = bad
        with pytest.raises(ValueError) as jerr:
            jresolve(jc)
        with pytest.raises(ValueError) as perr:
            TTS(device="cpu", quant_t2s=bad)
        assert str(perr.value) == str(jerr.value)
    for impl in ("flash", "fused", "fused_step_q8"):
        with pytest.raises(ValueError, match="attn_impl='fused_step'"):
            TTS(device="cpu", quant_t2s="int8", attn_impl=impl)
    assert TTS(device="cpu", quant_t2s=False, attn_impl="flash").tts_config.attn_impl == "flash"


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    return build_assets(tmp_path_factory.mktemp("models"))


def test_facade_infer_q8_matches_jax(assets):
    """End to end: ``TTS(quant_t2s="int8", device="cpu").infer`` against the
    JAX facade with ``quant_t2s="int8"`` running its q8 kernel in interpret
    mode (on the CPU JAX's loader keeps the XLA path, so its engine is set to
    ``"fused_step_q8_interpret"``), greedy, noise 0, exact-shape SoVITS on
    both: the same semantic tokens and the same waveform."""
    from gsv_tts_tpu import TTS as JaxTTS
    from gsv_tts_tpu_torch import TTS

    kw = dict(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
              stream_vocoder="exact", quant_t2s="int8")
    jtts = JaxTTS(dtype="float32", **kw)
    ptts = TTS(device="cpu", seed=0, **kw)
    toks = []
    for tts in (jtts, ptts):
        tts.load_gpt_model(assets["gpt"])
        tts.load_sovits_model(assets["sovits"])
        engine = tts.gpt_models[assets["gpt"]].engine
        orig = engine.generate

        def generate(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            toks.append(np.asarray(out).ravel())
            return out

        engine.generate = generate
    jtts.gpt_models[assets["gpt"]].engine.attn_impl = "fused_step_q8_interpret"
    jtts._rng = jax.random.PRNGKey(0)
    assert ptts.gpt_models[assets["gpt"]].engine.attn_impl == "fused_step_q8"
    args = (assets["spk"], assets["prompt"], "hello there.", "this is a test.")
    jclip = jtts.infer(*args, top_k=1, noise_scale=0.0)
    pclip = ptts.infer(*args, top_k=1, noise_scale=0.0)
    jtoks, ptoks = toks
    assert len(ptoks) >= 40
    np.testing.assert_array_equal(ptoks, jtoks)
    assert np.all(np.isfinite(pclip.audio_data))
    np.testing.assert_allclose(pclip.audio_data, np.asarray(jclip.audio_data), rtol=RTOL,
                               atol=ATOL)
