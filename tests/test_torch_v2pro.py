"""The v2Pro / v2ProPlus SoVITS family against the JAX package: speaker
conditioning with the ERes2NetV2 embedding (``get_ge``), MRTE's ``ge_to512``
in the three SoVITS cores, and the facade — ``infer`` (exact path and
defaults), ``infer_batched``, ``infer_stream``, a speaker blend,
``infer_vc``, ``verify_speaker`` and the model and cache management — on
the same checkpoint files (a tiny v2ProPlus SoVITS at ``gin_channels``
1024, a full-width random ERes2NetV2 checkpoint, the shared tiny t2s and
HuBERT).

Facade pairs run with ``top_k=1`` and ``noise_scale=0``, and the port is fed
the JAX engine's tokens, so what is compared is everything after the t2s
stage.  Tolerance: rtol=2e-4, atol=2e-5 (float32 on both sides, summation
order only); subtitle words and text indices equal, times within one latent
frame."""
import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import (HPS_V2PRO, build_assets, jax_sovits,  # noqa: F401
                               text_modules_as_installed, write_sv_checkpoint)
from test_torch_sovits_padded import close, inputs, padded
from test_torch_assets import one_torch_thread  # noqa: F401
from test_torch_tts_defaults import feed_jax_tokens, same_clip

PROMPT_TEXT = "hello there."
TEXTS = ["this is a test.", "good day!", "one more line."]


@pytest.fixture(scope="module")
def models():
    from gsv_tts_tpu_torch.convert import sovits_from_jax
    from gsv_tts_tpu_torch.models.sovits import SovitsConfig

    jcfg, jp = jax_sovits(1, HPS_V2PRO)
    pcfg = SovitsConfig.from_hps(HPS_V2PRO["model"],
                                 HPS_V2PRO["data"]["filter_length"] // 2 + 1)
    return jcfg, jp, pcfg, sovits_from_jax(jax.tree.map(np.asarray, jp))


def test_v2pro_params_have_jax_keys_and_shapes(models):
    """``sovits_from_jax`` carries ``sv_emb``, ``ge_to512`` and ``prelu``, and
    the port's own ``init_params`` has the JAX ``init_params``'s keys and
    shapes for v2ProPlus at ``gin_channels`` 1024."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    want = {"sv_emb.weight": (1024, 20480), "sv_emb.bias": (1024,),
            "ge_to512.weight": (512, 1024), "ge_to512.bias": (512,), "prelu.weight": (1024,)}
    assert {k: tuple(pp[k].shape) for k in want} == want
    for k in want:
        assert np.array_equal(pp[k].numpy(), np.asarray(jp[k])), k
    shapes = jax.eval_shape(lambda: js.init_params(jax.random.PRNGKey(0), jcfg))
    mine = ps.init_params(pcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in mine.items()} == {k: v.shape for k, v in shapes.items()}


@pytest.mark.parametrize("version", ["v2Pro", "v2ProPlus"])
@pytest.mark.parametrize("with_sv", [True, False], ids=["sv_emb", "no-sv_emb"])
def test_get_ge_matches_jax(models, version, with_sv):
    """``get_ge`` for each v2Pro version: the style vector plus
    ``sv_emb``'s linear of the embedding through PReLU, or the style vector
    alone without an embedding."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    jcfg, pcfg = dataclasses.replace(jcfg, version=version), dataclasses.replace(
        pcfg, version=version)
    rng = np.random.RandomState(2)
    refer = np.abs(rng.randn(1, jcfg.spec_channels, 83)).astype(np.float32)
    emb = (rng.randn(1, 20480) * 0.5).astype(np.float32) if with_sv else None
    j = np.asarray(js.get_ge(jp, jcfg, jnp.asarray(refer),
                             None if emb is None else jnp.asarray(emb)))
    p = ps.get_ge(pp, pcfg, torch.tensor(refer), None if emb is None else torch.tensor(emb))
    assert p.shape == j.shape == (1, 1024, 1) and p.dtype == torch.float32
    close(p, j, "ge")
    plain = ps.get_ge(pp, pcfg, torch.tensor(refer))
    assert torch.equal(p, plain) != with_sv  # the embedding moves ge, its absence does not


@pytest.mark.parametrize("packed", [False, True], ids=["one-ge", "frame-wise-ge"])
def test_decode_core_and_flow_dec_match_jax(models, packed):
    """The exact core with a 1024-wide ``ge`` (one vector, or per code frame
    as the packed ``infer_batched`` gives it, with two requests' text
    spans): ``z_p``, the MRTE attention, the ``ge`` handed on at 1024, and
    flow⁻¹ + HiFi-GAN."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    n, N = 23, 17
    codes, text, ge, noise = inputs(jcfg, n, N, 3, 2 * n, n if packed else 1)
    si = np.repeat(np.asarray([[0, 7], [7, N]], np.int32), [20, 2 * n - 20], axis=0) \
        if packed else None
    jz, jmask, jattn, _, jge = jax.jit(
        lambda p, c, t, g, nz, s: js.decode_core(p, jcfg, c, t, g, nz, slice_indices=s))(
        jp, jnp.asarray(codes), jnp.asarray(text), jnp.asarray(ge), jnp.asarray(noise),
        None if si is None else jnp.asarray(si))
    pz, pmask, pattn, _, pge = ps.decode_core(
        pp, pcfg, torch.tensor(codes), torch.tensor(text), torch.tensor(ge),
        torch.tensor(noise), slice_indices=None if si is None else torch.tensor(si).long())
    assert pge.shape == (1, 1024, 2 * n if packed else 1)
    close(pz, jz, "z_p")
    close(pattn, jattn, "attn")
    close(pge, jge, "ge")
    ja = np.asarray(jax.jit(js.flow_dec, static_argnums=1)(jp, jcfg, jz, jmask, jge))
    pa = ps.flow_dec(pp, pcfg, pz, pmask, pge).numpy()
    assert pa.shape == ja.shape and np.abs(pa).max() > 0.05
    close(pa, ja, "audio")


@pytest.mark.parametrize("n,N,vsi,blend", [(20, 13, 0, False), (29, 30, 16, True)])
def test_decode_core_stream_padded_matches_jax(models, n, N, vsi, blend):
    """The padded core one row at a time, ``ge_to512`` inside: ``z_p``, the
    mask, the valid attention block and the new overlap."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    Bc, Np, ov = 32, 32, 5
    codes, text, ge, noise = inputs(jcfg, n, N, 5 + n, 2 * Bc)
    y_ov = (np.random.RandomState(n).randn(1, jcfg.hidden_channels, ov) * 0.5
            ).astype(np.float32)
    cp, tp = padded(codes, Bc), padded(text, Np)
    jout = jax.jit(lambda p, c, cl, t, tl, g, nz, yo, v: js.decode_core_stream_padded(
        p, jcfg, c, cl, t, tl, g, nz, yo, v, overlap_len=ov, blend=blend))(
        jp, jnp.asarray(cp), jnp.int32(n), jnp.asarray(tp), jnp.int32(N), jnp.asarray(ge),
        jnp.asarray(noise), jnp.asarray(y_ov), jnp.int32(vsi))
    i64 = torch.int64
    pout = ps.decode_core_stream_padded(
        pp, pcfg, torch.tensor(cp), torch.tensor(n, dtype=i64), torch.tensor(tp),
        torch.tensor(N, dtype=i64), torch.tensor(ge), torch.tensor(noise), torch.tensor(y_ov),
        torch.tensor(vsi, dtype=i64), overlap_len=ov, blend=blend)
    (pz, pmask, pattn, pnew), (jz, jmask, jattn, jnew) = pout, jout
    close(pz, jz, "z_p")
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    close(pattn[..., :2 * n, :N], np.asarray(jattn)[..., :2 * n, :N], "attn")
    close(pnew, jnew, "new overlap")


def test_decode_core_stream_padded_batch_matches_jax(models):
    """The batched padded core: two rows with their own speakers, lengths,
    offsets and blends."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = models
    Bc, Np, ov = 32, 32, 4
    rows = [(20, 13, 0, False), (29, 30, 16, True)]
    ins = [inputs(jcfg, n, N, 40 + i, 2 * Bc) for i, (n, N, _, _) in enumerate(rows)]
    y_ov = (np.random.RandomState(7).randn(2, jcfg.hidden_channels, ov) * 0.5
            ).astype(np.float32)
    cp = np.concatenate([padded(c, Bc) for c, _, _, _ in ins])
    tp = np.concatenate([padded(t, Np) for _, t, _, _ in ins])
    ge = np.concatenate([g for _, _, g, _ in ins])
    noise = np.concatenate([nz for _, _, _, nz in ins])
    lens = [np.asarray([r[k] for r in rows]) for k in range(4)]
    i64 = torch.int64
    pb = ps.decode_core_stream_padded_batch(
        pp, pcfg, torch.tensor(cp), torch.tensor(lens[0], dtype=i64), torch.tensor(tp),
        torch.tensor(lens[1], dtype=i64), torch.tensor(ge), torch.tensor(noise),
        torch.tensor(y_ov), torch.tensor(lens[2], dtype=i64), torch.tensor(lens[3]),
        overlap_len=ov)
    jb = jax.jit(lambda p, *a: js.decode_core_stream_padded_batch(p, jcfg, *a, overlap_len=ov))(
        jp, jnp.asarray(cp), jnp.asarray(lens[0], jnp.int32), jnp.asarray(tp),
        jnp.asarray(lens[1], jnp.int32), jnp.asarray(ge), jnp.asarray(noise),
        jnp.asarray(y_ov), jnp.asarray(lens[2], jnp.int32), jnp.asarray(lens[3]))
    for b, (n, N, _, _) in enumerate(rows):
        for k, (got, want) in enumerate(zip(pb, jb)):
            got, want = got[b:b + 1], np.asarray(want)[b:b + 1]
            if k == 2:  # attention: the row's valid block
                got, want = got[..., :2 * n, :N], want[..., :2 * n, :N]
            close(got, want, f"row {b} output {k}")


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    from gsv_tts_tpu.hparams import HParams
    from gsv_tts_tpu.loader import save_trained_sovits

    a = build_assets(tmp_path_factory.mktemp("models"))
    _, sp = jax_sovits(1, HPS_V2PRO)
    save_trained_sovits(sp, HParams(HPS_V2PRO), str(a["root"] / "sovits_v2pro"))
    return dict(a, v2pro=str(a["root"] / "sovits_v2pro"), sv=write_sv_checkpoint(a["root"]))


@pytest.fixture(scope="module")
def jax_sv(assets):
    """One JAX embedder for every JAX facade here (each instance compiles its
    own program)."""
    from types import SimpleNamespace

    from gsv_tts_tpu.models.sv import ERes2Net

    return ERes2Net(assets["sv"], SimpleNamespace(dtype=jnp.float32))


def _jax_tts(jax_sv, **kw):
    from gsv_tts_tpu import TTS as JaxTTS

    jtts = JaxTTS(dtype="float32", always_load_sv=True, **kw)
    jtts.sv_model = jax_sv
    return jtts


def _pair(assets, jax_sv, **kw):
    """A JAX and a port facade on the v2ProPlus model and the SV checkpoint;
    the port's engine returns what the JAX engine returned for the same
    call."""
    from gsv_tts_tpu_torch import TTS

    cache = [(1, 128), (2, 128)]
    jtts = _jax_tts(jax_sv, gpt_cache=cache, models_dir=str(assets["root"]), **kw)
    ptts = TTS(gpt_cache=cache, models_dir=str(assets["root"]), device="cpu", seed=0, **kw)
    for tts in (jtts, ptts):
        tts.load_gpt_model(assets["gpt"])
        tts.load_sovits_model(assets["v2pro"])
    jtts._rng = jax.random.PRNGKey(0)
    harvest = feed_jax_tokens(jtts.gpt_models[assets["gpt"]].engine,
                              ptts.gpt_models[assets["gpt"]].engine)
    return jtts, ptts, harvest


@pytest.fixture(scope="module")
def default_pair(assets, jax_sv):
    return _pair(assets, jax_sv)


@pytest.fixture(scope="module")
def exact_pair(assets, jax_sv):
    return _pair(assets, jax_sv, sovits_cache=[], stream_vocoder="exact")


KW = dict(top_k=1, noise_scale=0.0, return_subtitles=True)


@pytest.mark.parametrize("path", ["exact", "default"])
def test_infer_matches_jax(assets, default_pair, exact_pair, path):
    """``infer(return_subtitles=True)`` on the exact path and at the defaults
    (the padded core and the flow bucket): the cached embedding and ``ge``,
    then the same audio and subtitles as JAX's."""
    jtts, ptts, harvest = exact_pair if path == "exact" else default_pair
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT, "this is a test.")
    jclip, pclip = jtts.infer(*args, **KW), ptts.infer(*args, **KW)
    assert not harvest and pclip.subtitles and pclip.audio_data.size > 6400
    jent, pent = jtts.spk_audio_cache[assets["spk"]], ptts.spk_audio_cache[assets["spk"]]
    assert pent["sv_emb"].shape == (1, 20480) and pent["sv_emb"].dtype == torch.float32
    close(pent["sv_emb"], jent["sv_emb"], "sv_emb")
    close(pent["ge"][assets["v2pro"]], jent["ge"][assets["v2pro"]], "ge")
    same_clip(pclip, jclip, 0.02)


def test_infer_batched_matches_jax(assets, default_pair):
    """``infer_batched`` of three texts: the packed decode's frame-wise ``ge``
    through ``ge_to512``; clips and subtitles as JAX's."""
    jtts, ptts, harvest = default_pair
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT, TEXTS)
    jclips, pclips = jtts.infer_batched(*args, **KW), ptts.infer_batched(*args, **KW)
    assert not harvest and len(pclips) == len(jclips) == 3
    for pc, jc in zip(pclips, jclips):
        same_clip(pc, jc, 0.02)


def test_infer_stream_matches_jax(assets, default_pair):
    """``infer_stream`` over two segments at the defaults: every chunk and its
    subtitles as JAX's."""
    jtts, ptts, harvest = default_pair
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT,
            "this is a test of the stream. it has two parts.")
    kw = dict(KW, stream_chunk=15, cut_minlen=5)
    jclips = list(jtts.infer_stream(*args, debug=False, **kw))
    pclips = list(ptts.infer_stream(*args, **kw))
    assert not harvest and len(pclips) == len(jclips) >= 4
    for pc, jc in zip(pclips, jclips):
        same_clip(pc, jc, 0.02)


def test_speaker_blend_matches_jax(assets, default_pair):
    """``infer`` with a ``{path: weight}`` blend of two speakers, each with
    its own embedding."""
    jtts, ptts, harvest = default_pair
    spk = {assets["spk"]: 0.7, assets["prompt"]: 0.3}
    args = (spk, assets["prompt"], PROMPT_TEXT, "a blend of two.")
    jclip, pclip = jtts.infer(*args, **KW), ptts.infer(*args, **KW)
    assert not harvest and pclip.audio_data.size > 6400
    close(ptts.spk_audio_cache[assets["prompt"]]["sv_emb"],
          jtts.spk_audio_cache[assets["prompt"]]["sv_emb"], "the second speaker's sv_emb")
    same_clip(pclip, jclip, 0.02)


@pytest.mark.parametrize("speed", [1.0, 1.25])
def test_infer_vc_matches_jax(assets, default_pair, speed):
    """``infer_vc``: the prompt clip's own codes (HuBERT → RVQ) decoded in
    the speaker's voice — the padded core at speed 1, the exact core
    resampled at 1.25 — audio and subtitles (tail word, +0.2 s, text
    indices) as JAX's."""
    jtts, ptts, _ = default_pair
    args = (assets["spk"], assets["prompt"], PROMPT_TEXT)
    jclip = jtts.infer_vc(*args, noise_scale=0.0, speed=speed)
    pclip = ptts.infer_vc(*args, noise_scale=0.0, speed=speed)
    assert pclip.subtitles and pclip.subtitles[-1]["end_s"] > pclip.subtitles[-1]["start_s"]
    assert pclip.orig_text == jclip.orig_text == "hello there."
    same_clip(pclip, jclip, 0.02 / speed)
    st = ptts.last_timings
    assert st["sovits_s"] > 0 and st["tokens"] > 0 and st["sovits_graphs"] == 0


def test_verify_speaker_matches_jax_and_memoizes(assets, jax_sv):
    """``verify_speaker``: JAX's cosine within 1e-5, a clip against itself
    ≈ 1; an embedding computed for a clip cached under a v2 model (no
    embedding) is memoized into that entry, and a v2Pro model caching the
    clip afterwards reuses it."""
    from gsv_tts_tpu_torch import TTS

    root = str(assets["root"])
    jtts = _jax_tts(jax_sv, models_dir=root)
    ptts = TTS(models_dir=root, device="cpu")
    for tts in (jtts, ptts):
        tts.load_sovits_model(assets["sovits"], assets["v2pro"])
        tts.cache_spk_audio(assets["prompt"], sovits_model=assets["sovits"])
    assert ptts.spk_audio_cache[assets["prompt"]]["sv_emb"] is None
    cross = [t.verify_speaker(assets["spk"], assets["prompt"]) for t in (jtts, ptts)]
    assert abs(cross[1] - cross[0]) <= 1e-5 and -1.0 <= cross[1] <= 1.0
    assert ptts.verify_speaker(assets["spk"], assets["spk"]) == pytest.approx(1.0, abs=1e-5)
    memo = ptts.spk_audio_cache[assets["prompt"]]["sv_emb"]
    assert memo is not None and assets["spk"] not in ptts.spk_audio_cache
    close(memo, jtts.spk_audio_cache[assets["prompt"]]["sv_emb"], "memoized sv_emb")
    calls = []
    sv = ptts._get_sv_model()
    sv.compute_embedding3 = lambda wav: calls.append(wav)
    ptts.cache_spk_audio(assets["prompt"], sovits_model=assets["v2pro"])
    entry = ptts.spk_audio_cache[assets["prompt"]]
    assert not calls and entry["sv_emb"] is memo and set(entry["ge"]) == {assets["sovits"],
                                                                            assets["v2pro"]}


def test_lists_delete_and_unload_as_jax(assets, jax_sv, caplog):
    """The model and cache lists, ``del_*_audio`` and ``unload_*_model`` as
    JAX's (``tests/test_e2e.py:239-281``): an unloaded SoVITS model's ``ge``
    leaves every speaker entry, the entries and their embeddings stay; a
    name that is not there is a warning, not an error."""
    from gsv_tts_tpu_torch import TTS

    root = str(assets["root"])
    jtts = _jax_tts(jax_sv, gpt_cache=[(1, 128)], models_dir=root)
    ptts = TTS(gpt_cache=[(1, 128)], models_dir=root, device="cpu")
    seen = []
    for tts in (jtts, ptts):
        tts.load_gpt_model(assets["gpt"])
        tts.load_sovits_model(assets["v2pro"], assets["sovits"])
        tts.cache_prompt_audio(assets["prompt"], PROMPT_TEXT)
        tts.cache_spk_audio(assets["spk"])
        tts.cache_spk_audio(assets["spk"], sovits_model=assets["sovits"])
        state = [tts.get_gpt_list(), tts.get_sovits_list(), tts.get_prompt_audio_list(),
                 tts.get_spk_audio_list(), sorted(tts.spk_audio_cache[assets["spk"]]["ge"])]
        tts.unload_sovits_model(assets["v2pro"])
        entry = tts.spk_audio_cache[assets["spk"]]
        state += [tts.get_sovits_list(), sorted(entry["ge"]), entry["sv_emb"] is not None]
        tts.del_prompt_audio(assets["prompt"])
        tts.del_spk_audio(assets["spk"])
        tts.unload_gpt_model(assets["gpt"])
        state += [tts.get_prompt_audio_list(), tts.get_spk_audio_list(), tts.get_gpt_list()]
        with caplog.at_level(logging.WARNING):
            caplog.clear()
            tts.unload_sovits_model(assets["v2pro"])
            tts.unload_gpt_model(assets["gpt"])
            tts.del_spk_audio(assets["spk"])
            tts.del_prompt_audio(assets["prompt"])
        state.append(sum(r.levelno == logging.WARNING for r in caplog.records))
        seen.append(state)
    assert seen[1] == seen[0]
    assert seen[1][:5] == [[assets["gpt"]], [assets["v2pro"], assets["sovits"]],
                           [assets["prompt"]], [assets["spk"]],
                           sorted([assets["v2pro"], assets["sovits"]])]
    assert seen[1][5:] == [[assets["sovits"]], [assets["sovits"]], True, [], [], [], 4]


def test_cache_and_verify_without_the_model_log_and_return_as_jax(assets, jax_sv, caplog):
    """With no SoVITS model loaded, ``cache_spk_audio``, ``cache_prompt_audio``
    and ``verify_speaker`` log an error and return None, and so does
    ``cache_spk_audio`` naming a model that is not loaded; nothing is
    cached, as in JAX."""
    from gsv_tts_tpu_torch import TTS

    root = str(assets["root"])
    seen = []
    for tts in (_jax_tts(jax_sv, models_dir=root), TTS(models_dir=root, device="cpu")):
        with caplog.at_level(logging.ERROR):
            caplog.clear()
            out = [tts.cache_spk_audio(assets["spk"]),
                   tts.cache_prompt_audio(assets["prompt"], PROMPT_TEXT),
                   tts.verify_speaker(assets["spk"], assets["prompt"])]
            tts.load_sovits_model(assets["sovits"])
            out.append(tts.cache_spk_audio(assets["spk"], sovits_model=assets["v2pro"]))
            errors = sum(r.levelno == logging.ERROR for r in caplog.records)
        seen.append([out, errors, tts.get_spk_audio_list(), tts.get_prompt_audio_list()])
    assert seen[1] == seen[0] == [[None] * 4, 4, [], []]


def test_embedder_loaded_on_first_use_and_only_when_needed(assets):
    """The ERes2NetV2 embedder is loaded by the first call that computes an
    embedding and kept; calls that find every embedding they need cached
    (``verify_speaker``, ``cache_spk_audio`` under another model) never load
    it, and one that needs it without a checkpoint raises."""
    from gsv_tts_tpu_torch import TTS

    ptts = TTS(models_dir=str(assets["root"]), device="cpu")
    ptts.load_sovits_model(assets["v2pro"], assets["sovits"])
    assert ptts.sv_model is None
    ptts.cache_spk_audio(assets["spk"])
    sv = ptts.sv_model
    assert sv is not None
    ptts.cache_spk_audio(assets["prompt"])
    assert ptts.sv_model is sv

    ptts.sv_model, ptts.sv_path = None, assets["root"] / "sv" / "absent.ckpt"
    ptts.cache_spk_audio(assets["spk"], assets["prompt"], sovits_model=assets["sovits"])
    same = ptts.verify_speaker(assets["spk"], assets["spk"])
    assert same == pytest.approx(1.0, abs=1e-5) and ptts.sv_model is None
    assert set(ptts.spk_audio_cache[assets["spk"]]["ge"]) == {assets["v2pro"], assets["sovits"]}
    ptts.del_spk_audio(assets["prompt"])
    with pytest.raises(FileNotFoundError, match="absent.ckpt"):
        ptts.verify_speaker(assets["spk"], assets["prompt"])
