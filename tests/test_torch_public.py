"""The remaining public pieces of the port against the JAX package: the
log-mel parity metric (``ops/stft.mel_spectrogram`` / ``mel_distance``),
``spectrogram(power=)``, ``generator(n_stages=)``, ``init_params(scale=)``,
the ``Gpt.t2s_model`` and ``get_symbols`` aliases, the engine's
``check_interval`` / ``initial_suppression_steps``, and an AST comparison of
the two packages' public names and parameters, module by module, that finds
nothing missing but what ``ROADMAP.md`` lists as deliberately not ported.
Float32 on the CPU; tokens compared exactly over bounded prefixes at
``top_k=1``."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_assets import HPS, jax_sovits, jax_t2s
from test_torch_assets import one_torch_thread  # noqa: F401
from test_torch_engine_batched import requests
from test_torch_fused_step import SMALL, _jax_noise_chain
from test_torch_t2s import port_t2s

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5
PREFIX = 30


def speech_like(seed, seconds, sr=32000):
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    return (0.4 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
            + 0.05 * rng.randn(t.size)).astype(np.float32)


# -- the log-mel metric and the spectrogram's power ---------------------------------------

@pytest.mark.parametrize("seed,seconds,sr", [(0, 1.3, 32000), (1, 0.5, 32000), (2, 0.7, 16000)])
def test_mel_spectrogram_and_distance_match_jax(seed, seconds, sr):
    from gsv_tts_tpu.ops import stft as js
    from gsv_tts_tpu_torch.ops import stft as ps

    a, b = speech_like(seed, seconds, sr), speech_like(seed + 10, seconds * 0.8, sr)
    got, want = ps.mel_spectrogram(a, sr, device="cpu"), js.mel_spectrogram(a, sr)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (128, len(a) // 640 + 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    d = ps.mel_distance(a, b, sr, device="cpu")
    assert isinstance(d, float) and d > 0
    assert d == pytest.approx(js.mel_distance(a, b, sr), rel=RTOL)
    assert ps.mel_distance(a, a, sr, device="cpu") == 0.0
    kw = dict(n_fft=1024, hop_length=256, win_length=800, n_mels=80, fmin=50.0, fmax=7000.0)
    np.testing.assert_allclose(ps.mel_spectrogram(a, sr, device="cpu", **kw),
                               js.mel_spectrogram(a, sr, **kw), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("power", [1.0, 2.0, 0.5])
def test_spectrogram_power_matches_jax(power):
    """``spectrogram(power=)`` against JAX's, within twice the power-1
    tolerance of ``test_torch_sovits`` for the square (d(m^2) = 2m dm)."""
    from gsv_tts_tpu.ops import stft as js
    from gsv_tts_tpu_torch.ops import stft as ps

    audio = np.random.RandomState(3).randn(2, 5000).astype(np.float32)
    want = np.asarray(js.spectrogram(jnp.asarray(audio), 1024, 256, 1024, power=power))
    got = ps.spectrogram(torch.tensor(audio), 1024, 256, 1024, power=power).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    if power != 1.0:
        one = ps.spectrogram(torch.tensor(audio), 1024, 256, 1024).numpy()
        np.testing.assert_allclose(got, one ** power, rtol=1e-5, atol=1e-6)


# -- SoVITS: the vocoder's stages and the initializer's scale -----------------------------

@pytest.fixture(scope="module")
def sovits_models():
    from gsv_tts_tpu_torch.convert import sovits_from_jax
    from gsv_tts_tpu_torch.models.sovits import SovitsConfig

    jcfg, jp = jax_sovits(1)
    pcfg = SovitsConfig.from_hps(HPS["model"], HPS["data"]["filter_length"] // 2 + 1)
    return jcfg, jp, pcfg, sovits_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("n_stages", [0, 1, 2, None])
def test_generator_stages_match_jax(sovits_models, n_stages):
    """``generator(n_stages=)`` returns the intermediate after that many
    upsampling stages, as JAX's does; ``None`` is the whole vocoder."""
    from gsv_tts_tpu.models import sovits as js
    from gsv_tts_tpu_torch.models import sovits as ps

    jcfg, jp, pcfg, pp = sovits_models
    rng = np.random.RandomState(4)
    z = rng.randn(1, jcfg.inter_channels, 23).astype(np.float32)
    ge = (rng.randn(1, 512, 1) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(js.generator, static_argnums=(1, 4))(
        jp, jcfg, jnp.asarray(z), jnp.asarray(ge), n_stages))
    got = ps.generator(pp, pcfg, torch.tensor(z), g=torch.tensor(ge), n_stages=n_stages).numpy()
    ups = np.prod(pcfg.upsample_rates[:n_stages] if n_stages is not None else
                  pcfg.upsample_rates)
    assert got.shape == want.shape and got.shape[-1] == 23 * ups
    if n_stages is not None:
        assert got.shape[1] == pcfg.upsample_initial_channel // 2 ** n_stages
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_init_params_scale():
    """``init_params(scale=)`` draws the weights N(0, scale): the same draws
    as the default scaled by scale / 0.05.  Constants (norm gains, biases,
    the PReLU slope) and the RVQ codebook, N(0, 1) in JAX's too, stay."""
    from gsv_tts_tpu_torch.models import sovits as ps
    from gsv_tts_tpu_torch.models.sovits import SovitsConfig

    pcfg = SovitsConfig.from_hps(HPS["model"], HPS["data"]["filter_length"] // 2 + 1)
    base = ps.init_params(pcfg, torch.Generator().manual_seed(0))
    small = ps.init_params(pcfg, torch.Generator().manual_seed(0), scale=0.01)
    assert base.keys() == small.keys()
    w = torch.cat([v.flatten() for k, v in small.items() if k.endswith("weight")])
    assert abs(float(w.std()) - 0.01) < 1e-3 and abs(float(w.mean())) < 1e-3
    for k, v in base.items():
        kept = k.endswith("_codebook.embed") or bool(torch.all(v == v.flatten()[0]))
        torch.testing.assert_close(small[k], v if kept else v * 0.2, rtol=1e-6, atol=0, msg=k)


# -- the aliases ---------------------------------------------------------------------

def test_gpt_t2s_model_alias_and_get_symbols(tmp_path):
    from gsv_tts_tpu.frontend import symbols as jsym
    from gsv_tts_tpu.loader import save_trained_gpt
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.frontend import symbols as psym
    from gsv_tts_tpu_torch.loader import get_gpt_weights

    cfg, jp = jax_t2s(0, **SMALL)
    save_trained_gpt(jp, cfg, tmp_path / "gpt")
    gpt = get_gpt_weights(str(tmp_path / "gpt"), Config(device="cpu", gpt_cache=[(1, 64)]))
    assert gpt.t2s_model is gpt.engine
    assert psym.get_symbols() == jsym.get_symbols() == psym.symbols
    assert psym.get_symbols() is not psym.get_symbols()  # a fresh list, as JAX's


# -- the engine's check interval and suppression window -------------------------------

@pytest.fixture(scope="module")
def t2s_models():
    cfg, jp = jax_t2s(2, **SMALL)
    pcfg, pp = port_t2s(cfg, jp)
    return cfg, jp, pcfg, pp


@pytest.mark.parametrize("check_interval,suppress", [(3, 0), (3, 20), (5, 10)])
def test_engine_check_interval_and_suppression_match_jax(t2s_models, monkeypatch,
                                                         check_interval, suppress):
    """``T2SEngine(check_interval=, initial_suppression_steps=)``: B=1
    ``generate`` gives JAX's engine's tokens with the same arguments (the
    same noise chain), each dispatch at most ``check_interval`` steps with
    the window it was given; the batched path keeps no window, as JAX's."""
    from gsv_tts_tpu.runtime.t2s_session import T2SEngine as JEngine
    from gsv_tts_tpu_torch.runtime import t2s_session as ps

    cfg, jp, pcfg, pp = t2s_models
    kw = dict(check_interval=check_interval, initial_suppression_steps=suppress)
    jeng = JEngine(jp, cfg, gpt_cache=[(1, 128)], dtype=jnp.float32, attn_impl="xla", **kw)
    peng = ps.T2SEngine(pp, pcfg, gpt_cache=[(1, 128)], attn_impl="xla", **kw)
    assert (peng.check_interval, peng.initial_suppression_steps) == (check_interval, suppress)
    xs, ys, berts = requests(cfg, 1, seed=5)
    key = jax.random.PRNGKey(4)
    jtoks = np.asarray(jeng.generate(xs[0], ys[0], berts[0], top_k=1, rng=key)).ravel()
    monkeypatch.setattr(ps.sampling, "gumbel_noise", _jax_noise_chain(key))
    chunks = []
    real = ps.decode_chunk

    def recording(params, cfg_, state, n_steps, sa, gumbel, suppress_until, *a, **k):
        chunks.append((n_steps, suppress_until))
        return real(params, cfg_, state, n_steps, sa, gumbel, suppress_until, *a, **k)

    monkeypatch.setattr(ps, "decode_chunk", recording)
    ptoks = peng.generate(xs[0], ys[0], berts[0], top_k=1).ravel()
    assert len(ptoks) == len(jtoks) > 0
    np.testing.assert_array_equal(ptoks[:PREFIX], jtoks[:PREFIX])
    assert chunks and all(n <= check_interval and s == suppress for n, s in chunks)
    assert chunks[0][0] == check_interval
    chunks.clear()
    peng.generate_batched(xs, ys, berts, top_k=1)
    assert chunks and all(s == 0 for _, s in chunks)
    assert max(n for n, _ in chunks) == check_interval


# -- the AST comparison of the public surfaces -----------------------------------------

# What the port leaves out of the JAX package's public surface on purpose, as
# ``ROADMAP.md`` ("Deliberately not ported") lists it: module, name (a function, a
# class, ``Class.method``, or ``name(param)`` for a parameter) and the reason.
TPU_LAYOUT = "a TPU layout (the nch/nlc duality, the packed weight page, the MXU convolutions)"
JAX_RUNTIME = "a JAX-runtime helper with no PyTorch meaning"
JAX_RNG = "a JAX PRNG key: the port takes a torch.Generator or the noise itself"
INTERPRET = "Pallas interpret mode: the port's wrappers run their twin on CPU tensors"
STATIC_DTYPE = "a jit static argument: the port takes the torch dtype"
MEASURE = "a TPU measurement mode (ablate, the t2s_softmax variants, the block size)"
ROUTE = "the routes are plain methods of a parsed dict under an aiohttp adapter"
EMBEDDER = "each embedder loads on first use and is kept"
NO_READER = "no reader in the port; the benchmark has its own"
NOT_PORTED = {
    ("config.py", "default_platform"): JAX_RUNTIME,
    ("config.py", "default_dtype(platform)"): "the port takes the torch device",
    ("models/sovits.py", "wn_nlc"): TPU_LAYOUT,
    ("models/sovits.py", "flow_reverse_nlc"): TPU_LAYOUT,
    ("models/sovits.py", "resblock1_nlc"): TPU_LAYOUT,
    ("models/sovits.py", "generator_nlc"): TPU_LAYOUT,
    ("models/sovits.py", "init_params(rng)"): JAX_RNG,
    ("models/sovits_train.py", "init_enc_q_params(rng)"): JAX_RNG,
    ("models/sovits_train.py", "rand_slice_segments(rng)"): JAX_RNG,
    ("models/sovits_train.py", "init_discriminator_params(rng)"): JAX_RNG,
    ("models/sovits_train.py", "train_forward(rng)"): JAX_RNG,
    ("models/t2s.py", "init_params(rng)"): JAX_RNG,
    ("models/t2s.py", "transformer_decode_step(unroll)"): "XLA loop unrolling",
    ("ops/convs.py", "conv1d_mm"): TPU_LAYOUT,
    ("ops/convs.py", "conv_transpose1d_mm"): TPU_LAYOUT,
    ("ops/flash_decode.py", "flash_decode_attention(interpret)"): INTERPRET,
    ("ops/flash_decode.py", "flash_decode_attention_layered(interpret)"): INTERPRET,
    ("ops/flash_prefill.py", "flash_prefill_attention(interpret)"): INTERPRET,
    ("ops/fused_layer.py", "fused_decode_layer(interpret)"): INTERPRET,
    ("ops/fused_step.py", "fused_decode_step(interpret)"): INTERPRET,
    ("ops/fused_step.py", "fused_decode_step_sample(interpret)"): INTERPRET,
    ("ops/fused_step.py", "fused_decode_step_sample_batched(interpret)"): INTERPRET,
    ("ops/fused_step.py", "fused_decode_step_sample(quant4)"): "the port takes quant=",
    ("ops/fused_step.py", "fused_decode_step_sample_batched(quant4)"): "the port takes quant=",
    ("ops/fused_step.py", "fused_decode_step_sample(ablate)"): MEASURE,
    ("ops/fused_step.py", "fused_decode_step_sample_batched(ablate)"): MEASURE,
    ("ops/fused_step.py", "fused_decode_step_sample_batched(block_s)"): MEASURE,
    ("ops/fused_step.py", "fused_decode_step_sample_batched(softmax)"): MEASURE,
    ("ops/fused_step.py", "pack_bias_page"): TPU_LAYOUT,
    ("ops/fused_step.py", "pad_rows8"): TPU_LAYOUT,
    ("ops/fused_step.py", "pack_layer_weights"): TPU_LAYOUT,
    ("ops/sampling.py", "gumbel_argmax"): JAX_RNG,
    ("ops/sampling.py", "sample"): JAX_RNG,
    ("parallel/shard.py", "dp_state_sharding"): "a GSPMD placement",
    ("parallel/train.py", "t2s_loss(seq_mesh)"): "the sequence split lives in the train step",
    ("runtime/t2s_session.py", "DecodeState.tree_flatten"): JAX_RUNTIME,
    ("runtime/t2s_session.py", "DecodeState.tree_unflatten"): JAX_RUNTIME,
    ("runtime/t2s_session.py", "prefill_batch(rng)"): JAX_RNG,
    ("runtime/t2s_session.py", "prefill_batch(dtype_name)"): STATIC_DTYPE,
    ("runtime/t2s_session.py", "prefill_slot(dtype_name)"): STATIC_DTYPE,
    ("runtime/t2s_session.py", "prefill_slots(dtype_name)"): STATIC_DTYPE,
    ("runtime/t2s_session.py", "decode_chunk(dtype_name)"): STATIC_DTYPE,
    ("runtime/t2s_session.py", "T2SEngine.generate(rng)"): JAX_RNG,
    ("runtime/t2s_session.py", "T2SEngine.generate_batched(rng)"): JAX_RNG,
    ("runtime/t2s_session.py", "T2SEngine.generate_batched_stream(rng)"): JAX_RNG,
    ("serving/server.py", "parse_json(request)"): ROUTE,
    **{("serving/server.py", f"TTSServer.{m}(request)"): ROUTE for m in (
        "root", "health", "drain", "metrics", "tts_stream", "tts_stream_batched",
        "tts_batched", "get_audio", "tts_v2", "set_gpt_weights", "set_sovits_weights")},
    **{("serving/webui.py", f"WebUI.{m}(request)"): ROUTE for m in (
        "index", "models", "presets", "synth", "vc", "history", "audio")},
    ("tts.py", "TTS.__init__(always_load_cnhubert)"): EMBEDDER,
    ("tts.py", "TTS.__init__(always_load_sv)"): EMBEDDER,
    ("tts.py", "TTS.__init__(t2s_softmax)"): MEASURE,
    ("utils/timing.py", "jax_profile"): JAX_RUNTIME,
    ("utils/timing.py", "enable_compilation_cache"): JAX_RUNTIME,
    ("utils/timing.py", "RTFMeter"): NO_READER,
    ("utils/timing.py", "RTFMeter.__init__"): NO_READER,
    ("utils/timing.py", "RTFMeter.measure"): NO_READER,
    ("utils/timing.py", "RTFMeter.add_audio"): NO_READER,
    ("utils/timing.py", "RTFMeter.rtf"): NO_READER,
    ("utils/timing.py", "percentile"): NO_READER,
    ("utils/torch_pickle.py", "*"): "replaced by torch.load(weights_only=True)",
}


def public_surface(path: Path) -> dict:
    """Top-level public functions and classes, their public methods (and
    ``__init__``), each with its parameter names."""
    def params(f):
        a = f.args
        names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        return names + [x.arg for x in (a.vararg, a.kwarg) if x is not None]

    out = {}
    for node in ast.parse(path.read_text(encoding="utf-8")).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name[0] != "_":
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef) and node.name[0] != "_":
            out[node.name] = []
            for m in node.body:
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)) and (
                        m.name[0] != "_" or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = params(m)
    return out


def test_public_surface_matches_jax_but_the_listed_departures():
    missing = set()
    for jpath in sorted((REPO / "gsv_tts_tpu").rglob("*.py")):
        rel = jpath.relative_to(REPO / "gsv_tts_tpu").as_posix()
        ppath = REPO / "gsv_tts_tpu_torch" / rel
        if not ppath.exists():
            missing.add((rel, "*"))
            continue
        jsurf, psurf = public_surface(jpath), public_surface(ppath)
        for name, jparams in jsurf.items():
            if name not in psurf:
                missing.add((rel, name))
                continue
            missing |= {(rel, f"{name}({p})") for p in jparams
                        if p not in psurf[name] and p not in ("self", "cls")}
    assert missing - NOT_PORTED.keys() == set(), "missing from the port"
    assert NOT_PORTED.keys() - missing == set(), "listed but present: take it off the list"
    roadmap = (REPO / "ROADMAP.md").read_text(encoding="utf-8")
    for rel, name in NOT_PORTED:  # ROADMAP names each function, parameter or module
        if name == "*":
            word = Path(rel).name
        elif "(" in name:
            word = name.split("(")[1].rstrip(")")
        else:
            word = name.split(".")[-1]
        assert f"`{word}" in roadmap or f"{word}`" in roadmap, f"{rel}: {name} not in ROADMAP.md"
