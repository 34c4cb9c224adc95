"""GPT-SoVITS v4 in the port (``models/sovits_v4.py``, ``models/cfm.py`` and
the facade's ``_v4_decode``) against the benchmark's plain float32
reference (``benchmark/reference/cfm_ref.py``), on seeded random weights at
tiny widths on the CPU: ``decode_encp`` (and its padded twin against it on
the valid frames, a planted unmasked ``pre`` failing), one DiT forward, the whole chunk
loop with the same noise, the 48 kHz vocoder; ``TTS.infer`` on a tiny v4
directory, the entry points that refuse v4, and the spans.  Planted
departures in the reference (the rotary on every head, one Euler step
dropped, the text embedding of a zero ``fea``) each fail the comparison.

Tolerances: both sides compute in float32 and differ in summation order
and in what the port precomputes once a chunk (every step's modulation in
one product, the rotary tables), so features and velocities agree to
rtol 1e-4 / atol 1e-5; the chunk loop's mel, four Euler steps over two
chunks, to atol 1e-4; the vocoder's audio, which sums ~40 conv layers, to
atol 1e-5.  Each planted departure moves the compared output by more than
100 times its tolerance."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_assets import HPS, build_assets

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from reference import cfm_ref  # noqa: E402

TINY_DIT = {"dim": 64, "depth": 2, "heads": 4, "dim_head": 16, "ff_mult": 2, "mel_dim": 100,
            "text_dim": 32, "conv_layers": 2, "conv_mult": 2, "freq_embed_dim": 32,
            "conv_pos_kernel": 31, "conv_pos_groups": 16}
TINY_VOCODER = {"initial_channel": 100, "resblock_kernel_sizes": [3],
                "resblock_dilation_sizes": [[1, 3]], "upsample_rates": [10, 6, 8],
                "upsample_initial_channel": 32, "upsample_kernel_sizes": [20, 12, 16]}
#: chunks of 130 frames with a prompt of at most 50: the facade's loop runs
#: several chunks on the tiny clips and texts
HPS_V4 = {"data": HPS["data"], "train": HPS["train"],
          "model": {**HPS["model"], "version": "v4", "cfm": TINY_DIT, "t_ref": 50,
                    "t_chunk": 130, "cfm_steps": 4},
          "vocoder": TINY_VOCODER}
FEATURE_TOL = dict(rtol=1e-4, atol=1e-5)


def write_v4_dir(root: Path, seed: int = 5) -> str:
    """A v4 SoVITS directory: ``hps.json``, ``model.safetensors`` and the
    vocoder's ``vocoder.pth``, from the port's initialisers (the vocoder's
    output conv ×10, as the benchmark lifts v2's, above the trim threshold)."""
    from gsv_tts_tpu_torch.models import sovits_v4
    from gsv_tts_tpu_torch.models.sovits import SovitsConfig
    from gsv_tts_tpu_torch.utils.safetensors import save_file

    d = root / "sovits_v4"
    d.mkdir()
    scfg = SovitsConfig.from_hps(HPS_V4["model"], HPS_V4["data"]["filter_length"] // 2 + 1)
    v4 = sovits_v4.V4Config.from_hps(HPS_V4)
    gen = torch.Generator().manual_seed(seed)
    save_file(sovits_v4.init_params(scfg, v4, gen), d / "model.safetensors")
    voc = sovits_v4.init_vocoder(v4, gen)
    voc["conv_post.weight"] = voc["conv_post.weight"] * 10
    torch.save(voc, str(d / "vocoder.pth"))
    (d / "hps.json").write_text(json.dumps(HPS_V4))
    return str(d)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("v4models")
    a = build_assets(root)
    a["v4"] = write_v4_dir(root)
    return a


@pytest.fixture(scope="module")
def model(assets):
    """The port's loaded model and the reference's parameters of the same files."""
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_sovits_weights

    cfg = Config(device="cpu", dtype=None, gpt_cache=[(1, 128)], sovits_cache=[])
    ref = cfm_ref.V4Reference(assets["v4"], assets["hubert"], "cpu")
    return get_sovits_weights(assets["v4"], cfg), ref


@pytest.fixture(scope="module")
def tts(assets):
    from gsv_tts_tpu_torch import TTS

    t = TTS(gpt_cache=[(1, 128)], sovits_cache=[], models_dir=str(assets["root"]),
            device="cpu", seed=1)
    t.load_gpt_model(assets["gpt"])
    t.load_sovits_model(assets["v4"])
    return t


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), **tol)


def _inputs(seed=0, n=9, N=7):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 1024, n), rng.randint(1, 300, N), torch.as_tensor(
        rng.randn(1, 512, 1).astype(np.float32) * 0.5)


def test_decode_encp_matches_reference(model):
    from gsv_tts_tpu_torch.models import sovits_v4

    m, ref = model
    codes, phones, ge = _inputs()
    got, attn = sovits_v4.decode_encp(m.params, m.cfg, m.v4, torch.as_tensor(codes)[None, None],
                                      torch.as_tensor(phones)[None], ge)
    want = ref.decode_encp(codes, phones, ge)
    assert got.shape == (1, TINY_DIT["text_dim"], 4 * len(codes)) == want.shape
    assert attn.shape == (1, 4, 2 * len(codes), len(phones))
    _close(got, want, **FEATURE_TOL)


#: t2s sequences of at most 128 tokens: codes padded to 32, 64, 96 or 128,
#: phones to 32 or 128
ENCP_TOP = 128


def _encp_padded_case(m, n, N, seed=11):
    """The padded ``decode_encp`` at the bucket of (n, N), the padding filled
    with other codes and phones, against the exact function; both take every
    bias drawn non-zero (the initialiser's are zero, and would hide a mask
    left out).  Returns ((fea, attn) cut to the valid frames, (fea, attn)
    exact)."""
    from gsv_tts_tpu_torch.models import sovits_v4

    g = torch.Generator().manual_seed(seed)
    p = {k: v + torch.randn(v.shape, generator=g) * 0.1 if k.endswith("bias") else v
         for k, v in m.params.items()}
    Bc, Np = sovits_v4.encp_bucket(sovits_v4.encp_buckets(ENCP_TOP), n, N)
    rng = np.random.RandomState(seed)
    codes, phones = rng.randint(0, 1024, Bc), rng.randint(1, 300, Np)
    ge = torch.as_tensor(rng.randn(1, 512, 1).astype(np.float32) * 0.5)
    fea, attn = sovits_v4.decode_encp_padded(
        p, m.cfg, m.v4, torch.as_tensor(codes)[None, None], torch.tensor(n),
        torch.as_tensor(phones)[None], torch.tensor(N), ge)
    assert fea.shape == (1, TINY_DIT["text_dim"], 4 * Bc) and attn.shape == (1, 4, 2 * Bc, Np)
    want = sovits_v4.decode_encp(p, m.cfg, m.v4, torch.as_tensor(codes[:n])[None, None],
                                 torch.as_tensor(phones[:N])[None], ge)
    return (fea[..., :4 * n], attn[:, :, :2 * n, :N]), want


def test_encp_buckets_are_few_and_cover_the_cache():
    """Eight (codes, phones) buckets up to the longest t2s sequence, at most."""
    from gsv_tts_tpu_torch.models import sovits_v4

    assert sovits_v4.encp_buckets(1024) == ((256, 512, 768, 1024), (256, 1024))
    assert sovits_v4.encp_buckets(ENCP_TOP) == ((32, 64, 96, 128), (32, 128))
    assert sovits_v4.encp_buckets(0) == ((), ())
    buckets = sovits_v4.encp_buckets(1000)
    assert sovits_v4.encp_bucket(buckets, 1000, 1000) == (1024, 1024)
    assert sovits_v4.encp_bucket(buckets, 257, 256) == (512, 256)
    assert sovits_v4.encp_bucket(buckets, 1025, 1) is None
    assert sovits_v4.encp_bucket(buckets, 1, 1025) is None


@pytest.mark.parametrize("n,N", [(32, 7), (33, 7), (1, 7), (9, 1), (9, 128), (128, 33)],
                         ids=["codes-at-an-edge", "codes-one-past", "one-code", "one-phone",
                              "phones-at-the-top", "both-wide"])
def test_padded_decode_encp_equals_exact_on_the_valid_frames(model, n, N):
    """The padded ``decode_encp`` over its first 4n frames and its first 2n
    attention rows and N columns is the exact function's at (n, N)."""
    (fea, attn), (want_fea, want_attn) = _encp_padded_case(model[0], n, N)
    _close(fea, want_fea, **FEATURE_TOL)
    _close(attn, want_attn, **FEATURE_TOL)


def test_padded_decode_encp_without_the_pre_mask_fails_the_comparison(model, monkeypatch):
    """Planted: ``wns1``'s ``pre`` output left unmasked (its bias on the
    padded frames reaches the last valid frames through the first kernel-5
    convolution): the features move far past the comparison's tolerance."""
    from gsv_tts_tpu_torch.models import sovits, sovits_v4
    from gsv_tts_tpu_torch.ops.convs import conv1d

    def unmasked_pre(p, v4, fea, mask, ge):
        fea = conv1d(fea, p["wns1.pre.weight"], p["wns1.pre.bias"])
        fea = sovits.wn(p, "wns1.enc.", fea, mask, v4.wns1_layers, v4.bridge_channels,
                        v4.wns1_kernel, 1, g=ge)
        return conv1d(fea, p["wns1.proj.weight"], p["wns1.proj.bias"])

    monkeypatch.setattr(sovits_v4, "_wns1", unmasked_pre)
    (fea, _), (want, _) = _encp_padded_case(model[0], 9, 7)
    with pytest.raises(AssertionError):
        _close(fea, want, **FEATURE_TOL)
    assert float((fea - want).abs().max()) > 100 * FEATURE_TOL["atol"]


def _dit_case(m, ref, T=37, seed=3, step=2, steps=4):
    from gsv_tts_tpu_torch.models import cfm

    g = torch.Generator().manual_seed(seed)
    fea = torch.randn(1, T, TINY_DIT["text_dim"], generator=g)
    x = torch.randn(1, T, 100, generator=g)
    cond = torch.randn(1, T, 100, generator=g)
    assert m.params[cfm.PFX + "mods"].shape[0] == steps
    got = cfm.dit_forward(m.params, m.v4.dit, x, cfm.conditioning(m.params, m.v4.dit, fea, cond),
                          cfm.rotary_tables(T, TINY_DIT["dim_head"], x.device),
                          m.params[cfm.PFX + "mods"][step], m.params[cfm.PFX + "final"][step])
    cd = cfm_ref.time_embedding(ref.p, "d_embed", torch.tensor([1.0 / steps]),
                                TINY_DIT["freq_embed_dim"])
    text = cfm_ref.text_embedding(ref.p, ref.dit_cfg, fea)
    return got, lambda **plant: cfm_ref.dit(ref.p, ref.dit_cfg, x, cond, text, cd,
                                            step / steps, **plant)


def test_dit_forward_matches_reference(model):
    got, want = _dit_case(*model)
    _close(got, want(), **FEATURE_TOL)


def _chunk_case(m, ref, seed=4, T=70, P=20):
    """One chunk by the port's Euler loop and a function running the
    reference's on the same inputs and noise."""
    from gsv_tts_tpu_torch.models import cfm

    g = torch.Generator().manual_seed(seed)
    fea = torch.randn(1, TINY_DIT["text_dim"], T, generator=g)
    prompt = torch.randn(1, 100, P, generator=g) * 0.5
    noise = torch.randn(1, 100, T, generator=g)
    got = cfm.cfm_chunk(m.params, m.v4.dit, fea, prompt, noise)
    return got, lambda **plant: ref.cfm(fea, prompt, noise, **plant)


def test_cfm_chunk_matches_reference(model):
    got, want = _chunk_case(*model)
    ref_x = want()
    assert float(got[..., :20].abs().max()) == 0.0  # the prompt's frames stay zero
    _close(got, ref_x, rtol=0, atol=1e-4)


@pytest.mark.parametrize("plant", [{"rot_all_heads": True}, {"drop_step": 3},
                                   {"zero_text": True}],
                         ids=["rotary-on-every-head", "one-euler-step-dropped",
                              "text-embedding-of-zero-fea"])
def test_planted_departures_fail_the_comparison(model, plant):
    """Each departure, planted in the reference, moves the chunk's mel (and,
    for the rotary, one DiT forward) far past the comparison's tolerance."""
    got, want = _chunk_case(*model)
    assert float((got - want(**plant)).abs().max()) > 100 * 1e-4
    if "rot_all_heads" in plant:
        v, vref = _dit_case(*model)
        assert float((v - vref(**plant)).abs().max()) > 100 * FEATURE_TOL["atol"]


def test_vocoder_matches_reference(model):
    from gsv_tts_tpu_torch.models import sovits_v4

    m, ref = model
    mel = torch.as_tensor(np.random.RandomState(6).randn(1, 100, 23).astype(np.float32)) * 3 - 6
    got = sovits_v4.vocode(m.vocoder, m.v4, mel).reshape(-1)
    want = ref.vocode(mel)
    assert got.shape == (23 * 480,) == want.shape
    _close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pad", [0.0, 5.0])
def test_vocoder_cut_at_its_frames_matches_reference_at_that_length(model, pad):
    """The vocoder at a longer bucket with every layer cut at the mel's
    frames (``frames``, as the facade's graphs run it): its first 480·F
    samples are the reference's at F frames, whatever pads the mel after
    them; uncut, the padding and the layers' biases past the mel move its
    last samples.  Both sides take the same biases drawn non-zero (the
    initialiser's are zero, and would hide a layer left uncut)."""
    from gsv_tts_tpu_torch.models import sovits_v4
    from reference import sovits_ref

    m, ref = model
    g = torch.Generator().manual_seed(8)
    bias = {k: torch.randn(v.shape, generator=g) * 0.1 for k, v in ref.vp.items()
            if k.endswith("bias")}
    vp, vp_ref = {**m.vocoder, **bias}, {**ref.vp, **bias}
    mel = torch.as_tensor(np.random.RandomState(7).randn(1, 100, 23).astype(np.float32)) * 3 - 6
    padded = torch.nn.functional.pad(mel, (0, 17), value=pad)
    got = sovits_v4.vocode(vp, m.v4, padded, torch.tensor([23])).reshape(-1)
    assert got.shape == (40 * 480,)
    want = sovits_ref.generator(vp_ref, ref.voc_cfg, mel).reshape(-1)
    _close(got[: 23 * 480], want, rtol=0, atol=1e-5)
    uncut = sovits_v4.vocode(vp, m.v4, padded).reshape(-1)[: 23 * 480]
    assert float((uncut - want).abs().max()) > 100 * 1e-5


def test_prompt_mel_matches_reference(tts, assets, model):
    """The facade's v4 mel of the prompt clip (``ops/stft.py:mel_v4``,
    normalised) against the reference's framing and rfft."""
    from reference.voice import read_wav

    _, ref = model
    got = tts._prompt_mel(assets["prompt"], tts.sovits_models[assets["v4"]].v4)
    audio, _ = read_wav(assets["prompt"])
    assert got.shape == (1, 100, len(audio) // 320)
    _close(got, ref.prompt_mel(assets["prompt"]), rtol=0, atol=1e-4)


def _recorded_infer(tts, assets, text="this is a test of the voice."):
    """``TTS.infer`` with each chunk's CFM inputs and the vocoder's mel kept."""
    chunks, mels = [], []
    orig_chunk, orig_voc = tts._cfm_chunk, tts._vocode_v4

    def _cfm_chunk(sovits, fea, prompt_mel, noise):
        out = orig_chunk(sovits, fea, prompt_mel, noise)
        chunks.append({"fea": fea.clone(), "prompt": prompt_mel.clone(), "noise": noise.clone(),
                       "out": out.clone()})
        return out

    def _vocode_v4(sovits, mel):
        mels.append(mel.clone())
        return orig_voc(sovits, mel)

    tts._cfm_chunk, tts._vocode_v4 = _cfm_chunk, _vocode_v4
    try:
        clip = tts.infer(assets["spk"], assets["prompt"], "hello there.", text, top_k=1)
    finally:
        del tts._cfm_chunk, tts._vocode_v4
    return clip, chunks, mels


def test_chunk_loop_and_infer_match_reference(tts, assets, model):
    """``TTS.infer`` on a tiny v4 directory: the facade's chunk loop (T_min,
    each chunk's features and prompt, the mel kept) equals the reference's
    own loop over the same codes, phones, speaker clip and noise, untaught
    by the program's outputs; the clip is 48 kHz audio of the vocoded mel."""
    _, ref = model
    captured = {}
    orig = tts._sovits_decode

    def _sovits_decode(sovits, codes, text, ge, *a, **kw):
        captured.update(codes=np.asarray(codes).reshape(-1), phones=np.asarray(text).reshape(-1),
                        prompt=kw["prompt"])
        out = orig(sovits, codes, text, ge, *a, **kw)
        captured["audio"] = out[0].reshape(-1)
        return out

    tts._sovits_decode = _sovits_decode
    try:
        clip, chunks, mels = _recorded_infer(tts, assets)
    finally:
        del tts._sovits_decode
    assert len(chunks) >= 2, "the tiny text should take more than one chunk"
    ge = ref.ge(assets["spk"])
    fea_ref = ref.decode_encp(captured["prompt"]["prompt"], captured["prompt"]["phones1"], ge)
    fea_todo = ref.decode_encp(captured["codes"], captured["phones"], ge)
    t_min, fea_p, mel_p = ref.chunking(fea_ref, ref.prompt_mel(assets["prompt"]))
    assert t_min == 50 and chunks[0]["prompt"].shape[-1] == t_min
    outs, step = [], ref.t_chunk - t_min
    for k, idx in enumerate(range(0, fea_todo.shape[-1], step)):
        part = fea_todo[..., idx: idx + step]
        fea = torch.cat([fea_p, part], dim=-1)
        _close(chunks[k]["fea"], fea, rtol=1e-4, atol=1e-4)
        x = ref.cfm(fea, mel_p, chunks[k]["noise"])
        _close(chunks[k]["out"], x, rtol=0, atol=1e-4)
        new = x[..., t_min:]
        outs.append(new)
        mel_p, fea_p = new[..., -t_min:], part[..., -t_min:]
    assert len(outs) == len(chunks)
    mel = cfm_ref.denorm(torch.cat(outs, dim=-1))
    _close(mels[0], mel, rtol=0, atol=1e-3)
    audio = ref.vocode(mels[0])
    assert captured["audio"].shape == audio.shape == (mel.shape[-1] * 480,)
    _close(captured["audio"], audio, rtol=0, atol=1e-5)
    assert clip.samplerate == 48000
    assert clip.audio_len_s == len(clip.audio_data) / 48000
    lt = tts.last_timings
    assert lt["cfm_chunks"] == [(int(c["fea"].shape[-1]), t_min, 4) for c in chunks]
    assert lt["cfm_s"] > 0 and lt["vocoder_s"] > 0 and lt["sovits_s"] >= lt["cfm_s"]


@pytest.mark.parametrize("call", ["infer_batched", "infer_stream", "infer_batched_stream",
                                  "stream_shared", "infer_vc"])
def test_v4_is_refused_outside_infer(tts, assets, call):
    spk, prompt, ptext, text = assets["spk"], assets["prompt"], "hello there.", "good day."
    args = {"infer_batched": ([spk], [prompt], [ptext], [text]),
            "infer_batched_stream": ([spk], [prompt], [ptext], [text]),
            "infer_stream": (spk, prompt, ptext, text),
            "stream_shared": (spk, prompt, ptext, text),
            "infer_vc": (spk, prompt, ptext)}[call]
    with pytest.raises(NotImplementedError, match="v4"):
        out = getattr(tts, call)(*args)
        if not hasattr(out, "audio_data") and not isinstance(out, list):
            list(out)


def test_v4_spans_nest_under_the_decode(tts, assets):
    """Traced, ``infer`` leaves ``gsv.sovits.encp`` (with one
    ``gsv.sovits.encp.*`` child for each of its two calls), one
    ``gsv.sovits.cfm`` a chunk (its frames, prompt and steps set) and
    ``gsv.sovits.vocoder`` under ``gsv.sovits.decode``; caching the prompt
    leaves ``gsv.voice.mel``."""
    from gsv_tts_tpu_torch.utils import timing

    timing.SPAN_LOG.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        tts.del_prompt_audio(assets["prompt"])
        tts.cache_prompt_audio(assets["prompt"], "hello there.")
        clip, chunks, _ = _recorded_infer(tts, assets)
    recs = timing.span_log()
    by_id = {r.id: r for r in recs}
    decode = [r for r in recs if r.name == "gsv.sovits.decode"]
    assert len(decode) == 1

    def under(name):
        return [r for r in recs if r.name == name and by_id[r.parent].name == "gsv.sovits.decode"]

    cfm_spans = under("gsv.sovits.cfm")
    encp = under("gsv.sovits.encp")
    assert len(encp) == 1 and len(under("gsv.sovits.vocoder")) == 1
    # the prompt's call and the output's, each its own child: eager on the CPU
    assert [r.name for r in recs if r.parent == encp[0].id] == ["gsv.sovits.encp.eager"] * 2
    assert [(r.attrs["frames"], r.attrs["prompt"], r.attrs["steps"]) for r in cfm_spans] == \
        [(int(c["fea"].shape[-1]), 50, 4) for c in chunks]
    mel = [r for r in recs if r.name == "gsv.voice.mel"]
    assert len(mel) == 1 and by_id[mel[0].parent].name == "gsv.request.cache_prompt_audio"
    assert "mel_v4" in tts.prompt_audio_cache[assets["prompt"]]
    assert len(clip.audio_data) > 0
