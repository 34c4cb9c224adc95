"""The frozen plain reference agrees with the port at tiny widths on the
CPU, in float32 (the port's own math, unbatched and unpadded)."""
import json
import math

import numpy as np
import torch

from harness import weights
from reference.t2s import T2SReference
from reference.voice import VoiceReference

import tiny


def test_t2s_reference_matches_the_port(tmp_path):
    from gsv_tts_tpu_torch.models import t2s

    root = tiny.build(tmp_path)
    table = weights.leaf_table("t2s-s1v3", root / "benchmark")
    gen = torch.Generator().manual_seed(3)
    sd = weights.draw_part(table, gen, "cpu", torch.float32)
    weights.t2s_shaping(sd, table["meta"], {"attn_out": 0.2, "mlp_out": 0.1, "qk_gain": 2.0})
    cfg = t2s.T2SConfig.from_checkpoint_config(table["meta"])
    params = t2s.params_from_torch_state_dict(sd, cfg)
    rng = np.random.RandomState(0)
    x, y = rng.randint(1, 732, 17), rng.randint(0, 1024, 23)
    bert = rng.randn(17, 1024).astype(np.float32) * 0.1
    xy, mask = t2s.embed_prompt_single(params, cfg, torch.as_tensor(x)[None],
                                       torch.as_tensor(y)[None], torch.as_tensor(bert)[None],
                                       torch.float32)
    h, _, _ = t2s.transformer_prefill(params, cfg, xy, mask)
    want = torch.nn.functional.linear(h[0, -len(y):], params["predict_w"])
    got = T2SReference(sd, table["meta"], "cpu").logits(x, y, bert)
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4)


def test_voice_reference_matches_the_port(tmp_path):
    from gsv_tts_tpu_torch.models import hubert, sovits, sv
    from gsv_tts_tpu_torch.ops import stft

    root = tiny.build(tmp_path)
    cfg = json.loads((root / "benchmark" / "configs" / "gsv-v2pro-en.json").read_text())
    cfg["assumed"]["weights_seed"] = 1
    paths = weights.write_models(cfg, 12, tmp_path / "m", "cpu", torch.float32,
                                 root / "benchmark")
    rng = np.random.RandomState(1)
    spk, prompt = tmp_path / "spk.wav", tmp_path / "prompt.wav"
    weights.save_wav(spk, weights.sine_voice(1.5, 200.0, rng))
    weights.save_wav(prompt, weights.sine_voice(1.2, 150.0, rng))
    vref = VoiceReference(paths["sovits"], paths["hubert"], paths["sv"], "cpu")

    hps = json.loads((paths["sovits"] / "hps.json").read_text())
    scfg = sovits.SovitsConfig.from_hps(hps["model"], hps["data"]["filter_length"] // 2 + 1)
    sp = sovits.params_from_torch_state_dict(weights.load_safetensors(
        paths["sovits"] / "model.safetensors"))
    # the speaker embedding and ge
    audio, sr = vref_audio = weights_read(spk)
    emb = sv.ERes2Net(paths["sv"], type("C", (), {"device": "cpu", "dtype": torch.float32})())
    a16 = stft.resample(audio[None], sr, 16000)
    want_e = emb.compute_embedding3(a16)
    assert torch.allclose(vref.sv_embedding(spk), want_e, atol=1e-4, rtol=1e-4)
    d = hps["data"]
    spec = stft.spectrogram(torch.as_tensor(audio[None]), d["filter_length"], d["hop_length"],
                            d["win_length"])
    want_ge = sovits.get_ge(sp, scfg, spec, want_e)
    got_ge = vref.ge(spk)
    assert torch.allclose(got_ge, want_ge, atol=1e-4, rtol=1e-4)
    # the prompt's codes
    hcfg = hubert.HubertConfig.from_json(paths["hubert"] / "config.json")
    hp = hubert.params_from_torch_state_dict(weights.load_safetensors(
        paths["hubert"] / "model.safetensors"))
    p_audio, p_sr = weights_read(prompt)
    wav16 = stft.resample(p_audio[None], p_sr, 16000).mean(axis=0)
    wav16 = np.concatenate([wav16, np.zeros(int(16000 * 0.3), np.float32)])
    ssl = hubert.hubert_forward(hp, hcfg, torch.as_tensor(wav16[None]))
    want_codes = sovits.extract_latent(sp, ssl.transpose(1, 2))[0, 0].numpy()
    assert np.array_equal(vref.prompt_codes(prompt), want_codes)
    # the decode of served codes
    codes = rng.randint(0, 1024, 37)
    phones = rng.randint(1, 732, 21)
    noise = torch.zeros((1, scfg.inter_channels, 74))
    z_p, y_mask, _, _, ge_out = sovits.decode_core(
        sp, scfg, torch.as_tensor(codes).reshape(1, 1, -1), torch.as_tensor(phones)[None],
        want_ge, noise)
    want_audio = sovits.flow_dec(sp, scfg, z_p, y_mask, ge_out).reshape(-1).numpy()
    got_audio = vref.decode(codes, phones, got_ge)
    assert got_audio.shape == want_audio.shape
    err = np.linalg.norm(got_audio - want_audio) / np.linalg.norm(want_audio)
    assert err < 1e-4, err


def weights_read(path):
    from reference.voice import read_wav

    return read_wav(path)


def test_fp8_control_rounds_each_row():
    from harness.check import fp8_rows

    t = torch.randn(64, 96)
    q = fp8_rows(t)
    rel = (q - t).norm() / t.norm()
    assert 0.005 < float(rel) < 0.08        # e4m3: 3 mantissa bits
    assert torch.equal(fp8_rows(q), q)      # already on the grid
    assert math.isclose(float(q.abs().amax(dim=1)[0]), float(t.abs().amax(dim=1)[0]),
                        rel_tol=1e-6)
