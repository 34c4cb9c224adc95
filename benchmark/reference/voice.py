"""Plain float32 reference of the voice side of GPT-SoVITS v2 / v2Pro:
the speaker conditioning ``ge`` (linear spectrogram → style encoder, plus
the ERes2NetV2 embedding for v2Pro), the prompt's semantic codes
(HuBERT → ``ssl_proj`` → RVQ), and the SoVITS decode of served codes
(MRTE text encoder, flow⁻¹, HiFi-GAN) with no noise, at exact shapes.

Built on the frozen copies beside this file; weights come from the files the
benchmark wrote.  ``weight_fn`` maps every matrix of the decode path before
use (the control puts a lower precision there).  Imports nothing of the
program.
"""
from __future__ import annotations

import json
import wave
from pathlib import Path

import numpy as np
import torch

from . import hubert_ref, sovits_ref, stft_ref, sv_ref
from .io import load_file


def read_wav(path) -> tuple:
    """16-bit PCM mono WAV → (float32 [T], rate)."""
    with wave.open(str(path), "rb") as w:
        sr, n = w.getframerate(), w.getnframes()
        pcm = np.frombuffer(w.readframes(n), "<i2").astype(np.float32) / 32768.0
    return pcm, sr


def _matrices(params: dict, weight_fn):
    if weight_fn is None:
        return params
    return {k: (weight_fn(v) if v.dim() >= 2 and "codebook" not in k else v)
            for k, v in params.items()}


class VoiceReference:
    def __init__(self, sovits_dir, hubert_dir, sv_ckpt, device, weight_fn=None):
        sovits_dir = Path(sovits_dir)
        hps = json.loads((sovits_dir / "hps.json").read_text())
        self.hps = hps
        self.cfg = sovits_ref.SovitsConfig.from_hps(hps["model"],
                                                    hps["data"]["filter_length"] // 2 + 1)
        sd = load_file(sovits_dir / "model.safetensors")
        self.p = _matrices(sovits_ref.params_from_torch_state_dict(sd, device=device),
                           weight_fn)
        self.device = device
        self.hubert_dir = Path(hubert_dir)
        self.sv_ckpt = sv_ckpt
        self.weight_fn = weight_fn
        self._hubert = None
        self._sv = None

    # -- featurizers --------------------------------------------------------
    def _hubert_params(self):
        if self._hubert is None:
            cfg = hubert_ref.HubertConfig.from_json(self.hubert_dir / "config.json")
            sd = load_file(self.hubert_dir / "model.safetensors")
            self._hubert = (cfg, _matrices(hubert_ref.params_from_torch_state_dict(
                sd, device=self.device), self.weight_fn))
        return self._hubert

    def _sv_params(self):
        if self._sv is None:
            sd = torch.load(str(self.sv_ckpt), map_location="cpu", weights_only=True)
            self._sv = _matrices(sv_ref.params_from_state_dict(
                {k: v.float() for k, v in sd.items()}, device=self.device), self.weight_fn)
        return self._sv

    @torch.no_grad()
    def sv_embedding(self, spk_wav) -> torch.Tensor:
        audio, sr = read_wav(spk_wav)
        a16 = stft_ref.resample(audio[None], sr, 16000)
        feat = torch.as_tensor(np.stack([sv_ref.kaldi_fbank(w) for w in a16]),
                               device=self.device)
        return sv_ref.eres2netv2_forward3(self._sv_params(), feat, sv_ref.SVConfig())

    @torch.no_grad()
    def ge(self, spk_wav, sv_emb=None) -> torch.Tensor:
        """[1, gin, 1] float32; for a v2Pro model the clip's own embedding
        unless one is given."""
        audio, sr = read_wav(spk_wav)
        audio = audio[None]
        sr1 = int(self.hps["data"]["sampling_rate"])
        if sr != sr1:
            audio = stft_ref.resample(audio, sr, sr1)
        maxx = np.abs(audio).max()
        if maxx > 1:
            audio = audio / min(2.0, maxx)
        d = self.hps["data"]
        spec = stft_ref.spectrogram(torch.as_tensor(audio, device=self.device),
                                    d["filter_length"], d["hop_length"], d["win_length"])
        if self.cfg.is_v2pro and sv_emb is None:
            sv_emb = self.sv_embedding(spk_wav)
        return sovits_ref.get_ge(self.p, self.cfg, spec, sv_emb)

    @torch.no_grad()
    def prompt_codes(self, prompt_wav) -> np.ndarray:
        return self.prompt_distances(prompt_wav).argmin(dim=1).cpu().numpy()

    @torch.no_grad()
    def prompt_distances(self, prompt_wav) -> torch.Tensor:
        """Squared distances [frames, codebook] of the prompt's projected
        HuBERT features to the first quantizer's codebook: the codes are
        each row's nearest."""
        audio, sr = read_wav(prompt_wav)
        wav16k = stft_ref.resample(audio[None], sr, 16000).mean(axis=0)
        wav16k = np.concatenate([wav16k, np.zeros(int(16000 * 0.3), np.float32)])
        cfg, hp = self._hubert_params()
        ssl = hubert_ref.hubert_forward(hp, cfg, torch.as_tensor(wav16k[None],
                                                                 device=self.device))
        proj = sovits_ref.conv1d(ssl.transpose(1, 2), self.p["ssl_proj.weight"],
                                 self.p["ssl_proj.bias"], stride=2)[0].T.float()
        embed = self.p["quantizer.vq.layers.0._codebook.embed"].float()
        return ((proj ** 2).sum(-1, keepdim=True) - 2 * proj @ embed.T
                + (embed ** 2).sum(-1)[None, :])

    # -- decode ---------------------------------------------------------------
    @torch.no_grad()
    def decode(self, codes, phones, ge) -> np.ndarray:
        """Audio [n·2·hop] float32 of ``codes`` [n] against ``phones`` [N]."""
        dev = self.device
        codes = torch.as_tensor(np.asarray(codes, np.int64).reshape(1, 1, -1), device=dev)
        text = torch.as_tensor(np.asarray(phones, np.int64).reshape(1, -1), device=dev)
        noise = torch.zeros((1, self.cfg.inter_channels, 2 * codes.shape[-1]), device=dev)
        z_p, y_mask, _, _, ge_out = sovits_ref.decode_core(self.p, self.cfg, codes, text,
                                                           ge.float(), noise)
        audio = sovits_ref.flow_dec(self.p, self.cfg, z_p, y_mask, ge_out)
        return audio.reshape(-1).float().cpu().numpy()
