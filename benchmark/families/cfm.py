"""The SoVITS stage of GPT-SoVITS v4: ``decode_encp``, the flow-matching DiT
over chunks of up to ``T_chunk`` mel frames (32 Euler steps each), the 48 kHz
vocoder.  The harness loads this module for a configuration naming
``"sovits_family": "cfm"`` and calls its four functions (``families/vits.py``
says what each does); a program without a v4 stage is a ``RunError`` here,
before anything is written.

* ``install``: the facade's ``_sovits_decode`` (the codes, phones, the
  prompt's codes and phones, the 48 kHz audio), each ``_cfm_chunk`` of it
  (the chunk's frames, its noise, its prompt mel and the new mel it made) and
  ``_vocode_v4`` (the denormalised mel it vocoded), into the judged item's
  ``"sovits"`` list.  Tensors stay on the card until the check.
* ``warm``: the vocoder's CUDA graph of every frame bucket an output of
  1 .. s_max codes (4 mel frames a code) reaches, and the CFM's Euler-step
  graph of every chunk length such an output gives each cached voice's
  prompt (T_min + the chunk's new frames), each once.
* ``reference``: ``reference.cfm_ref.V4Reference``.
* ``numbers``:

  - ``cfm_mel_gap``: relative L2 distance of the judged decodes' new mel
    frames, chunk by chunk, from the reference's CFM run on its own
    ``decode_encp`` features (from the codes, phones and speaker clip) and the
    program's noise; the first chunk's prompt is the reference's mel of the
    prompt clip, a later chunk's the program's previous chunk (teacher
    forcing), so an error does not carry from chunk to chunk.  Pooled over the
    chunks; ``inf`` where the program's chunking (T_min, frames) differs.
  - ``v4_audio_spec``: relative L2 distance of the program's 48 kHz audio, as
    mel magnitudes (n_fft 2048, hop 480, 128 mels), from the reference
    vocoder's audio of the program's mel at the mel's own length, pooled
    (the program vocodes at a frame bucket with every layer cut at the mel's
    length, which the reference knows nothing of); ``v4_audio_err``, the
    waveform's worst relative error, is printed beside it.

:func:`dit_flops` counts a chunk's DiT work for the ``cfm_mfu`` reader.
"""
from __future__ import annotations

import importlib
import math
from typing import Dict, List, Optional

import numpy as np

from harness.cli import RunError
from reference.cfm_ref import DIT

try:
    importlib.import_module("gsv_tts_tpu_torch.models.sovits_v4")
except ImportError as exc:
    raise RunError("the program has no GPT-SoVITS v4 stage "
                   "(gsv_tts_tpu_torch.models.sovits_v4): it cannot run this configuration") \
        from exc

AUDIO_MEL = {"sr": 48000, "n_fft": 2048, "hop_length": 480, "win_length": 2048, "n_mels": 128}


def dit_flops(frames: int, steps: int, widths: Optional[dict] = None) -> int:
    """Floating-point operations of one chunk of ``frames`` mel frames over
    ``steps`` Euler steps: the text stack and the step-size embedding once,
    then at each step the time embedding, every block's and the final
    modulation, the input projection, the two grouped convs, each block's
    q/k/v/out projections, its attention over frames² and its feed-forward,
    and the output projection (2 a multiply-add; nothing is padded)."""
    c = dict(DIT, **(widths or {}))  # the published widths, or a configuration's
    T, D, Dt, M = frames, c["dim"], c["text_dim"], c["mel_dim"]
    inner, ff, fe = c["heads"] * c["dim_head"], D * c["ff_mult"], c["freq_embed_dim"]

    def lin(rows, i, o):
        return 2 * rows * i * o

    text = c["conv_layers"] * (2 * T * Dt * 7 + 2 * lin(T, Dt, Dt * c["conv_mult"]))
    temb = lin(1, fe, D) + lin(1, D, D)
    block = lin(T, D, 3 * inner) + 2 * (2 * T * T * inner) + lin(T, inner, D) \
        + 2 * lin(T, D, ff) + lin(1, D, 6 * D)
    step = temb + lin(1, D, 2 * D) + lin(T, 2 * M + Dt, D) \
        + 2 * (2 * T * D * (D // c["conv_pos_groups"]) * c["conv_pos_kernel"]) \
        + c["depth"] * block + lin(T, D, M)
    return text + temb + steps * step


def install(recorder, tts):
    state = {"d": None}

    def decode_wrap(orig):
        def _sovits_decode(sovits, codes, text, ge, *a, **kw):
            cur, prompt = recorder._cur, kw.get("prompt")
            d = None
            if cur is not None and prompt is not None:
                d = {"codes": np.asarray(codes).reshape(-1).copy(),
                     "phones": np.asarray(text).reshape(-1).copy(),
                     "prompt_codes": np.asarray(prompt["prompt"]).reshape(-1).copy(),
                     "prompt_phones": np.asarray(prompt["phones1"]).reshape(-1).copy(),
                     "prompt_wav": cur["prompt_wav"], "chunks": [], "mel": None}
            state["d"] = d
            try:
                audio, attn = orig(sovits, codes, text, ge, *a, **kw)
            finally:
                state["d"] = None
            if d is not None:
                d["audio"] = np.asarray(audio).reshape(-1).copy()
                cur["sovits"].append(d)
            return audio, attn
        return _sovits_decode

    def chunk_wrap(orig):
        def _cfm_chunk(sovits, fea, prompt_mel, noise):
            out = orig(sovits, fea, prompt_mel, noise)
            d = state["d"]
            if d is not None:
                P = prompt_mel.shape[-1]
                d["chunks"].append({"frames": int(fea.shape[-1]), "prompt_frames": int(P),
                                    "noise": noise.detach().clone(),
                                    "prompt": prompt_mel.detach().clone(),
                                    "new": out[..., P:].detach().clone()})
            return out
        return _cfm_chunk

    def vocode_wrap(orig):
        def _vocode_v4(sovits, mel):
            if state["d"] is not None:
                state["d"]["mel"] = mel.detach().clone()
            return orig(sovits, mel)
        return _vocode_v4

    recorder._patch(tts, "_sovits_decode", decode_wrap)
    recorder._patch(tts, "_cfm_chunk", chunk_wrap)
    recorder._patch(tts, "_vocode_v4", vocode_wrap)


def warm(cell):
    """Capture the vocoder at every frame bucket ``_flow_bucket(4n)`` that an
    output of n = 1 .. s_max codes reaches, and the CFM step at every chunk
    length T_min + ((4n − 1) mod (T_chunk − T_min)) + 1 that it gives a
    cached voice's prompt (T_min = min(its v4 mel frames, 4 × its codes,
    T_ref), as ``_v4_decode`` chunks), each once."""
    import torch

    tts = cell.tts
    sovits = tts.sovits_models[cell.sovits_key]
    v4, dev = sovits.v4, tts.device
    s_max = max(s for b, s in cell.gpt_cache if b == 1)
    seen = set()
    for n in range(1, s_max + 1):
        bucket = tts._flow_bucket(4 * n)
        if bucket not in seen:
            seen.add(bucket)
            tts._vocode_v4(sovits, torch.zeros((1, v4.dit.mel_dim, bucket), device=dev))
    lengths = set()
    for v in cell.voices:
        entry = tts.prompt_audio_cache.get(v["prompt"])
        if entry is None:
            continue
        t_min = min(entry["mel_v4"].shape[-1], 4 * np.asarray(entry["prompt"]).size, v4.t_ref)
        step = v4.t_chunk - t_min
        lengths |= {(t_min, t_min + (4 * n - 1) % step + 1) for n in range(1, s_max + 1)}
    for t_min, T in sorted(lengths):
        tts._cfm_chunk(sovits, torch.zeros((1, v4.dit.text_dim, T), device=dev),
                       torch.zeros((1, v4.dit.mel_dim, t_min), device=dev),
                       torch.zeros((1, v4.dit.mel_dim, T), device=dev))
    torch.cuda.synchronize()


def reference(paths, device, weight_fn=None):
    from reference.cfm_ref import V4Reference

    return V4Reference(paths["sovits"], paths["hubert"], device, weight_fn=weight_fn)


def _chunk_mels(r, d: dict, ge, mel0) -> Optional[List]:
    """The new mel of each of the decode's chunks by reference ``r`` on its
    own features, the program's noise and, after the first chunk, the
    program's prompt mel; None where the program chunked otherwise."""
    import torch

    fea_ref = r.decode_encp(d["prompt_codes"], d["prompt_phones"], ge)
    fea_todo = r.decode_encp(d["codes"], d["phones"], ge)
    t_min, fea_p, mel_p = r.chunking(fea_ref, mel0)
    step = r.t_chunk - t_min
    n_chunks = math.ceil(fea_todo.shape[-1] / step)
    if len(d["chunks"]) != n_chunks:
        return None
    out = []
    for k, c in enumerate(d["chunks"]):
        part = fea_todo[..., k * step: (k + 1) * step]
        fea = torch.cat([fea_p, part], dim=-1)
        if c["prompt_frames"] != t_min or c["frames"] != fea.shape[-1]:
            return None
        prompt = mel_p if k == 0 else c["prompt"].float()
        out.append(r.cfm(fea, prompt, c["noise"])[..., t_min:])
        fea_p = part[..., -t_min:]
    return out


def _spec_terms(got, want, device):
    """Σ(|M(got)| − |M(want)|)² and Σ|M(want)|² of two waveforms' mel
    magnitudes (``AUDIO_MEL``), over the shorter length."""
    from reference.stft_ref import mel_spectrogram

    n = min(len(got), len(want))
    ma = np.exp(mel_spectrogram(np.asarray(got[:n], np.float32), device=device, **AUDIO_MEL))
    mb = np.exp(mel_spectrogram(np.asarray(want[:n], np.float32), device=device, **AUDIO_MEL))
    mb = mb.astype(np.float64)
    return float(np.sum((ma.astype(np.float64) - mb) ** 2)), float(np.sum(mb ** 2))


def numbers(ref, items: List[dict], decodes: List[dict], ctl=None) -> Dict[str, float]:
    """``cfm_mel_gap``, ``v4_audio_spec`` and ``v4_audio_err`` of ``decodes``
    (``items``, every judged request, are not needed here).  With ``ctl``
    (a reference in the control's precision) the control's numbers against
    ``ref``."""
    import torch

    from harness.check import rel

    out: Dict[str, float] = {}
    ge_cache: Dict[str, tuple] = {}
    m_num = m_den = 0.0
    a_num = a_den = 0.0
    chunks = 0
    for d in decodes:
        spk = d["spk_wav"]
        if spk not in ge_cache:
            ge_cache[spk] = (ref.ge(spk), ctl.ge(spk) if ctl is not None else None)
        ge, ge_ctl = ge_cache[spk]
        mel0 = ref.prompt_mel(d["prompt_wav"])
        want = _chunk_mels(ref, d, ge, mel0)
        got = [c["new"] for c in d["chunks"]] if ctl is None else _chunk_mels(ctl, d, ge_ctl, mel0)
        if want is None or got is None:
            m_num = math.inf
        else:
            for w, g in zip(want, got):
                w, g = w.double().cpu(), g.double().cpu()
                m_num += float(((g - w) ** 2).sum())
                m_den += float((w ** 2).sum())
                chunks += 1
        mel = d["mel"].float()
        a_want = ref.vocode(mel)
        a_got = ctl.vocode(mel) if ctl is not None else d["audio"]
        out["v4_audio_err"] = max(out.get("v4_audio_err", 0.0), rel(a_got, a_want))
        num, den = _spec_terms(a_got, a_want, ref.device)
        a_num, a_den = a_num + num, a_den + den
        del mel
    if decodes:
        out["cfm_mel_gap"] = (m_num / max(m_den, 1e-30)) ** 0.5
        out["cfm_chunks_judged"] = chunks
        out["v4_audio_spec"] = (a_num / max(a_den, 1e-30)) ** 0.5
    torch.cuda.empty_cache() if torch.cuda.is_available() else None
    return out
