"""The SoVITS stage of GPT-SoVITS v2 / v2Pro: the VITS decode.

A configuration names its SoVITS family by ``"sovits_family"`` (none:
this one); the harness loads ``families/<name>.py`` and calls its four
functions:

* ``install(recorder, tts)``: what the window records of the stage, through
  ``recorder._patch``; here the facade's ``_sovits_decode`` (codes, phones
  and the audio it returned) into the current item's ``"sovits"`` list.
* ``warm(cell)``: the stage's CUDA graph captures, in set-up.
* ``reference(paths, device, weight_fn=None)``: the plain reference of the
  voice side (``reference.voice.VoiceReference``), which the shared checks
  also use for the prompt codes and the speaker embedding.
* ``numbers(ref, items, decodes, ctl=None)``: the stage's check numbers.

Numbers (each compared beside its limit where the cell's limits name it):

* ``sovits_spec``: relative L2 distance of the judged requests' SoVITS audio,
  as mel magnitudes, from the reference's decode of the same codes and
  phonemes (with the reference's own speaker conditioning worked out from
  the clip), pooled over the requests; ``sovits_err``, the waveform's worst
  relative error, is printed beside it (bf16 moves the waveform's phase).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def install(recorder, tts):
    def sovits_wrap(orig):
        def _sovits_decode(sovits, codes, text, ge, *a, **kw):
            audio, attn = orig(sovits, codes, text, ge, *a, **kw)
            cur = recorder._cur  # the item being recorded, or None
            if cur is not None and kw.get("slice_indices") is None:
                cur["sovits"].append({"codes": np.asarray(codes).reshape(-1).copy(),
                                      "phones": np.asarray(text).reshape(-1).copy(),
                                      "audio": np.asarray(audio).reshape(-1).copy()})
            return audio, attn
        return _sovits_decode

    recorder._patch(tts, "_sovits_decode", sovits_wrap)


def warm(cell):
    """Capture the padded SoVITS core for every (codes, phonemes) bucket
    the pool's texts and the cache's lengths reach, and the flow graph of
    every frame bucket ``_flow_bucket(2n)`` that an output of n = 1 ..
    s_max codes reaches, each once."""
    from gsv_tts_tpu_torch.tts import get_phones_and_bert

    tts = cell.tts
    sovits = tts.sovits_models[cell.sovits_key]
    ge = next(iter(tts.spk_audio_cache.values()))["ge"][cell.sovits_key] \
        if tts.spk_audio_cache else None
    if ge is None:
        v = cell.voices[0]
        tts.cache_spk_audio(v["spk"])
        ge = tts.spk_audio_cache[v["spk"]]["ge"][cell.sovits_key]
        tts.del_spk_audio(v["spk"])
    mult = 32
    phone_buckets = sorted({-(-len(get_phones_and_bert(t, tts.tts_config)[0]) // mult) * mult
                            for t in cell.pool})
    s_max = max(s for b, s in cell.gpt_cache if b == 1)  # codes a request can reach

    def decode(n, N):
        tts._sovits_decode(sovits, np.zeros((1, 1, n), np.int64), np.ones((1, N), np.int64),
                           ge, noise_scale=0.0)

    steps = range(mult, s_max + mult, mult)
    for N in phone_buckets:
        for n in steps:
            decode(n, N)
    # the flow buckets below 2 * mult frames (the configured sovits_cache) and
    # any other that the steps above step over: the smallest n reaching each
    warmed = {tts._flow_bucket(2 * n) for n in steps}
    for n in range(1, s_max + 1):
        bucket = tts._flow_bucket(2 * n)
        if bucket not in warmed:
            warmed.add(bucket)
            decode(n, phone_buckets[0])


def reference(paths, device, weight_fn=None):
    from reference.voice import VoiceReference

    return VoiceReference(paths["sovits"], paths["hubert"], paths.get("sv"), device,
                          weight_fn=weight_fn)


def numbers(ref, items: List[dict], decodes: List[dict], ctl=None) -> Dict[str, float]:
    """``sovits_err`` and ``sovits_spec`` of ``decodes`` (the program's audio
    with its codes, phonemes and speaker clip; ``items``, every judged
    request, are not needed here).  With ``ctl`` (a reference in the
    control's precision) the control's numbers against ``ref``."""
    from harness.check import rel
    from reference.stft_ref import mel_spectrogram

    out: Dict[str, float] = {}
    ge_cache: Dict[str, object] = {}
    s_num = s_den = 0.0
    for d in decodes:
        if d["spk_wav"] not in ge_cache:
            ge_cache[d["spk_wav"]] = ref.ge(d["spk_wav"])
        want = ref.decode(d["codes"], d["phones"], ge_cache[d["spk_wav"]])
        got = (ctl.decode(d["codes"], d["phones"], ctl.ge(d["spk_wav"])) if ctl is not None
               else d["audio"])
        out["sovits_err"] = max(out.get("sovits_err", 0.0), rel(got, want))
        n = min(len(got), len(want))
        ma = np.exp(mel_spectrogram(np.asarray(got[:n], np.float32), device=ref.device))
        mb = np.exp(mel_spectrogram(np.asarray(want[:n], np.float32), device=ref.device))
        s_num += float(np.sum((ma.astype(np.float64) - mb) ** 2))
        s_den += float(np.sum(mb.astype(np.float64) ** 2))
    if decodes:
        out["sovits_spec"] = (s_num / max(s_den, 1e-30)) ** 0.5
    return out
