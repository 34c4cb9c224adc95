"""The streaming vocoder's whole chunk as one function of tensors
(counterpart of ``gsv_tts_tpu/runtime/vocoder_batch.py:_stream_batch_fused_jit``).

``TTS.infer_stream`` runs every bucketed chunk as the B=1 case, captured as
one CUDA graph per (codes bucket, text bucket, flow bucket, overlap) on the
card.  Not ported yet: ``VocoderBatcher``, which gathers the chunks of
concurrent streams into one call with B > 1 (ROADMAP Queue 1: batched
streaming and the shared wave).
"""
from __future__ import annotations

import torch.nn.functional as F

from ..models import sovits as sovits_model


def stream_batch_fused(params, cfg, codes_pad, codes_len, text_pad, text_len, ge, noise, y_ov,
                       vsi, blend, *, overlap_len: int, bucket: int):
    """The padded core (:func:`models.sovits.decode_core_stream_padded_batch`,
    same arguments), its latent padded or cut to the flow's ``bucket``
    frames, then flow⁻¹ and HiFi-GAN.  Returns (audio [B, 1, bucket·hop],
    attn [B, 4, 2·Bc, Np], new_overlap [B, hidden, overlap_len])."""
    z_p, mask, attn, new_ov = sovits_model.decode_core_stream_padded_batch(
        params, cfg, codes_pad, codes_len, text_pad, text_len, ge, noise, y_ov, vsi, blend,
        overlap_len=overlap_len)
    pad = bucket - z_p.shape[-1]  # negative: cut
    audio = sovits_model.flow_dec(params, cfg, F.pad(z_p, (0, pad)), F.pad(mask, (0, pad)), ge)
    return audio, attn, new_ov
