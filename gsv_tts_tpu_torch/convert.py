"""Parameters of the JAX package → parameters of this port.

The JAX package keeps t2s weights as a pytree with the layers stacked on a
leading axis and matrices as ``[in, out]``; SoVITS, HuBERT and the ERes2NetV2
speaker embedder as flat dicts keyed by the reference state-dict names
(weight norm already folded).  Given
those as numpy arrays (``jax.tree.map(np.asarray, params)``), these
functions build the port's parameters, so both packages can compute with the
same weights.  The BERT featurizer's dict keeps the state-dict names and
``[out, in]`` weights too; its int8 form adds ``::q8`` / ``::scale`` keys.
No JAX import is needed here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models import hubert as hubert_model
from .models import sovits as sovits_model
from .models import sv as sv_model
from .models import t2s as t2s_model
from .models.t2s import LAYER_KEYS, T2SConfig

_T2S_TOP = (  # (jax name, state-dict name, transpose)
    ("text_emb", "ar_text_embedding.word_embeddings.weight", False),
    ("audio_emb", "ar_audio_embedding.word_embeddings.weight", False),
    ("bert_proj_w", "bert_proj.weight", True),
    ("bert_proj_b", "bert_proj.bias", False),
    ("predict_w", "ar_predict_layer.weight", True),
)


def t2s_from_jax(params: Dict[str, Any], cfg: T2SConfig, dtype=torch.float32,
                 device="cpu") -> Dict[str, Any]:
    """Stacked JAX t2s pytree (numpy leaves) → per-layer port params.  A
    gradient pytree of the same structure converts the same way (``pe`` is
    rebuilt from the sine table, never read)."""
    sd = {}
    for ours, theirs, transpose in _T2S_TOP:
        a = np.asarray(params[ours], np.float32)
        sd[theirs] = torch.from_numpy(np.array(a.T if transpose else a, order="C"))
    sd["ar_text_position.alpha"] = torch.tensor(float(np.asarray(params["text_pos_alpha"]).reshape(-1)[0]))
    sd["ar_audio_position.alpha"] = torch.tensor(float(np.asarray(params["audio_pos_alpha"]).reshape(-1)[0]))
    layers = params["layers"]
    for i in range(cfg.num_layers):
        for ours, theirs, _ in LAYER_KEYS:
            a = np.asarray(layers[ours][i], np.float32)
            if ours.endswith("_w"):  # [in, out] → torch [out, in]
                a = a.T
            sd[f"t2s_transformer.blocks.{i}.{theirs}"] = torch.from_numpy(np.array(a, order="C"))
    return t2s_model.params_from_torch_state_dict(sd, cfg, dtype=dtype, device=device)


def _flat(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in params.items()}


def sovits_from_jax(params: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Flat JAX SoVITS params (numpy) → port params (same keys); also the
    fresh ``enc_q.*`` and discriminator dicts of JAX's ``sovits_train``."""
    return sovits_model.params_from_torch_state_dict(_flat(params), dtype=dtype, device=device)


def hubert_from_jax(params: Dict[str, Any], dtype=torch.float32,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Flat JAX HuBERT params (numpy) → port params (same keys)."""
    return hubert_model.params_from_torch_state_dict(_flat(params), dtype=dtype, device=device)


def roberta_params_from_jax(params: Dict[str, Any], dtype=torch.float32,
                            device="cpu") -> Dict[str, torch.Tensor]:
    """JAX ``CNRoberta.params`` (numpy) → the port's: the same keys, float
    tensors in ``dtype`` (float32 for the int8 form, whose scales are
    float32), the ``::q8`` int8 weights as they are."""
    out = {}
    for k, v in params.items():
        t = torch.from_numpy(np.array(v))
        out[k] = (t.to(dtype) if t.is_floating_point() else t).to(device)
    return out


def sv_from_jax(params: Dict[str, Any], cfg: sv_model.SVConfig = sv_model.SVConfig(),
                dtype=torch.float32, device="cpu") -> Dict[str, torch.Tensor]:
    """Flat JAX ERes2NetV2 params (``ERes2Net.params``, numpy) → port params:
    the keys the forward pass reads (a missing one raises, naming it)."""
    return sv_model.params_from_state_dict(_flat(params), cfg, dtype=dtype, device=device,
                                           where="the JAX SV params")
