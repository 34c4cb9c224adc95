"""Checkpoint loading (counterpart of ``gsv_tts_tpu/loader.py``; reference
``gsv_tts/Loader.py``).

Two formats per model: a safetensors directory (``model.safetensors`` plus
``config.json`` for GPT or ``hps.json`` for SoVITS, as written by the JAX
package's ``save_trained_*`` and by :func:`save_trained_gpt` /
:func:`save_trained_sovits` here), read by the in-package reader; and the
reference's torch pickles (GPT ``.ckpt``, SoVITS ``.pth`` with its 2-byte
version header), read only through ``torch.load(weights_only=True)`` —
never with arbitrary unpickling.  :func:`gpt_to_safetensors` and
:func:`sovits_to_safetensors` convert those pickles into safetensors
directories, float32 as the JAX package's export writes them.  Nothing is
downloaded: a missing file raises an error that names it.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from .config import Config
from .hparams import HParams
from .models import cfm
from .models import sovits as sovits_model
from .models import sovits_v4
from .models import t2s as t2s_model
from .models.sovits import SovitsConfig
from .models.t2s import T2SConfig
from .runtime.t2s_session import T2SEngine
from .utils.safetensors import load_file, save_file

HEAD2VERSION = {b"01": "v2", b"05": "v2Pro", b"06": "v2ProPlus"}
# MD5(first 8 KiB) of the known pretrained checkpoints (``Loader.py:22-27``)
HASH_PRETRAINED = {
    "dc3c97e17592963677a4a1681f30c653": "v2",
    "6642b37f3dbb1f76882b69937c95a5f3": "v2",
    "c7e9fce2223f3db685cdfa1e6368728a": "v2Pro",
    "66b313e39455b57ab1b0bc0b239c9d0a": "v2ProPlus",
}
# training-checkpoint key → runtime key inside each block (``Loader.py:130-143``)
GPT_KEY_MAP = [
    ("self_attn.in_proj_weight", "qkv.weight"),
    ("self_attn.in_proj_bias", "qkv.bias"),
    ("self_attn.out_proj.weight", "out_proj.weight"),
    ("self_attn.out_proj.bias", "out_proj.bias"),
    ("linear1.weight", "mlp.0.weight"),
    ("linear1.bias", "mlp.0.bias"),
    ("linear2.weight", "mlp.2.weight"),
    ("linear2.bias", "mlp.2.bias"),
    ("norm1.weight", "norm1.weight"),
    ("norm1.bias", "norm1.bias"),
    ("norm2.weight", "norm2.weight"),
    ("norm2.bias", "norm2.bias"),
]


class Gpt:
    """Loaded stage-1 model."""

    def __init__(self, engine: T2SEngine, params, cfg: T2SConfig, config: Dict[str, Any]):
        self.engine = engine
        self.params = params
        self.cfg = cfg
        self.config = config

    # the JAX package's alias: reference code calls gpt.t2s_model.infer(...)
    @property
    def t2s_model(self) -> T2SEngine:
        return self.engine


class Sovits:
    """Loaded stage-2 model; a v4 model also holds its ``V4Config`` and its
    48 kHz vocoder's parameters."""

    def __init__(self, params, cfg: SovitsConfig, hps: HParams,
                 v4: Optional[sovits_v4.V4Config] = None, vocoder=None):
        self.params = params
        self.cfg = cfg
        self.hps = hps
        self.v4 = v4
        self.vocoder = vocoder

    @property
    def samplerate(self) -> int:
        """The rate of the audio it makes: 48000 for v4, else the ``hps``'."""
        return self.v4.samplerate if self.v4 is not None else int(self.hps.data.sampling_rate)


def _require(path: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(f"model file not found: {path}")
    return path


def _torch_load(path_or_bytes) -> Dict[str, Any]:
    """Tensors, dicts and plain values only (``weights_only=True``)."""
    return torch.load(path_or_bytes, map_location="cpu", weights_only=True)


def _float_state_dict(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float() if torch.is_tensor(v) and v.is_floating_point()
            else torch.as_tensor(v) for k, v in sd.items()}


def resolve_t2s_attn_impl(tts_config: Config) -> str:
    """The engine's ``attn_impl`` for a config: ``"xla"`` when
    ``use_flash_attn`` is false (the JAX package's mapping, whatever
    ``attn_impl`` and ``quant_t2s`` say); else ``attn_impl``, or under
    ``quant_t2s`` the quantized whole-step stream (``True`` and ``"int8"``:
    ``"fused_step_q8"``, ``"int4"``: ``"fused_step_q4"``).  Validates
    unconditionally, as the JAX package does (``loader.py:191-215``): a
    ``quant_t2s`` outside ``False, True, "int8", "int4"`` raises, and so does
    ``quant_t2s`` with an ``attn_impl`` other than ``"fused_step"``, which
    has no quantized kernels."""
    quant_mode = getattr(tts_config, "quant_t2s", False)
    if quant_mode not in (False, True, "int8", "int4"):
        raise ValueError(
            f"quant_t2s must be False, True ('int8'), 'int8' or 'int4', "
            f"got {quant_mode!r}")
    if not getattr(tts_config, "use_flash_attn", True):
        return "xla"
    if not quant_mode:
        return tts_config.attn_impl
    if tts_config.attn_impl != "fused_step":
        raise ValueError(
            f"quant_t2s={quant_mode!r} quantizes the whole-step kernels' weight stream: it "
            f"needs attn_impl='fused_step', not {tts_config.attn_impl!r}")
    return "fused_step_q4" if quant_mode == "int4" else "fused_step_q8"


def get_hash_from_file(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.md5(f.read(8192)).hexdigest()


def load_sovits_raw(sovits_path: str) -> Tuple[Dict[str, Any], Optional[str]]:
    """Read a ``.pth`` whose first two bytes may be a version tag in place
    of the zip magic ``PK`` (``Loader.py:42-57``)."""
    digest = get_hash_from_file(_require(sovits_path))
    with open(sovits_path, "rb") as f:
        meta = f.read(2)
        version = HEAD2VERSION.get(meta) or HASH_PRETRAINED.get(digest)
        if meta != b"PK":
            return _torch_load(io.BytesIO(b"PK" + f.read())), version
    return _torch_load(sovits_path), version


def _sovits_pth(sovits_path: str) -> Tuple[Dict[str, Any], HParams, str]:
    """A ``.pth``'s state dict, hyperparameters (25 Hz semantics, the
    version written into them) and version; a version neither the header,
    the hash table nor the config names raises."""
    dict_s2, version = load_sovits_raw(sovits_path)
    hps = HParams(dict_s2["config"])
    hps.model.semantic_frame_rate = "25hz"
    if version is None:
        version = hps.model.get("version")
        if version not in ("v2", "v2Pro", "v2ProPlus"):
            raise ValueError("The SoVITS model is not the v2/v2Pro/v2ProPlus version. "
                             "Please check the model file.")
    hps.model.version = version
    return dict_s2["weight"], hps, version


def get_sovits_weights(sovits_path, tts_config: Config) -> Sovits:
    sovits_path = str(sovits_path)
    if os.path.isdir(sovits_path):
        with open(_require(os.path.join(sovits_path, "hps.json"))) as f:
            hps = HParams(json.load(f))
        weights = load_file(_require(os.path.join(sovits_path, "model.safetensors")))
        version = hps.model.get("version", "v2")
    else:
        weight, hps, version = _sovits_pth(sovits_path)
        weights = _float_state_dict(weight)
    model_d = hps.model.to_dict() if isinstance(hps.model, HParams) else dict(hps.model)
    model_d["version"] = version
    cfg = SovitsConfig.from_hps(model_d, hps.data.filter_length // 2 + 1)
    params = sovits_model.params_from_torch_state_dict(
        weights, dtype=tts_config.dtype, device=tts_config.device)
    if not cfg.is_v4:
        return Sovits(params, cfg, hps)
    if not os.path.isdir(sovits_path):
        raise ValueError(f"a GPT-SoVITS v4 model loads from a directory holding hps.json, "
                         f"model.safetensors and its vocoder, not from {sovits_path}")
    v4 = sovits_v4.V4Config.from_hps(hps.to_dict())
    vocoder = sovits_v4.vocoder_params(_vocoder_state(sovits_path), tts_config.dtype,
                                       tts_config.device)
    return Sovits(cfm.prepare_params(params, v4.dit, v4.steps), cfg, hps, v4=v4, vocoder=vocoder)


def _vocoder_state(sovits_dir: str) -> Dict[str, torch.Tensor]:
    """A v4 directory's vocoder: ``vocoder.safetensors``, else the published
    ``vocoder.pth`` (tensors only, ``weights_only=True``)."""
    st = os.path.join(sovits_dir, "vocoder.safetensors")
    if os.path.exists(st):
        return load_file(st)
    return _float_state_dict(_torch_load(_require(os.path.join(sovits_dir, "vocoder.pth"))))


def remap_gpt_state_dict(weight: Dict[str, Any], n_layer: int) -> Dict[str, Any]:
    """Training-checkpoint names → runtime names (``Loader.py:145-154``)."""
    weight = dict(weight)
    for i in range(n_layer):
        old_l = f"model.h.layers.{i}."
        new_l = f"t2s_transformer.blocks.{i}."
        for old_w, new_w in GPT_KEY_MAP:
            if old_l + old_w in weight:
                weight[new_l + new_w] = weight.pop(old_l + old_w)
    return {(k[len("model."):] if k.startswith("model.") else k): v
            for k, v in weight.items()}


def _gpt_ckpt(gpt_path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A training ``.ckpt``'s config and its state dict under runtime names."""
    dict_s1 = _torch_load(_require(gpt_path))
    config = dict_s1["config"]
    return config, remap_gpt_state_dict(dict_s1["weight"], config["model"]["n_layer"])


def get_gpt_weights(gpt_path, tts_config: Config) -> Gpt:
    gpt_path = str(gpt_path)
    attn_impl = resolve_t2s_attn_impl(tts_config)
    if os.path.isdir(gpt_path):
        with open(_require(os.path.join(gpt_path, "config.json"))) as f:
            config = json.load(f)
        weights = load_file(_require(os.path.join(gpt_path, "model.safetensors")))
    else:
        config, weights = _gpt_ckpt(gpt_path)
        weights = _float_state_dict(weights)
    cfg = T2SConfig.from_checkpoint_config(config)
    params = t2s_model.params_from_torch_state_dict(
        weights, cfg, dtype=tts_config.dtype, device=tts_config.device)
    engine = T2SEngine(params, cfg, gpt_cache=tts_config.gpt_cache or [(1, 512), (1, 1024)],
                       dtype=tts_config.dtype, attn_impl=attn_impl)
    return Gpt(engine, params, cfg, config)


def save_trained_gpt(params, cfg: T2SConfig, output_dir, config: Optional[dict] = None):
    """Write t2s params as a safetensors directory :func:`get_gpt_weights`
    (and the JAX package's loader) can read; ``config`` is written as its
    ``config.json`` (default: ``cfg``'s)."""
    os.makedirs(output_dir, exist_ok=True)
    save_file(t2s_model.params_to_torch_state_dict(params, cfg),
              os.path.join(output_dir, "model.safetensors"))
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(cfg.to_checkpoint_config() if config is None else config, f, indent=4,
                  ensure_ascii=False)


def save_trained_sovits(params, hps: HParams, output_dir):
    """Write SoVITS params (float32) with their ``hps.json``."""
    os.makedirs(output_dir, exist_ok=True)
    save_file({k: v.detach().to("cpu", torch.float32) for k, v in params.items()},
              os.path.join(output_dir, "model.safetensors"))
    with open(os.path.join(output_dir, "hps.json"), "w") as f:
        json.dump(hps.to_dict(), f, indent=4, ensure_ascii=False)


# -- safetensors export (``TTS.to_safetensors``; reference ``TTS.py:1482-1523``) --

def _all_float32(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Every tensor as float32 (what the JAX package's export writes)."""
    return {k: v.detach().to("cpu", torch.float32) if torch.is_tensor(v) else torch.as_tensor(v)
            for k, v in sd.items()}


def gpt_to_safetensors(gpt_path, output_dir, tts_config: Optional[Config] = None):
    """A GPT ``.ckpt`` → a safetensors directory (``model.safetensors`` under
    runtime names, float32, and the checkpoint's ``config.json``) that both
    packages load."""
    config, weights = _gpt_ckpt(str(gpt_path))
    os.makedirs(output_dir, exist_ok=True)
    save_file(_all_float32(weights), os.path.join(output_dir, "model.safetensors"))
    with open(os.path.join(output_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=4, ensure_ascii=False)


def sovits_to_safetensors(sovits_path, output_dir, tts_config: Optional[Config] = None):
    """A SoVITS ``.pth`` → a safetensors directory (float32 weights and an
    ``hps.json`` naming the version) that both packages load."""
    weight, hps, _ = _sovits_pth(str(sovits_path))
    os.makedirs(output_dir, exist_ok=True)
    save_file(_all_float32(weight), os.path.join(output_dir, "model.safetensors"))
    with open(os.path.join(output_dir, "hps.json"), "w") as f:
        json.dump(hps.to_dict(), f, indent=4, ensure_ascii=False)
