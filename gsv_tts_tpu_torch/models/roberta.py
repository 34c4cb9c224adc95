"""CNRoberta phone-level BERT featurizer (counterpart of
``gsv_tts_tpu/models/roberta.py``; reference ``Featurizer/cnroberta.py``).

chinese-roberta-wwm-ext-large character features from ``hidden_states[-3]``
(the output of layer ``N-2``; the last two layers and the MLM head are never
computed) are repeated over ``word2ph`` into phone-level 1024-d rows, which
the t2s prefill adds to the Chinese phones' embeddings.  Post-LN BERT,
driven by the Hugging Face ``config.json`` and ``vocab.txt``, read from
``model.safetensors`` (the port's own reader) or ``pytorch_model.bin``
(``torch.load(weights_only=True)``) without ``transformers``.

Numerics follow the JAX package: attention scores in float32 with a -1e9
bias on padded keys, probabilities cast back to the hidden dtype before the
value product, exact (erf) GELU in float32, linear weights cast to the
input's dtype.  ``quant=True`` (``Config.quant_bert``) runs the encoder's
linear layers as int8 × int8 products (per-output-channel weight scales,
per-row dynamic activation scales) with the rest in float32.  The int8
products accumulate exactly: a float32 product is not exact at K=4096
(4096 · 127² > 2^24) and ``torch.matmul`` takes no integer tensors on CUDA,
so they run as float64 products, exact below 2^53, on the CPU and the card.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import unicodedata
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.convs import linear
from ..ops.norms import layer_norm
from ..utils.safetensors import load_file

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 21128
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def from_json(cls, path) -> "BertConfig":
        with open(path) as f:
            c = json.load(f)
        return cls(
            vocab_size=c["vocab_size"],
            hidden_size=c["hidden_size"],
            num_hidden_layers=c["num_hidden_layers"],
            num_attention_heads=c["num_attention_heads"],
            intermediate_size=c["intermediate_size"],
            max_position_embeddings=c["max_position_embeddings"],
            type_vocab_size=c.get("type_vocab_size", 2),
            layer_norm_eps=c.get("layer_norm_eps", 1e-12),
        )

    def to_dict(self) -> dict:
        return {**dataclasses.asdict(self), "model_type": "bert"}


# -- int8 dynamic quantization (``quant_bert``) --------------------------------

_Q8_KEYS = ("attention.self.query", "attention.self.key", "attention.self.value",
            "attention.output.dense", "intermediate.dense", "output.dense")


def quantize_bert_params(p: Dict[str, torch.Tensor], cfg: BertConfig) -> Dict[str, torch.Tensor]:
    """Every encoder linear weight → int8 ``[in, out]`` (``key + "::q8"``)
    and a float32 scale per output channel (``key + "::scale"``);
    everything else passes through as float32."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in p.items():
        if (k.endswith(".weight") and k.startswith("encoder.")
                and any(q in k for q in _Q8_KEYS)):
            w = v.to(F32)                                   # [out, in]
            s = w.abs().amax(dim=1) / 127.0
            s = torch.where(s > 0, s, torch.ones_like(s))
            q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
            out[k + "::q8"] = q.T.contiguous()              # [in, out]
            out[k + "::scale"] = s
        else:
            out[k] = v.to(F32)
    return out


def _q8_linear(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Per-row dynamic activation quantization, the int8 product (exact, in
    float64), and the float32 dequantization."""
    s = x.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.where(s > 0, s, torch.ones_like(s))
    xq = torch.clamp(torch.round(x / s), -127, 127)
    acc = torch.matmul(xq.to(torch.float64), wq.to(torch.float64))
    return acc.to(F32) * s * ws + b


def _encoder(p, cfg: BertConfig, input_ids, attention_mask, lin):
    """Embeddings and the first ``N-2`` layers; ``lin(name, x)`` is the
    layers' linear map."""
    B, T = input_ids.shape
    h = (p["embeddings.word_embeddings.weight"][input_ids.long()]
         + p["embeddings.position_embeddings.weight"][None, :T]
         + p["embeddings.token_type_embeddings.weight"][0][None, None, :])
    h = layer_norm(h, p["embeddings.LayerNorm.weight"], p["embeddings.LayerNorm.bias"],
                   cfg.layer_norm_eps)
    mask_bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).to(F32)
    H = cfg.num_attention_heads
    D = cfg.hidden_size
    Dh = D // H

    def heads(y):
        return y.reshape(B, T, H, Dh).transpose(1, 2)

    for i in range(cfg.num_hidden_layers - 2):
        pfx = f"encoder.layer.{i}."
        res = h
        q = heads(lin(pfx + "attention.self.query", h))
        k = heads(lin(pfx + "attention.self.key", h))
        v = heads(lin(pfx + "attention.self.value", h))
        scores = torch.matmul(q.float(), k.float().transpose(2, 3)) / math.sqrt(Dh)
        probs = torch.softmax(scores + mask_bias, dim=-1).to(h.dtype)
        attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, T, D)
        attn = lin(pfx + "attention.output.dense", attn)
        h = layer_norm(res + attn, p[pfx + "attention.output.LayerNorm.weight"],
                       p[pfx + "attention.output.LayerNorm.bias"], cfg.layer_norm_eps)
        res = h
        m = lin(pfx + "intermediate.dense", h)
        m = F.gelu(m.float()).to(h.dtype)
        m = lin(pfx + "output.dense", m)
        h = layer_norm(res + m, p[pfx + "output.LayerNorm.weight"],
                       p[pfx + "output.LayerNorm.bias"], cfg.layer_norm_eps)
    return h


def bert_hidden_minus3(p: Dict[str, torch.Tensor], cfg: BertConfig, input_ids: torch.Tensor,
                       attention_mask: torch.Tensor) -> torch.Tensor:
    """ids and mask [B, T] → ``hidden_states[-3]`` [B, T, hidden] in the
    parameters' dtype."""
    def lin(name, x):
        return linear(x, p[name + ".weight"], p[name + ".bias"])

    return _encoder(p, cfg, input_ids, attention_mask, lin)


def bert_hidden_minus3_q8(p: Dict[str, torch.Tensor], cfg: BertConfig, input_ids: torch.Tensor,
                          attention_mask: torch.Tensor) -> torch.Tensor:
    """:func:`bert_hidden_minus3` over :func:`quantize_bert_params`'s output."""
    def lin(name, x):
        return _q8_linear(x, p[name + ".weight::q8"], p[name + ".weight::scale"],
                          p[name + ".bias"])

    return _encoder(p, cfg, input_ids, attention_mask, lin)


def init_params(cfg: BertConfig, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random float32 CPU weights in the Hugging Face key layout (without the
    ``bert.`` prefix): N(0, 0.02) matrices and embeddings, zero biases, unit
    LayerNorm gains — every layer, as a published checkpoint holds them."""
    D, I = cfg.hidden_size, cfg.intermediate_size

    def nrm(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    p = {"embeddings.word_embeddings.weight": nrm(cfg.vocab_size, D),
         "embeddings.position_embeddings.weight": nrm(cfg.max_position_embeddings, D),
         "embeddings.token_type_embeddings.weight": nrm(cfg.type_vocab_size, D),
         "embeddings.LayerNorm.weight": torch.ones(D),
         "embeddings.LayerNorm.bias": torch.zeros(D)}
    for i in range(cfg.num_hidden_layers):
        pfx = f"encoder.layer.{i}."
        for name, n_out, n_in in (("attention.self.query", D, D), ("attention.self.key", D, D),
                                  ("attention.self.value", D, D),
                                  ("attention.output.dense", D, D),
                                  ("intermediate.dense", I, D), ("output.dense", D, I)):
            p[pfx + name + ".weight"] = nrm(n_out, n_in)
            p[pfx + name + ".bias"] = torch.zeros(n_out)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            p[pfx + name + ".weight"] = torch.ones(D)
            p[pfx + name + ".bias"] = torch.zeros(D)
    return p


# ---------------------------------------------------------------------------
# Minimal BERT tokenizer (BasicTokenizer + WordPiece over vocab.txt)
# ---------------------------------------------------------------------------

def _is_cjk(cp: int) -> bool:
    # BERT's _is_chinese_char ranges, in full: a narrower set mis-merges
    # rare-plane CJK into a neighbouring word buffer, and the resulting
    # token count no longer matches word2ph (np.repeat length crash)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


class BertTokenizer:
    def __init__(self, vocab_path: str, do_lower_case: bool = True):
        self.vocab: Dict[str, int] = {}
        with open(vocab_path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i
        self.do_lower_case = do_lower_case
        self.unk = "[UNK]"

    def _basic(self, text: str) -> List[str]:
        if self.do_lower_case:
            # HF BasicTokenizer(do_lower_case=True, strip_accents=None)
            # lowercases AND strips accents (NFD normalize + drop Mn marks)
            text = unicodedata.normalize("NFD", text.lower())
        out: List[str] = []
        buf = ""
        for ch in text:
            cp = ord(ch)
            cat = unicodedata.category(ch)
            if (cp == 0 or cp == 0xFFFD
                    or (cat.startswith("C") and ch not in "\t\n\r")):
                # BERT _clean_text + _is_control: every category-C char
                # (control/format/unassigned) is dropped, not tokenized
                continue
            if self.do_lower_case and cat == "Mn":
                continue
            if _is_cjk(cp) or cat.startswith("P") or ch in "~`!@#$%^&*()+=|\\/?<>,.:;\"'“”‘’！？。，、：；（）【】《》…~·":
                if buf:
                    out.append(buf)
                    buf = ""
                if not ch.isspace():
                    out.append(ch)
            elif ch.isspace():
                if buf:
                    out.append(buf)
                    buf = ""
            else:
                buf += ch
        if buf:
            out.append(buf)
        return out

    def _wordpiece(self, token: str) -> List[str]:
        if token in self.vocab:
            return [token]
        pieces: List[str] = []
        start = 0
        while start < len(token):
            end = len(token)
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        return [p for t in self._basic(text) for p in self._wordpiece(t)]

    def encode(self, text: str, max_length: int = 512) -> List[int]:
        toks = ["[CLS]"] + self.tokenize(text)[: max_length - 2] + ["[SEP]"]
        return [self.vocab.get(t, self.vocab[self.unk]) for t in toks]


class CNRoberta:
    """The featurizer the frontend calls (``Config.cnroberta``): a list of
    ``word2ph`` dicts → per-item phone-level features ``[n_phones, hidden]``
    (numpy float32).  Reads ``config.json``, ``vocab.txt`` and
    ``model.safetensors`` (or ``pytorch_model.bin``; the ``bert.`` prefix
    stripped) from ``base_path``; a missing file raises ``FileNotFoundError``.  ``quant=None`` takes ``tts_config.quant_bert``;
    ``tts_config.featurizer_buckets`` pads the token batch to multiples of
    ``COL_BUCKET`` columns (never past the position table) and a power-of-two
    number of rows.  The weights live on ``tts_config.device`` in its dtype
    (the int8 path: float32 and int8)."""

    COL_BUCKET = 32

    def __init__(self, base_path, tts_config, quant: bool = None):
        base_path = str(base_path)
        self.cfg = BertConfig.from_json(os.path.join(base_path, "config.json"))
        self.device = tts_config.device
        self.dtype = tts_config.dtype
        self.quant = bool(getattr(tts_config, "quant_bert", False)) if quant is None else quant
        self.tokenizer = BertTokenizer(os.path.join(base_path, "vocab.txt"))
        st_path = os.path.join(base_path, "model.safetensors")
        bin_path = os.path.join(base_path, "pytorch_model.bin")
        if os.path.exists(st_path):
            sd = load_file(st_path)
        elif os.path.exists(bin_path):
            sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        else:
            raise FileNotFoundError(f"BERT weights not found: {st_path} (or {bin_path})")
        sd = {k.removeprefix("bert."): v for k, v in sd.items()}
        sd = {k: v for k, v in sd.items() if k.startswith(("embeddings.", "encoder."))}
        if self.quant:
            params = quantize_bert_params(sd, self.cfg)
            self.params = {k: v.to(self.device) for k, v in params.items()}
            self._fwd = bert_hidden_minus3_q8
        else:
            self.params = {k: v.to(self.device, self.dtype) for k, v in sd.items()}
            self._fwd = bert_hidden_minus3
        self.buckets = bool(getattr(tts_config, "featurizer_buckets", False))

    @staticmethod
    def _row_bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def batch(self, texts: List[str]):
        """Token ids and attention mask [rows, cols] (int32 numpy) of
        ``texts``, padded as the options say."""
        encoded = [self.tokenizer.encode(t) for t in texts]
        maxlen = max(len(e) for e in encoded)
        n_rows = len(texts)
        if self.buckets:
            # the -1e9 bias makes a padded key's probability exactly 0, and
            # rows are independent: the valid rows match the exact shapes
            padded = -(-maxlen // self.COL_BUCKET) * self.COL_BUCKET
            # a text that fits the position table still fits bucketed
            maxlen = max(maxlen, min(padded, self.cfg.max_position_embeddings))
            n_rows = self._row_bucket(n_rows)
        ids = np.zeros((n_rows, maxlen), np.int32)
        mask = np.zeros((n_rows, maxlen), np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask

    @torch.no_grad()
    def __call__(self, word2ph_list: List[Dict[str, list]]) -> List[np.ndarray]:
        ids, mask = self.batch(["".join(w["word"]) for w in word2ph_list])
        hidden = self._fwd(self.params, self.cfg, torch.as_tensor(ids, device=self.device),
                           torch.as_tensor(mask, device=self.device))
        hidden = hidden.float().cpu().numpy()
        out: List[np.ndarray] = []
        for i, w2p in enumerate(word2ph_list):
            char_feats = hidden[i][mask[i] == 1][1:-1]  # strip [CLS]/[SEP]
            out.append(np.repeat(char_feats, np.asarray(w2p["ph"], np.int64), axis=0))
        return out
