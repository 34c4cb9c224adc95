"""Plain float32 forward pass of the GPT-SoVITS t2s decoder (``AR/models/
t2s_model.py`` of github.com/RVC-Boss/GPT-SoVITS), for judging what the
program served.

One full causal pass over ``[phonemes | prompt codes + served codes]``: the
phoneme block attends itself, the code block attends the phonemes and the
codes up to itself; 24 post-norm blocks (attention, ReLU MLP, each followed
by LayerNorm); the head reads the hidden state of every code position.  No
cache, no batching, no kernel.  Weights come from the checkpoint files the
benchmark wrote, as the program reads them.

This module imports nothing of the program.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

LAYER_KEYS = ("qkv.weight", "qkv.bias", "out_proj.weight", "out_proj.bias", "norm1.weight",
              "norm1.bias", "mlp.0.weight", "mlp.0.bias", "mlp.2.weight", "mlp.2.bias",
              "norm2.weight", "norm2.bias")


def sine_table(n: int, dim: int) -> torch.Tensor:
    """The sinusoidal position table of ``embedding.py`` (float32)."""
    position = np.arange(n, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * -(math.log(10000.0) / dim))
    pe = np.zeros((n, dim), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return torch.from_numpy(pe)


class T2SReference:
    """The decoder in float32 on ``device``.  ``weight_fn`` maps each matrix
    before use (the control puts a lower precision there)."""

    def __init__(self, sd: Dict[str, torch.Tensor], config: dict, device, weight_fn=None):
        m = config["model"]
        self.D, self.H, self.L = m["hidden_dim"], m["head"], m["n_layer"]
        self.V, self.eos = m["vocab_size"], m["EOS"]
        wf = weight_fn or (lambda t: t)

        def get(k, mat=False):
            t = sd[k].to(device=device, dtype=torch.float32)
            return wf(t) if mat else t

        self.text_emb = get("ar_text_embedding.word_embeddings.weight")
        self.audio_emb = get("ar_audio_embedding.word_embeddings.weight")
        self.bert_w = get("bert_proj.weight", True)
        self.bert_b = get("bert_proj.bias")
        self.text_alpha = get("ar_text_position.alpha").reshape(())
        self.audio_alpha = get("ar_audio_position.alpha").reshape(())
        self.head = get("ar_predict_layer.weight", True)
        self.layers = [{k: get(f"t2s_transformer.blocks.{i}.{k}", k.endswith("weight")
                               and not k.startswith("norm"))
                        for k in LAYER_KEYS} for i in range(self.L)]
        self.pe = sine_table(4000, self.D).to(device)
        self.device = device

    @torch.no_grad()
    def logits(self, x_ids, y_ids, bert, n_out: Optional[int] = None) -> torch.Tensor:
        """Logits [n_out, V] predicting the code after each of the last
        ``n_out`` positions of ``y_ids`` (the prompt codes, then the fed
        codes).  float32 throughout."""
        n_out = len(y_ids) if n_out is None else n_out
        return F.linear(self.hidden(x_ids, y_ids, bert)[-n_out:], self.head)

    @torch.no_grad()
    def hidden(self, x_ids, y_ids, bert) -> torch.Tensor:
        """The last block's output [Lx + Ly, D] at every position."""
        dev = self.device
        x_ids = torch.as_tensor(np.asarray(x_ids, np.int64), device=dev)
        y_ids = torch.as_tensor(np.asarray(y_ids, np.int64), device=dev)
        bert = torch.as_tensor(np.asarray(bert, np.float32), device=dev)
        Lx, Ly = len(x_ids), len(y_ids)
        x = self.text_emb[x_ids] + F.linear(bert, self.bert_w, self.bert_b)
        x = x + self.text_alpha * self.pe[:Lx]
        y = self.audio_emb[y_ids] + self.audio_alpha * self.pe[:Ly]
        h = torch.cat([x, y])[None]
        T = Lx + Ly
        rows = torch.arange(T, device=dev)[:, None]
        cols = torch.arange(T, device=dev)[None, :]
        allowed = torch.where(rows < Lx, cols < Lx, (cols < Lx) | (cols <= rows))
        Dh = self.D // self.H
        for lp in self.layers:
            q, k, v = F.linear(h, lp["qkv.weight"], lp["qkv.bias"]).split(self.D, dim=-1)
            q, k, v = (t.reshape(1, T, self.H, Dh).transpose(1, 2) for t in (q, k, v))
            s = (q @ k.transpose(-1, -2)) / math.sqrt(Dh)
            s = s.masked_fill(~allowed, float("-inf"))
            a = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(1, T, self.D)
            h = F.layer_norm(h + F.linear(a, lp["out_proj.weight"], lp["out_proj.bias"]),
                             (self.D,), lp["norm1.weight"], lp["norm1.bias"], 1e-5)
            m = F.linear(F.relu(F.linear(h, lp["mlp.0.weight"], lp["mlp.0.bias"])),
                         lp["mlp.2.weight"], lp["mlp.2.bias"])
            h = F.layer_norm(h + m, (self.D,), lp["norm2.weight"], lp["norm2.bias"], 1e-5)
        return h[0]


def penalized(logits: torch.Tensor, seen: torch.Tensor, penalty: float) -> torch.Tensor:
    """The repetition penalty of ``AR/models/utils.py``: a seen code's logit
    divided by ``penalty`` where positive, multiplied where negative."""
    if penalty == 1.0:
        return logits
    pen = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, pen, logits)


def masks_for(logits: torch.Tensor, prompt_codes, fed, penalty: float, suppress_until: int,
              suppressed, eos: int, first_eos_masked: bool = True) -> torch.Tensor:
    """What greedy decoding compares at each position: the logits [n, V]
    predicting fed[0..n-1] (row 0 predicts the prefill's code), with the
    repetition penalty over the prompt codes and the codes fed so far, the
    early steps' suppressed codes and EOS barred, and EOS barred at the
    prefill.  Rows of ``-inf`` mark barred codes."""
    n, V = logits.shape
    out = logits.clone()
    seen = torch.zeros(V, dtype=torch.bool, device=logits.device)
    prompt = torch.as_tensor(np.asarray(prompt_codes, np.int64), device=logits.device)
    seen[prompt[(prompt >= 0) & (prompt < V)]] = True
    fed = np.asarray(fed, np.int64)
    for i in range(n):
        if penalty != 1.0:
            out[i] = penalized(out[i], seen, penalty)
        if i < suppress_until:
            out[i, list(suppressed)] = float("-inf")
            out[i, eos] = float("-inf")
        if i == 0 and first_eos_masked:
            out[i, eos] = float("-inf")
        if i < len(fed) and 0 <= fed[i] < V:
            seen[int(fed[i])] = True
    return out
