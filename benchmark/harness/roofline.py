"""The least time the card could take for the t2s decoder's work: the
operation and byte counts of one decode step (``chip_smoke.py``'s
``weight_bytes``, ``step_bound``, ``attn_bound`` and ``layers_bound``,
copied here so that a change to the program cannot move the yardstick), at
the published peaks of one H100 SXM (NVIDIA's data sheet, dense rates)."""
from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


class Dims:
    """The t2s widths a configuration file states."""

    def __init__(self, t2s: dict):
        self.num_layers = t2s["n_layer"]
        self.hidden_dim = t2s["hidden_dim"]
        self.mlp_ratio = t2s["ffn_dim"] // t2s["hidden_dim"]
        self.vocab_size = t2s["vocab_size"]
        self.num_heads = t2s["head"]


def weight_bytes(cfg) -> int:
    """bf16 matrix bytes every whole decode step reads once, whatever B is."""
    L, D, M, V = cfg.num_layers, cfg.hidden_dim, cfg.hidden_dim * cfg.mlp_ratio, cfg.vocab_size
    return 2 * (L * (4 * D * D + 2 * D * M) + V * D)


def bound_parts(n_bytes: float, n_flops: float, peak: float = BF16_FLOPS):
    """(seconds, "bytes" or "operations"): the larger of the two times."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / peak
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def step_counts(cfg, S: int, kv_lens: Sequence[int]):
    """(bytes, operations) of one whole bf16 decode step (K1, K2) for live
    rows at ``kv_lens``: every weight read once whatever B is; per row its
    embedding and position rows, the attended cache rows (K and V, bf16) and
    the appended row, the noise and the filtered row, its ``tok_buf`` row
    and counters."""
    L, D, M, V = cfg.num_layers, cfg.hidden_dim, cfg.hidden_dim * cfg.mlp_ratio, cfg.vocab_size
    B = len(kv_lens)
    n_layer, n_head = L * (4 * D * D + 2 * D * M), V * D
    w_bytes = 2 * n_layer + 2 * n_head
    small = L * (2 * (3 * D + D + M + D) + 4 * 4 * D)
    per_slot = sum(2 * D + 4 * D + 4 * L * kv * D + 4 * L * D + 8 * V + 4 * S + 24
                   for kv in kv_lens)
    flops = 2 * B * (n_layer + n_head) + sum(4 * L * (kv + 1) * D for kv in kv_lens)
    return w_bytes + small + per_slot, flops


def step_bound(cfg, S: int, kv_lens: Sequence[int]):
    """Least seconds of one whole decode step, and what bounds it."""
    return bound_parts(*step_counts(cfg, S, kv_lens))


def attn_bound(H: int, Dh: int, kv_lens: Sequence[int], q_bytes: int):
    """One decode attention call (K3): K and V rows 0..kv_len[b] (bf16), the
    query in, the output out, the lengths."""
    D = H * Dh
    n = sum(kv + 1 for kv in kv_lens)
    return bound_parts(4 * n * D + len(kv_lens) * (2 * q_bytes * D + 4), 4 * n * D)


def layers_bound(cfg, n_layers: int, kv_lens: Sequence[int], x_bytes: int):
    """``n_layers`` layers for rows at ``kv_lens`` (K5, K6)."""
    D, M = cfg.hidden_dim, cfg.hidden_dim * cfg.mlp_ratio
    n_w = n_layers * (4 * D * D + 2 * D * M)
    small = n_layers * (2 * (3 * D + D + M + D) + 4 * 4 * D)
    per_row = sum(2 * x_bytes * D + n_layers * (4 * kv * D + 4 * D) + 4 for kv in kv_lens)
    flops = 2 * len(kv_lens) * n_w + sum(4 * n_layers * (kv + 1) * D for kv in kv_lens)
    return bound_parts(2 * n_w + small + per_row, flops)


def single_row_steps(cfg, S: int, prompt_len: int, n_steps: int):
    """Summed (bytes, operations) of the ``n_steps`` B=1 decode steps of one
    request whose prompt fills ``prompt_len`` cache rows: step i attends
    ``prompt_len + i`` rows."""
    tb = tf = 0
    for i in range(n_steps):
        b, f = step_counts(cfg, S, [prompt_len + i])
        tb += b
        tf += f
    return tb, tf


def decode_seconds(ctx, requests) -> float:
    """Least seconds of the B=1 decode steps ``requests`` took: each
    request's ``decode_steps`` steps from its prompt's ``prompt_len`` cache
    rows on, each step bounded on its own, the cache at the smallest B=1
    bucket that holds the request."""
    buckets = sorted(s for b, s in ctx.gpt_cache if b == 1)
    total = 0.0
    for r in requests:
        n, p = r.get("decode_steps"), r.get("prompt_len")
        if not n or p is None:
            continue
        S = next((s for s in buckets if s >= p + n + 1), buckets[-1])
        total += sum(step_bound(ctx.dims, S, [p + i])[0] for i in range(n))
    return total

