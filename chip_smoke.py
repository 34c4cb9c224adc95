#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gsv_tts_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py             # the smoke
    python3 chip_smoke.py --profile   # the smoke's set-up, then a torch.profiler
                                      # breakdown of one K1 and one K2 step

Phases, each fatal on failure (non-zero exit, no result line):

1. card: ``nvidia-smi`` name and power limit;
2. build: one ``nvcc`` per library, all started together, from
   ``gsv_tts_tpu_torch/csrc`` (K1, K2, K3);
3. kernels, each against its plain PyTorch twin at the flagship t2s widths
   (L=24, D=512, H=16, M=2048, V=1025) in bf16:
   * K1 (whole B=1 decode step) and K2 (whole step for a wave of B slots,
     B = 2, 4 and ``MAX_FUSED_B``): caches of 512 and 1024 rows, ragged
     ``kv_len`` (a frozen slot, the first row past the 512 -> 1024
     escalation, the last row of the cache), repetition penalty on and off;
     final hidden state, logits, appended K/V rows and filtered rows within
     stated tolerances, tokens equal wherever the top-2 margin of
     ``row + gumbel`` clears the tolerance, every other cache row untouched;
   * K3a / K3b (decode attention, one layer's cache / a layer of the stacked
     cache): B = 1, 4 and 12, lengths 0, 63, 64, S-1 and more, every layer
     index, cache rows past ``kv_len`` poisoned;
   CUDA-event times of kernel and twin (and, for K3, of one
   ``scaled_dot_product_attention`` call as a yardstick), beside the least
   time the card could take for the bytes the call must move;
4. main path: full-width random s1v3 t2s / v2 SoVITS / HuBERT-base
   checkpoints and synthetic wavs made from a seed in a temporary models
   directory, loaded through ``TTS.load_gpt_model`` / ``load_sovits_model``;
   two English ``TTS.infer`` requests (K1), one ``TTS.infer_batched`` of six
   texts on a four-slot wave (K2, with slot refills and tail compaction) and
   one of twelve texts (a wave above K2's limit: the generic step with K3b).
   The audio must be finite and of plausible length and each kernel's
   launch count must equal the decode steps its path took.

The last line is ``{"ok": true, "device": {...}}``; before it come the
kernels' JSON record and the card.  Nothing here imports JAX.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.modules["jax"] = None  # any JAX import in the port fails loudly
HERE = Path(__file__).resolve().parent
SEED = 1234

# bf16 tolerances of the whole-step kernels (K1, K2) against their twin.
# Both round activations to bf16 at the same points and accumulate in
# float32, in different orders: they agree to ~1e-7 until a reduction-order
# difference flips one bf16 rounding (2^-9 relative), which 24 post-norm
# layers then carry forward.  On an NVIDIA H100 80GB HBM3 at 700 W such a
# flip left the two 1.1% apart (relative L2) while each sat 0.9% from a
# float32 evaluation of the same step.  So hidden states and logits (both
# O(1) here) are held to an absolute 0.1 per element and 2% relative L2,
# and the kernel may sit no further from float32 than 1.5x its twin (+1e-3).
TOL_ABS = 0.1
TOL_REL = 2e-2
# K3 against its twin: the outputs are O(1) averages of bf16 cache rows.  In
# bf16 the twin rounds the probabilities and both round the output (2^-9
# relative each); with float32 queries only the summation order differs.
K3_TOL = {"bfloat16": 2e-2, "float32": 1e-4}

# the card's published peaks (NVIDIA H100 SXM data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_turns(run_kernel, run_plain, k_iters: int, p_iters: int):
    """plain, kernel, kernel, plain: the card's clocks drift, so each time is
    the mean of its two turns.  Returns (kernel ms, plain ms)."""
    p1 = cuda_ms(run_plain, p_iters)
    k1 = cuda_ms(run_kernel, k_iters)
    k2 = cuda_ms(run_kernel, k_iters)
    p2 = cuda_ms(run_plain, p_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(n_bytes: float, n_flops: float):
    """Least time (ms) the card could take: the larger of the bytes over the
    memory rate and the operations over the bf16 peak, and which it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / BF16_FLOPS
    return 1000 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def step_bound(cfg, S, kv_lens):
    """Bound of one whole decode step (K1, K2) for slots at ``kv_lens``:
    every weight read once whatever B is; per slot its embedding and
    positional rows, the attended cache rows (K and V, bf16) and the appended
    row, the noise and the filtered row, its ``tok_buf`` row and counters."""
    L, D, M, V = cfg.num_layers, cfg.hidden_dim, cfg.hidden_dim * cfg.mlp_ratio, cfg.vocab_size
    B = len(kv_lens)
    n_w = L * (4 * D * D + 2 * D * M) + V * D  # matrix entries, bf16
    small = L * (2 * (3 * D + D + M + D) + 4 * 4 * D)  # biases bf16, LayerNorm affines f32
    per_slot = sum(2 * D + 4 * D + 4 * L * kv * D + 4 * L * D + 8 * V + 4 * S + 24
                   for kv in kv_lens)
    flops = 2 * B * n_w + sum(4 * L * (kv + 1) * D for kv in kv_lens)
    return bound(2 * n_w + small + per_slot, flops)


def attn_bound(H, Dh, kv_lens, q_bytes):
    """Bound of one decode attention call (K3): K and V rows 0..kv_len[b]
    (bf16), the query in, the output out, the lengths."""
    D = H * Dh
    n = sum(kv + 1 for kv in kv_lens)
    return bound(4 * n * D + len(kv_lens) * (2 * q_bytes * D + 4), 4 * n * D)


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-12))


def check_close(name, got, twin, exact, where) -> float:
    """Kernel vs twin within TOL_ABS / TOL_REL, and the kernel no further
    from float32 arithmetic than 1.5x the twin is; returns the max abs error."""
    err = float((got - twin).abs().max())
    rel, noise, own = rel_err(got, twin), rel_err(twin, exact), rel_err(got, exact)
    if err > TOL_ABS or rel > TOL_REL or own > 1.5 * noise + 1e-3:
        fail(f"{name} differs: max abs {err:.4g}, rel {rel:.3g}; from float32: kernel "
             f"{own:.3g}, twin {noise:.3g} at {where}")
    return err


# ---------------------------------------------------------------------------
# K1 and K2: the whole decode step
# ---------------------------------------------------------------------------

class StepBench:
    """Flagship-width parameters and the comparison of one whole-step kernel
    call (K1 at B=1 with host-int counters, K2 with [B] device counters)
    with the twin."""

    def __init__(self, dev):
        import torch

        from gsv_tts_tpu_torch.models import t2s
        from gsv_tts_tpu_torch.ops import fused_step

        self.dev = dev
        self.cfg = cfg = t2s.T2SConfig()
        gen = torch.Generator().manual_seed(SEED)
        self.params = t2s.init_params(cfg, gen, dtype=torch.bfloat16, device=dev)
        self.params32 = dict(
            self.params, layers=[{k: v.float() for k, v in lp.items()}
                                 for lp in self.params["layers"]],
            **{k: self.params[k].float() for k in ("audio_emb", "predict_w")})
        self.table = self.params["k1_table"] = fused_step.K1Table(self.params)
        self.sup = cfg.suppressed_tokens + (cfg.eos,)
        self.dgen = torch.Generator(device=dev).manual_seed(SEED)

    def state(self, S, kv_lens, x_lens, lasts, step_idx):
        """Random caches and token histories for slots at ``kv_lens``."""
        import torch

        cfg, dev, g = self.cfg, self.dev, self.dgen
        B, V = len(kv_lens), cfg.vocab_size
        shape = (cfg.num_layers, B, S, cfg.num_heads, cfg.head_dim)
        kc = (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
        vc = (torch.randn(shape, generator=g, device=dev) * 0.5).to(torch.bfloat16)
        buf_lens = [max(kv - x + 1, 0) for kv, x in zip(kv_lens, x_lens)]
        tok_buf = torch.full((B, S), V, dtype=torch.int32, device=dev)
        for b, n in enumerate(buf_lens):
            tok_buf[b, :n] = torch.randint(0, V, (n,), generator=g, device=dev,
                                           dtype=torch.int32)

        def i32(v):
            return torch.tensor(v, dtype=torch.int32, device=dev)

        return dict(kc=kc, vc=vc, tok_buf=tok_buf, kv=i32(kv_lens), x=i32(x_lens),
                    last=i32(lasts), buf=i32(buf_lens), step=i32(step_idx),
                    kv_lens=list(kv_lens), x_lens=list(x_lens), buf_lens=buf_lens,
                    steps=list(step_idx))

    def kernel(self, st, kc, vc, tok_buf, g, sa, su, **out):
        """K1 for one slot (its counters as host ints), K2 for a wave."""
        from gsv_tts_tpu_torch.ops import fused_step

        kw = dict(sa=sa, suppress_until=su, suppressed=self.sup, **out)
        if len(st["kv_lens"]) == 1:
            return fused_step.fused_decode_step_sample(
                self.params, kc, vc, tok_buf, st["kv_lens"][0], st["x_lens"][0], st["last"],
                st["buf_lens"][0], st["steps"][0], g, **kw)
        return fused_step.fused_decode_step_sample_batched(
            self.params, kc, vc, tok_buf, st["kv"], st["x"], st["last"], st["buf"], st["step"],
            g, **kw)

    def twin(self, st, kc, vc, tok_buf, g, sa, su, **out):
        from gsv_tts_tpu_torch.ops import fused_step

        return fused_step.fused_decode_step_sample_batched_ref(
            self.params, kc, vc, tok_buf, st["kv"], st["x"], st["last"], st["buf"], st["step"],
            g, sa=sa, suppress_until=su, suppressed=self.sup, **out)

    def compare(self, st, sa, su, is_plain, where) -> float:
        """One step through the kernel and through the twin from the same
        state; fails on any disagreement, returns the max abs error."""
        import torch

        from gsv_tts_tpu_torch.ops import fused_step
        from gsv_tts_tpu_torch.ops.sampling import gumbel_noise

        B, V, D = len(st["kv_lens"]), self.cfg.vocab_size, self.cfg.hidden_dim
        g = gumbel_noise((B, V), self.dgen, self.dev)
        kk, kv, kt = st["kc"].clone(), st["vc"].clone(), st["tok_buf"].clone()
        tok, row, _, _ = self.kernel(st, kk, kv, kt, g, sa, su)
        hid = self.table.x[:B * D].clone().reshape(B, D)
        rk, rv, rt = st["kc"].clone(), st["vc"].clone(), st["tok_buf"].clone()
        ref_h, ref_logits = fused_step.decode_hidden_ref(
            self.params, rk.clone(), rv.clone(), st["kv"], st["x"], st["last"])
        f32_h, f32_logits = fused_step.decode_hidden_ref(
            self.params32, st["kc"].float(), st["vc"].float(), st["kv"], st["x"], st["last"])
        rtok, rrow, _, _ = self.twin(st, rk, rv, rt, g, sa, su)
        torch.cuda.synchronize()
        self.table.check()
        worst = check_close("hidden", hid, ref_h, f32_h, where)
        if is_plain:  # no filter: the row is the logits
            worst = max(worst, check_close("logits", row, ref_logits, f32_logits, where))
        for b in range(B):
            at = f"{where} slot {b}"
            # rows: -1e30 (removed) must agree where the twin's value is
            # clear of the filter's cut; kept values within the tolerance
            keep_k, keep_r = row[b] > -1e29, rrow[b] > -1e29
            both = keep_k & keep_r
            err_r = float((row[b][both] - rrow[b][both]).abs().max()) if both.any() else 0.0
            worst = max(worst, err_r)
            if err_r > TOL_ABS * (1 / sa.temperature):
                fail(f"filtered row values differ by {err_r:.4g} at {at}")
            diff = keep_k ^ keep_r
            if diff.any():
                # a membership flip is allowed only for a value within the
                # tolerance of the surviving row's cut
                edge = torch.where(keep_r, rrow[b], row[b])[diff]
                cut = torch.where(keep_r, rrow[b], torch.full_like(rrow[b], math.inf)).min()
                if float((edge - cut).abs().max()) > 2 * TOL_ABS:
                    fail(f"filter membership differs away from the cut at {at}")
            tot = torch.where(keep_r, rrow[b], torch.full_like(rrow[b], -math.inf)) + g[b]
            top2 = torch.topk(tot, 2).values
            # (where the filters kept different sets, vetted above as a flip at
            # the cut, the two draw from different candidates)
            if (not diff.any() and float(top2[0] - top2[1]) > 2 * TOL_ABS
                    and int(tok[b]) != int(rtok[b])):
                fail(f"token {int(tok[b])} != twin {int(rtok[b])} with margin "
                     f"{float(top2[0] - top2[1]):.3g} at {at}")
            n = st["kv_lens"][b]
            for name, a, r, orig in (("K", kk, rk, st["kc"]), ("V", kv, rv, st["vc"])):
                e = float((a[:, b, n].float() - r[:, b, n].float()).abs().max())
                worst = max(worst, e)
                if e > TOL_ABS:
                    fail(f"appended {name} rows differ by {e:.4g} at {at}")
                if not (torch.equal(a[:, b, :n], orig[:, b, :n])
                        and torch.equal(a[:, b, n + 1:], orig[:, b, n + 1:])):
                    fail(f"{name} cache rows other than kv_len were modified at {at}")
            if int(kt[b, st["buf_lens"][b]]) != int(tok[b]):
                fail(f"token not appended to tok_buf at {at}")
        return worst

    def times(self, st, sa, su, k_iters=100, p_iters=10):
        import torch

        from gsv_tts_tpu_torch.ops.sampling import gumbel_noise

        B, V = len(st["kv_lens"]), self.cfg.vocab_size
        g = gumbel_noise((B, V), self.dgen, self.dev)
        kk, kv, kt = st["kc"].clone(), st["vc"].clone(), st["tok_buf"].clone()
        out = dict(tok_out=torch.empty(B, dtype=torch.int32, device=self.dev),
                   row_out=torch.empty((B, V), dtype=torch.float32, device=self.dev))
        return timed_turns(lambda: self.kernel(st, kk, kv, kt, g, sa, su, **out),
                           lambda: self.twin(st, kk, kv, kt, g, sa, su, **out),
                           k_iters, p_iters)


def sampling_settings():
    """(SampleArgs, suppress_until, is the row the plain logits)."""
    from gsv_tts_tpu_torch.runtime.t2s_session import SampleArgs

    V = 1025
    return [(SampleArgs(top_k=V, top_p=1.0, temperature=1.0, repetition_penalty=1.0), 0, True),
            (SampleArgs(), 10, False),  # single-utterance defaults: penalty and suppression
            (SampleArgs(top_k=5, top_p=0.8, temperature=0.8, repetition_penalty=1.2), 0, False),
            (SampleArgs(use_prev=False), 0, False)]  # the batched mode's settings


def k1_phase(bench: StepBench):
    """K1 vs its twin; returns (max abs err, {S: (kernel ms, twin ms, bound)})."""
    worst, times, steps = 0.0, {}, 0
    V = bench.cfg.vocab_size
    for S, kv_len, x_len in [(512, 1, 0), (512, 300, 60), (512, 511, 60),
                             (1024, 512, 60), (1024, 777, 60), (1024, 1023, 60)]:
        for last in (17, V - 1):
            st = bench.state(S, [kv_len], [x_len], [last], [5])
            for sa, su, is_plain in sampling_settings()[:3]:
                where = f"K1 S={S} kv_len={kv_len} last_tok={last} sa={sa} suppress_until={su}"
                worst = max(worst, bench.compare(st, sa, su, is_plain, where))
                steps += 1
        if kv_len in (300, 777):
            sa, su, _ = sampling_settings()[1]
            k_ms, p_ms = bench.times(st, sa, su)
            times[S] = (k_ms, p_ms) + step_bound(bench.cfg, S, [kv_len])
            print(f"K1 time S={S} kv_len={kv_len}: kernel {k_ms:.4f} ms/step, plain twin "
                  f"{p_ms:.4f} ms/step, bound {times[S][2]:.4f} ms ({times[S][3]})", flush=True)
    print(f"K1 matches its twin on {steps} flagship steps; max abs err {worst:.4g} "
          f"(tolerance {TOL_ABS})", flush=True)
    return worst, times


def k2_phase(bench: StepBench):
    """K2 vs its twin at B = 2, 4 and MAX_FUSED_B; same returns as K1's."""
    from gsv_tts_tpu_torch.ops.fused_step import MAX_FUSED_B

    worst, times, steps = 0.0, {}, 0
    V = bench.cfg.vocab_size
    for S in (512, 1024):
        half = S // 2  # at S=1024: the first row past the 512 -> 1024 escalation
        waves = {2: [0, S - 1], 4: [0, 300, S - 1, half],
                 MAX_FUSED_B: [0, 1, 63, 64, 300, half, S - 200, S - 1]}
        for B, kv_lens in waves.items():
            # slot 0 is frozen (kv_len 0 below its x_len); slot b's step
            # index straddles the suppression window
            x_lens = [40] + [min(60, kv) for kv in kv_lens[1:]]
            lasts = [17] * (B - 1) + [V - 1]
            st = bench.state(S, kv_lens, x_lens, lasts, [5 + 7 * b for b in range(B)])
            for sa, su, is_plain in sampling_settings():
                where = f"K2 B={B} S={S} kv_len={kv_lens} sa={sa} suppress_until={su}"
                worst = max(worst, bench.compare(st, sa, su, is_plain, where))
                steps += 1
        kv_lens = [300, 287, 313, 296] if S == 512 else [777, 761, 790, 770]
        st = bench.state(S, kv_lens, [60] * 4, [17] * 4, [20] * 4)
        sa, su, _ = sampling_settings()[3]
        k_ms, p_ms = bench.times(st, sa, su)
        times[S] = (k_ms, p_ms) + step_bound(bench.cfg, S, kv_lens)
        print(f"K2 time B=4 S={S} kv_len={kv_lens}: kernel {k_ms:.4f} ms/step, plain twin "
              f"{p_ms:.4f} ms/step, bound {times[S][2]:.4f} ms ({times[S][3]})", flush=True)
    print(f"K2 matches its twin on {steps} flagship steps (B=2, 4, {MAX_FUSED_B}); max abs err "
          f"{worst:.4g} (tolerance {TOL_ABS})", flush=True)
    return worst, times


# ---------------------------------------------------------------------------
# K3a / K3b: decode attention
# ---------------------------------------------------------------------------

def k3_phase(dev, cfg):
    """K3a and K3b vs the twin at ``cfg``'s widths; returns {"k3a"/"k3b": (max abs err, kernel ms,
    twin ms, library ms, bound ms, bound by)}."""
    import torch
    import torch.nn.functional as F

    from gsv_tts_tpu_torch.ops import flash_decode as fd

    L, H, Dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {"k3a": 0.0, "k3b": 0.0}
    calls = 0

    def held(name, got, ref, dtype, where):
        err = float((got.float() - ref.float()).abs().max())
        tol = K3_TOL[dtype]
        if not bool(torch.isfinite(got.float()).all()) or err > tol:
            fail(f"{name} differs from its twin by {err:.4g} (tolerance {tol}) at {where}")
        worst[name] = max(worst[name], err)

    for S in (512, 1024):
        for B, lens in ((1, [S - 1]), (1, [0]), (4, [0, 63, 64, S - 1]),
                        (12, [0, 63, 64, S - 1, 1, 300, 127, 128, 129, 200, S // 2, 17])):
            kc = (torch.randn((L, B, S, H, Dh), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            vc = (torch.randn((L, B, S, H, Dh), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            for dtype in (torch.bfloat16, torch.float32) if B != 4 else (torch.bfloat16,):
                q = torch.randn((B, H, Dh), generator=gen, device=dev).to(dtype)
                name = str(dtype).split(".")[1]
                refs = [fd.decode_attention_ref(q, kc[i], vc[i], kv_len) for i in range(L)]
                # rows past kv_len[b] must never be read: poison them
                kp, vp = kc.clone(), vc.clone()
                for b, n in enumerate(lens):
                    kp[:, b, n + 1:] = float("nan")
                    vp[:, b, n + 1:] = float("nan")
                for layer in range(L):
                    out = fd.flash_decode_attention_layered(q, kp, vp, kv_len, layer)
                    held("k3b", out, refs[layer], name, f"B={B} S={S} {name} layer {layer}")
                    calls += 1
                for layer in (0, L - 1):
                    out = fd.flash_decode_attention(q, kp[layer], vp[layer], kv_len)
                    held("k3a", out, refs[layer], name, f"B={B} S={S} {name} layer {layer}")
                    calls += 1
                torch.cuda.synchronize()
                fd.check(dev)

    # times at the generic step's shapes: a 12-slot wave, ~300 rows attended
    B, S, layer = 12, 512, min(5, L - 1)
    lens = [300, 287, 313, 296, 305, 291, 320, 279, 301, 310, 284, 298]
    kc = (torch.randn((L, B, S, H, Dh), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    vc = (torch.randn((L, B, S, H, Dh), generator=gen, device=dev) * 0.5).to(torch.bfloat16)
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    mask = (torch.arange(S, device=dev)[None, :] <= kv_len[:, None])[:, None, None, :]
    k1, v1 = kc[layer], vc[layer]

    def library():  # one PyTorch call computing the same function; timed only
        return F.scaled_dot_product_attention(q[:, :, None, :], k1.permute(0, 2, 1, 3),
                                              v1.permute(0, 2, 1, 3), attn_mask=mask)

    lib = library()[:, :, 0]
    held("k3b", fd.flash_decode_attention_layered(q, kc, vc, kv_len, layer), lib, "bfloat16",
         "the library call")
    b_ms, b_by = attn_bound(H, Dh, lens, 2)
    out = {}
    for name, run in (("k3a", lambda: fd.flash_decode_attention(q, k1, v1, kv_len)),
                      ("k3b", lambda: fd.flash_decode_attention_layered(q, kc, vc, kv_len, layer))):
        k_ms, p_ms = timed_turns(run, lambda: fd.decode_attention_ref(q, k1, v1, kv_len), 200, 50)
        lib_ms = cuda_ms(library, 200)
        out[name] = (worst[name], k_ms, p_ms, lib_ms, b_ms, b_by)
        print(f"{name} time B={B} S={S} kv_len~300: kernel {k_ms:.4f} ms, plain twin {p_ms:.4f} "
              f"ms, scaled_dot_product_attention {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})",
              flush=True)
    print(f"K3a/K3b match the twin on {calls} calls (B=1, 4, 12; every layer; rows past kv_len "
          f"poisoned); max abs err K3a {worst['k3a']:.4g}, K3b {worst['k3b']:.4g}", flush=True)
    return out


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

def write_checkpoints(root: Path):
    """Full-width random s1v3 t2s, v2 SoVITS and HuBERT-base checkpoints
    plus speaker/prompt wavs, all from SEED."""
    import numpy as np
    import torch

    from gsv_tts_tpu_torch.hparams import HParams
    from gsv_tts_tpu_torch.loader import save_trained_gpt, save_trained_sovits
    from gsv_tts_tpu_torch.models import hubert, sovits, t2s
    from gsv_tts_tpu_torch.utils.audio_io import save_wav
    from gsv_tts_tpu_torch.utils.safetensors import save_file

    gen = torch.Generator().manual_seed(SEED)
    tcfg = t2s.T2SConfig()
    save_trained_gpt(t2s.init_params(tcfg, gen), tcfg, root / "s1v3")
    # the published v2 s2 config (GPT-SoVITS s2.json): 32 kHz, 2048-pt STFT
    hps = {"data": {"sampling_rate": 32000, "filter_length": 2048, "hop_length": 640,
                    "win_length": 2048, "n_mel_channels": 128},
           "model": {"inter_channels": 192, "hidden_channels": 192, "filter_channels": 768,
                     "n_heads": 2, "n_layers": 6, "kernel_size": 3, "p_dropout": 0.1,
                     "resblock": "1", "resblock_kernel_sizes": [3, 7, 11],
                     "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                     "upsample_rates": [10, 8, 2, 2, 2], "upsample_initial_channel": 512,
                     "upsample_kernel_sizes": [16, 16, 8, 2, 2], "gin_channels": 512,
                     "semantic_frame_rate": "25hz", "version": "v2"}}
    scfg = sovits.SovitsConfig.from_hps(hps["model"], 1025)
    sp = sovits.init_params(scfg, gen)
    sp["dec.conv_post.weight"] *= 10.0  # lift the random vocoder above the trim threshold
    save_trained_sovits(sp, HParams(hps), root / "s2v2")
    hcfg = hubert.HubertConfig()
    hdir = root / "chinese-hubert-base"
    hdir.mkdir()
    (hdir / "config.json").write_text(json.dumps(hcfg.to_dict()))
    save_file(hubert.init_params(hcfg, gen), hdir / "model.safetensors")
    rng = np.random.RandomState(SEED)
    for name, secs, freq in (("spk.wav", 3.0, 180.0), ("prompt.wav", 4.0, 240.0)):
        t = np.arange(int(32000 * secs)) / 32000
        wav = 0.3 * np.sin(2 * np.pi * freq * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
        save_wav(root / name, (wav + 0.02 * rng.randn(len(t))).astype(np.float32), 32000)
    return root / "s1v3", root / "s2v2", root / "spk.wav", root / "prompt.wav"


TEXTS = ["The quick brown fox jumps over the lazy dog.",
         "She sells sea shells by the sea shore, and the shells she sells are surely seashells.",
         "A journey of a thousand miles begins with a single step.",
         "To be or not to be, that is the question.",
         "All that glitters is not gold, and not all who wander are lost in the end.",
         "Early to bed and early to rise.",
         "The rain in Spain stays mainly in the plain, or so the old song would have it.",
         "Ask not what your country can do for you.",
         "It was the best of times, it was the worst of times, it was the age of wisdom.",
         "Better late than never, but never late is better.",
         "A picture is worth a thousand words.",
         "When in Rome, do as the Romans do, and when elsewhere, do as they do there."]
PROMPT_TEXT = "Hello there, this is the prompt voice."
BIG_WAVE = 12  # slots of the wave above K2's limit


def launch_counts():
    from gsv_tts_tpu_torch.ops import flash_decode, fused_step

    return {"k1": fused_step.fused_decode_step_sample,
            "k2": fused_step.fused_decode_step_sample_batched,
            "k3a": flash_decode.flash_decode_attention,
            "k3b": flash_decode.flash_decode_attention_layered}


def reset_counts():
    for fn in launch_counts().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in launch_counts().items()}


def check_audio(what, audio, lo, hi):
    import numpy as np

    if not (audio.ndim == 1 and lo < audio.size <= hi):
        fail(f"{what}: audio of {audio.size} samples, expected ({lo}, {hi}]")
    if not np.all(np.isfinite(audio)) or np.abs(audio).max() > 1.0 + 1e-6:
        fail(f"{what}: audio not finite or out of [-1, 1]")


def single_path(tts, spk, prompt):
    """Two ``TTS.infer`` requests; every decode step is one K1 launch."""
    import torch

    reset_counts()
    steps = 0
    for i, text in enumerate(TEXTS[:2]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip = tts.infer(str(spk), str(prompt), PROMPT_TEXT, text)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = tts.last_timings
        steps += st["decode_steps"]
        check_audio(f"infer request {i}", clip.audio_data, int(0.2 * 32000),
                    st["tokens"] * 1280 + int(0.2 * 32000))
        print(f"infer request {i}: {st['tokens']} tokens, {st['decode_steps']} decode steps in "
              f"{st['decode_s']:.3f} s = {st['decode_steps'] / st['decode_s']:.1f} tok/s, "
              f"{1000 * st['decode_s'] / st['decode_steps']:.3f} ms/step; prefill "
              f"{1000 * st['prefill_s']:.1f} ms, SoVITS {st['sovits_s']:.3f} s; "
              f"{clip.audio_len_s:.2f} s of audio in {wall:.3f} s, RTF "
              f"{wall / clip.audio_len_s:.4f}", flush=True)
    counts = read_counts()
    print(f"main path, infer: K1 launched {counts['k1']} times for {steps} decode steps",
          flush=True)
    if counts["k1"] != steps or steps == 0 or counts["k2"] or counts["k3b"]:
        fail(f"infer: launches {counts} for {steps} decode steps")
    return counts


def batched_path(tts, engine, spk, prompt, texts, layers):
    """One ``TTS.infer_batched`` call; returns (launch counts, engine stats)."""
    import torch

    reset_counts()
    refills, compactions = engine.refills, engine.compactions
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clips = tts.infer_batched(str(spk), str(prompt), PROMPT_TEXT, texts, is_cut_text=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = dict(tts.last_timings, refills=engine.refills - refills,
              compactions=engine.compactions - compactions)
    counts = read_counts()
    n = len(texts)
    if len(clips) != n or st["requests"] != n:
        fail(f"infer_batched of {n} texts returned {len(clips)} clips, {st['requests']} requests")
    mute = int(0.4 * 2.0 * 32000)  # the longest pause appended after a segment
    for i, clip in enumerate(clips):
        check_audio(f"infer_batched({n}) request {i}", clip.audio_data, int(0.2 * 32000),
                    1024 * 1280 + mute)
    total = sum(c.audio_data.size for c in clips)
    if not 0.25 * st["tokens"] * 1280 < total <= st["tokens"] * 1280 + n * mute:
        fail(f"infer_batched({n}): {total} samples for {st['tokens']} tokens")
    audio_s = total / 32000
    print(f"infer_batched of {n}: {st['requests']} requests, {st['tokens']} tokens, "
          f"{st['decode_steps']} decode steps ({st['slot_steps']} slot steps: K1 "
          f"{st['k1_steps']}, K2 {st['k2_steps']}, generic {st['generic_steps']}) in "
          f"{st['decode_s']:.3f} s = {st['tokens'] / st['decode_s']:.1f} tok/s aggregate, "
          f"{1000 * st['decode_s'] / st['decode_steps']:.3f} ms/step; prefill "
          f"{1000 * st['prefill_s']:.1f} ms, SoVITS {st['sovits_s']:.3f} s; refills "
          f"{st['refills']}, compactions {st['compactions']}; {audio_s:.2f} s of audio in "
          f"{wall:.3f} s, RTF {wall / audio_s:.4f}", flush=True)
    want = {"k1": st["k1_steps"], "k2": st["k2_steps"], "k3a": 0,
            "k3b": st["generic_steps"] * layers}
    print(f"main path, infer_batched of {n}: launches {counts}", flush=True)
    if counts != want:
        fail(f"infer_batched({n}): launches {counts}, the decode steps need {want}")
    return counts, st


def main_path_phase(dev):
    """Drives ``infer`` and ``infer_batched``; returns the launches summed
    over the three drives (counts are zeroed before each and read after)."""
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.ops.fused_step import MAX_FUSED_B

    if BIG_WAVE <= MAX_FUSED_B:
        fail(f"the big wave ({BIG_WAVE}) must exceed MAX_FUSED_B ({MAX_FUSED_B})")
    small = [(1, 512), (1, 1024), (2, 512), (4, 512)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        gpt, sov, spk, prompt = write_checkpoints(Path(tmp))

        def engine_for(gpt_cache):
            tts = TTS(gpt_cache=gpt_cache, models_dir=tmp, device=dev, seed=SEED)
            tts.load_gpt_model(str(gpt))
            tts.load_sovits_model(str(sov))
            return tts, tts.gpt_models[str(gpt)].engine

        tts, engine = engine_for(small)
        layers = engine.cfg.num_layers
        print(f"main path: checkpoints written and loaded in {time.perf_counter() - t0:.1f} s",
              flush=True)
        total = single_path(tts, spk, prompt)
        # six texts with waves of at most four slots: two refills, then the
        # tail compacts
        counts, st = batched_path(tts, engine, spk, prompt, TEXTS[:6], layers)
        if counts["k2"] == 0 or st["refills"] < 2 or st["compactions"] < 1:
            fail(f"infer_batched(6): K2 launches {counts['k2']}, refills {st['refills']}, "
                 f"compactions {st['compactions']}")
        total = {k: total[k] + v for k, v in counts.items()}
        del tts, engine
        # a wave above K2's limit: the generic step, K3b in every layer
        tts, engine = engine_for(small + [(BIG_WAVE, 512)])
        counts, st = batched_path(tts, engine, spk, prompt, TEXTS[:BIG_WAVE], layers)
        if counts["k3b"] == 0:
            fail(f"infer_batched({BIG_WAVE}): K3b was not launched")
        return {k: total[k] + v for k, v in counts.items()}


def profile_phase(bench: StepBench):
    """torch.profiler over 20 steps of K1, of K2 (B=4) and of the generic
    step with K3b (B=12) at kv_len ~777 in a 1024-row cache: device time by
    kernel and the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gsv_tts_tpu_torch.ops.sampling import gumbel_noise
    from gsv_tts_tpu_torch.runtime import t2s_session as ts

    V, n = bench.cfg.vocab_size, 20
    wave12 = [777, 761, 790, 770, 745, 781, 799, 752, 766, 773, 758, 787]
    for label, kv_lens, (sa, su, _) in (("K1 B=1", [777], sampling_settings()[1]),
                                        ("K2 B=4", wave12[:4], sampling_settings()[3]),
                                        ("generic step with K3b B=12", wave12,
                                         sampling_settings()[3])):
        B = len(kv_lens)
        st = bench.state(1024, kv_lens, [60] * B, [17] * B, [20] * B)
        g = gumbel_noise((B, V), bench.dgen, bench.dev)
        kk, kv, kt = st["kc"].clone(), st["vc"].clone(), st["tok_buf"].clone()
        if B <= 8:
            def step():
                bench.kernel(st, kk, kv, kt, g, sa, su)
        else:
            state = ts.DecodeState(kk, kv, st["kv"], st["x"], kt, st["buf"], st["last"],
                                   st["step"])
            tok_out = torch.empty(B, dtype=torch.int32, device=bench.dev)

            def step():  # the same row every time: the counters are not advanced
                ts._generic_step(bench.params, bench.cfg, state, g, sa, su, torch.bfloat16,
                                 tok_out)
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            span_ms = 1000 * (time.perf_counter() - t0) / n

        def self_us(e):  # the attribute's name changed between PyTorch versions
            return getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)

        # device-side events only: a host op's device time repeats its kernels'
        rows = [(e.key, self_us(e) / 1000 / n, e.count / n) for e in prof.key_averages()
                if "CUDA" in str(getattr(e, "device_type", "")) and self_us(e) > 0]
        busy = sum(r[1] for r in rows)
        if busy == 0:
            fail("torch.profiler recorded no device time")
        t_plain = cuda_ms(step, n)
        print(f"profile {label} S=1024 kv_len~777: profiled span {span_ms:.4f} ms/step "
              f"({t_plain:.4f} without the profiler), device busy {busy:.4f} ms/step in "
              f"{sum(r[2] for r in rows):.0f} launches, idle share {1 - busy / span_ms:.3f}",
              flush=True)
        for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:12]:
            print(f"  {ms:.4f} ms/step  {cnt:6.1f} launches/step  {key[:100]}", flush=True)


def main():
    if not (HERE / "gsv_tts_tpu_torch" / "csrc").is_dir():
        fail(f"the gsv_tts_tpu_torch package is not beside {__file__}")
    sys.path.insert(0, str(HERE))
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)

    from gsv_tts_tpu_torch.ops import flash_decode, fused_step
    from gsv_tts_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    libraries = [fused_step.K1_LIBRARY, fused_step.K2_LIBRARY, flash_decode.LIBRARY]
    cuda_build.load_libraries(libraries)
    for bind in (fused_step.load_kernels, fused_step.load_batched_kernels,
                 flash_decode.load_kernels):
        bind()
    print(f"build: {len(libraries)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, _ in libraries:
        info = cuda_build.build_info[name]
        print(f"  {info['path']} (nvcc {info['seconds']:.1f} s)", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    ptxas: {line.strip()}", flush=True)

    bench = StepBench(dev)
    if "--profile" in sys.argv[1:]:
        profile_phase(bench)
        return
    k1_err, k1_times = k1_phase(bench)
    k2_err, k2_times = k2_phase(bench)
    k3 = k3_phase(dev, bench.cfg)
    del bench
    torch.cuda.empty_cache()
    launches = main_path_phase(dev)

    def step_record(name, source, replaces, count, err, t):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": count, "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                "bound_ms": t[2], "bound_by": t[3], "library_ms": None}

    def attn_record(name, replaces, count, r):
        return {"name": name, "route": "cuda",
                "source": "gsv_tts_tpu_torch/csrc/k3_flash_decode.cu", "replaces": replaces,
                "launches": count, "max_abs_err": r[0], "ms": r[1], "plain_ms": r[2],
                "bound_ms": r[4], "bound_by": r[5], "library_ms": r[3]}

    # times of the whole-step kernels: S=1024, kv_len ~777 (K2 at B=4); of
    # the attention kernels: B=12, S=512, kv_len ~300.  K3a is not on the
    # main path (it shares K3b's kernel body and is held in the kernel phase)
    record = {"kernels": [
        step_record("k1_decode_step", "gsv_tts_tpu_torch/csrc/k1_decode_step.cu",
                    "gsv_tts_tpu/ops/fused_step.py:897", launches["k1"], k1_err, k1_times[1024]),
        step_record("k2_decode_step_batched", "gsv_tts_tpu_torch/csrc/k2_decode_step_batched.cu",
                    "gsv_tts_tpu/ops/fused_step.py:1641", launches["k2"], k2_err,
                    k2_times[1024]),
        attn_record("k3a_flash_decode", "gsv_tts_tpu/ops/flash_decode.py:116", launches["k3a"],
                    k3["k3a"]),
        attn_record("k3b_flash_decode_layered", "gsv_tts_tpu/ops/flash_decode.py:183",
                    launches["k3b"], k3["k3b"])]}
    for name in ("k1", "k2", "k3b"):  # the kernels of the main path
        if launches[name] == 0:
            fail(f"{name} was not launched on the main path")
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
