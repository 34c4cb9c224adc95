#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``gsv_tts_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py             # the smoke
    python3 chip_smoke.py --profile   # the smoke's set-up, then a torch.profiler
                                      # breakdown of a K1 and a K2 step, of K5 and
                                      # K6 calls, and the persistent kernels' time
                                      # phase by phase

Phases, each fatal on failure (non-zero exit, no result line):

1. card: ``nvidia-smi`` name and power limit;
2. build: one ``nvcc`` per library, all started together, from
   ``gsv_tts_tpu_torch/csrc`` (K1, K2, K3, K4, K5, K6, and the probes P1-P3), and
   beside them the host DSP library (``csrc/host/gsv_native.cpp``) with the host C++
   compiler;
3. kernels, each against its plain PyTorch twin at the flagship t2s widths
   (L=24, D=512, H=16, M=2048, V=1025) in bf16:
   * K1 (whole B=1 decode step) and K2 (whole step for a wave of B slots,
     every B from 2 to ``MAX_FUSED_B``), each one persistent cooperative
     kernel plus the sampling launch: caches of 512 and 1024 rows, ragged
     ``kv_len`` (a frozen slot, the first row past the 512 -> 1024
     escalation, the last row of the cache), repetition penalty on and off;
     final hidden state, logits, appended K/V rows and filtered rows within
     stated tolerances, tokens equal wherever the top-2 margin of
     ``row + gumbel`` clears the tolerance, every other cache row untouched;
     the three error bits (a bad ``last_tok``, ``kv_len = S``, a positional
     index past the table) set with NaN where promised and the kernel back
     within a deadline; each timed in turns with its twin, the cost of one
     grid barrier, and the host's time per call;
   * K3a / K3b (decode attention, one layer's cache / a layer of the stacked
     cache; one launch of clusters of ``cluster_plan`` blocks a (slot, head)):
     B = 1, 4 and 12, lengths 0, 63, 64, S-1 and more, every layer index,
     cache rows past ``kv_len`` poisoned, at B=1 also forced to the largest
     cluster (8); at B=12, S=512 and at B=1, S=1024 the device kernels of 10
     calls (one each: the kernel nodes of a CUDA graph captured around them,
     read through libcuda; ``torch.profiler``'s count printed beside
     it), the time a call in turns with
     the twin, the device time from a CUDA graph of 50 launches beside the
     library call's and, at B=1, the same launch forced to each other cluster
     size;
     the host's time per call;
   * K4 (prefill attention under the hybrid mask; bf16 on the tensor cores,
     float32 on the CUDA cores): B = 1, 4 and 6, T = 160, 512 and 1024, q/k/v
     as strided views of one qkv product, lengths with one phoneme, no audio
     rows, pad rows, the 1/1 of a dead slot, a ragged batch, every pair of
     lengths from 15, 16, 17, 63, 64 and 65, head dims 8 and 128; at T=160 and
     512 the time a call in turns with the twin, the device time of the
     tensor-core body and of the library call from CUDA graphs of 50 launches
     in turns, the host's time per call; then the wall
     time of ``prefill_batch`` with and without it;
   * K5 (all layers, one token, B=1) and K6 (one layer, one token per row),
     each one launch of the persistent kernel as a layer stack (K6 one per
     group of at most 8 rows): K5 at caches of 512 and 1024 rows, ``kv_len``
     0, mid and S-1, bf16 and float32 rows; K6 at B = 1, 3, 4, 5, 8, 11 and
     12 (groups with dead rows), ragged ``kv_len``, every layer index, cache
     rows past ``kv_len`` poisoned, ``x`` and ``kv_len`` ending where the
     wave does, every other cache entry bit for bit; hidden rows and appended
     rows within the whole-step tolerances; a ``kv_len`` past the cache sets
     its bit with NaN in that row alone; one device kernel a call (K6: a
     group), counted as K3b's are; the time a call in turns with the twin
     (K6's calls walk the layers as the ``"fused"`` path does), the device
     time from a CUDA graph of many calls, the host's time per call;
     then K1, K6, K5 and K1 interleaved on the engine's one table, each bit
     for bit its lone call;
   * K1 and K2 on the int8 and int4 weight pages (``quant_t2s``; K2 at B = 2,
     4 and 6): caches of 512 and 1024 rows, ragged ``kv_len`` with a frozen
     slot and the cache's last row, each step against the quantized twin and
     a float32 evaluation of the same quantized chain in K1's tolerance form,
     every other cache row untouched, three error bits through each stream;
     the time a step in turns with the bf16 kernel and the device time of
     both from CUDA graphs, beside the bound of the pages' bytes;
   CUDA-event times of kernel and twin (and, for K3 and K4, of one
   ``scaled_dot_product_attention`` call as a yardstick), beside the least
   time the card could take for the bytes the call must move; on the device
   (CUDA graphs, timed in turns) K4 must be faster than the library call at
   T=512;
4. main path: full-width random s1v3 t2s / v2 SoVITS / HuBERT-base
   checkpoints and synthetic wavs made from a seed in a temporary models
   directory, loaded through ``TTS.load_gpt_model`` / ``load_sovits_model``;
   two English ``TTS.infer`` requests (K1), one ``TTS.infer_batched`` of six
   texts on a four-slot wave (K2, with slot refills and tail compaction) and
   one of twelve texts (a wave above K2's limit: the generic step with K3b).
   The audio must be finite and of plausible length and each kernel's
   launch count must equal the decode steps its path took;
5. the ``attn_impl`` paths and streaming, on the same checkpoints:
   ``T2SEngine(attn_impl="flash").generate`` (K4 in every layer of the
   prefill, K3b in every layer of every step, at B=1),
   ``T2SEngine(attn_impl="fused").generate`` (K6 in every layer of every
   step), a decode loop through ``transformer_decode_step`` under
   ``"fused_step"`` (K5 once per step; its tokens held against the
   ``"flash"`` route's from the same states), and ``TTS.infer_stream`` twice
   with the default engine (K1) and once under ``attn_impl="flash"``: more
   than one chunk, every chunk finite, time to first audio printed;
6. SoVITS buckets.  Every facade above runs at the default SoVITS options
   (``sovits_cache=[50, 55]``, ``stream_vocoder="bucketed"``): each ``infer``
   replays two CUDA graphs (the padded core, the flow bucket), each stream
   chunk one (the fused chunk).  Then: two equal ``infer`` requests, the
   second capturing no graph; a padded core captured at one length and
   replayed at another of its bucket, and a fused stream chunk, against
   their eager runs; ``sovits_s`` and the stream's warm time to first audio
   under ``"bucketed"`` and ``"exact"`` in turns (b, e, e, b, twice) in one process;
   ``speed=0.8``; ``infer(return_subtitles=True)`` (non-empty, times not
   decreasing); the graphs' count, each one's device time a replay, and
   their memory pool's size;
7. v2ProPlus: a full-width random v2ProPlus SoVITS (``gin_channels`` 1024)
   and ERes2NetV2 checkpoint from SEED; the card's bf16 speaker embedding and
   ``ge`` held against a float32 evaluation of the same weights (K1's
   tolerance form), the embedder's time a clip; one facade with the v2 and
   the v2ProPlus model: ``infer`` twice on each, in turns (the second
   capturing no graph; RTF and ``sovits_s`` of both), ``infer_batched`` of 4
   texts (K2), one ``infer_stream``, ``infer_vc`` (audio of about the
   prompt's length, subtitles; its wall time), ``verify_speaker`` (self
   ≥ 0.999, cross in [-1, 1]) and ``unload_sovits_model`` (its graphs and
   their pool gone, the v2 model's still replaying);
8. ``quant_t2s``: ``TTS(quant_t2s="int8").infer`` three times in turns with a
   bf16 facade's (ms a step of both), ``infer_batched`` of 4 texts (the int8 K2
   and K1) and of 7 (a 7-slot wave: the bf16 K2, then the int8 kernels as
   it compacts), one ``infer_stream``, ``TTS(quant_t2s="int4")``'s ``infer``
   and ``infer_batched`` of 4, and ``unload_gpt_model`` freeing at least the
   pages' bytes; every quantized
   launch count equals the decode steps its path took;
9. the probes (``gsv_tts_tpu_torch/tools``, counterparts of the TPU probes
   under ``tools/``), their path being each tool's entry: P1's and P2's
   ``run_variant`` (the probe's input against its reference), P3's (a step
   against its twin, then the 100-step chain from one CUDA graph) at the full
   [24, 512, 6144] bf16 weight for every variant (the TPU tool's, and
   ``k1ring``: K1's ring of 8 slots of 16 KB), xla and fori in turns;
   launches counted there (a replayed step counts, a captured one does not).
   Then P1 (both variants, at the probe's shape, the flagship MLP-1's and the
   s1v3 layer stack as one int4 page, D = 12288, N = 6144; what ``cuobjdump
   -sass`` shows of the kernels: HMMA, no I2F, no atomic in ``unpack``), P2
   (four variants) and every P3 kernel variant against their twins, with a
   call's time in turns with the twin and the device's from CUDA graphs in
   turns with an empty kernel's (the launch floor), each P3 step alone on the
   device, and M1: P1's time at the stack beside P3 ``fori``'s rate over the
   same bytes;
10. zh: a full-width random CNRoberta from SEED (``BertConfig()``: vocab 21128,
   hidden 1024, 24 layers, 16 heads, FFN 4096; ~325 M parameters, ~650 MB as
   bf16 safetensors) and a synthesized ``vocab.txt`` beside the v2 checkpoints
   of phase 4; the host has no ``jieba``, so a stand-in zh G2P
   (``StandInZhG2P``: the port's ``zh_norm``, a pinyin table of the phase's
   texts and ``split_full_pinyin``, no sandhi) is installed as
   ``global_config.chinese_g2p`` (the real G2P is held to JAX's on the CPU).
   ``TTS(use_bert=True)``: English and Chinese ``infer`` in turns (ms a step,
   RTF) and a mixed zh/en one (K1 a step), ``infer_batched`` of four Chinese
   texts (K2, then K1 for the tail), a Chinese ``infer_stream`` (K1),
   ``infer_async`` twice from ``asyncio.run`` (the SoVITS graphs evicted first:
   the first call captures in its worker thread, the second replays) and
   ``infer_stream_async``; ``TTS(quant_bert=True)`` and
   ``TTS(featurizer_buckets=True)``, one ``infer`` each, the BERT loaded on the
   first Han text; the bf16 and int8 BERT features of the four texts against a
   float32 evaluation of the same weights on the card (``BERT_BF16_TOL``,
   ``BERT_Q8_TOL``), a BERT call's time at two text lengths (CUDA events), the
   encoder's device time (a CUDA graph of it) and its bound;
   ``TTS(use_flash_attn=False).infer`` (the ``"xla"`` engine: no launch of any
   kernel) with its ms a step.  Every launch count equals the decode steps its
   path took;
11. shared streams and ja, on the phase-4 checkpoints and ``[(1,512),(2,512),(4,512)]``:
   ``infer_batched_stream`` of 4 texts (its tokens equal ``infer_batched``'s: both K2 at
   B=4); ``VocoderBatcher.decode_many`` at 2 and 4 rows against each row's solo chunk, in
   float32 (a float32 facade) and in bf16 against a float32 evaluation, and a batched
   chunk of 4 rows against 4 solo chunks, replays only, in turns; 4 ``stream_shared``
   clients 50-100 ms apart after the SoVITS graphs were evicted (captures while their K2
   wave is live, a wave of more than one slot, batched vocoder groups, every client done
   within ``CLIENT_DEADLINE_S``), each client's time to first audio, the wave's tok/s and
   ms a K2 step against ``infer_batched``'s; a lone ``stream_shared`` against
   ``infer_batched_stream`` of its text (both K1); Japanese kana through ``infer`` and
   ``stream_shared``; ``warmup(stream=True)``, ``stream_shared_async`` and
   ``infer_batched_stream_async``.  K1's and K2's launches equal the steps of each drive;
12. training, on the phase-4 t2s and the phase-7 v2ProPlus checkpoints: 8 clips of 4-10 s
   with English sentences of 8-20 words from SEED, featurized through the port's ``TTS``
   (``train_data.featurize``: frontend, HuBERT, RVQ codes; ``featurize_sovits``: STFT,
   HuBERT, each clip's ERes2NetV2 embedding), ms a clip; bf16 against float32 loss and
   gradients at step 0 (``TRAIN_LOSS_REL_TOL``, ``TRAIN_GRAD_COS_MIN``); ``finetune_t2s``
   (bf16, batch 8, 30 steps, warmup 5, a checkpoint at 15) straight and resumed from step
   15, every step's loss finite and a fixed batch's loss lower after than before; the export
   loaded by ``TTS.load_gpt_model`` and decoded through K1 (launches equal to the decode
   steps); ``finetune_sovits`` on v2ProPlus (batch 4, ``segment_frames`` from the hparams,
   10 GAN steps) straight and resumed at step 5, every loss finite, the frozen RVQ leaves
   bit for bit, the export loaded and decoded with the fine-tuned t2s through K1; ms a t2s
   step and a GAN step (D + G), trained audio tokens/s, peak memory of each run, the warm
   RTF; straight against resumed on the card (leaves apart, largest difference), the
   operations PyTorch flags as nondeterministic in one step of each, and for SoVITS one
   step twice from one state (cuDNN's default and deterministic algorithms) and the mel
   loss's gradient twice.

13. serving, on the phase-4 checkpoints and ``[(1,512),(2,512),(4,512)]`` after
   ``TTS.warmup()``: ``serving.server.TTSServer``'s route methods in one asyncio loop, without
   aiohttp (the card's host has none; the aiohttp adapter is held to JAX's app on the CPU).
   Twice: api_v2 ``/tts`` wav at ``top_k=1, noise_scale=0`` (the bytes of a direct
   ``TTS.infer`` with the same arguments), api_v2 ``streaming_mode=1`` (a wav header chunk,
   then ``infer_stream``'s chunks as raw frames), ``/tts/stream`` not shared (audio events
   and one done; ``"speed": 0`` one error event), shared (3 concurrent clients on a K2 wave;
   at a cap of 1 a second client's 503 + ``Retry-After: 1`` before any byte, a later client
   streaming) — the second round capturing no graph and building no library
   (``backend_compiles``).  Between the rounds: ``batch_window_ms`` coalescing 4 api_v2
   requests into one ``infer_batched`` (K2) and a lone one into ``infer``, OpenAI ``speech``
   as wav and SSE and an unknown voice's 400, the WebUI's ``synth`` through
   ``fx.enhance_audio``, ``health`` (the card's name, ``warmed``, wave and vocoder stats) and
   ``metrics``; after them ``set_gpt_weights`` reloading the checkpoint and one request.
   The server's overhead (api_v2 against the direct ``infer``), SSE time to first audio
   against ``infer_stream``'s ``ttfa_s``, the coalesced call's wall time and the phase's
   seconds are printed.  Every launch count equals the decode steps its drive took.

14. multi-device, on the phase-4 checkpoints in bf16, in a world of one rank over NCCL on
   this card (``parallel/mesh.py:make_mesh()``: dp=1, tp=1; a one-rank group runs no
   collective): ``T2SEngine(...).shard(mesh)``'s ``generate`` and ``generate_batched`` of 6
   texts equal to the unsharded ``"xla"`` engine's bit for bit with no kernel launched, ms a
   step of each in turns, and µs a call of the NCCL collectives a split would run;
   ``DataParallelEngine(mesh=)`` ``generate_batched`` of 6 on ``[(1,512),(4,512)]`` equal to
   the plain engine's, greedy and sampled, K1 / K2 launches equal to its steps; one dp×tp
   ``make_train_step`` step and one ``seq_mesh`` step bit for bit the single-card step (loss
   and gradients), GPipe at pp=1 with 2 and 4 microbatches within ``TRAIN_LOSS_REL_TOL`` /
   ``TRAIN_GRAD_COS_MIN``, on 8 synthesized samples, with ms a step in turns;
   ``finetune_t2s(mesh=)`` 4 steps straight and resumed at 2 (bit for bit) and
   ``finetune_sovits(mesh=)`` 2 GAN steps, every loss finite.  With two cards a world of 2
   (``parallel/launch.py``) runs the engines and the steps at tp=2, dp=2 and pp=2 against
   each rank's single-card results; with one it says so.

15. host library and public surface, on the phase-4 checkpoints: the host DSP library's
   path and build seconds; ``fx.enhance_audio`` on 10 s of seeded 32 kHz audio and on an
   ``infer`` clip through the library against its numpy path (``GSV_DISABLE_NATIVE``),
   within ``ENHANCE_TOL``, both times printed with the card, the envelope follower and
   Freeverb called on the native run and never on the numpy one;
   ``infer(return_subtitles=True)`` and ``infer_stream`` at ``top_k=1, noise_scale=0``
   through the library and through numpy: the same tokens, subtitles, SOLA offsets and
   audio, the library's Viterbi and SOLA called on the native run and never on the numpy
   one, K1 launches equal to the decode steps; ``dsp.sola_align`` at the stream's chunk
   shapes with a known shift of 137 samples, found by both paths; ``ops/stft.mel_spectrogram`` of the clip on the card against ``device="cpu"``
   (``MEL_CARD_TOL``), ``mel_distance`` of the clip with itself 0 and of the stream's audio
   with the clip's; the package's four exports; ``clip.play(0.5)`` and
   ``tts.audio_queue.wait()`` within 2 s (whether an output stream opened); a ``.flac``
   ``save`` (through ``soundfile``, or its ``ImportError``); ``check_pretrained_models`` on
   an empty directory: ``False`` with no socket connect.  ``GSV_OFFLINE`` is set to 1 at the
   start unless the caller set it, so no phase's facade opens a connection.

The last line is ``{"ok": true, "device": {...}}``; before it come the
kernels' JSON record, phase 10's to 15's readings (``zh readings: {...}``,
``shared readings: {...}``, ``train readings: {...}``, ``serving readings: {...}``,
``multi readings: {...}``, ``host readings: {...}``) and the card.  Nothing here imports JAX.
"""
from __future__ import annotations

import json
import math
import os
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

# K4 against its twin: O(1) averages of bf16 value rows.  In bf16 the twin
# rounds the normalised probabilities to bf16 before the value product (as the
# TPU kernel does), the kernel keeps them in float32, and both round the
# output (2^-9 relative each); in float32 only the summation order differs.
# The error is taken relative to max(1, |twin|): a row that attends one
# column returns that value row itself, whose entries reach past 2.
K4_TOL = {"bfloat16": 2e-2, "float32": 1e-4}

# the card's published peaks (NVIDIA H100 SXM data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12  # outside the tensor cores


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


def turns_beside(run_kernel, run_beside, run_plain, k_iters: int, p_iters: int):
    """plain, beside, kernel, kernel, beside, plain: as :func:`timed_turns`, with a second
    kernel beside the first.  Returns (kernel ms, plain ms, beside ms)."""
    p1 = cuda_ms(run_plain, p_iters)
    c1 = cuda_ms(run_beside, k_iters)
    k1 = cuda_ms(run_kernel, k_iters)
    k2 = cuda_ms(run_kernel, k_iters)
    c2 = cuda_ms(run_beside, k_iters)
    p2 = cuda_ms(run_plain, p_iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, (c1 + c2) / 2


def host_us(fn, calls: int = 10) -> float:
    """Host time of one call (us): the host clock around ``calls`` calls with no synchronise
    inside, started on an idle device so that the launch queue stays shallow."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / calls


def host_scale(t) -> str:
    """What a wrapper's host time compares with on this host: one ``torch.empty_like`` (every
    launch allocates its output) and one eager ``torch.add``."""
    import torch

    return (f"for scale, torch.empty_like {host_us(lambda: torch.empty_like(t)):.1f} us and an "
            f"eager torch.add {host_us(lambda: torch.add(t, t)):.1f} us")


def weight_bytes(cfg) -> int:
    """bf16 matrix bytes every whole decode step reads once, whatever B is."""
    L, D, M, V = cfg.num_layers, cfg.hidden_dim, cfg.hidden_dim * cfg.mlp_ratio, cfg.vocab_size
    return 2 * (L * (4 * D * D + 2 * D * M) + V * D)


def bound(n_bytes: float, n_flops: float, peak: float = BF16_FLOPS):
    """Least time (ms) the card could take: the larger of the bytes over the
    memory rate and the operations over ``peak`` (the bf16 tensor cores'
    unless given), and which it is."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_flops / peak
    return 1000 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def step_bound(cfg, S, kv_lens, quant=None):
    """Bound of one whole decode step (K1, K2) for slots at ``kv_lens``:
    every weight read once whatever B is (the layers' matrices as bf16, or
    as int8 / int4 pages with a float32 scale a lane under ``quant``; the
    head bf16); per slot its embedding and positional rows, the attended
    cache rows (K and V, bf16) and the appended row, the noise and the
    filtered row, its ``tok_buf`` row and counters."""
    L, D, M, V = cfg.num_layers, cfg.hidden_dim, cfg.hidden_dim * cfg.mlp_ratio, cfg.vocab_size
    B = len(kv_lens)
    n_layer, n_head = L * (4 * D * D + 2 * D * M), V * D  # matrix entries
    w_bytes = {None: 2 * n_layer, "int8": n_layer, "int4": n_layer // 2}[quant] + 2 * n_head
    if quant is not None:
        w_bytes += 4 * L * (3 * D + D + M + M)  # the scales
    small = L * (2 * (3 * D + D + M + D) + 4 * 4 * D)  # biases bf16, LayerNorm affines f32
    per_slot = sum(2 * D + 4 * D + 4 * L * kv * D + 4 * L * D + 8 * V + 4 * S + 24
                   for kv in kv_lens)
    flops = 2 * B * (n_layer + n_head) + sum(4 * L * (kv + 1) * D for kv in kv_lens)
    return bound(w_bytes + small + per_slot, flops)


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
        self.quant_sets = {}

    def params_for(self, quant=None):
        """(parameters with their table, float32 parameters) of the bf16 stream, or of the
        ``quant`` pages (packed once, with a table of their own; the float32 set carries the
        same pages: a float32 evaluation of the same quantized chain)."""
        from gsv_tts_tpu_torch.ops import fused_step

        if quant is None:
            return self.params, self.params32
        if quant not in self.quant_sets:
            pages = {fused_step.QUANT_KEYS[quant]: fused_step.quant_layers(self.params, quant)}
            p = dict(self.params, **pages)
            p["k1_table"] = fused_step.K1Table(p, quant)
            self.quant_sets[quant] = (p, dict(self.params32, **pages))
        return self.quant_sets[quant]

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

    def kernel(self, st, kc, vc, tok_buf, g, sa, su, quant=None, **out):
        """K1 for one slot (its counters as host ints), K2 for a wave, on the bf16 weights or
        the ``quant`` pages."""
        from gsv_tts_tpu_torch.ops import fused_step

        kw = dict(sa=sa, suppress_until=su, suppressed=self.sup, quant=quant, **out)
        params = self.params_for(quant)[0]
        if len(st["kv_lens"]) == 1:
            return fused_step.fused_decode_step_sample(
                params, kc, vc, tok_buf, st["kv_lens"][0], st["x_lens"][0], st["last"],
                st["buf_lens"][0], st["steps"][0], g, **kw)
        return fused_step.fused_decode_step_sample_batched(
            params, kc, vc, tok_buf, st["kv"], st["x"], st["last"], st["buf"], st["step"], g,
            **kw)

    def twin(self, st, kc, vc, tok_buf, g, sa, su, quant=None, **out):
        from gsv_tts_tpu_torch.ops import fused_step

        return fused_step.fused_decode_step_sample_batched_ref(
            self.params_for(quant)[0], kc, vc, tok_buf, st["kv"], st["x"], st["last"],
            st["buf"], st["step"], g, sa=sa, suppress_until=su, suppressed=self.sup,
            quant=quant, **out)

    def compare(self, st, sa, su, is_plain, where, quant=None) -> float:
        """One step through the kernel and through the twin from the same
        state (on the ``quant`` pages when given, held to a float32
        evaluation of the same quantized chain); fails on any disagreement,
        returns the max abs error."""
        import torch

        from gsv_tts_tpu_torch.ops import fused_step
        from gsv_tts_tpu_torch.ops.sampling import gumbel_noise

        B, V, D = len(st["kv_lens"]), self.cfg.vocab_size, self.cfg.hidden_dim
        params, params32 = self.params_for(quant)
        g = gumbel_noise((B, V), self.dgen, self.dev)
        kk, kv, kt = st["kc"].clone(), st["vc"].clone(), st["tok_buf"].clone()
        tok, row, _, _ = self.kernel(st, kk, kv, kt, g, sa, su, quant=quant)
        hid = params["k1_table"].x[:B * D].clone().reshape(B, D)
        rk, rv, rt = st["kc"].clone(), st["vc"].clone(), st["tok_buf"].clone()
        ref_h, ref_logits = fused_step.decode_hidden_ref(
            params, rk.clone(), rv.clone(), st["kv"], st["x"], st["last"], quant)
        f32_h, f32_logits = fused_step.decode_hidden_ref(
            params32, st["kc"].float(), st["vc"].float(), st["kv"], st["x"], st["last"], quant)
        rtok, rrow, _, _ = self.twin(st, rk, rv, rt, g, sa, su, quant=quant)
        torch.cuda.synchronize()
        params["k1_table"].check()
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

    def times(self, name, st, sa, su, S, k_iters=100, p_iters=10):
        """Times of one step from ``st``: the twin, the persistent kernel twice, the twin,
        each the mean of its two turns, and the host's time per kernel call.  Returns
        (kernel ms, twin ms, bound ms, bound by)."""
        import torch

        from gsv_tts_tpu_torch.ops.sampling import gumbel_noise

        B, V = len(st["kv_lens"]), self.cfg.vocab_size
        g = gumbel_noise((B, V), self.dgen, self.dev)
        kk, kv, kt = st["kc"].clone(), st["vc"].clone(), st["tok_buf"].clone()
        out = dict(tok_out=torch.empty(B, dtype=torch.int32, device=self.dev),
                   row_out=torch.empty((B, V), dtype=torch.float32, device=self.dev))

        def run_kernel():
            self.kernel(st, kk, kv, kt, g, sa, su, **out)

        k_ms, p_ms = timed_turns(
            run_kernel, lambda: self.twin(st, kk, kv, kt, g, sa, su, **out), k_iters, p_iters)
        b_ms, b_by = step_bound(self.cfg, S, st["kv_lens"])
        print(f"{name} time B={B} S={S} kv_len={st['kv_lens']}: persistent kernel {k_ms:.4f} "
              f"ms/step ({weight_bytes(self.cfg) / k_ms / 1e6:.0f} GB/s over the weight bytes), "
              f"plain twin {p_ms:.4f} ms/step, bound {b_ms:.4f} ms ({b_by}); host "
              f"{host_us(run_kernel):.1f} us per call", flush=True)
        return k_ms, p_ms, b_ms, b_by

    def quant_times(self, name, st, sa, su, S, quant, k_iters=100, p_iters=10):
        """Times of one step from ``st`` on the ``quant`` pages, in turns with the bf16 kernel
        and the quantized twin (twin, bf16, quantized, quantized, bf16, twin), each the mean
        of its two turns; the device alone from CUDA graphs of 20 steps of each, replayed in
        turns; the host's time per call.  Returns (ms, twin ms, bound ms, bound by, bf16 ms,
        extras)."""
        import torch

        from gsv_tts_tpu_torch.ops.sampling import gumbel_noise

        B, V = len(st["kv_lens"]), self.cfg.vocab_size
        g = gumbel_noise((B, V), self.dgen, self.dev)
        kk, kv, kt = st["kc"].clone(), st["vc"].clone(), st["tok_buf"].clone()
        out = dict(tok_out=torch.empty(B, dtype=torch.int32, device=self.dev),
                   row_out=torch.empty((B, V), dtype=torch.float32, device=self.dev))

        def run(q):
            return lambda: self.kernel(st, kk, kv, kt, g, sa, su, quant=q, **out)

        k_ms, p_ms, bf_ms = turns_beside(
            run(quant), run(None), lambda: self.twin(st, kk, kv, kt, g, sa, su, quant=quant, **out),
            k_iters, p_iters)
        dev_ms = graph_turns({"q": graph_of(run(quant), 20), "bf16": graph_of(run(None), 20)}, 20)
        self.params_for(quant)[0]["k1_table"].check()
        self.table.check()
        b_ms, b_by = step_bound(self.cfg, S, st["kv_lens"], quant)
        bf_b_ms, _ = step_bound(self.cfg, S, st["kv_lens"])
        host = host_us(run(quant))
        print(f"{name} time B={B} S={S} kv_len={st['kv_lens']}: {quant} kernel {k_ms:.4f} "
              f"ms/step ({dev_ms['q']:.4f} on the device), bf16 kernel {bf_ms:.4f} ms/step "
              f"({dev_ms['bf16']:.4f} on the device), plain twin {p_ms:.4f} ms/step, bound "
              f"{b_ms:.4f} ms ({b_by}; bf16 {bf_b_ms:.4f}); host {host:.1f} us per call; device "
              f"times from CUDA graphs of 20 steps replayed in turns", flush=True)
        return k_ms, p_ms, b_ms, b_by, bf_ms, dict(device_ms=dev_ms["q"],
                                                     bf16_device_ms=dev_ms["bf16"], host_us=host)


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
            times[S] = bench.times("K1", st, sa, su, S)
    print(f"K1 matches its twin on {steps} flagship steps; max abs err {worst:.4g} "
          f"(tolerance {TOL_ABS})", flush=True)
    return worst, times


def k2_phase(bench: StepBench):
    """K2 vs its twin at every B from 2 to MAX_FUSED_B; same returns as K1's."""
    from gsv_tts_tpu_torch.ops.fused_step import MAX_FUSED_B

    worst, times, steps = 0.0, {}, 0
    V = bench.cfg.vocab_size
    for S in (512, 1024):
        half = S // 2  # at S=1024: the first row past the 512 -> 1024 escalation
        waves = {2: [0, S - 1], 3: [0, 64, S - 1], 4: [0, 300, S - 1, half],
                 5: [0, 63, half, 1, S - 1], 6: [0, S - 1, 64, 300, half, 1],
                 7: [0, 1, 63, S - 1, 300, half, S - 200],
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
        times[S] = bench.times("K2", st, sa, su, S)
    wave8 = [777, 761, 790, 770, 745, 781, 799, 752]
    bench.times("K2", bench.state(1024, wave8, [60] * 8, [17] * 8, [20] * 8), sa, su, 1024)
    print(f"K2 matches its twin on {steps} flagship steps (B=2..{MAX_FUSED_B}); max abs err "
          f"{worst:.4g} (tolerance {TOL_ABS})", flush=True)
    return worst, times


def returned_within(seconds: float) -> bool:
    """Whether the device finishes what it was given within ``seconds`` (polled: a kernel that
    hangs must fail the run, not stall it)."""
    import torch

    done = torch.cuda.Event()
    done.record()
    deadline = time.perf_counter() + seconds
    while not done.query():
        if time.perf_counter() > deadline:
            return False
        time.sleep(0.01)
    return True


def error_cases(bench: StepBench):
    """(what is wrong, B, slot, field, value, the message's words, the slot's cache row stays)
    for :func:`error_case`."""
    V, P, S = bench.cfg.vocab_size, bench.params["pe"].shape[0], 512
    return [("last_tok = V", 1, 0, "last", V, "last_tok", False),
            ("last_tok = -1", 4, 1, "last", -1, "last_tok", False),
            ("kv_len = S", 4, 2, "kv", S, "kv_len", True),
            ("kv_len = S", 2, 0, "kv", S, "kv_len", True),
            ("positional index = P", 4, 3, "x", 296 - P, "positional", False),
            ("kv_len = -1", 8, 5, "kv", -1, "kv_len", True)]


def error_case(bench: StepBench, what, B, slot, field, value, words, row_stays, quant=None):
    """One out-of-range device value through a persistent kernel (on the ``quant`` pages when
    given): the launch comes back, the error word holds the value's bit, the slot's row is NaN
    where promised (a bad ``kv_len`` appends nothing) and the other slots are untouched."""
    import torch

    from gsv_tts_tpu_torch.ops.sampling import gumbel_noise

    cfg, V, S = bench.cfg, bench.cfg.vocab_size, 512
    sa, su, _ = sampling_settings()[3]
    what = f"{what} at B={B}" + (f" ({quant})" if quant else "")
    kv_lens = [300, 287, 313, 296, 305, 291, 320, 279][:B]
    st = bench.state(S, kv_lens, [60] * B, [17] * B, [20] * B)
    st[field][slot] = value
    if B == 1:  # K1's counters are host ints, checked on the host: only last_tok is left
        st["last"][0] = value
    g = gumbel_noise((B, V), bench.dgen, bench.dev)
    kk, kv, kt = st["kc"].clone(), st["vc"].clone(), st["tok_buf"].clone()
    _, row, _, _ = bench.kernel(st, kk, kv, kt, g, sa, su, quant=quant)
    if not returned_within(30.0):
        fail(f"the persistent kernel did not come back from {what}")
    table = bench.params_for(quant)[0]["k1_table"]
    try:
        table.check()
    except RuntimeError as e:
        if words not in str(e) or "gave up" in str(e):
            fail(f"{what} raised {e}")
    else:
        fail(f"{what} set no error bit")
    hid = table.x[:B * cfg.hidden_dim].reshape(B, cfg.hidden_dim)
    for b in range(B):
        nan = bool(torch.isnan(hid[b]).all()) and bool(torch.isnan(row[b]).any())
        fine = bool(torch.isfinite(hid[b]).all())
        if (b == slot and not nan) or (b != slot and not fine):
            fail(f"{what}: slot {b} {'is not NaN' if b == slot else 'is not finite'}")
    if row_stays and not (torch.equal(kk[:, slot], st["kc"][:, slot])
                          and torch.equal(kv[:, slot], st["vc"][:, slot])):
        fail(f"{what}: the slot's cache was written")


def error_bits_phase(bench: StepBench):
    """Out-of-range device values through the persistent kernels (:func:`error_case`)."""
    cases = error_cases(bench)
    for case in cases:
        error_case(bench, *case)
    print(f"K1/K2 error bits: {len(cases)} launches with an out-of-range last_tok, kv_len or "
          f"positional index came back with their bit set and NaN in that slot alone", flush=True)


QUANTS = ("int8", "int4")


def quant_kernel_phase(bench: StepBench):
    """K1 and K2 (B = 2, 4, 6) on the int8 and int4 pages against their quantized twins, each
    also held to a float32 evaluation of the same quantized chain (:meth:`StepBench.compare`):
    caches of 512 and 1024 rows, ragged ``kv_len`` with a frozen slot and the cache's last
    row, repetition penalty on and off; three error bits through each stream; times in turns
    with the bf16 kernel.  Returns {(kernel, quant): (max abs err, times)}."""
    V = bench.cfg.vocab_size
    settings = sampling_settings()
    out = {}
    for quant in QUANTS:
        worst, steps = {"k1": 0.0, "k2": 0.0}, 0
        for S, kv_len, x_len in [(512, 1, 0), (512, 300, 60), (512, 511, 60),
                                 (1024, 512, 60), (1024, 777, 60), (1024, 1023, 60)]:
            last = V - 1 if kv_len % 2 else 17
            st = bench.state(S, [kv_len], [x_len], [last], [5])
            for sa, su, is_plain in settings[:2]:
                where = f"K1 {quant} S={S} kv_len={kv_len} last_tok={last} sa={sa} su={su}"
                worst["k1"] = max(worst["k1"], bench.compare(st, sa, su, is_plain, where, quant))
                steps += 1
        for S in (512, 1024):
            half = S // 2
            for kv_lens in ([0, S - 1], [0, 300, S - 1, half], [0, S - 1, 64, 300, half, 1]):
                B = len(kv_lens)
                x_lens = [40] + [min(60, kv) for kv in kv_lens[1:]]
                st = bench.state(S, kv_lens, x_lens, [17] * (B - 1) + [V - 1],
                                 [5 + 7 * b for b in range(B)])
                for sa, su, is_plain in (settings[0], settings[3]):
                    where = f"K2 {quant} B={B} S={S} kv_len={kv_lens} sa={sa} su={su}"
                    worst["k2"] = max(worst["k2"],
                                      bench.compare(st, sa, su, is_plain, where, quant))
                    steps += 1
        cases = error_cases(bench)
        for case in (cases[0], cases[2], cases[4]):
            error_case(bench, *case, quant=quant)
        sa, su, _ = settings[1]
        k1 = bench.quant_times(f"K1-{quant}", bench.state(1024, [777], [60], [17], [5]), sa, su,
                               1024, quant)
        sa, su, _ = settings[3]
        k2 = bench.quant_times(f"K2-{quant}", bench.state(1024, [777, 761, 790, 770], [60] * 4,
                                                          [17] * 4, [20] * 4), sa, su, 1024, quant)
        out[("k1", quant)], out[("k2", quant)] = (worst["k1"], k1), (worst["k2"], k2)
        print(f"K1/K2 on {quant} pages match their twins on {steps} flagship steps (K2 at B=2, 4, "
              f"6) and set their error bits; max abs err K1 {worst['k1']:.4g}, K2 "
              f"{worst['k2']:.4g} (tolerance {TOL_ABS})", flush=True)
    return out


def barrier_phase(bench: StepBench):
    """What one grid barrier of the persistent kernels costs: loops of empty barriers."""
    from gsv_tts_tpu_torch.ops import fused_step

    costs = {}
    for n in (100, 10000):
        costs[n] = cuda_ms(lambda: fused_step.grid_barrier_loop(bench.table, n), 5)
    bench.table.check()
    per = 1000 * (costs[10000] - costs[100]) / 9900
    print(f"grid barrier: {costs[100]:.4f} ms for 100, {costs[10000]:.4f} ms for 10000 in one "
          f"launch = {per:.3f} us each (132 blocks of 512 threads, nothing between them)",
          flush=True)


# ---------------------------------------------------------------------------
# K3a / K3b: decode attention
# ---------------------------------------------------------------------------

def graph_of(fn, n: int = 50):
    """A CUDA graph of ``n`` calls of ``fn``: replayed, it times the device alone, without the
    wrapper's host cost."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    return graph


def graph_turns(graphs: dict, n: int = 50, reps: int = 20) -> dict:
    """Device ms per call from each of ``graphs`` (name -> a :func:`graph_of` of ``n`` calls),
    timed in turns (a, b, ..., ..., b, a) and averaged over its two turns."""
    order = list(graphs) + list(reversed(graphs))
    ms = {name: 0.0 for name in graphs}
    for name in order:
        ms[name] += cuda_ms(graphs[name].replay, reps) / n / 2
    return ms


class forced_clusters:
    """Within the block, K3's wrapper launches clusters of ``C`` blocks whatever
    ``cluster_plan`` would pick (the plans memoized before and after are dropped)."""

    def __init__(self, C: int):
        from gsv_tts_tpu_torch.ops import flash_decode

        self.fd, self.C = flash_decode, C

    def __enter__(self):
        self.saved = self.fd.cluster_plan
        self.fd.cluster_plan = lambda B, H, S, sms: self.C
        self.fd.launch_plan.cache_clear()

    def __exit__(self, *exc):
        self.fd.cluster_plan = self.saved
        self.fd.launch_plan.cache_clear()


_CU = {}


def _libcuda():
    """libcuda (``libcuda.so.1``), its functions typed on first use."""
    import ctypes

    if not _CU:
        cu = ctypes.CDLL("libcuda.so.1")
        p, vp = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
        for name, args in (("cuStreamBeginCapture_v2", [p, ctypes.c_int]),
                           ("cuStreamEndCapture", [p, vp]),
                           ("cuGraphGetNodes", [p, p, ctypes.POINTER(ctypes.c_size_t)]),
                           ("cuGraphNodeGetType", [p, ctypes.POINTER(ctypes.c_int)]),
                           ("cuGraphKernelNodeGetParams_v2", [p, p]),
                           ("cuKernelGetFunction", [vp, p]),
                           ("cuFuncGetName", [ctypes.POINTER(ctypes.c_char_p), p]),
                           ("cuGraphDestroy", [p])):
            fn = getattr(cu, name)
            fn.argtypes, fn.restype = args, ctypes.c_int

        class KernelNodeParams(ctypes.Structure):  # CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h)
            _fields_ = ([("func", p)] + [(f"dim{i}", ctypes.c_uint) for i in range(7)]
                        + [("kernelParams", p), ("extra", p), ("kern", p), ("ctx", p),
                           ("room", ctypes.c_char * 64)])
        _CU["cu"], _CU["params"] = cu, KernelNodeParams
    return _CU["cu"]


def _cu_ok(rc: int, what: str):
    if rc != 0:
        fail(f"{what} returned CUresult {rc}")


def graph_kernels(fn, calls: int) -> dict:
    """{kernel name: nodes} of a CUDA graph captured around ``calls`` calls of ``fn``: a
    stream capture on a side stream through libcuda, counted node by node and
    destroyed, never launched.  Every launch a call puts on the stream is a node of the
    graph, so nothing is lost as a profiler window can lose events; a node that is not a
    kernel counts under its type.  ``fn`` must be safe to capture (no host read of the
    device), as it is for the CUDA graphs the timings take."""
    import ctypes

    import torch

    cu = _libcuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    torch.cuda.synchronize()
    stream, graph = ctypes.c_void_p(side.cuda_stream), ctypes.c_void_p()
    with torch.cuda.stream(side):
        _cu_ok(cu.cuStreamBeginCapture_v2(stream, 2), "cuStreamBeginCapture")  # relaxed mode
        try:
            for _ in range(calls):
                fn()
        finally:
            _cu_ok(cu.cuStreamEndCapture(stream, ctypes.byref(graph)), "cuStreamEndCapture")
    try:
        n = ctypes.c_size_t(0)
        _cu_ok(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * max(n.value, 1))()
        _cu_ok(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        got = {}
        for i in range(n.value):
            kind = ctypes.c_int(-1)
            _cu_ok(cu.cuGraphNodeGetType(nodes[i], ctypes.byref(kind)), "cuGraphNodeGetType")
            if kind.value == 0:
                prm = _CU["params"]()
                _cu_ok(cu.cuGraphKernelNodeGetParams_v2(nodes[i], ctypes.byref(prm)),
                       "cuGraphKernelNodeGetParams")
                func = ctypes.c_void_p(prm.func)
                if not func.value:
                    _cu_ok(cu.cuKernelGetFunction(ctypes.byref(func), ctypes.c_void_p(prm.kern)),
                           "cuKernelGetFunction")
                name = ctypes.c_char_p()
                _cu_ok(cu.cuFuncGetName(ctypes.byref(name), func), "cuFuncGetName")
                key = name.value.decode()
            else:  # a CUgraphNodeType of cuda.h: 1 memcpy, 2 memset, 3 host, ...
                key = f"graph node of type {kind.value}"
            got[key] = got.get(key, 0) + 1
        return got
    finally:
        _cu_ok(cu.cuGraphDestroy(graph), "cuGraphDestroy")


def device_kernels(fn, calls: int = 10) -> dict:
    """torch.profiler over ``calls`` calls of ``fn`` (after a warm-up window of as many that
    is not recorded): {kernel name: launches} — a printed reading only, since a window may
    lose kernel events (one run recorded 4 of 10 launches of a kernel whose calls all ran,
    another nothing in three windows in a row); the checks count the nodes of a captured
    graph (:func:`graph_kernels`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    got = {}

    def ready(prof):
        got.update({e.key: e.count for e in prof.key_averages()  # (the step's own annotation
                    if "CUDA" in str(getattr(e, "device_type", ""))  # is no kernel)
                    and e.count > 0 and not e.key.startswith("ProfilerStep")})

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return got


def k3_phase(dev, cfg):
    """K3a and K3b vs the twin at ``cfg``'s widths; returns {"k3a"/"k3b": (max abs err, kernel ms,
    twin ms, library ms, bound ms, bound by, extra record fields)}, the times at B=12, S=512."""
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

    def caches(B, S):
        return tuple((torch.randn((L, B, S, H, Dh), generator=gen, device=dev) * 0.5)
                     .to(torch.bfloat16) for _ in range(2))

    plans = {}
    for S in (512, 1024):
        for B, lens in ((1, [S - 1]), (1, [0]), (1, [777 % S]), (4, [0, 63, 64, S - 1]),
                        (12, [0, 63, 64, S - 1, 1, 300, 127, 128, 129, 200, S // 2, 17])):
            kc, vc = caches(B, S)
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
                plans[(B, S)] = fd.launch_plan(
                    True, *(fd.meta(t, t.data_ptr()) for t in (q, kp, vp, kv_len)),
                    fd.sm_count(dev)).C
                for layer in range(L):
                    out = fd.flash_decode_attention_layered(q, kp, vp, kv_len, layer)
                    held("k3b", out, refs[layer], name, f"B={B} S={S} {name} layer {layer}")
                    calls += 1
                if B == 1:  # the largest cluster the kernel takes, whatever the plan picks
                    with forced_clusters(fd.MAX_CLUSTER):
                        for layer in range(L):
                            out = fd.flash_decode_attention_layered(q, kp, vp, kv_len, layer)
                            held("k3b", out, refs[layer], name, f"B=1 S={S} {name} layer {layer} "
                                 f"in clusters of {fd.MAX_CLUSTER}")
                            calls += 1
                for layer in (0, L - 1):
                    out = fd.flash_decode_attention(q, kp[layer], vp[layer], kv_len)
                    held("k3a", out, refs[layer], name, f"B={B} S={S} {name} layer {layer}")
                    calls += 1
                torch.cuda.synchronize()
                fd.check(dev)
    print(f"K3a/K3b: blocks per (slot, head) from cluster_plan on {fd.sm_count(dev)} SMs: "
          f"{', '.join(f'B={B} S={S}: {C}' for (B, S), C in sorted(plans.items()))}", flush=True)

    # times at the generic step's shapes (a 12-slot wave, ~300 rows attended) and at the
    # "flash" engine's (B=1 on a 1024-row cache, ~777 rows)
    out, layer = {}, min(5, L - 1)
    for B, S, lens in ((1, 1024, [777]),
                       (12, 512, [300, 287, 313, 296, 305, 291, 320, 279, 301, 310, 284, 298])):
        kc, vc = caches(B, S)
        q = torch.randn((B, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
        kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = (torch.arange(S, device=dev)[None, :] <= kv_len[:, None])[:, None, None, :]
        k1, v1 = kc[layer], vc[layer]

        def library():  # one PyTorch call computing the same function; timed only
            return F.scaled_dot_product_attention(q[:, :, None, :], k1.permute(0, 2, 1, 3),
                                                  v1.permute(0, 2, 1, 3), attn_mask=mask)

        def k3b():
            return fd.flash_decode_attention_layered(q, kc, vc, kv_len, layer)

        held("k3b", k3b(), library()[:, :, 0], "bfloat16", f"the library call at B={B}")
        kernels = graph_kernels(k3b, 10)
        if sum(kernels.values()) != 10 or len(kernels) != 1:
            fail(f"K3b at B={B}: 10 calls put the device kernels {kernels} in a captured graph, "
                 f"one each is the design")
        profiled = device_kernels(k3b)
        b_ms, b_by = attn_bound(H, Dh, lens, 2)
        twin = lambda: fd.decode_attention_ref(q, k1, v1, kv_len)  # noqa: E731
        if B == 12:  # K3a shares K3b's body: timed where K3b's record is taken
            k_ms, p_ms = timed_turns(lambda: fd.flash_decode_attention(q, k1, v1, kv_len), twin,
                                     200, 50)
            out["k3a"] = (worst["k3a"], k_ms, p_ms, cuda_ms(library, 200), b_ms, b_by, {})
        k_ms, p_ms = timed_turns(k3b, twin, 200, 50)
        lib_ms = cuda_ms(library, 200)
        graphs = {"kernel": graph_of(k3b), "library": graph_of(library)}
        if B == 1:  # the same launch with each cluster size the plan did not pick
            for C in (1, 2, 4, fd.MAX_CLUSTER):
                if C != plans[(B, S)]:
                    with forced_clusters(C):
                        graphs[f"C={C}"] = graph_of(k3b)
        dev_ms = graph_turns(graphs)
        host = host_us(k3b)
        print(f"k3b time B={B} S={S} kv_len~{lens[0]}: clusters of {plans.get((B, S), 1)}; kernel "
              f"{k_ms:.4f} ms a call in turns ({dev_ms['kernel']:.4f} ms on the device, from a "
              f"CUDA graph of 50 launches), plain twin {p_ms:.4f} ms, "
              f"scaled_dot_product_attention "
              f"{lib_ms:.4f} ms a call ({dev_ms['library']:.4f} on the device), bound "
              f"{b_ms:.5f} ms ({b_by})"
              + "".join(f"; forced {k}: {v:.4f} ms on the device" for k, v in dev_ms.items()
                        if k.startswith("C=")), flush=True)
        print(f"k3b device kernels of 10 calls at B={B}: {kernels} (nodes of a captured graph; "
              f"torch.profiler read {profiled}); host {host:.1f} us per call, {host_scale(q)}",
              flush=True)
        if B == 12:
            out["k3b"] = (worst["k3b"], k_ms, p_ms, lib_ms, b_ms, b_by,
                          {"device_ms": dev_ms["kernel"],
                           "library_device_ms": dev_ms["library"], "host_us": host})
    print(f"K3a/K3b match the twin on {calls} calls (B=1, 4, 12; every layer; rows past kv_len "
          f"poisoned; B=1 also in clusters of {fd.MAX_CLUSTER}); max abs err K3a {worst['k3a']:.4g}, K3b {worst['k3b']:.4g}", flush=True)
    return out


# ---------------------------------------------------------------------------
# K4: prefill attention under the hybrid mask
# ---------------------------------------------------------------------------

def k4_row_limits(T, xl, xyl):
    """Columns each of the T rows attends under the hybrid mask."""
    return [min(xl, xyl) if r < xl else (r + 1 if r < xyl else xyl) for r in range(T)]


def k4_err(got, ref):
    """(largest |got - ref| / max(1, |ref|), largest |got - ref|)."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    return float((diff / ref.abs().clamp_min(1.0)).max()), float(diff.max())


def k4_phase(dev, cfg):
    """K4 vs its twin at ``cfg``'s widths (and at head dims 8 and 128); returns (max abs err,
    kernel ms, twin ms, library ms, bound ms, bound by, extra record fields), the times at B=1,
    T=512."""
    import torch
    import torch.nn.functional as F

    from gsv_tts_tpu_torch.ops import flash_prefill as fp
    from gsv_tts_tpu_torch.ops import fused_step

    H, Dh, D = cfg.num_heads, cfg.head_dim, cfg.hidden_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    worst, calls = 0.0, 0

    def views(B, T, dtype, H=H, Dh=Dh):
        qkv = (torch.randn((B, T, 3 * H * Dh), generator=gen, device=dev) * 0.7).to(dtype)
        return tuple(t.reshape(B, T, H, Dh) for t in qkv.split(H * Dh, dim=-1))

    def i32(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def held(B, T, dtype, xl, xyl, H=H, Dh=Dh):
        nonlocal worst, calls
        q, k, v = views(B, T, dtype, H, Dh)
        if q.is_contiguous():
            fail("K4's inputs are meant to be strided views")
        name = str(dtype).split(".")[1]
        ref = fp.flash_prefill_attention_ref(q, k, v, i32(xl), i32(xyl), num_heads=H)
        out = fp.flash_prefill_attention(q, k, v, i32(xl), i32(xyl), num_heads=H)
        torch.cuda.synchronize()
        fused_step.check(dev)
        err, abs_err = k4_err(out, ref)
        if not bool(torch.isfinite(out.float()).all()) or err > K4_TOL[name]:
            fail(f"k4 differs from its twin by {err:.4g} (tolerance {K4_TOL[name]}) at "
                 f"B={B} T={T} H={H} Dh={Dh} {name} x_lens={xl} xy_lens={xyl}")
        if dtype == torch.bfloat16:
            worst = max(worst, abs_err)
        calls += 1

    # T=192 with 60 / 160 is what the engine paths below give the kernel: a
    # 60-phoneme, 100-token prompt padded to 64 + 128 rows
    for T in (160, 192, 512, 1024):
        cases = [(1, [1], [T]), (1, [T], [T]), (1, [T // 3], [T - 37]), (1, [1], [2]),
                 (1, [60], [160]),
                 (4, [1, T, T // 3, 1], [T, T, T - 37, 2]),
                 (4, [60, T // 2, 7, T - 1], [T - 5, T // 2 + 1, T, T])]
        for B, xl, xyl in cases:
            for dtype in (torch.bfloat16, torch.float32) if T == 160 else (torch.bfloat16,):
                held(B, T, dtype, xl, xyl)
    # lengths on and beside the 16- and 64-row tile edges: every (x_len, xy_len) pair
    edges = [15, 16, 17, 63, 64, 65]
    for T in (160, 512):
        for shift in range(len(edges)):
            held(len(edges), T, torch.bfloat16, edges, edges[shift:] + edges[:shift])
    # the narrowest and the widest head (Dh=8 pads the tensor cores' depth)
    for hd, nh in ((8, 16), (128, 4)):
        for T in (160, 512):
            held(4, T, torch.bfloat16, [60, T // 2, 7, T - 1], [T - 5, T // 2 + 1, T, T],
                 H=nh, Dh=hd)

    record = None
    for T, xl, xyl in ((160, 60, 150), (512, 200, 480)):
        q, k, v = views(1, T, torch.bfloat16)
        lx, lxy = i32([xl]), i32([xyl])
        mask = fp.hybrid_mask(T, lx, lxy)[:, None]
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))

        def library():  # one PyTorch call computing the same function; timed only
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        def k4():
            return fp.flash_prefill_attention(q, k, v, lx, lxy, num_heads=H)

        err, _ = k4_err(k4(), library().permute(0, 2, 1, 3).reshape(1, T, D))
        if err > K4_TOL["bfloat16"]:
            fail(f"k4 differs from the library call by {err:.4g} at T={T}")
        k_ms, p_ms = timed_turns(
            k4, lambda: fp.flash_prefill_attention_ref(q, k, v, lx, lxy, num_heads=H), 200, 50)
        lib_ms = cuda_ms(library, 200)
        # q, k, v read and the output written once (bf16), the lengths; QK and PV
        # only for the columns each row attends
        pairs = sum(k4_row_limits(T, xl, xyl))
        b_ms, b_by = bound(4 * T * D * 2 + 8, 4 * Dh * H * pairs)
        # the kernels alone, without the wrapper's host cost: 50 launches replayed from a CUDA
        # graph, the kernel and the library call in turns
        dev_ms = graph_turns({"tensor cores": graph_of(k4), "library": graph_of(library)})
        host = host_us(k4)
        print(f"k4 time B=1 T={T} x_len={xl} xy_len={xyl}: kernel {k_ms:.4f} ms a call in turns "
              f"({dev_ms['tensor cores']:.4f} ms on the device, from a CUDA graph of 50 launches, "
              f"{100 * b_ms / dev_ms['tensor cores']:.1f} % of the bound; host {host:.1f} us per "
              f"call), plain twin {p_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms "
              f"a call "
              f"({dev_ms['library']:.4f} on the device), bound {b_ms:.5f} ms ({b_by}); "
              f"{host_scale(q)}", flush=True)
        record = (worst, k_ms, p_ms, lib_ms, b_ms, b_by,
                  {"device_ms": dev_ms["tensor cores"],
                   "library_device_ms": dev_ms["library"], "host_us": host})
    # like against like: both on the device alone, from the same graph_turns
    if record[6]["device_ms"] >= record[6]["library_device_ms"]:
        fail(f"K4 at T=512 takes {record[6]['device_ms']:.4f} ms on the device, the library call "
             f"{record[6]['library_device_ms']:.4f}")
    print(f"K4 matches its twin on {calls} calls (B=1, 4, 6; T=160, 192, 512, 1024; head dims 8, "
          f"{Dh}, 128; strided views; ragged lengths, on and beside the tile edges); max abs err "
          f"{worst:.4g} (bf16 tolerance {K4_TOL['bfloat16']} of max(1, |twin|))", flush=True)
    return record


def prefill_times(bench):
    """Wall time of ``prefill_batch`` (all layers, first token) with the plain attention and
    with K4, at T = 160 and 512."""
    import torch

    from gsv_tts_tpu_torch.ops.sampling import gumbel_noise
    from gsv_tts_tpu_torch.runtime import t2s_session as ts

    cfg, dev = bench.cfg, bench.dev
    sa = ts.SampleArgs()
    for lx, ly in ((60, 90), (200, 280)):
        Lx, Ly = ts._round_up(lx, 32), ts._round_up(ly, 32)
        x = torch.randint(1, cfg.phoneme_vocab_size, (1, Lx), generator=bench.dgen, device=dev)
        y = torch.randint(0, cfg.vocab_size - 1, (1, Ly), generator=bench.dgen, device=dev)
        bert = torch.randn((1, Lx, cfg.bert_dim), generator=bench.dgen, device=dev) * 0.1
        shape = (cfg.num_layers, 1, 1024, cfg.num_heads, cfg.head_dim)
        kc = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        vc = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        g = gumbel_noise((1, cfg.vocab_size), bench.dgen, dev)
        ms = {}
        for impl in ("fused_step", "flash", "flash", "fused_step"):  # plain, K4, K4, plain
            def run():
                ts.prefill_batch(bench.params, cfg, x, y, bert, lx, ly, kc, vc, g, sa, True,
                                 torch.bfloat16, impl)
            for _ in range(3):
                run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                run()
            torch.cuda.synchronize()
            ms.setdefault(impl, []).append(100 * (time.perf_counter() - t0))
        print(f"prefill_batch T={Lx + Ly} (x_len {lx}, y_len {ly}): plain attention "
              f"{sum(ms['fused_step']) / 2:.3f} ms, K4 {sum(ms['flash']) / 2:.3f} ms (host wall "
              f"clock, mean of two turns of 10)", flush=True)


# ---------------------------------------------------------------------------
# K5 and K6: the layers without embedding, head and sampling
# ---------------------------------------------------------------------------

def layers_bound(cfg, n_layers, kv_lens, x_bytes):
    """Bound of ``n_layers`` layers for rows at ``kv_lens`` (K5: all layers, one row; K6: one
    layer): every weight read once whatever B is; per row its hidden row in and out, the
    attended cache rows (K and V, bf16), the appended row and its length."""
    D, M = cfg.hidden_dim, cfg.hidden_dim * cfg.mlp_ratio
    n_w = n_layers * (4 * D * D + 2 * D * M)
    small = n_layers * (2 * (3 * D + D + M + D) + 4 * 4 * D)
    per_row = sum(2 * x_bytes * D + n_layers * (4 * kv * D + 4 * D) + 4 for kv in kv_lens)
    flops = 2 * len(kv_lens) * n_w + sum(4 * n_layers * (kv + 1) * D for kv in kv_lens)
    return bound(2 * n_w + small + per_row, flops)


def one_kernel_a_launch(name, fn, calls, per_call):
    """Fail unless ``calls`` calls of ``fn`` put ``per_call`` device kernels each, all of
    them the persistent kernel, in a graph captured around them (:func:`graph_kernels`);
    torch.profiler's count of the same calls is printed beside it."""
    got = graph_kernels(fn, calls)
    if sum(got.values()) != calls * per_call or not all("decode_step_persistent" in k
                                                        for k in got):
        fail(f"{name}: {calls} calls put the device kernels {got} in a captured graph, "
             f"expected {per_call} persistent kernel(s) a call")
    print(f"{name}: {calls} calls, {sum(got.values())} persistent kernel nodes in a captured "
          f"graph; torch.profiler read {device_kernels(fn, calls)}",
          flush=True)
    return got


def poisoned_view(t, pad):
    """``t`` as the leading rows of a buffer one row longer whose last row is ``pad``: a
    kernel that reads past the view's end reads it."""
    import torch

    return torch.cat([t, torch.full_like(t[:1], pad)])[:t.shape[0]]


def k5_phase(bench: StepBench):
    """K5 vs its twin; returns (max abs err, kernel ms, twin ms, bound ms, bound by, extras),
    the times at S=1024, kv_len 777."""
    import torch

    from gsv_tts_tpu_torch.ops import fused_step

    cfg, dev = bench.cfg, bench.dev
    layers, layers32 = bench.params["layers"], bench.params32["layers"]
    worst, calls, times = 0.0, 0, None
    for S, kv_len in [(512, 0), (512, 300), (512, 511), (1024, 0), (1024, 777), (1024, 1023)]:
        st = bench.state(S, [kv_len], [0], [17], [5])
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((1, cfg.hidden_dim), generator=bench.dgen, device=dev).to(dtype)
            where = f"K5 S={S} kv_len={kv_len} x {dtype}"
            ka, va = st["kc"].clone(), st["vc"].clone()
            h, _, _ = fused_step.fused_decode_step(x, layers, ka, va, st["kv"],
                                                   table=bench.table)
            kb, vb = st["kc"].clone(), st["vc"].clone()
            rh, _, _ = fused_step.fused_decode_step_ref(x, layers, kb, vb, st["kv"])
            fh, _, _ = fused_step.fused_decode_step_ref(x.float(), layers32, st["kc"].float(),
                                                        st["vc"].float(), st["kv"])
            torch.cuda.synchronize()
            fused_step.check(dev)
            if h.dtype != dtype:
                fail(f"K5 returned {h.dtype} at {where}")
            worst = max(worst, check_close("hidden", h.float(), rh.float(), fh, where))
            for name, a, r, orig in (("K", ka, kb, st["kc"]), ("V", va, vb, st["vc"])):
                e = float((a[:, 0, kv_len].float() - r[:, 0, kv_len].float()).abs().max())
                worst = max(worst, e)
                if e > TOL_ABS:
                    fail(f"appended {name} rows differ by {e:.4g} at {where}")
                if not (torch.equal(a[:, 0, :kv_len], orig[:, 0, :kv_len])
                        and torch.equal(a[:, 0, kv_len + 1:], orig[:, 0, kv_len + 1:])):
                    fail(f"{name} cache rows other than kv_len were modified at {where}")
            calls += 1
        if (S, kv_len) == (1024, 777):
            x = x.to(torch.bfloat16)
            ka, va = st["kc"].clone(), st["vc"].clone()

            def kernel():
                fused_step.fused_decode_step(x, layers, ka, va, st["kv"], table=bench.table)

            k_ms, p_ms = timed_turns(
                kernel, lambda: fused_step.fused_decode_step_ref(x, layers, ka, va, st["kv"]),
                50, 10)
            dev_ms = graph_turns({"kernel": graph_of(kernel, 20)}, 20)
            one_kernel_a_launch("K5", kernel, 10, 1)
            host = host_us(kernel)
            times = (k_ms, p_ms) + layers_bound(cfg, cfg.num_layers, [kv_len], 2) + (dict(
                device_ms=dev_ms["kernel"], host_us=host),)
            print(f"k5 time S={S} kv_len={kv_len}: persistent kernel {k_ms:.4f} ms a call "
                  f"({dev_ms['kernel']:.4f} on the device), plain twin {p_ms:.4f} ms, bound "
                  f"{times[2]:.4f} ms ({times[3]}); host {host:.1f} us per call; one device "
                  f"kernel a call (a captured graph's nodes); device times from CUDA graphs "
                  f"of 20 calls replayed; {host_scale(x)}", flush=True)
    # a kv_len past the cache: the bit, NaN, no append, and the kernel comes back
    st = bench.state(512, [300], [0], [17], [5])
    ka, va = st["kc"].clone(), st["vc"].clone()
    h, _, _ = fused_step.fused_decode_step(x, layers, ka, va, st["kv"] + 212, table=bench.table)
    if not returned_within(30.0):
        fail("K5 did not come back from kv_len = S")
    try:
        fused_step.check(dev)
    except RuntimeError as e:
        if "kv_len" not in str(e) or "gave up" in str(e):
            fail(f"K5 with kv_len = S raised {e}")
    else:
        fail("K5 with kv_len = S set no error bit")
    if not (bool(torch.isnan(h.float()).all()) and torch.equal(ka, st["kc"])
            and torch.equal(va, st["vc"])):
        fail("K5 with kv_len = S: the row is not NaN or the cache was written")
    print(f"K5 matches its twin on {calls} flagship calls (S=512, 1024; kv_len 0, mid, S-1; bf16 "
          f"and float32 rows); kv_len = S sets its bit with NaN and no append; max abs err "
          f"{worst:.4g} (tolerance {TOL_ABS})", flush=True)
    return (worst,) + times


def k6_phase(bench: StepBench):
    """K6 vs its twin; returns (max abs err, kernel ms, twin ms, bound ms, bound by, extras),
    the times at B=1, S=1024, kv_len 777."""
    import torch

    from gsv_tts_tpu_torch.ops import fused_layer, fused_step

    cfg, dev = bench.cfg, bench.dev
    L = cfg.num_layers
    layers, layers32 = bench.params["layers"], bench.params32["layers"]
    worst, calls = 0.0, 0
    for S in (512, 1024):
        # groups of 3, 5 and 3 (after 8) run at the kernel's next row count with dead rows
        waves = {1: [S - 1], 3: [0, S - 1, 300], 4: [0, 300, S - 1, S // 2],
                 5: [S - 1, 0, 63, 64, S // 2],
                 8: [0, 1, 63, 64, 300, S // 2, S - 200, S - 1],
                 11: [0, 63, 64, S - 1, 1, 300, 127, 128, 129, 200, S // 2],
                 12: [0, 63, 64, S - 1, 1, 300, 127, 128, 129, 200, S // 2, 17]}
        for B, kv_lens in waves.items():
            st = bench.state(S, kv_lens, [0] * B, [17] * B, [5] * B)
            # x and kv_len end where the wave does: the next row (NaN) and length (past the
            # cache, which would set the error bit) belong to no row, dead or alive
            x = poisoned_view(torch.randn((B, cfg.hidden_dim), generator=bench.dgen,
                                          device=dev).to(torch.bfloat16), float("nan"))
            kv = poisoned_view(st["kv"], S + 7)
            # rows past kv_len[b] must never be read: poison them (row kv_len[b]
            # itself is the one the call writes)
            kp, vp = st["kc"].clone(), st["vc"].clone()
            for b, n in enumerate(kv_lens):
                kp[:, b, n:] = float("nan")
                vp[:, b, n:] = float("nan")
            before = fused_layer.fused_decode_layer.launches
            picked = range(L) if S == 512 or B == 4 else (0, L // 2, L - 1)
            for layer in picked:
                where = f"K6 B={B} S={S} layer {layer} kv_len={kv_lens}"
                ka, va = kp.clone(), vp.clone()
                h, _, _ = fused_layer.fused_decode_layer(x, layers[layer], ka, va, kv, layer,
                                                         table=bench.table)
                kb, vb = st["kc"].clone(), st["vc"].clone()
                rh, _, _ = fused_layer.fused_decode_layer_ref(x, layers[layer], kb, vb, kv,
                                                              layer)
                fh, _, _ = fused_layer.fused_decode_layer_ref(
                    x.float(), layers32[layer], st["kc"].float(), st["vc"].float(), kv, layer)
                torch.cuda.synchronize()
                fused_step.check(dev)
                worst = max(worst, check_close("hidden", h.float(), rh.float(), fh, where))
                for name, a, r, orig in (("K", ka, kb, kp), ("V", va, vb, vp)):
                    want = orig.clone()
                    for b, n in enumerate(kv_lens):
                        e = float((a[layer, b, n].float() - r[layer, b, n].float()).abs().max())
                        worst = max(worst, e)
                        if not e <= TOL_ABS:
                            fail(f"appended {name} row differs by {e:.4g} at {where} row {b}")
                        want[layer, b, n] = a[layer, b, n]
                    # bit for bit (the poisoned rows are NaN, never equal as numbers)
                    if not torch.equal(a.view(torch.int16), want.view(torch.int16)):
                        fail(f"{name} cache entries other than the appended rows changed at "
                             f"{where}")
                calls += 1
            groups = -(-B // fused_step.MAX_FUSED_B)
            if fused_layer.fused_decode_layer.launches - before != groups * len(picked):
                fail(f"K6 at B={B}: {fused_layer.fused_decode_layer.launches - before} launches "
                     f"for {len(picked)} calls of {groups} groups")
    times = {}
    for B, kv_lens in ((4, [777, 761, 790, 770]), (1, [777]), (12, [777, 761, 790, 770] * 3)):
        st = bench.state(1024, kv_lens, [0] * B, [17] * B, [5] * B)
        x = torch.randn((B, cfg.hidden_dim), generator=bench.dgen, device=dev).to(torch.bfloat16)
        ka, va = st["kc"].clone(), st["vc"].clone()

        def walk(fn, table=True):
            """One call a layer, the layers in turn as the "fused" path takes them: each call
            finds its layer's 6.3 MB of weights out of L2."""
            at = [0]

            def call():
                layer = at[0] % L
                at[0] += 1
                kw = dict(table=bench.table) if table else {}
                fn(x, layers[layer], ka, va, st["kv"], layer, **kw)
            return call

        kernel = walk(fused_layer.fused_decode_layer)
        k_ms, p_ms = timed_turns(kernel, walk(fused_layer.fused_decode_layer_ref, table=False),
                                 10 * L, L)
        dev_ms = graph_turns({"kernel": graph_of(kernel, 2 * L)}, 2 * L)
        groups = -(-B // fused_step.MAX_FUSED_B)
        one_kernel_a_launch(f"K6 at B={B}", kernel, L, groups)
        host = host_us(kernel, L)
        times[B] = (k_ms, p_ms) + layers_bound(cfg, 1, kv_lens, 2) + (dict(
            device_ms=dev_ms["kernel"], host_us=host),)
        print(f"k6 time B={B} S=1024 kv_len~777, the {L} layers in turn: persistent kernel "
              f"{k_ms:.4f} ms a call ({dev_ms['kernel']:.4f} on the device, {groups} launch(es) "
              f"a call), plain twin {p_ms:.4f} ms, bound {times[B][2]:.5f} ms ({times[B][3]}); "
              f"host {host:.1f} us per call; one device kernel a group (a captured graph's "
              f"nodes); device times from CUDA graphs of {2 * L} calls replayed", flush=True)
    # a kv_len past the cache in a group of 5: that row's bit and NaN, the rest as before
    st = bench.state(512, [10, 150, 300, 0, 511], [0] * 5, [17] * 5, [5] * 5)
    st["kv"][2] = 512
    x = torch.randn((5, cfg.hidden_dim), generator=bench.dgen, device=dev).to(torch.bfloat16)
    ka, va = st["kc"].clone(), st["vc"].clone()
    h, _, _ = fused_layer.fused_decode_layer(x, layers[3], ka, va, st["kv"], 3, table=bench.table)
    if not returned_within(30.0):
        fail("K6 did not come back from kv_len = S")
    try:
        fused_step.check(dev)
    except RuntimeError as e:
        if "kv_len" not in str(e) or "gave up" in str(e):
            fail(f"K6 with kv_len = S raised {e}")
    else:
        fail("K6 with kv_len = S set no error bit")
    if not (bool(torch.isnan(h[2].float()).all()) and bool(torch.isfinite(h[[0, 1, 3, 4]]).all())
            and torch.equal(ka[:, 2], st["kc"][:, 2]) and torch.equal(va[:, 2], st["vc"][:, 2])):
        fail("K6 with kv_len = S in row 2: NaN elsewhere, or the row's cache was written")
    print(f"K6 matches its twin on {calls} flagship calls (B=1, 3, 4, 5, 8, 11, 12: groups with "
          f"dead rows; every layer at S=512; rows past kv_len poisoned, nothing read past the "
          f"wave's x and kv_len, every other cache entry bit for bit); kv_len = S sets its bit "
          f"with NaN in that row alone; max abs err {worst:.4g} (tolerance {TOL_ABS})",
          flush=True)
    return (worst,) + times[1]


def interleave_phase(bench: StepBench):
    """K1, K6 (one row, then a group of 4), K5 and K1 again on the engine's one table, one
    after another: each must give bit for bit what the same call gives alone (one count of
    launches numbers every launch on the table's workspace)."""
    import torch

    from gsv_tts_tpu_torch.ops import fused_layer, fused_step
    from gsv_tts_tpu_torch.ops.sampling import gumbel_noise

    cfg, dev, table = bench.cfg, bench.dev, bench.table
    D, V = cfg.hidden_dim, cfg.vocab_size
    layers = bench.params["layers"]
    sa, su, _ = sampling_settings()[1]
    s1 = bench.state(1024, [777], [60], [17], [20])
    s4 = bench.state(512, [0, 63, 300, 511], [0] * 4, [17] * 4, [5] * 4)
    g = gumbel_noise((1, V), bench.dgen, dev)
    x1 = torch.randn((1, D), generator=bench.dgen, device=dev).to(torch.bfloat16)
    x4 = torch.randn((4, D), generator=bench.dgen, device=dev).to(torch.bfloat16)

    def k1():
        ka, va, kt = s1["kc"].clone(), s1["vc"].clone(), s1["tok_buf"].clone()
        tok, row, _, _ = bench.kernel(s1, ka, va, kt, g, sa, su)
        return [tok.clone(), row.clone(), table.x[:D].clone(), ka, va, kt]

    def k6(x, st, layer):
        ka, va = st["kc"].clone(), st["vc"].clone()
        h, _, _ = fused_layer.fused_decode_layer(x, layers[layer], ka, va, st["kv"], layer,
                                                 table=table)
        return [h, ka, va]

    def k5():
        ka, va = s1["kc"].clone(), s1["vc"].clone()
        h, _, _ = fused_step.fused_decode_step(x1, layers, ka, va, s1["kv"], table=table)
        return [h, ka, va]

    calls = [("K1", k1), ("K6 B=1", lambda: k6(x1, s1, 7)), ("K6 B=4", lambda: k6(x4, s4, 20)),
             ("K5", k5), ("K1", k1)]
    alone = []
    for _, fn in calls:
        alone.append(fn())
        torch.cuda.synchronize()
    together = [fn() for _, fn in calls]
    torch.cuda.synchronize()
    table.check()
    for (name, _), a, b in zip(calls, alone, together):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            fail(f"{name} interleaved with the others on one table differs from its lone call")
    print("K1, K6 (B=1, 4), K5, K1 interleaved on one table: each equals its lone call bit for "
          "bit", flush=True)


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

# the published v2 s2 config (GPT-SoVITS s2.json): 32 kHz, 2048-pt STFT
V2_HPS = {"data": {"sampling_rate": 32000, "filter_length": 2048, "hop_length": 640,
                   "win_length": 2048, "n_mel_channels": 128},
          "model": {"inter_channels": 192, "hidden_channels": 192, "filter_channels": 768,
                    "n_heads": 2, "n_layers": 6, "kernel_size": 3, "p_dropout": 0.1,
                    "resblock": "1", "resblock_kernel_sizes": [3, 7, 11],
                    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
                    "upsample_rates": [10, 8, 2, 2, 2], "upsample_initial_channel": 512,
                    "upsample_kernel_sizes": [16, 16, 8, 2, 2], "gin_channels": 512,
                    "semantic_frame_rate": "25hz", "version": "v2"},
          "train": {"segment_size": 20480}}


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
    scfg = sovits.SovitsConfig.from_hps(V2_HPS["model"], 1025)
    sp = sovits.init_params(scfg, gen)
    sp["dec.conv_post.weight"] *= 10.0  # lift the random vocoder above the trim threshold
    save_trained_sovits(sp, HParams(V2_HPS), root / "s2v2")
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
    """name -> (wrapper, the attribute its launches count in): K1 and K2 count their int8 and
    int4 streams apart from the bf16 one."""
    from gsv_tts_tpu_torch.ops import flash_decode, flash_prefill, fused_layer, fused_step

    k1, k2 = fused_step.fused_decode_step_sample, fused_step.fused_decode_step_sample_batched
    return {"k1": (k1, "launches"), "k2": (k2, "launches"),
            "k1q8": (k1, "launches_q8"), "k1q4": (k1, "launches_q4"),
            "k2q8": (k2, "launches_q8"), "k2q4": (k2, "launches_q4"),
            "k3a": (flash_decode.flash_decode_attention, "launches"),
            "k3b": (flash_decode.flash_decode_attention_layered, "launches"),
            "k4": (flash_prefill.flash_prefill_attention, "launches"),
            "k5": (fused_step.fused_decode_step, "launches"),
            "k6": (fused_layer.fused_decode_layer, "launches")}


def expect_counts(what, counts, **want):
    """Fail unless the launch counts are ``want`` (kernels not named: 0)."""
    want = {name: want.get(name, 0) for name in counts}
    print(f"main path, {what}: launches {counts}", flush=True)
    if counts != want:
        fail(f"{what}: launches {counts}, the path needs {want}")


def reset_counts():
    for fn, attr in launch_counts().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr) for name, (fn, attr) in launch_counts().items()}


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
    steps, rtf = 0, 0.0
    for i, text in enumerate(TEXTS[:2]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip = tts.infer(str(spk), str(prompt), PROMPT_TEXT, text)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = tts.last_timings
        steps += st["decode_steps"]
        rtf = wall / clip.audio_len_s  # the last request's: the warm one
        check_audio(f"infer request {i}", clip.audio_data, int(0.2 * 32000),
                    st["tokens"] * 1280 + int(0.2 * 32000))
        print(f"infer request {i}: {st['tokens']} tokens, {st['decode_steps']} decode steps in "
              f"{st['decode_s']:.3f} s = {st['decode_steps'] / st['decode_s']:.1f} tok/s, "
              f"{1000 * st['decode_s'] / st['decode_steps']:.3f} ms/step; prefill "
              f"{1000 * st['prefill_s']:.1f} ms, SoVITS {st['sovits_s']:.3f} s (CUDA graphs: "
              f"{st['sovits_graphs']} captured in {st['sovits_capture_s']:.3f} s, "
              f"{st['sovits_replays']} replayed); "
              f"{clip.audio_len_s:.2f} s of audio in {wall:.3f} s, RTF "
              f"{wall / clip.audio_len_s:.4f}", flush=True)
        if st["sovits_replays"] != 2:  # the padded core and the flow bucket
            fail(f"infer request {i}: {st['sovits_replays']} SoVITS graph replays, not 2")
    counts = read_counts()
    if steps == 0:
        fail("infer took no decode step")
    expect_counts(f"infer ({steps} decode steps)", counts, k1=steps)
    return counts, rtf


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
    expect_counts(f"infer_batched of {n}", counts, k1=st["k1_steps"], k2=st["k2_steps"],
                  k3b=st["generic_steps"] * layers)
    return counts, st


def random_prompt(cfg, lx, ly, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    return (rng.randint(1, cfg.phoneme_vocab_size, lx), rng.randint(0, cfg.vocab_size - 1, ly),
            (rng.randn(lx, cfg.bert_dim) * 0.1).astype(np.float32))


def engine_path(gpt_path, dev, impl, lx, ly, min_steps):
    """``T2SEngine(attn_impl=impl).generate`` at B=1 on a 512-row cache, once to warm up and
    once counted; returns the launch counts."""
    import torch

    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_gpt_weights

    engine = get_gpt_weights(gpt_path, Config(device=dev, gpt_cache=[(1, 512)],
                                              attn_impl=impl)).engine
    L = engine.cfg.num_layers
    # random weights may sample EOS early: take the first seed whose run is long enough
    for seed in range(SEED, SEED + 4):
        x, y, bert = random_prompt(engine.cfg, lx, ly, seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        engine.generate(x, y, bert, generator=gen)
        reset_counts()
        torch.cuda.synchronize()
        toks = engine.generate(x, y, bert, generator=gen)
        torch.cuda.synchronize()
        counts, st = read_counts(), engine.last_stats
        if st["decode_steps"] >= min_steps:
            break
    else:
        fail(f'attn_impl="{impl}": no run of {min_steps} decode steps in four seeds')
    steps = st["decode_steps"]
    print(f'T2SEngine(attn_impl="{impl}").generate, B=1, prompt {lx}+{ly}: {toks.size} tokens, '
          f"{steps} decode steps in {st['decode_s']:.3f} s = "
          f"{1000 * st['decode_s'] / steps:.3f} ms/step; prefill {1000 * st['prefill_s']:.2f} ms",
          flush=True)
    if impl == "flash":
        expect_counts(f'attn_impl="flash" ({steps} steps, 1 prefill)', counts, k4=L,
                      k3b=L * steps)
    else:
        expect_counts(f'attn_impl="fused" ({steps} steps)', counts, k6=L * steps)
    return counts


def k5_loop_path(gpt_path, dev, n_steps=120, n_held=32):
    """A greedy decode loop at B=1 through ``transformer_decode_step`` under ``"fused_step"``
    (embedding -> K5 -> head -> sampling, the engine's generic step) after a plain prefill.
    Then the ``"flash"`` route (PyTorch layers around K3b) takes the first ``n_held`` steps
    from the same states: two bf16 routes may pick different tokens at a near-tie, so at
    least 7 of 8 must agree.  Returns the launch counts of the K5 loop."""
    import dataclasses

    import torch

    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_gpt_weights
    from gsv_tts_tpu_torch.runtime import t2s_session as ts

    engine = get_gpt_weights(gpt_path, Config(device=dev, gpt_cache=[(1, 512)])).engine
    cfg, params, dtype = engine.cfg, engine.params, engine.dtype
    x, y, bert = random_prompt(cfg, 60, 100, SEED)
    xp, yp, bp = engine._pad_prompt(x, y, bert)
    k_cache, v_cache = engine._alloc_cache(1, 512)
    sa = ts.SampleArgs(top_k=1)
    g = torch.zeros((1, cfg.vocab_size), device=dev)
    state, _ = ts.prefill_batch(params, cfg, *engine._dev(xp[None], yp[None], bp[None]), len(x),
                                len(y), k_cache, v_cache, g, sa, True, dtype)
    toks = torch.empty((n_steps, 1), dtype=torch.int32, device=dev)

    def step(st, out, impl):
        ts._generic_step(params, cfg, st, g, sa, ts.INITIAL_SUPPRESSION_STEPS, dtype, out, impl)

    def snapshot(st):
        return dataclasses.replace(st, **{f.name: getattr(st, f.name).clone()
                                          for f in dataclasses.fields(st)})

    held = []
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_steps):
        if i < n_held:
            held.append(snapshot(state))
        step(state, toks[i], "fused_step")
        state.last_tok = toks[i]
        for t in (state.kv_len, state.buf_len, state.step_idx):
            t += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    engine._check_kernels()
    print(f'transformer_decode_step(attn_impl="fused_step") loop, B=1: {n_steps} steps in '
          f"{wall:.3f} s = {1000 * wall / n_steps:.3f} ms/step ({n_held} of them with a state "
          f"snapshot)", flush=True)
    expect_counts(f"K5 loop ({n_steps} steps)", counts, k5=n_steps)
    other = torch.empty((n_held, 1), dtype=torch.int32, device=dev)
    for i, st in enumerate(held):
        step(st, other[i], "flash")
    same = int((other == toks[:n_held]).sum())
    print(f'K5 loop: {same} of {n_held} greedy tokens equal the "flash" route\'s from the same '
          f"states", flush=True)
    if same * 8 < n_held * 7:
        fail(f'K5 loop: only {same} of {n_held} tokens equal the "flash" route\'s')
    return counts


def stream_path(models_dir, gpt, sov, spk, prompt, dev, attn_impl, texts, warm_rtf):
    """``TTS.infer_stream`` once per text on an engine under ``attn_impl`` (one segment a
    text, chunks of 25 tokens, the first sent at once); returns the launch counts."""
    import numpy as np
    import torch

    from gsv_tts_tpu_torch import TTS

    tts = TTS(gpt_cache=[(1, 512)], models_dir=models_dir, device=dev, seed=SEED,
              attn_impl=attn_impl)
    tts.load_gpt_model(str(gpt))
    tts.load_sovits_model(str(sov))
    L = tts.gpt_models[str(gpt)].engine.cfg.num_layers
    reset_counts()
    steps = 0
    for i, text in enumerate(texts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clips = list(tts.infer_stream(str(spk), str(prompt), PROMPT_TEXT, text, is_cut_text=False))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = tts.last_timings
        steps += st["decode_steps"]
        what = f'infer_stream (attn_impl="{attn_impl}") request {i}'
        if len(clips) < 2:
            fail(f"{what}: {len(clips)} chunk(s), a stream has more than one")
        for clip in clips:
            if clip.audio_data.dtype != np.float32 or not np.all(np.isfinite(clip.audio_data)):
                fail(f"{what}: a chunk is not finite float32")
        audio = np.concatenate([c.audio_data for c in clips])
        mute = int(0.4 * 2.0 * 32000)  # the longest pause appended after a segment
        # (a stream is not peak-normalised: its chunks leave before the peak is known)
        if not 0.25 * st["decode_steps"] * 1280 < audio.size <= st["decode_steps"] * 1280 + mute:
            fail(f"{what}: {audio.size} samples for {st['decode_steps']} decode steps")
        print(f"{what}: {len(clips)} chunks, {st['decode_steps']} decode steps, time to first "
              f"audio {1000 * st['ttfa_s']:.1f} ms, SoVITS {st['sovits_s']:.3f} s (CUDA graphs: "
              f"{st['sovits_graphs']} captured in {st['sovits_capture_s']:.3f} s, "
              f"{st['sovits_replays']} replayed), "
              f"{len(audio) / 32000:.2f} s of audio in {wall:.3f} s, RTF "
              f"{wall / (len(audio) / 32000):.4f} (warm infer RTF {warm_rtf:.4f})", flush=True)
        if st["sovits_replays"] != len(clips):  # one fused chunk program a chunk
            fail(f"{what}: {st['sovits_replays']} SoVITS graph replays for {len(clips)} chunks")
    counts = read_counts()
    if attn_impl == "flash":
        expect_counts(f"infer_stream under flash ({steps} steps, {len(texts)} prefills)", counts,
                      k4=L * len(texts), k3b=L * steps)
    else:
        expect_counts(f"infer_stream ({steps} steps)", counts, k1=steps)
    return counts


def graph_pool_bytes(pool) -> int:
    """Bytes a CUDA graph memory pool holds (its peak: a graph
    pool keeps its blocks while its graphs live); 0 when the allocator's
    snapshot names no segment of it."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory._snapshot()["segments"]
               if pool is not None and tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def held_to_eager(what, got, want):
    """Graph replay against the eager run of the same program: bf16 on the
    same kernels, so equal but for a reduction order cuDNN may pick anew —
    held to 2^-6 of max(1, |eager|)."""
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    scale = max(1.0, max(float(w.float().abs().max()) for w in want))
    print(f"sovits buckets: {what}: max abs diff graph replay vs eager {err:.3g}", flush=True)
    if not err <= scale / 64:
        fail(f"{what}: graph replay differs from eager by {err} (scale {scale})")


def sovits_buckets_phase(models_dir, gpt, sov, spk, prompt, dev, card):
    """The default SoVITS path (``sovits_cache=[50, 55]``, ``stream_vocoder="bucketed"``):
    two equal ``infer`` requests, the second capturing no graph; a padded core captured at
    one length and replayed at another of its bucket, and a fused stream chunk, each against
    eager; ``sovits_s`` and the stream's warm time to first audio under "bucketed" and
    "exact" in turns; ``speed=0.8``; subtitles; the graphs and their pool.  Returns the
    launch counts of its requests (K1: one per decode step)."""
    import functools

    import numpy as np
    import torch

    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.models import sovits as sovits_model
    from gsv_tts_tpu_torch.runtime.vocoder_batch import stream_batch_fused
    from gsv_tts_tpu_torch.tts import SovitsGraphs

    def facade(**kw):
        tts = TTS(gpt_cache=[(1, 512)], models_dir=models_dir, device=dev, seed=SEED, **kw)
        tts.load_gpt_model(str(gpt))
        tts.load_sovits_model(str(sov))
        return tts

    def infer(tts, text, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip = tts.infer(str(spk), str(prompt), PROMPT_TEXT, text, top_k=1, **kw)
        torch.cuda.synchronize()
        return clip, dict(tts.last_timings, wall_s=time.perf_counter() - t0)

    def stream(tts, text):
        clips = list(tts.infer_stream(str(spk), str(prompt), PROMPT_TEXT, text, top_k=1,
                                      is_cut_text=False))
        torch.cuda.synchronize()
        return clips, dict(tts.last_timings)

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    tts = facade()
    steps = 0
    reset_counts()
    for i in range(2):
        clip, st = infer(tts, TEXTS[3])
        steps += st["decode_steps"]
        check_audio(f"sovits buckets: infer {i}", clip.audio_data, int(0.2 * 32000),
                    st["tokens"] * 1280 + int(0.2 * 32000))
        print(f"sovits buckets: infer {i} ({st['tokens']} tokens): SoVITS {st['sovits_s']:.4f} s, "
              f"CUDA graphs {st['sovits_graphs']} captured in {st['sovits_capture_s']:.3f} s, "
              f"{st['sovits_replays']} replayed", flush=True)
    if st["sovits_graphs"] != 0 or st["sovits_replays"] != 2:
        fail(f"sovits buckets: the second equal infer captured {st['sovits_graphs']} graph(s), "
             f"replayed {st['sovits_replays']}: it should replay the first's two")

    # one padded core captured at one length and replayed at another of its bucket
    sovits = tts.sovits_models[str(sov)]
    cfg, p = sovits.cfg, sovits.params
    ge = tts.spk_audio_cache[str(spk)]["ge"][str(sov)].to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    core = functools.partial(sovits_model.decode_core_stream_padded, p, cfg, overlap_len=1,
                             blend=False)

    def core_inputs(n, N):
        i64 = dict(dtype=torch.int64, device=dev)
        codes = torch.zeros((1, 1, 64), **i64)
        codes[..., :n] = torch.randint(0, 1024, (n,), generator=gen, **i64)
        text = torch.zeros((1, 32), **i64)
        text[:, :N] = torch.randint(1, 700, (N,), generator=gen, **i64)
        noise = torch.randn((1, cfg.inter_channels, 128), generator=gen, device=dev) * 0.5
        return (codes, torch.tensor(n, **i64), text, torch.tensor(N, **i64), ge,
                noise.to(torch.bfloat16),
                torch.zeros((1, cfg.hidden_channels, 1), dtype=torch.bfloat16, device=dev),
                torch.tensor(0, **i64))

    graphs = SovitsGraphs()
    with torch.no_grad():
        graphs.run(p, ("core",), core, *core_inputs(40, 20))
        ins = core_inputs(57, 27)
        got, want = graphs.run(p, ("core",), core, *ins), core(*ins)
        held_to_eager("padded core captured at n=40, N=20, replayed at n=57, N=27",
                      [got[0][..., :114], got[2][..., :114, :27], got[3]],
                      [want[0][..., :114], want[2][..., :114, :27], want[3]])
        if not torch.equal(got[1], want[1]):
            fail("sovits buckets: the replayed core's mask differs from eager")
        # a fused stream chunk (core, flow bucket, HiFi-GAN), blended and not
        bucket = tts._flow_bucket(84)
        chunk = functools.partial(stream_batch_fused, p, cfg, overlap_len=5, bucket=bucket)
        for n, vsi, blend in ((45, 6, True), (50, 16, False)):
            c = core_inputs(n, 30)
            ins = (c[0], c[1].reshape(1), c[2], c[3].reshape(1), ge, c[5],
                   torch.randn((1, cfg.hidden_channels, 5), generator=gen,
                               device=dev).to(torch.bfloat16),
                   torch.tensor([vsi], device=dev), torch.tensor([blend], device=dev))
            got, want = graphs.run(p, ("chunk",), chunk, *ins), chunk(*ins)
            t_valid = 2 * n - vsi
            held_to_eager(f"stream chunk (bucket {bucket}) at n={n}, vsi={vsi}, blend={blend}",
                          [got[0][..., :t_valid * cfg.samples_per_frame],
                           got[1][..., :2 * n, :30], got[2]],
                          [want[0][..., :t_valid * cfg.samples_per_frame],
                           want[1][..., :2 * n, :30], want[2]])
    if graphs.captures != 2 or graphs.replays != 4:
        fail(f"sovits buckets: {graphs.captures} captures, {graphs.replays} replays (2, 4)")
    del graphs

    # sovits_s and the stream's warm time to first audio, both vocoder modes in turns
    exact = facade(stream_vocoder="exact")
    modes = {"bucketed": tts, "exact": exact}
    for name, t in modes.items():  # warm: graphs captured, kernels' first launches paid
        steps += infer(t, TEXTS[0])[1]["decode_steps"] + stream(t, TEXTS[1])[1]["decode_steps"]
    for turn, name in enumerate(("bucketed", "exact", "exact", "bucketed") * 2):
        t = modes[name]
        clip, st = infer(t, TEXTS[0])
        clips, sst = stream(t, TEXTS[1])
        steps += st["decode_steps"] + sst["decode_steps"]
        if len(clips) < 2 or not all(np.all(np.isfinite(c.audio_data)) for c in clips):
            fail(f"sovits buckets: {name} stream of {len(clips)} chunk(s), or not finite")
        print(f"sovits buckets: turn {turn}, {name}: infer ({st['tokens']} tokens) sovits_s "
              f"{1000 * st['sovits_s']:.2f} ms (graphs {st['sovits_graphs']} captured, "
              f"{st['sovits_replays']} replayed), wall {1000 * st['wall_s']:.1f} ms; "
              f"infer_stream ({len(clips)} chunks) warm time to first audio "
              f"{1000 * sst['ttfa_s']:.1f} ms, sovits_s {1000 * sst['sovits_s']:.2f} ms "
              f"({1000 * sst['sovits_s'] / len(clips):.2f} ms a chunk; graphs "
              f"{sst['sovits_graphs']} captured, {sst['sovits_replays']} replayed) [{card}]",
              flush=True)
    del exact, modes

    clip1, _ = infer(tts, TEXTS[0])
    clip, st = infer(tts, TEXTS[0], speed=0.8)
    steps += 2 * st["decode_steps"]
    ratio = clip.audio_len_s / clip1.audio_len_s
    print(f"sovits buckets: speed=0.8: {clip.audio_len_s:.2f} s of audio against "
          f"{clip1.audio_len_s:.2f} s at speed 1 (x{ratio:.3f}), SoVITS {st['sovits_s']:.4f} s, "
          f"graphs {st['sovits_graphs']} captured, {st['sovits_replays']} replayed", flush=True)
    check_audio("sovits buckets: speed=0.8", clip.audio_data, int(0.2 * 32000),
                int(st["tokens"] * 1280 / 0.8) + 2 * 1280 + int(0.2 * 32000))
    if not 1.1 < ratio < 1.4:
        fail(f"sovits buckets: speed=0.8 made the audio x{ratio:.3f} as long, not ~1.25")
    clip, st = infer(tts, TEXTS[2], return_subtitles=True)
    steps += st["decode_steps"]
    subs = clip.subtitles
    starts = [sub["start_s"] for sub in subs]
    print(f"sovits buckets: infer(return_subtitles=True): {len(subs)} subtitles, first "
          f"{subs[:2]}, last {subs[-1:]}", flush=True)
    if not subs or starts != sorted(starts) or any(
            sub["end_s"] < sub["start_s"] for sub in subs):
        fail("sovits buckets: subtitles empty or their times decrease")
    counts = read_counts()
    expect_counts(f"sovits buckets ({steps} decode steps)", counts, k1=steps)
    for key, (graph, *_) in sorted(tts.sovits_graphs.graphs.items(), key=lambda kv: kv[0][2:]):
        print(f"sovits buckets: graph {key[0]} {key[2:]}: {cuda_ms(graph.replay, 10):.3f} ms a "
              f"replay on the device", flush=True)
    n_graphs = len(tts.sovits_graphs.graphs)
    pool = sum(graph_pool_bytes(pl) for pl in tts.sovits_graphs.pools.values())
    print(f"sovits buckets: {n_graphs} CUDA graphs on the default facade "
          f"({sorted(k[0] for k in tts.sovits_graphs.graphs)}), their pool "
          f"{pool / 2 ** 20:.1f} MiB; peak allocated over the phase "
          f"{(torch.cuda.max_memory_allocated() - mem0) / 2 ** 20:.1f} MiB above its start "
          f"[{card}]", flush=True)
    return counts


def write_v2pro(root: Path):
    """A full-width random v2ProPlus SoVITS (the published v2 widths with
    ``gin_channels`` 1024: the flow and HiFi-GAN take ``ge`` at 1024, MRTE
    ``ge_to512(ge)``) and a full-width ERes2NetV2 checkpoint where ``TTS``
    looks for it, from SEED."""
    import torch

    from gsv_tts_tpu_torch.hparams import HParams
    from gsv_tts_tpu_torch.loader import save_trained_sovits
    from gsv_tts_tpu_torch.models import sovits, sv

    gen = torch.Generator().manual_seed(SEED + 8)
    hps = {**V2_HPS, "model": {**V2_HPS["model"], "gin_channels": 1024, "version": "v2ProPlus"}}
    p = sovits.init_params(sovits.SovitsConfig.from_hps(hps["model"], 1025), gen)
    p["dec.conv_post.weight"] *= 10.0  # as the v2 model: above the trim threshold
    p["sv_emb.weight"] *= 0.1  # its 20480 inputs would swamp the style vector
    save_trained_sovits(p, HParams(hps), root / "s2v2ProPlus")
    (root / "sv").mkdir()
    torch.save(sv.init_params(sv.SVConfig(), gen),
               str(root / "sv" / "pretrained_eres2netv2w24s4ep4.ckpt"))
    return root / "s2v2ProPlus"


def v2pro_phase(models_dir, gpt, v2, spk, prompt, dev, card):
    """The v2ProPlus family: the card's bf16 speaker embedding and ``ge`` held against a
    float32 evaluation of the same weights, the audio with the port's bf16 ``ge`` against
    JAX's float32 one (a reading), the embedder's time a clip; then one facade
    at the SoVITS defaults with the v2 and the v2ProPlus model loaded: ``infer`` twice
    with each (the second capturing no graph), ``infer_batched`` of 4 texts (K2), one
    ``infer_stream``, ``infer_vc``, ``verify_speaker``, and ``unload_sovits_model``
    (that model's graphs and pool gone, the other's replaying).  Returns the launch
    counts of its drives."""
    import numpy as np
    import torch

    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_sovits_weights
    from gsv_tts_tpu_torch.models import sovits as sovits_model
    from gsv_tts_tpu_torch.models import sv as sv_model
    from gsv_tts_tpu_torch.ops.convs import linear, prelu
    from gsv_tts_tpu_torch.utils.audio_io import load_audio

    t0 = time.perf_counter()
    pro = str(write_v2pro(Path(models_dir)))
    tts = TTS(gpt_cache=[(1, 512), (4, 512)], models_dir=models_dir, device=dev, seed=SEED)
    tts.load_gpt_model(str(gpt))
    tts.load_sovits_model(str(v2), pro)
    print(f"v2ProPlus: checkpoints written and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the embedder and ge in bf16 (the engine's) against float32 on the card; the bf16
    # embedder is the facade's own, loaded here on first use and kept
    f32 = Config(device=dev, dtype=torch.float32)
    t1 = time.perf_counter()
    sv16 = tts._get_sv_model()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t1
    sv32 = sv_model.ERes2Net(tts.sv_path, f32)
    model16, model32 = tts.sovits_models[pro], get_sovits_weights(pro, f32)
    spec16, wav16k = tts._get_spec(model16.hps, str(spk))
    e16, e32 = sv16.compute_embedding3(wav16k), sv32.compute_embedding3(wav16k)
    with torch.no_grad():
        ge16 = sovits_model.get_ge(model16.params, model16.cfg, spec16, e16)
        ge32 = sovits_model.get_ge(model32.params, model32.cfg, spec16.float(), e32)
    if e16.dtype != torch.float32 or e16.shape != (1, sv_model.EMBED_DIM) or not e16.is_cuda:
        fail(f"v2ProPlus: the embedding is {e16.dtype} {tuple(e16.shape)} on {e16.device}")
    if ge16.dtype != torch.bfloat16 or ge16.shape != (1, 1024, 1):
        fail(f"v2ProPlus: ge is {ge16.dtype} {tuple(ge16.shape)}, the model's bf16 [1, 1024, 1]")
    for name, a, b in (("embedding", e16, e32), ("ge", ge16, ge32)):
        err, rel = float((a.float() - b).abs().max()), rel_err(a, b)
        print(f"v2ProPlus: bf16 {name} against float32 on the card: max abs {err:.4g}, relative "
              f"L2 {rel:.4g} (tolerance {TOL_ABS} / {TOL_REL}; |float32| max "
              f"{float(b.abs().max()):.3g})", flush=True)
        if not (err <= TOL_ABS and rel <= TOL_REL):
            fail(f"v2ProPlus: the bf16 {name} is max abs {err:.4g}, relative L2 {rel:.4g} from "
                 f"float32")
    # what the port's bf16 ge (ROADMAP Queue 3) does to the audio: the flow and HiFi-GAN on
    # the same bf16 weights, z_p and mask, once with the port's bf16 ge and once with ge
    # left in float32, as JAX leaves it, which promotes them to float32 from the first
    # conditioning add (the port's ops cast each weight to the input's dtype, as JAX's do)
    cfg, p16 = model16.cfg, model16.params
    with torch.no_grad():
        mel = sovits_model.mel_style_encoder(p16, cfg, spec16[:, :cfg.ref_enc_in])
        sv_term = linear(e16, p16["sv_emb.weight"], p16["sv_emb.bias"])[:, :, None]
        ge_f32 = prelu(mel.float() + sv_term, p16["prelu.weight"])
        if not torch.equal(ge_f32.to(torch.bfloat16), ge16):
            fail("v2ProPlus: get_ge's bf16 ge is not the float32 ge rounded once")
        frames = 500  # 10 s of audio at 50 latent frames a second
        z_p = torch.randn(1, cfg.inter_channels, frames, device=dev,
                          generator=torch.Generator(device=dev).manual_seed(SEED))
        z_p = z_p.to(torch.bfloat16)
        mask = torch.ones(1, 1, frames, device=dev, dtype=torch.bfloat16)
        a16 = sovits_model.flow_dec(p16, cfg, z_p, mask, ge16)
        a32 = sovits_model.flow_dec(p16, cfg, z_p, mask, ge_f32)
    if (a16.dtype, a32.dtype) != (torch.bfloat16, torch.float32) or not (
            torch.isfinite(a16).all() and torch.isfinite(a32).all()):
        fail(f"v2ProPlus: the flow and HiFi-GAN gave {a16.dtype} / {a32.dtype} audio, or not "
             f"finite")
    print(f"v2ProPlus: the audio of {frames} latent frames with the port's bf16 ge against "
          f"JAX's float32 ge (the flow and HiFi-GAN then in float32), same bf16 weights: "
          f"relative L2 {rel_err(a16, a32):.4g}, max abs "
          f"{float((a16.float() - a32).abs().max()):.4g} (|float32| max "
          f"{float(a32.abs().max()):.3g}) [{card}]", flush=True)
    del a16, a32, z_p, mask

    feat = torch.as_tensor(np.stack([sv_model.kaldi_fbank(wav16k[0])]), device=dev)
    feat = feat.to(torch.bfloat16)
    with torch.no_grad():
        clip_ms = cuda_ms(lambda: sv16.compute_embedding3(wav16k), 10)
        net = graph_of(lambda: sv_model.eres2netv2_forward3(sv16.params, feat), 5)
        dev_ms = cuda_ms(net.replay, 10) / 5
        del net
        ops = sum(graph_kernels(lambda: sv_model.eres2netv2_forward3(sv16.params, feat),
                                1).values())
    t1 = time.perf_counter()
    sv_model.kaldi_fbank(wav16k[0])
    fbank_ms = 1000 * (time.perf_counter() - t1)
    print(f"v2ProPlus: ERes2NetV2 embedding of a {wav16k.shape[1] / 16000:.1f} s clip "
          f"({feat.shape[1]} frames): the facade's first-use load with its bucket captures "
          f"{load_s:.2f} s (once), {clip_ms:.2f} ms a clip by CUDA events around the call "
          f"(its bucket's graph replayed, fbank included; the host numpy fbank "
          f"{fbank_ms:.2f} ms), the network at the exact length {dev_ms:.2f} ms on the "
          f"device (a CUDA graph of 5 calls, replayed) in {ops} device operations (the nodes "
          f"of a graph captured around one call) [{card}]", flush=True)
    sv_kept = id(sv16)
    del sv16, sv32, model16, model32, p16

    counts = {name: 0 for name in launch_counts()}

    def infer(model, text):
        t = time.perf_counter()
        clip = tts.infer(str(spk), str(prompt), PROMPT_TEXT, text, top_k=1, sovits_model=model)
        torch.cuda.synchronize()
        return clip, dict(tts.last_timings, wall_s=time.perf_counter() - t)

    warm = {}
    for label, model in (("v2ProPlus", pro), ("v2", str(v2)), ("v2ProPlus", pro), ("v2", str(v2))):
        for i in range(2):
            reset_counts()
            clip, st = infer(model, TEXTS[0])
            expect_counts(f"v2ProPlus phase: infer on {label} ({st['decode_steps']} steps)",
                          read_counts(), k1=st["decode_steps"])
            counts["k1"] += st["decode_steps"]
            check_audio(f"v2ProPlus phase: infer on {label}", clip.audio_data, int(0.2 * 32000),
                        st["tokens"] * 1280 + int(0.2 * 32000))
            rtf = st["wall_s"] / clip.audio_len_s
            print(f"v2ProPlus phase: infer {i} on {label}: {st['tokens']} tokens, RTF {rtf:.4f}, "
                  f"sovits_s {1000 * st['sovits_s']:.2f} ms (graphs {st['sovits_graphs']} "
                  f"captured, {st['sovits_replays']} replayed), wall {st['wall_s']:.3f} s "
                  f"[{card}]", flush=True)
            if i == 1:
                if st["sovits_graphs"] != 0 or st["sovits_replays"] != 2:
                    fail(f"v2ProPlus phase: the second equal infer on {label} captured "
                         f"{st['sovits_graphs']} graph(s), replayed {st['sovits_replays']}")
                warm.setdefault(label, []).append((rtf, st["sovits_s"]))
    if id(tts.sv_model) != sv_kept:
        fail("v2ProPlus phase: the facade loaded its speaker embedder again")
    ge = tts.spk_audio_cache[str(spk)]["ge"][pro]
    if ge.dtype != torch.bfloat16 or tts.spk_audio_cache[str(spk)]["sv_emb"] is None:
        fail(f"v2ProPlus phase: the cached ge is {ge.dtype}, or no embedding was cached")
    p = tts.sovits_models[pro].params
    not_bf16 = [key for key, entry in tts.sovits_graphs.graphs.items()
                if key[1] == id(p) and key[0] in ("core", "flow")
                and entry[2][0].dtype != torch.bfloat16]
    if not_bf16:  # z_p of the core, the flow's audio: the model's dtype, not float32
        fail(f"v2ProPlus phase: the graphs {not_bf16} return no bf16 z_p / audio")

    reset_counts()
    clips = tts.infer_batched(str(spk), str(prompt), PROMPT_TEXT, TEXTS[:4], is_cut_text=False,
                              sovits_model=pro)
    torch.cuda.synchronize()
    st = tts.last_timings
    expect_counts(f"v2ProPlus phase: infer_batched of 4", read_counts(), k1=st["k1_steps"],
                  k2=st["k2_steps"])
    if st["k2_steps"] == 0 or len(clips) != 4:
        fail(f"v2ProPlus phase: infer_batched of 4 gave {len(clips)} clips, K2 steps "
             f"{st['k2_steps']}")
    for i, c in enumerate(clips):
        check_audio(f"v2ProPlus phase: infer_batched request {i}", c.audio_data, int(0.2 * 32000),
                    1024 * 1280 + int(0.8 * 32000))
    counts["k1"] += st["k1_steps"]
    counts["k2"] += st["k2_steps"]
    print(f"v2ProPlus phase: infer_batched of 4: {st['tokens']} tokens, K2 steps "
          f"{st['k2_steps']}, K1 steps {st['k1_steps']}, SoVITS {st['sovits_s']:.3f} s", flush=True)

    reset_counts()
    chunks = list(tts.infer_stream(str(spk), str(prompt), PROMPT_TEXT, TEXTS[1],
                                   is_cut_text=False, sovits_model=pro))
    torch.cuda.synchronize()
    st = tts.last_timings
    expect_counts("v2ProPlus phase: infer_stream", read_counts(), k1=st["decode_steps"])
    counts["k1"] += st["decode_steps"]
    if len(chunks) < 2 or not all(np.all(np.isfinite(c.audio_data)) for c in chunks):
        fail(f"v2ProPlus phase: a stream of {len(chunks)} chunk(s), or not finite")
    print(f"v2ProPlus phase: infer_stream: {len(chunks)} chunks, time to first audio "
          f"{1000 * st['ttfa_s']:.1f} ms, sovits_s {1000 * st['sovits_s']:.1f} ms", flush=True)

    prompt_s = len(load_audio(str(prompt))[0].reshape(-1)) / 32000
    for i in range(2):
        reset_counts()
        t = time.perf_counter()
        clip = tts.infer_vc(str(spk), str(prompt), PROMPT_TEXT, sovits_model=pro)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        expect_counts("v2ProPlus phase: infer_vc", read_counts())
        st = tts.last_timings
        # the prompt's codes (HuBERT at 50 Hz over the clip and 0.3 s of padding, 25 Hz codes)
        # voiced at 1280 samples a code, and 0.2 s of tail
        if not prompt_s < clip.audio_len_s <= prompt_s + 0.6:
            fail(f"v2ProPlus phase: infer_vc gave {clip.audio_len_s:.2f} s for a {prompt_s:.2f} s "
                 f"prompt")
        check_audio("v2ProPlus phase: infer_vc", clip.audio_data, int(prompt_s * 32000),
                    int((prompt_s + 0.6) * 32000))
        if not clip.subtitles:
            fail("v2ProPlus phase: infer_vc returned no subtitles")
        print(f"v2ProPlus phase: infer_vc {i}: {clip.audio_len_s:.2f} s of audio for a "
              f"{prompt_s:.2f} s prompt ({st['tokens']} codes), {len(clip.subtitles)} subtitles; "
              f"wall {1000 * wall:.1f} ms (codes and phones {1000 * st['prompt_s']:.1f}, "
              f"sovits_s {1000 * st['sovits_s']:.1f}; graphs {st['sovits_graphs']} captured, "
              f"{st['sovits_replays']} replayed) [{card}]", flush=True)

    same = tts.verify_speaker(str(spk), str(spk))
    cross = tts.verify_speaker(str(spk), str(prompt))
    print(f"v2ProPlus phase: verify_speaker: self {same:.6f}, cross {cross:.6f}", flush=True)
    if id(tts.sv_model) != sv_kept:
        fail("v2ProPlus phase: verify_speaker loaded the speaker embedder again")
    if not (same >= 0.999 and -1.0 <= cross <= 1.0):
        fail(f"v2ProPlus phase: verify_speaker self {same}, cross {cross}")

    graphs = tts.sovits_graphs
    pool = graphs.pools[id(p)]
    n_pro = sum(k[1] == id(p) for k in graphs.graphs)
    before = (len(graphs.graphs), graph_pool_bytes(pool), torch.cuda.memory_reserved())
    del p, ge
    tts.unload_sovits_model(pro)
    after = (len(graphs.graphs), graph_pool_bytes(pool), torch.cuda.memory_reserved())
    print(f"v2ProPlus phase: unload_sovits_model: graphs {before[0]} -> {after[0]} "
          f"({n_pro} of the model), its pool {before[1] / 2 ** 20:.1f} -> "
          f"{after[1] / 2 ** 20:.1f} MiB, reserved {before[2] / 2 ** 20:.0f} -> "
          f"{after[2] / 2 ** 20:.0f} MiB", flush=True)
    if not (n_pro > 0 and after[0] == before[0] - n_pro and before[1] > 0 and after[1] == 0
            and after[2] < before[2]):
        fail("v2ProPlus phase: unload_sovits_model left the model's graphs or pool")
    reset_counts()
    clip, st = infer(str(v2), TEXTS[0])
    expect_counts("v2ProPlus phase: infer on v2 after the unload", read_counts(),
                  k1=st["decode_steps"])
    counts["k1"] += st["decode_steps"]
    if st["sovits_graphs"] != 0 or st["sovits_replays"] != 2:
        fail(f"v2ProPlus phase: after the unload, v2's infer captured {st['sovits_graphs']}, "
             f"replayed {st['sovits_replays']}")
    for label, runs in warm.items():
        print(f"v2ProPlus phase: warm infer on {label} in turns: RTF "
              f"{', '.join(f'{r:.4f}' for r, _ in runs)}; sovits_s "
              f"{', '.join(f'{1000 * s:.2f}' for _, s in runs)} ms [{card}]", flush=True)
    return counts


def quant_path_phase(models_dir, gpt, sov, spk, prompt, dev, card):
    """The facade under ``quant_t2s``: ``TTS(quant_t2s="int8").infer`` three times in turns
    with a bf16 facade's (ms a step side by side), ``infer_batched`` of 4 texts (the int8 K2 and K1),
    a 7-text wave (the bf16 K2 at seven slots, then the int8 kernels as it compacts), one
    ``infer_stream``; ``TTS(quant_t2s="int4")``: ``infer`` and ``infer_batched`` of 4 texts;
    and ``unload_gpt_model`` giving the pages back.  Every quantized launch count equals the decode steps its path took; returns
    the launches summed over the drives."""
    import gc

    import numpy as np
    import torch

    from gsv_tts_tpu_torch import TTS

    total = {name: 0 for name in launch_counts()}

    def facade(quant):
        tts = TTS(gpt_cache=[(1, 512), (1, 1024), (2, 512), (4, 512), (7, 512)],
                  models_dir=models_dir, device=dev, seed=SEED, quant_t2s=quant)
        tts.load_gpt_model(str(gpt))
        tts.load_sovits_model(str(sov))
        return tts

    tts8, tts16 = facade("int8"), facade(False)
    if tts8.gpt_models[str(gpt)].engine.attn_impl != "fused_step_q8":
        fail("quant phase: quant_t2s='int8' did not reach the engine")
    ms, in_turns = {"int8": [], "bf16": []}, []
    turns = (("int8", tts8), ("bf16", tts16), ("bf16", tts16), ("int8", tts8), ("int8", tts8),
             ("bf16", tts16))  # a, b, b, a, a, b: a drift of the card's clocks cancels
    for label, tts in turns:
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip = tts.infer(str(spk), str(prompt), PROMPT_TEXT, TEXTS[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = tts.last_timings
        check_audio(f"quant phase: infer ({label})", clip.audio_data, int(0.2 * 32000),
                    st["tokens"] * 1280 + int(0.2 * 32000))
        counts = read_counts()
        expect_counts(f"quant phase: infer ({label}, {st['decode_steps']} decode steps)", counts,
                      **{"k1q8" if label == "int8" else "k1": st["decode_steps"]})
        for name, n in counts.items():
            total[name] += n
        ms[label].append(1000 * st["decode_s"] / st["decode_steps"])
        in_turns.append(ms[label][-1])
        print(f"quant phase: infer ({label}): {st['decode_steps']} decode steps, "
              f"{ms[label][-1]:.3f} ms/step, RTF {wall / clip.audio_len_s:.4f}", flush=True)
    print(f"quant phase: infer ms/step in turns (int8, bf16, bf16, int8, int8, bf16): "
          f"{', '.join(f'{t:.3f}' for t in in_turns)}"
          f"; mean int8 {sum(ms['int8']) / 3:.3f}, bf16 {sum(ms['bf16']) / 3:.3f} [{card}]",
          flush=True)
    del tts16
    tts4 = facade("int4")

    for quant, tts, texts in (("int8", tts8, TEXTS[:4]), ("int8", tts8, TEXTS[:7]),
                              ("int4", tts4, TEXTS[:4])):
        reset_counts()
        clips = tts.infer_batched(str(spk), str(prompt), PROMPT_TEXT, texts, is_cut_text=False)
        torch.cuda.synchronize()
        st, n, tag = tts.last_timings, len(texts), "q8" if quant == "int8" else "q4"
        counts = read_counts()
        expect_counts(f"quant phase: infer_batched of {n} ({quant})", counts,
                      **{"k1" + tag: st["k1q_steps"], "k2" + tag: st["k2q_steps"]},
                      k2=st["k2_steps"])
        # (four texts: the quantized K2 and K1; seven: the bf16 K2 until the wave compacts)
        if len(clips) != n or st["k2q_steps" if n == 4 else "k2_steps"] == 0 or (
                n == 4 and st["k2_steps"] > 0):
            fail(f"quant phase: infer_batched of {n} ({quant}): {len(clips)} clips, steps {st}")
        for i, c in enumerate(clips):
            check_audio(f"quant phase: infer_batched({n}, {quant}) request {i}", c.audio_data,
                        int(0.2 * 32000), 1024 * 1280 + int(0.8 * 32000))
        for name, c in counts.items():
            total[name] += c
        print(f"quant phase: infer_batched of {n} ({quant}): {st['tokens']} tokens; steps: "
              f"{quant} K2 {st['k2q_steps']}, bf16 K2 {st['k2_steps']}, {quant} K1 "
              f"{st['k1q_steps']}; {1000 * st['decode_s'] / st['decode_steps']:.3f} ms/step",
              flush=True)

    reset_counts()
    chunks = list(tts8.infer_stream(str(spk), str(prompt), PROMPT_TEXT, TEXTS[1],
                                    is_cut_text=False))
    torch.cuda.synchronize()
    st = tts8.last_timings
    counts = read_counts()
    expect_counts(f"quant phase: infer_stream ({st['decode_steps']} steps)", counts,
                  k1q8=st["decode_steps"])
    if len(chunks) < 2 or not all(np.all(np.isfinite(c.audio_data)) for c in chunks):
        fail(f"quant phase: infer_stream gave {len(chunks)} chunks or a chunk not finite")
    for name, c in counts.items():
        total[name] += c
    print(f"quant phase: infer_stream (int8): {len(chunks)} chunks, {st['decode_steps']} decode "
          f"steps, time to first audio {1000 * st['ttfa_s']:.1f} ms", flush=True)

    reset_counts()
    clip = tts4.infer(str(spk), str(prompt), PROMPT_TEXT, TEXTS[0])
    torch.cuda.synchronize()
    st = tts4.last_timings
    check_audio("quant phase: infer (int4)", clip.audio_data, int(0.2 * 32000),
                st["tokens"] * 1280 + int(0.2 * 32000))
    counts = read_counts()
    expect_counts(f"quant phase: infer (int4, {st['decode_steps']} decode steps)", counts,
                  k1q4=st["decode_steps"])
    for name, c in counts.items():
        total[name] += c
    print(f"quant phase: infer (int4): {st['decode_steps']} decode steps, "
          f"{1000 * st['decode_s'] / st['decode_steps']:.3f} ms/step", flush=True)
    del tts4

    pages = sum(t.numel() * t.element_size()
                for ql in tts8.gpt_models[str(gpt)].engine.params["layers_q8"] for t in ql.values())
    gc.collect()
    before = torch.cuda.memory_allocated()
    tts8.unload_gpt_model(str(gpt))
    freed = before - torch.cuda.memory_allocated()
    print(f"quant phase: unload_gpt_model freed {freed / 2**20:.1f} MiB (int8 pages and scales "
          f"{pages / 2**20:.1f} MiB)", flush=True)
    if freed < pages:
        fail(f"quant phase: unload_gpt_model freed {freed} bytes, the pages hold {pages}")
    return total


# ---------------------------------------------------------------------------
# zh: Chinese text, the CNRoberta BERT featurizer, and the facade's other entry points
# ---------------------------------------------------------------------------

# toned pinyin of every Han character of the phase's texts (the stand-in G2P's table)
ZH_PINYIN = {
    "今": "jin1", "天": "tian1", "气": "qi4", "很": "hen3", "好": "hao3", "我": "wo3",
    "们": "men5", "一": "yi4", "起": "qi3", "去": "qu4", "公": "gong1", "园": "yuan2",
    "散": "san4", "步": "bu4", "吧": "ba5", "人": "ren2", "工": "gong1", "智": "zhi4",
    "能": "neng2", "正": "zheng4", "在": "zai4", "改": "gai3", "变": "bian4", "的": "de5",
    "生": "sheng1", "活": "huo2", "和": "he2", "作": "zuo4", "方": "fang1", "式": "shi4",
    "他": "ta1", "说": "shuo1", "这": "zhe4", "本": "ben3", "书": "shu1", "非": "fei1",
    "常": "chang2", "有": "you3", "意": "yi4", "思": "si5", "值": "zhi2", "得": "de2",
    "读": "du2", "再": "zai4", "春": "chun1", "来": "lai2", "了": "le5", "花": "hua1",
    "儿": "er5", "都": "dou1", "开": "kai1", "小": "xiao3", "鸟": "niao3", "树": "shu4",
    "上": "shang4", "唱": "chang4", "歌": "ge1", "最": "zui4", "喜": "xi3", "欢": "huan5",
    "电": "dian4", "影": "ying3", "是": "shi4", "你": "ni3", "呢": "ne5",
}
ZH_TEXTS = ["今天天气很好，我们一起去公园散步吧。",
            "人工智能正在改变我们的生活和工作方式。",
            "他说这本书非常有意思，值得一读再读。",
            "春天来了，花儿都开了，小鸟在树上唱歌。"]
ZH_MIXED = "我最喜欢的电影是 The Matrix，你呢？"
# the bf16 BERT features against a float32 evaluation of the same weights, and the int8
# ones: relative L2 over the valid rows and the largest element error.  On the CPU at
# width 1024 (random N(0, 0.02) weights, 40 tokens) bf16 sat 0.0064 / 0.0093 / 0.0111 from
# float32 after 2 / 6 / 10 layers (max 0.043-0.066) and int8 0.0136 / 0.0227 / 0.0287 (max
# 0.059-0.120), growing about as the root of the depth: 22 layers should stay near 0.016
# and 0.04; the bounds leave 2.5x
BERT_BF16_TOL = (4e-2, 0.3)
BERT_Q8_TOL = (1e-1, 0.6)


class StandInZhG2P:
    """The card's host has no ``jieba``, which the Chinese G2P segments with: this stand-in
    takes its place as ``global_config.chinese_g2p`` (the injection the CPU tests use).  It
    normalizes with the port's ``zh_norm`` as the real one does and reads each Han
    character's pinyin from ``ZH_PINYIN`` through the port's ``split_full_pinyin``, without
    word segmentation, tone sandhi or erhua (the real G2P is held to JAX's on the CPU)."""

    def text_normalize(self, text: str) -> str:
        import re

        from gsv_tts_tpu_torch.frontend.g2p import zh_norm
        from gsv_tts_tpu_torch.frontend.pause import escaped_pause

        return re.sub(f"[^一-龥{escaped_pause}]", "", zh_norm.normalize(text))

    def g2p(self, text: str):
        from gsv_tts_tpu_torch.frontend.g2p.chinese import split_full_pinyin
        from gsv_tts_tpu_torch.frontend.pause import pause_map

        phones, word2ph = [], {"word": [], "ph": []}
        for ch in text:
            word2ph["word"].append(ch)
            if ch in pause_map:
                phones.append(ch)
                word2ph["ph"].append(1)
                continue
            py = ZH_PINYIN[ch]
            ini, fin = split_full_pinyin(py[:-1])
            phones += [ini, fin + py[-1]]
            word2ph["ph"].append(2)
        return phones, word2ph


def write_bert(root: Path):
    """A full-width random CNRoberta (``BertConfig()``: vocab 21128, hidden 1024, 24 layers,
    16 heads, FFN 4096, 512 positions) from SEED, stored as bf16 safetensors under the
    published ``bert.`` prefix, with a ``vocab.txt`` of 21128 lines: BERT's special tokens,
    ASCII, full-width punctuation, ``##`` pieces, then CJK characters from U+4E00."""
    import torch

    from gsv_tts_tpu_torch.models import roberta
    from gsv_tts_tpu_torch.utils.safetensors import save_file

    cfg = roberta.BertConfig()
    d = root / "chinese-roberta-wwm-ext-large"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfg.to_dict()))
    vocab = (["[PAD]"] + [f"[unused{i}]" for i in range(1, 100)]
             + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
             + [chr(c) for c in range(33, 127)] + list("，。！？、；：（）《》“”…")
             + ["##" + chr(c) for c in range(97, 123)])
    vocab += [chr(0x4E00 + i) for i in range(cfg.vocab_size - len(vocab))]
    (d / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    params = roberta.init_params(cfg, torch.Generator().manual_seed(SEED))
    save_file({"bert." + k: v.to(torch.bfloat16) for k, v in params.items()},
              d / "model.safetensors")
    n = sum(v.numel() for v in params.values())
    return d, n


def bert_bound(cfg, T: int, rows: int = 1):
    """Bound of one BERT call: the ``N - 2`` layers' bf16 matrices read once, and their
    products' operations (2 a multiply-add) plus the attention's, for ``rows`` x ``T``
    tokens."""
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers - 2
    n_w = L * (4 * D * D + 2 * D * I)
    flops = 2 * rows * T * n_w + L * rows * 4 * T * T * D
    return bound(2 * n_w + 2 * rows * T * D, flops)


def encoder_graph(bert, ids, mask):
    """A CUDA graph of one bf16 encoder call on ``ids`` / ``mask`` (device tensors), after a
    warm run on the capture's stream (cuBLAS's workspace is made outside the capture)."""
    import torch

    from gsv_tts_tpu_torch.models.roberta import bert_hidden_minus3

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.stream(side):
        bert_hidden_minus3(bert.params, bert.cfg, ids, mask)
        with torch.cuda.graph(graph, stream=side):
            bert_hidden_minus3(bert.params, bert.cfg, ids, mask)
    torch.cuda.current_stream().wait_stream(side)
    return graph


def zh_bert_checks(tts_bf16, tts_q8, dev):
    """The card's bf16 and int8 BERT features of the four texts against a float32
    evaluation of the same weights on the card; a call's time at two text lengths (CUDA
    events), the device time of a call (a CUDA graph of it), beside the bound."""
    import torch

    from gsv_tts_tpu_torch.frontend.g2p import text_to_phonemes
    from gsv_tts_tpu_torch.models.roberta import bert_hidden_minus3

    bert, q8 = tts_bf16.tts_config.cnroberta, tts_q8.tts_config.cnroberta
    w2p = [text_to_phonemes(t, "zh")[1] for t in ZH_TEXTS]
    ids, mask = bert.batch(["".join(w["word"]) for w in w2p])
    ids_d, mask_d = torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev)
    p32 = {k: v.float() for k, v in bert.params.items()}  # the bf16 weights, upcast
    with torch.no_grad():
        f32 = bert_hidden_minus3(p32, bert.cfg, ids_d, mask_d)
        b16 = bert_hidden_minus3(bert.params, bert.cfg, ids_d, mask_d).float()
        i8 = q8._fwd(q8.params, q8.cfg, ids_d, mask_d)
    valid = mask_d.bool()
    errs = {}
    for name, got, (tol_rel, tol_abs) in (("bf16", b16, BERT_BF16_TOL),
                                          ("int8", i8, BERT_Q8_TOL)):
        if not torch.isfinite(got).all():
            fail(f"zh phase: the {name} BERT features are not finite")
        d = got[valid] - f32[valid]
        rel, mx = float(d.norm() / f32[valid].norm()), float(d.abs().max())
        errs[name] = (rel, mx)
        print(f"zh phase: BERT {name} features of {len(ZH_TEXTS)} texts ({int(valid.sum())} "
              f"tokens) against float32 on the card: relative L2 {rel:.5f} (bound {tol_rel}), "
              f"max abs {mx:.4f} (bound {tol_abs}); |float32| max "
              f"{float(f32[valid].abs().max()):.3f}", flush=True)
        if not (rel <= tol_rel and mx <= tol_abs):
            fail(f"zh phase: the {name} BERT features sit {rel:.4g} (max {mx:.4g}) from float32")
    times = {}
    for label, texts in (("short", ZH_TEXTS[:1]), ("long", ["".join(ZH_TEXTS * 2)])):
        w = [text_to_phonemes(t, "zh")[1] for t in texts]
        i_, m_ = bert.batch(["".join(x["word"]) for x in w])
        T = i_.shape[1]
        call_ms = cuda_ms(lambda: bert(w), 20)
        i_d, m_d = torch.as_tensor(i_, device=dev), torch.as_tensor(m_, device=dev)
        dev_ms = cuda_ms(encoder_graph(bert, i_d, m_d).replay, 10)
        b_ms, b_by = bert_bound(bert.cfg, T)
        q8_ms = cuda_ms(lambda: q8(w), 5)
        times[label] = (T, call_ms, dev_ms, b_ms, q8_ms)
        print(f"zh phase: BERT, {T} tokens: {call_ms:.3f} ms a call (bf16, CUDA events, host "
              f"tokenization and the copy back included), {dev_ms:.3f} ms on the device (a "
              f"CUDA graph of the encoder); bound {b_ms:.4f} ms ({b_by}); int8 "
              f"{q8_ms:.3f} ms a call", flush=True)
    return errs, times


def zh_phase(models_dir, gpt, sov, spk, prompt, dev, card):
    """Chinese text on the main path (phase 10): a full-width random CNRoberta beside the v2
    checkpoints, a stand-in zh G2P; ``TTS(use_bert=True)``: English and Chinese ``infer`` in
    turns and a mixed zh/en one (K1), ``infer_batched`` of four Chinese texts (K2 and K1), a
    Chinese ``infer_stream`` (K1), ``infer_async`` twice (a CUDA graph captured in the
    worker thread, then replayed) and ``infer_stream_async`` from ``asyncio.run``;
    ``TTS(quant_bert=True)`` and ``TTS(featurizer_buckets=True)``, one ``infer`` each; the
    BERT features held to float32 and timed; ``TTS(use_flash_attn=False).infer`` launching
    no kernel.  Counts are zeroed just before each drive and read just after; returns the
    launches summed over the drives."""
    import asyncio

    import numpy as np
    import torch

    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.config import global_config

    total = {name: 0 for name in launch_counts()}

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    t0 = time.perf_counter()
    bert_dir, n_params = write_bert(Path(models_dir))
    print(f"zh phase: a full-width random CNRoberta ({n_params / 1e6:.1f} M parameters, "
          f"{(bert_dir / 'model.safetensors').stat().st_size / 1e6:.0f} MB bf16) written in "
          f"{time.perf_counter() - t0:.1f} s; the zh frontend is a stand-in (the host has no "
          f"jieba): zh_norm, a pinyin table and split_full_pinyin, no sandhi", flush=True)
    saved_g2p = global_config.chinese_g2p
    global_config.chinese_g2p = StandInZhG2P()
    small = [(1, 512), (1, 1024), (2, 512), (4, 512)]
    try:
        t0 = time.perf_counter()
        tts = TTS(gpt_cache=small, models_dir=models_dir, device=dev, seed=SEED, use_bert=True)
        tts.load_gpt_model(str(gpt))
        tts.load_sovits_model(str(sov))
        engine = tts.gpt_models[str(gpt)].engine
        if tts.tts_config.cnroberta is None:
            fail("zh phase: TTS(use_bert=True) loaded no BERT")
        print(f"zh phase: TTS(use_bert=True) built and loaded in {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
        # English and Chinese in turns, then a mixed text: every step one K1 launch
        reset_counts()
        steps, per = 0, {"en": [], "zh": []}
        for i, (lang, text) in enumerate((("en", TEXTS[0]), ("zh", ZH_TEXTS[0]),
                                          ("zh", ZH_TEXTS[1]), ("en", TEXTS[1]),
                                          ("mixed", ZH_MIXED))):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            clip = tts.infer(str(spk), str(prompt), PROMPT_TEXT, text)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            st = tts.last_timings
            steps += st["decode_steps"]
            check_audio(f"zh phase: infer {i} ({lang})", clip.audio_data, int(0.2 * 32000),
                        st["tokens"] * 1280 + int(0.2 * 32000))
            ms_step = 1000 * st["decode_s"] / st["decode_steps"]
            per.setdefault(lang, []).append((ms_step, wall / clip.audio_len_s))
            print(f"zh phase: infer {i} ({lang}): {st['tokens']} tokens, {st['decode_steps']} "
                  f"decode steps, {ms_step:.3f} ms/step, prefill {1000 * st['prefill_s']:.1f} "
                  f"ms, frontend {1000 * st['frontend_s']:.1f} ms, SoVITS {st['sovits_s']:.3f} "
                  f"s; {clip.audio_len_s:.2f} s of audio in {wall:.3f} s, RTF "
                  f"{wall / clip.audio_len_s:.4f}", flush=True)
        counts = read_counts()
        expect_counts(f"zh phase: infer en/zh/zh/en/mixed ({steps} decode steps)", counts,
                      k1=steps)
        add(counts)
        print("zh phase: in turns (en, zh, zh, en): ms/step en "
              + " / ".join(f"{m:.3f}" for m, _ in per["en"]) + ", zh "
              + " / ".join(f"{m:.3f}" for m, _ in per["zh"]) + "; RTF en "
              + " / ".join(f"{r:.4f}" for _, r in per["en"]) + ", zh "
              + " / ".join(f"{r:.4f}" for _, r in per["zh"]) + f" ({card})", flush=True)
        # four Chinese texts on a four-slot wave
        counts, st = batched_path(tts, engine, spk, prompt, ZH_TEXTS, engine.cfg.num_layers)
        if counts["k2"] == 0:
            fail("zh phase: infer_batched of 4 launched no K2")
        add(counts)
        # a Chinese stream
        reset_counts()
        chunks = list(tts.infer_stream(str(spk), str(prompt), PROMPT_TEXT, ZH_TEXTS[2],
                                       is_cut_text=False))
        st = tts.last_timings
        expect_counts(f"zh phase: infer_stream ({st['decode_steps']} steps)", read_counts(),
                      k1=st["decode_steps"])
        add(read_counts())
        if len(chunks) < 2 or not all(np.all(np.isfinite(c.audio_data)) for c in chunks):
            fail(f"zh phase: a stream of {len(chunks)} chunk(s), or a chunk not finite")
        print(f"zh phase: infer_stream: {len(chunks)} chunks, {st['decode_steps']} decode "
              f"steps, time to first audio {1000 * st['ttfa_s']:.1f} ms", flush=True)
        # the async wrappers, from an event loop: the SoVITS graphs evicted first, so the
        # first call captures in its worker thread and the second, greedy like the first
        # (the same tokens, so the same buckets), replays what it captured
        tts.sovits_graphs.evict(tts.sovits_models[str(sov)].params)

        async def drive():
            out = []
            for _ in range(2):
                clip = await tts.infer_async(str(spk), str(prompt), PROMPT_TEXT, ZH_TEXTS[3],
                                             top_k=1)
                out.append((clip, dict(tts.last_timings)))
            chunks = [c async for c in tts.infer_stream_async(
                str(spk), str(prompt), PROMPT_TEXT, ZH_TEXTS[0], is_cut_text=False)]
            return out, chunks, dict(tts.last_timings)

        reset_counts()
        calls, achunks, sst = asyncio.run(drive())
        counts = read_counts()
        steps = sum(st["decode_steps"] for _, st in calls) + sst["decode_steps"]
        expect_counts(f"zh phase: infer_async x2 and infer_stream_async ({steps} steps)",
                      counts, k1=steps)
        add(counts)
        (c1, s1), (c2, s2) = calls
        for i, c in enumerate((c1, c2)):
            check_audio(f"zh phase: infer_async {i}", c.audio_data, int(0.2 * 32000),
                        1024 * 1280 + int(0.2 * 32000))
        if not (s1["sovits_graphs"] >= 1 and s2["sovits_graphs"] == 0
                and s2["sovits_replays"] == 2):
            fail(f"zh phase: infer_async captured {s1['sovits_graphs']} then "
                 f"{s2['sovits_graphs']} graphs, replayed {s2['sovits_replays']}")
        if len(achunks) < 2 or not all(np.all(np.isfinite(c.audio_data)) for c in achunks):
            fail(f"zh phase: infer_stream_async gave {len(achunks)} chunk(s) or a chunk not "
                 f"finite")
        print(f"zh phase: infer_async: the first captured {s1['sovits_graphs']} SoVITS graphs "
              f"in its worker thread ({s1['sovits_capture_s']:.3f} s), the second replayed "
              f"{s2['sovits_replays']} and captured none; infer_stream_async: {len(achunks)} "
              f"chunks; get_timings: "
              + ", ".join(f"{k} p50 {v['p50'] * 1000:.1f} ms (n={v['count']})"
                          for k, v in tts.get_timings().items()), flush=True)
        # quant_bert and featurizer_buckets, one infer each (BERT loaded on the first Han text)
        variants = {}
        for opt in ("quant_bert", "featurizer_buckets"):
            v = TTS(gpt_cache=small, models_dir=models_dir, device=dev, seed=SEED, **{opt: True})
            v.load_gpt_model(str(gpt))
            v.load_sovits_model(str(sov))
            reset_counts()
            clip = v.infer(str(spk), str(prompt), PROMPT_TEXT, ZH_TEXTS[1])
            st = v.last_timings
            expect_counts(f"zh phase: TTS({opt}=True).infer ({st['decode_steps']} steps)",
                          read_counts(), k1=st["decode_steps"])
            add(read_counts())
            check_audio(f"zh phase: TTS({opt}=True).infer", clip.audio_data, int(0.2 * 32000),
                        st["tokens"] * 1280 + int(0.2 * 32000))
            bert = v.tts_config.cnroberta
            if bert is None or getattr(bert, "quant" if opt == "quant_bert" else "buckets") \
                    is not True:
                fail(f"zh phase: TTS({opt}=True) did not load its BERT with the option")
            print(f"zh phase: TTS({opt}=True).infer: {st['decode_steps']} decode steps, "
                  f"frontend {1000 * st['frontend_s']:.1f} ms, {clip.audio_len_s:.2f} s of "
                  f"audio", flush=True)
            variants[opt] = v
        errs, times = zh_bert_checks(tts, variants["quant_bert"], dev)
        del variants
        # the "xla" engine: no kernel of the package
        x = TTS(gpt_cache=small, models_dir=models_dir, device=dev, seed=SEED,
                use_flash_attn=False)
        x.load_gpt_model(str(gpt))
        x.load_sovits_model(str(sov))
        if x.gpt_models[str(gpt)].engine.attn_impl != "xla":
            fail("zh phase: TTS(use_flash_attn=False) did not take the xla engine")
        reset_counts()
        clip = x.infer(str(spk), str(prompt), PROMPT_TEXT, ZH_TEXTS[2])
        st = x.last_timings
        expect_counts(f"zh phase: TTS(use_flash_attn=False).infer ({st['decode_steps']} steps)",
                      read_counts())
        check_audio("zh phase: TTS(use_flash_attn=False).infer", clip.audio_data,
                    int(0.2 * 32000), st["tokens"] * 1280 + int(0.2 * 32000))
        xla_ms = 1000 * st["decode_s"] / st["decode_steps"]
        print(f"zh phase: xla engine: {st['decode_steps']} decode steps at {xla_ms:.3f} ms/step "
              f"(plain PyTorch, no kernel launched; K1's infer above "
              f"{per['zh'][0][0]:.3f} / {per['zh'][1][0]:.3f})", flush=True)
        del x, tts, engine
        torch.cuda.empty_cache()
    finally:
        global_config.chinese_g2p = saved_g2p
    return total, {"bert_err": errs, "bert_ms": times, "xla_ms_step": xla_ms}


# ---------------------------------------------------------------------------
# shared streams and ja: batched streaming, the shared wave, the vocoder batcher, Japanese
# ---------------------------------------------------------------------------

# kana-only Japanese: without pyopenjtalk (the card's host has none) the built-in converter
JA_TEXTS = ["こんにちは、きょうはいいてんきですね。", "カタカナとひらがな、ちょっとまってね。"]
# VocoderBatcher.decode_many against each row's solo chunk.  The batcher's semantics are
# held in float32 on the card (a float32 facade on the same checkpoint): each batched row
# within VOC_F32_TOL (relative L2) of its solo chunk (on the CPU they agree to 2e-5: only
# the summation order differs).  In bf16 each row is held to a float32 evaluation of the
# same bf16 weights: the MRTE attention (in [0, 1]) and the latent overlap (O(1)) by K1's
# rule against its twin (check_close: within VOC_TOL_ABS of the solo row, and no further
# from float32 than 1.5x the solo row, +1e-3).  The waveform cannot be held so: the random
# vocoder saturates its tanh, so a relative L2 counts sign flips of samples near zero
# before it (on an NVIDIA H100 80GB HBM3 at 700 W two bf16 evaluations of one row sat
# 5.5 % and 10.1 % from float32, one sample 2 apart); each bf16 waveform, batched and
# solo, must lie within VOC_BF16_AUDIO_TOL of float32, which a wrong row, offset or
# conditioning (~100 % off) does not
VOC_F32_TOL = 1e-3
VOC_TOL_ABS = 0.1
VOC_BF16_AUDIO_TOL = 0.25
# every shared-stream client must be done within this many seconds of its start
CLIENT_DEADLINE_S = 120.0


def voc_check(name, got, solo, f32):
    """A bf16 batched row against its solo row and float32 (the bounds above); returns
    (max abs to solo, rel to solo, batched from f32, solo from f32)."""
    import torch

    got, solo, f32 = (torch.as_tensor(t).float().cpu() for t in (got, solo, f32))
    if got.shape != solo.shape or got.shape != f32.shape:
        fail(f"{name}: shapes {tuple(got.shape)}, solo {tuple(solo.shape)}, float32 "
             f"{tuple(f32.shape)}")
    err = float((got - solo).abs().max())
    rel, noise, own = rel_err(got, solo), rel_err(solo, f32), rel_err(got, f32)
    if name.endswith("audio"):
        bad = max(own, noise) > VOC_BF16_AUDIO_TOL
    else:
        bad = err > VOC_TOL_ABS or own > 1.5 * noise + 1e-3
    if bad:
        fail(f"{name} differs: max abs {err:.4g}, rel {rel:.3g}; from float32: batched "
             f"{own:.3g}, solo {noise:.3g}")
    return err, rel, own, noise


def batcher_rows(tts, sov, ge, ov=5):
    """(codes, phones, vsi, overlap) of four chunks at different points of their streams:
    two first chunks of other lengths, a cross-faded continuation (its overlap carried from
    a solo first chunk) and a short first chunk, every row's valid frames (40, 47, 18, 48)
    in the 50-frame flow bucket alone and in the batch.  A batch padded to a longer bucket
    than a row's own gives HiFi-GAN the speaker conditioning on the pad frames where the
    row alone meets the convolutions' zero padding, and the full-width vocoder sees that
    far back into the row (float32 on an NVIDIA H100 80GB HBM3 at 700 W: a 47-frame row
    8.4 % from its solo chunk at a 128-frame batch bucket): the JAX batcher's semantics
    too, which this check does not isolate."""
    import numpy as np

    rng = np.random.RandomState(SEED)
    codes = rng.randint(0, 1024, 41).astype(np.int64)
    text = rng.randint(1, 700, 13).astype(np.int64)
    _, _, carry = tts._sovits_decode_stream(sov, codes[None, None, :20], text[None], ge,
                                            noise_scale=0.0, speed=1.0, y_overlap=None,
                                            valid_start_idx=0, overlap_len=ov)
    return [(codes[:20], text, 0, None), (codes, text, 35, carry),
            (rng.randint(0, 1024, 9).astype(np.int64), rng.randint(1, 700, 7).astype(np.int64),
             0, None), (codes[:24], text[:11], 0, None)]


def batched_and_solo(tts, sov, ge, rows, ov=5):
    """Each row's solo chunk, then the rows through one ``decode_many`` (a fresh batcher):
    returns (batched results, solo results, the batcher's stats)."""
    from gsv_tts_tpu_torch.runtime.vocoder_batch import VocoderBatcher

    solo = [tts._sovits_decode_stream(sov, c[None, None, :], t[None], ge, noise_scale=0.0,
                                      speed=1.0, y_overlap=yo, valid_start_idx=v,
                                      overlap_len=ov) for c, t, v, yo in rows]
    b = VocoderBatcher(tts, max_batch=4)
    try:
        got = b.decode_many([(sov, c, t, ge, 0.0, yo, v, ov) for c, t, v, yo in rows])
    finally:
        b.close()
    if b.stats["max_group"] != len(rows) or b.stats["solo_rows"]:
        fail(f"decode_many of {len(rows)} rows ran {b.stats}")
    return got, solo


def f32_chunk(tts, sov, p32, codes, text, ge, y_ov, vsi, overlap_len):
    """One streaming chunk as ``TTS._sovits_decode_stream`` builds it, evaluated eagerly in
    float32 on ``p32`` (the bf16 weights in float32), noise zero."""
    import torch

    from gsv_tts_tpu_torch.runtime.vocoder_batch import stream_batch_fused

    cfg = sov.cfg
    codes_pad, n_t, text_pad, N_t = tts._padded(codes[None, None, :], text[None])
    Bc = codes_pad.shape[-1]
    t_valid = 2 * codes.size - vsi
    dev = codes_pad.device
    y = (torch.zeros((1, cfg.hidden_channels, overlap_len), device=dev) if y_ov is None
         else y_ov.float())
    audio, attn, new_ov = stream_batch_fused(
        p32, cfg, codes_pad, n_t.reshape(1), text_pad, N_t.reshape(1), ge.float(),
        torch.zeros((1, cfg.inter_channels, 2 * Bc), device=dev), y,
        torch.full((1,), vsi, device=dev), torch.full((1,), y_ov is not None, device=dev),
        overlap_len=overlap_len, bucket=tts._flow_bucket(t_valid))
    return (audio[..., :t_valid * cfg.samples_per_frame],
            attn[0, :, :2 * codes.size, :text.size], new_ov)


def replay_ms(graphs, key, reps: int = 20) -> float:
    """Device ms of one replay of the captured graph ``key`` (CUDA events over ``reps``)."""
    graph = graphs.graphs[key][0]
    return cuda_ms(graph.replay, reps)


def vocoder_batch_checks(tts, sov, ge, models_dir, sov_path, spk, card):
    """``VocoderBatcher.decode_many`` at 2 and 4 rows against each row's solo
    ``_sovits_decode_stream``, in float32 (a float32 facade) and in bf16 against a float32
    evaluation; then a batched chunk of 4 rows against the 4 solo chunks, replays only
    (after the captures), in turns."""
    import torch

    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.models.sovits import STREAM_PAD_MULTIPLE as CB

    ov = 5
    f32_tts = TTS(models_dir=models_dir, device=tts.device, dtype="float32", seed=SEED)
    f32_tts.load_sovits_model(str(sov_path))
    f32_sov, f32_ge = f32_tts._prepare_sovits_resources(str(sov_path), str(spk))
    f32_rows = batcher_rows(f32_tts, f32_sov, f32_ge, ov)
    f32_err = {}
    for n_rows in (2, 4):
        got, solo = batched_and_solo(f32_tts, f32_sov, f32_ge, f32_rows[:n_rows], ov)
        for i, (g, s) in enumerate(zip(got, solo)):
            for name, x, y in zip(("audio", "attn", "overlap"), g, s):
                e = rel_err(torch.as_tensor(x).float().cpu(), torch.as_tensor(y).float().cpu())
                f32_err[f"B{n_rows}_row{i}_{name}"] = e
                if e > VOC_F32_TOL:
                    fail(f"float32 decode_many B={n_rows} row {i} {name}: {e:.3g} from its "
                         f"solo chunk (bound {VOC_F32_TOL})")
    del f32_tts, f32_sov, f32_ge, f32_rows, got, solo
    rows = batcher_rows(tts, sov, ge, ov)
    p32 = {k: v.float() for k, v in sov.params.items()}
    readings = {}
    for n_rows in (2, 4):
        got, solo = batched_and_solo(tts, sov, ge, rows[:n_rows], ov)
        f32 = [f32_chunk(tts, sov, p32, c, t, ge, yo, v, ov) for c, t, v, yo in rows[:n_rows]]
        for i, (g, s, f) in enumerate(zip(got, solo, f32)):
            for name, x, y, z in zip(("audio", "attn", "overlap"), g, s, f):
                r = voc_check(f"decode_many B={n_rows} row {i} {name}", x, y, z)
                readings[f"B{n_rows}_row{i}_{name}"] = [round(v, 6) for v in r]
    print(f"shared phase: decode_many at 2 and 4 rows: float32 batched rows from their solo "
          f"chunks at most {max(f32_err.values()):.3g} (relative L2, bound {VOC_F32_TOL}); bf16 "
          f"(max abs, rel to solo, batched from f32, solo from f32; attention and overlap: "
          f"within {VOC_TOL_ABS} and batched <= 1.5x solo + 1e-3 from f32; audio: each "
          f"<= {VOC_BF16_AUDIO_TOL} from f32): {json.dumps(readings)}", flush=True)
    # replays only: the 4-row graph against the 4 solo graphs, in turns
    p = sov.params
    keys = []
    for c, t, v, _ in rows:
        bc, npad = -(-c.size // CB) * CB, -(-t.size // CB) * CB
        keys.append(("chunk", id(p), bc, npad, tts._flow_bucket(2 * c.size - v), ov))
    bc = max(k[2] for k in keys)
    npad = max(k[3] for k in keys)
    bkey = ("chunk", id(p), 4, bc, npad,
            tts._flow_bucket(max(2 * c.size - v for c, _, v, _ in rows)), ov)
    graphs = tts.sovits_graphs
    missing = [k for k in keys + [bkey] if k not in graphs.graphs]
    if missing:
        fail(f"shared phase: no captured graph under {missing}")

    def solo_ms():
        return sum(replay_ms(graphs, k) for k in keys)

    s1, b1, b2, s2 = solo_ms(), replay_ms(graphs, bkey), replay_ms(graphs, bkey), solo_ms()
    batched, solo4 = (b1 + b2) / 2, (s1 + s2) / 2
    print(f"shared phase: one batched chunk of 4 rows {batched:.3f} ms on the device against "
          f"4 solo chunks {solo4:.3f} ms (replays of captured graphs, CUDA events, in turns "
          f"s, b, b, s: {s1:.3f} / {b1:.3f} / {b2:.3f} / {s2:.3f}); {card}", flush=True)
    return {"f32_max_rel": max(f32_err.values()), "bf16": readings, "batched4_ms": batched,
            "solo4_ms": solo4}


def wave_totals(tts, gpt):
    return dict(tts.wave_stats().get(str(gpt), {}).get("totals", {}))


def wave_delta(after, before):
    return {k: after.get(k, 0) - before.get(k, 0) for k in after if k != "max_live"}


def shared_clients(tts, gpt, spk, prompt, texts, card):
    """``len(texts)`` ``stream_shared`` clients on their own threads, started 50-100 ms
    apart, with the SoVITS graphs evicted first so that clients capture while the wave
    decodes; every capture records the live slots of the waves at that moment."""
    import threading

    import numpy as np

    graphs = tts.sovits_graphs
    sched = tts._get_wave_scheduler(str(gpt))
    live_at_capture = []
    capture = graphs._capture

    def spy(*a, **kw):
        waves = sched.stats["waves"]
        live_at_capture.append(max((w["live"] for w in waves), default=0))
        return capture(*a, **kw)

    graphs._capture = spy
    results = [None] * len(texts)
    errors = []

    def client(i):
        t0 = time.perf_counter()
        chunks, ttfa = [], None
        try:
            for c in tts.stream_shared(str(spk), str(prompt), PROMPT_TEXT, texts[i],
                                       is_cut_text=False, debug=False):
                if ttfa is None:
                    ttfa = time.perf_counter() - t0
                chunks.append(c.audio_data)
            results[i] = (chunks, ttfa, time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 — fails the phase below
            errors.append((i, repr(exc)))

    cap0, cap_s0 = graphs.captures, graphs.capture_s
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(len(texts))]
    rng = np.random.RandomState(SEED)
    t_start = time.perf_counter()
    try:
        for i, t in enumerate(threads):
            if i:
                time.sleep(0.05 + 0.05 * rng.rand())  # 50-100 ms apart
            t.start()
        for t in threads:
            t.join(timeout=max(0.1, CLIENT_DEADLINE_S - (time.perf_counter() - t_start)))
    finally:
        graphs._capture = capture
    if any(t.is_alive() for t in threads):
        fail(f"shared phase: a stream_shared client was not done within {CLIENT_DEADLINE_S} s")
    if errors:
        fail(f"shared phase: stream_shared clients failed: {errors}")
    for i, (chunks, ttfa, wall) in enumerate(results):
        audio = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
        check_audio(f"shared phase: client {i}", audio, int(0.4 * 32000),
                    1024 * 1280 + int(0.8 * 32000))
        print(f"shared phase: client {i}: {len(chunks)} chunks, {audio.size / 32000:.2f} s of "
              f"audio, time to first audio {1000 * ttfa:.1f} ms, done in {wall:.2f} s; {card}",
              flush=True)
    during = sum(1 for n in live_at_capture if n >= 2)
    return {"captures": graphs.captures - cap0, "capture_s": graphs.capture_s - cap_s0,
            "captures_beside_k2": during, "ttfa_ms": [1000 * r[1] for r in results]}


def shared_phase(models_dir, gpt, sov, spk, prompt, dev, card):
    """Batched and shared-wave streaming and Japanese (phase 11): ``infer_batched_stream`` of
    4 texts (its tokens equal to ``infer_batched``'s, both K2 at B=4), ``decode_many`` at 2
    and 4 rows against solo chunks and float32, a batched chunk against 4 solo chunks, 4
    ``stream_shared`` clients 50-100 ms apart (captures while their K2 wave decodes, a wave
    of more than one slot, a batched vocoder group), a lone ``stream_shared`` equal to
    ``infer_batched_stream`` of its text (both K1), Japanese ``infer`` and
    ``stream_shared``, ``warmup(stream=True)`` and the two async wrappers.  Counts are
    zeroed just before each drive and read just after; returns the launches summed."""
    import asyncio

    import numpy as np
    import torch

    from gsv_tts_tpu_torch import TTS

    total = {name: 0 for name in launch_counts()}

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    # one 512-row bucket at each batch size: random weights sample no EOS, so every request
    # decodes to its bucket's edge, and a 1024-row one would double the phase's B=1 work
    tts = TTS(gpt_cache=[(1, 512), (2, 512), (4, 512)], models_dir=models_dir, device=dev,
              seed=SEED)
    tts.load_gpt_model(str(gpt))
    tts.load_sovits_model(str(sov))
    engine = tts.gpt_models[str(gpt)].engine
    sov_m, ge = tts._prepare_sovits_resources(str(sov), str(spk))
    args = (str(spk), str(prompt), PROMPT_TEXT)
    greedy = dict(top_k=1, noise_scale=0.0, is_cut_text=False)

    # the engine's harvests by request, for the token check (grouped: the batched stream)
    harvest = {}
    stream_fn = engine.generate_batched_stream

    def spy(*a, grouped=False, **kw):
        toks = harvest.setdefault(grouped, {})
        for item in stream_fn(*a, grouped=grouped, **kw):
            for i, t, _ in (item if grouped else [item]):
                toks.setdefault(i, []).append(np.asarray(t))
            yield item

    engine.generate_batched_stream = spy
    texts = TEXTS[:4]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clips = tts.infer_batched(*args, texts, **greedy)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t0
    bst = dict(tts.last_timings)
    expect_counts("shared phase: infer_batched of 4", read_counts(), k1=bst["k1_steps"],
                  k2=bst["k2_steps"])
    add(read_counts())
    reset_counts()
    t0 = time.perf_counter()
    events = list(tts.infer_batched_stream(*args, texts, **greedy))
    s_wall = time.perf_counter() - t0
    sst = dict(tts.last_timings)
    expect_counts("shared phase: infer_batched_stream of 4", read_counts(), k1=sst["k1_steps"],
                  k2=sst["k2_steps"])
    add(read_counts())
    engine.generate_batched_stream = stream_fn
    for i in range(4):
        want = np.concatenate(harvest[False][i])
        got = np.concatenate(harvest[True][i])
        if not np.array_equal(got, want):
            fail(f"shared phase: infer_batched_stream request {i}: {got.size} tokens, not "
                 f"infer_batched's {want.size} (first difference at "
                 f"{int(np.argmax(got[:min(got.size, want.size)] != want[:min(got.size, want.size)]))})")
    if sorted(i for i, _, d in events if d) != [0, 1, 2, 3] or bst["k2_steps"] == 0:
        fail(f"shared phase: infer_batched_stream ended {[i for i, _, d in events if d]}, K2 "
             f"steps {bst['k2_steps']}")
    for i in range(4):
        audio = np.concatenate([c.audio_data for j, c, _ in events if j == i])
        check_audio(f"shared phase: infer_batched_stream request {i}", audio, int(0.4 * 32000),
                    1024 * 1280 + int(0.8 * 32000))
    vb = tts.vocoder_batch_stats()
    print(f"shared phase: infer_batched_stream of 4: tokens equal infer_batched's "
          f"({sst['tokens']} tokens; K2 {sst['k2_steps']} steps, K1 {sst['k1_steps']}), "
          f"{len(events)} events in {s_wall:.2f} s (infer_batched {b_wall:.2f} s), SoVITS "
          f"{sst['sovits_s']:.2f} s, vocoder batches {vb}; {card}", flush=True)

    voc = vocoder_batch_checks(tts, sov_m, ge, models_dir, sov, spk, card)

    # 4 shared-stream clients, 50-100 ms apart
    before = wave_totals(tts, gpt)
    vb0 = tts.vocoder_batch_stats()
    tts.sovits_graphs.evict(sov_m.params)
    reset_counts()
    clients = shared_clients(tts, gpt, spk, prompt, TEXTS[4:8], card)
    counts = read_counts()
    totals = wave_totals(tts, gpt)
    d = wave_delta(totals, before)
    expect_counts(f"shared phase: 4 stream_shared clients ({d['decode_steps']} wave steps)",
                  counts, k1=d["k1_steps"], k2=d["k2_steps"])
    add(counts)
    vb = tts.vocoder_batch_stats()
    groups = vb["rows"] - vb0["rows"] - (vb["solo_rows"] - vb0["solo_rows"])
    if totals["max_live"] < 2 or vb["max_group"] < 2 or groups < 2:
        fail(f"shared phase: wave totals {totals}, vocoder batches {vb}")
    if clients["captures_beside_k2"] == 0:
        fail(f"shared phase: no SoVITS capture ran while a wave of two or more slots was live "
             f"({clients})")
    wave_ms = 1000 * d["k2_s"] / max(d["k2_steps"], 1)
    b_ms = 1000 * bst["decode_s"] / bst["decode_steps"]
    # a chunk's host time ends in a read-back, which waits for the vocoder replays other
    # threads queued on the same stream meanwhile
    print(f"shared phase: the wave: {d['tokens']} tokens in {d['decode_s']:.2f} s of chunks = "
          f"{d['tokens'] / d['decode_s']:.1f} tok/s aggregate, {wave_ms:.3f} ms per K2 step "
          f"({d['k2_steps']} K2 steps, {d['k1_steps']} K1, most live slots "
          f"{totals['max_live']}); infer_batched of 4 in this process: "
          f"{bst['tokens'] / bst['decode_s']:.1f} tok/s, {b_ms:.3f} ms a step; SoVITS graphs "
          f"captured meanwhile {clients['captures']} in {clients['capture_s']:.2f} s "
          f"({clients['captures_beside_k2']} while a K2 wave was live); vocoder batches "
          f"{vb}; {card}", flush=True)

    # a lone shared stream equals infer_batched_stream of its text (both K1)
    reset_counts()
    before = wave_totals(tts, gpt)
    lone = [c.audio_data for c in tts.stream_shared(*args, TEXTS[8], debug=False, **greedy)]
    d = wave_delta(wave_totals(tts, gpt), before)
    lone_counts = read_counts()
    one = [c.audio_data for _, c, _ in tts.infer_batched_stream(*args, [TEXTS[8]], **greedy)]
    counts = read_counts()
    expect_counts("shared phase: a lone stream_shared and infer_batched_stream of its text",
                  counts, k1=d["k1_steps"] + tts.last_timings["k1_steps"])
    add(counts)
    if d["k2_steps"] or lone_counts["k1"] != d["k1_steps"]:
        fail(f"shared phase: the lone stream took {d}")
    # the two vocode the same chunks, except where the wave hands a request's last tokens
    # as an event of their own right after a chunk came due: stream_shared then vocodes
    # that chunk and the final pass apart, infer_batched_stream (one event list a decode
    # chunk) in one pass (the JAX facade's semantics, both ways)
    same_split = [x.size for x in lone[:-2]] == [y.size for y in one[:len(lone) - 2]]
    whole = np.array_equal(np.concatenate(lone), np.concatenate(one))
    if not (whole or (same_split and len(lone) == len(one) + 1
                      and sum(x.size for x in lone) == sum(y.size for y in one)
                      and all(np.array_equal(x, y) for x, y in zip(lone[:-2], one)))):
        first = next((i for i, (x, y) in enumerate(zip(lone, one))
                      if x.shape != y.shape or not np.array_equal(x, y)), None)
        fail(f"shared phase: a lone stream_shared differs from infer_batched_stream of its "
             f"text: chunks {[x.size for x in lone]} against {[y.size for y in one]}, the "
             f"first differing {first}")
    print(f"shared phase: a lone stream_shared ({len(lone)} chunks, {d['k1_steps']} K1 steps) "
          f"equals infer_batched_stream of its text sample for sample"
          + ("" if whole else " up to the final pass, which the batched stream merges with "
             "the chunk before it (same total length)"), flush=True)

    # Japanese
    reset_counts()
    ja = tts.infer(*args, JA_TEXTS[0])
    st = dict(tts.last_timings)
    before = wave_totals(tts, gpt)
    ja_chunks = [c.audio_data for c in tts.stream_shared(*args, JA_TEXTS[1], debug=False)]
    d = wave_delta(wave_totals(tts, gpt), before)
    expect_counts("shared phase: Japanese infer and stream_shared", read_counts(),
                  k1=st["decode_steps"] + d["k1_steps"], k2=d["k2_steps"])
    add(read_counts())
    check_audio("shared phase: Japanese infer", ja.audio_data, int(0.2 * 32000),
                st["tokens"] * 1280 + int(0.2 * 32000))
    if not ja_chunks or not all(np.all(np.isfinite(c)) for c in ja_chunks):
        fail("shared phase: Japanese stream_shared gave no audio or audio not finite")
    print(f"shared phase: Japanese: infer {st['decode_steps']} K1 steps, "
          f"{ja.audio_len_s:.2f} s of audio; stream_shared {len(ja_chunks)} chunks", flush=True)

    # warmup(stream=True) and the async wrappers
    reset_counts()
    before = wave_totals(tts, gpt)
    wst = tts.warmup(stream=True)
    st = dict(tts.last_timings)

    async def drive():
        shared = [c async for c in tts.stream_shared_async(*args, TEXTS[9], debug=False)]
        batched = [e async for e in tts.infer_batched_stream_async(*args, TEXTS[10:12],
                                                                   is_cut_text=False)]
        return shared, batched

    shared, batched = asyncio.run(asyncio.wait_for(drive(), timeout=CLIENT_DEADLINE_S))
    bst2 = dict(tts.last_timings)
    d = wave_delta(wave_totals(tts, gpt), before)
    expect_counts("shared phase: warmup(stream=True), stream_shared_async and "
                  "infer_batched_stream_async", read_counts(),
                  k1=st["decode_steps"] + d["k1_steps"] + bst2["k1_steps"],
                  k2=d["k2_steps"] + bst2["k2_steps"])
    add(read_counts())
    if "stream_s" not in wst or not shared or sorted(i for i, _, x in batched if x) != [0, 1]:
        fail(f"shared phase: warmup {wst}, {len(shared)} async chunks, async batched ends "
             f"{[i for i, _, x in batched if x]}")
    print(f"shared phase: warmup(stream=True) {json.dumps({k: round(v, 3) for k, v in wst.items()})}"
          f"; stream_shared_async {len(shared)} chunks; infer_batched_stream_async "
          f"{len(batched)} events", flush=True)
    for sched in list(tts._wave_schedulers.values()):
        sched.close()
    if tts._vocoder_batcher is not None:
        tts._vocoder_batcher.close()
    del tts, engine, sov_m, ge
    torch.cuda.empty_cache()
    return total, {"voc": voc, "clients": clients}


# -- phase 12: single-card fine-tuning ----------------------------------------------------------

TRAIN_WORDS = ("the a small green house stood near river where children played every summer "
               "morning while old friends talked about music books travel weather gardens "
               "city lights quiet roads and bright stars over distant hills before evening "
               "came slowly across open fields").split()
TRAIN_CLIPS = 8
T2S_STEPS, T2S_BATCH, T2S_LR, T2S_WARMUP = 30, 8, 1e-3, 5
SOV_STEPS, SOV_BATCH = 10, 4
# bf16 against float32 at step 0, the same params (bf16 values): the loss within 2 % and
# every trained leaf's gradient at a cosine of at least 0.99 with float32's (24 post-norm
# layers round each activation to bf16, 2^-9 relative)
TRAIN_LOSS_REL_TOL = 2e-2
TRAIN_GRAD_COS_MIN = 0.99


def write_train_clips(root: Path, n: int = TRAIN_CLIPS):
    """``n`` clips of 4-10 s (harmonics on a gliding pitch, a syllable-rate envelope and
    noise) with English sentences of 8-20 words, all from SEED, and their ``.list``
    manifest; returns the manifest's path."""
    import numpy as np

    from gsv_tts_tpu_torch.utils.audio_io import save_wav

    rng = np.random.RandomState(SEED + 12)
    lines = []
    for i in range(n):
        secs = rng.uniform(4.0, 10.0)
        t = np.arange(int(32000 * secs)) / 32000
        f0 = rng.uniform(110, 260) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t))
        phase = 2 * np.pi * np.cumsum(f0) / 32000
        wav = sum(np.sin(k * phase) / k for k in range(1, 6))
        wav *= 0.15 * (1 + np.sin(2 * np.pi * rng.uniform(3, 5) * t))
        save_wav(root / f"train{i}.wav", (wav + 0.01 * rng.randn(len(t))).astype(np.float32),
                 32000)
        words = rng.choice(TRAIN_WORDS, size=int(rng.randint(8, 21)))
        lines.append(f"train{i}.wav|spk|en|{' '.join(words).capitalize()}.")
    (root / "train.list").write_text("\n".join(lines) + "\n")
    return root / "train.list"


def f32_t2s(params):
    """t2s params with every model tensor in float32 (the bf16 values, widened)."""
    from gsv_tts_tpu_torch.parallel.train import T2S_TOP

    out = {k: params[k].float() for k in T2S_TOP}
    out["layers"] = [{k: v.float() for k, v in lp.items()} for lp in params["layers"]]
    out["pe"] = params["pe"]
    return out


def nondeterministic_ops(fn) -> list:
    """The operations ``fn`` runs that PyTorch flags as nondeterministic on this card
    (``use_deterministic_algorithms(True, warn_only=True)``: one warning each)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split(" does not have")[0].split(". ")[0][:120]
                   for w in caught if "determinis" in str(w.message).lower()})


def leaves_apart(a: dict, b: dict):
    """(leaves that differ, the largest absolute difference) of two named tensor dicts."""
    import torch

    diff = [float((a[k].detach().float() - b[k].detach().float()).abs().max()) for k in a
            if not torch.equal(a[k].detach(), b[k].detach())]
    return len(diff), max(diff, default=0.0)


def loss_logger(*names: str):
    """A ``log_fn`` for the loops with ``log_every=1`` that keeps each step's value of each
    name the log line carries (``loss``; ``g``, ``d``)."""
    import re

    values = {name: [] for name in names}

    def log(line: str):
        for name in names:
            m = re.search(rf"(?:^|\s){name} (\S+)", line)
            if m:
                values[name].append(float(m.group(1)))

    return log, values


def cuda_steps_ms(step, n: int) -> float:
    """ms a call of ``step()`` over ``n`` calls after one warm call (host clock, synchronised)."""
    import torch

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return 1000 * (time.perf_counter() - t0) / n


def train_phase(models_dir, gpt, v2pro, spk, prompt, dev, card):
    """Single-card fine-tuning (phase 12) at full width: featurize 8 synthesized clips
    through the port's ``TTS`` (frontend, HuBERT, RVQ codes, each clip's ERes2NetV2
    embedding), ``finetune_t2s`` (bf16, batch 8, 30 steps, a checkpoint at 15) straight and
    resumed from the midpoint, the loss finite at every step and a fixed batch's loss lower
    after than before, bf16 against float32 loss and gradients at step 0, the export loaded
    by ``TTS.load_gpt_model`` and decoded through K1 (launches equal to the decode steps);
    ``finetune_sovits`` on v2ProPlus (batch 4, ``segment_frames`` from the hparams, 10 GAN
    steps) straight and resumed once, the frozen RVQ leaves bit for bit, the export loaded
    and decoded.  Straight against resumed: bit for bit or the leaves apart, the ops PyTorch
    flags as nondeterministic, and for SoVITS one step twice from one state with cuDNN's
    default and deterministic algorithms and the mel loss's gradient twice.  Returns the
    launch counts and the readings."""
    import numpy as np
    import torch

    from gsv_tts_tpu_torch import TTS, train_data
    from gsv_tts_tpu_torch.models import sovits_train as svt
    from gsv_tts_tpu_torch.parallel import train as ptrain
    from gsv_tts_tpu_torch.train_loop import (_step_generator, finetune_sovits, finetune_t2s,
                                              sovits_batches)
    from gsv_tts_tpu_torch.utils.audio_io import load_audio

    total = {name: 0 for name in launch_counts()}
    root = Path(models_dir)
    t0 = time.perf_counter()
    items = train_data.read_manifest(write_train_clips(root))
    tts = TTS(gpt_cache=[(1, 512), (1, 1024)], models_dir=models_dir, device=dev, seed=SEED)
    tts.load_gpt_model(str(gpt))
    tts.load_sovits_model(str(v2pro))
    g = tts.gpt_models[str(gpt)]
    s = tts.sovits_models[str(v2pro)]
    audio_s = sum(load_audio(w)[0].shape[-1] / 32000 for w, _, _ in items)
    tts._get_cnhubert()  # loaded before the timing, as a served facade has them
    tts._get_sv_model()
    print(f"train phase: {len(items)} clips ({audio_s:.1f} s) written, models loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 1. featurize on the card
    t0 = time.perf_counter()
    samples = train_data.featurize(tts, items)
    t1 = time.perf_counter()
    sov_samples = train_data.featurize_sovits(tts, items)
    t2 = time.perf_counter()
    if not all(len(y) > 50 and len(x) > 8 for x, y, _ in samples):
        fail(f"train phase: featurize gave {[(len(x), len(y)) for x, y, _ in samples]}")
    if not all(len(x) == 5 and x[4].shape == (20480,) and np.isfinite(x[4]).all()
               and np.isfinite(x[0]).all() and x[0].shape[-1] == x[1].shape[-1]
               for x in sov_samples):
        fail("train phase: featurize_sovits samples malformed or not finite")
    feat = {"t2s_ms_a_clip": 1000 * (t1 - t0) / len(items),
            "sovits_ms_a_clip": 1000 * (t2 - t1) / len(items)}
    print(f"train phase: featurize {feat['t2s_ms_a_clip']:.1f} ms a clip (frontend, HuBERT, "
          f"RVQ), featurize_sovits {feat['sovits_ms_a_clip']:.1f} ms a clip (STFT, HuBERT, "
          f"ERes2NetV2); {card}", flush=True)

    # 2-3. t2s: bf16 against float32 at step 0, then straight and resumed runs
    cfg = g.cfg
    dt = tts.tts_config.dtype  # bf16 on the card
    batch = next(train_data.batches(cfg, samples, T2S_BATCH, seed=None, device=dev))
    args = (batch["x_ids"], batch["y_ids"], batch["bert"], batch["x_lens"], batch["y_lens"])
    p16 = ptrain.t2s_train_params(g.params)
    p32 = ptrain.t2s_train_params(f32_t2s(g.params))
    l16 = ptrain.t2s_loss(p16, cfg, *args, dt)
    l32 = ptrain.t2s_loss(p32, cfg, *args, torch.float32)
    g16 = torch.autograd.grad(l16, list(ptrain.t2s_leaves(p16).values()))
    g32 = torch.autograd.grad(l32, list(ptrain.t2s_leaves(p32).values()))
    # a leaf whose gradient is zero in both (bert_proj_w: English text has no BERT
    # features) has no direction to compare
    cos = {name: float(torch.nn.functional.cosine_similarity(a.float().flatten(), b.flatten(),
                                                            dim=0))
           for name, a, b in zip(ptrain.t2s_leaves(p16), g16, g32)
           if a.abs().max() > 0 or b.abs().max() > 0}
    worst = min(cos, key=cos.get)
    loss_rel = abs(l16.item() - l32.item()) / abs(l32.item())
    print(f"train phase: step 0 loss bf16 {l16.item():.5f} float32 {l32.item():.5f} (rel "
          f"{loss_rel:.2e}, tol {TRAIN_LOSS_REL_TOL}); gradient cosine min {cos[worst]:.5f} "
          f"({worst}), median {float(np.median(list(cos.values()))):.5f} over {len(cos)} leaves "
          f"(min allowed {TRAIN_GRAD_COS_MIN}; {len(g16) - len(cos)} zero in both)", flush=True)
    if loss_rel > TRAIN_LOSS_REL_TOL or cos[worst] < TRAIN_GRAD_COS_MIN:
        fail("train phase: bf16 loss or gradients too far from float32 at step 0")
    del p32, g16, g32, l16, l32

    kw = dict(total_steps=T2S_STEPS, batch_size=T2S_BATCH, init_params=g.params, device=dev,
              dtype=dt, peak_lr=T2S_LR, warmup_steps=T2S_WARMUP,
              ckpt_every=T2S_STEPS // 2, log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    log, logged = loss_logger("loss")
    losses = logged["loss"]
    t0 = time.perf_counter()
    straight = finetune_t2s(samples, cfg, str(root / "ft_t2s"), log_fn=log, **kw)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    t2s_peak = torch.cuda.max_memory_allocated()
    if len(losses) != T2S_STEPS or not np.all(np.isfinite(losses)):
        fail(f"train phase: t2s losses {losses}")
    quiet = dict(kw, log_fn=lambda *_: None)
    finetune_t2s(samples, cfg, str(root / "ft_t2s_b"), max_steps_this_run=T2S_STEPS // 2,
                 export=False, **quiet)
    resumed = finetune_t2s(samples, cfg, str(root / "ft_t2s_b"), export=False, **quiet)
    t2s_apart = leaves_apart(ptrain.t2s_leaves(straight), ptrain.t2s_leaves(resumed))
    with torch.no_grad():
        before = ptrain.t2s_loss(p16, cfg, *args, dt).item()
        after = ptrain.t2s_loss(straight, cfg, *args, dt).item()
    if not after < before:
        fail(f"train phase: the fixed batch's t2s loss went {before:.4f} -> {after:.4f}")
    opt, _ = ptrain.make_optimizer(ptrain.t2s_leaves(p16), peak_lr=1e-5, warmup_steps=0,
                                   decay_steps=100)
    step = ptrain.make_train_step(cfg, opt, dtype=dt)
    t2s_ms = cuda_steps_ms(lambda: step(p16, batch), 10)
    t2s_nondet = nondeterministic_ops(lambda: step(p16, batch))
    audio_tokens = int(batch["y_lens"].sum())
    del p16, opt, step
    t2s = {"steps": T2S_STEPS, "batch": T2S_BATCH, "loss_first": losses[0],
           "loss_last": losses[-1], "fixed_batch_loss": [before, after],
           "step0_loss_rel": loss_rel, "step0_grad_cos_min": cos[worst],
           "ms_a_step": t2s_ms, "audio_tokens_a_step": audio_tokens,
           "tok_s": audio_tokens / t2s_ms * 1000, "run_s": run_s,
           "peak_gib": t2s_peak / 2**30, "resident_gib_before": base / 2**30,
           "resumed_leaves_apart": t2s_apart[0], "resumed_max_abs": t2s_apart[1],
           "nondeterministic_ops": t2s_nondet}
    print(f"train phase: t2s {T2S_STEPS} steps at batch {T2S_BATCH} (bf16): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, fixed batch {before:.4f} -> {after:.4f}; "
          f"{t2s_ms:.2f} ms a step, {t2s['tok_s']:.0f} trained audio tokens/s "
          f"({audio_tokens} a step); peak {t2s['peak_gib']:.2f} GiB allocated "
          f"({t2s['resident_gib_before']:.2f} before); resumed vs straight: {t2s_apart[0]} "
          f"leaves apart, max {t2s_apart[1]:.3g}; nondeterministic ops {t2s_nondet}; {card}",
          flush=True)

    # 4. export and serve through K1
    out = str(root / "ft_t2s")
    tts.load_gpt_model(out)
    reset_counts()
    steps = 0
    for i in range(2):
        clip = tts.infer(str(spk), str(prompt), PROMPT_TEXT, TEXTS[i], gpt_model=out,
                         sovits_model=str(v2pro))
        st = tts.last_timings
        steps += st["decode_steps"]
        check_audio(f"train phase: fine-tuned t2s infer {i}", clip.audio_data,
                    int(0.2 * 32000), st["tokens"] * 1280 + int(0.2 * 32000))
    counts = read_counts()
    expect_counts(f"train phase: the fine-tuned t2s's infer ({steps} decode steps)", counts,
                  k1=steps)
    for name, n in counts.items():
        total[name] += n

    # 5. SoVITS on v2ProPlus
    hop = int(s.hps.data.hop_length)
    if hop != s.cfg.samples_per_frame:
        fail(f"train phase: hop {hop} is not the vocoder's {s.cfg.samples_per_frame} samples a "
             f"frame")
    seg = int(s.hps.train.segment_size) // hop
    skw = dict(total_steps=SOV_STEPS, batch_size=SOV_BATCH, init_params=s.params, device=dev,
               ckpt_every=SOV_STEPS // 2, log_every=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    log, logged = loss_logger("g", "d")
    g_losses, d_losses = logged["g"], logged["d"]
    t0 = time.perf_counter()
    sov_straight = finetune_sovits(sov_samples, s.cfg, s.hps, str(root / "ft_sov"), log_fn=log,
                                   **skw)
    torch.cuda.synchronize()
    sov_run_s = time.perf_counter() - t0
    sov_peak = torch.cuda.max_memory_allocated()
    if len(g_losses) != SOV_STEPS or len(d_losses) != SOV_STEPS \
            or not np.all(np.isfinite(g_losses + d_losses)):
        fail(f"train phase: SoVITS losses g {g_losses} d {d_losses}")
    squiet = dict(skw, log_fn=lambda *_: None)
    finetune_sovits(sov_samples, s.cfg, s.hps, str(root / "ft_sov_b"),
                    max_steps_this_run=SOV_STEPS // 2, export=False, **squiet)
    sov_resumed = finetune_sovits(sov_samples, s.cfg, s.hps, str(root / "ft_sov_b"),
                                  export=False, **squiet)
    sov_apart = leaves_apart(sov_straight, sov_resumed)
    for k, v in s.params.items():
        if k.startswith(svt.FROZEN_PREFIXES) and not torch.equal(sov_straight[k], v.float()):
            fail(f"train phase: frozen SoVITS leaf {k} moved")
    # a GAN step alone (D + G): its time, the ops PyTorch flags, and which ops make two
    # steps from one state differ (with cuDNN's default algorithms and its deterministic
    # ones; the mel loss's gradient alone)
    sbatch = next(sovits_batches(s.cfg, sov_samples, SOV_BATCH, hop, seed=None, device=dev))
    draws = svt.sovits_draws(s.cfg, sbatch, _step_generator(0, 0, dev))

    def gan_setup():
        gp = {k: v.detach().float().clone() for k, v in sov_straight.items()}
        dp = svt.init_discriminator_params(torch.Generator().manual_seed(1), device=dev)
        g_opt = ptrain.Optimizer({k: v.requires_grad_(True) for k, v in gp.items()
                                  if not k.startswith(svt.FROZEN_PREFIXES)}, lambda _: 1e-6)
        d_opt = ptrain.Optimizer({k: v.requires_grad_(True) for k, v in dp.items()},
                                 lambda _: 1e-6)
        gan = svt.make_sovits_train_step(
            s.cfg, g_opt, d_opt, n_fft=int(s.hps.data.filter_length), hop_length=hop,
            win_length=int(s.hps.data.win_length), sr=int(s.hps.data.sampling_rate),
            segment_frames=seg)
        return gp, dp, lambda: gan(gp, dp, sbatch, *draws)

    gp, dp, gan = gan_setup()
    sov_ms = cuda_steps_ms(gan, 3)
    sov_nondet = nondeterministic_ops(gan)

    def steps_apart():
        after = []
        for _ in range(2):
            gp, dp, gan = gan_setup()
            gan()
            after.append({**gp, **{"D." + k: v for k, v in dp.items()}})
        return leaves_apart(*after)

    def mel_grads_apart():
        y_hat = (0.1 * torch.randn((SOV_BATCH, seg * hop), device=dev,
                                   generator=_step_generator(0, 1, dev))).requires_grad_(True)
        grads = [torch.autograd.grad(svt.mel_spectrogram(
            y_hat, n_fft=int(s.hps.data.filter_length), hop_length=hop,
            win_length=int(s.hps.data.win_length), sr=int(s.hps.data.sampling_rate)).mean(),
            y_hat)[0] for _ in range(2)]
        return leaves_apart({"y_hat": grads[0]}, {"y_hat": grads[1]})

    repeat = {"step": steps_apart()}
    torch.backends.cudnn.deterministic = True
    try:
        repeat["step_cudnn_deterministic"] = steps_apart()
        repeat["mel_grad_cudnn_deterministic"] = mel_grads_apart()
    finally:
        torch.backends.cudnn.deterministic = False
    del gp, dp, gan
    sov = {"steps": SOV_STEPS, "batch": SOV_BATCH, "segment_frames": seg,
           "g_first": g_losses[0], "g_last": g_losses[-1], "d_first": d_losses[0],
           "d_last": d_losses[-1], "ms_a_step": sov_ms, "run_s": sov_run_s,
           "peak_gib": sov_peak / 2**30, "resumed_leaves_apart": sov_apart[0],
           "resumed_max_abs": sov_apart[1], "repeated_apart": repeat,
           "nondeterministic_ops": sov_nondet}
    print(f"train phase: SoVITS v2ProPlus {SOV_STEPS} GAN steps at batch {SOV_BATCH}, "
          f"{seg} frames a slice (float32): g {g_losses[0]:.3f} -> {g_losses[-1]:.3f}, "
          f"d {d_losses[0]:.3f} -> {d_losses[-1]:.3f}; {sov_ms:.1f} ms a step (D + G); peak "
          f"{sov['peak_gib']:.2f} GiB allocated; resumed vs straight: {sov_apart[0]} leaves "
          f"apart, max {sov_apart[1]:.3g}; one step twice from one state, (leaves apart, max): "
          f"{repeat}; frozen leaves bit for bit; ops PyTorch flags as nondeterministic "
          f"{sov_nondet}; {card}", flush=True)

    # the exported SoVITS, with the fine-tuned t2s, through K1
    sov_out = str(root / "ft_sov")
    tts.load_sovits_model(sov_out)
    reset_counts()
    steps, rtf = 0, 0.0
    for i in range(3):  # one text: the first call captures the new model's SoVITS graphs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clip = tts.infer(str(spk), str(prompt), PROMPT_TEXT, TEXTS[2], gpt_model=out,
                         sovits_model=sov_out)
        torch.cuda.synchronize()
        rtf = (time.perf_counter() - t0) / clip.audio_len_s  # the last: warm
        st = tts.last_timings
        steps += st["decode_steps"]
        check_audio(f"train phase: fine-tuned models' infer {i}", clip.audio_data,
                    int(0.2 * 32000), st["tokens"] * 1280 + int(0.2 * 32000))
    counts = read_counts()
    expect_counts(f"train phase: the fine-tuned models' infer ({steps} decode steps)", counts,
                  k1=steps)
    for name, n in counts.items():
        total[name] += n
    print(f"train phase: the fine-tuned t2s and SoVITS served, warm RTF {rtf:.4f}; {card}",
          flush=True)
    del tts, straight, resumed, sov_straight, sov_resumed
    torch.cuda.empty_cache()
    return total, {"featurize": feat, "t2s": t2s, "sovits": sov, "rtf": rtf, "card": card}


# -- phase 13: the serving layer ---------------------------------------------------------------

SERVE_TEXT = TEXTS[0]
SERVE_VOCODER_WINDOW_S = 0.03
# api_v2's sampling keys at greedy (tokens equal on every run) with api_v2's other defaults
SERVE_GREEDY = dict(top_k=1, top_p=1.0, temperature=1.0, repetition_penalty=1.35,
                    noise_scale=0.0, speed=1.0)


def sse_names(body: bytes) -> list:
    """The event names (or, without one, the ``type`` of the data) of an SSE body, in order."""
    out = []
    for block in body.split(b"\n\n"):
        if not block.strip():
            continue
        first = block.split(b"\n", 1)[0].decode()
        out.append(first[7:] if first.startswith("event: ")
                   else json.loads(first[6:])["type"])
    return out


async def streamed(reply) -> list:
    """The chunks of a route's streamed reply, read to its end."""
    from gsv_tts_tpu_torch.serving.server import Stream

    if reply.status != 200 or not isinstance(reply.body, Stream):
        fail(f"serving phase: a stream answered {reply.status} {reply.body[:200]!r}")
    return [c async for c in reply.body]


def wav_of(what, body: bytes):
    import io
    import wave

    import numpy as np

    if body[:4] != b"RIFF":
        fail(f"serving phase: {what}: the body does not open with RIFF: {body[:16]!r}")
    with wave.open(io.BytesIO(body)) as w:
        audio = np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32767
    check_audio(f"serving phase: {what}", audio, int(0.2 * 32000), 1024 * 1280)
    return audio


async def serving_round(server, tts, gpt, spk, prompt, n: int) -> dict:
    """Items 1-4 of phase 13 once: api_v2 wav against a direct ``infer``, api_v2 streamed
    against ``infer_stream``, ``/tts/stream`` not shared (and its error event), shared (3
    concurrent clients; then the admission cap at 1).  Counts are zeroed just before each
    drive and read just after it."""
    import asyncio

    import torch

    from gsv_tts_tpu_torch.serving.server import Stream, pack_raw, pack_wav, wave_header_chunk

    what = f"serving round {n}"
    total = {name: 0 for name in launch_counts()}

    def counted(label, **want):
        counts = read_counts()
        expect_counts(f"{what}: {label}", counts, **want)
        for name, c in counts.items():
            total[name] += c

    q = {"text": SERVE_TEXT, "ref_audio_path": str(prompt), "prompt_text": PROMPT_TEXT,
         "media_type": "wav", "top_k": "1", "noise_scale": "0"}
    # 1. api_v2 wav: the samples of a direct infer with the same arguments
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reply = await server.tts_v2(dict(q))
    api_ms = 1000 * (time.perf_counter() - t0)
    steps = tts.last_timings["decode_steps"]
    counted(f"api_v2 /tts wav ({steps} decode steps)", k1=steps)
    if reply.status != 200 or reply.headers["Content-Type"] != "audio/wav":
        fail(f"{what}: api_v2 answered {reply.status} {reply.headers}")
    wav_of(f"{what}: api_v2 wav", reply.body)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = tts.infer(str(prompt), str(prompt), PROMPT_TEXT, SERVE_TEXT, **SERVE_GREEDY)
    infer_ms = 1000 * (time.perf_counter() - t0)
    want = pack_wav(direct.audio_data, direct.samplerate)
    if reply.body != want:
        fail(f"{what}: api_v2's wav ({len(reply.body)} bytes) is not the direct infer's "
             f"({len(want)} bytes)")
    # 2. api_v2 streaming_mode=1: a wav header chunk, then raw frames of infer_stream's chunks
    reset_counts()
    chunks = await streamed(await server.tts_v2({**q, "streaming_mode": "1"}))
    steps = tts.last_timings["decode_steps"]
    counted(f"api_v2 /tts streaming_mode=1 ({steps} decode steps)", k1=steps)
    clips = list(tts.infer_stream(str(prompt), str(prompt), PROMPT_TEXT, SERVE_TEXT,
                                  is_cut_text=True, cut_minlen=50, cut_mute=0.3,
                                  stream_mode="token", stream_chunk=25, overlap_len=5,
                                  boost_first_chunk=True, debug=False, **SERVE_GREEDY))
    if chunks[0] != wave_header_chunk(sample_rate=32000) or len(chunks) != len(clips) + 1 \
            or b"".join(chunks[1:]) != b"".join(pack_raw(c.audio_data) for c in clips):
        fail(f"{what}: api_v2 streamed {len(chunks)} chunks, not a header and "
             f"infer_stream's {len(clips)} chunks")
    # 3. /tts/stream, not shared: audio x N, one done; "speed": 0 is one error event
    body = {"text": SERVE_TEXT, "speaker_audio": str(spk), "prompt_audio": str(prompt),
            "prompt_text": PROMPT_TEXT, "top_k": 1, "noise_scale": 0}
    reset_counts()
    names = sse_names(b"".join(await streamed(await server.tts_stream(dict(body)))))
    st = dict(tts.last_timings)
    counted(f"/tts/stream ({st['decode_steps']} decode steps)", k1=st["decode_steps"])
    if len(names) < 3 or names != ["audio"] * (len(names) - 1) + ["done"]:
        fail(f"{what}: /tts/stream events {names}")
    sse_ttfa = server.timings.summary()["ttfa_s"]["last"]
    reset_counts()
    errs = sse_names(b"".join(await streamed(await server.tts_stream({**body, "speed": 0}))))
    counted("/tts/stream with speed 0 (no decode)")
    if errs != ["error"]:
        fail(f"{what}: /tts/stream with speed 0 gave {errs}, not one error event")
    # 4. shared: three concurrent clients on the wave (K2), then the admission cap at 1
    shared = {**body, "shared": True}

    async def client():
        return sse_names(b"".join(await streamed(await server.tts_stream(dict(shared)))))

    reset_counts()
    before = wave_totals(tts, gpt)
    outs = await asyncio.wait_for(asyncio.gather(client(), client(), client()),
                                  CLIENT_DEADLINE_S)
    d = wave_delta(wave_totals(tts, gpt), before)
    counted(f"3 shared clients ({d['decode_steps']} wave steps)", k1=d["k1_steps"],
            k2=d["k2_steps"])
    if d["k2_steps"] == 0 or any(o[-1] != "done" or "error" in o or len(o) < 3 for o in outs):
        fail(f"{what}: 3 shared clients: wave {d}, events {outs}")
    sched = tts._get_wave_scheduler(str(gpt))
    tts.wave_max_clients = sched.max_clients = 1
    try:
        reset_counts()
        before = wave_totals(tts, gpt)
        holder = await server.tts_stream(dict(shared))
        it = holder.body.__aiter__()
        first = await it.__anext__()
        refused = await server.tts_stream(dict(shared))
        rest = [first] + [c async for c in it]
        after = await server.tts_stream(dict(shared))
        late = sse_names(b"".join(await streamed(after)))
        d = wave_delta(wave_totals(tts, gpt), before)
        counted(f"the cap at 1: a holder and a later client ({d['decode_steps']} wave steps)",
                k1=d["k1_steps"], k2=d["k2_steps"])
    finally:
        tts.wave_max_clients = sched.max_clients = None
    if refused.status != 503 or refused.headers.get("Retry-After") != "1" \
            or isinstance(refused.body, Stream) or b"capacity" not in refused.body:
        fail(f"{what}: a second shared client at the cap got {refused.status} "
             f"{refused.headers} {refused.body!r:.200}")
    if sse_names(b"".join(rest))[-1] != "done" or late[-1] != "done" or sched.stats["clients"]:
        fail(f"{what}: the holder or the later client did not stream to done "
             f"({sse_names(b''.join(rest))}, {late}; clients {sched.stats['clients']})")
    print(f"{what}: api_v2 wav {api_ms:.1f} ms (direct infer {infer_ms:.1f} ms, the same "
          f"bytes), streamed api_v2 = infer_stream's {len(clips)} chunks; /tts/stream "
          f"{len(names) - 1} audio events + done, time to first audio {1000 * sse_ttfa:.1f} ms "
          f"(infer_stream's ttfa_s {1000 * st['ttfa_s']:.1f} ms); speed 0: one error event; 3 "
          f"shared clients done; at the cap of 1 a second client got 503 + Retry-After 1 "
          f"before any byte, a later one streamed", flush=True)
    return total, {"api_v2_ms": api_ms, "infer_ms": infer_ms, "overhead_ms": api_ms - infer_ms,
                   "sse_ttfa_ms": 1000 * sse_ttfa, "stream_ttfa_ms": 1000 * st["ttfa_s"]}


def serving_phase(models_dir, gpt, sov, spk, prompt, dev, card):
    """The serving layer (phase 13): ``TTSServer``'s route methods driven in one asyncio loop
    on the card, without aiohttp (the card's host has none): items 1-4 twice
    (``serving_round``; the second round captures no graph and builds no library), the
    micro-batcher coalescing 4 api_v2 requests into one ``infer_batched`` (K2) and a lone one
    into ``infer``, OpenAI ``speech`` as wav and SSE and its error envelope, the WebUI's
    ``synth`` through ``fx.enhance_audio``, ``health`` and ``metrics``, and
    ``set_gpt_weights`` reloading the checkpoint with a request after.  Returns the launches
    summed and the phase's readings."""
    import asyncio

    import numpy as np
    import torch

    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.serving.openai_compat import _OpenAISpeech
    from gsv_tts_tpu_torch.serving.server import TTSServer, compile_count
    from gsv_tts_tpu_torch.serving.webui import WebUI
    from gsv_tts_tpu_torch.utils.audio_io import load_audio

    t_phase = time.perf_counter()
    total = {name: 0 for name in launch_counts()}

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    tts = TTS(gpt_cache=[(1, 512), (2, 512), (4, 512)], models_dir=models_dir, device=dev,
              seed=SEED)
    tts.load_gpt_model(str(gpt))
    tts.load_sovits_model(str(sov))
    # which chunks the vocoder batcher groups depends on when the clients' threads hand them
    # in: with its 4 ms window, a second round of the same 3 shared clients met 7 group shapes
    # the first had not (each a CUDA graph of its own).  A window wider than the clients'
    # skew groups the chunks that come due together every time, so that a graph captured in
    # the second round would be a shape leaking, not a regrouping
    tts._get_vocoder_batcher().window_s = SERVE_VOCODER_WINDOW_S
    reset_counts()
    tts.warmup()  # as ``--warmup`` does before the server listens
    add(read_counts())
    server = TTSServer(tts)

    async def drive():
        readings = {}
        counts, readings["round1"] = await serving_round(server, tts, gpt, spk, prompt, 1)
        add(counts)
        # 5. the micro-batcher: 4 concurrent api_v2 requests, one infer_batched (K2)
        bserver = TTSServer(tts, batch_window_ms=50.0, batch_max=4)
        q = {"ref_audio_path": str(prompt), "prompt_text": PROMPT_TEXT, "media_type": "wav",
             "top_k": "1", "noise_scale": "0"}
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replies = await asyncio.gather(*(bserver.tts_v2({**q, "text": t}) for t in TEXTS[:4]))
        batch_ms = 1000 * (time.perf_counter() - t0)
        st = dict(tts.last_timings)
        counts = read_counts()
        expect_counts(f"serving phase: 4 coalesced api_v2 requests ({st['k2_steps']} K2 steps, "
                      f"{st['k1_steps']} K1)", counts, k1=st["k1_steps"], k2=st["k2_steps"])
        add(counts)
        stats = dict(bserver.batcher.stats)
        if stats["calls"] != 1 or stats["requests"] != 4 or st["k2_steps"] == 0:
            fail(f"serving phase: the batcher made {stats}, K2 steps {st['k2_steps']}")
        for i, r in enumerate(replies):
            wav_of(f"coalesced request {i}", r.body)
        reset_counts()
        lone = await bserver.tts_v2({**q, "text": SERVE_TEXT})
        steps = tts.last_timings["decode_steps"]
        counts = read_counts()
        expect_counts(f"serving phase: a lone request through the batcher ({steps} steps)",
                      counts, k1=steps)
        add(counts)
        wav_of("the lone batcher request", lone.body)
        if bserver.batcher.stats["calls"] != 2:
            fail(f"serving phase: the lone request made {bserver.batcher.stats}")
        await bserver.batcher.close()
        print(f"serving phase: 4 api_v2 requests coalesced into one infer_batched in "
              f"{batch_ms:.1f} ms ({st['k2_steps']} K2 steps, {st['k1_steps']} K1, batcher "
              f"{stats}); a lone one took infer ({steps} K1 steps); {card}", flush=True)
        readings["batch_ms"] = batch_ms
        # 6. OpenAI speech: wav, SSE, an unknown voice
        oai = _OpenAISpeech(server, {"alloy": {"speaker_audio": str(spk),
                                               "prompt_audio": str(prompt),
                                               "prompt_text": PROMPT_TEXT}})
        speech = {"input": SERVE_TEXT, "voice": "alloy", "top_k": 1, "noise_scale": 0}
        reset_counts()
        r = await oai.speech(dict(speech))
        steps = tts.last_timings["decode_steps"]
        wav_of("OpenAI speech wav", r.body)
        r = await oai.speech({**speech, "stream_format": "sse"})
        types = sse_names(b"".join(await streamed(r)))
        steps += tts.last_timings["decode_steps"]
        counts = read_counts()
        expect_counts(f"serving phase: OpenAI speech wav and SSE ({steps} steps)", counts,
                      k1=steps)
        add(counts)
        if len(types) < 2 or types != ["speech.audio.delta"] * (len(types) - 1) + \
                ["speech.audio.done"]:
            fail(f"serving phase: OpenAI SSE events {types}")
        r = await oai.speech({"input": "x", "voice": "nope"})
        err = json.loads(r.body)["error"]
        if r.status != 400 or err["type"] != "invalid_request_error" or err["param"] != "voice":
            fail(f"serving phase: an unknown voice got {r.status} {err}")
        # 7. the WebUI's synth through the enhance chain
        ui = WebUI(tts, Path(models_dir) / "webui")
        ui_steps = []
        infer = tts.infer

        def counted_infer(*a, **kw):
            clip = infer(*a, **kw)
            ui_steps.append(tts.last_timings["decode_steps"])
            return clip

        tts.infer = counted_infer
        reset_counts()
        try:
            r = await ui.synth({"text": f"{SERVE_TEXT} <break:0.3/> {TEXTS[1]}",
                                "speaker_audio": str(spk), "prompt_audio": str(prompt),
                                "prompt_text": PROMPT_TEXT, "top_k": 1, "noise_scale": 0,
                                "enhance": True})
        finally:
            del tts.infer
        counts = read_counts()
        expect_counts(f"serving phase: WebUI synth ({sum(ui_steps)} steps)", counts,
                      k1=sum(ui_steps))
        add(counts)
        d = json.loads(r.body)
        audio, sr = load_audio(str(ui.audio_dir / d["audio_url"].rsplit("/", 1)[1]))
        if len(ui_steps) != 2 or sr != 32000 or audio.size < 0.3 * 32000 \
                or not np.all(np.isfinite(audio)):
            fail(f"serving phase: WebUI synth {d}, {len(ui_steps)} infer calls")
        print(f"serving phase: OpenAI speech wav and {len(types) - 1} SSE deltas + done, an "
              f"unknown voice 400 {err['type']}; WebUI synth of 2 segments and a break through "
              f"enhance_audio: {d['duration']} s, RTF {d['rtf']}", flush=True)
        # 8. health and metrics; then a second round of items 1-4 captures nothing new
        h = json.loads((await server.health()).body)
        name = torch.cuda.get_device_name(0)
        if name not in h["device"] or not h["warmed"] or "waves" not in h \
                or "vocoder_batcher" not in h or h["live_arrays"] <= 0:
            fail(f"serving phase: /health {dict((k, h[k]) for k in h if k != 'timings')}")
        m = (await server.metrics()).body.decode()
        if not all(s in m for s in ("gsv_up 1", "gsv_backend_compiles ", "gsv_live_arrays ",
                                    "gsv_wave_clients{", "gsv_ttfa_s_p50 ")):
            fail(f"serving phase: /metrics {m[:400]}")
        graphs0, compiles0 = set(tts.sovits_graphs.graphs), compile_count(tts)
        counts, readings["round2"] = await serving_round(server, tts, gpt, spk, prompt, 2)
        add(counts)
        h2 = json.loads((await server.health()).body)
        if compile_count(tts) != compiles0:
            fail(f"serving phase: the second round compiled {compile_count(tts) - compiles0} "
                 f"more (graphs {sorted(set(tts.sovits_graphs.graphs) - graphs0)})")
        readings["health"] = {k: h2[k] for k in ("device", "warmed", "backend_compiles",
                                                 "live_arrays", "inflight")}
        # 9. set_gpt_weights reloading the checkpoint, then one request
        r = await server.set_gpt_weights({"weights_path": str(gpt)})
        if r.status != 200 or json.loads(r.body) != {"message": "success"}:
            fail(f"serving phase: set_gpt_weights answered {r.status} {r.body!r}")
        reset_counts()
        r = await server.tts_v2({**q, "text": SERVE_TEXT})
        steps = tts.last_timings["decode_steps"]
        counts = read_counts()
        expect_counts(f"serving phase: a request after set_gpt_weights ({steps} steps)",
                      counts, k1=steps)
        add(counts)
        wav_of("the request after set_gpt_weights", r.body)
        return readings

    readings = asyncio.run(drive())
    readings["phase_s"] = time.perf_counter() - t_phase
    readings["card"] = card
    print(f"serving phase: /health {readings['health']}; the second round added no "
          f"backend compile; done in {readings['phase_s']:.1f} s; {card}", flush=True)
    for sched in list(tts._wave_schedulers.values()):
        sched.close()
    if tts._vocoder_batcher is not None:
        tts._vocoder_batcher.close()
    del tts, server
    torch.cuda.empty_cache()
    return total, readings


# ---------------------------------------------------------------------------
# Phase 14: multi-device (torch.distributed), a world of one rank on this card
# ---------------------------------------------------------------------------

MULTI_CACHE = [(1, 512), (4, 512)]
SHARD_CACHE = [(1, 384), (4, 384)]  # the sharded / "xla" drives: ~200 host-bound steps a run
MULTI_BATCH, MULTI_FT_STEPS, MULTI_SOV_STEPS = 8, 4, 2


def multi_samples(cfg, n: int = MULTI_BATCH):
    """``n`` synthesized t2s samples from SEED: 30-80 phonemes with BERT features and
    120-300 semantic tokens each."""
    import numpy as np

    rng = np.random.RandomState(SEED + 14)
    out = []
    for _ in range(n):
        lx, ly = int(rng.randint(30, 81)), int(rng.randint(120, 301))
        out.append((rng.randint(1, cfg.phoneme_vocab_size, lx).astype(np.int32),
                    rng.randint(0, cfg.vocab_size - 1, ly).astype(np.int32),
                    (rng.randn(lx, cfg.bert_dim) * 0.1).astype(np.float32)))
    return out


def multi_sovits_samples(cfg, hop: int, n: int = 4):
    """``n`` synthesized SoVITS samples (HuBERT features, spectrogram, waveform, phones) of
    100-200 frames from SEED."""
    import numpy as np

    rng = np.random.RandomState(SEED + 15)
    out = []
    for _ in range(n):
        T = int(rng.randint(100, 201))
        out.append((rng.randn(768, T).astype(np.float32) * 0.1,
                    np.abs(rng.randn(cfg.spec_channels, T)).astype(np.float32),
                    (rng.randn(T * hop) * 0.1).astype(np.float32),
                    rng.randint(1, 300, size=(int(rng.randint(20, 60)),)).astype(np.int32)))
    return out


class GradRecorder:
    """A ``GradSync`` stand-in that keeps the gradients the optimizer was given, after the
    sync's sums over the ranks (float32 copies by leaf name): the sharded steps are held to
    the single-card step's gradient (a bf16 update of bf16 params rounds small changes away)."""

    def __init__(self, sync):
        self.sync, self.grads = sync, None

    def reduce(self, names, grads):
        grads = list(grads) if self.sync is None else self.sync.reduce(names, grads)
        self.grads = {n: g.detach().float() for n, g in zip(names, grads)}
        return grads

    def leaf_norms(self, names, norms):
        return list(norms) if self.sync is None else self.sync.leaf_norms(names, norms)


def train_variant(kind, cfg, params, batch, dt, mesh, n_micro=2):
    """One AdamW step of ``kind`` from ``params`` on ``mesh``'s ranks: "single" (no
    collective), "tp" (``make_train_step(mesh=)``), "seq" (``seq_mesh=``) or "pp"
    (``make_pp_train_step``, ``mesh`` a ``("dp","pp")`` mesh).  Returns (the loss, {this
    rank's leaf: its gradient, summed over the ranks}, a call of the step again)."""
    from gsv_tts_tpu_torch.parallel import mesh as pmesh
    from gsv_tts_tpu_torch.parallel import pipeline as ppl
    from gsv_tts_tpu_torch.parallel import train as ptrain

    whole = ptrain.t2s_train_params(params)
    kw, p, sync = {}, whole, None
    if kind == "tp":
        p = ptrain.t2s_train_params(pmesh.shard_t2s_params(whole, mesh))
        p["tp"] = pmesh.axis(mesh, "tp")[0]
        sync, kw = ptrain.t2s_grad_sync(list(ptrain.t2s_leaves(p)), mesh=mesh), {"mesh": mesh}
    elif kind == "seq":
        sync = ptrain.t2s_grad_sync(list(ptrain.t2s_leaves(p)), mesh=mesh, seq=True)
        kw = {"seq_mesh": mesh}
    elif kind == "pp":
        p = ppl.shard_pp_params(whole, cfg, mesh)
        sync = ptrain.t2s_grad_sync(list(ptrain.t2s_leaves(p)), pp_mesh=mesh)
    recorder = GradRecorder(sync)
    opt, _ = ptrain.make_optimizer(ptrain.t2s_leaves(p), peak_lr=1e-5, warmup_steps=0,
                                   decay_steps=100, sync=recorder)
    fn = ppl.make_pp_train_step(cfg, opt, mesh, n_micro, dt) if kind == "pp" \
        else ptrain.make_train_step(cfg, opt, dt, **kw)
    rows = pmesh.batch_sharding(mesh)
    local = {k: rows(v) for k, v in batch.items()}
    loss = float(fn(p, local))
    return loss, recorder.grads, (lambda: fn(p, local))


def grads_agree(what, got, want, loss, want_loss, exact):
    """Fail unless a sharded step's loss and gradients are the single-card step's: bit for
    bit (``exact``), or the loss within ``TRAIN_LOSS_REL_TOL`` and every leaf's gradient at a
    cosine of at least ``TRAIN_GRAD_COS_MIN`` (leaves zero in both skipped).  Returns (the
    loss's relative difference, the smallest cosine)."""
    import torch

    rel = abs(loss - want_loss) / abs(want_loss)
    cos = [float(torch.nn.functional.cosine_similarity(got[k].flatten(), want[k].flatten(),
                                                       dim=0))
           for k in want if got[k].abs().max() > 0 or want[k].abs().max() > 0]
    worst = min(cos)
    if exact:
        apart = [k for k in want if not torch.equal(got[k], want[k])]
        if loss != want_loss or apart:
            fail(f"multi phase: {what} is not the single-card step bit for bit (loss {loss} vs "
                 f"{want_loss}; {len(apart)} gradients apart, e.g. {apart[:3]})")
    elif rel > TRAIN_LOSS_REL_TOL or worst < TRAIN_GRAD_COS_MIN:
        fail(f"multi phase: {what}: loss rel {rel:.2e} (tol {TRAIN_LOSS_REL_TOL}), gradient "
             f"cosine min {worst:.5f} (min {TRAIN_GRAD_COS_MIN})")
    return rel, worst


def collective_us(dev, calls: int = 200) -> dict:
    """µs a call of the collectives a tp=2 step or a dp engine's chunk would run, here on a
    one-rank NCCL group (host clock over ``calls`` calls, then a synchronise): an all-reduce
    of one decode row [1, 512] bf16 and of a train step's [8, 512, 512] bf16, an all-gather of
    a chunk's tokens [4, 5] int32."""
    import torch
    import torch.distributed as dist

    out = {}
    for name, t, op in (("all_reduce_row", torch.ones(1, 512, dtype=torch.bfloat16, device=dev),
                         lambda t: dist.all_reduce(t)),
                        ("all_reduce_train", torch.ones(8, 512, 512, dtype=torch.bfloat16,
                                                        device=dev), lambda t: dist.all_reduce(t)),
                        ("all_gather_tokens", torch.ones(4, 5, dtype=torch.int32, device=dev),
                         lambda t: dist.all_gather([torch.empty_like(t)], t))):
        op(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            op(t)
        torch.cuda.synchronize()
        out[name] = 1e6 * (time.perf_counter() - t0) / calls
    return out


def engine_tokens(engine, xs, ys, berts, dev, **kw):
    """``generate_batched`` of the prompts from a generator seeded SEED: {request: tokens}."""
    import torch

    with torch.no_grad():
        pred, idx = engine.generate_batched(
            xs, ys, berts, generator=torch.Generator(device=dev).manual_seed(SEED), **kw)
    return {int(i): p.tolist() for p, i in zip(pred, idx)}


def multi_phase(models_dir, gpt, sov, spk, prompt, dev, card):
    """Phase 14 (multi-device) in a world of one rank over NCCL on this card: the sharded
    ``"xla"`` engine against the unsharded one (tokens bit for bit, no kernel launch, ms a
    step), ``DataParallelEngine`` against the plain engine (greedy and sampled tokens, K1 / K2
    launches equal to its steps), the dp×tp, ``seq_mesh`` and GPipe (pp=1, 2 and 4
    microbatches) train steps against the single-card step on 8 synthesized samples,
    ``finetune_t2s(mesh=)`` straight and resumed, ``finetune_sovits(mesh=)``; with two cards,
    a world of 2 (:func:`two_card_phase`).  Returns the launch counts and the readings."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.parallel import mesh as pmesh
    from gsv_tts_tpu_torch.parallel import pipeline as ppl
    from gsv_tts_tpu_torch.parallel import train as ptrain
    from gsv_tts_tpu_torch.parallel.shard import DataParallelEngine
    from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine
    from gsv_tts_tpu_torch.train_loop import finetune_sovits, finetune_t2s

    total = {name: 0 for name in launch_counts()}

    def add(counts):
        for name, n in counts.items():
            total[name] += n

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    mesh = pmesh.make_mesh()
    x = torch.ones(1, device=dev)
    dist.all_reduce(x)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shape = (pmesh.axis(mesh, "dp")[1], pmesh.axis(mesh, "tp")[1])
    if shape != (1, 1) or dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        fail(f"multi phase: make_mesh() gave dp, tp {shape} over {dist.get_backend()} in a "
             f"world of {dist.get_world_size()}")
    print(f"multi phase: make_mesh() -> dp=1, tp=1 over NCCL on {dev} in {init_s:.2f} s "
          f"(process group, mesh, first all-reduce)", flush=True)

    tts = TTS(gpt_cache=MULTI_CACHE, models_dir=models_dir, device=dev, seed=SEED)
    tts.load_gpt_model(str(gpt))
    tts.load_sovits_model(str(sov))
    g = tts.gpt_models[str(gpt)]
    cfg, dt = g.cfg, g.engine.dtype
    xs, ys, berts = tts._prepare_batched_inputs(str(spk), str(prompt), PROMPT_TEXT, TEXTS[:6],
                                                False, 10, 20, None, None)[8:11]

    # 1. T2SEngine.shard: the "xla" engine's tokens, no kernel, ms a step in turns
    t0 = time.perf_counter()
    xla = T2SEngine(g.params, cfg, SHARD_CACHE, dtype=dt, attn_impl="xla")
    sharded = T2SEngine(g.params, cfg, SHARD_CACHE, dtype=dt).shard(mesh)
    if sharded.attn_impl != "xla" or "k1_table" in sharded.params:
        fail("multi phase: the sharded engine kept a kernel path")
    per_step = {"xla": [], "sharded": []}
    for name, eng in (("xla", xla), ("sharded", sharded), ("sharded", sharded), ("xla", xla)):
        reset_counts()
        torch.cuda.synchronize()
        with torch.no_grad():
            one = eng.generate(xs[0], ys[0], berts[0], top_k=1,
                               generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        st = eng.last_stats
        per_step[name].append((one.ravel().tolist(), 1000 * st["decode_s"] / st["decode_steps"],
                               st["decode_steps"]))
        if name == "sharded":
            expect_counts("multi phase: the sharded engine's generate", read_counts())
    if len({str(t) for t, _, _ in per_step["xla"] + per_step["sharded"]}) != 1:
        fail("multi phase: the sharded engine's generate differs from the xla engine's")
    reset_counts()
    want = engine_tokens(xla, xs, ys, berts, dev, top_k=1)
    reset_counts()
    got = engine_tokens(sharded, xs, ys, berts, dev, top_k=1)
    expect_counts("multi phase: the sharded engine's generate_batched of 6", read_counts())
    if got != want:
        fail("multi phase: the sharded engine's generate_batched differs from the xla engine's")
    # in turns: xla, sharded, sharded, xla
    xla_ms = [ms for _, ms, _ in per_step["xla"]]
    shard_ms = [ms for _, ms, _ in per_step["sharded"]]
    coll = collective_us(dev)
    section_s = {"shard": time.perf_counter() - t0}
    print(f"multi phase: T2SEngine.shard: generate {per_step['xla'][0][2]} steps and "
          f"generate_batched of 6 ({sum(map(len, got.values()))} tokens) equal the xla engine's "
          f"bit for bit, no kernel launched; ms a step (B=1, in turns) xla {xla_ms}, sharded "
          f"{shard_ms} (a one-rank group runs no collective); one NCCL call at world 1, "
          f"µs: {coll}; {card}", flush=True)

    # 2. DataParallelEngine: the plain engine's tokens, greedy and sampled; K1 / K2 = its steps
    t0 = time.perf_counter()
    plain = T2SEngine(g.params, cfg, MULTI_CACHE, dtype=dt)
    dpe = DataParallelEngine(g.params, cfg, MULTI_CACHE, dtype=dt, mesh=mesh)
    dp_read = {}
    for label, kw in (("greedy", {"top_k": 1}), ("sampled", {})):
        want = engine_tokens(plain, xs, ys, berts, dev, **kw)
        reset_counts()
        torch.cuda.synchronize()
        got = engine_tokens(dpe, xs, ys, berts, dev, **kw)
        torch.cuda.synchronize()
        st = dpe.last_stats
        counts = read_counts()
        expect_counts(f"multi phase: DataParallelEngine generate_batched of 6 ({label})", counts,
                      k1=st["k1_steps"], k2=st["k2_steps"])
        add(counts)
        if got != want:
            fail(f"multi phase: DataParallelEngine ({label}) differs from the plain engine")
        if st["k2_steps"] == 0:
            fail(f"multi phase: DataParallelEngine ({label}) took no K2 step")
        dp_read[label] = {"k1_steps": st["k1_steps"], "k2_steps": st["k2_steps"],
                          "ms_a_step": 1000 * st["decode_s"] / st["decode_steps"]}
    print(f"multi phase: DataParallelEngine(mesh=) generate_batched of 6 on {MULTI_CACHE}: "
          f"greedy and sampled tokens equal the plain engine's; {dp_read}", flush=True)
    del xla, sharded, plain, dpe
    section_s["dp_engine"] = time.perf_counter() - t0

    # 3. the train steps against the single-card step: loss and gradients; ms a step in
    # turns, the single step first and last
    t0 = time.perf_counter()
    samples = multi_samples(cfg)
    batch = ptrain.pad_batch(cfg, samples, device=dev)
    want_loss, want, again = train_variant("single", cfg, g.params, batch, dt, mesh)
    train_read = {"single_loss": want_loss, "single_ms_a_step": cuda_steps_ms(again, 3)}
    pp_mesh = ppl.make_mesh_dp_pp()
    for kind, n_micro, exact in (("tp", 2, True), ("seq", 2, True), ("pp", 2, False),
                                 ("pp", 4, False)):
        loss, grads, again = train_variant(kind, cfg, g.params, batch, dt,
                                           pp_mesh if kind == "pp" else mesh, n_micro)
        label = f"pp n_micro={n_micro}" if kind == "pp" else kind
        rel, worst = grads_agree(f"the {label} step", grads, want, loss, want_loss, exact)
        train_read[label] = {"loss_rel": rel, "grad_cos_min": worst,
                             "ms_a_step": cuda_steps_ms(again, 3)}
        del grads, again
    _, _, again = train_variant("single", cfg, g.params, batch, dt, mesh)
    train_read["single_ms_a_step_last"] = cuda_steps_ms(again, 3)
    del want, again
    section_s["train_steps"] = time.perf_counter() - t0
    print(f"multi phase: train steps on a batch of {MULTI_BATCH} (bf16) against the "
          f"single-card step: {train_read}", flush=True)

    # 4. the loops over the mesh: t2s straight and resumed, SoVITS
    t_loops = time.perf_counter()
    root = Path(models_dir)
    kw = dict(total_steps=MULTI_FT_STEPS, batch_size=4, init_params=g.params, device=dev,
              dtype=dt, peak_lr=T2S_LR, warmup_steps=1, ckpt_every=100, log_every=1,
              mesh=mesh, export=False)
    log, logged = loss_logger("loss")
    t0 = time.perf_counter()
    straight = finetune_t2s(samples, cfg, str(root / "mesh_t2s_a"), log_fn=log, **kw)
    ft_s = time.perf_counter() - t0
    quiet = dict(kw, log_fn=lambda *_: None)
    finetune_t2s(samples, cfg, str(root / "mesh_t2s_b"), max_steps_this_run=2, **quiet)
    resumed = finetune_t2s(samples, cfg, str(root / "mesh_t2s_b"), **quiet)
    apart = leaves_apart(ptrain.t2s_leaves(straight), ptrain.t2s_leaves(resumed))
    if apart[0] or len(logged["loss"]) != MULTI_FT_STEPS or \
            not np.all(np.isfinite(logged["loss"])):
        fail(f"multi phase: finetune_t2s(mesh=) losses {logged['loss']}, straight against "
             f"resumed at 2: {apart[0]} leaves apart (largest {apart[1]})")
    s = tts.sovits_models[str(sov)]
    hop = int(s.hps.data.hop_length)
    slog, slogged = loss_logger("g", "d")
    t0 = time.perf_counter()
    finetune_sovits(multi_sovits_samples(s.cfg, hop), s.cfg, s.hps, str(root / "mesh_sovits"),
                    total_steps=MULTI_SOV_STEPS, batch_size=2, init_params=s.params,
                    device=dev, mesh=mesh, ckpt_every=100, log_every=1, export=False,
                    log_fn=slog)
    sov_s = time.perf_counter() - t0
    if len(slogged["g"]) != MULTI_SOV_STEPS or \
            not np.all(np.isfinite(slogged["g"] + slogged["d"])):
        fail(f"multi phase: finetune_sovits(mesh=) losses {slogged}")
    section_s["loops"] = time.perf_counter() - t_loops
    loops = {"t2s_losses": logged["loss"], "t2s_s": ft_s, "resumed_equal": True,
             "sovits_g": slogged["g"], "sovits_d": slogged["d"], "sovits_s": sov_s}
    print(f"multi phase: finetune_t2s(mesh=) {MULTI_FT_STEPS} steps (batch 4) straight and "
          f"resumed at 2 bit for bit, finetune_sovits(mesh=) {MULTI_SOV_STEPS} GAN steps "
          f"(batch 2): {loops}", flush=True)
    del tts, g, straight, resumed
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # 5. two cards: a world of 2
    two = two_card_phase(str(gpt), xs, ys, berts)
    readings = {"nccl_init_s": init_s, "xla_ms_a_step": xla_ms, "sharded_ms_a_step": shard_ms,
                "collective_us_world1": coll,
                "dp_engine": dp_read, "train": train_read, "loops": loops, "two_cards": two,
                "section_s": section_s, "phase_s": time.perf_counter() - t_phase}
    return total, readings


def two_card_phase(gpt_dir, xs, ys, berts):
    """With at least two cards: a world of 2 over NCCL (``parallel/launch.py``, each rank
    refusing ``jax``) runs the sharded engine at tp=2, ``DataParallelEngine`` at dp=2 and the
    train steps at dp=2, tp=2 and pp=2 against each rank's own single-card results
    (:func:`two_card_rank`).  With one card, says so (not a failure)."""
    import torch

    if torch.cuda.device_count() < 2:
        print(f"multi phase: the world-of-2 runs (tp=2, dp=2, pp=2) need two cards; this "
              f"machine has {torch.cuda.device_count()}", flush=True)
        return "needs two cards"
    from gsv_tts_tpu_torch.parallel.launch import spawn

    out = spawn(two_card_rank, 2, gpt_dir, "cuda", xs, ys, berts, timeout=600)
    for rank, res in enumerate(out):
        for what, ok in res["checks"].items():
            if not ok:
                fail(f"multi phase, world of 2, rank {rank}: {what}")
    print(f"multi phase: world of 2 over NCCL: {out[0]['readings']}", flush=True)
    return out[0]["readings"]


def two_card_rank(gpt_dir, device_type, xs, ys, berts):
    """One rank of :func:`two_card_phase` (also runs on the CPU over gloo with
    ``device_type="cpu"``): each rank computes the single-card results itself, then the
    sharded ones, and returns which agree and their readings."""
    import torch

    from gsv_tts_tpu_torch.config import Config
    from gsv_tts_tpu_torch.loader import get_gpt_weights
    from gsv_tts_tpu_torch.parallel import mesh as pmesh
    from gsv_tts_tpu_torch.parallel import pipeline as ppl
    from gsv_tts_tpu_torch.parallel import train as ptrain
    from gsv_tts_tpu_torch.parallel.shard import DataParallelEngine
    from gsv_tts_tpu_torch.runtime.t2s_session import T2SEngine

    pmesh.init_world(device_type)
    dev = torch.device(device_type, torch.cuda.current_device()) if device_type == "cuda" \
        else torch.device("cpu")
    g = get_gpt_weights(gpt_dir, Config(device=dev, gpt_cache=MULTI_CACHE))
    cfg, dt = g.cfg, g.engine.dtype
    checks, readings = {}, {}
    xla = engine_tokens(T2SEngine(g.params, cfg, MULTI_CACHE, dtype=dt, attn_impl="xla"),
                        xs, ys, berts, dev, top_k=1)
    plain = engine_tokens(T2SEngine(g.params, cfg, MULTI_CACHE, dtype=dt), xs, ys, berts, dev,
                          top_k=1)
    tp2 = pmesh.make_mesh(dp=1, tp=2, device=device_type)
    got = engine_tokens(T2SEngine(g.params, cfg, MULTI_CACHE, dtype=dt).shard(tp2), xs, ys,
                        berts, dev, top_k=1)
    same = sum(a[:40] == b[:40] for a, b in zip(sorted(got.items()), sorted(xla.items())))
    checks["tp=2 engine: the first 40 tokens of at least 5 of 6 requests as the xla engine's "
           "(bf16 partial sums)"] = same >= 5
    readings["tp2_requests_equal_first_40"] = same
    dp2 = pmesh.make_mesh(dp=2, tp=1, device=device_type)
    got = engine_tokens(DataParallelEngine(g.params, cfg, MULTI_CACHE, dtype=dt, mesh=dp2), xs,
                        ys, berts, dev, top_k=1)
    same = sum(a[:40] == b[:40] for a, b in zip(sorted(got.items()), sorted(plain.items())))
    checks["dp=2 engine: the first 40 tokens of at least 5 of 6 requests as the plain "
           "engine's"] = same >= 5
    readings["dp2_requests_equal_first_40"] = same
    batch = ptrain.pad_batch(cfg, multi_samples(cfg), device=dev)
    want_loss, want, _ = train_variant("single", cfg, g.params, batch, dt, None)
    for label, kind, mesh in (("dp=2", "tp", dp2), ("tp=2", "tp", tp2), ("seq tp=2", "seq", tp2),
                              ("pp=2", "pp", ppl.make_mesh_dp_pp(dp=1, pp=2,
                                                                 device=device_type))):
        loss, grads, _ = train_variant(kind, cfg, g.params, batch, dt, mesh)
        if kind == "tp":
            grads = ptrain.t2s_leaves(pmesh.gather_t2s_params(ptrain.t2s_tree(grads), mesh))
        elif kind == "pp":
            nested = ptrain.t2s_tree(grads)
            grads = ptrain.t2s_leaves({**nested, "layers": ppl.gather_pp_layers(
                nested["layers"], mesh)})
        rel = abs(loss - want_loss) / abs(want_loss)
        cos = min(float(torch.nn.functional.cosine_similarity(grads[k].flatten(),
                                                               want[k].flatten(), dim=0))
                  for k in want if grads[k].abs().max() > 0 or want[k].abs().max() > 0)
        checks[f"{label} step: loss within {TRAIN_LOSS_REL_TOL} and gradient cosine at least "
               f"{TRAIN_GRAD_COS_MIN}"] = rel <= TRAIN_LOSS_REL_TOL and cos >= TRAIN_GRAD_COS_MIN
        readings[label] = {"loss_rel": rel, "grad_cos_min": cos}
    return {"checks": checks, "readings": readings}


# ---------------------------------------------------------------------------
# 15: the host C++ DSP library and the public surface
# ---------------------------------------------------------------------------

ENHANCE_TOL = 1e-5  # the enhance chain through the library against its numpy path
MEL_CARD_TOL = 1e-3  # mean |log-mel| difference, the card's FFT against the CPU's


def host_phase(models_dir, gpt, sov, spk, prompt, dev, card):
    """The host DSP library and the public surface (phase 15): the library's build (in phase
    2), ``enhance_audio`` through it against its numpy path on 10 s of seeded audio and on an
    ``infer`` clip, the envelope follower and Freeverb called on the native run only;
    ``infer(return_subtitles=True)`` and ``infer_stream`` at ``top_k=1, noise_scale=0`` once
    through the library and once through numpy (``GSV_DISABLE_NATIVE``): the same tokens,
    subtitles, SOLA offsets and audio, the library's Viterbi and SOLA called on the native run,
    K1 launches equal to the decode steps; ``sola_align`` at the stream's shapes finding a
    known shift through both paths; the log-mel metric on the card
    against the CPU; the package's exports; ``play`` / ``audio_queue.wait``; a non-WAV
    ``save``; ``check_pretrained_models`` on an empty directory offline, with every socket
    connect refused.  Returns the launches summed and the phase's readings."""
    import os
    import socket
    import threading

    import numpy as np

    import gsv_tts_tpu_torch
    from gsv_tts_tpu_torch import dsp, fx
    from gsv_tts_tpu_torch.download import check_pretrained_models
    from gsv_tts_tpu_torch.ops import stft
    from gsv_tts_tpu_torch.utils import cuda_build, native

    t_phase = time.perf_counter()
    total = {name: 0 for name in launch_counts()}
    lib = native.native_lib()
    if lib is None:
        fail("host phase: native_lib() is None: the host library was not built")
    info = cuda_build.build_info["gsv_native"]
    print(f"host phase: host library {info['path']} ({info['seconds']:.2f} s to build in phase "
          f"2)", flush=True)

    def fx_calls():
        return {k: lib.calls[k] for k in ("envelope_follow", "freeverb")}

    def enhance_both(audio):
        """(native ms, numpy ms, largest difference) of ``enhance_audio`` on ``audio``; the
        native run must call the envelope follower and Freeverb, the numpy run neither."""
        c0 = fx_calls()
        t0 = time.perf_counter()
        a = fx.enhance_audio(audio, 32000)
        t1 = time.perf_counter()
        c1 = fx_calls()
        os.environ["GSV_DISABLE_NATIVE"] = "1"
        try:
            b = fx.enhance_audio(audio, 32000)
        finally:
            del os.environ["GSV_DISABLE_NATIVE"]
        t2 = time.perf_counter()
        c2 = fx_calls()
        if not all(c1[k] > c0[k] and c2[k] == c1[k] for k in c0):
            fail(f"host phase: enhance_audio library calls before / after native / after numpy "
                 f"{c0} / {c1} / {c2}")
        if not (np.all(np.isfinite(a)) and np.abs(a).max() > 0):
            fail("host phase: enhance_audio through the library is not finite, or silent")
        return 1000 * (t1 - t0), 1000 * (t2 - t1), float(np.abs(a - b).max())

    rng = np.random.RandomState(SEED)
    t = np.arange(10 * 32000) / 32000
    seeded = (0.4 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 3 * t))
              + 0.05 * rng.randn(t.size)).astype(np.float32)
    enhance = {"seeded_10s": enhance_both(seeded)}

    tts = gsv_tts_tpu_torch.TTS(gpt_cache=[(1, 512)], models_dir=models_dir, device=dev,
                                seed=SEED)
    tts.load_gpt_model(str(gpt))
    tts.load_sovits_model(str(sov))
    engine = tts.gpt_models[str(gpt)].engine
    text = TEXTS[1]
    runs, sola_shapes = {}, []
    for label in ("native", "numpy"):
        tokens, offsets = [], []
        real_stream, real_sola = engine._generate_stream, dsp.sola_align

        def recording_stream(*a, **kw):
            last = None
            for item in real_stream(*a, **kw):
                last = item
                yield item
            tokens.append(np.asarray(last[0]).reshape(-1).copy())

        def recording_sola(*a, **kw):
            out = real_sola(*a, **kw)
            offsets.append(out[1])
            sola_shapes.append((np.asarray(a[0]).size, np.asarray(a[1]).size, a[2]))
            return out

        engine._generate_stream, dsp.sola_align = recording_stream, recording_sola
        if label == "numpy":
            os.environ["GSV_DISABLE_NATIVE"] = "1"
        calls = dict(lib.calls)
        reset_counts()
        try:
            clip = tts.infer(str(spk), str(prompt), PROMPT_TEXT, text, return_subtitles=True,
                             top_k=1, noise_scale=0.0)
            steps = tts.last_timings["decode_steps"]
            t0 = time.perf_counter()
            chunks = list(tts.infer_stream(str(spk), str(prompt), PROMPT_TEXT, text,
                                           is_cut_text=False, top_k=1, noise_scale=0.0))
            stream_s = time.perf_counter() - t0
            steps += tts.last_timings["decode_steps"]
        finally:
            del engine._generate_stream
            dsp.sola_align = real_sola
            os.environ.pop("GSV_DISABLE_NATIVE", None)
        counts = read_counts()
        expect_counts(f"host phase: infer + infer_stream through {label} ({steps} steps)",
                      counts, k1=steps)
        for name, n in counts.items():
            total[name] += n
        calls = {k: lib.calls[k] - calls[k] for k in calls}
        check_audio(f"host phase: infer ({label})", clip.audio_data, int(0.2 * 32000),
                    len(tokens[0]) * 1280 + int(0.2 * 32000))
        stream_audio = np.concatenate([c.audio_data for c in chunks])
        if len(chunks) < 2 or not np.all(np.isfinite(stream_audio)) or not clip.subtitles:
            fail(f"host phase: {label}: {len(chunks)} chunks, subtitles {clip.subtitles}")
        runs[label] = {"tokens": tokens, "offsets": offsets, "audio": clip.audio_data,
                       "subtitles": clip.subtitles, "stream": stream_audio, "calls": calls,
                       "chunks": len(chunks), "clip": clip, "stream_s": stream_s}
        print(f"host phase: infer(return_subtitles=True) and infer_stream through {label}: "
              f"{len(tokens[0])} + {len(tokens[1])} tokens, {len(clip.subtitles)} subtitles, "
              f"{len(chunks)} chunks, SOLA offsets {offsets}; library calls {calls}",
              flush=True)
    nat, num = runs["native"], runs["numpy"]
    if nat["calls"]["viterbi_monotonic"] == 0 or nat["calls"]["sola_offset"] == 0:
        fail(f"host phase: the native run called the library {nat['calls']}")
    if any(num["calls"].values()):
        fail(f"host phase: the numpy run called the library {num['calls']}")
    same = (len(nat["tokens"]) == len(num["tokens"]) == 2
            and all(np.array_equal(a, b) for a, b in zip(nat["tokens"], num["tokens"]))
            and nat["offsets"] == num["offsets"] and nat["subtitles"] == num["subtitles"]
            and np.array_equal(nat["audio"], num["audio"])
            and np.array_equal(nat["stream"], num["stream"]))
    if not same:
        fail("host phase: the native and numpy runs differ: tokens "
             f"{[len(a) for a in nat['tokens']]} / {[len(a) for a in num['tokens']]}, SOLA "
             f"offsets {nat['offsets']} / {num['offsets']}, subtitles equal "
             f"{nat['subtitles'] == num['subtitles']}")
    # the stream's offsets are all 0 on random weights: a known shift at its chunk's shapes
    if not sola_shapes:
        fail("host phase: the stream made no SOLA call")
    n_tail, n_chunk, overlap = sola_shapes[0]
    shift = 137
    chunk = (0.3 * np.random.RandomState(SEED + 1).randn(n_chunk)).astype(np.float32)
    tail = chunk[shift:shift + n_tail].copy()
    c0 = lib.calls["sola_offset"]
    sola_nat = dsp.sola_align(tail, chunk, overlap)
    c1 = lib.calls["sola_offset"]
    os.environ["GSV_DISABLE_NATIVE"] = "1"
    try:
        sola_num = dsp.sola_align(tail, chunk, overlap)
    finally:
        del os.environ["GSV_DISABLE_NATIVE"]
    if not (c1 == c0 + 1 and lib.calls["sola_offset"] == c1 and sola_nat[1] == sola_num[1] == shift
            and np.array_equal(sola_nat[0], sola_num[0])):
        fail(f"host phase: sola_align with a shift of {shift} at the stream's shapes "
             f"{sola_shapes[0]}: native {sola_nat[1]}, numpy {sola_num[1]}, library calls "
             f"{c1 - c0} / {lib.calls['sola_offset'] - c1}")
    print(f"host phase: sola_align at the stream's shapes (tail {n_tail}, chunk {n_chunk}, "
          f"overlap {overlap}) finds the shift of {shift} through the library and numpy alike",
          flush=True)
    infer_audio = nat["audio"]
    enhance["infer_clip"] = enhance_both(infer_audio)
    for what, (n_ms, p_ms, err) in enhance.items():
        if not err <= ENHANCE_TOL:
            fail(f"host phase: enhance_audio on {what}: native and numpy differ by {err:.3e}")
    print("host phase: enhance_audio, native against numpy: " + "; ".join(
        f"{what} ({len(seeded) if what == 'seeded_10s' else len(infer_audio)} samples) "
        f"{n_ms:.1f} ms against {p_ms:.1f} ms, largest difference {err:.3e}"
        for what, (n_ms, p_ms, err) in enhance.items()) + f" [{card}]", flush=True)

    # the log-mel metric: the spectrogram on the card against the CPU's
    t0 = time.perf_counter()
    mel_card = stft.mel_spectrogram(infer_audio)
    mel_card_ms = 1000 * (time.perf_counter() - t0)
    mel_cpu = stft.mel_spectrogram(infer_audio, device="cpu")
    mel_diff = float(np.mean(np.abs(mel_card - mel_cpu)))
    self_dist = stft.mel_distance(infer_audio, infer_audio)
    stream_dist = stft.mel_distance(nat["stream"], infer_audio)
    if not (mel_card.shape == mel_cpu.shape and mel_diff <= MEL_CARD_TOL and self_dist == 0.0):
        fail(f"host phase: mel_spectrogram on the card against the CPU: mean difference "
             f"{mel_diff}, shapes {mel_card.shape} / {mel_cpu.shape}, self distance {self_dist}")
    print(f"host phase: mel_spectrogram of the infer clip {mel_card.shape} on the card in "
          f"{mel_card_ms:.1f} ms, mean |difference| from the CPU's {mel_diff:.3e}; mel_distance "
          f"(clip, clip) {self_dist}, (stream, infer) {stream_dist:.4f}", flush=True)

    # the public surface
    from gsv_tts_tpu_torch import AudioClip, TTS, WaveOverloadedError, cut_text

    if not (isinstance(nat["clip"], AudioClip) and TTS is type(tts) and cut_text(text)
            and issubclass(WaveOverloadedError, RuntimeError)):
        fail("host phase: the package's exports")
    clip = nat["clip"]
    t0 = time.perf_counter()
    clip.play(0.5)
    done = threading.Event()
    waiter = threading.Thread(target=lambda: (tts.audio_queue.wait(), done.set()), daemon=True)
    waiter.start()
    if not done.wait(2.0):
        fail("host phase: audio_queue.wait() did not return within 2 s")
    play_s = time.perf_counter() - t0
    opened = tts.audio_queue.stream is not None
    with tempfile.TemporaryDirectory() as tmp:
        try:
            clip.save(str(Path(tmp) / "clip.flac"))
            saved = f"written through soundfile ({(Path(tmp) / 'clip.flac').stat().st_size} B)"
        except ImportError as e:
            saved = f"ImportError ({e})"
        connects = []
        real_connect = socket.socket.connect

        def refuse(sock, addr):
            connects.append(addr)
            raise OSError("the smoke opens no connection")

        socket.socket.connect = refuse
        try:
            present = check_pretrained_models(Path(tmp) / "empty")
        finally:
            socket.socket.connect = real_connect
    if present is not False or connects:
        fail(f"host phase: check_pretrained_models on an empty directory gave {present}, "
             f"connects {connects}")
    print(f"host phase: exports TTS, AudioClip, cut_text, WaveOverloadedError; play(0.5) and "
          f"audio_queue.wait() in {play_s:.3f} s (an output stream opened: {opened}); a .flac "
          f"save: {saved}; check_pretrained_models(empty dir) with GSV_OFFLINE="
          f"{os.environ.get('GSV_OFFLINE')!r}: {present}, no connection; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    readings = {"build_s": info["seconds"], "library": info["path"],
                "enhance_ms": {k: {"native": v[0], "numpy": v[1], "max_abs_diff": v[2]}
                               for k, v in enhance.items()},
                "native_calls": nat["calls"], "tokens": [len(a) for a in nat["tokens"]],
                "sola_offsets": nat["offsets"], "subtitles": len(nat["subtitles"]),
                "mel_card_vs_cpu": mel_diff, "mel_stream_vs_infer": stream_dist,
                "stream_opened": opened, "flac_save": saved.split(" (")[0],
                "phase_s": time.perf_counter() - t_phase}
    return total, readings


def main_path_phase(dev, card):
    """Drives ``infer``, ``infer_batched``, the engine under ``"flash"`` and ``"fused"``, the
    K5 loop, ``infer_stream`` and phases 6-15; returns the launches summed over the drives
    (counts are zeroed before each drive and read after it) and phases 10's to 15's
    readings."""
    from gsv_tts_tpu_torch import TTS
    from gsv_tts_tpu_torch.ops.fused_step import MAX_FUSED_B

    if BIG_WAVE <= MAX_FUSED_B:
        fail(f"the big wave ({BIG_WAVE}) must exceed MAX_FUSED_B ({MAX_FUSED_B})")
    small = [(1, 512), (1, 1024), (2, 512), (4, 512)]
    total = {name: 0 for name in launch_counts()}

    def add(counts):
        for name, n in counts.items():
            total[name] += n

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
        counts, warm_rtf = single_path(tts, spk, prompt)
        add(counts)
        # six texts with waves of at most four slots: two refills, then the
        # tail compacts
        counts, st = batched_path(tts, engine, spk, prompt, TEXTS[:6], layers)
        if counts["k2"] == 0 or st["refills"] < 2 or st["compactions"] < 1:
            fail(f"infer_batched(6): K2 launches {counts['k2']}, refills {st['refills']}, "
                 f"compactions {st['compactions']}")
        add(counts)
        del tts, engine
        # a wave above K2's limit: the generic step, K3b in every layer
        tts, engine = engine_for(small + [(BIG_WAVE, 512)])
        counts, st = batched_path(tts, engine, spk, prompt, TEXTS[:BIG_WAVE], layers)
        if counts["k3b"] == 0:
            fail(f"infer_batched({BIG_WAVE}): K3b was not launched")
        add(counts)
        del tts, engine
        # the engine's other implementations at B=1, the K5 loop, streaming
        add(engine_path(str(gpt), dev, "flash", 60, 100, 200))
        add(engine_path(str(gpt), dev, "fused", 200, 180, 100))
        add(k5_loop_path(str(gpt), dev))
        add(stream_path(tmp, gpt, sov, spk, prompt, dev, "fused_step", TEXTS[:2], warm_rtf))
        add(stream_path(tmp, gpt, sov, spk, prompt, dev, "flash", TEXTS[2:3], warm_rtf))
        add(sovits_buckets_phase(tmp, gpt, sov, spk, prompt, dev, card))
        add(v2pro_phase(tmp, gpt, sov, spk, prompt, dev, card))
        add(quant_path_phase(tmp, gpt, sov, spk, prompt, dev, card))
        counts, zh = zh_phase(tmp, gpt, sov, spk, prompt, dev, card)
        add(counts)
        counts, shared = shared_phase(tmp, gpt, sov, spk, prompt, dev, card)
        add(counts)
        counts, train = train_phase(tmp, gpt, Path(tmp) / "s2v2ProPlus", spk, prompt, dev, card)
        add(counts)
        counts, serving = serving_phase(tmp, gpt, sov, spk, prompt, dev, card)
        add(counts)
        counts, multi = multi_phase(tmp, gpt, sov, spk, prompt, dev, card)
        add(counts)
        counts, host = host_phase(tmp, gpt, sov, spk, prompt, dev, card)
        add(counts)
    return total, zh, shared, train, serving, multi, host


# what lies between a persistent kernel's clock marks, layer by layer: K1 hands over through
# tagged values, K2 through a grid barrier after every phase
K1_PHASES = ("stage x (embedding / LayerNorm 2)", "QKV product", "attention",
             "stage attention rows", "out-proj + residual", "stage LayerNorm 1", "MLP-1 (ReLU)",
             "stage MLP rows", "MLP-2 + residual")
K2_PHASES = (K1_PHASES[:2] + ("barrier",) + K1_PHASES[2:3] + ("barrier",) + K1_PHASES[3:5]
             + ("barrier",) + K1_PHASES[5:7] + ("barrier",) + K1_PHASES[7:] + ("barrier",))
# a layer stack (K5, K6) stages x_in in place of the embedding, and block 0 marks once more
# after the last LayerNorm's rows are stored
STACK_TAIL = "stage LayerNorm 2 + store the rows (block 0)"


def phase_trace(bench: StepBench, label: str, phases, L: int, tail: str = None):
    """The persistent kernel's time phase by phase, from the clock marks block 0 of a build
    with -DPS_TRACE leaves behind (``csrc/decode_step_persistent.cuh``) in its last launch
    of ``L`` layers (with ``tail``, the mark after a layer stack's store)."""
    import torch

    n = 1 + len(phases) * L + (tail is not None)
    marks = bench.table.trace[:2 * n].view(torch.int64).cpu().tolist()
    d = [marks[i + 1] - marks[i] for i in range(len(marks) - 1)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mhz = float(smi.stdout.split()[0])
    total = marks[-1] - marks[0]
    first = 1 if L > 1 else 0
    print(f"phase trace {label}: {total} SM cycles from the first phase to the last mark = "
          f"{total / mhz / 1000:.4f} ms at {mhz:.0f} MHz; mean SM cycles a layer of block 0 "
          f"(layers {first}..{L - 1}{'; layer 0 apart' if first else ''}; without barriers a "
          f"phase's wait for its inputs counts as its own time):", flush=True)
    for j, name in enumerate(phases):
        vals = [d[l * len(phases) + j] for l in range(first, L)]
        print(f"  {sum(vals) / len(vals):8.0f}  (min {min(vals)}, max {max(vals)}; layer 0 "
              f"{d[j]})  {name}", flush=True)
    if tail is not None:
        print(f"  {d[-1]:8.0f}  {tail}", flush=True)


def profile_phase(bench: StepBench):
    """torch.profiler over 20 steps of K1, of K2 (B=4 and B=8) and of the generic step with
    K3b (B=12) at kv_len ~777 in a 1024-row cache: device time by kernel, launches a step,
    the device's idle share, the persistent kernel's rate over the weight bytes and its time
    phase by phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gsv_tts_tpu_torch.ops.sampling import gumbel_noise
    from gsv_tts_tpu_torch.runtime import t2s_session as ts

    V, n = bench.cfg.vocab_size, 20
    wave12 = [777, 761, 790, 770, 745, 781, 799, 752, 766, 773, 758, 787]
    for label, kv_lens, (sa, su, _) in (("K1 B=1", [777], sampling_settings()[1]),
                                        ("K2 B=4", wave12[:4], sampling_settings()[3]),
                                        ("K2 B=8", wave12[:8], sampling_settings()[3]),
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
        launches = sum(r[2] for r in rows)
        t_plain = cuda_ms(step, n)
        print(f"profile {label} S=1024 kv_len~777: profiled span {span_ms:.4f} ms/step "
              f"({t_plain:.4f} without the profiler), device busy {busy:.4f} ms/step in "
              f"{launches:.0f} launches, idle share {1 - busy / span_ms:.3f}",
              flush=True)
        for key, ms, cnt in sorted(rows, key=lambda r: -r[1])[:12]:
            print(f"  {ms:.4f} ms/step  {cnt:6.1f} launches/step  {key[:100]}", flush=True)
        if B <= 8:
            if launches > 2.5:
                fail(f"{label}: {launches:.1f} device launches a step, the persistent design "
                     f"has two")
            # (per launch, not per step: the profiler may drop a window's first events)
            model = [r[1] / r[2] for r in rows if "decode_step_persistent" in r[0]]
            if len(model) != 1:
                fail(f"{label}: no persistent kernel among the profiled launches")
            print(f"  the persistent kernel takes {model[0]:.4f} ms a launch: the "
                  f"{weight_bytes(bench.cfg) / 1e6:.1f} MB of weights at "
                  f"{weight_bytes(bench.cfg) / model[0] / 1e6:.0f} GB/s", flush=True)
            phase_trace(bench, label, K1_PHASES if B == 1 else K2_PHASES, bench.cfg.num_layers)
    profile_layer_stacks(bench)


def profile_layer_stacks(bench: StepBench):
    """torch.profiler over calls of K5 (all layers, B=1) and of K6 (B=1 and 4, the layers in
    turn) at kv_len ~777 in a 1024-row cache: device kernels a call, the persistent kernel's
    time a launch, and its time phase by phase (K6: its last launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gsv_tts_tpu_torch.ops import fused_layer, fused_step

    cfg, L = bench.cfg, bench.cfg.num_layers
    layers = bench.params["layers"]
    for label, B in (("K5 B=1", 1), ("K6 B=1", 1), ("K6 B=4", 4)):
        st = bench.state(1024, [777, 761, 790, 770][:B], [60] * B, [17] * B, [20] * B)
        x = torch.randn((B, cfg.hidden_dim), generator=bench.dgen, device=bench.dev).to(
            torch.bfloat16)
        kk, kv = st["kc"].clone(), st["vc"].clone()
        at = [0]

        def call():
            if label.startswith("K5"):
                fused_step.fused_decode_step(x, layers, kk, kv, st["kv"], table=bench.table)
            else:
                layer = at[0] % L
                at[0] += 1
                fused_layer.fused_decode_layer(x, layers[layer], kk, kv, st["kv"], layer,
                                               table=bench.table)
        n = 20 if label.startswith("K5") else 2 * L
        for _ in range(5):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            span_ms = 1000 * (time.perf_counter() - t0) / n
        rows = [(e.key, (getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0.0)) / 1000, e.count)
                for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))
                and e.count > 0]
        launches = sum(r[2] for r in rows) / n
        busy = sum(r[1] for r in rows) / n
        print(f"profile {label} S=1024 kv_len~777: profiled span {span_ms:.4f} ms a call, "
              f"device busy {busy:.4f} ms a call in {launches:.1f} device kernels a call, idle "
              f"share {1 - busy / span_ms:.3f}", flush=True)
        for key, ms, cnt in rows:
            print(f"  {ms / cnt:.4f} ms a launch  {cnt / n:.1f} a call  {key[:100]}", flush=True)
        # (the profiler may drop a window's first events: fewer is no second kernel)
        if launches > 1.5 or not all("decode_step_persistent" in r[0] for r in rows):
            fail(f"{label}: {launches} device kernels a call, the persistent design has one")
        torch.cuda.synchronize()
        phases = ("stage x (x_in / LayerNorm 2)",) + (K1_PHASES if B == 1 else K2_PHASES)[1:]
        phase_trace(bench, label, phases, L if label.startswith("K5") else 1, tail=STACK_TAIL)


# ---------------------------------------------------------------------------
# P1-P3: the measurement probes (gsv_tts_tpu_torch/tools)
# ---------------------------------------------------------------------------

# The probe kernels against their twins.  P1 and P3 sum the same exact products in float32
# in other orders (relative to max |twin|); P2 sums at most 256 terms in another order
# (relative to max(1, |twin|), which holds bcastcmp's -5.4e10 to its float32 resolution).
P1_TOL, P2_TOL, P3_TOL = 1e-5, 1e-5, 1e-4
P1_FLAGSHIP = (512, 2048)  # the s1v3 t2s MLP-1: D -> N
# copies of P1's stack page (37.7 MB) its timed calls turn through, so that each finds its bytes
# cold in the 50 MB L2, as K1-q4's step (78 MB of pages) does
P1_STACK_COPIES = 4


def probes_path(dev, p3_inputs):
    """The probes' path: each tool's entry as its command runs it (P1's and P2's
    ``run_variant``: the probe's input against its reference; P3's: a step against its twin,
    then the 100-step chain from a CUDA graph, three replays), xla and fori in turns (xla,
    fori, the others, fori, xla); counts zeroed just before, read just after.  Returns
    (launches, P3's results by variant)."""
    from gsv_tts_tpu_torch.tools import int4_probe, mosaic_probe, stream_probe

    wrappers = {"p1": int4_probe.int4_unpack_matmul, "p2": mosaic_probe.mosaic_reduce,
                "p3": stream_probe.stream_step}
    for fn in wrappers.values():
        fn.launches = 0
    for v in int4_probe.VARIANTS:
        int4_probe.run_variant(v, dev)
    for v in mosaic_probe.VARIANTS:
        mosaic_probe.run_variant(v, dev)
    others = [v for v in stream_probe.VARIANTS if v not in ("xla", "fori")]
    p3 = {}
    for v in ["xla", "fori", *others, "fori", "xla"]:
        p3.setdefault(v, []).append(stream_probe.run_variant(v, dev, inputs=p3_inputs))
    launches = {name: fn.launches for name, fn in wrappers.items()}
    print(f"probes path: launches {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"{name}: no launch on the probes' path")
    return launches, p3


def sass_check(path: str) -> dict:
    """What P1's kernels compiled to: ``cuobjdump -sass`` of the probes' library (where the
    toolkit has it), per instance of the kernel, the count of HMMA (mma.sync products), I2F (an
    int -> float conversion) and ATOM / RED (atomics).  Fails if an instance multiplies without
    HMMA or converts int to float, or if ``unpack``
    holds an atomic (``unpack_dma``'s one is the error word's OR on a wait that gave up)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("P1 sass: cuobjdump not available", flush=True)
        return {}
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail(f"cuobjdump -sass {path}: {out.stderr.strip()[-500:]}")
    kinds = {"HMMA": ("HMMA",), "I2F": ("I2F", "I2FP"),
             "atomic": ("ATOM", "ATOMG", "ATOMS", "RED", "REDG")}
    counts, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:  # a kernel's SASS begins: name it if it is one of P1's
            name = next((k for k in ("p1_kernelILb0E", "p1_kernelILb1E") if k in line), None)
            if name:
                counts[name] = dict.fromkeys(kinds, 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if name and m:
            op = m.group(1).split(".")[0]
            for k, ops in kinds.items():
                counts[name][k] += op in ops
    print(f"P1 sass: {counts}", flush=True)
    for key in ("p1_kernelILb0E", "p1_kernelILb1E"):
        c = counts.get(key)
        if c is None or c["HMMA"] == 0 or c["I2F"] != 0:
            fail(f"P1 {key}: {c} -- the products must be HMMA, the unpack free of I2F")
    if counts["p1_kernelILb0E"]["atomic"]:
        fail(f"P1 unpack holds an atomic: {counts['p1_kernelILb0E']}")
    return counts


def p1_phase(dev):
    """P1 at the probe's shape, the flagship MLP-1's and the s1v3 layer stack as one page
    (``int4_probe.STACK``), both variants against the twin.  A call's time in turns with the
    twin; the device's from CUDA graphs of 48 launches in turns with the empty kernel's (the
    launch floor).  At the stack the timed calls turn through ``P1_STACK_COPIES``
    copies of the page, so that every call finds its bytes cold in the 50 MB L2, and a bf16
    ``torch.matmul`` of the same elements unquantized is read beside them (not the same
    function)."""
    import itertools

    import torch

    from gsv_tts_tpu_torch import tools
    from gsv_tts_tpu_torch.tools import int4_probe as p1

    errs, res = [], {}
    for d, n in ((p1.D, p1.N), P1_FLAGSHIP, p1.STACK):
        stack = (d, n) == p1.STACK
        x, _, packed, scale = p1.make_inputs(1, d=d, n=n)
        args = [torch.from_numpy(a).to(dev) for a in (x, packed, scale)]
        del x, packed, scale
        want = p1.int4_unpack_matmul_plain(*args)
        calls = {v: (lambda v=v: p1.int4_unpack_matmul(*args, variant=v)) for v in p1.VARIANTS}
        err = {}
        for name, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            tools.check(dev)
            err[name] = float((got - want).abs().max())
            if not err[name] <= P1_TOL * float(want.abs().max()):
                fail(f"P1 {name} at D={d}, N={n}: max abs error {err[name]:.3e} against the "
                     f"twin (max |twin| {float(want.abs().max()):.3e})")
        errs += [err[v] for v in p1.VARIANTS]
        timed = calls
        if stack:
            copies = [args[1]] + [args[1].clone() for _ in range(P1_STACK_COPIES - 1)]

            def turning(v):
                page = itertools.cycle(copies)
                return lambda: p1.int4_unpack_matmul(args[0], next(page), args[2], variant=v)

            timed = {v: turning(v) for v in p1.VARIANTS}
        plain = lambda: p1.int4_unpack_matmul_plain(*args)  # noqa: E731
        ms = {v: timed_turns(call, plain, 24 if stack else 200, 4 if stack else 50)
              for v, call in timed.items()}
        graphs = {name: graph_of(call, 48) for name, call in timed.items()}
        if stack:
            xb, wb = args[0].to(torch.bfloat16), p1.unpack_int4(args[1])
            graphs["bf16 matmul"] = graph_of(lambda: torch.matmul(xb, wb), 48)
        graphs["floor"] = graph_of(lambda: tools.empty_launch(dev), 48)
        dev_ms = graph_turns(graphs, n=48)
        b_ms, b_by = bound(4 * 8 * d + d * n // 2 + 4 * n + 4 * 8 * n, 2 * 8 * d * n)
        plans = {v: p1.plan(d, n // 2, v, tools.sm_count(dev)) for v in p1.VARIANTS}
        res[(d, n)] = {"ms": ms, "device_ms": dev_ms, "bound": (b_ms, b_by), "err": err}
        print(f"P1 at D={d}, N={n}: bound {b_ms:.6f} ms ({b_by}); "
              + "; ".join(f"{v} ({plans[v].blocks} blocks: {plans[v].tiles} tiles of "
                          f"{plans[v].tile} B x {plans[v].splits} splits, ring "
                          f"{plans[v].ring}) {ms[v][0]:.4f} ms a call, {dev_ms[v]:.4f} on the "
                          f"device ({b_ms / dev_ms[v]:.3f} of the bound), err {err[v]:.2e}"
                          for v in p1.VARIANTS)
              + "; " + ", ".join(f"{k} {dev_ms[k]:.4f}" for k in graphs if k not in calls)
              + (" ms on the device (the bf16 matmul: not the same function, "
                 f"{2 * d * n} bytes of weights)" if stack else " ms on the device")
              + f"; the twin {ms['unpack'][1]:.4f} ms; host {host_us(calls['unpack']):.1f} us a "
              f"call", flush=True)
        del args, want, graphs
        torch.cuda.empty_cache()
    return max(errs), res


def p2_phase(dev):
    """P2's four variants against the twin; a call's time in turns with the twin; the device's
    from CUDA graphs of 50 launches in turns with the empty kernel's (the launch floor)."""
    import torch

    from gsv_tts_tpu_torch import tools
    from gsv_tts_tpu_torch.tools import mosaic_probe as p2

    x = torch.from_numpy(p2.make_input(2)).to(dev)
    calls = {v: (lambda v=v: p2.mosaic_reduce(x, v)) for v in p2.VARIANTS}
    errs, ms = [], {}
    for name, call in calls.items():
        want = p2.mosaic_reduce_plain(x, name)
        got = call()
        torch.cuda.synchronize()
        err = float(((got - want).abs() / want.abs().clamp_min(1.0)).max())
        if not err <= P2_TOL:
            fail(f"P2 {name}: error {err:.3e} against the twin (relative to max(1, |twin|))")
        errs.append(float((got - want).abs().max()))
        ms[name] = timed_turns(call, lambda v=name: p2.mosaic_reduce_plain(x, v), 200, 50)
    graphs = {name: graph_of(call) for name, call in calls.items()}
    graphs["floor"] = graph_of(lambda: tools.empty_launch(dev))
    dev_ms = graph_turns(graphs)
    b_ms, b_by = bound(4 * x.numel() + 4 * p2.H, 0)
    print("P2: " + ", ".join(f"{v} {ms[v][0]:.4f} ms a call ({dev_ms[v]:.4f} on the device, "
                             f"{dev_ms[v] / dev_ms['floor']:.2f}x the floor; twin "
                             f"{ms[v][1]:.4f})" for v in calls)
          + f"; the floor (an empty kernel) {dev_ms['floor']:.4f} ms on the device; bound "
          f"{b_ms:.6f} ({b_by}); host {host_us(calls['combined']):.1f} us a call", flush=True)
    return max(errs), ms, dev_ms, (b_ms, b_by)


def p3_phase(dev, p3_inputs, p3):
    """P3's kernel variants at the full size against the twin (one step each, both rows of
    the result: every column of w enters it); each variant's step alone on the device (CUDA
    graphs of 20 steps, in turns), the twin's step; the chains' times come from the probes'
    path."""
    import torch

    from gsv_tts_tpu_torch import tools
    from gsv_tts_tpu_torch.tools import stream_probe as p3m

    w, x_all = p3_inputs
    xs = {v: x_all[:, :p3m.rows_of(v, p3m.D)].contiguous() for v in p3m.VARIANTS}
    errs = {}
    for v in p3m.VARIANTS:
        if v == "xla":
            continue
        got, want = p3m.stream_step(xs[v], w, v), p3m.stream_step_plain(xs[v], w, v)
        torch.cuda.synchronize()
        tools.check(dev)
        errs[v] = float((got - want).abs().max())
        if not errs[v] <= P3_TOL * float(want.abs().max()):
            fail(f"P3 {v}: max abs error {errs[v]:.3e} against the twin")
    alone = graph_turns({v: graph_of(lambda v=v: p3m.stream_step(xs[v], w, v), 20)
                         for v in p3m.VARIANTS}, n=20, reps=5)
    plain_ms = cuda_ms(lambda: p3m.stream_step_plain(xs["fori"], w, "fori"), 10)
    chain = {v: sum(r["ms"] for r in runs) / len(runs) for v, runs in p3.items()}
    n_l, d, width = w.shape
    # w and x read once, the [2, D] result written once; y's float32 FMAs on the CUDA cores
    b_ms, b_by = bound(2 * w.numel() + 2 * d + 8 * d, 2 * n_l * d * width, FP32_FLOPS)
    for v in p3m.VARIANTS:
        r = p3[v][0]
        extra = (f", {r['stages']} slots of {r['copy_bytes']} B, {r['copies_per_page']} "
                 f"copies a page a block" if "copy_bytes" in r else "")
        print(f"P3 {v}: {chain[v]:.4f} ms a step in the chain (mean of {len(p3[v])} runs' "
              f"best rounds), {2 * w.numel() / chain[v] / 1e6:.0f} GB/s, "
              f"{b_ms / chain[v]:.3f} of the bound; the step alone {alone[v]:.4f} ms on the "
              f"device ({2 * w.numel() / alone[v] / 1e6:.0f} GB/s, {b_ms / alone[v]:.3f} of "
              f"the bound){extra}", flush=True)
    print(f"P3: bound {b_ms:.4f} ms ({b_by}, {2 * w.numel()} bytes of w); the twin's fori step "
          f"{plain_ms:.3f} ms", flush=True)
    return max(errs.values()), chain, alone, plain_ms, (b_ms, b_by)


def probes_phase(dev):
    """Build P3's weights once, drive the probes' path, then hold every probe kernel against
    its twin and time it; returns (the path's launches, the kernels' JSON records)."""
    import torch

    from gsv_tts_tpu_torch import tools
    from gsv_tts_tpu_torch.tools import int4_probe, stream_probe
    from gsv_tts_tpu_torch.utils import cuda_build

    sass = sass_check(cuda_build.build_info[tools.PROBES_LIBRARY[0]]["path"])
    t0 = time.perf_counter()
    w, x = stream_probe.make_inputs(max(stream_probe.rows_of(v, stream_probe.D)
                                        for v in stream_probe.VARIANTS))
    p3_inputs = (w.to(dev), x.to(dev))
    print(f"probes: P3's weights {tuple(w.shape)} built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    launches, p3 = probes_path(dev, p3_inputs)
    p1_err, p1 = p1_phase(dev)
    p2_err, p2_ms, p2_dev, p2_bound = p2_phase(dev)
    p3_err, chain, alone, p3_plain, p3_bound = p3_phase(dev, p3_inputs, p3)
    del p3_inputs
    torch.cuda.empty_cache()
    # M1: the stack's bytes at P3 fori's rate of this run (its step alone on the device), beside
    # P1's device time at the stack: the gap is what the unpack and the products cost
    stack = p1[int4_probe.STACK]
    stack_bytes = stack["bound"][0] * HBM_BYTES_PER_S / 1000
    fori_rate = 2 * stream_probe.L * stream_probe.D * stream_probe.W / (alone["fori"] / 1000)
    stream_ms = 1000 * stack_bytes / fori_rate
    print(f"M1: P1 at the stack ({stack_bytes / 1e6:.2f} MB) unpack {stack['device_ms']['unpack']:.4f}"
          f" / unpack_dma {stack['device_ms']['unpack_dma']:.4f} ms on the device; the same bytes "
          f"at P3 fori's {fori_rate / 1e12:.2f} TB/s (this run) {stream_ms:.4f} ms; the unpack and "
          f"the products cost {min(stack['device_ms'][v] for v in int4_probe.VARIANTS) - stream_ms:.4f}"
          f" ms above the stream", flush=True)

    def rec(name, source, replaces, err, ms, plain_ms, b, library_ms, **extra):
        return {"name": name, "route": "cuda", "source": f"gsv_tts_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name[:2]], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0], "bound_by": b[1],
                "library_ms": library_ms, **extra}

    small, flag = p1[(int4_probe.D, int4_probe.N)], p1[P1_FLAGSHIP]
    records = [
        # P1: a call of ``unpack`` at the probe's shape; the other variant, the device's times
        # (beside the launch floor), the MLP-1 and the stack beside it
        rec("p1_int4_probe", "p1_int4_probe.cu", "tools/int4_probe.py:83", p1_err,
            small["ms"]["unpack"][0], small["ms"]["unpack"][1], small["bound"], None,
            unpack_dma_ms=small["ms"]["unpack_dma"][0], device_ms=small["device_ms"],
            mlp1_ms={v: t[0] for v, t in flag["ms"].items()}, mlp1_device_ms=flag["device_ms"],
            mlp1_bound_ms=flag["bound"][0],
            stack_ms={v: t[0] for v, t in stack["ms"].items()},
            stack_device_ms=stack["device_ms"], stack_bound_ms=stack["bound"][0],
            stack_bound_share={v: stack["bound"][0] / stack["device_ms"][v]
                               for v in int4_probe.VARIANTS},
            stack_plain_ms=stack["ms"]["unpack"][1], stack_stream_ms=stream_ms, sass=sass),
        # P2: a call of ``combined`` (the construct that hung Mosaic); every variant and the
        # launch floor beside it
        rec("p2_mosaic_probe", "p2_mosaic_probe.cu", "tools/mosaic_probe.py:88", p2_err,
            p2_ms["combined"][0], p2_ms["combined"][1], p2_bound, None,
            variant_ms={v: t[0] for v, t in p2_ms.items()}, device_ms=p2_dev),
        # P3: fori's step in the chain (the TPU tool's metric); xla's, the same function
        # through one torch.matmul, as the library call; launches: steps, eager or replayed
        rec("p3_stream_probe", "p3_stream_probe.cu", "tools/stream_probe.py:99", p3_err,
            chain["fori"], p3_plain, p3_bound, chain["xla"],
            grid_replaces="tools/stream_probe.py:140", chain_ms=chain, step_device_ms=alone)]
    return launches, records


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
    # the facade fetches missing pretrained assets unless this is set: the smoke opens no
    # connection
    os.environ.setdefault("GSV_OFFLINE", "1")

    from gsv_tts_tpu_torch import tools
    from gsv_tts_tpu_torch.ops import flash_decode, flash_prefill, fused_layer, fused_step
    from gsv_tts_tpu_torch.utils import cuda_build, native

    profiling = "--profile" in sys.argv[1:]
    if profiling:  # the persistent kernels leave their clock marks (phase_trace reads them)
        cuda_build.NVCC_FLAGS += ("-DPS_TRACE",)
    t0 = time.perf_counter()
    libraries = [fused_step.K1_LIBRARY, fused_step.K2_LIBRARY, flash_decode.LIBRARY,
                 flash_prefill.LIBRARY, fused_step.K5_LIBRARY, fused_layer.LIBRARY,
                 tools.PROBES_LIBRARY]
    cuda_build.load_libraries(libraries)
    # the host DSP library (phase 15) with the host compiler
    if native.native_lib() is None:
        fail("the host library was not built: no C++ compiler ($CXX, c++ or g++)")
    for bind in (fused_step.load_kernels, fused_step.load_batched_kernels,
                 flash_decode.load_kernels, flash_prefill.load_kernels,
                 fused_step.load_layers_kernels, fused_layer.load_kernels, tools.load_kernels):
        bind()
    print(f"build: {len(libraries)} libraries and the host library in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, _ in libraries + [native.LIBRARY]:
        info = cuda_build.build_info[name]
        tool = "host compiler" if name == native.LIBRARY[0] else "nvcc"
        print(f"  {info['path']} ({tool} {info['seconds']:.1f} s)", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    ptxas: {line.strip()}", flush=True)

    bench = StepBench(dev)
    if profiling:
        profile_phase(bench)
        return
    k1_err, k1_times = k1_phase(bench)
    k2_err, k2_times = k2_phase(bench)
    error_bits_phase(bench)
    barrier_phase(bench)
    k3 = k3_phase(dev, bench.cfg)
    k4 = k4_phase(dev, bench.cfg)
    prefill_times(bench)
    k5 = k5_phase(bench)
    k6 = k6_phase(bench)
    interleave_phase(bench)
    quant = quant_kernel_phase(bench)
    del bench
    torch.cuda.empty_cache()
    launches, zh, shared, train, serving, multi, host = main_path_phase(dev, card)
    print("zh readings: " + json.dumps(zh), flush=True)
    print("shared readings: " + json.dumps(shared), flush=True)
    print("train readings: " + json.dumps(train), flush=True)
    print("serving readings: " + json.dumps(serving), flush=True)
    print("multi readings: " + json.dumps(multi), flush=True)
    print("host readings: " + json.dumps(host), flush=True)
    torch.cuda.empty_cache()
    probe_launches, probe_records = probes_phase(dev)
    launches.update(probe_launches)

    def step_record(name, source, replaces, count, err, t):
        # t: (ms, plain ms, bound ms, bound by[, extras])
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": count, "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                "bound_ms": t[2], "bound_by": t[3], "library_ms": None,
                **(t[4] if len(t) > 4 else {})}

    def attn_record(name, source, replaces, count, r):
        return {"name": name, "route": "cuda", "source": f"gsv_tts_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": count, "max_abs_err": r[0], "ms": r[1],
                "plain_ms": r[2], "bound_ms": r[4], "bound_by": r[5], "library_ms": r[3],
                **r[6]}

    # times of the whole-step kernels (K1 and K2: the persistent kernel plus
    # the sampling launch) and of K5 and K6 (the persistent kernel alone; K6's
    # calls walk the layers): S=1024, kv_len ~777 (K2 at B=4, K6 at B=1); of the
    # decode attention kernels: B=12, S=512,
    # kv_len ~300; of K4: B=1, T=512.  K3a has no caller in the JAX package
    # outside its own module, so there is no path to put it on: it is held in
    # the kernel phase and shares K3b's kernel body
    record = {"kernels": [
        step_record("k1_decode_step", "gsv_tts_tpu_torch/csrc/k1_decode_step.cu",
                    "gsv_tts_tpu/ops/fused_step.py:897", launches["k1"], k1_err, k1_times[1024]),
        step_record("k2_decode_step_batched", "gsv_tts_tpu_torch/csrc/k2_decode_step_batched.cu",
                    "gsv_tts_tpu/ops/fused_step.py:1641", launches["k2"], k2_err,
                    k2_times[1024]),
        attn_record("k3a_flash_decode", "k3_flash_decode.cu",
                    "gsv_tts_tpu/ops/flash_decode.py:116", launches["k3a"], k3["k3a"]),
        attn_record("k3b_flash_decode_layered", "k3_flash_decode.cu",
                    "gsv_tts_tpu/ops/flash_decode.py:183", launches["k3b"], k3["k3b"]),
        attn_record("k4_flash_prefill", "k4_flash_prefill.cu",
                    "gsv_tts_tpu/ops/flash_prefill.py:97", launches["k4"], k4),
        step_record("k5_decode_layers", "gsv_tts_tpu_torch/csrc/k5_decode_layers.cu",
                    "gsv_tts_tpu/ops/fused_step.py:255", launches["k5"], k5[0], k5[1:]),
        step_record("k6_decode_layer", "gsv_tts_tpu_torch/csrc/k6_decode_layer.cu",
                    "gsv_tts_tpu/ops/fused_layer.py:208", launches["k6"], k6[0], k6[1:])]}
    # the int8 / int4 streams of K1 and K2 (the TPU kernels' quant / quant4 modes): times at
    # S=1024, kv_len ~777 (K2 at B=4), beside the bf16 kernel's in the same turns
    for kernel, source, line in (("k1", "k1_decode_step", 897),
                                 ("k2", "k2_decode_step_batched", 1641)):
        for q in QUANTS:
            err, t = quant[(kernel, q)]
            tag = "q8" if q == "int8" else "q4"
            record["kernels"].append({
                "name": f"{source}_{tag}", "route": "cuda",
                "source": f"gsv_tts_tpu_torch/csrc/{source}.cu",
                "replaces": f"gsv_tts_tpu/ops/fused_step.py:{line}",
                "launches": launches[kernel + tag], "max_abs_err": err, "ms": t[0],
                "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3], "library_ms": None,
                "bf16_ms": t[4], **t[5]})
    record["kernels"] += probe_records
    for name in ("k1", "k2", "k3b", "k4", "k5", "k6", "k1q8", "k1q4", "k2q8", "k2q4",
                 "p1", "p2", "p3"):
        # the kernels of the main paths and of the probes' path
        if launches[name] == 0:
            fail(f"{name} was not launched on the main path")
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
