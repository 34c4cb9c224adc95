"""Decode runtime for the t2s model (counterpart of
``gsv_tts_tpu/runtime/t2s_session.py``; reference ``t2s_model.py:385-734``).

Bucketed KV cache ``[L, B, S, H, Dh]`` with escalation to the next
``gpt_cache`` length, a prefill under the hybrid mask (whole batch, or one
or several slots of a running wave), and a chunked decode loop.  The
engine's ``attn_impl`` picks the kernels both go through (on the card; their
twins on the CPU), as in the JAX engine:

* ``"fused_step"`` (the default): plain-PyTorch prefill attention; decode
  steps by wave size —
  ``B == 1``: K1, the whole step for one slot (``ops/fused_step.py``);
  ``2 <= B <= MAX_FUSED_B``: K2, the whole step for the wave, the weights
  read once for all slots;
  larger waves: the generic step — plain PyTorch embedding, products,
  LayerNorms and sampling around K3b, the per-slot decode attention
  (``ops/flash_decode.py``);
* ``"flash"``: the prefill's attention is K4 (``ops/flash_prefill.py``) and
  every wave, B=1 included, decodes through the generic step with K3b;
* ``"fused"``: plain prefill attention; the generic step with K6, one
  whole-layer call per layer (``ops/fused_layer.py``);
* ``"xla"`` (``Config.use_flash_attn=False``): plain prefill attention; the
  generic step at every B with ``ops/flash_decode.py:xla_decode_attention``,
  plain PyTorch throughout — no kernel of this package launches;
* ``"fused_step_q8"`` / ``"fused_step_q4"``: ``"fused_step"`` with the t2s
  layers' weights streamed as int8 / int4 pages (packed once, at
  construction) by K1 and by K2 for waves of 2..``MAX_QUANT_B`` slots, as the
  JAX engine's quantized kernels are; the prefill, waves of 7..8 slots
  (the bf16 K2: JAX's generic step on the unquantized weights computes the
  same function) and larger waves (the generic step) use the bf16 weights.

The per-slot counters (``kv_len``, ``x_len``, ``buf_len``, ``last_tok``,
``step_idx``) are ``[B]`` int32 tensors on the device; the kernels read
their own slot's entries and nothing is read back per step.  The host reads
tokens and ``kv_len`` once per chunk of ``check_interval`` steps, mirroring
the reference's 5-step EOS readback; K1, whose scalars are host ints, takes
them from one readback at the start of its chunk.

Continuous batching (``generate_batched`` / ``generate_batched_stream``)
refills a finished slot with the next request while the others keep
decoding, and re-packs a mostly dead tail into the smallest batch bucket
that holds the survivors (down to B=1, i.e. K1).  Dead slots keep decoding
with zeroed counters (``freeze_slot``), as in the JAX engine.

Randomness is an input: every prefill takes a [rows, V] Gumbel tensor and
each decode dispatch one [n_steps, B, V] tensor, the shapes the JAX engine
draws, in the order it draws them, so parity tests can feed both engines the
same noise.  The engine draws them from an explicit ``torch.Generator``.

Over several ranks (``torch.distributed``, one process each): :meth:`T2SEngine.shard`
splits the layers by head over the mesh's ``tp`` ranks (the ``"xla"`` path, no
kernel; logits replicated after the all-reduce, so every tp rank draws the
same token from the same noise) and a wave's slots over its ``dp`` ranks;
``parallel/shard.py:DataParallelEngine`` splits the slots alone, each rank's
wave on its own kernels.  Every rank runs the same host loop: a split wave
holds ``B/dp`` slots' caches on each rank, each rank draws the whole wave's
noise and takes its rows, and the per-chunk host reads are all-gathers over
dp, so every rank makes the same refill, escalation and compaction
decisions.  A wave of one slot, or of a size that does not divide over dp,
is replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import t2s as t2s_model
from ..models.t2s import ATTN_IMPLS, T2SConfig
from ..ops import flash_decode, sampling
from ..ops.fused_step import (MAX_FUSED_B, QUANT_KEYS, K1Table, fused_decode_step_sample,
                              fused_decode_step_sample_batched, quant_layers)
from ..parallel import mesh as pmesh
from ..utils.timing import span

PAD_MULTIPLE = 32
CHECK_INTERVAL = 5  # default decode steps per dispatch: the host checks EOS this often
INITIAL_SUPPRESSION_STEPS = 10  # default steps during which 280, 486 and EOS are barred
I32 = torch.int32
#: the engine's quantized whole-step names and the weight stream each takes
QUANT_IMPLS = {"fused_step_q8": "int8", "fused_step_q4": "int4"}
#: the largest wave the quantized K2 takes (the JAX engine's ``max_fused_b``
#: under the per-row softmax); waves of 7..8 run the bf16 K2
MAX_QUANT_B = 6


def resolve_attn_impl(attn_impl: str) -> str:
    """Validate an engine ``attn_impl`` name at construction (the JAX
    ``loader.resolve_t2s_attn_impl``)."""
    if attn_impl not in ATTN_IMPLS + tuple(QUANT_IMPLS):
        raise ValueError(f"attn_impl {attn_impl!r}: expected one of "
                         f"{ATTN_IMPLS + tuple(QUANT_IMPLS)}")
    return attn_impl


def step_path(attn_impl: str, B: int) -> str:
    """The kernel a decode step of a ``B``-slot wave takes under
    ``attn_impl``: ``"k1"`` / ``"k2"`` (bf16 weights), ``"k1q"`` / ``"k2q"``
    (a quantized stream) or ``"generic"``."""
    quant = attn_impl in QUANT_IMPLS
    if attn_impl != "fused_step" and not quant or B > MAX_FUSED_B:
        return "generic"
    if B == 1:
        return "k1q" if quant else "k1"
    return "k2q" if quant and B <= MAX_QUANT_B else "k2"


def _prefill_impl(attn_impl: str) -> str:
    """Engine ``attn_impl`` → prefill attention: only ``"flash"`` takes K4;
    the whole-step and whole-layer decode paths pair with the plain prefill
    (the JAX engine's mapping of its real implementations)."""
    return "flash" if attn_impl == "flash" else "plain"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SampleArgs:
    top_k: int = 15
    top_p: float = 1.0
    temperature: float = 1.0
    repetition_penalty: float = 1.35
    use_prev: bool = True  # penalty over previous tokens (off in batched mode)


@dataclasses.dataclass
class DecodeState:
    """Device-resident decode state of one wave of B slots."""

    k_cache: torch.Tensor  # [L, B, S, H, Dh]
    v_cache: torch.Tensor  # [L, B, S, H, Dh]
    kv_len: torch.Tensor   # [B] int32: valid cache rows per slot
    x_len: torch.Tensor    # [B] int32: phoneme-block length per slot
    tok_buf: torch.Tensor  # [B, S] int32: prompt y + generated (V = empty)
    buf_len: torch.Tensor  # [B] int32
    last_tok: torch.Tensor  # [B] int32: token fed next step
    step_idx: torch.Tensor  # [B] int32: decode step counter (suppression window)


def _fields(state: DecodeState) -> List[torch.Tensor]:
    """The state's tensors in field order (``dataclasses.astuple`` would
    deep-copy them)."""
    return [getattr(state, f.name) for f in dataclasses.fields(state)]


def freeze_slot(state: DecodeState, j: int) -> DecodeState:
    """Zero a dead slot's counters (in place) so its per-chunk K/V appends
    restart from row 0 and never reach the bucket edge."""
    for t in (state.kv_len, state.step_idx, state.buf_len):
        t[j] = 0
    return state


def prompt_rows(x, y) -> int:
    """Cache rows a slot prefill + its first decode step need: the padded
    ``[Lx|Ly]`` block the prefill writes, or prompt+1, whichever is
    larger.  For a BATCHED refill the binding number is the GROUP pad
    (``xs.shape[1] + ys.shape[1]`` from :meth:`T2SEngine._pad_prompts`),
    which can exceed every per-request value when x/y splits are
    mismatched across the group."""
    lxp = _round_up(max(len(x), 1), PAD_MULTIPLE)
    lyp = _round_up(max(len(y), 1), PAD_MULTIPLE)
    return max(len(x) + len(y) + 1, lxp + lyp)


class SlotHarvest:
    """Per-slot incremental-emission bookkeeping of
    :meth:`T2SEngine.generate_batched_stream`.  Reference semantics
    (``t2s_model.py:655,674-679``): only decode samples BEFORE the
    interval's last one are emittable mid-stream, nothing at or past the
    first sampled EOS is ever emitted, and the final harvest trims
    specials and yields the not-yet-emitted tail."""

    __slots__ = ("samples", "emitted", "eos_seen")

    def __init__(self):
        self.samples: List[int] = []  # every decode sample so far (host ints)
        self.emitted = 0  # how many the consumer has received
        self.eos_seen = False

    def extend(self, toks) -> None:
        self.samples.extend(int(t) for t in toks)

    def drain_stream(self, eos: int) -> Optional[np.ndarray]:
        """Newly-final tokens, or None when there is nothing new.  The
        emittable window is every decode sample EXCEPT the interval's
        last one (``samples[:-1]``), trimmed at the first EOS."""
        if self.eos_seen:
            return None
        window = self.samples[:-1]
        hi = len(window)
        for t in range(self.emitted, len(window)):
            if window[t] == eos:
                hi = t
                self.eos_seen = True
                break
        if hi <= self.emitted:
            return None
        out = np.asarray(window[self.emitted:hi], np.int64)
        self.emitted = hi
        return out

    def drain_final(self, eos: int, gen: Optional[np.ndarray] = None) -> np.ndarray:
        """Final-harvest tail: ``gen`` — the full harvest window, defaulting
        to the host-accumulated ``samples[:-1]`` (``generate_batched_stream``
        passes the equivalent device ``tok_buf`` window instead) — trimmed
        at the first EOS, specials dropped, already-emitted prefix
        skipped."""
        if gen is None:
            gen = np.asarray(self.samples[:-1], np.int64)
        eos_pos = np.nonzero(gen == eos)[0]
        if eos_pos.size:
            gen = gen[: eos_pos[0]]
        gen = gen[gen < eos]
        return gen.astype(np.int64)[self.emitted:]


def _sample_logits(g, logits, tok_buf, sa: SampleArgs, vocab: int, mask_eos: bool,
                   suppress: torch.Tensor, suppressed: Tuple[int, ...]):
    """Logit post-processing of the prefills and the generic step:
    suppression, EOS masking, filtering, Gumbel argmax (JAX
    ``_sample_logits``)."""
    logits = logits.float()
    suppressed = [s for s in suppressed if 0 <= s < vocab]  # JAX drops the rest
    if suppressed:
        sup = torch.as_tensor(suppressed, device=logits.device)
        masked = logits.clone()
        masked[:, sup] = float("-inf")
        logits = torch.where(suppress[:, None], masked, logits)
    if mask_eos:
        logits = logits.clone()
        logits[:, vocab - 1] = float("-inf")
    probs = sampling.logits_to_probs(
        logits, tok_buf if sa.use_prev else None, temperature=sa.temperature,
        top_k=sa.top_k, top_p=sa.top_p, repetition_penalty=sa.repetition_penalty)
    return sampling.gumbel_argmax_with_noise(probs, g).to(I32)


def _append_tok(tok_buf, buf_len, tok):
    """Write ``tok[b]`` at ``tok_buf[b, buf_len[b]]`` in place, for the slots
    whose ``buf_len`` is inside the buffer."""
    idx = buf_len.long()
    fits = idx < tok_buf.shape[1]
    tok_buf[torch.arange(tok_buf.shape[0], device=tok_buf.device)[fits], idx[fits]] = tok[fits]
    return tok_buf


def _gather_slots(state: DecodeState, slot_map, new_S: int, vocab: int) -> DecodeState:
    """Re-pack slots into a (differently sized) wave: ``slot_map[j]`` is
    the OLD slot index new slot ``j`` inherits, -1 for a dead slot.  One
    gather per buffer — used for wave growth (identity map into a larger B)
    and tail compaction (survivors into a smaller B, so a lone tail request
    decodes through the small-batch kernel instead of burning dead slots).
    The sequence dimension pads or truncates to ``new_S``; the caller
    guarantees every live slot's ``kv_len`` fits."""
    dev = state.kv_len.device
    slot_map = torch.as_tensor(np.asarray(slot_map), device=dev).long()
    src = slot_map.clamp(0, state.kv_len.shape[0] - 1)
    live = slot_map >= 0
    S = state.k_cache.shape[2]
    n = min(S, new_S)

    def fix_s(c):
        L, _, _, H, Dh = c.shape
        out = torch.zeros((L, len(src), new_S, H, Dh), dtype=c.dtype, device=dev)
        out[:, :, :n] = c[:, :, :n].index_select(1, src)
        return out

    tok_buf = torch.full((len(src), new_S), vocab, dtype=I32, device=dev)
    tok_buf[:, :n] = state.tok_buf[:, :n].index_select(0, src)

    def scal(a):
        return torch.where(live, a.index_select(0, src), torch.zeros((), dtype=a.dtype, device=dev))

    return DecodeState(
        k_cache=fix_s(state.k_cache), v_cache=fix_s(state.v_cache),
        kv_len=scal(state.kv_len), x_len=scal(state.x_len), tok_buf=tok_buf,
        buf_len=scal(state.buf_len), last_tok=scal(state.last_tok),
        step_idx=scal(state.step_idx))


def _lens(v, dev) -> torch.Tensor:
    """A host int or sequence, or a tensor, → [rows] int64 tensor on ``dev``."""
    return torch.as_tensor(v, device=dev).reshape(-1).long()


def _prefill_rows(params, cfg, x_ids, y_ids, bert, x_lens, y_lens, dtype, S, guard_pad,
                  attn_impl):
    """What the three prefills share: the packed prompt through all layers,
    the last real position's logits, and each row's fresh ``tok_buf`` row
    (prompt y tokens, then V).  Returns (ks, vs [L, k, T, H, Dh], logits
    [k, V], tok_rows [k, S] int32)."""
    dev = x_ids.device
    k, Ly = y_ids.shape
    impl = _prefill_impl(attn_impl)
    # K4 derives the mask from the lengths: no [k, T, T] tensor is built
    xy_pos, mask, _ = t2s_model.embed_prompt_batch(
        params, cfg, x_ids, y_ids, bert, x_lens, y_lens, dtype, with_mask=impl == "plain")
    if guard_pad and mask is not None:
        # padded rows must still attend somewhere to avoid NaN softmax rows
        mask = mask | (torch.arange(mask.shape[-1], device=dev)[None, None, :] == 0)
    h, ks, vs = t2s_model.transformer_prefill(params, cfg, xy_pos, mask,
                                              lens=(x_lens, x_lens + y_lens), impl=impl)
    h_last = h[torch.arange(k, device=dev), x_lens + y_lens - 1]  # [k, D]
    logits = torch.nn.functional.linear(h_last, params["predict_w"])
    pos = torch.arange(S, device=dev)[None, :]
    y_gather = torch.gather(y_ids, 1, pos.clamp(0, Ly - 1).expand(k, S)).to(I32)
    tok_rows = torch.where(pos < y_lens[:, None], y_gather,
                           torch.full((), cfg.vocab_size, dtype=I32, device=dev))
    return ks, vs, logits, tok_rows


def prefill_batch(params, cfg: T2SConfig, x_ids, y_ids, bert, x_lens, y_lens,
                  k_cache, v_cache, gumbel, sa: SampleArgs, first_suppress: bool,
                  dtype=torch.float32, attn_impl: str = "fused_step"):
    """Full-batch prefill into fresh caches; samples the first token per row.

    ``x_ids`` [B, Lx] / ``y_ids`` [B, Ly] / ``bert`` [B, Lx, bert_dim] may be
    right-padded past ``x_lens`` / ``y_lens`` ([B], or host ints at B=1); the
    caches receive the padded block's rows (rows at or past ``x_len + y_len``
    are overwritten by decode before they are attended).  ``gumbel`` [B, V].
    Returns ``(state, tok [B] int32)``."""
    dev = k_cache.device
    V = cfg.vocab_size
    B = x_ids.shape[0]
    x_lens, y_lens = _lens(x_lens, dev), _lens(y_lens, dev)
    S = k_cache.shape[2]
    ks, vs, logits, tok_buf = _prefill_rows(params, cfg, x_ids, y_ids, bert, x_lens, y_lens,
                                            dtype, S, False, attn_impl)
    T = ks.shape[2]
    k_cache[:, :, :T] = ks.to(k_cache.dtype)
    v_cache[:, :, :T] = vs.to(v_cache.dtype)
    suppress = torch.full((B,), first_suppress, dtype=torch.bool, device=dev)
    tok = _sample_logits(gumbel, logits, tok_buf, sa, V, True, suppress,
                         cfg.suppressed_tokens if first_suppress else ())
    tok_buf[torch.arange(B, device=dev), y_lens] = tok
    state = DecodeState(
        k_cache=k_cache, v_cache=v_cache, kv_len=(x_lens + y_lens).to(I32),
        x_len=x_lens.to(I32), tok_buf=tok_buf, buf_len=(y_lens + 1).to(I32), last_tok=tok,
        step_idx=torch.ones((B,), dtype=I32, device=dev))
    return state, tok


def prefill_slots(params, cfg: T2SConfig, state: DecodeState, slots, x_ids, y_ids, bert,
                  x_lens, y_lens, gumbel, sa: SampleArgs, dtype=torch.float32,
                  attn_impl: str = "fused_step"):
    """Batched slot refill: prefill ``k`` requests into cache slots ``slots``
    ([k], distinct) of a running wave in one pass, in place.  Inputs are
    [k, Lx] / [k, Ly] / [k, Lx, bert_dim] padded to common shapes; ``gumbel``
    [k, V].  The first token is drawn without the repetition penalty and
    without suppression, with EOS masked.  Returns ``(state, toks [k])``."""
    dev = state.k_cache.device
    slots = _lens(slots, dev)
    x_lens, y_lens = _lens(x_lens, dev), _lens(y_lens, dev)
    k = len(slots)
    ks, vs, logits, tok_rows = _prefill_rows(params, cfg, x_ids, y_ids, bert, x_lens, y_lens,
                                             dtype, state.k_cache.shape[2], True, attn_impl)
    T = ks.shape[2]
    state.k_cache[:, slots, :T] = ks.to(state.k_cache.dtype)
    state.v_cache[:, slots, :T] = vs.to(state.v_cache.dtype)
    toks = _sample_logits(gumbel, logits, None, dataclasses.replace(sa, use_prev=False),
                          cfg.vocab_size, True,
                          torch.zeros((k,), dtype=torch.bool, device=dev), ())
    tok_rows[torch.arange(k, device=dev), y_lens] = toks
    state.tok_buf[slots] = tok_rows
    state.kv_len[slots] = (x_lens + y_lens).to(I32)
    state.x_len[slots] = x_lens.to(I32)
    state.buf_len[slots] = (y_lens + 1).to(I32)
    state.last_tok[slots] = toks
    state.step_idx[slots] = 1
    return state, toks


def prefill_slot(params, cfg: T2SConfig, state: DecodeState, slot: int, x_ids, y_ids, bert,
                 x_len, y_len, gumbel, sa: SampleArgs, dtype=torch.float32,
                 attn_impl: str = "fused_step"):
    """Continuous-batching slot refill (``t2s_model.py:696-722``): prefill
    one request ([1, Lx] / [1, Ly] inputs, ``gumbel`` [1, V]) into cache slot
    ``slot`` while the other slots keep their state.  Returns
    ``(state, tok)``."""
    state, toks = prefill_slots(params, cfg, state, [slot], x_ids, y_ids, bert, x_len, y_len,
                                gumbel, sa, dtype, attn_impl)
    return state, toks[0]


def _generic_step(params, cfg: T2SConfig, st: DecodeState, g, sa: SampleArgs,
                  suppress_until: int, dtype, tok_out, attn_impl: str = "flash"):
    """One step outside the whole-step kernels (the JAX generic ``step``):
    embedding, head and sampling as plain PyTorch around
    ``transformer_decode_step`` — under ``"flash"`` PyTorch layers with K3b
    as their attention, under ``"fused"`` K6 per layer, under ``"xla"``
    PyTorch layers with ``xla_decode_attention``."""
    pe_idx = (st.kv_len - st.x_len).clamp_min(0).long()  # 0 for a frozen slot
    pe = (params["audio_pos_alpha"] * params["pe"][pe_idx]).to(dtype)
    x = params["audio_emb"][st.last_tok.long()].to(dtype) + pe
    h, _, _ = t2s_model.transformer_decode_step(params, cfg, x, st.k_cache, st.v_cache,
                                                st.kv_len, attn_impl)
    logits = torch.nn.functional.linear(h, params["predict_w"])
    tok = _sample_logits(g, logits, st.tok_buf, sa, cfg.vocab_size, False,
                         st.step_idx < suppress_until,
                         cfg.suppressed_tokens + (cfg.eos,) if suppress_until else ())
    tok_out.copy_(tok)
    _append_tok(st.tok_buf, st.buf_len, tok_out)


def decode_chunk(params, cfg: T2SConfig, state: DecodeState, n_steps: int,
                 sa: SampleArgs, gumbel: torch.Tensor, suppress_until: int = 0,
                 dtype=torch.float32, attn_impl: str = "fused_step"):
    """Generate ``n_steps`` tokens per slot (the caches, ``tok_buf`` and the
    counters are updated in place).  Under ``"fused_step"``: one K1 call per
    step at B=1, one K2 call per step for 2..``MAX_FUSED_B`` slots, the
    generic step with K3b above; ``"fused_step_q8"`` / ``"_q4"`` the same,
    K1 and K2 up to ``MAX_QUANT_B`` slots on the quantized pages
    (:func:`step_path`).  Under ``"flash"`` the generic step with K3b, under
    ``"fused"`` the generic step with K6, under ``"xla"`` the generic step in
    plain PyTorch, at every B.  Every slot advances,
    dead ones too.  ``gumbel`` [n_steps, B, V] float32.  Returns ``(state,
    toks [B, n_steps] int32)`` with ``toks`` on the device (no host
    synchronisation here except K1's one counter readback)."""
    dev = state.k_cache.device
    B, S = state.tok_buf.shape
    V = cfg.vocab_size
    if tuple(gumbel.shape) != (n_steps, B, V):
        raise ValueError(f"gumbel {tuple(gumbel.shape)} is not ({n_steps}, {B}, {V})")
    toks = torch.empty((n_steps, B), dtype=I32, device=dev)
    suppressed = cfg.suppressed_tokens + (cfg.eos,)
    path = step_path(attn_impl, B)
    quant = QUANT_IMPLS.get(attn_impl) if path in ("k1q", "k2q") else None
    if path in ("k1", "k1q"):
        with span("gsv.t2s.readback"):
            kv_len, x_len, buf_len, step_idx = torch.stack(
                [state.kv_len, state.x_len, state.buf_len, state.step_idx]).flatten().tolist()
        if kv_len + n_steps > S:
            raise ValueError(f"{n_steps} steps from kv_len {kv_len} overrun the {S}-row cache")
        row = torch.empty((1, V), dtype=torch.float32, device=dev)
        with span("gsv.t2s.chunk", device=True) as chunk:
            chunk.set(steps=n_steps)
            for i in range(n_steps):
                fused_decode_step_sample(
                    params, state.k_cache, state.v_cache, state.tok_buf, kv_len + i, x_len,
                    state.last_tok, buf_len + i, step_idx + i, gumbel[i], sa=sa,
                    suppress_until=suppress_until, suppressed=suppressed, tok_out=toks[i],
                    row_out=row, quant=quant)
                state.last_tok = toks[i]
            chunk.device_end()
            for t in (state.kv_len, state.buf_len, state.step_idx):
                t += n_steps
        return state, toks.T
    fused = path in ("k2", "k2q")
    if fused:
        row = torch.empty((B, V), dtype=torch.float32, device=dev)
    with span("gsv.t2s.chunk", device=True) as chunk:
        chunk.set(steps=n_steps)
        for i in range(n_steps):
            if fused:
                fused_decode_step_sample_batched(
                    params, state.k_cache, state.v_cache, state.tok_buf, state.kv_len,
                    state.x_len, state.last_tok, state.buf_len, state.step_idx, gumbel[i],
                    sa=sa, suppress_until=suppress_until, suppressed=suppressed,
                    tok_out=toks[i], row_out=row, quant=quant)
            else:
                # (a wave above K2's limit: "fused_step" degrades to "flash" at B > 1)
                _generic_step(params, cfg, state, gumbel[i], sa, suppress_until, dtype, toks[i],
                              "fused_step" if attn_impl in QUANT_IMPLS else attn_impl)
            state.last_tok = toks[i]
            for t in (state.kv_len, state.buf_len, state.step_idx):
                t += 1
    return state, toks.T


class T2SEngine:
    """Host orchestration of generation (reference ``infer`` /
    ``infer_stream`` / ``infer_batched``, ``t2s_model.py:385-734``)."""

    def __init__(self, params, cfg: T2SConfig, gpt_cache: Sequence[Tuple[int, int]],
                 dtype=torch.float32, check_interval: int = CHECK_INTERVAL,
                 initial_suppression_steps: int = INITIAL_SUPPRESSION_STEPS,
                 attn_impl: str = "fused_step"):
        self.params = params
        self.cfg = cfg
        self.attn_impl = resolve_attn_impl(attn_impl)
        self.dtype = dtype
        #: decode steps a dispatch (the host checks EOS this often) and the B=1
        #: steps during which 280, 486 and EOS are barred
        self.check_interval = check_interval
        self.initial_suppression_steps = initial_suppression_steps
        self.device = params["predict_w"].device
        #: host wall times of the last generation (each ends in a readback)
        self.last_stats: Dict[str, float] = {}
        # observability counters of the batched path
        self.compactions = 0
        self.refills = 0
        #: the quantized weight stream of K1 / K2, or None
        self.quant = QUANT_IMPLS.get(self.attn_impl)
        if self.quant is not None:  # packed once, from the model-dtype weights
            self.params = dict(params, **{QUANT_KEYS[self.quant]: quant_layers(params, self.quant)})
        if self.device.type == "cuda" and self.attn_impl != "xla":
            # the kernels' pointer table and workspace, built once ("xla" runs none)
            self.params = dict(self.params, k1_table=K1Table(self.params, self.quant))
        #: set by :meth:`shard` (or ``DataParallelEngine``): the ranks' mesh, and
        #: the (group, size, rank) of the dp axis a wave's slots split over
        self.mesh = None
        self._dp = (None, 1, 0)
        self.buckets: Dict[int, List[int]] = {}
        for b, s in gpt_cache:
            self.buckets.setdefault(b, [])
            if s not in self.buckets[b]:
                self.buckets[b].append(s)
        for b in self.buckets:
            self.buckets[b].sort()

    def shard(self, mesh) -> "T2SEngine":
        """Inference over the ranks of ``mesh`` (``parallel/mesh.py:make_mesh``;
        every rank calls this, and then the same generation, with the same
        arguments): the layers split by head over ``tp``
        (``shard_t2s_params``), caches ``[L, B/dp, S, H/tp, Dh]``, a wave's
        slots split over ``dp``.  The engine takes the ``"xla"`` path and
        drops its kernels' table, as the JAX engine's sharded programs run its
        XLA attention.  A quantized engine raises ``ValueError``."""
        if self.quant is not None:
            raise ValueError(f"attn_impl {self.attn_impl!r}: a quantized engine does not "
                             "shard (its packed pages have no tp layout)")
        pmesh.check_tp(self.cfg, mesh)
        self.mesh = mesh
        self.params = pmesh.shard_t2s_params(self.params, mesh)
        self.attn_impl = "xla"
        self._dp = pmesh.axis(mesh, "dp")
        return self

    # -- helpers -----------------------------------------------------------

    def _rows(self, B: int) -> Tuple[int, int]:
        """This rank's slots ``[lo, hi)`` of a ``B``-slot wave: ``B/dp`` of
        them when the wave splits over dp, else all (replicated)."""
        _, n, r = self._dp
        if n == 1 or B == 1 or B % n:
            return 0, B
        b = B // n
        return r * b, (r + 1) * b

    def _host(self, t: torch.Tensor, B: int) -> np.ndarray:
        """A per-slot tensor of a ``B``-slot wave (slots on dim 0) on the
        host: the whole wave's, gathered over dp when the wave splits."""
        lo, hi = self._rows(B)
        if hi - lo == B:
            return t.cpu().numpy()
        return pmesh.all_gather_cat(t, self._dp[0]).cpu().numpy()

    def _freeze(self, state: DecodeState, j: int, B: int) -> DecodeState:
        """:func:`freeze_slot` of wave slot ``j``, on the rank that holds it."""
        lo, hi = self._rows(B)
        return freeze_slot(state, j - lo) if lo <= j < hi else state

    def _full_state(self, state: DecodeState, B: int) -> DecodeState:
        """The whole ``B``-slot wave's state on every rank."""
        lo, hi = self._rows(B)
        if hi - lo == B:
            return state
        g = self._dp[0]
        return DecodeState(*(pmesh.all_gather_cat(t, g, 1 if t.dim() == 5 else 0)
                             for t in _fields(state)))

    def _local_state(self, state: DecodeState, B: int) -> DecodeState:
        """This rank's slots of a whole ``B``-slot wave's state."""
        lo, hi = self._rows(B)
        if hi - lo == B:
            return state
        return DecodeState(*((t[:, lo:hi] if t.dim() == 5 else t[lo:hi]).contiguous()
                             for t in _fields(state)))

    def _pick_bucket(self, batch_size: int, prompt_len: int) -> Tuple[int, int]:
        sizes = sorted(self.buckets.keys())
        B = next((b for b in sizes if b >= batch_size), sizes[-1])
        lens = self.buckets[B]
        S = next((s for s in lens if s > prompt_len), lens[-1])
        if S <= prompt_len:
            raise ValueError(
                f"prompt length {prompt_len} exceeds largest gpt_cache bucket {lens[-1]}")
        return B, S

    def _alloc_cache(self, B: int, S: int):
        """Zeroed K and V caches of this rank's slots of a ``B``-slot wave."""
        lo, hi = self._rows(B)
        return self._alloc_rows(hi - lo, S)

    def _alloc_rows(self, b: int, S: int):
        c = self.cfg
        heads = self.params["layers"][0]["qkv_w"].shape[0] // (3 * c.head_dim)  # H/tp
        shape = (c.num_layers, b, S, heads, c.head_dim)
        return (torch.zeros(shape, dtype=self.dtype, device=self.device),
                torch.zeros(shape, dtype=self.dtype, device=self.device))

    def _escalate(self, state: DecodeState, new_S: int) -> DecodeState:
        """Grow the cache to the next length bucket (one pad-copy)."""
        B, S = state.tok_buf.shape
        k, v = self._alloc_rows(B, new_S)
        k[:, :, :S] = state.k_cache
        v[:, :, :S] = state.v_cache
        tok_buf = torch.full((B, new_S), self.cfg.vocab_size, dtype=I32, device=self.device)
        tok_buf[:, :S] = state.tok_buf
        return dataclasses.replace(state, k_cache=k, v_cache=v, tok_buf=tok_buf)

    def _pad_prompt(self, x: np.ndarray, y: np.ndarray, bert: np.ndarray):
        """Pad (x, y, bert) to 32-multiples, as the JAX engine does (the
        padded lengths decide the first cache bucket)."""
        xs, ys, bs, _, _ = self._pad_prompts([(x, y, bert)])
        return xs[0], ys[0], bs[0]

    def _pad_prompts(self, items, B: Optional[int] = None):
        """Stack k prompts padded to common 32-multiple ``(Lx, Ly)`` shapes.
        ``items`` is a list of ``(x, y, bert)``; rows past ``len(items)`` (up
        to ``B``) stay zero with 1/1 dummy lengths for dead slots.  Returns
        ``(xs, ys, bs, x_lens, y_lens)``.  A batched prefill of this group
        writes ``xs.shape[1] + ys.shape[1]`` cache rows per slot — callers
        must check that against the target bucket (the common pad can exceed
        every per-request :func:`prompt_rows` when x/y splits are mismatched
        across the group)."""
        B = len(items) if B is None else B
        Lx = _round_up(max(max(len(x) for x, _, _ in items), 1), PAD_MULTIPLE)
        Ly = _round_up(max(max(len(y) for _, y, _ in items), 1), PAD_MULTIPLE)
        xs = np.zeros((B, Lx), np.int64)
        ys = np.zeros((B, Ly), np.int64)
        bs = np.zeros((B, Lx, self.cfg.bert_dim), np.float32)
        x_lens = np.ones((B,), np.int64)
        y_lens = np.ones((B,), np.int64)
        for n, (x, y, bert) in enumerate(items):
            xs[n, : len(x)] = x
            ys[n, : len(y)] = y
            bs[n, : len(x)] = np.asarray(bert, np.float32).reshape(len(x), -1)
            x_lens[n] = len(x)
            y_lens[n] = len(y)
        return xs, ys, bs, x_lens, y_lens

    def _dev(self, *arrays):
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def _noise(self, generator, *shape):
        return sampling.gumbel_noise(shape, generator, self.device)

    def _check_kernels(self):
        """Raise on a device-side range error flagged since the last call
        (one small readback each; called where the host has just
        synchronised on a chunk's tokens)."""
        table = self.params.get("k1_table")
        if table is not None:
            table.check()
            flash_decode.check(self.device)

    def _prepare_chunk(self, state: DecodeState, live_mask: List[bool],
                       n_steps: int) -> Tuple[DecodeState, int, int]:
        """Pre-chunk bucket bookkeeping of :meth:`generate_batched_stream`:

        * escalate to a bigger S bucket when the ACTIVE slots near the edge
          (keyed on live slots only: decode_chunk advances kv_len for frozen
          slots too, so a long-dead slot's phantom kv would drive spurious
          escalations);
        * clamp the chunk to the tightest active slot's room when no bigger
          bucket exists — a slot REFILLED within check_interval of the
          largest bucket has not passed the post-chunk retire check yet, and
          unclamped its K/V append would run past the cache edge.  The refill
          guards keep kv <= S-1, so at least one step always fits;
        * re-freeze dead slots whose phantom kv nears the edge.

        Returns ``(state, n_steps, S_cur)``."""
        B = len(live_mask)
        S_cur = state.k_cache.shape[2]
        kv = self._host(state.kv_len, B)
        kv_active = max((int(kv[j]) for j in range(B) if live_mask[j]), default=0)
        if kv_active + n_steps >= S_cur:
            bigger = [s for s in self.buckets[B] if s > S_cur]
            if bigger:
                state = self._escalate(state, bigger[0])
                S_cur = bigger[0]
        if kv_active + n_steps > S_cur:
            n_steps = max(1, S_cur - kv_active)
        assert kv_active + n_steps <= S_cur, (kv_active, n_steps, S_cur)
        for j in range(B):
            if not live_mask[j] and int(kv[j]) + n_steps >= S_cur:
                state = self._freeze(state, j, B)
        return state, n_steps, S_cur

    def _ensure_rows(self, state: DecodeState, B: int, need: int) -> Optional[DecodeState]:
        """Escalate ``state`` until its cache holds ``need`` rows.  Returns
        the (possibly grown) state, or None when no ``gpt_cache`` bucket at
        this batch size fits."""
        S_cur = state.k_cache.shape[2]
        if need <= S_cur:
            return state
        new_S = next((s for s in self.buckets[B] if s >= need), None)
        if new_S is None:
            return None
        return self._escalate(state, new_S)

    def _retire_after_chunk(self, last_sample: int, kv_j: int, B: int, S_cur: int) -> bool:
        """Post-chunk retire check: the reference checks EOS only on the
        interval's LAST sample (``t2s_model.py:655``); a slot within one
        check interval of the LARGEST S bucket's edge also retires — there
        is no escalation room left for another full chunk."""
        if last_sample == self.cfg.eos:
            return True
        return (kv_j + self.check_interval >= S_cur
                and not [s for s in self.buckets[B] if s > S_cur])

    def _refill_slots_prefill(self, state: DecodeState, slot_idx: List[int], items,
                              sa: SampleArgs, generator,
                              B: Optional[int] = None) -> Tuple[DecodeState, bool]:
        """Prefill ``items`` (``(x, y, bert)`` tuples) into ``slot_idx``.
        Several requests arriving together pay ONE batched pass
        (``prefill_slots``) when the group-padded ``[Lx|Ly]`` block fits a
        cache bucket at this batch size; otherwise (mismatched x/y splits
        can pad the GROUP past every bucket although each request fits
        alone) they fall back to one pass a request.
        Escalates the sequence bucket as needed; raises ``ValueError`` when
        a single request fits no bucket at this batch size.  ``B``: the
        wave's slots (default: the state's).  Returns ``(state,
        used_batched_pass)``."""
        B = state.k_cache.shape[1] if B is None else B
        V = self.cfg.vocab_size
        items = [(np.asarray(x, np.int64), np.asarray(y, np.int64),
                  np.asarray(b, np.float32).reshape(len(x), -1)) for x, y, b in items]
        group = self._pad_prompts(items) if len(items) > 1 else None
        if group is not None:
            g_need = max(group[0].shape[1] + group[1].shape[1],
                         max(prompt_rows(x, y) for x, y, _ in items))
            new_state = self._ensure_rows(state, B, g_need)
            if new_state is None:
                group = None
            else:
                state = new_state
        if group is not None:
            state = self._prefill_owned(state, B, slot_idx, group,
                                        self._noise(generator, len(items), V), sa)
            return state, True
        for j, (x, y, b) in zip(slot_idx, items):
            new_state = self._ensure_rows(state, B, prompt_rows(x, y))
            if new_state is None:
                raise ValueError(f"prompt for slot {j} needs {prompt_rows(x, y)} cache "
                                 f"rows; no gpt_cache bucket at B={B} holds it")
            state = new_state
            xp, yp, bp = self._pad_prompt(x, y, b)
            state = self._prefill_owned(
                state, B, [j], (xp[None], yp[None], bp[None], [len(x)], [len(y)]),
                self._noise(generator, 1, V), sa)
        return state, False

    def _prefill_owned(self, state: DecodeState, B: int, slots: List[int], group, gumbel,
                       sa: SampleArgs) -> DecodeState:
        """``prefill_slots`` of the wave slots ``slots`` that this rank holds
        (every slot when the wave is not split): ``group`` is ``(xs, ys, bs,
        x_lens, y_lens)`` with one row per slot, ``gumbel`` [len(slots), V]."""
        lo, hi = self._rows(B)
        mine = [n for n, j in enumerate(slots) if lo <= j < hi]
        if not mine:
            return state
        rows = [np.asarray(a)[mine] for a in group]
        state, _ = prefill_slots(self.params, self.cfg, state, [slots[n] - lo for n in mine],
                                 *self._dev(*rows), gumbel[mine], sa, self.dtype, self.attn_impl)
        return state

    def _gather_live(self, state: DecodeState, live_idx: List[int],
                     new_B: int, B: Optional[int] = None) -> Optional[DecodeState]:
        """Re-pack the live slots of a ``B``-slot wave (default: the state's
        slots) into a ``new_B``-slot state (growth or tail compaction; one
        on-device gather copy, no re-prefill; a split wave gathers its
        slots over dp first).  Returns None when no sequence bucket at
        ``new_B`` holds the longest survivor."""
        B = state.kv_len.shape[0] if B is None else B
        kv = self._host(state.kv_len, B)
        need = int(max((kv[k] for k in live_idx), default=0))
        new_S = next((s for s in self.buckets[new_B] if s > need), None)
        if new_S is None:
            return None
        slot_map = np.full((new_B,), -1, np.int64)
        keep = live_idx[:new_B]
        slot_map[: len(keep)] = keep
        new = _gather_slots(self._full_state(state, B), slot_map, new_S, self.cfg.vocab_size)
        return self._local_state(new, new_B)

    # -- single-utterance generation (``t2s_model.py:385-464``) ------------

    def generate(self, x_ids, y_ids, bert, top_k=15, top_p=1.0, temperature=1.0,
                 repetition_penalty=1.35, generator: Optional[torch.Generator] = None,
                 stream_chunk: Optional[int] = None, boost_first_chunk: bool = False):
        """B=1 generation.  Returns the generated tokens [1, 1, n] int64 (the
        prefill's sample excluded, EOS trimmed); with ``stream_chunk`` a
        generator of ``(tokens_so_far, is_final)`` instead, each chunk held
        back until the next one arrives — except the first when
        ``boost_first_chunk`` is set, which goes out at once."""
        if stream_chunk is not None:
            return self._generate_stream(
                x_ids, y_ids, bert, top_k, top_p, temperature, repetition_penalty,
                generator, stream_chunk, boost_first_chunk, stream_final_semantics=True)
        toks = None
        for toks, _ in self._generate_stream(
                x_ids, y_ids, bert, top_k, top_p, temperature, repetition_penalty,
                generator, stream_chunk=1 << 30):
            pass
        return toks

    def _generator(self, generator):
        if generator is None:
            generator = torch.Generator(device=self.device)
            if self.mesh is None:
                generator.seed()
            else:  # the ranks draw the same noise
                generator.manual_seed(pmesh.broadcast_seed(self.device))
        return generator

    def _generate_stream(self, x_ids, y_ids, bert, top_k, top_p, temperature,
                         repetition_penalty, generator, stream_chunk,
                         boost_first_chunk: bool = False,
                         stream_final_semantics: bool = False):
        cfg = self.cfg
        V = cfg.vocab_size
        generator = self._generator(generator)
        x_ids = np.asarray(x_ids, np.int64).reshape(-1)
        y_ids = np.asarray(y_ids, np.int64).reshape(-1)
        bert = np.asarray(bert, np.float32).reshape(len(x_ids), -1)
        sa = SampleArgs(top_k=top_k, top_p=top_p, temperature=temperature,
                        repetition_penalty=repetition_penalty, use_prev=True)
        # every stretch of the loop sits in a span: the prefill, the host's
        # bookkeeping and noise, the readbacks, the kernels' check, the chunk
        with span("gsv.t2s.prefill", device=True) as pre:
            xp, yp, bp = self._pad_prompt(x_ids, y_ids, bert)
            prompt_len = len(x_ids) + len(y_ids)
            pick_B, S = self._pick_bucket(1, max(prompt_len + 1, len(xp) + len(yp)))
            s_ladder = self.buckets[pick_B]
            k_cache, v_cache = self._alloc_cache(1, S)
            state, tok0 = prefill_batch(
                self.params, cfg, *self._dev(xp[None], yp[None], bp[None]),
                len(x_ids), len(y_ids), k_cache, v_cache, self._noise(generator, 1, V), sa,
                True, self.dtype, self.attn_impl)
            pre.device_end()
            del k_cache, v_cache
            generated: List[int] = [int(tok0[0])]
        steps = 0
        kv = prompt_len  # every step advances the one slot by one row
        eos_at = None
        chunk_accum = 0
        first_chunk = True
        pre_chunk = None
        while True:
            out = None
            with span("gsv.t2s.host"):
                cur_S = state.k_cache.shape[2]
                if kv >= cur_S:
                    # escalate, or stop when the largest bucket is full
                    bigger = [s for s in s_ladder if s > cur_S]
                    if not bigger:
                        break
                    with span("gsv.t2s.escalate"):
                        state = self._escalate(state, bigger[0])
                    cur_S = bigger[0]
                n = min(self.check_interval, cur_S - kv)
                noise = self._noise(generator, n, 1, V)
            state, toks = decode_chunk(self.params, cfg, state, n, sa, noise,
                                       self.initial_suppression_steps, self.dtype,
                                       self.attn_impl)
            with span("gsv.t2s.readback") as rb:
                toks = toks.cpu().numpy()[0]
            steps += n
            kv += n
            self.last_stats = {"prefill_s": pre.seconds, "decode_steps": steps,
                               "decode_s": rb.t1 - pre.t1}
            with span("gsv.t2s.check"):
                self._check_kernels()
            with span("gsv.t2s.host"):
                for t in toks:
                    generated.append(int(t))
                    if int(t) == cfg.eos:
                        eos_at = len(generated) - 1
                        break
                if eos_at is not None:
                    break
                chunk_accum += n
                if chunk_accum >= stream_chunk:
                    chunk_accum = 0
                    out = np.asarray(generated[1:], np.int64)[None, None, :]
            if out is not None:
                if first_chunk and boost_first_chunk:
                    first_chunk = False
                    yield out, False
                    continue
                # a chunk is held back until the next one arrives; the last
                # one held gives way to the final yield below
                if pre_chunk is not None:
                    yield pre_chunk, False
                pre_chunk = out
        if eos_at is not None:
            # reference quirk kept for parity: stream mode keeps the
            # prefill-sampled first token of an EOS-ended run
            start = 0 if stream_final_semantics else 1
            final = generated[start:eos_at]
        else:
            final = generated[1:]
        yield np.asarray(final, np.int64)[None, None, :], True

    # -- continuous batching (``t2s_model.py:555-734``) --------------------

    def generate_batched(self, x_list, y_list, bert_list, top_k=15, top_p=1.0,
                         temperature=1.0, repetition_penalty=1.35,
                         generator: Optional[torch.Generator] = None, compact: bool = True):
        """Continuous batching with slot refill.  Returns (list of np token
        arrays, array of original indices), in order of completion."""
        acc: Dict[int, List[np.ndarray]] = {}
        order: List[int] = []
        for i, toks, done in self.generate_batched_stream(
                x_list, y_list, bert_list, top_k=top_k, top_p=top_p,
                temperature=temperature, repetition_penalty=repetition_penalty,
                generator=generator, compact=compact):
            acc.setdefault(i, []).append(toks)
            if done:
                order.append(i)
        pred = [np.concatenate(acc[i]).astype(np.int64) if acc[i]
                else np.zeros(0, np.int64) for i in order]
        return pred, np.asarray(order, np.int64)

    def generate_batched_stream(self, x_list, y_list, bert_list, top_k=15, top_p=1.0,
                                temperature=1.0, repetition_penalty=1.35,
                                generator: Optional[torch.Generator] = None,
                                compact: bool = True, grouped: bool = False):
        """Incremental continuous batching: yields ``(orig_idx, new_tokens,
        done)`` after every decode chunk, where concatenating a request's
        ``new_tokens`` arrays reproduces its :meth:`generate_batched`
        harvest EXACTLY (same reference window semantics: the prefill
        sample and the interval's last sample are withheld until the
        harvest, and nothing past a sampled EOS is ever emitted).

        With ``grouped=True`` each iteration instead yields the LIST of
        ``(orig_idx, new_tokens, done)`` events produced by one decode
        chunk (same events, same order).

        Batched mode samples without the repetition penalty and without the
        initial suppression window; the first chunk is 1 step and the rest
        are ``check_interval`` steps."""
        cfg = self.cfg
        V = cfg.vocab_size
        generator = self._generator(generator)
        N = len(x_list)
        sa = SampleArgs(top_k=top_k, top_p=top_p, temperature=temperature,
                        repetition_penalty=repetition_penalty, use_prev=False)
        with span("gsv.t2s.prefill", device=True) as pre:
            sizes = sorted(self.buckets.keys())
            B = next((b for b in sizes if b >= N), sizes[-1])
            wave = list(range(min(N, B)))

            # pad the first wave to common (Lx, Ly) shapes; dead slots get a
            # 1-phoneme dummy prompt
            xs, ys, bs, x_lens, y_lens = self._pad_prompts(
                [(np.asarray(x_list[i], np.int64), np.asarray(y_list[i], np.int64),
                  np.asarray(bert_list[i], np.float32)) for i in wave], B)
            prompt_max = int((x_lens + y_lens).max())
            _, S = self._pick_bucket(B, max(prompt_max + 1, xs.shape[1] + ys.shape[1]))
            k_cache, v_cache = self._alloc_cache(B, S)
            lo, hi = self._rows(B)
            state, _ = prefill_batch(
                self.params, cfg, *self._dev(*(a[lo:hi] for a in (xs, ys, bs, x_lens, y_lens))),
                k_cache, v_cache, self._noise(generator, B, V)[lo:hi], sa, False, self.dtype,
                self.attn_impl)
            del k_cache, v_cache

        slot_orig = list(wave) + [-1] * (B - len(wave))
        slot_start = [int(x_lens[j] + y_lens[j]) for j in range(B)]  # kv where generation began
        slot_steps = [0] * B  # decode steps taken for the slot's current request
        slot_harvest = [SlotHarvest() for _ in range(B)]
        ignore = [j >= len(wave) for j in range(B)]
        next_req = len(wave)
        # decode steps in all and by the path that took them (the wave's size
        # changes with compaction), and steps x slots
        stats = {"prefill_s": pre.seconds, "decode_steps": 0,
                 "slot_steps": 0, "k1_steps": 0, "k2_steps": 0, "k1q_steps": 0,
                 "k2q_steps": 0, "generic_steps": 0}

        # the reference's decode loop checks at GLOBAL steps 1, 6, 11, ...
        # (t2s_model.py:634-655), so the first chunk is 1 step and the rest
        # are check_interval; slot refills inherit the global phase
        first_chunk = True
        events: List[tuple] = []
        refill_jobs: List[Tuple[int, int]] = []
        while not all(ignore):
            n_steps = 1 if first_chunk else self.check_interval
            first_chunk = False
            state, n_steps, S_cur = self._prepare_chunk(
                state, [not ig for ig in ignore], n_steps)
            lo, hi = self._rows(B)
            state, toks = decode_chunk(self.params, cfg, state, n_steps, sa,
                                       self._noise(generator, n_steps, B, V)[:, lo:hi], 0,
                                       self.dtype, self.attn_impl)
            with span("gsv.t2s.readback"):
                toks = self._host(toks, B)  # [B, n_steps]
                kv = self._host(state.kv_len, B)
            with span("gsv.t2s.check") as chk:
                self._check_kernels()
            stats["decode_steps"] += n_steps
            stats["slot_steps"] += n_steps * B
            stats[step_path(self.attn_impl, hi - lo) + "_steps"] += n_steps
            stats["decode_s"] = chk.t1 - pre.t1
            self.last_stats = stats
            for j in range(B):
                slot_steps[j] += n_steps
                if not ignore[j]:
                    slot_harvest[j].extend(toks[j])
            buf = None
            for j in range(B):
                if ignore[j]:
                    continue
                # stream out newly-final tokens (SlotHarvest.drain_stream)
                out = slot_harvest[j].drain_stream(cfg.eos)
                if out is not None:
                    events.append((slot_orig[j], out, False))
                    if not grouped:
                        yield events.pop()
                if not self._retire_after_chunk(int(toks[j][-1]), int(kv[j]), B, S_cur):
                    continue
                if buf is None:
                    buf = self._host(state.tok_buf, B)
                    x_len_host = self._host(state.x_len, B)
                # harvest (``t2s_model.py:674-679``): the reference window
                # ``pre_tokens[i, kv-steps+1 : kv]`` excludes both the first
                # post-prefill sample AND the last written sample, then trims
                # at the first EOS — here read from the device tok_buf
                y_len = slot_start[j] - int(x_len_host[j])
                gen = buf[j, y_len + 1: y_len + slot_steps[j]]
                events.append((slot_orig[j], slot_harvest[j].drain_final(cfg.eos, gen), True))
                if not grouped:
                    yield events.pop()

                if next_req < N:
                    refill_jobs.append((j, next_req))
                    next_req += 1
                else:
                    ignore[j] = True
                    # freeze the slot: reset kv_len so it stops growing
                    state = self._freeze(state, j, B)

            # refill every slot that finished this chunk in ONE pass (the
            # harvests above read the pre-refill state; a refill only
            # touches its own slot's rows)
            if refill_jobs:
                state, _ = self._refill_slots_prefill(
                    state, [j for j, _ in refill_jobs],
                    [(x_list[i], y_list[i], bert_list[i]) for _, i in refill_jobs], sa,
                    generator, B)
                for j, i in refill_jobs:
                    slot_orig[j] = i
                    slot_start[j] = len(x_list[i]) + len(y_list[i])
                    slot_steps[j] = 0
                    slot_harvest[j] = SlotHarvest()
                    self.refills += 1
                refill_jobs = []

            # tail compaction: once no requests remain to refill and the
            # wave is mostly dead, re-pack survivors into the smallest batch
            # bucket that fits (one device gather — the tail then decodes
            # through the small-batch kernel instead of paying full-wave
            # steps for frozen slots)
            if compact and next_req >= N:
                live_idx = [k for k in range(B) if not ignore[k]]
                if live_idx and len(live_idx) <= B // 2:
                    smaller = next((b for b in sorted(self.buckets.keys())
                                    if b >= len(live_idx) and b < B), None)
                    new_state = self._gather_live(state, live_idx, smaller, B) \
                        if smaller is not None else None
                    if new_state is not None:
                        state = new_state

                        def remap(lst, fill):
                            return [lst[k] for k in live_idx] + \
                                [fill] * (smaller - len(live_idx))

                        slot_orig = remap(slot_orig, -1)
                        slot_start = remap(slot_start, 0)
                        slot_steps = remap(slot_steps, 0)
                        slot_harvest = remap(slot_harvest, SlotHarvest())
                        ignore = remap(ignore, True)
                        B = smaller
                        self.compactions += 1

            if grouped and events:
                yield events
                events = []
