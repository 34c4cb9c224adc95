"""K1, K2 and K5: the t2s decode step as one call (counterpart of
``gsv_tts_tpu/ops/fused_step.py``).

* K1, :func:`fused_decode_step_sample`: the whole step for one slot —
  embedding, every layer with the K/V row appended in place, the logits head
  and the sampling chain (TPU kernel ``_kernel_sample``), CUDA source
  ``csrc/k1_decode_step.cu``.
* K2, :func:`fused_decode_step_sample_batched`: the same for a wave of ``B``
  slots with per-slot counters (TPU kernel ``_kernel_sample_b``), CUDA source
  ``csrc/k2_decode_step_batched.cu``; every layer's weights cross device
  memory once per step for all ``B`` rows.
  Both are two launches a step: one persistent cooperative kernel for the
  model (``csrc/decode_step_persistent.cuh``: the weights streamed through a
  shared-memory ring; between phases tagged values at one row, a grid
  barrier for a wave) and the sampling chain.
* K5, :func:`fused_decode_step`: a given hidden row through all layers at
  B=1, no embedding, head or sampling (TPU kernel ``_kernel``), CUDA source
  ``csrc/k5_decode_layers.cu``: one launch of the same persistent kernel as
  a layer stack; ``kv_len`` is a ``[1]`` tensor that stays on the device.
* The quantized weight streams of K1 and K2 (the TPU kernels' ``quant`` /
  ``quant4`` modes): :func:`pack_layer_weights_int8` / ``_int4`` quantize
  each layer's four matrices per lane (one float32 scale per output channel
  of qkv, out and mlp1, per contracted channel of mlp2), and the wrappers
  given ``quant="int8"`` or ``"int4"`` stream those pages instead of the
  bf16 matrices (``k1_decode_step_quant`` / ``k2_decode_step_batched_quant``
  entries of the same sources; the table built with ``quant=`` holds them).
  Their launches count in ``.launches_q8`` / ``.launches_q4``, the bf16
  kernels' in ``.launches``.

On CUDA tensors the wrappers launch the hand-written Hopper kernels (built
with ``nvcc`` at first use); on CPU tensors they run the plain PyTorch twins
(``*_ref``), which are also what the card's kernels are held against.  There
is no fallback between the two.

Semantics follow the TPU kernels, not the XLA path, where they differ:
removed ids carry -1e30 instead of -inf, a token's own K/V enter the
attention in float32, and top-p keeps a prefix of the order (value
descending, ties to the lowest id).  Differences from the TPU kernels'
interface: K1's scalars are Python ints, K2's stay ``[B]`` int32 tensors on
the device (the kernel's blocks read their own slot's entries; nothing is
read back per step); the vocabulary is not padded to a lane multiple; any
cache length ``S`` is accepted; indices are bounds-checked instead of
clamped (on the card a bad device-side value sets a flag that
``K1Table.check`` raises on); and the sampled token is also appended to
``tok_buf[b, buf_len[b]]`` in place.  The TPU kernel's three softmax modes
(``rows``, ``vec``, ``shared``) are one function in exact arithmetic, so K2
has one: the exact per-row online softmax.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ..utils import cuda_build
from .norms import layer_norm

NEG = -1e30
MAX_SUPPRESSED = 8
HEAD_DIMS = (8, 16, 32, 64, 128)  # a cache row is read by Dh/8 lanes of a warp
TRACE_BYTES = 4096  # csrc PS_TRACE_BYTES
MAX_VOCAB = 2048  # the sampling block keeps the row and its sort in shared memory
#: slots K2 takes: row accumulators its weight-streaming GEMV keeps per warp
#: (csrc K2_MAX_B); larger waves decode through the generic step
MAX_FUSED_B = 8
PS_STAGE_BYTES = 16384  # a stage of the persistent kernel's weight ring (csrc PS_STAGE_BYTES)
#: (library name, sources) for ``cuda_build``
K1_LIBRARY = ("gsv_k1", ["k1_decode_step.cu"])
K2_LIBRARY = ("gsv_k2", ["k2_decode_step_batched.cu"])
K5_LIBRARY = ("gsv_k5", ["k5_decode_layers.cu"])

_LAYER_FIELDS = ("qkv_w", "qkv_b", "out_w", "out_b", "mlp1_w", "mlp1_b",
                 "mlp2_w", "mlp2_b", "ln1_g", "ln1_b", "ln2_g", "ln2_b")
#: the quantized streams: where the engine keeps a parameter set's packed
#: layers, the kernels' weight format, the launch counter, the largest value
QUANT_KEYS = {"int8": "layers_q8", "int4": "layers_q4"}
_WQ = {"int8": 1, "int4": 2}
_LAUNCHES = {None: "launches", "int8": "launches_q8", "int4": "launches_q4"}
_QMAX = {"int8": 127.0, "int4": 7.0}
#: the four matrices of a quantized layer and the axis their scale reduces:
#: a lane is a row (output channel) of qkv, out and mlp1 and a column
#: (contracted channel) of mlp2, as in the TPU kernels' packed layout
_QUANT_MATS = (("qkv", 1), ("out", 1), ("mlp1", 1), ("mlp2", 0))


# ---------------------------------------------------------------------------
# Quantized weight pages
# ---------------------------------------------------------------------------

def _quantize(w: torch.Tensor, qmax: float, axis: int):
    """Symmetric per-lane quantization of ``w``, in float32 from the model
    dtype: ``s = max|w| over axis / qmax`` (1 where that is 0) and ``q =
    clip(round(w / s), ±qmax)`` (half to even).  Returns (q int8, s)."""
    w = w.float()
    s = w.abs().amax(dim=axis) / qmax
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(w / s.unsqueeze(axis)), -qmax, qmax).to(torch.int8)
    return q, s


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values [N, K] (K even) → bytes [N, K/2] (uint8): element ``2i``
    in the low nibble of byte ``i``, ``2i + 1`` in the high one (the order
    the kernels read along K; the TPU kernels' pairing of lane ``j`` with
    ``j + N/2`` is a TPU layout)."""
    q = q.to(torch.int32)
    return ((q[:, 0::2] & 15) | ((q[:, 1::2] & 15) << 4)).to(torch.uint8)


def unpack_int4(b: torch.Tensor) -> torch.Tensor:
    """:func:`pack_int4`'s bytes [N, K/2] → int8 values [N, K]."""
    b = b.to(torch.int32)
    lo, hi = ((b & 15) ^ 8) - 8, ((b >> 4) ^ 8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(b.shape[0], -1).to(torch.int8)


def _pack_layers(layers, quant: str):
    qmax = _QMAX[quant]
    out = []
    for lp in layers:
        ql = {}
        for name, axis in _QUANT_MATS:
            q, s = _quantize(lp[name + "_w"], qmax, axis)
            ql[name + "_q"] = pack_int4(q) if quant == "int4" else q
            ql[name + "_s"] = s
        out.append(ql)
    return out


def pack_layer_weights_int8(layers):
    """Per-lane int8 quantization of each layer's four matrices (JAX
    ``pack_layer_weights_int8``'s values and scales in the port's layout):
    a list of per-layer dicts of ``qkv_q`` [3D, D], ``out_q`` [D, D],
    ``mlp1_q`` [M, D], ``mlp2_q`` [D, M] int8 and their float32 scales
    ``qkv_s`` [3D], ``out_s`` [D], ``mlp1_s`` [M] (rows) and ``mlp2_s`` [M]
    (columns), so that ``w ≈ q * s`` along each lane."""
    return _pack_layers(layers, "int8")


def pack_layer_weights_int4(layers):
    """As :func:`pack_layer_weights_int8` with int4 values (``s = max|w| /
    7``), two to a byte along K (:func:`pack_int4`): ``qkv_q`` [3D, D/2],
    ``out_q`` [D, D/2], ``mlp1_q`` [M, D/2], ``mlp2_q`` [D, M/2] uint8."""
    return _pack_layers(layers, "int4")


def quant_layers(params, quant: str):
    """The packed layers of ``params`` for ``quant`` (``"int8"`` /
    ``"int4"``): the ones the owner keeps under :data:`QUANT_KEYS`, else
    packed now."""
    if quant not in QUANT_KEYS:
        raise ValueError(f"quant {quant!r}: expected one of {tuple(QUANT_KEYS)}")
    packed = params.get(QUANT_KEYS[quant])
    if packed is None:
        packed = _pack_layers(params["layers"], quant)
    return packed


# ---------------------------------------------------------------------------
# Plain PyTorch twin
# ---------------------------------------------------------------------------

def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to ``w``'s dtype, times ``w``ᵀ, accumulated in
    float32 (the kernel's bf16 operands with a float32 sum)."""
    return F.linear(x.to(w.dtype).float(), w.float())


def _as_counter(v, B: int, dev) -> torch.Tensor:
    """A host int (B=1) or a [B] tensor → [B] int64 tensor on ``dev``."""
    t = torch.as_tensor(v, device=dev).reshape(-1).long()
    if t.numel() != B:
        raise ValueError(f"counter of {t.numel()} entries for {B} slots")
    return t


def filter_row_ref(logits: torch.Tensor, tok_buf: torch.Tensor, buf_len, suppress,
                    suppressed: Sequence[int], sa) -> torch.Tensor:
    """The sampling chain's filtered rows [B, V] (float32): per-row
    suppression → repetition penalty over ``tok_buf[b, :buf_len[b]]`` → top-p
    on the pre-temperature row → temperature → top-k pivot; removed ids hold
    -1e30 (scaled by 1/temperature when the top-p cut removed them, as in
    the TPU kernels).  ``buf_len`` [B] ints, ``suppress`` [B] bools."""
    row = logits.float().clone()
    B, V = row.shape
    dev = row.device
    ids = [s for s in suppressed if 0 <= s < V]
    if ids:
        sup = torch.as_tensor(suppress, device=dev).reshape(B, 1)
        row[:, ids] = torch.where(sup, torch.full_like(row[:, ids], NEG), row[:, ids])
    if sa.use_prev and sa.repetition_penalty != 1.0:
        prev = tok_buf.long()
        valid = ((torch.arange(prev.shape[1], device=dev)[None, :]
                  < _as_counter(buf_len, B, dev)[:, None]) & (prev >= 0) & (prev < V))
        member = torch.zeros((B, V + 1), dtype=torch.bool, device=dev)
        member = member.scatter_(1, torch.where(valid, prev, V), True)[:, :V]
        rp = sa.repetition_penalty
        row = torch.where(member, torch.where(row < 0, row * rp, row / rp), row)
    k = min(sa.top_k, V)
    pos = torch.arange(V, device=dev)[None, :]
    n_keep = torch.full((B, 1), V, device=dev)
    if sa.top_p < 1.0 or k < V:
        key, order = torch.sort(row, dim=-1, descending=True, stable=True)
    if sa.top_p < 1.0:
        e = torch.exp(key - key[:, :1])
        cum = torch.cumsum(e / e.sum(-1, keepdim=True), -1)
        over = (cum > sa.top_p) & (pos > 0)
        n_keep = torch.where(over.any(-1, keepdim=True),
                             over.int().argmax(-1, keepdim=True), n_keep)
        row = row.scatter(1, order, torch.where(pos >= n_keep, torch.full_like(key, NEG), key))
    inv_t = torch.tensor(1.0 / max(sa.temperature, 1e-5), dtype=torch.float32, device=dev)
    row = row * inv_t
    if k < V:
        pivot = torch.where(k - 1 < n_keep, key[:, k - 1:k], torch.full_like(key[:, :1], NEG))
        row = torch.where(row < pivot * inv_t, torch.full_like(row, NEG), row)
    return row


def decode_layers_ref(x, layers, k_cache, v_cache, kv, first_layer: int = 0, qlayers=None):
    """The twins' layer loop: float32 ``x`` [B, D] through ``layers`` (a list
    of per-layer dicts, applied to cache layers ``first_layer`` onwards).
    Each slot's K/V row is written in place at ``kv[b]`` ([B] int64);
    attention runs over the cache rows below it plus the token's own float32
    K/V.  With ``qlayers`` (:func:`pack_layer_weights_int8` / ``_int4``'s
    list) the four products read the packed values, the inputs rounded to
    the model dtype, and the scales enter as the quantized kernels apply
    them: on the sums of qkv, out and mlp1 before residual and bias, and
    mlp2's on the ReLU'd activation in float32.  Returns the final hidden
    [B, D] in float32."""
    _, B, S, H, Dh = k_cache.shape
    D = H * Dh
    cd = k_cache.dtype
    dev = k_cache.device
    scale = 1.0 / math.sqrt(Dh)
    bidx = torch.arange(B, device=dev)
    below = (torch.arange(S, device=dev)[None, :] < kv[:, None])[:, :, None]  # [B, S, 1]
    for i, lp in enumerate(layers, first_layer):
        ql = None if qlayers is None else qlayers[i - first_layer]

        def prod(v, name):
            """``v`` times the layer's matrix ``name`` (on the pages: scaled per
            output lane; mlp2's scale is on ``v``)."""
            if ql is None:
                return _mm(v, lp[name + "_w"])
            q = ql[name + "_q"]
            q = unpack_int4(q) if q.dtype == torch.uint8 else q
            y = F.linear(v.to(lp[name + "_w"].dtype).float(), q.float())
            return y if name == "mlp2" else y * ql[name + "_s"]

        qkv = prod(x, "qkv") + lp["qkv_b"].float()
        q, k_new, v_new = (t.reshape(B, H, Dh) for t in qkv.split(D, dim=-1))
        k_cache[i, bidx, kv] = k_new.to(cd)
        v_cache[i, bidx, kv] = v_new.to(cd)
        scores = (k_cache[i].float() * q[:, None]).sum(-1).masked_fill(~below, float("-inf"))
        scores = torch.cat([scores, (k_new * q).sum(-1)[:, None]], 1) * scale  # [B, S+1, H]
        p = torch.softmax(scores, dim=1)
        attn = ((p[:, :S, :, None] * v_cache[i].float()).sum(1)
                + p[:, S, :, None] * v_new).reshape(B, D)
        h = x + prod(attn, "out") + lp["out_b"].float()
        h = layer_norm(h, lp["ln1_g"], lp["ln1_b"])
        m1 = torch.relu(prod(h, "mlp1") + lp["mlp1_b"].float())
        if ql is not None:  # mlp2's lane is its contracted channel
            m1 = m1 * ql["mlp2_s"]
        h2 = h + prod(m1, "mlp2") + lp["mlp2_b"].float()
        x = layer_norm(h2, lp["ln2_g"], lp["ln2_b"])
    return x


def decode_hidden_ref(params, k_cache, v_cache, kv_len, x_len, last_tok, quant=None):
    """The twins' model half for B slots: embedding with the positional
    entry ``max(kv_len - x_len, 0)`` (the clamp serves frozen slots, whose
    ``kv_len < x_len``), every layer (:func:`decode_layers_ref`, on the
    ``quant`` pages when given) and the head.  ``kv_len``/``x_len``: host
    ints (B=1) or [B] tensors.  Returns (final hidden [B, D], logits [B, V]),
    both float32."""
    B = k_cache.shape[1]
    cd = k_cache.dtype
    dev = k_cache.device
    kv = _as_counter(kv_len, B, dev)
    pe_idx = (kv - _as_counter(x_len, B, dev)).clamp_min(0)
    emb = params["audio_emb"][last_tok.long()].to(cd)
    pe_q = (params["audio_pos_alpha"].float() * params["pe"][pe_idx].float()).to(cd)
    x = decode_layers_ref((emb + pe_q).float(), params["layers"], k_cache, v_cache, kv,
                          qlayers=quant_layers(params, quant) if quant else None)
    return x, _mm(x, params["predict_w"])


def fused_decode_step_ref(x, layers, k_cache, v_cache, kv_len):
    """Plain PyTorch twin of K5: ``x`` [1, D] through all layers, each
    layer's K/V row written in place at ``kv_len``.  Returns ``(h [1, D] in
    x's dtype, k_cache, v_cache)``."""
    kv = _as_counter(kv_len, x.shape[0], x.device)
    h = decode_layers_ref(x.float(), layers, k_cache, v_cache, kv)
    return h.to(x.dtype), k_cache, v_cache


def fused_decode_step_sample_batched_ref(params, k_cache, v_cache, tok_buf, kv_len, x_len,
                                         last_tok, buf_len, step_idx, gumbel, *, sa,
                                         suppress_until: int = 0, suppressed=(),
                                         tok_out=None, row_out=None, quant=None):
    """Plain PyTorch twin of both kernels (same effects): each slot's K/V
    row is written at ``kv_len[b]`` and its token at
    ``tok_buf[b, buf_len[b]]`` in place.  Counters are host ints (B=1) or
    [B] tensors.  ``quant`` (``"int8"`` / ``"int4"``): the layers on their
    quantized pages (:func:`quant_layers`).  Returns ``(tok [B] int32, row
    [B, V] float32, k_cache, v_cache)``."""
    B, S = tok_buf.shape
    dev = tok_buf.device
    _, logits = decode_hidden_ref(params, k_cache, v_cache, kv_len, x_len, last_tok, quant)
    sup = tuple(suppressed) if suppress_until else ()
    row = filter_row_ref(logits, tok_buf, buf_len,
                          _as_counter(step_idx, B, dev) < suppress_until, sup, sa)
    tok = torch.argmax(row + gumbel.float(), dim=-1).to(torch.int32)
    bl = _as_counter(buf_len, B, dev)
    fits = bl < S
    tok_buf[torch.arange(B, device=dev)[fits], bl[fits]] = tok[fits]
    if tok_out is not None:
        tok_out.copy_(tok)
        tok = tok_out
    if row_out is not None:
        row_out.copy_(row)
        row = row_out
    return tok, row, k_cache, v_cache


#: K1's twin is the batched twin at B=1 with host-int counters
fused_decode_step_sample_ref = fused_decode_step_sample_batched_ref


# ---------------------------------------------------------------------------
# CUDA kernel binding
# ---------------------------------------------------------------------------

class _LayerWeights(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _LAYER_FIELDS]


class _QuantScales(ctypes.Structure):  # csrc PsQuantScales
    _fields_ = [(n, ctypes.c_void_p) for n, _ in _QUANT_MATS]


_SAMPLE_FIELDS = ([("n_suppressed", ctypes.c_int),
                   ("suppressed", ctypes.c_int * MAX_SUPPRESSED), ("use_prev", ctypes.c_int)]
                  + [(n, ctypes.c_float) for n in ("rep_penalty", "top_p", "inv_temperature")]
                  + [("top_k", ctypes.c_int)])


def _pointers(*names):
    return [(n, ctypes.c_void_p) for n in names]


#: the float32 rows a wave hands from phase to phase (K2, a K6 group of
#: more than one row; one row hands over through tagged values)
_WAVE_ROWS = ("h", "qkv", "attn", "mlp")
#: the :class:`LayerTable` workspace an argument struct may point at
_WORKSPACE = ("x", *_WAVE_ROWS, "trace", "err")
# what the persistent kernels read besides: the layer table on the device;
# K1's tagged workspace and the launch's number; K2's extra workspace rows and
# its grid barrier's counter
_PERSISTENT_FIELDS = _pointers("layers_dev", "tagged", "pre", "bar") + [("epoch", ctypes.c_uint)]


def _layers_fields(rows=()):
    """K5's and K6's fields after their widths: the rows in and out, the
    caches, the counters, the workspace (``rows``: a wave's)."""
    return ([("attn_scale", ctypes.c_float)]
            + _pointers("x_in", "x_out", "k_cache", "v_cache", "kv_len", *rows, "trace", "err")
            + _PERSISTENT_FIELDS)


class _K1Args(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_int) for n in ("L", "D", "H", "M", "V", "S", "P")]
        + [("alpha", ctypes.c_float), ("attn_scale", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in ("audio_emb", "pe", "predict_w", "k_cache",
                                          "v_cache", "tok_buf", "last_tok", "gumbel")]
        + [(n, ctypes.c_int) for n in ("kv_len", "pe_idx", "buf_len", "suppress")]
        + _SAMPLE_FIELDS + _pointers("x", "trace", "row_out", "tok_out", "err")
        + _PERSISTENT_FIELDS + [("scales", ctypes.c_void_p)]
    )


class _K2Args(ctypes.Structure):
    _fields_ = (
        [(n, ctypes.c_int) for n in ("B", "L", "D", "H", "M", "V", "S", "P")]
        + [("alpha", ctypes.c_float), ("attn_scale", ctypes.c_float)]
        + [(n, ctypes.c_void_p) for n in ("audio_emb", "pe", "predict_w", "k_cache",
                                          "v_cache", "tok_buf", "kv_len", "x_len",
                                          "last_tok", "buf_len", "step_idx", "gumbel")]
        + [("suppress_until", ctypes.c_int)]
        + _SAMPLE_FIELDS + _pointers("x", *_WAVE_ROWS, "trace", "row_out", "tok_out", "err")
        + _PERSISTENT_FIELDS + [("scales", ctypes.c_void_p)]
    )


class _K5Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("L", "D", "H", "M", "S", "x_f32")] + _layers_fields()


@functools.lru_cache(maxsize=None)
def _workspace_fields(struct) -> tuple:
    """The names of :data:`_WORKSPACE` an argument struct type has."""
    return tuple(n for n, _ in struct._fields_ if n in _WORKSPACE)


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (first call only) and bind ``csrc/k1_decode_step.cu``."""
    lib = cuda_build.load_library(*K1_LIBRARY)
    lib.k1_decode_step.argtypes = [ctypes.POINTER(_K1Args), ctypes.c_void_p]
    lib.k1_decode_step_quant.argtypes = [ctypes.POINTER(_K1Args), ctypes.c_int, ctypes.c_void_p]
    lib.k1_barrier_loop.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p]
    for fn in (lib.k1_decode_step, lib.k1_decode_step_quant, lib.k1_barrier_loop):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_batched_kernels() -> ctypes.CDLL:
    """Build (first call only) and bind ``csrc/k2_decode_step_batched.cu``."""
    lib = cuda_build.load_library(*K2_LIBRARY)
    lib.k2_decode_step_batched.argtypes = [ctypes.POINTER(_K2Args), ctypes.c_void_p]
    lib.k2_decode_step_batched_quant.argtypes = [ctypes.POINTER(_K2Args), ctypes.c_int,
                                                 ctypes.c_void_p]
    for fn in (lib.k2_decode_step_batched, lib.k2_decode_step_batched_quant):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_layers_kernels() -> ctypes.CDLL:
    """Build (first call only) and bind ``csrc/k5_decode_layers.cu``."""
    lib = cuda_build.load_library(*K5_LIBRARY)
    lib.k5_decode_layers.argtypes = [ctypes.POINTER(_K5Args), ctypes.c_void_p]
    lib.k5_decode_layers.restype = ctypes.c_int
    return lib


def _need(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"decode step kernel: {msg}")


_err_words = {}  # device -> the [1] int32 error word the t2s kernels (K1, K2, K4-K6) set bits in


def error_word(dev: torch.device) -> torch.Tensor:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    err = _err_words.get(dev)
    if err is None:
        err = _err_words[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return err


def check(dev) -> None:
    """Raise if a launch on ``dev`` found a device-side value out of range
    (reads one int from the card; call where the host synchronises anyway).
    ``"cuda"`` without an index means the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    err = _err_words.get(dev)
    bits = int(err.item()) if err is not None else 0
    if bits:
        err.zero_()
        what = [name for bit, name in ((1, "last_tok outside [0, V)"),
                                       (2, "kv_len outside the cache"),
                                       (4, "positional index outside the table"),
                                       (8, "prefill x_lens / xy_lens outside the prompt block"),
                                       (16, "a wait inside the persistent step kernel gave up "
                                            "(its results are void; build a new K1Table "
                                            "before decoding on)"))
                if bits & bit]
        raise RuntimeError("t2s kernel: " + ", ".join(what))


def _device_bytes(struct_array, dev) -> torch.Tensor:
    """A ctypes array's bytes copied to ``dev``."""
    return torch.frombuffer(bytearray(bytes(struct_array)), dtype=torch.uint8).to(dev)


class LayerTable:
    """What the layer kernels (K1, K2, K5, K6) read besides the per-step
    tensors: a table of the layers' weight pointers (built on the host,
    copied to the card), a float32 workspace on the card for up to
    ``MAX_FUSED_B`` rows, and the persistent kernel's
    hand-over state: the tagged values of one row, the grid barrier's
    counter and the one count (``epoch``) that numbers every launch on this
    workspace, whichever kernel makes it.  ``layers`` is a list of per-layer
    dicts; the table holds it alive (``kept``).  One table serves one decode
    at a time — its workspace is shared.  Whoever owns the parameters builds
    one table over them (the engine's ``K1Table``) and hands it to the
    wrappers; a wrapper given none builds one for its call."""

    def __init__(self, layers):
        first = layers[0]
        self.device = first["qkv_w"].device
        _need(self.device.type == "cuda", "the kernels' table needs CUDA parameters")
        self.D = first["qkv_w"].shape[1]
        self.M = first["mlp1_w"].shape[0]
        self.L = len(layers)
        D, M = self.D, self.M
        _need(D % 8 == 0 and M % 8 == 0, f"D={D} and M={M} must be multiples of 8")
        shapes = {"qkv_w": (3 * D, D), "qkv_b": (3 * D,), "out_w": (D, D), "out_b": (D,),
                  "mlp1_w": (M, D), "mlp1_b": (M,), "mlp2_w": (D, M), "mlp2_b": (D,),
                  "ln1_g": (D,), "ln1_b": (D,), "ln2_g": (D,), "ln2_b": (D,)}
        bf = torch.bfloat16
        self.layers = (_LayerWeights * self.L)(*[
            _LayerWeights(*[self.ptr(lp[n], shapes[n], torch.float32 if n.startswith("ln") else bf)
                            for n in _LAYER_FIELDS]) for lp in layers])
        # [rows, D | D | 3D | D | M | D]: B=1 kernels use row 0, the others rows [0, B)
        R = MAX_FUSED_B
        ws = torch.empty(R * (7 * D + M), dtype=torch.float32, device=self.device)
        self.x, self.h, self.qkv, self.attn, self.mlp, self.pre = torch.split(
            ws, [R * D, R * D, 3 * R * D, R * D, R * M, R * D])
        self.err = error_word(self.device)
        self.trace = torch.empty(TRACE_BYTES // 4, dtype=torch.float32, device=self.device)
        self.kept = layers
        # the persistent kernel's copy of the layer table; what its phases
        # hand to each other at one row: (value, tag) pairs for
        # [D | D | 3D | D | M], the tag naming the launch (``epoch``, counted
        # here from 1 in 24 bits for every launch on this workspace: two
        # counts could give two launches one tag, and a reader would take
        # the older launch's value) and the layer that wrote the value; and
        # the counter of the grid barrier between a wave's phases (it only
        # grows)
        self.layers_dev = _device_bytes(self.layers, self.device)
        self.tagged = torch.zeros((6 * D + M, 2), dtype=torch.int32, device=self.device)
        self.epoch = 0
        self.bar = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.persistent_ok = set()  # the hand-over modes check_persistent has passed

    def ptr(self, t, shape, dtype):
        _need(t.device == self.device and t.dtype == dtype and t.is_contiguous()
              and tuple(t.shape) == tuple(shape) and t.data_ptr() % 16 == 0,
              f"weight {tuple(t.shape)} {t.dtype} must be contiguous, 16-byte "
              f"aligned {dtype} {tuple(shape)} on {self.device}")
        return t.data_ptr()

    def work(self, a):
        """The workspace fields of the argument struct ``a``: those of
        :data:`_WORKSPACE` its type has (``trace``: where a traced build of
        the persistent kernel writes its clock marks)."""
        for name in _workspace_fields(type(a)):
            setattr(a, name, getattr(self, name).data_ptr())

    def check(self):
        """Raise if a launch found a device-side value out of range
        (:func:`check` for this table's device)."""
        check(self.device)

    def check_persistent(self, tagged: bool):
        """Raise on widths the persistent kernel does not take (at one row it
        hands over through ``tagged`` values, for a wave through barriers).
        What is left to the launch: the shared memory a block needs (its rows
        of D and M floats beside the ring), refused as an invalid value.  A
        table's widths do not change: each mode is checked once."""
        if tagged in self.persistent_ok:
            return
        _need(2 * max(self.D, self.M) <= PS_STAGE_BYTES,
              f"a weight row of {max(self.D, self.M)} bf16 exceeds a {PS_STAGE_BYTES}-byte "
              f"ring stage")
        if tagged:  # without barriers, what orders a buffer's writers behind its readers
            sms = torch.cuda.get_device_properties(self.device).multi_processor_count
            _need(min(3 * self.D, self.M) >= sms and self.L <= 255,
                  f"D={self.D}, M={self.M}: every one of the card's {sms} blocks needs a row of "
                  f"the QKV and MLP-1 products (and at most 255 layers)")
        self.persistent_ok.add(tagged)

    def persistent(self, a, layer: int = 0):
        """The persistent kernel's fields of an argument struct: the device
        table from entry ``layer`` on, the hand-over state, and this launch's
        number."""
        self.epoch = self.epoch % 0xFFFFFE + 1  # 1 .. 2^24 - 2: never 0, the fresh workspace's
        a.layers_dev = self.layers_dev.data_ptr() + layer * ctypes.sizeof(_LayerWeights)
        a.tagged, a.epoch = self.tagged.data_ptr(), self.epoch
        a.pre, a.bar = self.pre.data_ptr(), self.bar.data_ptr()


class K1Table(LayerTable):
    """The layer table plus what the whole-step kernels (K1 and K2) read
    around the layers: embedding, positional table and head.  Build it once
    per parameter set (the engine keeps it under ``params["k1_table"]``); it
    holds the parameters alive.  Built with ``quant="int8"`` / ``"int4"`` it
    also holds that stream's pages and scales (:func:`quant_layers`) and a
    second device table pointing the four matrices at them; the bf16 weights
    stay, for the launches that stream them."""

    def __init__(self, params, quant=None):
        pw = params["predict_w"]
        _need(pw.device.type == "cuda", "K1Table needs CUDA parameters")
        super().__init__(params["layers"])
        self.V = pw.shape[0]
        D = self.D
        _need(self.V <= MAX_VOCAB, f"vocabulary {self.V} > {MAX_VOCAB}")
        bf = torch.bfloat16
        self.audio_emb = self.ptr(params["audio_emb"], (self.V, D), bf)
        self.predict_w = self.ptr(pw, (self.V, D), bf)
        pe = params["pe"]
        self.P = pe.shape[0]
        self.pe = self.ptr(pe, (self.P, D), torch.float32)
        self.alpha = float(params["audio_pos_alpha"].float().reshape(-1)[0])
        self.params = params
        self.quant = quant
        if quant is not None:
            self._add_quant(quant, quant_layers(params, quant))

    def _add_quant(self, quant, qlayers):
        D, M = self.D, self.M
        _need(D % 32 == 0 and M % 32 == 0,
              f"D={D} and M={M} must be multiples of 32 for a quantized stream (its int4 rows "
              f"are whole 16-byte runs)")
        _need(len(qlayers) == self.L, f"{len(qlayers)} packed layers for {self.L}")
        per, qd = (2, torch.uint8) if quant == "int4" else (1, torch.int8)
        shapes = {"qkv": (3 * D, D), "out": (D, D), "mlp1": (M, D), "mlp2": (D, M)}
        lanes = {"qkv": 3 * D, "out": D, "mlp1": M, "mlp2": M}
        entries, scales = [], []
        for w, ql in zip(self.layers, qlayers):
            e = _LayerWeights.from_buffer_copy(bytes(w))
            sc = _QuantScales()
            for name, _ in _QUANT_MATS:
                n, k = shapes[name]
                setattr(e, name + "_w", self.ptr(ql[name + "_q"], (n, k // per), qd))
                setattr(sc, name, self.ptr(ql[name + "_s"], (lanes[name],), torch.float32))
            entries.append(e)
            scales.append(sc)
        self.layers_dev_q = _device_bytes((_LayerWeights * self.L)(*entries), self.device)
        self.scales_dev = _device_bytes((_QuantScales * self.L)(*scales), self.device)
        self.qlayers = qlayers

    def check_quant(self, quant):
        _need(quant is None or quant in QUANT_KEYS, f"quant {quant!r}")
        _need(quant is None or quant == self.quant,
              f"the table holds no {quant} pages (built with quant={self.quant!r})")

    def fill(self, a, sa, sup, quant=None):
        """The fields both whole-step argument structs share: widths,
        weights (the ``quant`` pages' table when given) and the sampling
        settings."""
        a.L, a.D, a.M, a.V, a.P = self.L, self.D, self.M, self.V, self.P
        a.alpha = self.alpha
        a.audio_emb, a.pe, a.predict_w = self.audio_emb, self.pe, self.predict_w
        a.n_suppressed = len(sup)
        for i, s in enumerate(sup):
            a.suppressed[i] = s
        a.use_prev = int(bool(sa.use_prev))
        a.rep_penalty = sa.repetition_penalty
        a.top_p = sa.top_p
        a.inv_temperature = 1.0 / max(sa.temperature, 1e-5)
        a.top_k = sa.top_k
        self.persistent(a)
        if quant is not None:
            a.layers_dev, a.scales = self.layers_dev_q.data_ptr(), self.scales_dev.data_ptr()


def _check_step_args(params, k_cache, v_cache, tok_buf, gumbel, sa, suppress_until, suppressed):
    """Host-side checks K1 and K2 share; returns (suppressed ids, V, P)."""
    L, B, S, H, Dh = k_cache.shape
    V = params["predict_w"].shape[0]
    _need(v_cache.shape == k_cache.shape, "k/v cache shapes differ")
    _need(tuple(tok_buf.shape) == (B, S), f"tok_buf {tuple(tok_buf.shape)} is not ({B}, {S})")
    _need(tuple(gumbel.shape) == (B, V), f"gumbel {tuple(gumbel.shape)} is not ({B}, {V})")
    sup = tuple(int(s) for s in suppressed) if suppress_until else ()
    _need(len(sup) <= MAX_SUPPRESSED, f"at most {MAX_SUPPRESSED} suppressed ids")
    _need(sa.top_k >= 1, f"top_k={sa.top_k} must be at least 1")
    return sup, V, params["pe"].shape[0]


def _check_cuda_tensors(dev, table, k_cache, named):
    """Device, dtype, contiguity and alignment of the per-step tensors."""
    L, B, S, H, Dh = k_cache.shape
    _need(table.L == L and table.D == H * Dh and Dh in HEAD_DIMS,
          f"cache [{L}, {B}, {S}, {H}, {Dh}] does not match the weights "
          f"(head dim must be one of {HEAD_DIMS})")
    for name, t, dtype in named:
        _need(t.device == dev and t.dtype == dtype and t.is_contiguous()
              and t.data_ptr() % 4 == 0, f"{name} must be a contiguous {dtype} tensor on {dev}")
    _need(k_cache.data_ptr() % 16 == 0 and named[1][1].data_ptr() % 16 == 0,
          "the caches must be 16-byte aligned")


def _launch(entry, what: str, a, dev, *extra):
    """Call a persistent kernel's entry point on ``dev``'s current stream
    with ``extra`` arguments after the struct; raise on the CUDA error of a
    refused launch (an invalid value: widths that need more shared memory
    than a block has; a cooperative launch too large: a card that cannot
    hold one block per SM, shared with another process)."""
    rc = entry(ctypes.byref(a), *extra, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def _k1_args(params, k_cache, v_cache, tok_buf, kv_len, x_len, last_tok, buf_len, step_idx,
             gumbel, sa, suppress_until, suppressed, tok_out, row_out, quant=None):
    """Check K1's arguments; on the CPU return None, else the filled argument
    struct with its table and outputs ``(a, table, tok_out, row_out)``."""
    L, B, S, H, Dh = k_cache.shape
    _need(B == 1, f"batch {B}: this kernel is B=1")
    sup, V, P = _check_step_args(params, k_cache, v_cache, tok_buf, gumbel, sa,
                                 suppress_until, suppressed)
    _need(0 <= kv_len < S, f"kv_len={kv_len} outside the cache [0, {S})")
    _need(0 <= kv_len - x_len < P, f"positional index {kv_len - x_len} outside [0, {P})")
    _need(0 <= buf_len <= S, f"buf_len {buf_len} does not fit S={S}")
    dev = k_cache.device
    if dev.type == "cpu":
        return None
    _need(dev.type == "cuda", f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")

    table = params.get("k1_table")
    if table is None:
        table = K1Table(params, quant)
    table.check_quant(quant)
    table.check_persistent(tagged=True)
    if tok_out is None:
        tok_out = torch.empty(1, dtype=torch.int32, device=dev)
    if row_out is None:
        row_out = torch.empty((1, V), dtype=torch.float32, device=dev)
    _check_cuda_tensors(dev, table, k_cache, (
        ("k_cache", k_cache, torch.bfloat16), ("v_cache", v_cache, torch.bfloat16),
        ("tok_buf", tok_buf, torch.int32), ("last_tok", last_tok, torch.int32),
        ("gumbel", gumbel, torch.float32), ("tok_out", tok_out, torch.int32),
        ("row_out", row_out, torch.float32)))
    _need(last_tok.numel() == 1 and tok_out.numel() == 1
          and tuple(row_out.shape) == (1, V), "last_tok/tok_out/row_out shapes")

    a = _K1Args()
    table.fill(a, sa, sup, quant)
    a.H, a.S = H, S
    a.attn_scale = 1.0 / math.sqrt(Dh)
    a.k_cache, a.v_cache = k_cache.data_ptr(), v_cache.data_ptr()
    a.tok_buf, a.last_tok, a.gumbel = tok_buf.data_ptr(), last_tok.data_ptr(), gumbel.data_ptr()
    a.kv_len, a.pe_idx, a.buf_len = kv_len, kv_len - x_len, buf_len
    a.suppress = int(step_idx < suppress_until)
    table.work(a)
    a.row_out, a.tok_out = row_out.data_ptr(), tok_out.data_ptr()
    return a, table, tok_out, row_out


def _count(wrapper, quant):
    name = _LAUNCHES[quant]
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def fused_decode_step_sample(params, k_cache, v_cache, tok_buf, kv_len: int,
                             x_len: int, last_tok, buf_len: int, step_idx: int,
                             gumbel, *, sa, suppress_until: int = 0,
                             suppressed=(), tok_out=None, row_out=None, quant=None):
    """K1: one full decode step at B=1.

    ``k_cache``/``v_cache`` [L, 1, S, H, Dh] (updated in place at row
    ``kv_len``); ``tok_buf`` [1, S] int32 (token appended at ``buf_len``);
    ``last_tok`` [1] int32 on the device; ``gumbel`` [1, V] float32 noise;
    ``kv_len``/``x_len``/``buf_len``/``step_idx`` host ints.  ``tok_out``
    [1] int32 / ``row_out`` [1, V] float32 receive the results when given.
    ``quant`` (``"int8"`` / ``"int4"``): the layers stream their quantized
    pages (on the card the table must hold them: ``K1Table(params,
    quant)``).  Returns ``(tok, row, k_cache, v_cache)``.
    """
    prepared = _k1_args(params, k_cache, v_cache, tok_buf, kv_len, x_len, last_tok, buf_len,
                        step_idx, gumbel, sa, suppress_until, suppressed, tok_out, row_out, quant)
    if prepared is None:
        return fused_decode_step_sample_ref(
            params, k_cache, v_cache, tok_buf, kv_len, x_len, last_tok, buf_len,
            step_idx, gumbel, sa=sa, suppress_until=suppress_until,
            suppressed=suppressed, tok_out=tok_out, row_out=row_out, quant=quant)
    a, _, tok_out, row_out = prepared
    lib = load_kernels()
    if quant is None:
        _launch(lib.k1_decode_step, "K1", a, k_cache.device)
    else:
        _launch(lib.k1_decode_step_quant, f"K1 {quant}", a, k_cache.device, _WQ[quant])
    _count(fused_decode_step_sample, quant)
    return tok_out, row_out, k_cache, v_cache


def _k2_args(params, k_cache, v_cache, tok_buf, kv_len, x_len, last_tok, buf_len, step_idx,
             gumbel, sa, suppress_until, suppressed, tok_out, row_out, quant=None):
    """Check K2's arguments; on the CPU return None, else the filled argument
    struct with its table and outputs ``(a, table, tok_out, row_out)``."""
    L, B, S, H, Dh = k_cache.shape
    _need(1 <= B <= MAX_FUSED_B, f"batch {B}: this kernel takes 1..{MAX_FUSED_B} slots")
    sup, V, P = _check_step_args(params, k_cache, v_cache, tok_buf, gumbel, sa,
                                 suppress_until, suppressed)
    counters = (("kv_len", kv_len), ("x_len", x_len), ("last_tok", last_tok),
                ("buf_len", buf_len), ("step_idx", step_idx))
    for name, t in counters:
        _need(isinstance(t, torch.Tensor) and tuple(t.shape) == (B,),
              f"{name} must be a [{B}] tensor")
    dev = k_cache.device
    if dev.type == "cpu":
        _need(bool(((kv_len >= 0) & (kv_len < S)).all()), f"kv_len outside the cache [0, {S})")
        _need(bool((kv_len - x_len < P).all()), f"positional index outside [0, {P})")
        return None
    _need(dev.type == "cuda", f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")

    table = params.get("k1_table")
    if table is None:
        table = K1Table(params, quant)
    table.check_quant(quant)
    table.check_persistent(tagged=False)
    if tok_out is None:
        tok_out = torch.empty(B, dtype=torch.int32, device=dev)
    if row_out is None:
        row_out = torch.empty((B, V), dtype=torch.float32, device=dev)
    _check_cuda_tensors(dev, table, k_cache, (
        ("k_cache", k_cache, torch.bfloat16), ("v_cache", v_cache, torch.bfloat16),
        ("tok_buf", tok_buf, torch.int32), ("gumbel", gumbel, torch.float32),
        ("tok_out", tok_out, torch.int32), ("row_out", row_out, torch.float32))
        + tuple((n, t, torch.int32) for n, t in counters))
    _need(tuple(tok_out.shape) == (B,) and tuple(row_out.shape) == (B, V),
          "tok_out/row_out shapes")

    a = _K2Args()
    table.fill(a, sa, sup, quant)
    a.B, a.H, a.S = B, H, S
    a.attn_scale = 1.0 / math.sqrt(Dh)
    a.k_cache, a.v_cache = k_cache.data_ptr(), v_cache.data_ptr()
    a.tok_buf, a.gumbel = tok_buf.data_ptr(), gumbel.data_ptr()
    for name, t in counters:
        setattr(a, name, t.data_ptr())
    a.suppress_until = suppress_until
    table.work(a)
    a.row_out, a.tok_out = row_out.data_ptr(), tok_out.data_ptr()
    return a, table, tok_out, row_out


def fused_decode_step_sample_batched(params, k_cache, v_cache, tok_buf, kv_len, x_len,
                                     last_tok, buf_len, step_idx, gumbel, *, sa,
                                     suppress_until: int = 0, suppressed=(),
                                     tok_out=None, row_out=None, quant=None):
    """K2: one full decode step for a wave of ``B <= MAX_FUSED_B`` slots.

    ``k_cache``/``v_cache`` [L, B, S, H, Dh] (slot b updated in place at row
    ``kv_len[b]``); ``tok_buf`` [B, S] int32 (slot b's token appended at
    ``buf_len[b]``); ``kv_len``/``x_len``/``last_tok``/``buf_len``/
    ``step_idx`` [B] int32 on the tensors' device — nothing is read back;
    ``gumbel`` [B, V] float32 noise.  A frozen slot (``kv_len < x_len``)
    takes positional entry 0; slot b is suppressed while ``step_idx[b] <
    suppress_until``.  ``tok_out`` [B] int32 / ``row_out`` [B, V] float32
    receive the results when given.  ``quant``: as K1's.  Returns ``(tok,
    row, k_cache, v_cache)``.
    """
    prepared = _k2_args(params, k_cache, v_cache, tok_buf, kv_len, x_len, last_tok, buf_len,
                        step_idx, gumbel, sa, suppress_until, suppressed, tok_out, row_out, quant)
    if prepared is None:
        return fused_decode_step_sample_batched_ref(
            params, k_cache, v_cache, tok_buf, kv_len, x_len, last_tok, buf_len,
            step_idx, gumbel, sa=sa, suppress_until=suppress_until,
            suppressed=suppressed, tok_out=tok_out, row_out=row_out, quant=quant)
    a, _, tok_out, row_out = prepared
    lib = load_batched_kernels()
    if quant is None:
        _launch(lib.k2_decode_step_batched, "K2", a, k_cache.device)
    else:
        _launch(lib.k2_decode_step_batched_quant, f"K2 {quant}", a, k_cache.device, _WQ[quant])
    _count(fused_decode_step_sample_batched, quant)
    return tok_out, row_out, k_cache, v_cache


def grid_barrier_loop(table: "K1Table", n: int) -> None:
    """Launch the persistent kernels' grid barrier ``n`` times in a row on
    ``table``'s counter (what one barrier costs; for measurements only)."""
    rc = load_kernels().k1_barrier_loop(
        table.bar.data_ptr(), n, table.err.data_ptr(),
        torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"barrier loop launch failed: CUDA error {rc}")


def check_hidden_rows(x, k_cache, v_cache, kv_len):
    """Checks K5 and K6 share: ``x`` [B, D] of bf16 or float32, the stacked
    caches [L, B, S, H, Dh], ``kv_len`` a [B] tensor."""
    _need(k_cache.dim() == 5 and v_cache.shape == k_cache.shape,
          f"cache shapes {tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    L, B, S, H, Dh = k_cache.shape
    _need(tuple(x.shape) == (B, H * Dh), f"x {tuple(x.shape)} is not ({B}, {H * Dh})")
    _need(isinstance(kv_len, torch.Tensor) and tuple(kv_len.shape) == (B,),
          f"kv_len must be a [{B}] tensor")
    dev = x.device
    if dev.type == "cpu":
        _need(bool(((kv_len >= 0) & (kv_len < S)).all()), f"kv_len outside the cache [0, {S})")
        return
    _need(dev.type == "cuda", f"tensors on {dev}: the kernel runs on CUDA, the twin on CPU")
    _need(Dh in HEAD_DIMS, f"head dim {Dh} must be one of {HEAD_DIMS}")
    _need(x.dtype in (torch.bfloat16, torch.float32), f"x dtype {x.dtype}")
    for name, t, dtype, align in (("x", x, x.dtype, 4), ("k_cache", k_cache, torch.bfloat16, 16),
                                  ("v_cache", v_cache, torch.bfloat16, 16),
                                  ("kv_len", kv_len, torch.int32, 4)):
        _need(t.device == dev and t.dtype == dtype and t.is_contiguous()
              and t.data_ptr() % align == 0,
              f"{name} must be a contiguous, {align}-byte aligned {dtype} tensor on {dev}")


def table_for(table, layers, at: int = 0) -> LayerTable:
    """``table`` after checking that its entries ``at`` onwards are the
    dicts of ``layers``, or a new table over ``layers`` when ``table`` is
    None (a one-call table: pass the owner's to avoid building it)."""
    if table is None:
        return LayerTable(layers)
    _need(at + len(layers) <= table.L
          and all(table.kept[at + i] is lp for i, lp in enumerate(layers)),
          "the table was not built over these layers")
    return table


def _k5_args(x, layers, k_cache, v_cache, kv_len, table):
    """Check K5's arguments; on the CPU return None, else the filled argument
    struct with its table and output ``(a, table, out)``."""
    check_hidden_rows(x, k_cache, v_cache, kv_len)
    L, B, S, H, Dh = k_cache.shape
    _need(B == 1, f"batch {B}: this kernel is B=1")
    _need(len(layers) == L, f"{len(layers)} layers for a {L}-layer cache")
    if x.device.type == "cpu":
        return None
    table = table_for(table, layers)
    _need(table.L == L and table.D == H * Dh,
          f"cache width {H * Dh} does not match the weights' {table.D}")
    table.check_persistent(tagged=True)
    out = torch.empty_like(x)
    a = _K5Args()
    a.L, a.D, a.H, a.M, a.S = L, table.D, H, table.M, S
    a.x_f32 = int(x.dtype == torch.float32)
    a.attn_scale = 1.0 / math.sqrt(Dh)
    a.x_in, a.x_out = x.data_ptr(), out.data_ptr()
    a.k_cache, a.v_cache, a.kv_len = k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr()
    table.work(a)
    return a, table, out


def fused_decode_step(x, layers, k_cache, v_cache, kv_len, *, table=None):
    """K5: one token through all layers at B=1, no embedding, head or
    sampling: one launch of the persistent kernel.

    ``x`` [1, D] (bf16 or float32); ``layers`` the list of per-layer dicts
    (``params["layers"]``); ``k_cache``/``v_cache`` [L, 1, S, H, Dh], every
    layer's new K/V row appended in place at row ``kv_len``; ``kv_len`` [1]
    int32 on the tensors' device, never read back; ``table`` the
    :class:`LayerTable` built over ``layers`` (``params["k1_table"]``).
    Returns ``(h [1, D] in x's dtype, k_cache, v_cache)``.
    """
    prepared = _k5_args(x, layers, k_cache, v_cache, kv_len, table)
    if prepared is None:
        return fused_decode_step_ref(x, layers, k_cache, v_cache, kv_len)
    a, table, out = prepared
    table.persistent(a)
    _launch(load_layers_kernels().k5_decode_layers, "K5", a, x.device)
    fused_decode_step.launches += 1
    return out, k_cache, v_cache


#: kernel launches (whole steps) since the last reset, the quantized streams'
#: apart; the twins never count
for _fn in (fused_decode_step_sample, fused_decode_step_sample_batched):
    for _name in _LAUNCHES.values():
        setattr(_fn, _name, 0)
fused_decode_step.launches = 0
