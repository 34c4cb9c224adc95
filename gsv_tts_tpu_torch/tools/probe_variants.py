"""What each design choice of P1 and P2 is worth on the card: named edits of
``csrc/p1_int4_probe.cu`` and ``csrc/p2_mosaic_probe.cu``, each built into a
library of its own beside the package's source, timed in turns in one
process.

    python -m gsv_tts_tpu_torch.tools.probe_variants           # on the card (~2 min, the builds included)
    python -m gsv_tts_tpu_torch.tools.probe_variants --check   # apply the edits only: no card, no nvcc

P1 at the stack shape (``int4_probe.STACK``), its calls turning through four
copies of the page so that each finds its bytes cold in the 50 MB L2;
every variant is checked against the twin, then timed from CUDA graphs of 48
calls in turns (a, b, ..., ..., b, a), three rounds.  Edits of the source:
the second pass launched plainly (no programmatic dependent launch), x
staged a float a thread and row at a time, the epilogue's k-warp sums one
dependent load at a time and stored a float at a time, L2 prefetch of the
stages ahead of the loads (of the ring's copies under ``unpack_dma``),
``__ldg`` and the ``L2::256B`` hint for the loads, the blocks in split-major
order; edits of the plan: the column tiles and blocks an SM of ``unpack``,
the tiles and ring of ``unpack_dma``.  A ``%globaltimer`` build prints P1's
time by part (single cold calls).  P2's ``combined`` with one or two passes,
no exp, no sum tree, the accurate ``expf``, full barriers; beside its
``baseline`` and the empty kernel.  Nothing here is on a user path; no
module of the package imports it.
"""
from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..utils import cuda_build

CSRC = cuda_build.CSRC_DIR

# -- edits of csrc/p1_int4_probe.cu -------------------------------------------------

NO_PDL = [(
    """  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + P1_THREADS - 1) / P1_THREADS, P1_XROWS);
  cfg.blockDim = dim3(P1_THREADS);
  cfg.stream = st;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, p1_sum_splits, (const float*)part, (const float*)scale,
                               (float*)out, N, splits);
  return rc ? rc : (int)cudaGetLastError();""",
    """  p1_sum_splits<<<dim3((N + P1_THREADS - 1) / P1_THREADS, P1_XROWS), P1_THREADS, 0, st>>>(
      (const float*)part, (const float*)scale, (float*)out, N, splits);
  return (int)cudaGetLastError();""")]

X_BY_ROW = [(
    """  for (int k4 = tid; k4 < (rows >> 2); k4 += P1_THREADS) {
    float4 f[P1_XROWS];
#pragma unroll
    for (int r = 0; r < P1_XROWS; ++r)
      f[r] = __ldg(reinterpret_cast<const float4*>(a.x + (size_t)r * a.D + row0) + k4);
    __nv_bfloat16* dst = xs + 4 * (k4 & ~3) + (k4 & 3);
#pragma unroll
    for (int r = 0; r < P1_XROWS; ++r) {
      dst[r * a.xs] = __float2bfloat16_rn(f[r].x);
      dst[r * a.xs + 4] = __float2bfloat16_rn(f[r].y);
      dst[r * a.xs + 8] = __float2bfloat16_rn(f[r].z);
      dst[r * a.xs + 12] = __float2bfloat16_rn(f[r].w);
    }
  }""",
    """  for (int r = 0; r < P1_XROWS; ++r)
    for (int k = tid; k < rows; k += P1_THREADS)
      xs[r * a.xs + (k & ~15) + 4 * (k & 3) + ((k & 15) >> 2)] =
          __float2bfloat16_rn(a.x[(size_t)r * a.D + row0 + k]);""")]

EPILOGUE_CHAIN = [(
    """#pragma unroll 2
  for (int i = 4 * tid; i < P1_XROWS * cw_n * 2 * P1_WARP_BYTES; i += 4 * P1_THREADS) {
    const int p = i & (P1_WARP_BYTES - 1), hl = (i >> 7) & 1, rest = i >> 8;
    const int cwi = rest & (cw_n - 1), r = rest >> a.col_log;
    const float* w = all + cwi * P1_XROWS * P1_PS + r * P1_PS + hl * P1_WARP_BYTES +
                     8 * (p & 15) + (p >> 4);  // column p + c at w + 8c
    float v[P1_WARPS][4];
#pragma unroll
    for (int k = 0; k < P1_WARPS; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[k][c] = k < kw_n ? w[k * cw_n * P1_XROWS * P1_PS + 8 * c] : 0.f;
    float4 sum = make_float4(v[0][0], v[0][1], v[0][2], v[0][3]);
#pragma unroll
    for (int k = 1; k < P1_WARPS; ++k)
      if (k < kw_n) {
        sum.x += v[k][0];
        sum.y += v[k][1];
        sum.z += v[k][2];
        sum.w += v[k][3];
      }
    const int col = c0 + P1_WARP_BYTES * cwi + p + hl * a.half;
    if (a.splits == 1) {
      const float4 sc = *reinterpret_cast<const float4*>(a.scale + col);
      sum = make_float4(sum.x * sc.x, sum.y * sc.y, sum.z * sc.z, sum.w * sc.w);
      *reinterpret_cast<float4*>(a.out + (size_t)r * N + col) = sum;
    } else {
      *reinterpret_cast<float4*>(a.out + ((size_t)split * P1_XROWS + r) * N + col) = sum;
    }
  }""",
    """  for (int i = tid; i < P1_XROWS * cw_n * 2 * P1_WARP_BYTES; i += P1_THREADS) {
    const int p = i & (P1_WARP_BYTES - 1), hl = (i >> 7) & 1, rest = i >> 8;
    const int cwi = rest & (cw_n - 1), r = rest >> a.col_log;
    const int pos = r * P1_PS + hl * P1_WARP_BYTES + 8 * (p & 15) + (p >> 4);
    float sum = 0.f;
    for (int k = 0; k < kw_n; ++k) sum += all[(k * cw_n + cwi) * P1_XROWS * P1_PS + pos];
    const int col = c0 + P1_WARP_BYTES * cwi + p + hl * a.half;
    if (a.splits == 1)
      a.out[(size_t)r * N + col] = sum * a.scale[col];
    else
      a.out[((size_t)split * P1_XROWS + r) * N + col] = sum;
  }""")]

LOAD_LDG = [("      v[i] = __ldcs(reinterpret_cast<const uint4*>(p + (size_t)4 * i * a.half));",
             "      v[i] = __ldg(reinterpret_cast<const uint4*>(p + (size_t)4 * i * a.half));")]

LOAD_L2_256B = [(
    "      v[i] = __ldcs(reinterpret_cast<const uint4*>(p + (size_t)4 * i * a.half));",
    """      asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\\n"
                   : "=r"(v[i].x), "=r"(v[i].y), "=r"(v[i].z), "=r"(v[i].w)
                   : "l"(p + (size_t)4 * i * a.half));""")]

SPLIT_MAJOR = [
    ("""  const int c0 = blockIdx.x * tile;       // the block's first byte column
  const int split = blockIdx.y;""", """  const int c0 = blockIdx.y * tile;       // the block's first byte column
  const int split = blockIdx.x;"""),
    ("  const dim3 grid(half / (P1_WARP_BYTES * col_warps), splits);",
     "  const dim3 grid(splits, half / (P1_WARP_BYTES * col_warps));")]


def l2_prefetch(n: int):
    """Stages ``n`` ahead of the register loads into L2 (``unpack``: one
    ``prefetch.global.L2`` a row's 128 bytes; ``unpack_dma``: a bulk prefetch
    a row, ``n`` stages past the ring)."""
    return [
        ("""  uint4 va[4], vb[4];""", f"""  constexpr int PF = {n};
  uint4 va[4], vb[4];
  auto l2 = [&](int s) {{
    if (lane < 16 && has(s))
      asm volatile("prefetch.global.L2 [%0];\\n" ::"l"(a.packed + (size_t)(row0 + s * sr + 16 * kw + lane) * a.half + c0 + P1_WARP_BYTES * cw));
  }};
  auto l2bulk = [&](int s) {{
    const int r0 = row0 + s * sr, rows = min(sr, row1 - r0);
    if (s < n_st && tid < rows)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\\n" ::"l"(a.packed + (size_t)(r0 + tid) * a.half + c0), "r"(tile) : "memory");
  }};"""),
        ("""    for (int s = 0; s < min(a.ring, n_st); ++s) issue(s, s);""",
         """    for (int s = 0; s < min(a.ring, n_st); ++s) issue(s, s);
    for (int q = a.ring; q < a.ring + PF; ++q) l2bulk(q);"""),
        ("""    load(va, 0);  // in flight while x is staged""",
         """    load(va, 0);  // in flight while x is staged
#pragma unroll
    for (int q = 1; q <= PF; ++q) l2(q);"""),
        ("""      if (s + a.ring < n_st) issue(s + a.ring, k);""",
         """      if (s + a.ring < n_st) issue(s + a.ring, k);
      l2bulk(s + a.ring + PF);"""),
        ("""    for (int s = 0; s < n_st; s += 2) {  // two stages a turn: va, vb in flight in turns
""", """    for (int s = 0; s < n_st; s += 2) {  // two stages a turn: va, vb in flight in turns
      l2(s + 1 + PF);
      l2(s + 2 + PF);
"""),
    ]


# a %globaltimer mark a block: [start, x staged, the last warp's stream done,
# epilogue done, -, SM]; the second pass's start and the end of its wait
TRACE = [
    ("""template <bool DMA>
__global__ void __launch_bounds__(P1_THREADS, 2) p1_kernel""",
     """__device__ unsigned long long p1_trace[4096 * 6];
__device__ unsigned long long p1_sum_trace[2];
static __device__ __forceinline__ unsigned long long p1_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int p1_read_trace(void* blocks, void* sum) {
  cudaMemcpyFromSymbol(sum, p1_sum_trace, sizeof(p1_sum_trace));
  return (int)cudaMemcpyFromSymbol(blocks, p1_trace, sizeof(p1_trace));
}
template <bool DMA>
__global__ void __launch_bounds__(P1_THREADS, 2) p1_kernel"""),
    ("""  const int g = lane >> 2, t = lane & 3;
""", """  const int g = lane >> 2, t = lane & 3;
  unsigned long long* tr = p1_trace + 6 * (blockIdx.y * gridDim.x + blockIdx.x);
  if (tid == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    tr[0] = p1_now();
    tr[2] = 0;
    tr[5] = sm;
  }
"""),
    ("""  float acc[16][4];
#pragma unroll""", """  if (tid == 0) tr[1] = p1_now();
  float acc[16][4];
#pragma unroll"""),
    ("""  asm volatile("griddepcontrol.launch_dependents;\\n");""",
     """  if (lane == 0) atomicMax(tr + 2, p1_now());
  asm volatile("griddepcontrol.launch_dependents;\\n");"""),
    ("""      *reinterpret_cast<float4*>(a.out + ((size_t)split * P1_XROWS + r) * N + col) = sum;
    }
  }
}""", """      *reinterpret_cast<float4*>(a.out + ((size_t)split * P1_XROWS + r) * N + col) = sum;
    }
  }
  __syncthreads();
  if (tid == 0) tr[3] = p1_now();
}"""),
    ("""  asm volatile("griddepcontrol.wait;\\n" ::: "memory");""",
     """  const bool first = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  if (first) p1_sum_trace[0] = p1_now();
  asm volatile("griddepcontrol.wait;\\n" ::: "memory");
  if (first) p1_sum_trace[1] = p1_now();"""),
]

# -- edits of csrc/p2_mosaic_probe.cu -----------------------------------------------

P2_PASSES_1 = [("""  float a00 = 0.f;
  for (int pass = 0; pass < 3; ++pass) {""", """  float a00 = 0.f;
  for (int pass = 0; pass < 1; ++pass) {""")]
P2_PASSES_2 = [("""  float a00 = 0.f;
  for (int pass = 0; pass < 3; ++pass) {""", """  float a00 = 0.f;
  for (int pass = 0; pass < 2; ++pass) {""")]
P2_NO_EXP = [("__expf(", "(", "every")]
P2_EXPF = [("__expf(", "expf(", "every")]
P2_NO_TREE = [("""    s = p2_tree_sum(s);
    if (b == 0) {""", """    if (b == 0) {""")]
P2_FULL_BARRIERS = [
    ("""      if (b == 0) {
        a00 = __shfl_sync(0xffffffffu, acc.x, 0);
      } else {
        asm volatile("bar.sync %0, %1;\\n" ::"r"(pass), "r"(P2_WARPS * 32) : "memory");
        a00 = a00s[pass - 1];
      }""", """      __syncthreads();
      a00 = b == 0 ? __shfl_sync(0xffffffffu, acc.x, 0) : a00s[pass - 1];"""),
    ("""        __threadfence_block();
        asm volatile("bar.arrive %0, %1;\\n" ::"r"(pass + 1), "r"(P2_WARPS * 32) : "memory");
""", ""),
]

#: P1's variants: name -> edits of its source
P1_VARIANTS = {
    "final": [],
    "no pdl": NO_PDL,
    "x by row": X_BY_ROW,
    "epilogue chain": EPILOGUE_CHAIN,
    "ldg": LOAD_LDG,
    "l2 256B": LOAD_L2_256B,
    "split major": SPLIT_MAJOR,
    "l2 prefetch 1": l2_prefetch(1),
    "l2 prefetch 2": l2_prefetch(2),
    "l2 prefetch 4": l2_prefetch(4),
    "trace": TRACE,
}
#: P1 variants that run ``unpack`` only (their edit is in its load path)
UNPACK_ONLY = {"ldg", "l2 256B"}
#: P1's plan edits, on the final source: name -> (variant, its COL_WARPS, its
#: BLOCKS_PER_SM, RING)
PLANS = {"unpack 256 B tiles": ("unpack", (2,), 2, 4),
         "unpack 512 B tiles": ("unpack", (4,), 2, 4),
         "unpack one block an SM": ("unpack", (1,), 1, 4),
         "unpack_dma 512 B tiles": ("unpack_dma", (4, 2, 1), 1, 4),
         "unpack_dma 256 B tiles": ("unpack_dma", (2, 1), 1, 4),
         "unpack_dma 128 B tiles": ("unpack_dma", (1,), 1, 4),
         "unpack_dma ring of 8": ("unpack_dma", (8, 4, 2, 1), 1, 8)}
#: P2's variants of ``combined``: name -> edits of its source; the first
#: three compute another function and are not held to the twin
P2_VARIANTS = {"one pass": P2_PASSES_1, "two passes": P2_PASSES_2, "no exp": P2_NO_EXP,
               "no sum tree": P2_NO_TREE, "expf": P2_EXPF, "full barriers": P2_FULL_BARRIERS,
               "final": []}
P2_OTHER_FUNCTION = {"one pass", "two passes", "no exp", "no sum tree"}


def apply(source: str, edits) -> str:
    """Each edit (old, new) replaces the one place ``old`` stands; (old, new,
    "every") every place, at least one."""
    for old, new, *every in edits:
        count = source.count(old)
        if count == 0 or (count > 1 and not every):
            raise ValueError(f"edit does not apply to the source ({count} places): {old[:80]!r}")
        source = source.replace(old, new)
    return source


def sources() -> dict:
    """("p1" or "p2", name) -> (p1 source, p2 source) of every variant (raises
    if an edit no longer applies to the package's source)."""
    p1 = (CSRC / "p1_int4_probe.cu").read_text()
    p2 = (CSRC / "p2_mosaic_probe.cu").read_text()
    out = {("p1", name): (apply(p1, e), p2) for name, e in P1_VARIANTS.items()}
    out.update({("p2", name): (p1, apply(p2, e)) for name, e in P2_VARIANTS.items()})
    return out


def build(srcs: dict, out: Path) -> dict:
    """One library a variant, one ``nvcc`` each, all started together."""
    flags = [*cuda_build.ARCH_FLAGS, *cuda_build.NVCC_FLAGS, "-I", str(CSRC)]

    def one(item):
        key, (a, b) = item
        stem = "_".join(key).replace(" ", "_")
        fa, fb, so = out / f"p1_{stem}.cu", out / f"p2_{stem}.cu", out / f"lib{stem}.so"
        fa.write_text(a)
        fb.write_text(b)
        r = subprocess.run([cuda_build.find_nvcc(), *flags, "-o", str(so), str(fa), str(fb)],
                           capture_output=True, text=True, timeout=600)
        if r.returncode:
            raise RuntimeError(f"nvcc failed on variant {key}:\n{r.stdout}{r.stderr}")
        lib = ctypes.CDLL(str(so))
        lib.p1_int4_unpack_matmul.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        lib.p2_mosaic_probe.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.p1_int4_unpack_matmul.restype = lib.p2_mosaic_probe.restype = ctypes.c_int
        return key, lib

    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        return dict(pool.map(one, srcs.items()))


def graph_of(fn, n: int):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(n):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    return graph


def graph_turns(graphs: dict, n: int, reps: int = 20) -> dict:
    """Device ms a call of each graph of ``n`` calls, in turns a, b, ..., b, a."""
    ms = dict.fromkeys(graphs, 0.0)
    for name in list(graphs) + list(reversed(graphs)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        graphs[name].replay()
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            graphs[name].replay()
        end.record()
        torch.cuda.synchronize()
        ms[name] += start.elapsed_time(end) / reps / n / 2
    return ms


def rounds(label: str, graphs: dict, n: int, count: int = 3) -> None:
    for i in range(count):
        ms = graph_turns(graphs, n)
        print(f"{label}, round {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in ms.items()),
              flush=True)


def run() -> None:
    from . import empty_launch, int4_probe as p1, load_kernels, mosaic_probe as p2, sm_count

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the variants run on the card (--check applies the "
                           "edits only)")
    dev = torch.device("cuda", torch.cuda.current_device())
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {card.stdout.strip()}", flush=True)
    load_kernels()  # the package's library: the empty kernel
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(sources(), Path(tmp))
    saved = (p1.load_kernels, p2.load_kernels, p1.COL_WARPS, p1.BLOCKS_PER_SM, p1.RING)

    def use(lib, plan_edit=None):
        """Route the wrappers to ``lib``; ``plan_edit`` (variant, COL_WARPS,
        BLOCKS_PER_SM, RING) changes one variant's plan."""
        p1.load_kernels = p2.load_kernels = lambda: lib
        p1.COL_WARPS, p1.BLOCKS_PER_SM, p1.RING = saved[2], saved[3], saved[4]
        if plan_edit is not None:
            v, cws, per_sm, ring = plan_edit
            p1.COL_WARPS = {**saved[2], v: cws}
            p1.BLOCKS_PER_SM = {**saved[3], v: per_sm}
            p1.RING = ring
        p1.plan.cache_clear()

    try:
        d, n = p1.STACK
        x, _, packed, scale = p1.make_inputs(1, d=d, n=n)
        args = [torch.from_numpy(a).to(dev) for a in (x, packed, scale)]
        want = p1.int4_unpack_matmul_plain(*args)
        pages = [args[1]] + [args[1].clone() for _ in range(3)]

        def turning(v):
            page = itertools.cycle(pages)
            return lambda: p1.int4_unpack_matmul(args[0], next(page), args[2], variant=v)

        def checked(label, v):
            got = p1.int4_unpack_matmul(*args, variant=v)
            err = float((got - want).abs().max()) / float(want.abs().max())
            if not err <= p1.REL_TOL:
                raise RuntimeError(f"P1 {label} {v}: error {err:.2e} against the twin")
            return graph_of(turning(v), 48)

        for v in p1.VARIANTS:
            graphs = {}
            for name in P1_VARIANTS:
                if name != "trace" and (v == "unpack" or name not in UNPACK_ONLY):
                    use(libs[("p1", name)])
                    graphs[name] = checked(name, v)
            for name, edit in PLANS.items():
                if edit[0] == v:
                    use(libs[("p1", "final")], edit)
                    graphs[name] = checked(name, v)
            rounds(f"P1 {v} at D={d}, N={n}, device ms a call", graphs, 48)
        lib = libs[("p1", "trace")]
        use(lib)
        lib.p1_read_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        for v in p1.VARIANTS:
            plan = p1.plan(d, n // 2, v, sm_count(dev))
            for i in range(3):
                blocks, tail = np.zeros(4096 * 6, np.uint64), np.zeros(2, np.uint64)
                torch.cuda.synchronize()
                p1.int4_unpack_matmul(args[0], pages[i + 1], args[2], variant=v)
                torch.cuda.synchronize()
                lib.p1_read_trace(blocks.ctypes.data, tail.ctypes.data)
                b = blocks[: 6 * plan.blocks].reshape(-1, 6).astype(np.int64)
                t0 = b[:, 0].min()
                rel = (b[:, :4] - t0) / 1000.0
                part = {"x staging": rel[:, 1] - rel[:, 0], "stream": rel[:, 2] - rel[:, 1],
                        "epilogue": rel[:, 3] - rel[:, 2]}
                print(f"P1 {v} by part (us, one cold call, {plan.blocks} blocks on "
                      f"{len(set(b[:, 5].tolist()))} SMs): "
                      + ", ".join(f"{k} mean {t.mean():.2f} max {t.max():.2f}"
                                  for k, t in part.items())
                      + f"; last block done {rel[:, 3].max():.2f}; the second pass starts "
                      f"{(int(tail[0]) - t0) / 1000:.2f}, past its wait "
                      f"{(int(tail[1]) - t0) / 1000:.2f}", flush=True)
        del args, pages, want

        xm = torch.from_numpy(p2.make_input(2)).to(dev)
        graphs = {}
        for name in P2_VARIANTS:
            use(libs[("p2", name)])
            got, ref = p2.mosaic_reduce(xm, "combined"), p2.mosaic_reduce_plain(xm, "combined")
            err = float(((got - ref).abs() / ref.abs().clamp_min(1.0)).max())
            if name not in P2_OTHER_FUNCTION and not err <= p2.REL_TOL:
                raise RuntimeError(f"P2 combined, {name}: error {err:.2e} against the twin")
            graphs[f"combined, {name}"] = graph_of(lambda: p2.mosaic_reduce(xm, "combined"), 50)
        graphs["baseline"] = graph_of(lambda: p2.mosaic_reduce(xm, "baseline"), 50)
        graphs["the empty kernel"] = graph_of(lambda: empty_launch(dev), 50)
        rounds("P2 device ms a call", graphs, 50)
    finally:
        p1.load_kernels, p2.load_kernels, p1.COL_WARPS, p1.BLOCKS_PER_SM, p1.RING = saved
        p1.plan.cache_clear()


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args == ["--check"]:
        print(f"{len(sources())} variants apply to the source", flush=True)
        return 0
    if args:
        raise SystemExit("usage: python -m gsv_tts_tpu_torch.tools.probe_variants [--check]")
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
