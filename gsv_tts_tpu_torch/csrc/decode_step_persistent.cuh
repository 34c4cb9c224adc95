// The t2s decode layers as ONE persistent cooperative kernel on Hopper
// (sm_90a), for up to NB rows.  One kernel body serves three entries:
//   * the whole step (StepArgs::x_in == nullptr): embedding -> L post-norm
//     layers -> logits head; k1_decode_step.cu instantiates it at NB = 1
//     (K1), k2_decode_step_batched.cu at NB = 2, 4 and 8 (K2; a wave of 3
//     runs as 4 with a dead row that touches nothing).  The sampling chain
//     stays a second launch (decode_common.cuh: sample_row is written for one
//     block of 1024 threads; this kernel runs 512 a block so that a thread
//     may keep 128 registers, and one launch boundary costs less than the
//     sort at half the threads would);
//   * a layer stack (x_in given): the rows of x_in -> the L layers of the
//     table -> the last LayerNorm's rows into x_out, in x_in's type; no
//     embedding, no head.  k5_decode_layers.cu runs all L layers at one row
//     (K5), k6_decode_layer.cu one layer (a one-entry table and that layer's
//     cache slab) for groups of up to 8 rows (K6, NB = 1, 2, 4, 8).
//
// Replaces the model half of the TPU kernels
// gsv_tts_tpu/ops/fused_step.py:_kernel_sample and :_kernel_sample_b, and
// the whole of :_kernel (K5) and gsv_tts_tpu/ops/fused_layer.py:_kernel
// (K6): one launch with the next layer's weights in flight while the current
// layer computes (their double-buffered make_async_copy of w_packed_ref).
//
// What bounds a step on this card: bytes.  2*L*(4*D*D + 2*D*M) + 2*V*D bytes
// of bf16 weights (152 MB at L=24, D=512, M=2048, V=1025) cross device
// memory once per step whatever the number of rows, plus each row's attended
// cache rows.  The chain of 195 launches this replaces took as long as the
// host needed to issue it, and its kernels, each paying its own ramp-up and
// tail with a few KB in flight, kept the memory at a tenth of its rate.
// What this design does about it:
//
// * One launch.  cudaLaunchCooperativeKernel with one resident block per SM
//   (the weight ring below takes more than half of an SM's shared memory, so
//   one is what fits; the host side checks it).  A layer is five phases,
//     QKV product | attention (+ the K/V append) | out-proj + residual |
//     MLP-1 (ReLU) | MLP-2 + residual,
//   and what one writes every block reads in the next.
// * The weight stream never stops.  A block's share of a weight matrix
//   [N, K] is a run of whole rows, contiguous in memory, so a tile of rows
//   is ONE 1-D bulk asynchronous copy (cp.async.bulk, completion counted in
//   bytes on an mbarrier in shared memory; no tensor map).  Every block
//   walks the same fixed list of tiles -- layer by layer, product by
//   product, then the head if the entry has one -- through a ring of
//   PS_STAGES stages of PS_STAGE_BYTES.  One thread issues the copy of tile
//   t + PS_STAGES as soon as tile t has been consumed; the weights do not
//   depend on the activations, so the ring (128 KB a block, 17 MB over the card: two
//   layers ahead) keeps filling while the block computes another phase or
//   waits for one.  No product ever waits for its weights.
// * The hand-over between phases (PsHandOver).  A phase lasts a microsecond
//   or two, so a step's time is the number of DEPENDENT trips to L2 on its
//   path (0.3-0.5 us each) and the instructions between them, not bytes.
//   - A wave (NB > 1): a grid-wide barrier, a 64-bit counter that only grows
//     (ps_grid_barrier).  1.03-1.16 us each in a loop of empty barriers on an
//     NVIDIA H100 80GB HBM3 at 700 W, 1.2-1.7 us inside a step, where blocks
//     arrive apart; the fastest of seven variants tried, and the same for 16
//     blocks as for 132: it is the two trips (the arrival behind its fence,
//     then the poll), not contention.  Then the next phase loads its input:
//     a third trip.
//   - One row (NB = 1): no barrier.  Every value a phase hands on is stored
//     as one 8-byte word with the tag of the launch and layer that wrote it
//     (PsTagged), and the reader asks for all its values at once and takes
//     those whose tag has come -- one trip when they are there -- waiting
//     only for the late ones.  No fence, no count.  The data a row hands on
//     is 4-16 KB a phase; for a wave the doubled words, and the readers'
//     polling of values that have not come, cost more than the barrier
//     (measured: B=4 0.89 ms against 0.71, B=8 1.35 against 0.87).
//     Without a barrier, what keeps a buffer's next writer (a layer later)
//     behind its last reader: a block enters a phase only when EVERY block
//     with rows in the phase before has written them, and every block has
//     rows in the QKV and MLP-1 products (3 D >= grid, M >= grid: checked on
//     the host), so nobody is ever more than one of those products ahead of
//     anybody.
// * LayerNorm costs no launch and no phase: the producing product writes
//   the pre-norm sums, and every block normalises the rows itself (a row is
//   D floats) while it stages them to bf16 in shared memory for the next
//   product.  The normalised rows stay in shared memory in float32 as the
//   residual of the product after next; block 0 also writes the last
//   layer's to StepArgs::x (a whole step) or x_out (a layer stack, where
//   no other block needs them).
// * All SMs on every product: rows are dealt over the whole grid, and where
//   a block holds fewer rows than warps (out-proj, MLP-2, the head) a row's
//   K is split over several warps whose partial sums are added through
//   shared memory in a fixed order (no float atomics: equal inputs give
//   equal tokens from run to run).
// * Attention: one block per (slot, head) walks the slot's rows with all its
//   warps and merges inside the block (ps_attn_phase), so the merge of the
//   first design's 64-row splits costs no pass through L2 and no phase.
// * What does not depend on the activations -- biases, LayerNorm scales --
//   is requested a phase ahead; the block's row ranges and tile shapes are
//   worked out once (PsPlan), not with integer divisions in every phase; and
//   the pieces of the kernel are separate functions shared by the five
//   products and three LayerNorms of a layer instead of 244 KB of inlined
//   code that misses the instruction cache.
// * No early return: a persistent block must reach every phase.  A bad
//   value sets its ERR_* bit and gives NaN (last_tok, positional index) or
//   no append and NaN (kv_len), never a clamp.  No wait spins for ever: see
//   PS_SPIN_LIMIT.
//
// Activations cross from block to block through global memory (L2): every
// read of a buffer the kernel itself writes (pre, h, qkv, attn, mlp) goes to
// L2 (ld.global.cg or a relaxed gpu-scope load), never through the read-only
// path, and a barrier's arrival follows a __threadfence().
//
// Precision as in the first design: bf16 weights and caches, activations rounded to
// bf16 only where they enter a product, float32 accumulation, LayerNorm and
// attention.
//
// The quantized weight streams (template argument WQ: 0 bf16, 1 int8, 2
// int4; the whole step only, k1/k2 *_quant entries) replace the int8 / int4
// pages of the TPU kernels' quant / quant4 modes (_kernel_sample and
// _kernel_sample_b, gsv_tts_tpu/ops/fused_step.py:486-522, :589-607,
// :1154-1189, :1323-1344).  The four layer matrices stream as int8 values,
// or as int4 values two to a byte (element 2i in the low nibble, 2i + 1 in
// the high one, along K), with one float32 scale per lane; the head stays
// bf16.  A stage then holds two or four times the rows (PsPlan::row_bytes),
// which cuts the bytes a step reads by the same factor on the layers.  A
// lane still takes 8 weights a chunk (8 or 4 bytes from shared memory
// instead of 16), so the chunking and split-K are the bf16 kernel's.  The
// chain is the TPU kernel's: qkv = (x q) s + b, h = x + (a q) s + b,
// m1 = relu((h q) s + b) s_m2 in float32 (mlp2's lane is its contracted
// channel, so its scale moves onto the activation, in the MLP-1 epilogue,
// before the bf16 rounding of the staging), h2 = h + m1 q + b.  The scales
// are requested a phase ahead with the biases (PsEpi).
#pragma once
#include "bulk_copy.cuh"
#include "decode_common.cuh"

constexpr int PS_THREADS = 512;
constexpr int PS_WARPS = PS_THREADS / 32;
constexpr int PS_LOADER = PS_THREADS - 1;  // issues the bulk copies: it has no epilogue rows
constexpr int PS_STAGES = 8;
constexpr int PS_STAGE_BYTES = 16384;
constexpr int PS_MAX_TILE_ROWS = 64;  // bounds the partial sums a tile leaves
constexpr int PS_ATTN_FLOATS = 2 * PS_WARPS + PS_WARPS * 128;  // the attention's merge scratch

// A float32 value (x) and the tag of the launch and layer that wrote it (y),
// always stored and loaded as ONE aligned 64-bit word, which no reader sees
// half-written: what is read with the expected tag is the value.  (The
// flag-beside-the-data hand-over of collective libraries' low-latency
// protocols, here between the phases of one kernel.)
typedef uint2 PsTagged;

// How a phase's output reaches the phase that reads it (see the top).
template <int NB>
struct PsHandOver {
  static constexpr bool TAGGED = NB == 1;
};

// A quantized layer's per-lane float32 scales: [3D] | [D] | [M] (rows of
// qkv, out, mlp1) | [M] (columns of mlp2).
struct PsQuantScales {
  const float* qkv;
  const float* out;
  const float* mlp1;
  const float* mlp2;
};

struct StepArgs {
  int B, L, D, H, M, V, S, P;
  float alpha, attn_scale;
  const bf16* audio_emb;  // [V, D]
  const float* pe;        // [P, D]
  const bf16* predict_w;  // [V, D]
  bf16* k_cache;          // [L, B, S, D]
  bf16* v_cache;
  // per-row counters on the device ([B]); K1 gives kv_len = nullptr and its
  // host ints kv_i / pe_i instead
  const int* kv_len;
  const int* x_len;
  const int* last_tok;  // [B]
  int kv_i, pe_i;
  const LayerWeights* layers;  // [L], on the device
  float* x;     // [B, D]  the last layer's normalised rows (out)
  // what one phase hands to the next: PsTagged at one row, float above
  void* h;     // [B, D]  pre-norm sums of the out-proj
  void* pre;   // [B, D]  pre-norm sums of MLP-2
  void* qkv;   // [B, 3D]
  void* attn;  // [B, D]
  void* mlp;   // [B, M]
  float* trace;    // a traced build's clock marks (PS_TRACE_BYTES)
  float* row_out;  // [B, V] logits
  int* err;
  unsigned epoch;           // one row: this launch's number on its workspace, in [1, 2^24)
  unsigned long long* bar;  // a wave: the grid barrier's counter
  // A layer stack (K5, K6) gives x_in: the first layer's rows ([B, D], float32
  // when x_f32, else bf16; post-norm, so they are also its residual), and the
  // last LayerNorm's rows go to x_out in the same type.  There is then no
  // embedding and no head: audio_emb, pe, predict_w, x_len, last_tok, x and
  // row_out are not read.  nullptr: the whole step.
  const void* x_in;
  void* x_out;
  int x_f32;
  // A quantized stream (WQ > 0): ``layers`` points the four matrices at the
  // int8 / int4 pages, and these are their scales ([L], on the device).
  const PsQuantScales* scales;
};

// The products on the tile list: four a layer, and the head after them when
// the entry has one.  The list ends there, so that every bulk copy a block
// issues is one it consumes before it exits.
static __host__ __device__ __forceinline__ int ps_products(const StepArgs& a) {
  return 4 * a.L + (a.x_in == nullptr ? 1 : 0);
}

// A block's share of one product shape (see "The weight stream" below).
struct PsPlan {
  int N, K;
  int r0, r1;     // the block's rows
  int row_bytes;  // of a weight row: 2 K (bf16), K (int8), K / 2 (int4)
  int tile_rows;  // rows a ring stage holds
  int nch;        // ceil(K / 256): warp steps of 8 weights a lane over a row
};

// Shared-memory layout (bytes from the dynamic base), the same on both sides.
struct PsLayout {
  size_t full, stream, plan, layers, scales, psum, stats, gb, resid, scratch, total;
};

static __host__ __device__ inline PsLayout ps_layout(int NB, int L, int D, int M) {
  PsLayout o;
  size_t at = (size_t)PS_STAGES * PS_STAGE_BYTES;  // the ring is at 0
  o.full = at;
  at += sizeof(unsigned long long) * PS_STAGES;
  o.stream = at;
  at += 16;  // PsStream
  o.plan = at;
  at += (sizeof(PsPlan) * 5 + 15) / 16 * 16;
  o.layers = at;
  at += sizeof(LayerWeights) * (size_t)L;
  o.scales = at;  // (read by the quantized streams only)
  at += sizeof(PsQuantScales) * (size_t)L;
  o.psum = at;
  at += sizeof(float) * 2 * PS_MAX_TILE_ROWS * NB;
  o.stats = at;
  at += sizeof(float) * 2 * NB;
  at = (at + 15) / 16 * 16;
  o.gb = at;
  at += sizeof(float) * 2 * (size_t)D;
  o.resid = at;
  at += sizeof(float) * (size_t)NB * D;
  o.scratch = at;
  const size_t act = sizeof(bf16) * (size_t)NB * (D > M ? D : M);
  const size_t grp = sizeof(float) * PS_ATTN_FLOATS;
  at += act > grp ? act : grp;
  o.total = at;
  return o;
}

// ---------------------------------------------------------------------------
// Waiting: for a bulk copy (mbarrier), for a tagged value, for the grid
// ---------------------------------------------------------------------------
// A wait that does not end within PS_SPIN_LIMIT polls (seconds; a step takes
// well under a millisecond) gives up instead of hanging the card: it sets
// ERR_SYNC, which the host raises on at its next check, and marks the block
// dead, after which the block's later waits fall through at once (the step's
// results are garbage by then; what matters is that the launch ends).
constexpr unsigned PS_SPIN_LIMIT = 1u << 22;
extern __shared__ __align__(128) unsigned char ps_smem[];

static __device__ __forceinline__ int* ps_dead() {  // PsStream::dead, at PsLayout::stream
  return reinterpret_cast<int*>(ps_smem + (size_t)PS_STAGES * PS_STAGE_BYTES + 8 * PS_STAGES + 12);
}

// Called on a failed poll: whether to give up (every 1024th poll looks).
static __device__ __noinline__ bool ps_give_up(unsigned spins, int* err) {
  if (spins < PS_SPIN_LIMIT && !*reinterpret_cast<volatile int*>(ps_dead())) return false;
  *reinterpret_cast<volatile int*>(ps_dead()) = 1;
  atomicOr(err, ERR_SYNC);
  return true;
}

static __device__ __forceinline__ void ps_mbar_wait(unsigned long long* bar, uint32_t parity,
                                                    int* err) {
  const uint32_t addr = smem_u32(bar);
  unsigned spins = 0;
  while (!mbar_test(addr, parity) && !((++spins & 1023u) == 0 && ps_give_up(spins, err))) {
  }
}

// A value for the phase that waits for it / the value once its tag has come
// (polled in L2, never through L1).
static __device__ __forceinline__ void ps_put(PsTagged* p, float v, unsigned tag) {
  *reinterpret_cast<unsigned long long*>(p) =
      ((unsigned long long)tag << 32) | __float_as_uint(v);
}

static __device__ __forceinline__ float ps_take(const PsTagged* p, unsigned tag, int* err) {
  unsigned long long w;
  unsigned spins = 0;
  do {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(w) : "l"(p) : "memory");
  } while ((unsigned)(w >> 32) != tag && !((++spins & 1023u) == 0 && ps_give_up(spins, err)));
  return __uint_as_float((unsigned)w);
}

// Two neighbouring values (p 16-byte aligned) in one load, without a wait;
// ps_take_pair then takes them if both had come and waits for them if not.
// A loop that needs many values asks for all of them first and waits only
// for the late ones, so that it pays one trip to L2, not one a value.
static __device__ __forceinline__ uint4 ps_peek_pair(const PsTagged* p) {
  unsigned long long a, b;  // two 64-bit elements: each whole
  asm volatile("ld.volatile.global.v2.u64 {%0, %1}, [%2];\n" : "=l"(a), "=l"(b) : "l"(p) : "memory");
  return make_uint4((unsigned)a, (unsigned)(a >> 32), (unsigned)b, (unsigned)(b >> 32));
}

static __device__ __forceinline__ float2 ps_take_pair(const uint4& w, const PsTagged* p,
                                                      unsigned tag, int* err) {
  if (w.y == tag && w.w == tag) return make_float2(__uint_as_float(w.x), __uint_as_float(w.z));
  return make_float2(ps_take(p, tag, err), ps_take(p + 1, tag, err));
}

// f(i, v) for every pair i < n_pairs of values 2 i, 2 i + 1 of ``src``, dealt
// over the block's threads, U pairs a thread in flight.
template <int U, class F>
static __device__ __forceinline__ void ps_take_all(const PsTagged* src, int n_pairs, unsigned tag,
                                                   int* err, F f) {
#pragma unroll 1
  for (int i0 = threadIdx.x; i0 < n_pairs; i0 += U * PS_THREADS) {
    uint4 w[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i0 + u * PS_THREADS < n_pairs) w[u] = ps_peek_pair(src + 2 * (i0 + u * PS_THREADS));
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * PS_THREADS;
      if (i < n_pairs) f(i, ps_take_pair(w[u], src + 2 * i, tag, err));
    }
  }
}

// All blocks of the grid meet here (a wave's hand-over; ps_barrier_loop
// measures it).  A 64-bit counter that only grows: arrival is one
// fire-and-forget atomic add behind a fence, release is the counter reaching
// ``target``, the next multiple of the grid size, so a block polls the word
// it added to and nothing is reset.  The caller adds gridDim.x per barrier.
static __device__ __noinline__ void ps_grid_barrier(unsigned long long* ctr,
                                                    unsigned long long& target, int* err) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;\n" :: "l"(ctr), "l"(1ULL) : "memory");
    unsigned long long v;
    unsigned spins = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(ctr) : "memory");
    } while (v < target && !((++spins & 1023u) == 0 && ps_give_up(spins, err)));
  }
  __syncthreads();
  target += gridDim.x;
}

// The counter's value once all blocks have arrived at this launch's first
// barrier: it is a multiple of the grid size between launches, and until this
// block arrives at most gridDim.x - 1 others have added to it.
static __device__ __forceinline__ unsigned long long ps_first_target(unsigned long long* ctr,
                                                                     unsigned long long* s_word) {
  if (threadIdx.x == 0) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(ctr) : "memory");
    *s_word = v / gridDim.x * gridDim.x + gridDim.x;
  }
  __syncthreads();
  const unsigned long long t = *s_word;
  __syncthreads();
  return t;
}

// ---------------------------------------------------------------------------
// The weight stream: the block's tiles in the order every block consumes
// them.  Product p of ps_products(a): layer p / 4's qkv, out, mlp1, mlp2;
// a whole step's last is the head.  A block's rows of a product [N, K] are
// [N bid / G, N (bid + 1) / G), taken PsPlan::tile_rows at a time.  The five
// shapes' plans are worked out once, at the kernel's start (integer
// divisions are slow enough to show in a phase of two microseconds).  Under
// a quantized stream (wq 1 int8, 2 int4) a layer's row is K or K / 2 bytes,
// the head's stays bf16.
// ---------------------------------------------------------------------------
static __device__ __forceinline__ int ps_kind(const StepArgs& a, int p) {
  return p >= 4 * a.L ? 4 : p & 3;  // qkv, out, mlp1, mlp2, head
}

static __device__ void ps_make_plan(const StepArgs& a, PsPlan* plan, int kind, int wq) {
  const int N = kind == 0 ? 3 * a.D : kind == 2 ? a.M : kind == 4 ? a.V : a.D;
  const int K = kind == 3 ? a.M : a.D;
  const int fmt = kind == 4 ? 0 : wq;
  PsPlan& o = plan[kind];
  o.N = N;
  o.K = K;
  o.r0 = (int)((unsigned)N * blockIdx.x / gridDim.x);  // (N <= 3 * 8192: a row fits a stage)
  o.r1 = (int)((unsigned)N * (blockIdx.x + 1) / gridDim.x);
  o.row_bytes = fmt == 0 ? 2 * K : fmt == 1 ? K : K / 2;
  o.tile_rows = min(PS_MAX_TILE_ROWS, PS_STAGE_BYTES / o.row_bytes);
  o.nch = (K + 255) >> 8;
}

static __device__ __forceinline__ const unsigned char* ps_weights(const StepArgs& a,
                                                                  const LayerWeights* lw, int p) {
  const void* w;
  if (p >= 4 * a.L) {
    w = a.predict_w;
  } else {
    const LayerWeights& l = lw[p >> 2];
    switch (p & 3) {
      case 0: w = l.qkv_w; break;
      case 1: w = l.out_w; break;
      case 2: w = l.mlp1_w; break;
      default: w = l.mlp2_w; break;
    }
  }
  return static_cast<const unsigned char*>(w);
}

// Weights k .. k + 7 of a row in shared memory (k a multiple of 8) as float:
// bf16 (16 bytes), int8 (8 bytes) or int4 (4 bytes, element k + j in nibble
// j).  Every int8 and int4 value is exact in float.
template <int WQ>
static __device__ __forceinline__ void ps_weights8(const unsigned char* row, int k,
                                                   float (&f)[8]) {
  if (WQ == 0) {
    bf16x8_to_float(*reinterpret_cast<const uint4*>(row + 2 * k), f);
  } else if (WQ == 1) {
    const uint2 r = *reinterpret_cast<const uint2*>(row + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      f[j] = (float)((int)(r.x << (24 - 8 * j)) >> 24);
      f[4 + j] = (float)((int)(r.y << (24 - 8 * j)) >> 24);
    }
  } else {
    const unsigned r = *reinterpret_cast<const unsigned*>(row + k / 2);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] = (float)((int)(r << (28 - 4 * j)) >> 28);
  }
}

struct PsStream {  // the issuing thread's cursor over the tile list
  int p, row, issued;
  int dead;  // (not the cursor's: the block's flag of ps_dead(), in the same 16 bytes)

  // Issue copies until the ring is full or the list ends.
  __device__ __noinline__ void fill(const StepArgs& a, const LayerWeights* lw,
                                    const PsPlan* plan, unsigned char* ring,
                                    unsigned long long* full, int consumed) {
    while (issued - consumed < PS_STAGES && p < ps_products(a)) {
      const PsPlan& pl = plan[ps_kind(a, p)];
      if (row < pl.r0) row = pl.r0;
      if (row >= pl.r1) {  // this product is done (or the block has no row of it)
        ++p;
        row = 0;
        continue;
      }
      const int rows = min(pl.tile_rows, pl.r1 - row);
      const int stage = issued % PS_STAGES;
      bulk_load(ring + (size_t)stage * PS_STAGE_BYTES,
                ps_weights(a, lw, p) + (size_t)row * pl.row_bytes,
                (uint32_t)rows * pl.row_bytes, full + stage);
      ++issued;
      row += rows;
    }
  }
};

// The views of a block's shared memory (ps_layout).  The kernel's pieces are
// separate functions, not inlined: a step runs each of them once a layer, and
// only code that is shared between the five products, the three LayerNorms
// and the barriers stays in the instruction cache (inlined, the kernel was
// 244 KB of code and waited for instructions more than for data).
template <int NB>
struct PsBlock {
  unsigned char* ring;
  unsigned long long* full;
  PsStream* stream;  // the issuing thread's
  PsPlan* plan;      // [5] by product shape
  LayerWeights* lw;  // the layer table
  PsQuantScales* qs;  // a quantized stream's scale table
  float* psum;       // [2][PS_MAX_TILE_ROWS * NB]
  float* stats;      // [NB][2] mean, 1 / std
  float* gb;         // [2][D] the next LayerNorm's scale and shift
  float* resid;      // [NB][D] float32 rows: the residual
  bf16* act;         // [NB][K] the product's input rows
  float* scratch;    // the attention's merge scratch (aliases act)
};

template <int NB>
static __device__ __forceinline__ PsBlock<NB> ps_block(const StepArgs& a) {
  const PsLayout lay = ps_layout(NB, a.L, a.D, a.M);
  PsBlock<NB> s;
  s.ring = ps_smem;
  s.full = reinterpret_cast<unsigned long long*>(ps_smem + lay.full);
  s.stream = reinterpret_cast<PsStream*>(ps_smem + lay.stream);
  s.plan = reinterpret_cast<PsPlan*>(ps_smem + lay.plan);
  s.lw = reinterpret_cast<LayerWeights*>(ps_smem + lay.layers);
  s.qs = reinterpret_cast<PsQuantScales*>(ps_smem + lay.scales);
  s.psum = reinterpret_cast<float*>(ps_smem + lay.psum);
  s.stats = reinterpret_cast<float*>(ps_smem + lay.stats);
  s.gb = reinterpret_cast<float*>(ps_smem + lay.gb);
  s.resid = reinterpret_cast<float*>(ps_smem + lay.resid);
  s.act = reinterpret_cast<bf16*>(ps_smem + lay.scratch);
  s.scratch = reinterpret_cast<float*>(ps_smem + lay.scratch);
  return s;
}

// What this thread's epilogue entry of a tile adds: the bias (0 where there
// is none), the row's scale (1 where there is none) and the scale after the
// ReLU (MLP-1 of a quantized stream: mlp2's column scale; else 1).
struct PsEpi {
  float bias, scale, post;
};

// Epilogue entry t is (row t / NB, slot t % NB) of the tile at row ``n0``.
template <int NB>
static __device__ __forceinline__ PsEpi ps_epi_at(int n0, int R, const bf16* bias,
                                                  const float* scale, const float* post) {
  const int row = threadIdx.x / NB;
  PsEpi e = {0.f, 1.f, 1.f};
  if (row < R) {
    if (bias != nullptr) e.bias = __bfloat162float(bias[n0 + row]);
    if (scale != nullptr) e.scale = __ldg(scale + n0 + row);
    if (post != nullptr) e.post = __ldg(post + n0 + row);
  }
  return e;
}

// The first tile's entry: requested a phase ahead, so that its way from
// device memory hides.
template <int NB>
static __device__ __forceinline__ PsEpi ps_epi_first(const StepArgs& a, int p, const bf16* bias,
                                                     const float* scale = nullptr,
                                                     const float* post = nullptr) {
  const PsPlan& pl = ps_block<NB>(a).plan[ps_kind(a, p)];
  return ps_epi_at<NB>(pl.r0, min(pl.tile_rows, pl.r1 - pl.r0), bias, scale, post);
}

// ---------------------------------------------------------------------------
// y[b, n] = (res[b, n] +) scale[n] sum_k act[b, k] W[n, k] (+ bias[n]) (relu)
// (* post[n]) for the block's rows n of product p, b < B, streaming W (in
// format WQ) from the ring.  The residual is s.resid ([NB][N], shared
// memory); the result goes to global memory ([B][N]): into ``y`` for the
// next phase (under ``tag`` at one row), or, for the head, into
// ``y_plain``.  ``first`` is the first tile's epilogue entry (ps_epi_first).
// ``consumed`` counts the tiles the block has consumed so far (the same in
// every thread); the new count is returned.
// ---------------------------------------------------------------------------
template <int NB, int WQ>
static __device__ __noinline__ int ps_product_rows(const StepArgs& a, int p, const bf16* bias,
                                                   const float* scale, const float* post,
                                                   PsEpi first, bool residual, void* y,
                                                   unsigned tag, float* y_plain, bool relu,
                                                   int consumed) {
  static_assert(PS_MAX_TILE_ROWS * NB <= PS_THREADS, "one epilogue entry a thread");
  const PsBlock<NB> s = ps_block<NB>(a);
  const PsPlan pl = s.plan[ps_kind(a, p)];
  const int N = pl.N, K = pl.K, r0 = pl.r0, r1 = pl.r1, tile_rows = pl.tile_rows, nch = pl.nch;
  const int row_bytes = pl.row_bytes;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = threadIdx.x;
  const int e_row = t / NB, e_b = t % NB;  // this thread's epilogue entry
#pragma unroll 1
  for (int n0 = r0; n0 < r1; n0 += tile_rows) {
    const int R = min(tile_rows, r1 - n0);
    // a row's K over KS = 2^ks_shift warps where the tile has fewer rows than
    // the block warps
    int ks_shift = 0;
    while ((R << (ks_shift + 1)) <= PS_WARPS && (2 << ks_shift) <= nch) ++ks_shift;
    const int KS = 1 << ks_shift;
    const int cps = (nch + KS - 1) >> ks_shift;
    const int stage = consumed % PS_STAGES;
    float* psum = s.psum + (consumed & 1) * PS_MAX_TILE_ROWS * NB;
    // the epilogue's bias and scales: the first tile's came with the call, a
    // later tile's are requested before the wait for the tile
    const PsEpi ep = n0 == r0 ? first : ps_epi_at<NB>(n0, R, bias, scale, post);
    ps_mbar_wait(s.full + stage, (consumed / PS_STAGES) & 1, a.err);
    const unsigned char* tile = s.ring + (size_t)stage * PS_STAGE_BYTES;
#pragma unroll 1
    for (int u = warp; u < R * KS; u += PS_WARPS) {
      const int row = u >> ks_shift, ks = u & (KS - 1);
      const unsigned char* w = tile + (size_t)row * row_bytes;
      float acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0.f;
      const int c1 = min(nch, (ks + 1) * cps);
#pragma unroll 1
      for (int c = ks * cps; c < c1; ++c) {
        const int k = (c << 8) + lane * 8;
        if (k < K) {
          float wf[8];
          ps_weights8<WQ>(w, k, wf);
#pragma unroll
          for (int b = 0; b < NB; ++b) {
            float xf[8];
            bf16x8_to_float(*reinterpret_cast<const uint4*>(s.act + (size_t)b * K + k), xf);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[b] = fmaf(wf[j], xf[j], acc[b]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = warp_sum(acc[b]);
      if (lane == 0) {
#pragma unroll
        for (int b = 0; b < NB; ++b) psum[u * NB + b] = acc[b];
      }
    }
    __syncthreads();  // the partial sums are in; the stage is free
    ++consumed;
    if (t == PS_LOADER) s.stream->fill(a, s.lw, s.plan, s.ring, s.full, consumed);
    if (e_row < R && e_b < a.B) {
      const int n = n0 + e_row;
      float v = 0.f;
      for (int ks = 0; ks < KS; ++ks) v += psum[((e_row << ks_shift) + ks) * NB + e_b];
      if (WQ != 0) v *= ep.scale;  // before the residual and the bias
      if (residual) v = s.resid[(size_t)e_b * N + n] + v;
      if (bias != nullptr) v += ep.bias;
      if (relu) v = fmaxf(v, 0.f);
      if (WQ != 0) v *= ep.post;
      if (y == nullptr)
        y_plain[(size_t)e_b * N + n] = v;
      else if (PsHandOver<NB>::TAGGED)
        ps_put(static_cast<PsTagged*>(y) + (size_t)e_b * N + n, v, tag);
      else
        static_cast<float*>(y)[(size_t)e_b * N + n] = v;
    }
    // (the next tile writes the other half of psum; the one after that comes
    // after the next tile's __syncthreads)
  }
  return consumed;
}

// ---------------------------------------------------------------------------
// Staging: the product's input rows into s.act (bf16) and, where they are a
// later residual, s.resid (float32).  Each ends with a __syncthreads().
// ---------------------------------------------------------------------------

// x[b] = float(bf16(audio_emb[last_tok[b]]) + bf16(alpha * pe[pe_idx[b]]))
template <int NB>
static __device__ __noinline__ void ps_stage_embed(const StepArgs& a) {
  const PsBlock<NB> s = ps_block<NB>(a);
  const int D = a.D;
  for (int b = 0; b < a.B; ++b)
  for (int d = threadIdx.x; d < D; d += PS_THREADS) {
    const int i = b * D + d;
    const int t = a.last_tok[b];
    const int pe_idx = a.kv_len != nullptr ? max(a.kv_len[b] - a.x_len[b], 0) : a.pe_i;
    const int kv = a.kv_len != nullptr ? a.kv_len[b] : a.kv_i;
    const bool tok_ok = t >= 0 && t < a.V, pe_ok = pe_idx >= 0 && pe_idx < a.P;
    if (d == 0 && blockIdx.x == 0) {  // bounds-checked, never clamped
      const int bits = (tok_ok ? 0 : ERR_LAST_TOK) | (pe_ok ? 0 : ERR_PE_IDX) |
                       (kv >= 0 && kv < a.S ? 0 : ERR_KV_LEN);
      if (bits) atomicOr(a.err, bits);
    }
    float v = nanf("");
    if (tok_ok && pe_ok) {
      const float e = __bfloat162float(a.audio_emb[(size_t)t * D + d]);
      const float pq = __bfloat162float(__float2bfloat16(a.alpha * a.pe[(size_t)pe_idx * D + d]));
      v = __bfloat162float(__float2bfloat16(e + pq));
    }
    s.resid[i] = v;
    s.act[i] = __float2bfloat16(v);
  }
  __syncthreads();
}

// x[b] = x_in[b] (a layer stack's rows, promoted to float32); block 0 flags a
// kv_len outside [0, S), which the attention turns into NaN for that row.
template <int NB>
static __device__ __noinline__ void ps_stage_input(const StepArgs& a) {
  const PsBlock<NB> s = ps_block<NB>(a);
  if (blockIdx.x == 0 && threadIdx.x < a.B) {
    const int kv = a.kv_len != nullptr ? a.kv_len[threadIdx.x] : a.kv_i;
    if (kv < 0 || kv >= a.S) atomicOr(a.err, ERR_KV_LEN);
  }
  const int n = a.B * a.D;  // the live rows only: a dead row's x_in does not exist
  for (int i = threadIdx.x; i < n; i += PS_THREADS) {
    const float v = a.x_f32 ? static_cast<const float*>(a.x_in)[i]
                            : __bfloat162float(static_cast<const bf16*>(a.x_in)[i]);
    s.resid[i] = v;
    s.act[i] = __float2bfloat16(v);
  }
  __syncthreads();
}

// x_out[b] = the normalised rows in s.resid, in x_in's type (a layer stack's
// result; the caller's block has just staged the last LayerNorm).
template <int NB>
static __device__ __noinline__ void ps_store_rows(const StepArgs& a) {
  const float* r = ps_block<NB>(a).resid;
  const int n = a.B * a.D;
  if (a.x_f32) {
    for (int i = threadIdx.x; i < n; i += PS_THREADS) static_cast<float*>(a.x_out)[i] = r[i];
  } else {
    for (int i = threadIdx.x; i < n; i += PS_THREADS)
      static_cast<bf16*>(a.x_out)[i] = __float2bfloat16(r[i]);
  }
}

// Start the copy of a LayerNorm's scale and shift into s.gb (cp.async, 16
// bytes a thread): called a phase ahead, before the barrier.
template <int NB>
static __device__ __forceinline__ void ps_prefetch_layernorm(const StepArgs& a, const float* g,
                                                          const float* bt) {
  float* gb = ps_block<NB>(a).gb;
  const int D = a.D;
  for (int i = threadIdx.x; i < D / 2; i += PS_THREADS) {  // D / 4 chunks of g, then of bt
    const int c = i < D / 4 ? i : i - D / 4;
    const float* src = (i < D / 4 ? g : bt) + 4 * c;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(gb + 4 * i)), "l"(__cvta_generic_to_global(src)) : "memory");
  }
}

// LayerNorm of the pre-norm rows ``src`` ([B, D], written by other blocks,
// at one row under ``tag``) with the scale and shift that ps_prefetch_layernorm put
// under way; block 0 also writes the normalised rows to ``x_out`` when given.
template <int NB>
static __device__ __noinline__ void ps_stage_layernorm(const StepArgs& a, const void* src,
                                                       unsigned tag, float* x_out) {
  const PsBlock<NB> s = ps_block<NB>(a);
  const int D = a.D, B = a.B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (PsHandOver<NB>::TAGGED) {
    float2* resid2 = reinterpret_cast<float2*>(s.resid);
    ps_take_all<4>(static_cast<const PsTagged*>(src), B * D / 2, tag, a.err,
                   [&](int i, float2 v) { resid2[i] = v; });
  } else {
    const float4* src4 = static_cast<const float4*>(src);
    float4* resid4 = reinterpret_cast<float4*>(s.resid);
    for (int i = threadIdx.x; i < B * D / 4; i += PS_THREADS) resid4[i] = __ldcg(src4 + i);
  }
  __syncthreads();
  for (int b = warp; b < B; b += PS_WARPS) {
    const float* r = s.resid + (size_t)b * D;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += r[d];
    const float mean = warp_sum(sum) / D;
    float q = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = r[d] - mean;
      q += c * c;
    }
    const float var = warp_sum(q) / D;
    if (lane == 0) {
      s.stats[2 * b] = mean;
      s.stats[2 * b + 1] = 1.f / sqrtf(var + 1e-5f);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += PS_THREADS) {
    const float g = s.gb[d], bt = s.gb[D + d];
    for (int b = 0; b < B; ++b) {
      const int i = b * D + d;
      const float v = (s.resid[i] - s.stats[2 * b]) * s.stats[2 * b + 1] * g + bt;
      s.resid[i] = v;
      s.act[i] = __float2bfloat16(v);
      if (x_out != nullptr && blockIdx.x == 0) x_out[i] = v;
    }
  }
  __syncthreads();
}

// Rows of ``src`` ([B, K], written by other blocks, at one row under ``tag``)
// to bf16.
template <int NB>
static __device__ __noinline__ void ps_stage_rows(const StepArgs& a, const void* src,
                                                  unsigned tag, int K) {
  __nv_bfloat162* act2 = reinterpret_cast<__nv_bfloat162*>(ps_block<NB>(a).act);
  if (PsHandOver<NB>::TAGGED) {
    ps_take_all<8>(static_cast<const PsTagged*>(src), a.B * K / 2, tag, a.err,
                   [&](int i, float2 v) { act2[i] = __floats2bfloat162_rn(v.x, v.y); });
  } else {
    const float4* src4 = static_cast<const float4*>(src);
    for (int i = threadIdx.x; i < a.B * K / 4; i += PS_THREADS) {
      const float4 v = __ldcg(src4 + i);
      act2[2 * i] = __floats2bfloat162_rn(v.x, v.y);
      act2[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
    }
  }
  __syncthreads();
}

static __device__ __forceinline__ int ps_kv(const StepArgs& a, int b) {
  return a.kv_len != nullptr ? a.kv_len[b] : a.kv_i;
}

// ---------------------------------------------------------------------------
// Attention of layer ``l`` into a.attn: one block per (slot, head), all its
// warps walking the slot's rows [0, kv_len[b]] 64 at a time -- the cache rows
// below kv_len[b] and the token's own K/V, in float32 from qkv -- each
// (warp, row slot) with its own online softmax.  The row slots of a warp are
// merged by shuffles, the warps through shared memory, always in the same
// order, and the block appends the slot's K/V row at kv_len[b], which nobody
// reads in this phase.  No partial leaves the block, so the merge costs no
// pass through L2, no phase and no barrier; with B H <= 128 items the phase
// is one item long, whatever B is.
//
// Measured and lost: cutting a (slot, head) over several blocks (with a
// count of the parts done behind a fence, or with tagged parts that every
// block merges while it stages the out-proj's input), and 64-row splits over
// groups of 128 threads as the first design had them.  The walk is the smaller part
// of an item's time -- the wait for q, the two merges and the way out are
// the same however short the walk -- and the parts' way through L2 adds
// dependent trips to memory.  Asking for the next layer's rows with
// prefetch.global.L2 a layer ahead changed nothing either: the walk waits
// for instruction issue, not for memory.
// ---------------------------------------------------------------------------
template <int LPR, bool TAGGED>
static __device__ __noinline__ void ps_attn_phase(const StepArgs& a, float* scratch, int l,
                                                  unsigned tag) {
  constexpr int Dh = LPR * 8;
  const int D = a.D, H = a.H, S = a.S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* s_m = scratch;           // [PS_WARPS]
  float* s_l = s_m + PS_WARPS;    // [PS_WARPS]
  float* s_acc = s_l + PS_WARPS;  // [PS_WARPS][Dh]
  bf16* kc = a.k_cache + (size_t)l * a.B * S * D;
  bf16* vc = a.v_cache + (size_t)l * a.B * S * D;
  const int d0 = (lane % LPR) * 8;
  // attn[b, hoff + d] = v, the way this kernel hands over
  auto put = [&](size_t i, float v) {
    if (TAGGED)
      ps_put(static_cast<PsTagged*>(a.attn) + i, v, tag);
    else
      static_cast<float*>(a.attn)[i] = v;
  };
#pragma unroll 1
  for (int it = blockIdx.x; it < a.B * H; it += gridDim.x) {
    const int b = it / H, h = it - b * H;
    const int kv = ps_kv(a, b);
    const size_t hoff = (size_t)h * Dh;
    if (kv < 0 || kv >= S) {  // flagged at the embedding; uniform over the block
      for (int d = tid; d < Dh; d += PS_THREADS) put((size_t)b * D + hoff + d, nanf(""));
      continue;
    }
    const size_t qoff = (size_t)b * 3 * D + hoff;
    bf16* kcb = kc + (size_t)b * S * D + hoff;
    bf16* vcb = vc + (size_t)b * S * D + hoff;
    float qr[8], kown[8], vown[8];
    if (TAGGED) {  // the lane's 8 dims of q, k and v: twelve loads asked for together
      const PsTagged* q = static_cast<const PsTagged*>(a.qkv) + qoff;
      uint4 w[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) w[j] = ps_peek_pair(q + (j / 4) * D + d0 + 2 * (j % 4));
#pragma unroll
      for (int j = 0; j < 12; ++j) {
        const float2 v = ps_take_pair(w[j], q + (j / 4) * D + d0 + 2 * (j % 4), tag, a.err);
        float* dst = j < 4 ? qr : j < 8 ? kown : vown;
        dst[2 * (j % 4)] = v.x;
        dst[2 * (j % 4) + 1] = v.y;
      }
    } else {
      const float* q = static_cast<const float*>(a.qkv) + qoff;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        qr[j] = __ldcg(q + d0 + j);
        kown[j] = __ldcg(q + D + d0 + j);
        vown[j] = __ldcg(q + 2 * D + d0 + j);
      }
    }
    if (warp == 0 && lane < LPR) {  // the append
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        kcb[(size_t)kv * D + d0 + j] = __float2bfloat16(kown[j]);
        vcb[(size_t)kv * D + d0 + j] = __float2bfloat16(vown[j]);
      }
    }
    float acc[8], m, lsum;
    attn_walk<LPR, PS_THREADS>(qr, kown, vown, true, kcb, vcb, D, kv, 0, kv + 1, a.attn_scale,
                               tid, m, lsum, acc);
    // the warp's row slots (lanes that share lane % LPR) into one
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m, o);
      const float l_o = __shfl_xor_sync(0xffffffffu, lsum, o);
      const float m_new = fmaxf(m, m_o);
      const float c = lsum > 0.f ? __expf(m - m_new) : 0.f;  // a slot that met no row has l = 0
      const float c_o = l_o > 0.f ? __expf(m_o - m_new) : 0.f;
      lsum = lsum * c + l_o * c_o;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j] = acc[j] * c + __shfl_xor_sync(0xffffffffu, acc[j], o) * c_o;
      m = m_new;
    }
    if (lane < LPR) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s_acc[warp * Dh + d0 + j] = acc[j];
      if (lane == 0) {
        s_m[warp] = m;
        s_l[warp] = lsum;
      }
    }
    __syncthreads();
    for (int d = tid; d < Dh; d += PS_THREADS) {
      float mx = -INFINITY;
      for (int w = 0; w < PS_WARPS; ++w) mx = fmaxf(mx, s_m[w]);
      float den = 0.f, num = 0.f;
      for (int w = 0; w < PS_WARPS; ++w) {
        if (s_l[w] > 0.f) {
          const float c = __expf(s_m[w] - mx);
          den += s_l[w] * c;
          num += s_acc[w * Dh + d] * c;
        }
      }
      put((size_t)b * D + hoff + d, num / den);
    }
    __syncthreads();  // the scratch is free for the block's next item
  }
}

template <bool TAGGED>
static __device__ __forceinline__ void ps_attention(const StepArgs& a, float* scratch, int l,
                                                    unsigned tag) {
  switch (a.D / a.H) {  // checked on the host: one of these
    case 8: ps_attn_phase<1, TAGGED>(a, scratch, l, tag); break;
    case 16: ps_attn_phase<2, TAGGED>(a, scratch, l, tag); break;
    case 32: ps_attn_phase<4, TAGGED>(a, scratch, l, tag); break;
    case 64: ps_attn_phase<8, TAGGED>(a, scratch, l, tag); break;
    default: ps_attn_phase<16, TAGGED>(a, scratch, l, tag); break;
  }
}

// Built with -DPS_TRACE, block 0 writes its SM's clock at every mark (1 + 9
// a layer at one row, 14 for a wave with its barriers, and for a layer stack
// one more after its rows are stored) into a.trace, as long long (the
// wrapper keeps it PS_TRACE_BYTES long): where a step's time goes, phase by
// phase.
constexpr int PS_TRACE_BYTES = 4096;
#ifdef PS_TRACE
#define PS_MARK()                                                                        \
  do {                                                                                   \
    if (blockIdx.x == 0 && threadIdx.x == 0 && n_marks < PS_TRACE_BYTES / 8)             \
      reinterpret_cast<long long*>(a.trace)[n_marks] = clock64();                        \
    ++n_marks;                                                                           \
  } while (0)
#else
#define PS_MARK()
#endif

// ---------------------------------------------------------------------------
// The kernel: a.B <= NB rows; the layers' weights streamed in format WQ.
// ---------------------------------------------------------------------------
template <int NB, int WQ = 0>
__global__ void __launch_bounds__(PS_THREADS, 1)
decode_step_persistent(const __grid_constant__ StepArgs a) {
  const PsBlock<NB> s = ps_block<NB>(a);
  {  // the layer table (pointers only) into shared memory, and a quantized stream's scales
    const unsigned long long* src = reinterpret_cast<const unsigned long long*>(a.layers);
    unsigned long long* dst = reinterpret_cast<unsigned long long*>(s.lw);
    for (int i = threadIdx.x; i < a.L * (int)(sizeof(LayerWeights) / 8); i += PS_THREADS)
      dst[i] = src[i];
    if (WQ != 0) {
      const unsigned long long* qsrc = reinterpret_cast<const unsigned long long*>(a.scales);
      unsigned long long* qdst = reinterpret_cast<unsigned long long*>(s.qs);
      for (int i = threadIdx.x; i < a.L * (int)(sizeof(PsQuantScales) / 8); i += PS_THREADS)
        qdst[i] = qsrc[i];
    }
  }
  if (threadIdx.x >= 32 && threadIdx.x < 32 + 5) ps_make_plan(a, s.plan, threadIdx.x - 32, WQ);
  if (threadIdx.x == 0) {
    mbar_init(s.full, PS_STAGES);
  }
  __syncthreads();
  if (threadIdx.x == PS_LOADER) {
    s.stream->p = s.stream->row = s.stream->issued = s.stream->dead = 0;
    s.stream->fill(a, s.lw, s.plan, s.ring, s.full, 0);
  }
  __syncthreads();

  // What does not depend on the activations is requested a phase ahead of
  // its use: each product's bias and scales (PsEpi, registers) and each
  // LayerNorm's scale and shift (s.gb).  PS_HAND_OVER() stands where a
  // phase's output must have reached the next phase: a grid barrier for a
  // wave, nothing at one row, whose values carry their tags.
  constexpr bool TAGGED = PsHandOver<NB>::TAGGED;
  unsigned long long target = 0;
  if (!TAGGED) target = ps_first_target(a.bar, reinterpret_cast<unsigned long long*>(s.psum));
#define PS_HAND_OVER()                                   \
  do {                                                   \
    if (!TAGGED) {                                       \
      ps_grid_barrier(a.bar, target, a.err);             \
      PS_MARK();                                         \
    }                                                    \
  } while (0)
  const int D = a.D, M = a.M, L = a.L;
  int consumed = 0;
#ifdef PS_TRACE
  int n_marks = 0;
#endif
  // layer l's scales of a quantized stream (none for bf16)
#define PS_SCALES(l, m) (WQ != 0 ? s.qs[l].m : nullptr)
  PsEpi epi = ps_epi_first<NB>(a, 0, s.lw[0].qkv_b, PS_SCALES(0, qkv));
  PS_MARK();
#pragma unroll 1
  for (int l = 0; l < L; ++l) {
    const LayerWeights& w = s.lw[l];
    const unsigned tag = (a.epoch << 8) + l;  // what this layer's phases write under
    if (l == 0 && a.x_in != nullptr)
      ps_stage_input<NB>(a);
    else if (l == 0)
      ps_stage_embed<NB>(a);
    else
      ps_stage_layernorm<NB>(a, a.pre, tag - 1, nullptr);
    PS_MARK();
    consumed = ps_product_rows<NB, WQ>(a, 4 * l, w.qkv_b, PS_SCALES(l, qkv), nullptr, epi, false,
                                       a.qkv, tag, nullptr, false, consumed);
    epi = ps_epi_first<NB>(a, 4 * l + 1, w.out_b, PS_SCALES(l, out));
    PS_MARK();
    PS_HAND_OVER();
    ps_attention<TAGGED>(a, s.scratch, l, tag);
    PS_MARK();
    PS_HAND_OVER();
    ps_stage_rows<NB>(a, a.attn, tag, D);
    PS_MARK();
    consumed = ps_product_rows<NB, WQ>(a, 4 * l + 1, w.out_b, PS_SCALES(l, out), nullptr, epi,
                                       true, a.h, tag, nullptr, false, consumed);
    epi = ps_epi_first<NB>(a, 4 * l + 2, w.mlp1_b, PS_SCALES(l, mlp1), PS_SCALES(l, mlp2));
    ps_prefetch_layernorm<NB>(a, w.ln1_g, w.ln1_b);
    PS_MARK();
    PS_HAND_OVER();
    ps_stage_layernorm<NB>(a, a.h, tag, nullptr);
    PS_MARK();
    consumed = ps_product_rows<NB, WQ>(a, 4 * l + 2, w.mlp1_b, PS_SCALES(l, mlp1),
                                       PS_SCALES(l, mlp2), epi, false, a.mlp, tag, nullptr, true,
                                       consumed);
    epi = ps_epi_first<NB>(a, 4 * l + 3, w.mlp2_b);
    PS_MARK();
    PS_HAND_OVER();
    ps_stage_rows<NB>(a, a.mlp, tag, M);
    PS_MARK();
    consumed = ps_product_rows<NB, WQ>(a, 4 * l + 3, w.mlp2_b, nullptr, nullptr, epi, true, a.pre,
                                       tag, nullptr, false, consumed);
    if (l + 1 < L) epi = ps_epi_first<NB>(a, 4 * l + 4, s.lw[l + 1].qkv_b, PS_SCALES(l + 1, qkv));
    ps_prefetch_layernorm<NB>(a, w.ln2_g, w.ln2_b);
    PS_MARK();
    PS_HAND_OVER();
  }
#undef PS_SCALES
#undef PS_HAND_OVER
  if (a.x_in == nullptr) {  // the whole step: every block normalises the rows for the head
    ps_stage_layernorm<NB>(a, a.pre, (a.epoch << 8) + L - 1, a.x);
    ps_product_rows<NB, 0>(a, 4 * L, nullptr, nullptr, nullptr, PsEpi{0.f, 1.f, 1.f}, false,
                           nullptr, 0u, a.row_out, false, consumed);
  } else if (blockIdx.x == 0) {  // a layer stack: nobody else needs the last rows
    ps_stage_layernorm<NB>(a, a.pre, (a.epoch << 8) + L - 1, nullptr);
    ps_store_rows<NB>(a);
    PS_MARK();
  } else {  // (the last LayerNorm's scale and shift are on their way here too)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// ``n`` grid barriers as ps_grid_barrier's with nothing in between: what one
// costs (chip_smoke.py times it).  (Its own copy of the few lines: this
// kernel has no dynamic shared memory for the block's give-up flag.)
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(PS_THREADS, 1)
ps_barrier_loop(unsigned long long* ctr, int n, int* err) {
  __shared__ unsigned long long first;
  if (threadIdx.x == 0) {  // until this block arrives at most gridDim.x - 1 others have added
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(ctr) : "memory");
    first = v / gridDim.x * gridDim.x + gridDim.x;
  }
  __syncthreads();
  unsigned long long target = first;
  for (int i = 0; i < n; ++i, target += gridDim.x) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;\n" :: "l"(ctr), "l"(1ULL) : "memory");
      unsigned long long v;
      unsigned spins = 0;
      do {
        asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(ctr) : "memory");
      } while (v < target && ++spins < PS_SPIN_LIMIT);
      if (v < target) atomicOr(err, ERR_SYNC);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// One block per SM of the current device, or an error if none fits.
static int ps_grid(const void* kernel, size_t smem, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PS_THREADS, smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *grid = sms;
  return 0;
}

// Launch the step for a.B <= NB rows, the layers' weights in format WQ, on
// ``st``.  Returns the CUDA error (a grid that cannot be co-resident is
// cudaErrorCooperativeLaunchTooLarge).  A quantized stream needs its scale
// table and widths whose int4 rows are whole 16-byte runs (D, M multiples
// of 32), as the bulk copies are.
template <int NB, int WQ = 0>
static int launch_decode_step_persistent(const StepArgs& a, cudaStream_t st) {
  static int cached_dev = -1, cached_grid = 0;  // queried once per process and device
  static size_t cached_smem = 0;
  constexpr bool TAGGED = PsHandOver<NB>::TAGGED;
  if (a.B < 1 || a.B > NB || a.L < 1 || 2 * a.D > PS_STAGE_BYTES || 2 * a.M > PS_STAGE_BYTES ||
      (a.x_in != nullptr && a.x_out == nullptr) ||
      (TAGGED && (a.L > 255 || a.epoch == 0 || a.epoch >= (1u << 24))) ||
      (WQ != 0 && (a.scales == nullptr || a.D % 32 != 0 || a.M % 32 != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = ps_layout(NB, a.L, a.D, a.M).total;
  if (smem > SMEM_OPTIN) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)decode_step_persistent<NB, WQ>;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev || smem != cached_smem) {
    int rc = ps_grid(kernel, smem, &cached_grid);
    if (rc) return rc;
    cached_dev = dev;
    cached_smem = smem;
  }
  // without barriers every block must own rows of the QKV and MLP-1 products:
  // what keeps a buffer's next writer behind its last reader (see the top)
  if (TAGGED && (3 * a.D < cached_grid || a.M < cached_grid)) return (int)cudaErrorInvalidValue;
  StepArgs args = a;
  void* params[] = {&args};
  const cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(cached_grid), dim3(PS_THREADS),
                                                    params, smem, st);
  return (int)e;
}

static int launch_barrier_loop(unsigned long long* bar, int n, int* err, cudaStream_t st) {
  int grid = 0;
  int rc = ps_grid((const void*)ps_barrier_loop, 0, &grid);
  if (rc) return rc;
  void* params[] = {&bar, &n, &err};
  return (int)cudaLaunchCooperativeKernel((const void*)ps_barrier_loop, dim3(grid),
                                          dim3(PS_THREADS), params, 0, st);
}
