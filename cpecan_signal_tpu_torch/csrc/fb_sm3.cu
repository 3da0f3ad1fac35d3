// Banded forward-backward kernels of the signal-alignment and EM paths,
// written for Hopper (sm_90a) with a plain C interface (bound from Python with
// ctypes, see ops/_build.py and ops/fb_kernels.py).  The recursions are
// generic over a machine's edge table (threeState, fourState, vanilla,
// echelon, fiveState); the emissions kernel is threeState's.
//
// Layouts (all row-major, contiguous; B problems, Dp diagonals, W window
// lanes, S states, C emission channels):
//   x0, yr0       (B, nrow >= Dp) int32   per-diagonal slice offsets
//   xarr          (B, 13, lXp)    f32     per-x parameter pack
//   evr           (B, 2, lYp)     f32     reversed event rows (mean, noise)
//   E             (B, De >= Dp+2, C, W)   emissions; rows >= Dp are 0
//   ds            (B, ds_rows >= Dp+1, 8) int32 DS_* scalars (nh = 1)
//   F             (B, Dp, S, W)   forward log-probs, row d relative to
//   offF          (B, Dp)         f64: the absolute value is F + offF
//   P             (B, Dp, P, W)   posteriors of the states in pmask (P = its
//                                 set bits; the match state alone: (B, Dp, W)),
//                                 or at stage 4 with edge groups the group sums
//                                 of the per-edge posteriors; T (B, Dp) totals
//   edges         (n_edges, 12)   int32 edge table (engine/plan.edge_table)
//   exits         (B, Dp, G)      stage 4: window-group mass leaving lane W-1
//   gacc          (B, G, W)       stage 4: window-group tallies left at d = 0
//   stats         (B, 128)        stage 4: lane e = edge-e posterior sum,
//                                 lane LIK_LANE = likelihood
//   work          backward scratch (backward_work_floats): offB (B, Dp) f64,
//                 b (B, Dp, S, W) (relative to offB, as F to offF), at stage
//                 4 then the window-group sums (B, Dp, G, W) and the per-edge
//                 lane sums (B, Dp, n_edges)
//
// Every float operation that the reference logAdd and the Gaussian pack do
// as separate multiply and add is written with __fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA, so the card rounds exactly like the
// plain PyTorch versions on the CPU.  expf / logf are the accurate (not the
// fast-math) versions; the file must not be built with --use_fast_math.
//
// Design (H100): a diagonal needs the two before it, so each problem's
// recursion is a serial chain of Dp steps run by one block.  What limits it
// is the time of one step, not bytes or flops: PR 4's kernels took 3.1 us a
// diagonal (forward) and 6.0 us (stage-3 backward) at the threeState plan,
// mostly device-memory loads waited for one edge after the other, and the
// backward's two block-wide reductions.  The kernels keep only the
// recursion itself on that chain:
//   * each diagonal's E row and diagonal-scalar row are staged in a shared
//     ring K rows ahead by cp.async (ring_depth), the per-edge constants
//     (source, states, channel offsets, the summed scalar transition term)
//     are read once into shared memory, and a step reads only shared memory
//     and registers;
//   * edges are taken in rounds, round r holding the r-th edge into each
//     state (table order within a state, so every sum keeps its order), and
//     a round is straight-line code over a compile-time state count with a
//     branch-free logAdd, so the states' logAdd chains overlap;
//   * the backward's totals, posteriors and stage-4 tallies need the whole
//     diagonal; they run after the recursion in a kernel with one warp per
//     (problem, diagonal), so they cost no barrier and no step of the chain.
// Measured on an H100 80GB HBM3 at 700.00 W (tools/torch_recursion_ab.py,
// W = 128, Dp = 4096, B = 64, against PR 4's build in one call): forward
// 2.944 ms (0.72 us a diagonal; PR 4 12.728), stage-3 backward 4.211
// (24.328), stage 4 6.131 (35.831), stage 4 with pgroups at fiveState
// 11.709 (63.873), echelon pstates at Dp = 1024 5.437 (26.240); every
// output equal to PR 4's bit for bit (stats within chip_smoke.py's stage-4
// tolerance).  The per-diagonal offsets (Kernel 2) cost 10-28 %: forward
// 3.353 ms against 2.971 without them, stage 3 4.779 (4.233), stage 4 6.857
// (6.163), pgroups 13.703 (11.781), pstates 6.149 (5.463) (the same tool,
// one call).  More in ../../PERF.md (Findings, PR 5 and PR 9).
//
// Launch-bound instances and ptxas's registers (the same build): the
// recursion <false> and <true> under RECURSION_THREADS (64 registers, no
// spill); the epilogue <false,false,false> 56, <false,true,false> 48,
// <true,false,false> 64 and <true,false,true> 64 with 8 bytes spilled,
// under EPI_THREADS; the carry kernel 60 under RECURSION_THREADS.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define LOG_UNDERFLOW 7.5f
#define MAX_S 8
#define MAX_EDGES 64  // edge e's stage-4 tally sits in stats lane e < LIK_LANE
#define MAX_IDS 4
#define EDGE_COLS (4 + 2 * MAX_IDS)
#define N_XPARAMS 13
#define MAX_G 4
#define STATS_LANES 128
#define LIK_LANE 64

// The recursion kernels' launch bound and window lanes per thread (a block
// of W / LANES_PER_THREAD threads per problem), the deepest E ring, and the
// shared memory a block may use (227 KB, less the static arrays' room).
#define RECURSION_THREADS 1024
#define LANES_PER_THREAD 1
#define RING_MAX 12
#define SMEM_LIMIT (232448 - 4096)
// The backward epilogue: at most EPI_WARPS warps (diagonals) a block.
#define EPI_WARPS 8
#define EPI_THREADS (32 * EPI_WARPS)
// The added scalar term of a padding edge: its value lies below NEG_INF, so
// that its logAdd returns the running sum unchanged.
#define PAD_TERM (-3e38f)
// A row maximum at or below this holds no cell: its step shifts by 0.0
// (ops/fb_kernels.SHIFT_FLOOR).
#define SHIFT_FLOOR (-5e29f)

enum { DS_FL = 0, DS_FM, DS_BL, DS_BM, DS_W0, DS_XMYL, DS_XMYR, DS_XS };

// The posterior channels of the pgroups mode: channel c sums the per-edge
// posteriors of the edges whose bits are set in m[c] (bit e = edge e, all
// MAX_EDGES edges).  Passed by value.
struct ChannelGroups {
  unsigned long long m[MAX_S];
};
enum { SRC_LOWER = 0, SRC_MIDDLE = 1, SRC_UPPER = 2 };

// ---------------------------------------------------------------------------
// Shared device helpers
// ---------------------------------------------------------------------------

// Reference logAdd (pairwiseAligner.c:238-255), as ops/pallas_fb._ladd:
// hi + log1p(exp(lo - hi)) by a 4-piece cubic in d = hi - lo, truncated to
// hi for d >= 7.5, saturated at NEG_INF.  Branch-free: the piece's four
// coefficients are selected by comparisons and one Horner chain runs, the
// same rounded operations as evaluating the piece alone (the constants round
// decimal -> f64 -> f32 like the plain version's).
__device__ __forceinline__ float ladd(float x, float y) {
  const float hi = fmaxf(x, y);
  const float lo = fminf(x, y);
  const float d = fminf(__fsub_rn(hi, lo), LOG_UNDERFLOW);
  const bool p1 = d <= 1.0f, p2 = d <= 2.5f, p3 = d <= 4.5f;
  const float a = p1 ? (float)-0.009350833524763
                     : p2 ? (float)-0.014532321752540
                          : p3 ? (float)-0.004605031767994 : (float)-0.000458661602210;
  const float b = p1 ? (float)0.130659527668286
                     : p2 ? (float)0.139942324101744
                          : p3 ? (float)0.063427417320019 : (float)0.009695946122598;
  const float c = p1 ? (float)0.498799810682272
                     : p2 ? (float)0.495635523139337
                          : p3 ? (float)0.695956496475118 : (float)0.930734667215156;
  const float e = p1 ? (float)0.693203116424741
                     : p2 ? (float)0.692140569840976
                          : p3 ? (float)0.514272634594009 : (float)0.168037164329057;
  float v = __fadd_rn(__fmul_rn(a, d), b);
  v = __fadd_rn(__fmul_rn(v, d), c);
  const float lut = __fadd_rn(__fmul_rn(v, d), e);
  // out = d >= 7.5 ? hi : lo + lut, as a selp: written as ?: the compiler
  // branches around the Horner chain, which splits the edge loop into
  // blocks that cannot overlap
  float out;
  asm("{\n\t.reg .pred p;\n\tsetp.ge.f32 p, %1, 0f40F00000;\n\t"
      "selp.f32 %0, %2, %3, p;\n\t}"
      : "=f"(out)
      : "f"(d), "f"(hi), "f"(__fadd_rn(lo, lut)));
  return fmaxf(out, NEG_INF);
}
static_assert(LOG_UNDERFLOW == 7.5f, "ladd's selp compares with 7.5 (0f40F00000)");

// out[j] = v[j + s] selects on the sign of s only (ops/pallas_fb._shift)
__device__ __forceinline__ int sgn(int s) { return (s > 0) - (s < 0); }

__device__ __forceinline__ float lse_finish(float m, float s) {
  return (m <= NEG_INF) ? NEG_INF : __fadd_rn(m, logf(fmaxf(s, 1e-38f)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The butterfly of the plain versions' _block_sum within 32 lanes: lane i
// adds lane i ^ o for o = 16, 8, 4, 2, 1; every lane ends with the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One edge in shared memory, two 16-byte words: x = (src | frm << 4 |
// to << 8 | has_t << 12 | carry offset << 16, the summed scalar term t as
// bits, channel offsets 0, 1), y = (channel offsets 2, 3, 4, 0).  A channel
// offset is channel * W, or -1 past the edge's channels; the carry offset is
// the recursion's source state (forward: frm, backward: to) * (W + 2) + 1.
struct EdgeRec {
  int4 x, y;
};
__device__ __forceinline__ int rec_src(const EdgeRec& r) { return r.x.x & 15; }
__device__ __forceinline__ int rec_frm(const EdgeRec& r) { return (r.x.x >> 4) & 15; }
__device__ __forceinline__ int rec_to(const EdgeRec& r) { return (r.x.x >> 8) & 15; }
__device__ __forceinline__ int rec_off(const EdgeRec& r) { return r.x.x >> 16; }

// Sum of an edge's E channels at lane j: emission class, then per-cell
// transition channels, left to right (ops/pallas_fb._esum).  NCH (1..5)
// bounds the channels of any edge of the table; the sum is branch-free (a
// missing channel loads channel 0 and is not added), so that the loads of
// several edges can be in flight together.
template <int NCH>
__device__ __forceinline__ float rec_esum(const float* Ed, const EdgeRec& r, int j) {
  const int ch[4] = {r.x.w, r.y.x, r.y.y, r.y.z};
  float v = Ed[r.x.z + j];
#pragma unroll
  for (int k = 0; k < NCH - 1; ++k) {
    const float x = Ed[max(ch[k], 0) + j];
    v = ch[k] >= 0 ? __fadd_rn(v, x) : v;
  }
  return v;
}

// val + the edge's scalar transition terms, summed once per problem left to
// right (ops/pallas_fb tp_of; an edge without scalar terms adds nothing)
__device__ __forceinline__ float rec_add_t(float val, const EdgeRec& r) {
  return ((r.x.x >> 12) & 1) ? __fadd_rn(val, __int_as_float(r.x.y)) : val;
}

// Edge rows -> records, and record MAX_EDGES the padding edge; every thread
// of the block takes a share.  by_to: the carry offset is the to-state's
// (the backward recursion), else the from-state's.
__device__ void load_edges(const int* __restrict__ edges, const float* __restrict__ tp,
                           int n_edges, int W, bool by_to, EdgeRec* recs) {
  for (int e = threadIdx.x; e <= n_edges; e += blockDim.x) {
    EdgeRec r;
    if (e == n_edges) {
      r.x = make_int4(SRC_LOWER | 1 << 12 | 1 << 16, __float_as_int(PAD_TERM), 0, -1);
      r.y = make_int4(-1, -1, -1, 0);
      recs[MAX_EDGES] = r;
      continue;
    }
    const int* er = edges + e * EDGE_COLS;
    float t = 0.0f;
    const bool has_t = er[4] >= 0;
    if (has_t) {
      t = tp[er[4]];
      for (int k = 1; k < MAX_IDS; ++k)
        if (er[4 + k] >= 0) t = __fadd_rn(t, tp[er[4 + k]]);
    }
    int ch[1 + MAX_IDS];
    ch[0] = er[3] * W;
    for (int k = 0; k < MAX_IDS; ++k) {
      const int c = er[4 + MAX_IDS + k];
      ch[1 + k] = c >= 0 ? c * W : -1;
    }
    const int off = (by_to ? er[2] : er[1]) * (W + 2) + 1;
    r.x = make_int4(er[0] | er[1] << 4 | er[2] << 8 | (has_t ? 1 << 12 : 0) | off << 16,
                    __float_as_int(t), ch[0], ch[1]);
    r.y = make_int4(ch[2], ch[3], ch[4], 0);
    recs[e] = r;
  }
}

// ---------------------------------------------------------------------------
// Kernel 1: emissions
// ---------------------------------------------------------------------------
// Replaces cpecan_signal_tpu/ops/pallas_fb.py:emissions_sm3 (_emissions_kernel).
// Bound: device-memory bytes, nearly all of them E's own writes (3 floats a
// cell against the inputs' 15 floats a column of the x pack and the event
// rows, and two offsets a diagonal).  The first version ran one block per
// (diagonal, problem) and read each diagonal's 13 x-pack and 2 event slices
// of W floats: 5x the bytes it wrote, which came from L2, because the
// neighbouring diagonals whose slices overlap in W - 1 lanes ran on other
// SMs (0.351 ms at W = 128, Dp = 4096, B = 64 on an H100 80GB HBM3 at
// 700.00 W, against a bound of 0.124 ms: about the L2's rate for those
// reads).
// Design: one block per (problem, tile of EMIT_TILE = K consecutive
// diagonals).  Along a band x0 steps by 0 or +1 a diagonal and yr0 by 0 or
// -1 (the window's w0 steps by +-1), so a tile's slices lie within K - 1 + W
// columns of each row.  The block reads its tile's offsets, takes the span
// of the clamped columns, and stages that span of the 13 x rows and the 2
// event rows once in shared memory: the 16-byte aligned middle of each row
// by a bulk asynchronous copy (cp.async.bulk, TMA) completing on an
// mbarrier, the <= 3 floats at either end by plain loads.  It then computes
// the tile's K x W cells from shared memory, thread t at lane t % W, and
// writes E[b, d0 : d0 + K], K x 3 x W contiguous floats, in one sweep (a
// warp stores 128 contiguous bytes of a channel row; 4 lanes a thread with
// 16-byte stores would read the staged rows with a stride of 4 floats, a
// 4-way bank conflict).  A tile whose span is wider than the staged rows
// (offsets off a band), or whose rows do not start on 16 bytes, reads its
// slices from device memory with the same arithmetic.  Rows d >= Dp are
// zero: the backward reads them past the end.
// Measured on an H100 80GB HBM3 at 700.00 W (tools/torch_recursion_ab.py,
// the first version in the same call; E equal to its E bit for bit): 0.150
// ms at W = 128, Dp = 4096, B = 64 (first version 0.342; bound 0.124, the
// bytes), 0.061 ms for a 50 kb read (W = 128, Dp = 106496, B = 1; 0.143),
// 0.151 ms at W = 1024, Dp = 512, B = 64 (0.296).  Staging by cp.async of 16 bytes
// a thread took as long as the bulk copies; streaming stores (__stcs) took
// 4-9 % off and cost the forward that reads E nothing, even where E fits in
// the L2; 256 threads a block 2 % more, 1024 threads 14 % more.
#define EMIT_TILE 64         // diagonals of an emissions block (K)
#define EMIT_THREADS 512     // threads of an emissions block, whole windows
#define EMIT_STREAM_STORE 1  // write E with __stcs (1) or plain stores (0)
#define EMIT_ROWS (N_XPARAMS + 2)  // staged rows: the x pack, then the 2 event rows

// Floats of a staged row: a span of at most K - 1 + W columns from the
// 16-byte boundary at or before it (<= 3 floats earlier), in 16-byte units.
__host__ __device__ __forceinline__ int emit_row_floats(int W) {
  return (EMIT_TILE - 1 + W + 3 + 3) & ~3;
}

// Threads of an emissions block: whole windows, EMIT_THREADS / W of them
// (one if W >= EMIT_THREADS).
__host__ __device__ __forceinline__ int emit_threads(int W) {
  return W * (W < EMIT_THREADS ? EMIT_THREADS / W : 1);
}

// Dynamic shared bytes of an emissions block: the mbarrier (16 bytes), the
// staged rows, the tile's x0 and yr0, and the four span bounds.
__host__ __device__ __forceinline__ int emit_smem(int W) {
  return 16 + 4 * (EMIT_ROWS * emit_row_floats(W) + 2 * EMIT_TILE + 4);
}

struct EmitParams {
  const int* x0;
  const int* yr0;
  const float* xarr;
  const float* evr;
  float* E;
  int Dp, De, W, lXp, lYp, nrow;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects ``bytes`` of asynchronous copies.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_inval(unsigned long long* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Bulk copy (TMA) of ``bytes`` (a multiple of 16; both addresses on 16
// bytes) from device memory into this block's shared memory, completing on
// the mbarrier.
__device__ __forceinline__ void bulk_to_shared(void* dst, const void* src, unsigned bytes,
                                               unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void emit_store(float* p, float v) {
#if EMIT_STREAM_STORE
  __stcs(p, v);
#else
  *p = v;
#endif
}

// One cell at lane j of the output row o (3 x W floats): channel 0 gapX,
// 1 match, 2 gapY.  xb[r * xst + xi] is x-pack row r at the clamped column,
// yb[k * yst + yi] event row k (shared rows or device memory).
__device__ __forceinline__ void emit_cell(const float* xb, int xst, const float* yb,
                                          int yst, int xi, int yi, float* o, int W,
                                          int j) {
  const float mean = yb[yi];
  const float noise = yb[yst + yi];
  float g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float obs = (k & 1) ? noise : mean;
    const float* r = xb + 3 * k * xst + xi;
    const float a = __fmul_rn(__fsub_rn(obs, r[0]), r[xst]);
    g[k] = fmaxf(__fsub_rn(r[2 * xst], __fmul_rn(__fmul_rn(0.5f, a), a)), NEG_INF);
  }
  emit_store(o + j, xb[12 * xst + xi]);                              // gapX
  emit_store(o + W + j, fmaxf(__fadd_rn(g[0], g[1]), NEG_INF));      // match
  emit_store(o + 2 * W + j, fmaxf(__fadd_rn(g[2], g[3]), NEG_INF));  // gapY
}

// The tile's rows i < nt (i >= n: zero), thread t at lane t % W; the rows'
// clamped columns less xsh / ysh index xb / yb.
__device__ __forceinline__ void emit_tile(const EmitParams& p, const int* sx0,
                                          const int* sy0, const float* xb, int xst,
                                          int xsh, const float* yb, int yst, int ysh,
                                          float* out, int n, int nt) {
  const int W = p.W, j = threadIdx.x % W, step = blockDim.x / W;
  for (int i = threadIdx.x / W; i < nt; i += step) {
    float* o = out + (size_t)i * 3 * W;
    if (i >= n) {
      emit_store(o + j, 0.0f);
      emit_store(o + W + j, 0.0f);
      emit_store(o + 2 * W + j, 0.0f);
      continue;
    }
    const int xi = min(max(sx0[i] + j, 0), p.lXp - 1) - xsh;
    const int yi = min(max(sy0[i] + j, 0), p.lYp - 1) - ysh;
    emit_cell(xb, xst, yb, yst, xi, yi, o, W, j);
  }
}

__global__ void __launch_bounds__(1024) emissions_kernel(EmitParams p) {
  extern __shared__ __align__(16) float esm[];
  constexpr int K = EMIT_TILE;
  const int W = p.W, RS = emit_row_floats(W), tid = threadIdx.x;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(esm);
  float* rows = esm + 4;
  int* sx0 = reinterpret_cast<int*>(rows + EMIT_ROWS * RS);
  int* sy0 = sx0 + K;
  int* span = sy0 + K;  // min and max of the tile's x0, then of its yr0
  const int b = blockIdx.y, d0 = blockIdx.x * K;
  const int n = min(K, p.Dp - d0);  // the tile's diagonals below Dp (<= 0: none)
  const int nt = min(K, p.De - d0);
  float* out = p.E + ((size_t)b * p.De + d0) * 3 * W;
  const float* xa = p.xarr + (size_t)b * N_XPARAMS * p.lXp;
  const float* ev = p.evr + (size_t)b * 2 * p.lYp;

  if (tid == 0) {
    span[0] = span[2] = INT_MAX;
    span[1] = span[3] = INT_MIN;
    mbar_init(bar);
  }
  __syncthreads();
  for (int i = tid; i < ((n + 31) & ~31); i += blockDim.x) {  // whole warps
    const bool v = i < n;
    const int xs = v ? p.x0[(size_t)b * p.nrow + d0 + i] : 0;
    const int ys = v ? p.yr0[(size_t)b * p.nrow + d0 + i] : 0;
    if (v) {
      sx0[i] = xs;
      sy0[i] = ys;
    }
    const int xmn = __reduce_min_sync(0xffffffffu, v ? xs : INT_MAX);
    const int xmx = __reduce_max_sync(0xffffffffu, v ? xs : INT_MIN);
    const int ymn = __reduce_min_sync(0xffffffffu, v ? ys : INT_MAX);
    const int ymx = __reduce_max_sync(0xffffffffu, v ? ys : INT_MIN);
    if ((i & 31) == 0) {
      atomicMin(span, xmn);
      atomicMax(span + 1, xmx);
      atomicMin(span + 2, ymn);
      atomicMax(span + 3, ymx);
    }
  }
  __syncthreads();
  // the span of clamped columns each row needs
  const int xlo = min(max(span[0], 0), p.lXp - 1);
  const int xhi = (int)min(max((long long)span[1] + W - 1, 0ll), (long long)p.lXp - 1);
  const int ylo = min(max(span[2], 0), p.lYp - 1);
  const int yhi = (int)min(max((long long)span[3] + W - 1, 0ll), (long long)p.lYp - 1);
  const bool aligned = ((p.lXp | p.lYp) & 3) == 0 && ((uintptr_t)p.xarr & 15) == 0 &&
                       ((uintptr_t)p.evr & 15) == 0;
  const bool staged = n > 0 && aligned && xhi - xlo < K - 1 + W && yhi - ylo < K - 1 + W;
  if (!staged) {
    if (tid == 0) mbar_inval(bar);
    emit_tile(p, sx0, sy0, xa, p.lXp, 0, ev, p.lYp, 0, out, n, nt);
    return;
  }

  // shared row r holds the row's columns from its 16-byte boundary base
  // <= lo on; the middle [a0, b0) arrives by bulk copies, the ends
  // [lo, a0) and [b0, hi] (<= 3 columns each) by plain loads
  const int xbase = xlo & ~3, ybase = ylo & ~3;
  const int xa0 = min((xlo + 3) & ~3, xhi + 1), xb0 = max((xhi + 1) & ~3, xa0);
  const int ya0 = min((ylo + 3) & ~3, yhi + 1), yb0 = max((yhi + 1) & ~3, ya0);
  const unsigned xbytes = 4u * (xb0 - xa0), ybytes = 4u * (yb0 - ya0);
  const unsigned total = N_XPARAMS * xbytes + 2 * ybytes;
  if (tid == 0 && total > 0) {
    mbar_expect(bar, total);
    if (xbytes > 0)
      for (int r = 0; r < N_XPARAMS; ++r)
        bulk_to_shared(rows + r * RS + (xa0 - xbase), xa + (size_t)r * p.lXp + xa0, xbytes,
                       bar);
    if (ybytes > 0)
      for (int k = 0; k < 2; ++k)
        bulk_to_shared(rows + (N_XPARAMS + k) * RS + (ya0 - ybase),
                       ev + (size_t)k * p.lYp + ya0, ybytes, bar);
  }
  for (int q = tid; q < EMIT_ROWS * 8; q += blockDim.x) {
    const int r = q >> 3, e = q & 7;
    const bool isx = r < N_XPARAMS;
    const int lo = isx ? xlo : ylo, hi = isx ? xhi : yhi, base = isx ? xbase : ybase;
    const int c = e < 4 ? lo + e : (isx ? xb0 : yb0) + e - 4;
    if (e < 4 ? c < (isx ? xa0 : ya0) : c <= hi) {
      const float* src = isx ? xa + (size_t)r * p.lXp : ev + (size_t)(r - N_XPARAMS) * p.lYp;
      rows[r * RS + (c - base)] = src[c];
    }
  }
  if (total > 0) mbar_wait(bar, 0);
  __syncthreads();
  if (tid == 0) mbar_inval(bar);
  emit_tile(p, sx0, sy0, rows, RS, xbase, rows + N_XPARAMS * RS, RS, ybase, out, n, nt);
}

// ---------------------------------------------------------------------------
// Kernel 2: the recursions (forward F, backward b)
// ---------------------------------------------------------------------------
// Replaces cpecan_signal_tpu/ops/pallas_fb.py:forward_sm3 (_forward_kernel)
// and the recursion of backward_sm3 (_backward_kernel).  Bound: the latency
// of the serial chain of anti-diagonals: diagonal d needs d - 1 and d - 2
// (the backward d + 1 and d + 2), at a few dependent logAdds a lane.
//
// Design: one block per problem, W / LANES_PER_THREAD threads (thread t
// holds lanes t, t + blockDim, ...), the whole diagonal loop in one launch.
// The carries live in two pairs of shared rows of S x (W + 2) floats (a
// NEG_INF halo lane at each end makes the +-1 lane shift a plain offset):
// step i reads the pair the step before wrote (rows d -+ 1 and d -+ 2) and
// writes the other (row d and row d -+ 1 again, shifted as below); one
// __syncthreads a diagonal publishes them.  A step's inputs come from shared
// memory only:
//   * the E rows and diagonal-scalar rows stream through a ring of K slots
//     filled by cp.async K - 2 steps ahead of use; the wait for the next
//     step's group sits just before the diagonal's barrier, which publishes
//     the copies with the carry row.  Step i takes E row i (backward: rows
//     d + 1 and d + 2, the new one d + 1 = d_top + 1 - i) and scalar row d.
//     K comes from ring_depth (as large as RING_MAX and the 227 KB allow);
//     where not even 3 E rows fit beside the carry rows (echelon from
//     W = 736: 17 channels, 7 states) K = 0 and the step reads E and the
//     scalar row from device memory (an instance of its own, so that the
//     staged one reads shared memory with shared loads).
//   * each edge's constants sit in shared records (load_edges), its scalar
//     transition terms summed once per problem (the same adds, in the same
//     order, as summing them on every cell).
//   * rounds: the slot table lists, for round r and state s, the r-th edge
//     into s (forward; backward: out of s) in table order, or the padding
//     edge, whose logAdd is the identity.  A round is straight-line code
//     over NS >= S states (3, 5 or 8, a compile-time count chosen once per
//     launch), so the logAdds of different states overlap, and the states'
//     values stay in registers until the step's stores.  fiveState pads
//     13 edges to 5 rounds x 5 states; packing the states' edge chains into
//     fewer slots, or running the rounds that only its 5-edge state has as
//     one slot, was measured and dropped (PERF.md, PR 5): either cost the
//     other plans more than it saved.
//   * the logAdd is branch-free and the channel sum of an edge has a
//     compile-time bound (1, 3 or 5 channels), so a round has no branch:
//     the compiler turned both into branches at first, which ran every
//     edge's loads and logAdd one after the other.
// Lanes a thread: 1.  At 2 and 4 lanes a thread (fewer warps, no fewer
// instructions) the forward took 5.763 and 10.239 ms against 2.944 (same
// call as above): a step is bound by instruction issue, each warp on its own
// scheduler, not by the barrier.
// Offsets.  A row is stored relative to an offset of its own, held in f64
// (out is F + off absolute): absolute values reach the job's
// log-likelihood, about -1e5 at 1e5 diagonals, where f32 rounds each cell
// by 2^-7 and exp(F + b - total) carries 0.4 % of error into a posterior.
// Step d subtracts a shift sh from its new row and from the row before it
// (rewritten into the pair it writes, as the next step's middle source;
// the thread rewrites its own lanes, so no other barrier is needed: the
// forward keeps them in registers from the step before, the backward loads
// them before the step's stores, each the faster of the two in one A/B at
// W = 128, Dp = 4096, B = 64 (PERF.md, Findings PR 9); loaded after the
// stores, every load waited behind them, 5-20 % slower) and
// adds sh to the running offset, written to off[d] by thread 0.  sh is the
// maximum of the start (end) vector at the first step, 0 at the second,
// then the maximum of row d -+ 2 as stored less the previous shift, so that
// the offset tracks the absolute maximum two diagonals back.  A row's
// maximum costs no barrier: each thread keeps the maximum of what it
// wrote, the next step reduces it by warp shuffles into a per-warp shared
// slot (two sets, by parity) before that step's barrier, and the step after
// reads the slots (a redux.sync on the floats' order-preserving int bits
// in place of the shuffles took as long: 3.543 against 3.555 ms, forward
// at W = 128, Dp = 4096, B = 64).  ops/fb_kernels.forward_sm3_ref and backward_sm3_ref
// take the same steps.
// The backward recursion writes b to device memory (work) and stops; its
// epilogue is kernel 3.
struct RecParams {
  const float* E;
  const int* ds;
  const int* d_last;
  const float* init;  // forward: start (B, S); backward: end (B, S)
  const float* tps;
  const int* edges;
  float* out;   // forward: F; backward: b
  double* off;  // (B, Dp) the offset each row of out is stored against
  int Dp, De, C, S, W, n_tp, n_edges, ds_rows, K;
};

// The 4 carry rows of S x (W + 2) floats (two pairs), padded to 16 bytes
// (the E ring follows them).
__host__ __device__ __forceinline__ int carry_floats(int S, int W) {
  return (4 * S * (W + 2) + 3) & ~3;
}

// The shift a step takes from a row maximum: 0.0 where the row holds no cell
// above SHIFT_FLOOR (ops/fb_kernels._shift_of).
__device__ __forceinline__ float shift_of(float m) { return m > SHIFT_FLOOR ? m : 0.0f; }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// cp.async.wait_group takes an immediate: n = K - 3 < RING_MAX - 2.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
#define WAIT_CASE(N) \
  case N:            \
    asm volatile("cp.async.wait_group " #N ";\n" ::: "memory"); \
    break;
    WAIT_CASE(0) WAIT_CASE(1) WAIT_CASE(2) WAIT_CASE(3) WAIT_CASE(4)
    WAIT_CASE(5) WAIT_CASE(6) WAIT_CASE(7) WAIT_CASE(8)
#undef WAIT_CASE
    default:
      asm volatile("cp.async.wait_group 9;\n" ::: "memory");
  }
}
static_assert(RING_MAX - 3 <= 9, "cp_async_wait covers wait counts up to 9");

// Issue the copies of ring step g (a group is committed by the caller):
// E row (forward g, backward d_top + 1 - g) and the diagonal-scalar row
// (forward g, backward d_top - g; none for the backward's step -1).
template <bool BACKWARD>
__device__ __forceinline__ void ring_issue(const RecParams& p, const float* Eb,
                                           const int* dsb, float* ering,
                                           int* dsring, int g, int slot,
                                           int n_steps, int dtop, bool vec) {
  if (g >= n_steps) return;
  const int CW = p.C * p.W;
  const float* src = Eb + (size_t)(BACKWARD ? dtop + 1 - g : g) * CW;
  float* dst = ering + (size_t)slot * CW;
  if (vec) {
    for (int q = threadIdx.x; q < CW / 4; q += blockDim.x)
      cp_async16(dst + 4 * q, src + 4 * q);
  } else {
    for (int q = threadIdx.x; q < CW; q += blockDim.x) cp_async4(dst + q, src + q);
  }
  if (g >= 0 && threadIdx.x < 8)
    cp_async4(dsring + slot * 8 + threadIdx.x,
              dsb + (size_t)(BACKWARD ? dtop - g : g) * 8 + threadIdx.x);
}

template <bool BACKWARD, int NS, int NCH, bool STAGED>
__device__ __forceinline__ void recursion_steps(const RecParams& p, const EdgeRec* recs,
                                                const unsigned char* slot, int rounds,
                                                const float* sh_init, float sh0,
                                                float* carry, float* wmax, float* ering,
                                                int* dsring, int dtop, int dlast,
                                                bool vec) {
  constexpr int NL = LANES_PER_THREAD;
  const int b = blockIdx.x;
  const int S = p.S, W = p.W, WP = W + 2, C = p.C, K = p.K;
  const int NT = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_steps = dtop + 1;
  const int CW = C * W, SWP = S * WP;
  const float* Eb = p.E + (size_t)b * p.De * CW;
  const int* dsb = p.ds + (size_t)b * p.ds_rows * 8;
  float* outb = p.out + (size_t)b * p.Dp * S * W;
  double* offb = p.off + (size_t)b * p.Dp;

  // ring slots of steps i, i - 1 and i + K - 2
  int s_cur = 0, s_prev = K - 1, s_new = K - 2;
  double off = 0.0;
  float sh_last = 0.0f;
  float tmax = NEG_INF;  // this thread's maximum of the row it wrote last
  // and that row's values at its lanes (the forward keeps them from step to
  // step; the backward loads them from the carry each step)
  float last[NL][NS];
#pragma unroll
  for (int q = 0; q < NL; ++q)
#pragma unroll
    for (int s = 0; s < NS; ++s) last[q][s] = NEG_INF;
  for (int i = 0; i < n_steps; ++i) {
    if (STAGED) {
      ring_issue<BACKWARD>(p, Eb, dsb, ering, dsring, i + K - 2, s_new, n_steps, dtop,
                           vec);
      cp_async_commit();
    }
    const int d = BACKWARD ? dtop - i : i;
    const int* row = STAGED ? dsring + s_cur * 8 : dsb + (size_t)d * 8;
    // forward: E[d]; backward: E[d + 1] (Ea) and E[d + 2] (Ec)
    const float* Ea = STAGED ? ering + s_cur * CW : Eb + (size_t)(BACKWARD ? d + 1 : d) * CW;
    const float* Ec = STAGED ? ering + s_prev * CW : Eb + (size_t)(d + 2) * CW;
    s_prev = s_cur;
    s_cur = s_cur + 1 == K ? 0 : s_cur + 1;
    s_new = s_new + 1 == K ? 0 : s_new + 1;
    const int w0 = row[DS_W0], xl = row[DS_XMYL], xr = row[DS_XMYR];
    // the lower, middle and upper sources' lane shifts, and their carry rows
    // in the pair rp (lower and upper: d -+ 1, middle: d -+ 2) with the
    // shift folded in; this step writes the pair wp
    const int rp = (i & 1) ^ 1, wp = i & 1;
    const int shL = BACKWARD ? sgn(row[DS_BL]) : sgn(row[DS_FL]);
    const int shU = BACKWARD ? sgn(row[DS_BL] - 1) : sgn(row[DS_FL] + 1);
    const int shM = BACKWARD ? sgn(row[DS_BM]) : sgn(row[DS_FM]);
    const int oL = 2 * rp * SWP + shL, oU = 2 * rp * SWP + shU,
              oM = (2 * rp + 1) * SWP + shM;
    // this warp's maximum of row d -+ 1, and the block's of row d -+ 2 from
    // the slots the last barrier published
    const float wm = warp_max(tmax);
    const float m2 = warp_max(lane < (NT >> 5) ? wmax[rp * 32 + lane] : NEG_INF);

    float acc[NL][NS];
#pragma unroll
    for (int q = 0; q < NL; ++q)
#pragma unroll
      for (int s = 0; s < NS; ++s) acc[q][s] = NEG_INF;
    if (BACKWARD || d > 0) {
#pragma unroll 2
      for (int r = 0; r < rounds; ++r) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const EdgeRec er = recs[slot[r * MAX_S + s]];
          const int src = rec_src(er);
          const bool lower = src == SRC_LOWER, middle = src == SRC_MIDDLE;
          // forward: F_src[frm] + E[d] at lane j; backward: b_src[to] at
          // lane j + sh + E_src at j + sh (0.0 outside the window)
          const int o = (lower ? oL : (middle ? oM : oU)) + rec_off(er);
#pragma unroll
          for (int q = 0; q < NL; ++q) {
            const int j = tid + q * NT;
            float val;
            if (BACKWARD) {
              const int jj = j + (lower ? shL : (middle ? shM : shU));
              const float ev = rec_esum<NCH>(middle ? Ec : Ea, er, min(max(jj, 0), W - 1));
              val = __fadd_rn(carry[o + j], (jj >= 0 && jj < W) ? ev : 0.0f);
            } else {
              val = __fadd_rn(carry[o + j], rec_esum<NCH>(Ea, er, j));
            }
            acc[q][s] = ladd(acc[q][s], rec_add_t(val, er));
          }
        }
      }
    }
    // the start (forward, d = 0) or end vector (backward, d = d_last)
    // replaces the recursion's value; cells off the band are NEG_INF; the
    // new row and the row before it both less the step's shift
    const bool at_init = BACKWARD ? d == dlast : d == 0;
    const float sh = at_init ? sh0 : (m2 > SHIFT_FLOOR ? __fsub_rn(m2, sh_last) : 0.0f);
    float* cur = carry + 2 * wp * SWP + 1;
    float* old = cur + SWP;
    float* outd = outb + (size_t)d * S * W;
    if (BACKWARD) {
      // loaded before the stores, behind which the compiler would keep each
      // load (the rows may alias)
      const float* prev = carry + 2 * rp * SWP + 1;
#pragma unroll
      for (int q = 0; q < NL; ++q)
#pragma unroll
        for (int s = 0; s < NS; ++s)
          if (s < S) last[q][s] = prev[s * WP + tid + q * NT];
    }
    float tm = NEG_INF;
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      const int j = tid + q * NT;
      const int xmy = w0 + 2 * j;
      const bool valid = xmy >= xl && xmy <= xr;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (s < S) {
          float v = at_init ? sh_init[s] : acc[q][s];
          v = valid ? __fsub_rn(v, sh) : NEG_INF;
          cur[s * WP + j] = v;
          outd[s * W + j] = v;
          old[s * WP + j] = __fsub_rn(last[q][s], sh);
          if (!BACKWARD) last[q][s] = v;
          tm = fmaxf(tm, v);
        }
      }
    }
    off += (double)sh;
    if (tid == 0) offb[d] = off;
    if (lane == 0) wmax[wp * 32 + warp] = wm;
    tmax = tm;
    sh_last = sh;
    if (STAGED) cp_async_wait(K - 3);
    __syncthreads();
  }
  // the rows no step wrote: past d_last for the forward (F there is
  // NEG_INF), above d_top for the backward
  for (int d = dtop + 1 + tid; d < p.Dp; d += NT) offb[d] = BACKWARD ? 0.0 : off;
}

// Thread 0 plans the rounds: slot[r * MAX_S + s] is the r-th edge of state
// s (key: to-state, backward from-state) in table order, or MAX_EDGES (the
// padding edge).  Returns the rounds (the most edges of a state) and in
// *nch the most E channels of an edge.
__device__ int build_rounds(const int* __restrict__ edges, int n_edges, bool by_frm,
                            unsigned char* slot, int* nch) {
  int cnt[MAX_S];
  for (int s = 0; s < MAX_S; ++s) cnt[s] = 0;
  for (int i = 0; i < MAX_EDGES * MAX_S; ++i) slot[i] = MAX_EDGES;
  int rounds = 0;
  *nch = 1;
  for (int e = 0; e < n_edges; ++e) {
    const int* er = edges + e * EDGE_COLS;
    const int s = er[by_frm ? 1 : 2];
    slot[cnt[s] * MAX_S + s] = (unsigned char)e;
    rounds = max(rounds, ++cnt[s]);
    for (int k = 0; k < MAX_IDS; ++k)
      if (er[4 + MAX_IDS + k] >= 0) *nch = max(*nch, 2 + k);
  }
  return rounds;
}

// The step loop at a compile-time bound on the edges' channels.
template <bool BACKWARD, int NS>
__device__ __forceinline__ void recursion_nch(int nch, const RecParams& p,
                                              const EdgeRec* recs,
                                              const unsigned char* slot, int rounds,
                                              const float* sh_init, float sh0,
                                              float* carry, float* wmax, float* ering,
                                              int* dsring, int dtop, int dlast,
                                              bool vec) {
  if (nch <= 1)
    recursion_steps<BACKWARD, NS, 1, true>(p, recs, slot, rounds, sh_init, sh0, carry,
                                           wmax, ering, dsring, dtop, dlast, vec);
  else if (nch <= 3)
    recursion_steps<BACKWARD, NS, 3, true>(p, recs, slot, rounds, sh_init, sh0, carry,
                                           wmax, ering, dsring, dtop, dlast, vec);
  else
    recursion_steps<BACKWARD, NS, 1 + MAX_IDS, true>(p, recs, slot, rounds, sh_init, sh0,
                                                     carry, wmax, ering, dsring, dtop,
                                                     dlast, vec);
}

template <bool BACKWARD>
__global__ void __launch_bounds__(RECURSION_THREADS) recursion_kernel(RecParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ EdgeRec recs[MAX_EDGES + 1];
  __shared__ unsigned char slot[MAX_EDGES * MAX_S];
  __shared__ int sh_rounds, sh_nch;
  __shared__ float sh_init[MAX_S];
  __shared__ float wmax[2 * 32];  // per-warp row maxima, two sets by parity
  const int b = blockIdx.x;
  const int S = p.S, W = p.W, WP = W + 2, C = p.C, K = p.K;
  float* carry = smem;
  float* ering = carry + carry_floats(S, W);  // 16-byte aligned for cp.async
  int* dsring = (int*)(ering + (size_t)K * C * W);
  load_edges(p.edges, p.tps + (size_t)b * p.n_tp, p.n_edges, W, BACKWARD, recs);
  if (threadIdx.x == 0)
    sh_rounds = build_rounds(p.edges, p.n_edges, BACKWARD, slot, &sh_nch);
  if (threadIdx.x < S) sh_init[threadIdx.x] = p.init[(size_t)b * S + threadIdx.x];
  for (int i = threadIdx.x; i < 4 * S * WP; i += blockDim.x) carry[i] = NEG_INF;
  if (threadIdx.x < 2 * 32) wmax[threadIdx.x] = NEG_INF;

  const int dlast = p.d_last[b];
  const int dtop = min(dlast, p.Dp - 1);
  if (!BACKWARD) {  // every cell past d_last is outside the problem
    float* Fb = p.out + (size_t)b * p.Dp * S * W;
    const size_t from = (size_t)max(dtop + 1, 0) * S * W;
    for (size_t i = from + threadIdx.x; i < (size_t)p.Dp * S * W; i += blockDim.x)
      Fb[i] = NEG_INF;
  }
  // cp.async.cg takes 16-byte aligned rows: E's rows are C x W floats (W a
  // multiple of 32), so only the base pointer can break it
  const bool vec = ((uintptr_t)p.E & 15) == 0;
  const float* Eb = p.E + (size_t)b * p.De * C * W;
  const int* dsb = p.ds + (size_t)b * p.ds_rows * 8;
  if (K) {
    // steps 0 .. K - 3 ahead of the loop (the backward's E[d_top + 2] rides
    // in the first group), then wait for step 0
    for (int g = BACKWARD ? -1 : 0; g <= K - 3; ++g) {
      ring_issue<BACKWARD>(p, Eb, dsb, ering, dsring, g, (g + K) % K, dtop + 1, dtop,
                           vec);
      if (g >= 0) cp_async_commit();
    }
    cp_async_wait(K - 3);
  }
  __syncthreads();
  const int rounds = sh_rounds, nch = sh_nch;
  // the first step's shift: the maximum of the start (end) vector
  float m0 = NEG_INF;
  for (int s = 0; s < S; ++s) m0 = fmaxf(m0, sh_init[s]);
  const float sh0 = shift_of(m0);
  if (K == 0)  // no ring: E and the scalar rows from device memory, any plan
    recursion_steps<BACKWARD, MAX_S, 1 + MAX_IDS, false>(p, recs, slot, rounds, sh_init,
                                                         sh0, carry, wmax, ering, dsring,
                                                         dtop, dlast, vec);
  else if (S <= 3)
    recursion_nch<BACKWARD, 3>(nch, p, recs, slot, rounds, sh_init, sh0, carry, wmax,
                               ering, dsring, dtop, dlast, vec);
  else if (S <= 5)
    recursion_nch<BACKWARD, 5>(nch, p, recs, slot, rounds, sh_init, sh0, carry, wmax,
                               ering, dsring, dtop, dlast, vec);
  else
    recursion_nch<BACKWARD, MAX_S>(nch, p, recs, slot, rounds, sh_init, sh0, carry, wmax,
                                   ering, dsring, dtop, dlast, vec);
}

// ---------------------------------------------------------------------------
// Kernel 3: backward epilogue: per-diagonal totals and posteriors (stages 3,
// 4), stage-4 per-edge posteriors
// ---------------------------------------------------------------------------
// Replaces the rest of cpecan_signal_tpu/ops/pallas_fb.py:backward_sm3
// (_backward_kernel) at stage 3 (EM = false), with the match posterior or
// the echelon per-state posteriors (pstates, :537-547), and at stage 4 with
// window groups (EM = true), with the match posterior or the per-edge-group
// posterior channels (pgroups, :535, :579-599), with one problem per row
// (nh = 1).
// Bound: device-memory bytes (F, b and E read, P written); no chain.
//
// Why a kernel of its own, with b in device memory, and not warps of the
// recursion block trailing it through a shared ring: the recursion is
// bound by instruction issue (the lanes-per-thread measurement above), and
// the epilogue's work is large beside it.  At W = 128, Dp = 4096, B = 64 the
// stage-3 epilogue takes 1.056 ms on all 132 SMs (torch.profiler, same
// build), about 0.5 us of SM time a diagonal against the recursion's 0.77
// us a step (3.135 ms), so on the recursion's own SM it would take issue
// slots from the chain on every step.  As its own kernel it runs at the
// card's width after the chain, where a bucket of few long problems (realign:
// 5 of about 200 k diagonals) leaves most SMs idle.  The price is b in
// device memory: a workspace as large as F, which the symbol lane's bucket
// size counts (readpath.BUCKET_CELLS).
//
// Design: one warp per (problem, diagonal), EPI_WARPS or fewer a block (as
// many as their scratch fits).  Thread t holds lanes t, t + 32, ...: each
// 32-lane group is summed by a warp butterfly and the groups are added in
// order, the reduction order of the plain versions' _block_sum, without a
// block barrier.  Pass 1 forms v1 = F[d] + b[d] + mask and v2 = c + b[d+1]
// (c extends F[d-1] by the MIDDLE edges onto diagonal d+1's grid) into the
// warp's scratch and their maxima; pass 2 sums exp(v - max) per lane over
// the states and over the lanes; the total is lse(v1) ladd lse(v2).  Then
// the posteriors exp(min(F + b - total, 0)) of the states in pmask (the
// match state alone without PSTATES), masked to x > 0 and y > 0.
//
// Offsets: F[d] and b[d] are stored relative to offF[d] and offB[d] (Kernel
// 2), so v1 and the total are relative to offF[d] + offB[d]; v2 adds the
// f32 difference of (offF[d-1] + offB[d+1]) from that, and a stage-4 term
// of F[d-1] or F[d-2] that of offF[d-1] or offF[d-2] from offF[d].  The
// totals output holds the absolute total, ((f64) total + offF[d]) +
// offB[d] stored as f32: the carry kernel's likelihood lane sums it.
//
// Stage 4 (the EM E-step's tallies, ops/pallas_fb.py:559-624) adds one
// posterior per edge and cell, exp(min(F_src[frm] + b[to] + E[d] + tp -
// total, 0)) with F[d-1] / F[d-2] read at the forward's shifts of row d:
// their sums over the lanes per edge go to work (the carry kernel adds them
// over the diagonals), the sums over each window group's edges per lane to
// work (the carry kernel carries them), and with PGROUPS the sums over each
// edge group, in edge order, to P's channels in place of the match
// posterior.
struct EpiParams {
  const float* E;
  const float* F;
  const double* offF;  // (B, Dp) F's offsets
  const float* bw;     // b (B, Dp, S, W) from the backward recursion
  const double* offB;  // (B, Dp) b's offsets
  const int* ds;
  const int* d_last;
  const float* tps;
  const int* edges;
  float* P;
  float* T;
  float* pg;    // stage 4: (B, Dp, G, W) window-group sums
  float* part;  // stage 4: (B, Dp, n_edges) per-edge lane sums
  int Dp, De, C, S, W, n_tp, n_edges, ds_rows, G, NP;
  unsigned pmask, gm[MAX_G];
  ChannelGroups pgm;
};

template <bool EM, bool PSTATES, bool PGROUPS>
__global__ void __launch_bounds__(EPI_THREADS) epilogue_kernel(EpiParams p) {
  extern __shared__ __align__(16) float scratch[];
  __shared__ EdgeRec recs[MAX_EDGES + 1];
  __shared__ unsigned char mid[MAX_EDGES];
  __shared__ unsigned pch_of[MAX_EDGES];
  __shared__ int sh_nmid;
  const int b = blockIdx.y;
  const int S = p.S, W = p.W, C = p.C, NL = W / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  load_edges(p.edges, p.tps + (size_t)b * p.n_tp, p.n_edges, W, false, recs);
  if (threadIdx.x == 0) {
    int n = 0;
    for (int e = 0; e < p.n_edges; ++e)
      if (p.edges[e * EDGE_COLS] == SRC_MIDDLE) mid[n++] = (unsigned char)e;
    sh_nmid = n;
  }
  if (PGROUPS) {
    for (int e = threadIdx.x; e < p.n_edges; e += blockDim.x) {
      unsigned cm = 0u;
      for (int c = 0; c < p.NP; ++c)
        if ((p.pgm.m[c] >> e) & 1ull) cm |= 1u << c;
      pch_of[e] = cm;
    }
  }
  __syncthreads();
  const int dlast = p.d_last[b];
  const int d = blockIdx.x * nwarps + warp;
  if (d >= p.Dp) return;
  const int NP = p.NP;
  float* Pd = p.P + ((size_t)b * p.Dp + d) * NP * W;
  if (d > dlast) {  // b = NEG_INF, total = NEG_INF, posterior 0 exactly
    for (int i = lane; i < NP * W; i += 32) Pd[i] = 0.0f;
    if (lane == 0) p.T[(size_t)b * p.Dp + d] = NEG_INF;
    return;
  }
  const int nmid = sh_nmid;
  const int* row = p.ds + ((size_t)b * p.ds_rows + d) * 8;
  const int w0 = row[DS_W0], xl = row[DS_XMYL], xr = row[DS_XMYR];
  const int sM1 = sgn(row[8 + DS_FM]);
  const size_t SW = (size_t)S * W;
  const float* Fb = p.F + (size_t)b * p.Dp * SW;
  const float* Fd = Fb + d * SW;
  const float* bd = p.bw + ((size_t)b * p.Dp + d) * SW;
  const bool has_b1 = d + 1 <= min(dlast, p.Dp - 1);
  const float* E1 = p.E + ((size_t)b * p.De + d + 1) * C * W;
  // the other diagonals' offsets against offF[d] + offB[d], as f32
  const double* oF = p.offF + (size_t)b * p.Dp;
  const double* oB = p.offB + (size_t)b * p.Dp;
  const float dF1 = d >= 1 ? (float)(oF[d - 1] - oF[d]) : 0.0f;
  const float dF2 = d >= 2 ? (float)(oF[d - 2] - oF[d]) : 0.0f;
  const float dv2 =
      d >= 1 && has_b1 ? (float)((oF[d - 1] - oF[d]) + (oB[d + 1] - oB[d])) : 0.0f;
  float* v1s = scratch + (size_t)warp * (2 * SW + (EM ? 32 * p.n_edges : 0));
  float* v2s = v1s + SW;

  // pass 1: v1, v2 and their maxima
  float m1 = -3.4e38f, m2 = -3.4e38f;
  for (int k = 0; k < NL; ++k) {
    const int j = lane + 32 * k;
    const int xmy = w0 + 2 * j;
    const float vmask = (xmy >= xl && xmy <= xr) ? 0.0f : NEG_INF;
    float c[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) c[s] = NEG_INF;
    for (int i = 0; i < nmid; ++i) {
      const EdgeRec er = recs[mid[i]];
      const int jj = j + sM1;
      const float f = Fb[max(d - 1, 0) * SW + rec_frm(er) * W + min(max(jj, 0), W - 1)];
      const float fv = (d >= 1 && jj >= 0 && jj < W) ? f : NEG_INF;
      const float val = rec_add_t(__fadd_rn(fv, rec_esum<1 + MAX_IDS>(E1, er, j)), er);
      const int to = rec_to(er);
#pragma unroll
      for (int s = 0; s < MAX_S; ++s)
        if (s == to) c[s] = ladd(c[s], val);
    }
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < S) {
        const float v1 = __fadd_rn(__fadd_rn(Fd[s * W + j], bd[s * W + j]), vmask);
        const float v2 =
            __fadd_rn(__fadd_rn(c[s], has_b1 ? bd[SW + s * W + j] : NEG_INF), dv2);
        v1s[s * W + j] = v1;
        v2s[s * W + j] = v2;
        m1 = fmaxf(m1, v1);
        m2 = fmaxf(m2, v2);
      }
    }
  }
  m1 = warp_max(m1);
  m2 = warp_max(m2);
  // pass 2: the sums, lane group by lane group in order
  float s1 = 0.0f, s2 = 0.0f;
  for (int k = 0; k < NL; ++k) {
    const int j = lane + 32 * k;
    float l1 = 0.0f, l2 = 0.0f;
    for (int s = 0; s < S; ++s) {
      l1 = __fadd_rn(l1, expf(__fsub_rn(v1s[s * W + j], m1)));
      l2 = __fadd_rn(l2, expf(__fsub_rn(v2s[s * W + j], m2)));
    }
    l1 = warp_sum(l1);
    l2 = warp_sum(l2);
    s1 = k == 0 ? l1 : __fadd_rn(s1, l1);
    s2 = k == 0 ? l2 : __fadd_rn(s2, l2);
  }
  const float t1 = lse_finish(m1, s1);
  const float t2 = lse_finish(m2, s2);
  const float total = (d >= 1 && d < p.Dp - 1) ? ladd(t1, t2) : t1;
  if (lane == 0) p.T[(size_t)b * p.Dp + d] = (float)(((double)total + oF[d]) + oB[d]);

  // posteriors of the states in pmask, masked to x > 0 and y > 0 (v1 is
  // F + b there: the mask adds 0.0); with edge groups P is written below
  if (!PGROUPS) {
    for (int k = 0; k < NL; ++k) {
      const int j = lane + 32 * k;
      const int xmy = w0 + 2 * j;
      const bool pos_ok = xmy >= xl && xmy <= xr && xmy > -d && xmy < d;
      int pc = 0;
      for (int s = 0; s < S; ++s) {
        if ((p.pmask >> s) & 1u) {
          const float pv = expf(fminf(__fsub_rn(v1s[s * W + j], total), 0.0f));
          Pd[pc * W + j] = pos_ok ? pv : 0.0f;
          if (!PSTATES) break;
          ++pc;
        }
      }
    }
  }

  if (EM) {
    // per-edge posteriors of diagonal d (d >= 1, band cells), summed in the
    // plain version's order: src + b[to], + E channels, + tp terms, - total
    float* lsum = v2s + SW;  // lsum[e * 32 + lane]: this lane's edge sums
    const int n_edges = p.n_edges;
    for (int e = 0; e < n_edges; ++e) lsum[e * 32 + lane] = 0.0f;
    const int shL = sgn(row[DS_FL]);
    const int shU = sgn(row[DS_FL] + 1);
    const int shM = sgn(row[DS_FM]);
    const float* Ed = p.E + ((size_t)b * p.De + d) * C * W;
    for (int k = 0; k < NL; ++k) {
      const int j = lane + 32 * k;
      const int xmy = w0 + 2 * j;
      const bool em_ok = xmy >= xl && xmy <= xr && d >= 1;
      float pg[MAX_G], pch[MAX_S];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) pg[g] = 0.0f;
#pragma unroll
      for (int c = 0; c < MAX_S; ++c) pch[c] = 0.0f;
      for (int e = 0; e < n_edges; ++e) {
        const EdgeRec er = recs[e];
        const int src = rec_src(er);
        const int sh = src == SRC_LOWER ? shL : (src == SRC_MIDDLE ? shM : shU);
        const int dd = src == SRC_MIDDLE ? d - 2 : d - 1;
        const int jj = j + sh;
        const float f = Fb[max(dd, 0) * SW + rec_frm(er) * W + min(max(jj, 0), W - 1)];
        const float fv = __fadd_rn((dd >= 0 && jj >= 0 && jj < W) ? f : NEG_INF,
                                   src == SRC_MIDDLE ? dF2 : dF1);
        const float bto = bd[rec_to(er) * W + j];
        const float logp = __fsub_rn(
            rec_add_t(__fadd_rn(__fadd_rn(fv, bto), rec_esum<1 + MAX_IDS>(Ed, er, j)), er), total);
        const float pe = em_ok ? expf(fminf(logp, 0.0f)) : 0.0f;
        lsum[e * 32 + lane] = __fadd_rn(lsum[e * 32 + lane], pe);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < p.G && e < 32 && ((p.gm[g] >> e) & 1u)) pg[g] = __fadd_rn(pg[g], pe);
        if (PGROUPS) {
          const unsigned cm = pch_of[e];
#pragma unroll
          for (int c = 0; c < MAX_S; ++c)
            if ((cm >> c) & 1u) pch[c] = __fadd_rn(pch[c], pe);
        }
      }
      float* pgd = p.pg + ((size_t)b * p.Dp + d) * p.G * W;
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < p.G) pgd[g * W + j] = pg[g];
      if (PGROUPS) {
#pragma unroll
        for (int c = 0; c < MAX_S; ++c)
          if (c < NP) Pd[c * W + j] = pch[c];
      }
    }
    float* partd = p.part + ((size_t)b * p.Dp + d) * n_edges;
    for (int e = 0; e < n_edges; ++e) {
      const float v = warp_sum(lsum[e * 32 + lane]);
      if (lane == 0) partd[e] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 4: stage-4 carry: window-group tallies, exits, stats
// ---------------------------------------------------------------------------
// The window groups' tally (ops/pallas_fb.py:600-611) is an ordered pass
// over the diagonals, d_last down to 0: add the diagonal's group sums, let
// lane W-1 leave as exits[d] where the x-window steps (DS_XS), and shift the
// rest one lane right.  Design: one block per problem, one thread per lane
// slot, and no data moves: logical lane j lives in slot (j + base) mod W,
// a shift decrements base and zeroes the slot that left, so a thread only
// adds its slot's sums and no thread waits on another; the loads of
// CARRY_BATCH diagonals go out before their adds.  The same adds in the
// same order as the plain version, so exits and gacc are exact.  Then lane
// e < n_edges of stats sums edge e's lane sums and LIK_LANE the totals of
// d >= 1, from d_last down (the plain version's order over the diagonals,
// the kernel's butterfly within one).
#define CARRY_BATCH 8
#define CARRY_CHUNK 256
__global__ void __launch_bounds__(RECURSION_THREADS)
    carry_kernel(const int* __restrict__ ds, const int* __restrict__ d_last,
                 const float* __restrict__ T, const float* __restrict__ pg,
                 const float* __restrict__ part, float* __restrict__ exits,
                 float* __restrict__ gacc_out, float* __restrict__ stats, int Dp, int W,
                 int G, int n_edges, int ds_rows) {
  __shared__ unsigned char stp[CARRY_CHUNK];
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int dlast = d_last[b];
  const int dtop = min(dlast, Dp - 1);
  const int* dsb = ds + (size_t)b * ds_rows * 8;
  // nothing is tallied above d_last: exits 0 there
  for (int i = t; i < (Dp - 1 - dtop) * G; i += blockDim.x)
    exits[((size_t)b * Dp + dtop + 1) * G + i] = 0.0f;
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.0f;
  int base = 0;
  // CARRY_CHUNK diagonals at a time: their window steps first, into shared
  // memory; then per group CARRY_BATCH diagonals' sums are loaded (their
  // lanes follow from the steps alone) and added in order
  for (int c0 = dtop; c0 >= 0; c0 -= CARRY_CHUNK) {
    const int n = min(CARRY_CHUNK, c0 + 1);
    __syncthreads();
    for (int k = t; k < n; k += blockDim.x) stp[k] = dsb[(size_t)(c0 - k) * 8 + DS_XS] == 1;
    __syncthreads();
    int base_end = base;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      float a = acc[g];
      int bb = base;
      for (int k0 = 0; k0 < n; k0 += CARRY_BATCH) {
        bool step[CARRY_BATCH];
        int jb[CARRY_BATCH];
        float x[CARRY_BATCH];
#pragma unroll
        for (int u = 0; u < CARRY_BATCH; ++u) {
          const int k = min(k0 + u, n - 1);
          step[u] = k0 + u < n && stp[k];
          jb[u] = t - bb < 0 ? t - bb + W : t - bb;  // this slot's logical lane
          x[u] = pg[(((size_t)b * Dp + c0 - k) * G + g) * W + jb[u]];
          if (step[u]) bb = bb == 0 ? W - 1 : bb - 1;
        }
#pragma unroll
        for (int u = 0; u < CARRY_BATCH; ++u) {
          if (k0 + u >= n) break;
          a = __fadd_rn(a, x[u]);
          if (jb[u] == W - 1) {
            exits[((size_t)b * Dp + c0 - k0 - u) * G + g] = step[u] ? a : 0.0f;
            if (step[u]) a = 0.0f;
          }
        }
      }
      acc[g] = a;
      base_end = bb;
    }
    base = base_end;
  }
  const int j = t - base < 0 ? t - base + W : t - base;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G) gacc_out[((size_t)b * G + g) * W + j] = acc[g];
  // stats: lane e < n_edges sums edge e's lane sums and LIK_LANE the totals
  // of d >= 1, over the diagonals from d_last down: the plain version's order
  float* Sb = stats + (size_t)b * STATS_LANES;
  for (int i = t; i < STATS_LANES; i += blockDim.x) {
    const bool lik = i == LIK_LANE && i >= n_edges;
    const float* src = i < n_edges ? part + (size_t)b * Dp * n_edges + i
                                   : T + (size_t)b * Dp;
    const int stride = i < n_edges ? n_edges : 1;
    const int dmin = lik ? 1 : 0;
    float v = 0.0f;
    if (i < n_edges || lik) {
      for (int d0 = dtop; d0 >= dmin; d0 -= CARRY_BATCH) {
        float y[CARRY_BATCH];
#pragma unroll
        for (int u = 0; u < CARRY_BATCH; ++u) y[u] = src[(size_t)max(d0 - u, 0) * stride];
#pragma unroll
        for (int u = 0; u < CARRY_BATCH; ++u)
          if (d0 - u >= dmin) v = __fadd_rn(v, y[u]);
      }
    }
    Sb[i] = v;
  }
}

// ---------------------------------------------------------------------------
// Launch configuration (mirrored by ops/fb_kernels.ring_depth and
// epilogue_warps, which the CPU tests check at every plan and width)
// ---------------------------------------------------------------------------

// E-ring slots of a recursion launch: as many E rows (C x W floats, and an
// 8-int scalar row) as fit beside the 3 carry rows, at most RING_MAX; 0 (no
// ring: E read from device memory) if fewer than 3 fit.
static int ring_depth(int S, int C, int W, size_t* smem) {
  const size_t carry = (size_t)carry_floats(S, W) * sizeof(float);
  const size_t row = (size_t)C * W * sizeof(float) + 8 * sizeof(int);
  size_t k = carry < SMEM_LIMIT ? (SMEM_LIMIT - carry) / row : 0;
  if (k > RING_MAX) k = RING_MAX;
  if (k < 3) k = 0;
  *smem = carry + k * row;
  return (int)k;
}

// Warps (diagonals) of an epilogue block: up to EPI_WARPS whose scratch
// (v1 and v2 rows, and at stage 4 32 lanes of per-edge sums) fits.
static int epilogue_warps(int S, int W, int n_edges, bool em, size_t* smem) {
  const size_t per = ((size_t)2 * S * W + (em ? 32 * (size_t)n_edges : 0)) * sizeof(float);
  size_t n = SMEM_LIMIT / per;
  if (n > EPI_WARPS) n = EPI_WARPS;
  *smem = n * per;
  return (int)n;
}

// Raise the kernel's dynamic shared memory limit on every launch: without
// the opt-in a block gets 48 KB of static and dynamic shared memory
// together, so a dynamic size just under 48 KB would fail beside the static
// arrays.
static cudaError_t allow_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <bool BACKWARD>
static cudaError_t launch_recursion(RecParams p, int B, cudaStream_t stream) {
  size_t smem;
  p.K = ring_depth(p.S, p.C, p.W, &smem);
  cudaError_t err = allow_smem((const void*)recursion_kernel<BACKWARD>, smem);
  if (err != cudaSuccess) return err;
  recursion_kernel<BACKWARD><<<B, p.W / LANES_PER_THREAD, smem, stream>>>(p);
  return cudaGetLastError();
}

// The backward pass: recursion into work, the epilogue, at stage 4 the carry.
template <bool EM, bool PSTATES, bool PGROUPS>
static cudaError_t launch_backward(const float* E, const float* F, const double* offF,
                                   const int* ds,
                                   const int* d_last, const float* end,
                                   const float* tps, const int* edges, float* P,
                                   float* T, float* exits, float* gacc, float* stats,
                                   int B, int Dp, int De, int C, int S, int W,
                                   int n_tp, int n_edges, int ds_rows, unsigned pmask,
                                   int G, const unsigned* gm, const ChannelGroups& pgm,
                                   int NP, float* work, cudaStream_t stream) {
  if (W % LANES_PER_THREAD) return cudaErrorInvalidValue;
  double* offB = reinterpret_cast<double*>(work);
  float* bw = work + (size_t)2 * B * Dp;
  const RecParams rp = {E, ds, d_last, end, tps, edges, bw, offB, Dp, De, C, S, W,
                        n_tp, n_edges, ds_rows, 0};
  cudaError_t err = launch_recursion<true>(rp, B, stream);
  if (err != cudaSuccess) return err;

  EpiParams ep = {};
  ep.E = E; ep.F = F; ep.offF = offF; ep.bw = bw; ep.offB = offB;
  ep.ds = ds; ep.d_last = d_last; ep.tps = tps;
  ep.edges = edges; ep.P = P; ep.T = T;
  ep.pg = bw + (size_t)B * Dp * S * W;
  ep.part = ep.pg + (size_t)B * Dp * G * W;
  ep.Dp = Dp; ep.De = De; ep.C = C; ep.S = S; ep.W = W; ep.n_tp = n_tp;
  ep.n_edges = n_edges; ep.ds_rows = ds_rows; ep.G = G; ep.NP = NP;
  ep.pmask = pmask;
  for (int g = 0; g < MAX_G; ++g) ep.gm[g] = gm[g];
  ep.pgm = pgm;
  size_t smem;
  const int nw = epilogue_warps(S, W, n_edges, EM, &smem);
  err = allow_smem((const void*)epilogue_kernel<EM, PSTATES, PGROUPS>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Dp + nw - 1) / nw, B);
  epilogue_kernel<EM, PSTATES, PGROUPS><<<grid, 32 * nw, smem, stream>>>(ep);
  err = cudaGetLastError();
  if (err != cudaSuccess || !EM) return err;
  carry_kernel<<<B, W, 0, stream>>>(ds, d_last, T, ep.pg, ep.part, exits, gacc, stats,
                                    Dp, W, G, n_edges, ds_rows);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// C interface.  Each function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
// ---------------------------------------------------------------------------

extern "C" {

const char* fb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// The launch configuration the recursion and the epilogue take: ring slots
// and dynamic shared bytes of a recursion, warps and bytes of an epilogue
// block (for the wrappers' mirror of it).
void fb_launch_config(int S, int C, int W, int n_edges, int em, int* cfg) {
  size_t smem;
  cfg[0] = ring_depth(S, C, W, &smem);
  cfg[1] = (int)smem;
  cfg[2] = epilogue_warps(S, W, n_edges, em != 0, &smem);
  cfg[3] = (int)smem;
}

// Blocks of a recursion launch (the forward's, or with backward != 0 the
// backward's) that one SM holds at once at (S, C, W): the occupancy
// calculator's answer for the kernel's registers, its W / LANES_PER_THREAD
// threads and its shared memory.
int fb_recursion_blocks_per_sm(int S, int C, int W, int backward, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem;
  ring_depth(S, C, W, &smem);
  const void* fn = backward ? (const void*)recursion_kernel<true>
                            : (const void*)recursion_kernel<false>;
  err = allow_smem(fn, smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, W / LANES_PER_THREAD,
                                                            smem);
}

// The emissions launch: diagonals a block (EMIT_TILE), floats of a staged
// row, threads and dynamic shared bytes of a block at window width W.
void fb_emissions_config(int W, int* cfg) {
  cfg[0] = EMIT_TILE;
  cfg[1] = emit_row_floats(W);
  cfg[2] = emit_threads(W);
  cfg[3] = emit_smem(W);
}

int fb_emissions_sm3(const int* x0, const int* yr0, const float* xarr,
                     const float* evr, float* E, int B, int Dp, int De, int W,
                     int lXp, int lYp, int nrow, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W % 32 || W > 1024) return (int)cudaErrorInvalidValue;
  err = allow_smem((const void*)emissions_kernel, emit_smem(W));
  if (err != cudaSuccess) return (int)err;
  const EmitParams ep = {x0, yr0, xarr, evr, E, Dp, De, W, lXp, lYp, nrow};
  dim3 grid((De + EMIT_TILE - 1) / EMIT_TILE, B);
  emissions_kernel<<<grid, emit_threads(W), emit_smem(W), (cudaStream_t)stream>>>(ep);
  return (int)cudaGetLastError();
}

// offF (B, Dp) f64: the offset each row of F is stored against.
int fb_forward(const float* E, const int* ds, const int* d_last,
               const float* start, const float* tps, const int* edges, float* F,
               double* offF, int B, int Dp, int De, int C, int S, int W, int n_tp,
               int n_edges, int ds_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (W % LANES_PER_THREAD) return (int)cudaErrorInvalidValue;
  const RecParams rp = {E, ds, d_last, start, tps, edges, F, offF, Dp, De, C, S, W,
                        n_tp, n_edges, ds_rows, 0};
  return (int)launch_recursion<false>(rp, B, (cudaStream_t)stream);
}

// offF: the forward's offsets (fb_forward).
// Stage 3: pmask (bits < S) lists the states of P's channels, in order;
// 1 << match_state for the match posterior alone.  work: backward_work_floats.
int fb_backward_sm3(const float* E, const float* F, const double* offF, const int* ds,
                    const int* d_last, const float* end, const float* tps,
                    const int* edges, float* P, float* T, int B, int Dp, int De,
                    int C, int S, int W, int n_tp, int n_edges, int ds_rows,
                    int pmask, float* work, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (pmask <= 0 || (pmask >> S) != 0) return (int)cudaErrorInvalidValue;
  const unsigned gm[MAX_G] = {0u, 0u, 0u, 0u};
  const ChannelGroups no_groups = {};
  const int np = __builtin_popcount(pmask);
  if (np == 1)
    return (int)launch_backward<false, false, false>(
        E, F, offF, ds, d_last, end, tps, edges, P, T, nullptr, nullptr, nullptr, B, Dp,
        De, C, S, W, n_tp, n_edges, ds_rows, (unsigned)pmask, 0, gm, no_groups, 1,
        work, (cudaStream_t)stream);
  return (int)launch_backward<false, true, false>(
      E, F, offF, ds, d_last, end, tps, edges, P, T, nullptr, nullptr, nullptr, B, Dp, De,
      C, S, W, n_tp, n_edges, ds_rows, (unsigned)pmask, 0, gm, no_groups, np, work,
      (cudaStream_t)stream);
}

// Stage 4: G (1..MAX_G) window groups; gm<g> is group g's edge bitmask
// (bit e = edge e), 0 for the unused groups.
int fb_backward_sm3_em(const float* E, const float* F, const double* offF, const int* ds,
                       const int* d_last, const float* end, const float* tps,
                       const int* edges, float* P, float* T, float* exits,
                       float* gacc, float* stats, int B, int Dp, int De, int C,
                       int S, int W, int n_tp, int n_edges, int ds_rows,
                       int match_state, int G, int gm0, int gm1, int gm2,
                       int gm3, float* work, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G < 1 || G > MAX_G || match_state < 0 || match_state >= S)
    return (int)cudaErrorInvalidValue;
  const unsigned gm[MAX_G] = {(unsigned)gm0, (unsigned)gm1, (unsigned)gm2,
                              (unsigned)gm3};
  const ChannelGroups no_groups = {};
  return (int)launch_backward<true, false, false>(
      E, F, offF, ds, d_last, end, tps, edges, P, T, exits, gacc, stats, B, Dp, De, C, S,
      W, n_tp, n_edges, ds_rows, 1u << match_state, G, gm, no_groups, 1, work,
      (cudaStream_t)stream);
}

// Stage 4 with edge groups: as fb_backward_sm3_em, but P (B, Dp, NPG, W)
// carries the NPG (1..MAX_S) channels of the per-edge posteriors summed
// over the edges of masks[c] (a host array; bit e = edge e < n_edges).
int fb_backward_sm3_pgroups(const float* E, const float* F, const double* offF, const int* ds,
                            const int* d_last, const float* end,
                            const float* tps, const int* edges, float* P,
                            float* T, float* exits, float* gacc, float* stats,
                            int B, int Dp, int De, int C, int S, int W,
                            int n_tp, int n_edges, int ds_rows, int G, int gm0,
                            int gm1, int gm2, int gm3, int NPG,
                            const long long* masks, float* work, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G < 1 || G > MAX_G || NPG < 1 || NPG > MAX_S || n_edges > MAX_EDGES)
    return (int)cudaErrorInvalidValue;
  ChannelGroups groups = {};
  for (int c = 0; c < NPG; ++c) {
    groups.m[c] = (unsigned long long)masks[c];
    if (n_edges < 64 && (groups.m[c] >> n_edges) != 0ull)
      return (int)cudaErrorInvalidValue;
  }
  const unsigned gm[MAX_G] = {(unsigned)gm0, (unsigned)gm1, (unsigned)gm2,
                              (unsigned)gm3};
  return (int)launch_backward<true, false, true>(
      E, F, offF, ds, d_last, end, tps, edges, P, T, exits, gacc, stats, B, Dp, De, C, S,
      W, n_tp, n_edges, ds_rows, 1u, G, gm, groups, NPG, work,
      (cudaStream_t)stream);
}

}  // extern "C"
