// Banded forward-backward kernels of the signal-alignment and EM paths,
// written for Hopper (sm_90a) with a plain C interface (bound from Python with
// ctypes, see ops/_build.py and ops/fb_kernels.py).  The recursions are
// generic over a machine's edge table (threeState, fourState, vanilla,
// echelon); the emissions kernel is threeState's.
//
// Layouts (all row-major, contiguous; B problems, Dp diagonals, W window
// lanes, S states, C emission channels):
//   x0, yr0       (B, nrow >= Dp) int32   per-diagonal slice offsets
//   xarr          (B, 13, lXp)    f32     per-x parameter pack
//   evr           (B, 2, lYp)     f32     reversed event rows (mean, noise)
//   E             (B, De >= Dp+2, C, W)   emissions; rows >= Dp are 0
//   ds            (B, ds_rows >= Dp+1, 8) int32 DS_* scalars (nh = 1)
//   F             (B, Dp, S, W)   forward log-probs
//   P             (B, Dp, P, W)   posteriors of the states in pmask (P = its
//                                 set bits; the match state alone: (B, Dp, W));
//                                 T (B, Dp) totals
//   edges         (n_edges, 12)   int32 edge table (engine/plan.edge_table)
//   exits         (B, Dp, G)      stage 4: window-group mass leaving lane W-1
//   gacc          (B, G, W)       stage 4: window-group tallies left at d = 0
//   stats         (B, 128)        stage 4: lane e = edge-e posterior sum,
//                                 lane LIK_LANE = likelihood
//
// Every float operation that the reference logAdd and the Gaussian pack do
// as separate multiply and add is written with __fmul_rn / __fadd_rn, which
// nvcc never contracts into an FMA, so the card rounds exactly like the
// plain PyTorch versions on the CPU.  expf / logf are the accurate (not the
// fast-math) versions; the file must not be built with --use_fast_math.

#include <cuda_runtime.h>

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

enum { DS_FL = 0, DS_FM, DS_BL, DS_BM, DS_W0, DS_XMYL, DS_XMYR, DS_XS };
enum { SRC_LOWER = 0, SRC_MIDDLE = 1, SRC_UPPER = 2 };

// ---------------------------------------------------------------------------
// Shared device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float horner3(float d, double a, double b, double c,
                                         double e) {
  // ((a*d + b)*d + c)*d + e; the constants round decimal -> f64 -> f32 like
  // the Python float constants of the plain versions
  float v = __fadd_rn(__fmul_rn((float)a, d), (float)b);
  v = __fadd_rn(__fmul_rn(v, d), (float)c);
  return __fadd_rn(__fmul_rn(v, d), (float)e);
}

// Reference logAdd (pairwiseAligner.c:238-255), as ops/pallas_fb._ladd:
// hi + log1p(exp(lo - hi)) by a 4-piece cubic in d = hi - lo, truncated to
// hi for d >= 7.5, saturated at NEG_INF.
__device__ __forceinline__ float ladd(float x, float y) {
  float hi = fmaxf(x, y);
  float lo = fminf(x, y);
  float d = fminf(__fsub_rn(hi, lo), LOG_UNDERFLOW);
  float lut;
  if (d <= 1.0f)
    lut = horner3(d, -0.009350833524763, 0.130659527668286, 0.498799810682272,
                  0.693203116424741);
  else if (d <= 2.5f)
    lut = horner3(d, -0.014532321752540, 0.139942324101744, 0.495635523139337,
                  0.692140569840976);
  else if (d <= 4.5f)
    lut = horner3(d, -0.004605031767994, 0.063427417320019, 0.695956496475118,
                  0.514272634594009);
  else
    lut = horner3(d, -0.000458661602210, 0.009695946122598, 0.930734667215156,
                  0.168037164329057);
  float out = (d >= LOG_UNDERFLOW) ? hi : __fadd_rn(lo, lut);
  return fmaxf(out, NEG_INF);
}

// out[j] = v[j + s] selects on the sign of s only (ops/pallas_fb._shift)
__device__ __forceinline__ int sgn(int s) { return (s > 0) - (s < 0); }

// Sum of an edge's E channels at lane j: emission class, then per-cell
// transition channels, left to right (ops/pallas_fb._esum).
__device__ __forceinline__ float esum(const float* Ed, const int* er, int W,
                                      int j) {
  float v = Ed[er[3] * W + j];
#pragma unroll
  for (int k = 0; k < MAX_IDS; ++k) {
    int c = er[4 + MAX_IDS + k];
    if (c >= 0) v = __fadd_rn(v, Ed[c * W + j]);
  }
  return v;
}

// val + (sum of the edge's scalar transition terms); an edge without scalar
// terms adds nothing (ops/pallas_fb tp_of returns 0.0).
__device__ __forceinline__ float add_tp(float val, const float* tp,
                                        const int* er) {
  if (er[4] < 0) return val;
  float t = tp[er[4]];
#pragma unroll
  for (int k = 1; k < MAX_IDS; ++k)
    if (er[4 + k] >= 0) t = __fadd_rn(t, tp[er[4 + k]]);
  return __fadd_rn(val, t);
}

__device__ __forceinline__ void block_max2(float& a, float& b, float* ra,
                                           float* rb) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    ra[w] = a;
    rb[w] = b;
  }
  __syncthreads();
  a = ra[0];
  b = rb[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) {
    a = fmaxf(a, ra[i]);
    b = fmaxf(b, rb[i]);
  }
}

__device__ __forceinline__ void block_sum2(float& a, float& b, float* ra,
                                           float* rb) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    ra[w] = a;
    rb[w] = b;
  }
  __syncthreads();
  a = ra[0];
  b = rb[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) {
    a = __fadd_rn(a, ra[i]);
    b = __fadd_rn(b, rb[i]);
  }
}

__device__ __forceinline__ float lse_finish(float m, float s) {
  return (m <= NEG_INF) ? NEG_INF : __fadd_rn(m, logf(fmaxf(s, 1e-38f)));
}

// ---------------------------------------------------------------------------
// Kernel 1: emissions
// ---------------------------------------------------------------------------
// Replaces cpecan_signal_tpu/ops/pallas_fb.py:emissions_sm3 (_emissions_kernel).
// Bound: device-memory bytes.  Per cell it reads 15 floats (13 x-pack rows,
// 2 event rows) and writes 3, with a few flops in between.  Design: one
// thread per (problem, diagonal, lane), one block per (diagonal, problem);
// consecutive lanes read consecutive addresses of every row (the x slice is
// contiguous along a diagonal, the reversed event slice too), so each row
// load is one coalesced transaction per warp.  The x pack of a problem is
// re-read by neighbouring diagonals and stays in L2.
__global__ void emissions_kernel(const int* __restrict__ x0,
                                 const int* __restrict__ yr0,
                                 const float* __restrict__ xarr,
                                 const float* __restrict__ evr,
                                 float* __restrict__ E, int Dp, int De, int W,
                                 int lXp, int lYp, int nrow) {
  const int d = blockIdx.x;
  const int b = blockIdx.y;
  float* out = E + ((size_t)b * De + d) * 3 * W;
  if (d >= Dp) {  // zero sentinel rows read by the backward kernel
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      out[j] = 0.0f;
      out[W + j] = 0.0f;
      out[2 * W + j] = 0.0f;
    }
    return;
  }
  const int xs = x0[(size_t)b * nrow + d];
  const int ys = yr0[(size_t)b * nrow + d];
  const float* xa = xarr + (size_t)b * N_XPARAMS * lXp;
  const float* ev = evr + (size_t)b * 2 * lYp;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int xi = min(max(xs + j, 0), lXp - 1);
    const int yi = min(max(ys + j, 0), lYp - 1);
    const float mean = ev[yi];
    const float noise = ev[lYp + yi];
    float g[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float obs = (k & 1) ? noise : mean;
      const float* r = xa + (size_t)(3 * k) * lXp + xi;
      const float a = __fmul_rn(__fsub_rn(obs, r[0]), r[lXp]);
      g[k] = fmaxf(__fsub_rn(r[2 * lXp], __fmul_rn(__fmul_rn(0.5f, a), a)),
                   NEG_INF);
    }
    out[j] = xa[(size_t)12 * lXp + xi];                    // gapX
    out[W + j] = fmaxf(__fadd_rn(g[0], g[1]), NEG_INF);     // match
    out[2 * W + j] = fmaxf(__fadd_rn(g[2], g[3]), NEG_INF); // gapY
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: forward
// ---------------------------------------------------------------------------
// Replaces cpecan_signal_tpu/ops/pallas_fb.py:forward_sm3 (_forward_kernel).
// Bound: latency along the serial chain of anti-diagonals, not bytes or
// flops: diagonal d needs diagonals d-1 and d-2, and each step is a handful
// of dependent logAdds per lane.  Design: one block per problem, one thread
// per window lane, and the whole diagonal loop inside one launch, so no
// launch or device-memory round trip sits between two diagonals.  The
// carries F[d-1], F[d-2] live in three rotating shared-memory rows (one
// NEG_INF halo lane at each end makes the +-1 lane shift a plain offset), so
// there is one __syncthreads per diagonal.  E rows are read coalesced along
// the lanes.  Problems run on separate SMs; the card fills once a bucket has
// about as many problems as SMs.
__global__ void forward_kernel(const float* __restrict__ E,
                               const int* __restrict__ ds,
                               const int* __restrict__ d_last,
                               const float* __restrict__ start,
                               const float* __restrict__ tps,
                               const int* __restrict__ edges,
                               float* __restrict__ F, int Dp, int De, int C,
                               int S, int W, int n_tp, int n_edges,
                               int ds_rows) {
  extern __shared__ float carry[];  // 3 rows x S x (W + 2)
  __shared__ int sh_edges[MAX_EDGES * EDGE_COLS];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int WP = W + 2;
  for (int i = j; i < n_edges * EDGE_COLS; i += blockDim.x)
    sh_edges[i] = edges[i];
  for (int i = j; i < 3 * S * WP; i += blockDim.x) carry[i] = NEG_INF;
  __syncthreads();

  const float* tp = tps + (size_t)b * n_tp;
  const int dlast = d_last[b];
  const int* dsb = ds + (size_t)b * ds_rows * 8;
  const float* Eb = E + (size_t)b * De * C * W;
  float* Fb = F + (size_t)b * Dp * S * W;

  for (int d = 0; d < Dp; ++d) {
    if (d > dlast) {  // every later cell is outside the problem
      for (int dd = d; dd < Dp; ++dd)
        for (int s = 0; s < S; ++s) Fb[((size_t)dd * S + s) * W + j] = NEG_INF;
      break;
    }
    float* cur = carry + (d % 3) * S * WP;
    const float* f1 = carry + ((d + 2) % 3) * S * WP;  // F[d-1]
    const float* f2 = carry + ((d + 1) % 3) * S * WP;  // F[d-2]
    const int* row = dsb + (size_t)d * 8;
    const int xmy = row[DS_W0] + 2 * j;
    const bool valid = xmy >= row[DS_XMYL] && xmy <= row[DS_XMYR];
    float acc[MAX_S];
    if (d == 0) {
#pragma unroll
      for (int s = 0; s < MAX_S; ++s)
        acc[s] = (s < S && valid) ? start[(size_t)b * S + s] : NEG_INF;
    } else {
      const int sL = sgn(row[DS_FL]);
      const int sU = sgn(row[DS_FL] + 1);
      const int sM = sgn(row[DS_FM]);
      const float* Ed = Eb + (size_t)d * C * W;
#pragma unroll
      for (int s = 0; s < MAX_S; ++s) acc[s] = NEG_INF;
      for (int e = 0; e < n_edges; ++e) {
        const int* er = sh_edges + e * EDGE_COLS;
        const int src = er[0];
        const int sh = src == SRC_LOWER ? sL : (src == SRC_MIDDLE ? sM : sU);
        const float* prev = src == SRC_MIDDLE ? f2 : f1;
        const float fv = prev[er[1] * WP + 1 + j + sh];
        const float val = add_tp(__fadd_rn(fv, esum(Ed, er, W, j)), tp, er);
        const int to = er[2];
#pragma unroll
        for (int s = 0; s < MAX_S; ++s)
          if (s == to) acc[s] = ladd(acc[s], val);
      }
      if (!valid) {
#pragma unroll
        for (int s = 0; s < MAX_S; ++s) acc[s] = NEG_INF;
      }
    }
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < S) {
        cur[s * WP + 1 + j] = acc[s];
        Fb[((size_t)d * S + s) * W + j] = acc[s];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Kernel 3: backward + per-diagonal totals + posteriors (stages 3, 4)
// ---------------------------------------------------------------------------
// Replaces cpecan_signal_tpu/ops/pallas_fb.py:backward_sm3 (_backward_kernel)
// at stage 3 (EM = false), with the match posterior or the echelon
// per-state posteriors (pstates, :537-547), and at stage 4 with window
// groups (EM = true), with one problem per row (nh = 1).
// Bound: the same serial diagonal chain as the forward kernel, plus two
// block-wide logsumexp reductions per diagonal (the total over S x W and the
// match-through-diagonal correction).  Design: the forward kernel's shape
// run in reverse, one block per problem and one thread per lane, with the
// carries b[d+1], b[d+2] in rotating shared rows.  The two logsumexps are
// reduced together (warp shuffles, then one shared-memory pass over the
// warps), three __syncthreads per diagonal in all.  B never leaves the
// chip: the kernel writes only P and the totals.
//
// Posteriors (pstates).  pmask lists the states whose posterior
// exp(min(F[d][s] + b[d][s] - total, 0)) p carries, one channel each in
// state order: the match state alone for alignment, the five matchN states
// for echelon (one channel per k-mer count an event may emit).  Once the
// total is known each thread holds b[d][s] of every state in registers, so
// a channel costs one F load, an add, a subtract, an exp and one store; the
// state loop is unrolled over MAX_S with the mask as a runtime test, so one
// instance (PSTATES = true) serves every machine.  A mask of one state (the
// match posterior of alignment, and always at stage 4) takes the instances
// with PSTATES = false, which select that state alone, so the paths that
// write one channel do not carry the mask loop's registers.
//
// Stage 4 (the EM E-step's tallies, ops/pallas_fb.py:559-624) adds, once
// the total of diagonal d is known, one posterior per edge and cell,
// exp(min(F_src[frm] + b[d][to] + E[d] + tp - total, 0)), with F[d-1] /
// F[d-2] read at the forward kernel's shifts of row d.  It adds no barrier
// to the chain: each thread keeps its per-edge partial sums over diagonals
// in its own column of shared memory (registers would cost MAX_EDGES of
// them a thread) and the block reduces them once, after the last diagonal,
// so stats sum in another order than the plain version.  The window
// groups' tallies live in registers, one lane per thread; the one-lane
// shift where the x-window steps (DS_XS) crosses warps through a shared row
// written on the parity of d and read after the barrier that closes the
// diagonal.  exits and gacc sum the same members in the same order as the
// plain version.  The bound stays the serial chain: the per-edge work is
// independent across lanes and takes instruction slots, not barriers.
//
// Registers.  MAX_THREADS is the kernel's launch bound.  At 1024 it holds
// the kernel to 64 registers a thread, so that a block of up to 1024 lanes
// fits an SM's 65536 registers; stage 4 always runs so (93 registers
// unbounded, and no slower at 64).  Stage 3 spills at 64 and runs 4.9 %
// slower than at the 72 that a bound of NARROW_THREADS leaves it (26.02
// against 24.80 ms at W = 128, Dp = 4096, B = 64 on an H100 80GB HBM3 at
// 700 W, tools/torch_backward_launch_bounds.py), so windows that fit
// NARROW_THREADS lanes take that second instance.
#define NARROW_THREADS 896
template <bool EM, bool PSTATES, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS)
    backward_kernel(const float* __restrict__ E, const float* __restrict__ F,
                    const int* __restrict__ ds, const int* __restrict__ d_last,
                    const float* __restrict__ end, const float* __restrict__ tps,
                    const int* __restrict__ edges, float* __restrict__ P,
                    float* __restrict__ T, float* __restrict__ exits,
                    float* __restrict__ gacc_out, float* __restrict__ stats,
                    int Dp, int De, int C, int S, int W, int n_tp, int n_edges,
                    int ds_rows, unsigned pmask, int G, unsigned gm0,
                    unsigned gm1, unsigned gm2, unsigned gm3) {
  // 3 carry rows x S x (W + 2); at stage 4 then n_edges x W per-thread
  // partial sums and 2 parity rows x G x W for the window-group shift
  extern __shared__ float carry[];
  __shared__ int sh_edges[MAX_EDGES * EDGE_COLS];
  __shared__ float red[4][32];
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int WP = W + 2;
  for (int i = j; i < n_edges * EDGE_COLS; i += blockDim.x)
    sh_edges[i] = edges[i];
  for (int i = j; i < 3 * S * WP; i += blockDim.x) carry[i] = NEG_INF;
  float* part = carry + 3 * S * WP;  // part[e * W + j]: thread j's own
  float* gsh = part + n_edges * W;   // gsh[(parity * G + g) * W + j]
  const unsigned gmask[MAX_G] = {gm0, gm1, gm2, gm3};
  float gacc[MAX_G];
  float lik = 0.0f;
  if constexpr (EM) {
    for (int e = 0; e < n_edges; ++e) part[e * W + j] = 0.0f;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) gacc[g] = 0.0f;
  }
  __syncthreads();

  const float* tp = tps + (size_t)b * n_tp;
  const int dlast = d_last[b];
  const int* dsb = ds + (size_t)b * ds_rows * 8;
  const float* Eb = E + (size_t)b * De * C * W;
  const float* Fb = F + (size_t)b * Dp * S * W;
  const int NP = PSTATES ? __popc(pmask) : 1;  // posterior channels
  const int match_state = __ffs((int)pmask) - 1;  // PSTATES = false: its state
  float* Pb = P + (size_t)b * Dp * NP * W;
  float* Tb = T + (size_t)b * Dp;

  for (int d = Dp - 1; d >= 0; --d) {
    if (d > dlast) {  // b = NEG_INF, total = NEG_INF, posterior 0 exactly
      for (int c = 0; c < NP; ++c) Pb[((size_t)d * NP + c) * W + j] = 0.0f;
      if (j == 0) Tb[d] = NEG_INF;
      // nothing is tallied above d_last, so the window-group tallies are
      // still 0 and their shifts move zeros: only exits[d] = 0 is written
      if constexpr (EM)
        if (j < G) exits[((size_t)b * Dp + d) * G + j] = 0.0f;
      continue;
    }
    float* cur = carry + (d % 3) * S * WP;
    const float* b1 = carry + ((d + 1) % 3) * S * WP;  // b[d+1]
    const float* b2 = carry + ((d + 2) % 3) * S * WP;  // b[d+2]
    const int* row = dsb + (size_t)d * 8;
    const int* row1 = row + 8;
    const int xmy = row[DS_W0] + 2 * j;
    const bool valid = xmy >= row[DS_XMYL] && xmy <= row[DS_XMYR];
    const int sLo = sgn(row[DS_BL]);
    const int sUp = sgn(row[DS_BL] - 1);
    const int sMi = sgn(row[DS_BM]);
    const float* E1 = Eb + (size_t)(d + 1) * C * W;
    const float* E2 = Eb + (size_t)(d + 2) * C * W;

    // --- backward recursion; E shifts fill with 0.0, b shifts with NEG_INF
    float acc[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) acc[s] = NEG_INF;
    for (int e = 0; e < n_edges; ++e) {
      const int* er = sh_edges + e * EDGE_COLS;
      const int src = er[0];
      const int sh = src == SRC_LOWER ? sLo : (src == SRC_MIDDLE ? sMi : sUp);
      const float* bN = src == SRC_MIDDLE ? b2 : b1;
      const float* EN = src == SRC_MIDDLE ? E2 : E1;
      const int jj = j + sh;
      const float bv = bN[er[2] * WP + 1 + jj];
      const float ev = (jj >= 0 && jj < W) ? esum(EN, er, W, jj) : 0.0f;
      const float val = add_tp(__fadd_rn(bv, ev), tp, er);
      const int frm = er[1];
#pragma unroll
      for (int s = 0; s < MAX_S; ++s)
        if (s == frm) acc[s] = ladd(acc[s], val);
    }
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (d == dlast && s < S) acc[s] = end[(size_t)b * S + s];
      if (!valid) acc[s] = NEG_INF;
      if (s < S) cur[s * WP + 1 + j] = acc[s];
    }

    // --- per-diagonal total: lse(F[d] + b[d] + mask) ladd the
    // match-through-diagonal correction lse(c + b[d+1]), where c extends
    // F[d-1] by the MIDDLE edges onto diagonal d+1's grid
    const float* Fd = Fb + (size_t)d * S * W;
    const float vmask = valid ? 0.0f : NEG_INF;
    const int sM1 = sgn(row1[DS_FM]);
    float c[MAX_S];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) c[s] = NEG_INF;
    for (int e = 0; e < n_edges; ++e) {
      const int* er = sh_edges + e * EDGE_COLS;
      if (er[0] != SRC_MIDDLE) continue;
      const int jj = j + sM1;
      const float fv = (d >= 1 && jj >= 0 && jj < W)
                           ? Fb[((size_t)(d - 1) * S + er[1]) * W + jj]
                           : NEG_INF;
      const float val = add_tp(__fadd_rn(fv, esum(E1, er, W, j)), tp, er);
      const int to = er[2];
#pragma unroll
      for (int s = 0; s < MAX_S; ++s)
        if (s == to) c[s] = ladd(c[s], val);
    }
    float v1[MAX_S], v2[MAX_S];
    float m1 = NEG_INF, m2 = NEG_INF;
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < S) {
        v1[s] = __fadd_rn(__fadd_rn(Fd[s * W + j], acc[s]), vmask);
        v2[s] = __fadd_rn(c[s], b1[s * WP + 1 + j]);
        m1 = (s == 0) ? v1[s] : fmaxf(m1, v1[s]);
        m2 = (s == 0) ? v2[s] : fmaxf(m2, v2[s]);
      }
    }
    block_max2(m1, m2, red[0], red[1]);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < S) {
        s1 = __fadd_rn(s1, expf(__fsub_rn(v1[s], m1)));
        s2 = __fadd_rn(s2, expf(__fsub_rn(v2[s], m2)));
      }
    }
    block_sum2(s1, s2, red[2], red[3]);
    const float t1 = lse_finish(m1, s1);
    const float t2 = lse_finish(m2, s2);
    const float total = (d >= 1 && d < Dp - 1) ? ladd(t1, t2) : t1;
    if (j == 0) Tb[d] = total;

    // --- posteriors of the states in pmask, masked to x > 0 and y > 0
    const bool pos_ok = valid && xmy > -d && xmy < d;
    if constexpr (PSTATES) {
      int pc = 0;
#pragma unroll
      for (int s = 0; s < MAX_S; ++s) {
        if ((pmask >> s) & 1u) {
          const float pv = expf(
              fminf(__fsub_rn(__fadd_rn(Fd[s * W + j], acc[s]), total), 0.0f));
          Pb[((size_t)d * NP + pc) * W + j] = pos_ok ? pv : 0.0f;
          ++pc;
        }
      }
    } else {
      float mf = 0.0f, mb = 0.0f;
#pragma unroll
      for (int s = 0; s < MAX_S; ++s)
        if (s == match_state) {
          mf = Fd[s * W + j];
          mb = acc[s];
        }
      const float pv = expf(fminf(__fsub_rn(__fadd_rn(mf, mb), total), 0.0f));
      Pb[(size_t)d * W + j] = pos_ok ? pv : 0.0f;
    }

    // --- stage 4: per-edge posteriors of diagonal d (d >= 1, band cells),
    // summed in the plain version's order: src + b[to], + E channels, + tp
    // terms left to right, - total
    const bool step = row[DS_XS] == 1;  // the x-window steps right at d
    if constexpr (EM) {
      const int shL = sgn(row[DS_FL]);
      const int shU = sgn(row[DS_FL] + 1);
      const int shM = sgn(row[DS_FM]);
      const bool em_ok = valid && d >= 1;
      const float* Ed = Eb + (size_t)d * C * W;
      float pg[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) pg[g] = 0.0f;
      for (int e = 0; e < n_edges; ++e) {
        const int* er = sh_edges + e * EDGE_COLS;
        const int src = er[0];
        const int sh = src == SRC_LOWER ? shL : (src == SRC_MIDDLE ? shM : shU);
        const int dd = src == SRC_MIDDLE ? d - 2 : d - 1;
        const int jj = j + sh;
        const float fv = (dd >= 0 && jj >= 0 && jj < W)
                             ? Fb[((size_t)dd * S + er[1]) * W + jj]
                             : NEG_INF;
        float bto = NEG_INF;
#pragma unroll
        for (int s = 0; s < MAX_S; ++s)
          if (s == er[2]) bto = acc[s];
        const float logp = __fsub_rn(
            add_tp(__fadd_rn(__fadd_rn(fv, bto), esum(Ed, er, W, j)), tp, er),
            total);
        const float pe = em_ok ? expf(fminf(logp, 0.0f)) : 0.0f;
        part[e * W + j] = __fadd_rn(part[e * W + j], pe);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G && e < 32 && ((gmask[g] >> e) & 1u))
            pg[g] = __fadd_rn(pg[g], pe);
      }
      if (d >= 1) lik = __fadd_rn(lik, total);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          gacc[g] = __fadd_rn(gacc[g], pg[g]);
          if (j == W - 1)
            exits[((size_t)b * Dp + d) * G + g] = step ? gacc[g] : 0.0f;
          if (step) gsh[((d & 1) * G + g) * W + j] = gacc[g];
        }
      }
    }
    __syncthreads();
    if constexpr (EM) {
      // lane W-1 has left; every other lane moves one to the right
      if (step) {
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) gacc[g] = j > 0 ? gsh[((d & 1) * G + g) * W + j - 1] : 0.0f;
      }
    }
  }

  if constexpr (EM) {
    for (int g = 0; g < G; ++g) gacc_out[((size_t)b * G + g) * W + j] = gacc[g];
    float* Sb = stats + (size_t)b * STATS_LANES;
    // every thread holds the same likelihood (total is block-uniform)
    for (int i = j; i < STATS_LANES; i += blockDim.x)
      if (i >= n_edges) Sb[i] = (i == LIK_LANE) ? lik : 0.0f;
    for (int e = 0; e < n_edges; e += 2) {
      float a = part[e * W + j];
      float a2 = (e + 1 < n_edges) ? part[(e + 1) * W + j] : 0.0f;
      block_sum2(a, a2, red[2], red[3]);
      if (j == 0) {
        Sb[e] = a;
        if (e + 1 < n_edges) Sb[e + 1] = a2;
      }
      __syncthreads();  // red is rewritten by the next pair
    }
  }
}

// ---------------------------------------------------------------------------
// C interface.  Each function launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 = launched).
// ---------------------------------------------------------------------------

// Dynamic shared memory: the 3 carry rows, plus ``extra`` floats.  The
// kernel's limit is raised to it on every launch: without the opt-in a
// block gets 48 KB of static and dynamic shared memory together, so a
// dynamic size just under 48 KB would fail beside the static arrays.
static cudaError_t carry_smem(const void* fn, int S, int W, size_t extra,
                              size_t* bytes) {
  *bytes = ((size_t)3 * S * (W + 2) + extra) * sizeof(float);
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*bytes);
}

// One backward launch: a block of W threads per problem, ``extra`` floats
// of dynamic shared memory past the carry rows.
template <bool EM, bool PSTATES, int MAX_THREADS, typename... Args>
static cudaError_t launch_backward(int B, int S, int W, size_t extra,
                                   cudaStream_t stream, Args... args) {
  size_t smem;
  cudaError_t err = carry_smem(
      (const void*)backward_kernel<EM, PSTATES, MAX_THREADS>, S, W, extra,
      &smem);
  if (err != cudaSuccess) return err;
  backward_kernel<EM, PSTATES, MAX_THREADS><<<B, W, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Stage 3 at one of its four instances: several posterior channels or one,
// and the launch bound that fits W.
template <bool PSTATES, typename... Args>
static cudaError_t launch_stage3(int B, int S, int W, cudaStream_t stream,
                                 Args... args) {
  if (W <= NARROW_THREADS)
    return launch_backward<false, PSTATES, NARROW_THREADS>(B, S, W, 0, stream,
                                                           args...);
  return launch_backward<false, PSTATES, 1024>(B, S, W, 0, stream, args...);
}

extern "C" {

const char* fb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fb_emissions_sm3(const int* x0, const int* yr0, const float* xarr,
                     const float* evr, float* E, int B, int Dp, int De, int W,
                     int lXp, int lYp, int nrow, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(De, B);
  emissions_kernel<<<grid, W, 0, (cudaStream_t)stream>>>(
      x0, yr0, xarr, evr, E, Dp, De, W, lXp, lYp, nrow);
  return (int)cudaGetLastError();
}

int fb_forward(const float* E, const int* ds, const int* d_last,
               const float* start, const float* tps, const int* edges, float* F,
               int B, int Dp, int De, int C, int S, int W, int n_tp,
               int n_edges, int ds_rows, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  size_t smem;
  err = carry_smem((const void*)forward_kernel, S, W, 0, &smem);
  if (err != cudaSuccess) return (int)err;
  forward_kernel<<<B, W, smem, (cudaStream_t)stream>>>(
      E, ds, d_last, start, tps, edges, F, Dp, De, C, S, W, n_tp, n_edges,
      ds_rows);
  return (int)cudaGetLastError();
}

// Stage 3: pmask (bits < S) lists the states of P's channels, in order;
// 1 << match_state for the match posterior alone.
int fb_backward_sm3(const float* E, const float* F, const int* ds,
                    const int* d_last, const float* end, const float* tps,
                    const int* edges, float* P, float* T, int B, int Dp, int De,
                    int C, int S, int W, int n_tp, int n_edges, int ds_rows,
                    int pmask, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (pmask <= 0 || (pmask >> S) != 0) return (int)cudaErrorInvalidValue;
  float* none = nullptr;
  if (__builtin_popcount(pmask) == 1)
    return (int)launch_stage3<false>(
        B, S, W, (cudaStream_t)stream, E, F, ds, d_last, end, tps, edges, P, T,
        none, none, none, Dp, De, C, S, W, n_tp, n_edges, ds_rows,
        (unsigned)pmask, 0, 0u, 0u, 0u, 0u);
  return (int)launch_stage3<true>(
      B, S, W, (cudaStream_t)stream, E, F, ds, d_last, end, tps, edges, P, T,
      none, none, none, Dp, De, C, S, W, n_tp, n_edges, ds_rows,
      (unsigned)pmask, 0, 0u, 0u, 0u, 0u);
}

// Stage 4: G (1..MAX_G) window groups; gm<g> is group g's edge bitmask
// (bit e = edge e), 0 for the unused groups.
int fb_backward_sm3_em(const float* E, const float* F, const int* ds,
                       const int* d_last, const float* end, const float* tps,
                       const int* edges, float* P, float* T, float* exits,
                       float* gacc, float* stats, int B, int Dp, int De, int C,
                       int S, int W, int n_tp, int n_edges, int ds_rows,
                       int match_state, int G, int gm0, int gm1, int gm2,
                       int gm3, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (G < 1 || G > MAX_G || match_state < 0 || match_state >= S)
    return (int)cudaErrorInvalidValue;
  return (int)launch_backward<true, false, 1024>(
      B, S, W, (size_t)(n_edges + 2 * G) * W, (cudaStream_t)stream, E, F, ds,
      d_last, end, tps, edges, P, T, exits, gacc, stats, Dp, De, C, S, W, n_tp,
      n_edges, ds_rows, 1u << match_state, G, (unsigned)gm0, (unsigned)gm1,
      (unsigned)gm2, (unsigned)gm3);
}

}  // extern "C"
